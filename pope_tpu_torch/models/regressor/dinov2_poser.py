"""DINOv2-feature relative-pose regressor (port of
pope_tpu/models/regressor/dinov2_poser.py): frozen DINOv2 patch tokens of
both frames, a learnable cls token cross-attended to frame A's tokens, then
to frame B's (LoFTR linear-attention layers), and a 7-dof head
(translation 3 + quaternion 4); the PoseNet-style loss.

The frozen backbone runs without gradients, so on the card its attention
launches kernel 3 (`flash_attention`) in training too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import DinoV2Config
from pope_tpu_torch.geometry.pose import matrix_to_quat, quat_to_matrix
from pope_tpu_torch.models.dinov2.model import DinoVisionTransformer
from pope_tpu_torch.models.matcher.transformer import LocalFeatureTransformer


class DINOv2Poser(nn.Module):
    """(B, H, W, 3) image pair -> (t (B, 3), quat (B, 4)) relative pose."""

    def __init__(self, dinov2: DinoV2Config = DinoV2Config(), token_dim: int = 384, nhead: int = 8,
                 depth: int = 2, freeze_backbone: bool = True):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.dino = DinoVisionTransformer(dinov2)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, token_dim))
        layers = ("self", "cross") * depth
        self.cross_attn_a = LocalFeatureTransformer(token_dim, nhead, layers, "linear")
        self.cross_attn_b = LocalFeatureTransformer(token_dim, nhead, layers, "linear")
        self.head_fc1 = nn.Linear(token_dim, 128)
        self.head_fc2 = nn.Linear(128, 7)

    def forward(self, image0, image1):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            fea_a = self.dino(image0)["x_norm_patchtokens"]
            fea_b = self.dino(image1)["x_norm_patchtokens"]
        q = self.cls_token.expand(image0.shape[0], 1, -1).to(fea_a.dtype)
        q, _ = self.cross_attn_a(q, fea_a)
        q, _ = self.cross_attn_b(q, fea_b)
        out = self.head_fc2(F.gelu(self.head_fc1(q[:, 0]), approximate="tanh"))  # flax nn.gelu's default
        return out[:, :3], out[:, 3:]


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-8)


def posenet_loss(pred_t, pred_quat, gt_t, gt_R, beta: float = 500.0):
    """Position MSE + normalized-direction MSE + beta x the orientation L1 of
    unit quaternions (the smaller of q - q_gt and q + q_gt: the sign
    ambiguity)."""
    pos = ((pred_t - gt_t) ** 2).sum(-1).mean()
    dirn = ((_unit(pred_t) - _unit(gt_t)) ** 2).sum(-1).mean()
    q_pred, q_gt = _unit(pred_quat), matrix_to_quat(gt_R)
    orient = torch.minimum((q_pred - q_gt).abs().sum(-1), (q_pred + q_gt).abs().sum(-1)).mean()
    return pos + dirn + beta * orient


def poser_rotation(pred_quat):
    return quat_to_matrix(pred_quat)
