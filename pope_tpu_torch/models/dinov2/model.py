"""DINOv2 vision transformer, inference (port of pope_tpu/models/dinov2/model.py).

Patch embed (14x14 conv) + cls token + bicubic-resampled pos embed ->
pre-norm blocks with LayerScale -> final LayerNorm; returns
x_norm_clstoken / x_norm_patchtokens. The cast points are the JAX package's:
LayerNorms in f32, Dense layers in the config dtype, the LayerScale product
promotes the residual stream to f32.

Attention runs through the bias-free streaming kernel
(ops/flash_attention.py::flash_attention) on strided q/k/v views of the qkv
Dense output, with no copy. The JAX package computes it as einsum + f32
softmax with the logits and the softmax weights rounded to the compute
dtype; the kernel keeps logits and softmax statistics in f32.

Inference only: DropPath, mask tokens and the SwiGLU FFN (training and
other-variant paths) are not ported; the `mask_token` parameter is kept so
that state dicts load strictly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import DinoV2Config
from pope_tpu_torch.models.sam.encoder import conv_nhwc, dense, layer_norm_f32
from pope_tpu_torch.ops.flash_attention import flash_attention
from pope_tpu_torch.ops.resize import resize_bicubic_antialias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        nh = self.num_heads
        qkv = dense(self.qkv, x, self.dtype).view(B, N, 3, nh, C // nh)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return dense(self.proj, out, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float,
                 dtype: torch.dtype, gelu: str = "erf"):
        super().__init__()
        self.dtype = dtype
        self.gelu = gelu
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x):
        x = x + self.ls1(self.attn(layer_norm_f32(self.norm1, x)))
        h = dense(self.mlp_fc1, layer_norm_f32(self.norm2, x), self.dtype)
        h = F.gelu(h, approximate="tanh" if self.gelu == "tanh" else "none")
        return x + self.ls2(dense(self.mlp_fc2, h, self.dtype))


def interpolate_pos_embed(pos_embed, grid_hw):
    """The (1, 1 + side^2, C) pos embed on a (h, w) patch grid: the patch part
    resampled as jax.image.resize(..., "bicubic") does (Keys a = -0.5,
    antialiased when it shrinks)."""
    h, w = grid_hw
    side = int((pos_embed.shape[1] - 1) ** 0.5)
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, side, side, -1)
    if (h, w) != (side, side):
        patch_pe = resize_bicubic_antialias(patch_pe.float(), (h, w))
    return torch.cat([cls_pe, patch_pe.reshape(1, h * w, -1)], dim=1)


class DinoVisionTransformer(nn.Module):
    """(B, H, W, 3) normalised NHWC images -> {"x_norm_clstoken": (B, C),
    "x_norm_patchtokens": (B, N, C)} in f32."""

    def __init__(self, config: DinoV2Config = DinoV2Config()):
        super().__init__()
        cfg = config
        if cfg.ffn_layer != "mlp" or cfg.num_register_tokens:
            raise NotImplementedError(
                f"ffn_layer={cfg.ffn_layer!r}, {cfg.num_register_tokens} register tokens: "
                "the port implements the ViT-S/14 'mlp' variant only"
            )
        self.config = cfg
        self.dtype = getattr(torch, cfg.dtype)
        p, C = cfg.patch_size, cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, C, p, stride=p)
        self.mask_token = nn.Parameter(torch.zeros(1, C))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + (cfg.img_size // p) ** 2, C))
        self.block_names = []
        for i in range(cfg.depth):
            name = f"block_{i}"
            self.add_module(name, Block(C, cfg.num_heads, cfg.mlp_ratio, cfg.init_values,
                                        self.dtype, cfg.gelu))
            self.block_names.append(name)
        self.norm = nn.LayerNorm(C, eps=1e-6)

    def forward(self, x):
        B, H, W, _ = x.shape
        p, C = self.config.patch_size, self.config.embed_dim
        x = conv_nhwc(self.patch_embed, x, self.dtype).reshape(B, (H // p) * (W // p), C)
        x = torch.cat([self.cls_token.expand(B, 1, C).to(x.dtype), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, (H // p, W // p)).to(x.dtype)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = layer_norm_f32(self.norm, x)
        return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}
