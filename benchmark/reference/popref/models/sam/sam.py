"""Composite SAM model: preprocess -> encode -> prompt -> decode ->
postprocess (port of pope_tpu/models/sam/sam.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.popref.config import SamConfig
from benchmark.reference.popref.models.sam.decoder import MaskDecoder
from benchmark.reference.popref.models.sam.encoder import ImageEncoderViT
from benchmark.reference.popref.models.sam.prompt import PromptEncoder
from benchmark.reference.popref.ops.resize import resize_bilinear_torch

MASK_THRESHOLD = 0.0


def resize_longest_side(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """Output (h', w') with the longer side scaled to `long_side`."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def rect_frame(input_hw: Tuple[int, int], patch_size: int = 16) -> Tuple[int, int]:
    """Smallest patch-aligned frame containing the resized content: a 640x480
    image resized to 1024x768 gets a (768, 1024) frame, a 48x64 token grid."""
    h, w = input_hw
    up = lambda v: -(-v // patch_size) * patch_size
    return up(h), up(w)


def apply_coords(coords, orig_hw: Tuple[int, int], long_side: int = 1024):
    """Rescale (..., 2) xy pixel coords (a tensor or an array) from the
    original frame to the resized-longest-side frame; returns f32."""
    old_h, old_w = orig_hw
    new_h, new_w = resize_longest_side(old_h, old_w, long_side)
    coords = torch.as_tensor(coords, dtype=torch.float32)
    return coords * torch.tensor([new_w / old_w, new_h / old_h], dtype=torch.float32, device=coords.device)


def apply_boxes(boxes, orig_hw: Tuple[int, int], long_side: int = 1024):
    """Rescale (..., 4) XYXY boxes to the resized-longest-side frame: each box
    is a pair of corner points under apply_coords."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    pts = apply_coords(boxes.reshape(*boxes.shape[:-1], 2, 2), orig_hw, long_side)
    return pts.reshape(boxes.shape)


class Sam(nn.Module):
    def __init__(self, config: SamConfig = SamConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.image_encoder = ImageEncoderViT(cfg.encoder)
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg.prompt_embed_dim,
            image_embedding_size=(cfg.image_embedding_size, cfg.image_embedding_size),
            input_image_size=(cfg.encoder.img_size, cfg.encoder.img_size),
            mask_in_chans=cfg.mask_in_chans,
        )
        self.mask_decoder = MaskDecoder(
            transformer_dim=cfg.prompt_embed_dim,
            num_multimask_outputs=cfg.num_multimask_outputs,
            depth=cfg.decoder_depth,
            num_heads=cfg.decoder_num_heads,
            mlp_dim=cfg.decoder_mlp_dim,
            iou_head_hidden_dim=cfg.iou_head_hidden_dim,
            dtype=getattr(torch, cfg.decoder_dtype),
        )

    def preprocess(self, images_resized, input_hw: Tuple[int, int],
                   frame_hw: Optional[Tuple[int, int]] = None):
        """(B, H', W', 3) RGB [0, 255], already longest-side resized ->
        (B, fh, fw, 3) normalised and zero-padded. frame_hw defaults to the
        square (img_size, img_size) frame; rect encode passes rect_frame."""
        cfg = self.config
        dev = images_resized.device
        mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=dev)
        std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=dev)
        x = (images_resized.float() - mean) / std
        S = cfg.encoder.img_size
        fh, fw = (S, S) if frame_hw is None else frame_hw
        h, w = input_hw
        return F.pad(x, (0, 0, 0, fw - w, 0, fh - h))

    def encode_image(self, preprocessed):
        return self.image_encoder(preprocessed)

    def decode(self, image_embeddings, points, labels, masks_input=None,
               multimask_output: bool = True, subsample: int = 1):
        """points: (B, N, 2) coords in the 1024 frame; labels: (B, N).
        Returns (low-res masks (B, K, 4gh, 4gw), iou_pred (B, K)); with
        subsample=4 the exact stride-4 subsample, (B, K, gh, gw). Rect
        embeddings take the dense PE and no-mask embedding of their grid."""
        embed_hw = tuple(image_embeddings.shape[1:3])
        sparse, dense = self.prompt_encoder(points, labels, masks_input, embed_hw=embed_hw)
        return self.mask_decoder(
            image_embeddings, self.prompt_encoder.get_dense_pe(embed_hw), sparse, dense,
            multimask_output=multimask_output, subsample=subsample,
        )

    def forward(self, images_resized, input_hw: Tuple[int, int], points, labels,
                multimask_output: bool = True):
        """(B, H', W', 3) longest-side-resized RGB frames and their (B, N, 2)
        prompts in the resized frame -> (low-res masks, iou_pred), on the
        square frame: preprocess, encode, decode."""
        emb = self.encode_image(self.preprocess(images_resized, input_hw))
        return self.decode(emb, points, labels, multimask_output=multimask_output)


def postprocess_masks(low_res_masks, input_hw, original_hw,
                      frame_hw: Optional[Tuple[int, int]] = None):
    """(B, K, h, w) logits -> (B, K, H0, W0) at the original image size:
    upsample to the frame, strip the padding, upsample to the original.
    frame_hw defaults to 4x the mask grid (every full-res decode output)."""
    B, K = low_res_masks.shape[:2]
    if frame_hw is None:
        frame_hw = (4 * low_res_masks.shape[-2], 4 * low_res_masks.shape[-1])
    m = low_res_masks.reshape(B * K, *low_res_masks.shape[2:])[..., None]
    m = resize_bilinear_torch(m, frame_hw)
    m = m[:, : input_hw[0], : input_hw[1]]
    m = resize_bilinear_torch(m, tuple(original_hw))
    return m[..., 0].reshape(B, K, *original_hw)
