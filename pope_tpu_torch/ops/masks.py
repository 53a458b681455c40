"""Mask post-processing ops (port of pope_tpu/ops/masks.py, the parts the
eval path runs: stability score, mask -> box, point grid, box IoU)."""

from __future__ import annotations

import numpy as np
import torch


def calculate_stability_score(mask_logits, mask_threshold: float, offset: float):
    """IoU between high- and low-threshold binarizations; (..., H, W) -> (...)."""
    hi = (mask_logits > (mask_threshold + offset)).sum(dim=(-2, -1))
    lo = (mask_logits > (mask_threshold - offset)).sum(dim=(-2, -1))
    return hi.float() / torch.clamp(lo, min=1).float()


def batched_mask_to_box(masks):
    """XYXY boxes around boolean masks, [0, 0, 0, 0] for empty ones:
    (..., H, W) bool -> (..., 4) f32."""
    h, w = masks.shape[-2:]
    in_height = masks.any(dim=-1)
    hc = in_height * torch.arange(h, device=masks.device)
    bottom = hc.amax(dim=-1)
    top = (hc + h * ~in_height).amin(dim=-1)
    in_width = masks.any(dim=-2)
    wc = in_width * torch.arange(w, device=masks.device)
    right = wc.amax(dim=-1)
    left = (wc + w * ~in_width).amin(dim=-1)
    empty = (right < left) | (bottom < top)
    box = torch.stack([left, top, right, bottom], dim=-1).float()
    return box * ~empty[..., None]


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) grid of [0, 1]-normalized (x, y) points."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    x = np.tile(side[None, :], (n_per_side, 1))
    y = np.tile(side[:, None], (1, n_per_side))
    return np.stack([x, y], axis=-1).reshape(-1, 2)


def box_iou(boxes_a, boxes_b):
    """Pairwise IoU of XYXY boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    area_a = torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0) * torch.clamp(
        boxes_a[..., 3] - boxes_a[..., 1], min=0
    )
    area_b = torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0) * torch.clamp(
        boxes_b[..., 3] - boxes_b[..., 1], min=0
    )
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)
