"""Greedy box NMS over a precomputed IoU matrix, batched over images, and
its category-aware form (port of pope_tpu/ops/nms.py)."""

from __future__ import annotations

import torch

from pope_tpu_torch.ops.masks import box_iou


def nms(boxes, scores, iou_threshold: float, valid=None):
    """Greedy NMS; returns a keep mask.

    boxes: (..., N, 4) XYXY; scores: (..., N); valid: optional (..., N) bool.
    torchvision.ops.nms semantics: descending score order, suppression when
    IoU is strictly above the threshold. Ties keep the lower index first (a
    stable sort, as jnp.argsort is). Invalid candidates never suppress.
    """
    lead = boxes.shape[:-2]
    N = boxes.shape[-2]
    boxes = boxes.reshape(-1, N, 4)
    scores = scores.reshape(-1, N)
    valid = (
        torch.ones_like(scores, dtype=torch.bool) if valid is None else valid.reshape(-1, N)
    )
    iou = box_iou(boxes, boxes)
    key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)  # valid best-first
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    keep = torch.zeros_like(valid)
    alive = torch.ones_like(valid)
    # invalid candidates sort last and change nothing: stop after the valid ones
    for i in range(int(valid.sum(dim=-1).max()) if N else 0):
        idx = order[:, i]
        take = alive[rows, idx] & valid[rows, idx]
        keep[rows, idx] = take
        alive &= ~(take[:, None] & (iou[rows, idx] > iou_threshold))
        alive[rows, idx] |= take
    return (keep & valid).reshape(*lead, N)


def batched_nms(boxes, scores, idxs, iou_threshold: float, valid=None):
    """Category-aware NMS (torchvision batched_nms): boxes (..., N, 4) are
    offset per category idxs (..., N) so that cross-category pairs never
    overlap. Returns nms's keep mask."""
    max_coord = boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = idxs.to(boxes.dtype)[..., None] * (2.0 * max_coord)
    return nms(boxes + offsets, scores, iou_threshold, valid)
