"""Mask post-processing ops (port of pope_tpu/ops/masks.py): stability
score, mask -> box, point grids, box IoU on the device; the multi-crop
sweep's crop boxes and per-layer grids, its crop-edge test, and the RLE codec
in numpy on the host (the codec is the plain version of native.rle_encode /
rle_decode)."""

from __future__ import annotations

import math

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


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int) -> list:
    """Point grids of each crop layer: layer i has n_per_side / scale^i points
    to a side, at least 1."""
    return [build_point_grid(max(int(n_per_side / (scale_per_layer**i)), 1)) for i in range(n_layers + 1)]


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float):
    """XYXY crop boxes of each layer: layer 0 is the whole image, layer i has
    (2^i)^2 overlapping crops. Returns (boxes, layer indices)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [[0, 0, im_w, im_h]], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        cw = crop_len(im_w, n_per_side, overlap)
        ch = crop_len(im_h, n_per_side, overlap)
        for x0 in (int((cw - overlap) * i) for i in range(n_per_side)):
            for y0 in (int((ch - overlap) * i) for i in range(n_per_side)):
                crop_boxes.append([x0, y0, min(x0 + cw, im_w), min(y0 + ch, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def is_box_near_crop_edge_np(boxes: np.ndarray, crop_box, orig_box, atol: float = 20.0) -> np.ndarray:
    """(N,) bool: an XYXY box in crop coordinates touches the crop's edge
    (within atol) where that edge is not the image's."""
    boxes = boxes + np.asarray([crop_box[0], crop_box[1], crop_box[0], crop_box[1]], np.float32)
    near_crop = np.isclose(boxes, np.asarray(crop_box, np.float32)[None], atol=atol, rtol=0)
    near_img = np.isclose(boxes, np.asarray(orig_box, np.float32)[None], atol=atol, rtol=0)
    return (near_crop & ~near_img).any(axis=1)


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) -> uncompressed column-major RLE {"size", "counts"},
    runs alternating from a run of zeros."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).transpose().reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], change, [len(flat)]])).tolist()
    if flat[0]:
        runs = [0] + runs
    return {"size": [h, w], "counts": runs}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of mask_to_rle: (H, W) bool."""
    h, w = rle["size"]
    flat = np.empty(h * w, bool)
    idx, parity = 0, False
    for count in rle["counts"]:
        flat[idx : idx + count] = parity
        idx += count
        parity = not parity
    return flat.reshape(w, h).transpose()


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
