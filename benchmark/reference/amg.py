"""The reference's automatic mask generation on the records path, written
from segment-anything's `SamAutomaticMaskGenerator` semantics and not from
the program:

- `grid_decode`: the network's part, every grid prompt of one frame through
  the reference's SAM (`popref/`, plain PyTorch in float32);
- `records`: the exact part in NumPy and SciPy, from one frame's raw decode
  outputs: the IoU and stability filters, mask boxes, greedy box NMS, the
  top-`mask_capacity` cut, the small-region cleanup over 8-connected
  components and the re-NMS that prefers untouched masks.

Boxes and scores are float32, as the configuration states them; every box
coordinate is a multiple of the low-res cell's size in original pixels, so
areas, intersections and unions are exact and only the one division of an
IoU rounds.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

MASK_THRESHOLD = 0.0
_EIGHT = np.ones((3, 3), bool)
F32 = np.float32


def point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) [0, 1]-normalised (x, y) prompt points, row by row, each at
    the centre of its cell."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    xs, ys = np.meshgrid(side, side)
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)


def longest_side(h: int, w: int, long_side: int) -> tuple:
    """(h', w') with the longer side scaled to long_side, rounded half up."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def encode_frame_hw(input_hw: tuple, enc, rect: bool) -> tuple:
    """The encoder's frame: the resized content rounded up to whole patches
    (rect encode), else the square img_size frame."""
    if not rect:
        return enc.img_size, enc.img_size
    return tuple(-(-v // enc.patch_size) * enc.patch_size for v in input_hw)


@torch.no_grad()
def grid_decode(sam, cfg, frame: np.ndarray, device) -> tuple:
    """One (H, W, 3) uint8 frame -> the reference's ((P, 3, h, w) mask logits,
    (P, 3) IoU predictions) of every grid prompt (one positive point and a
    padding point each), decoded points_per_chunk prompts at a time."""
    from benchmark.reference.popref.ops.resize import resize_bilinear_antialias

    oh, ow = frame.shape[:2]
    enc = sam.config.encoder
    in_h, in_w = longest_side(oh, ow, enc.img_size)
    img = torch.as_tensor(np.ascontiguousarray(frame), device=device)[None].float()
    if (oh, ow) != (in_h, in_w):
        img = resize_bilinear_antialias(img, (in_h, in_w))
    emb = sam.encode_image(sam.preprocess(img, (in_h, in_w), encode_frame_hw((in_h, in_w), enc, cfg.rect_encode)))
    grid = torch.as_tensor(point_grid(cfg.points_per_side), dtype=torch.float32, device=device)
    pts = grid * torch.tensor([ow, oh], dtype=torch.float32, device=device)
    pts = (pts * torch.tensor([in_w / ow, in_h / oh], dtype=torch.float32, device=device))[:, None, :]
    pts = torch.cat([pts, torch.zeros_like(pts)], dim=1)
    n = pts.shape[0]
    labels = torch.tensor([1, -1], device=device).expand(n, 2)
    chunk = cfg.points_per_chunk if 0 < cfg.points_per_chunk < n else n
    outs = [sam.decode(emb, pts[i:i + chunk], labels[i:i + chunk], multimask_output=True)
            for i in range(0, n, chunk)]
    return torch.cat([m for m, _ in outs]), torch.cat([s for _, s in outs])


def mask_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, h, w) bool -> (N, 4) float32 XYXY of the first and last occupied
    column and row (inclusive), zeros for an empty mask."""
    cols, rows = masks.any(axis=1), masks.any(axis=2)
    out = np.zeros((len(masks), 4), F32)
    for i in np.flatnonzero(cols.any(axis=1)):
        xs, ys = np.flatnonzero(cols[i]), np.flatnonzero(rows[i])
        out[i] = (xs[0], ys[0], xs[-1], ys[-1])
    return out


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float, valid: np.ndarray) -> np.ndarray:
    """Greedy NMS over the valid candidates: best score first (the lower
    index first among equal scores), a candidate dropped when its IoU with
    a kept one is above thresh. Invalid candidates neither stay nor drop
    another. Returns (N,) bool keep flags."""
    b = boxes.astype(F32)
    thr = F32(thresh)
    w = np.maximum(b[:, 2] - b[:, 0], F32(0))
    h = np.maximum(b[:, 3] - b[:, 1], F32(0))
    area = w * h
    keep = np.zeros(len(b), bool)
    dropped = ~np.asarray(valid, bool)
    for i in sorted(np.flatnonzero(~dropped), key=lambda i: (-float(scores[i]), i)):
        if dropped[i]:
            continue
        keep[i] = True
        iw = np.maximum(np.minimum(b[i, 2], b[:, 2]) - np.maximum(b[i, 0], b[:, 0]), F32(0))
        ih = np.maximum(np.minimum(b[i, 3], b[:, 3]) - np.maximum(b[i, 1], b[:, 1]), F32(0))
        inter = iw * ih
        union = area[i] + area - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            over = (union > 0) & (inter / union > thr)
        over[i] = False
        dropped |= over
    return keep


def remove_small_regions(mask: np.ndarray, area_thresh: int, mode: str) -> tuple:
    """segment-anything's remove_small_regions: fill the holes ("holes") or
    drop the islands ("islands") of fewer than area_thresh pixels, regions
    8-connected; when every island is small the largest stays (the first in
    raster order among equal sizes). Returns (mask, changed)."""
    islands = mode == "islands"
    labels, n = ndimage.label(mask == islands, structure=_EIGHT)
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    small = sizes < area_thresh
    if not small.any():
        return mask, False
    if islands and small.all():
        small[int(np.argmax(sizes))] = False
    out = mask.copy()
    out[np.concatenate([[False], small])[labels]] = not islands
    return out, True


def records(logits, iou, cfg, orig_hw: tuple, enc) -> dict:
    """The exact steps of one frame's records path from its raw decode:
    logits (P, 3, h, w) and iou (P, 3), any float type. Returns the kept
    candidates in the cut's slots, as the program's host result has them:
    boxes (original pixels), iou_preds, stability, areas, valid, point_idx,
    masks (bool, after the cleanup) and n_dropped; and n_filtered, the
    candidates that passed the filters into NMS."""
    m = np.asarray(torch.as_tensor(logits).float().cpu().numpy(), F32)
    P, K, h, w = m.shape
    m = m.reshape(P * K, h, w)
    s = np.asarray(torch.as_tensor(iou).float().cpu().numpy(), F32).reshape(-1)
    oh, ow = orig_hw
    in_h, in_w = longest_side(oh, ow, enc.img_size)
    # the low-res grid covers the encoder's frame at 4 pixels a cell
    fh, fw = 4 * h, 4 * w
    to_input = np.array([fw / w, fh / h, fw / w, fh / h], F32)
    lim = np.array([in_w, in_h, in_w, in_h], F32)
    to_orig = np.array([ow / in_w, oh / in_h, ow / in_w, oh / in_h], F32)
    area_scale = (h * in_h / (fh * oh)) * (w * in_w / (fw * ow))

    def to_boxes(masks):
        return np.minimum(np.maximum(mask_boxes(masks) * to_input, F32(0)), lim) * to_orig

    hi = (m > MASK_THRESHOLD + cfg.stability_score_offset).sum(axis=(1, 2))
    lo = (m > MASK_THRESHOLD - cfg.stability_score_offset).sum(axis=(1, 2))
    stability = hi.astype(F32) / np.maximum(lo, 1).astype(F32)
    binm = m > MASK_THRESHOLD
    del m
    area_low = binm.sum(axis=(1, 2))
    keep = (s > F32(cfg.pred_iou_thresh)) & (stability >= F32(cfg.stability_score_thresh)) & (area_low > 0)
    boxes = to_boxes(binm)
    kept = greedy_nms(boxes, s, cfg.box_nms_thresh, keep)

    cap = min(cfg.mask_capacity, len(s))
    order = sorted(np.flatnonzero(kept), key=lambda i: (-float(s[i]), i))[:cap]
    slots = np.array(order, np.int64)
    out = {"n_dropped": max(int(kept.sum()) - cap, 0), "n_filtered": int(keep.sum()),
           "iou_preds": s[slots], "stability": stability[slots],
           "point_idx": slots // K, "masks": binm[slots]}
    del binm
    valid = np.ones(len(slots), bool)
    masks = out["masks"]
    changed = np.zeros(len(slots), bool)
    min_area = max(int(round(cfg.min_mask_region_area * area_scale)), 1)
    if cfg.min_mask_region_area > 0:
        for i in range(len(slots)):
            mk, c1 = remove_small_regions(masks[i], min_area, "holes")
            mk, c2 = remove_small_regions(mk, min_area, "islands")
            masks[i], changed[i] = mk, c1 or c2
        valid = greedy_nms(to_boxes(masks), np.where(changed, F32(0), F32(1)), cfg.box_nms_thresh, valid)
        out["boxes"] = to_boxes(masks)
    else:
        out["boxes"] = boxes[slots]
    out["areas"] = (masks.sum(axis=(1, 2)) / area_scale).astype(F32)
    out["valid"] = valid
    return out
