"""The numbers that decide `correct`: gaps between what the timed path
produced and what the reference computes from the same frame.

- `sam_gaps`: the network's continuous outputs, every grid prompt's IoU
  predictions and mask logits, the program's as the window decoded them
  against the reference's float32 decode of the same frame.
- `records_mismatch`: the exact steps (filters, NMS, the capacity cut, the
  small-region cleanup, boxes and areas), which the reference's NumPy code
  (`amg.records`) runs on the program's own raw decode outputs, so that a
  rounding in the network does not flip a discrete choice; counted as
  mismatches, limit 0.
"""

from __future__ import annotations

import numpy as np
import torch


def raw_of(calls) -> tuple:
    """One image's decode calls -> ((P, 3, h, w) mask logits, (P, 3) IoU)."""
    return torch.cat([m for m, _ in calls]), torch.cat([s for _, s in calls])


def sam_gaps(prog_raw, ref_raw) -> dict:
    """Largest IoU-prediction gap and largest mask-logit gap (relative to
    the reference's largest logit) over one image's candidates."""
    pm, pi = prog_raw
    rm, ri = ref_raw
    iou = (pi.float() - ri.float().to(pi.device)).abs().max().item()
    rm = rm.float().to(pm.device)
    scale = rm.abs().max().clamp(min=1e-6)
    mask = ((pm.float() - rm).abs().max() / scale).item()
    return {"sam_iou_gap": iou, "sam_mask_gap": mask}


def records_mismatch(prog, ref: dict, tol: float = 1e-3) -> int:
    """Slots of one image's host result (the program's AMGResult) that the
    reference's `amg.records` contradicts: a slot valid on one side only;
    or valid on both with a box more than tol pixels apart, an IoU
    prediction, stability score or area apart by more than 1e-4 of the
    reference's, another prompt, or another mask; plus 1 where the counts
    of candidates the cut dropped differ."""
    valid = np.asarray(prog.valid, bool)
    n = len(ref["valid"])
    bad = int(valid[n:].sum())
    valid = valid[:n]
    both = valid & ref["valid"]
    bad += int((valid != ref["valid"]).sum())
    apart = (np.abs(np.asarray(prog.boxes, np.float64)[:n] - ref["boxes"]) > tol).any(axis=1)
    for field in ("iou_preds", "stability", "areas"):
        a, c = np.asarray(getattr(prog, field), np.float64)[:n], np.asarray(ref[field], np.float64)
        apart |= np.abs(a - c) > 1e-4 * (1 + np.abs(c))
    apart |= np.asarray(prog.point_idx)[:n] != ref["point_idx"]
    apart |= ((np.asarray(prog.masks_low_res)[:n] > 0) != ref["masks"]).any(axis=(1, 2))
    bad += int((apart & both).sum())
    return bad + int(int(prog.n_dropped) != ref["n_dropped"])
