"""The reference's exact steps (`reference/amg.records`, NumPy) hold the
program's records path on decodes made to exercise them: blobs with holes
and islands, so that NMS suppresses, the capacity cut drops and the
small-region cleanup changes masks; and `records_mismatch` counts a slot
that differs."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import ndimage

from benchmark.cells import load_json, pipeline_config
from benchmark.reference import amg as ref_amg
from benchmark.reference import compare
from benchmark.tests import tiny_cells


def synthetic_decode(seed: int, P: int, h: int, w: int) -> tuple:
    """(P, 3, h, w) bf16 logits of small blobs of random place and size,
    with one-pixel islands and holes, and (P, 3) IoU predictions with ties."""
    rng = np.random.default_rng(seed)
    n = P * 3
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0, h, (n, 1, 1)), rng.uniform(0, w, (n, 1, 1))
    r = rng.uniform(1.5, 4.0, (n, 1, 1))
    logits = 8.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)) - 4.0
    logits += ndimage.gaussian_filter(rng.standard_normal((n, h, w)), sigma=(0, 1.0, 1.0))
    near = (yy - cy) ** 2 + (xx - cx) ** 2 < (2.5 * r) ** 2
    flip = near & (rng.random((n, h, w)) < 0.04)
    logits[flip] = -logits[flip]
    logits = torch.from_numpy(logits.reshape(P, 3, h, w)).to(torch.bfloat16)
    iou = torch.from_numpy(rng.choice([0.5, 0.6, 0.7, 0.8], size=(P, 3))).to(torch.bfloat16)
    return logits, iou


@pytest.fixture(scope="module")
def port_amg():
    from pope_tpu_torch import config
    from pope_tpu_torch.models.sam.amg import AutomaticMaskGenerator
    from pope_tpu_torch.models.sam.sam import Sam

    cfg = pipeline_config(config, load_json(tiny_cells.TINY), {})
    amg_cfg = dataclasses.replace(cfg.amg, pred_iou_thresh=float("-inf"), stability_score_thresh=0.0,
                                  min_mask_region_area=12000, mask_capacity=12, points_per_side=8)
    return AutomaticMaskGenerator(Sam(cfg.sam), amg_cfg, device="cpu"), cfg


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_records_agree_with_the_program(port_amg, monkeypatch, seed):
    amg, cfg = port_amg
    frame = np.zeros((480, 640, 3), np.uint8)
    P = amg.cfg.points_per_side ** 2
    h, w = 24, 32  # the low-res grid of a 640x480 frame at img_size 128
    logits, iou = synthetic_decode(seed, P, h, w)
    calls = []

    def decode(emb, pts, labels, multimask_output=True, subsample=1):
        i = sum(len(c) for c in calls)
        calls.append(pts)
        return logits[i:i + len(pts)], iou[i:i + len(pts)]

    monkeypatch.setattr(amg.sam, "decode", decode)
    monkeypatch.setattr(amg, "_encode", lambda images, in_h, in_w: torch.zeros(len(images), 6, 8, 16))
    prog = amg.generate_batch([frame], keep_logits=False)[0]
    ref = ref_amg.records(logits, iou, amg.cfg, frame.shape[:2], cfg.sam.encoder)
    assert compare.records_mismatch(prog, ref) == 0
    # the steps were exercised: the cut dropped survivors of NMS and the
    # cleanup changed masks
    uncleaned = ref_amg.records(logits, iou, dataclasses.replace(amg.cfg, min_mask_region_area=0), frame.shape[:2],
                                cfg.sam.encoder)
    assert ref["n_dropped"] > 0 and len(ref["valid"]) == amg.cfg.mask_capacity
    assert (uncleaned["masks"] != ref["masks"]).any(axis=(1, 2)).sum() > 0


def test_mismatch_counts_a_changed_slot(port_amg, monkeypatch):
    amg, cfg = port_amg
    P = amg.cfg.points_per_side ** 2
    logits, iou = synthetic_decode(5, P, 24, 32)
    ref = ref_amg.records(logits, iou, amg.cfg, (480, 640), cfg.sam.encoder)
    prog = type("R", (), {})()
    prog.valid, prog.boxes = ref["valid"].copy(), ref["boxes"].copy()
    prog.iou_preds, prog.stability, prog.areas = ref["iou_preds"], ref["stability"], ref["areas"]
    prog.point_idx, prog.n_dropped = ref["point_idx"], ref["n_dropped"]
    prog.masks_low_res = np.where(ref["masks"], 1.0, -1.0)
    assert compare.records_mismatch(prog, ref) == 0
    i = int(np.flatnonzero(ref["valid"])[0])
    prog.boxes[i, 0] += 1.0
    assert compare.records_mismatch(prog, ref) == 1
