"""The records path of the port's AutomaticMaskGenerator against pope_tpu's on
a tiny SAM with the same weights, 96x128 frames: generate, generate_batch
(B = 2, with and without the logits), generate_from_embeddings,
postprocess_small_regions_host, amg_records, and generate_records with
crop_n_layers 0 and 1 (the multi-crop sweep), in the exact f32 + erf config
and the shipped bf16 + tanh config. The decoder gets the structured surgery
of tests/test_amg_oracle.py, so that the masks have O(0.3) structure.

What must agree exactly: the valid slots, n_dropped, point_idx, the
records' count, order and crop boxes, and the RLE of every mask the two
packages binarize alike. Boxes within BOX_TOL. Full-resolution masks are
compared by IoU: the upsampled logits can sit at 0.0 on a boundary pixel,
where one f32 rounding flips it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu import native as jax_native
from pope_tpu.config import AMGConfig as JaxAMGConfig
from pope_tpu.models.sam import AutomaticMaskGenerator as JaxAMG
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu.models.sam import amg as jax_amg_module
from pope_tpu_torch import native
from pope_tpu_torch.config import AMGConfig
from pope_tpu_torch.models.sam import AutomaticMaskGenerator
from pope_tpu_torch.models.sam import amg as amg_module
from tests.test_torch_common import jax_params, port_sam, structure_decoder, tiny_cfg, to_jax

H, W = 96, 128
# filters half open: the IoU filter cuts about a quarter of the candidates,
# the cleanup (250 original pixels, 62 low-res cells) changes some masks
AMG_KW = dict(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0)
BOX_TOL = 1e-3  # boxes are low-res cell edges times f32 scale factors
MIN_IOU = 0.999  # full-resolution masks of one record, by pixel IoU
SCORE_TOL, LOGIT_TOL = 1e-4, 1e-3  # f32: predicted IoU, stability; low-res logits (O(1))
# bf16: the two packages' encoders round differently (tests/test_torch_encoder.py:
# 0.1 at most on O(1) embeddings) and the decoder carries that through bf16
# products, which moves mask boundaries and the order of near-equal scores.
# Records then agree as a set: counts within one, and every JAX record but
# one has a record of the same crop box whose mask overlaps it by IoU 0.9;
# the candidates of one image likewise: the same prompts, every box but one
# within BOX_TOL. Which candidates move depends on the machine: torch's CPU
# bf16 products take the AVX512-BF16 dot instructions where the CPU has them
# (another rounding than a machine without), and near-threshold candidates
# (predicted IoU within 0.03 of pred_iou_thresh) cross it. The multi-crop
# sweep runs one generate per crop box, so these bounds hold per crop box.
BF16_COUNT_DIFF, BF16_MIN_IOU, BF16_UNMATCHED = 1, 0.9, 1


def _scene(seed, h=H, w=W):
    """Coloured rectangles on a flat grey field."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 120, np.uint8)
    for _ in range(5):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        img[y0 : y0 + rng.integers(10, 35), x0 : x0 + rng.integers(10, 45)] = rng.integers(0, 255, 3)
    return img


@pytest.fixture(scope="module", params=[False, True], ids=["f32_erf", "bf16_tanh"])
def pair(request):
    shipped = request.param
    cfg = tiny_cfg(shipped)
    params = structure_decoder(jax_params(cfg, seed=0))
    # one generator pair per AMG config, so that each JAX program compiles once
    return shipped, cfg, JaxSam(cfg), to_jax(params), port_sam(cfg, params), {}


def _amgs(pair, **kw):
    shipped, cfg, jsam, jvars, sam, cache = pair
    amg_kw = {**AMG_KW, **kw}
    key = tuple(sorted(amg_kw.items()))
    if key not in cache:
        cache[key] = (JaxAMG(jsam, jvars, JaxAMGConfig(**amg_kw), cfg),
                      AutomaticMaskGenerator(sam, AMGConfig(**amg_kw), device="cpu"))
    return cache[key]


def _valid_sorted(res):
    """The valid candidates' (point_idx, box) rows in a fixed order."""
    ok = np.asarray(res.valid)
    rows = np.concatenate([np.asarray(res.point_idx)[ok, None].astype(np.float32),
                           np.asarray(res.boxes, np.float32)[ok]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def assert_result_matches(out, ref, shipped, logits=True):
    """One image's host AMGResult against the JAX package's. In bf16 two
    candidates of one image can score within the packages' rounding of each
    other and trade slots, so there the valid candidates are compared as a
    set: the same prompts with the same boxes."""
    ok = np.asarray(ref.valid)
    assert ok.sum() >= 3  # a non-trivial candidate set
    assert int(out.n_dropped) == int(ref.n_dropped)
    assert out.masks_low_res.dtype == np.float32 and out.masks_low_res.shape == np.asarray(ref.masks_low_res).shape
    if shipped:
        mine, theirs = _valid_sorted(out), _valid_sorted(ref)
        np.testing.assert_array_equal(mine[:, 0], theirs[:, 0])
        moved = np.abs(mine[:, 1:] - theirs[:, 1:]).max(1) > BOX_TOL
        assert moved.sum() <= BF16_UNMATCHED, (mine[moved], theirs[moved])
        return
    np.testing.assert_array_equal(out.valid, ok)
    np.testing.assert_array_equal(out.point_idx[ok], np.asarray(ref.point_idx)[ok])
    np.testing.assert_allclose(out.boxes[ok], np.asarray(ref.boxes)[ok], atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(out.areas[ok], np.asarray(ref.areas)[ok], rtol=1e-6)
    np.testing.assert_allclose(out.iou_preds[ok], np.asarray(ref.iou_preds, np.float32)[ok], atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(out.stability[ok], np.asarray(ref.stability)[ok], atol=SCORE_TOL, rtol=0)
    ref_masks = np.asarray(ref.masks_low_res, np.float32)[ok]
    if logits:
        np.testing.assert_allclose(out.masks_low_res[ok], ref_masks, atol=LOGIT_TOL, rtol=0)
    else:  # +-1 pseudo-logits
        np.testing.assert_array_equal(out.masks_low_res[ok], ref_masks)


def mask_iou(a, b) -> float:
    union = (a | b).sum()
    return float((a & b).sum() / union) if union else 1.0


def assert_records_match(recs, ref_recs, shipped):
    """Records against the JAX package's: in f32 one by one; in bf16 (see
    BF16_*) by their best partner of the same crop box."""
    for r in recs:
        assert r["segmentation"].dtype == bool and r["area"] == int(r["segmentation"].sum())
        assert np.array_equal(native.rle_decode(r["rle"]), r["segmentation"])
    if shipped:
        assert ref_recs
        for box in {tuple(q["crop_box"]) for q in ref_recs} | {tuple(r["crop_box"]) for r in recs}:
            mine = [r for r in recs if tuple(r["crop_box"]) == box]
            theirs = [q for q in ref_recs if tuple(q["crop_box"]) == box]
            assert abs(len(mine) - len(theirs)) <= BF16_COUNT_DIFF, box
            best = [max([mask_iou(r["segmentation"], q["segmentation"]) for r in mine] or [0.0]) for q in theirs]
            assert sum(b < BF16_MIN_IOU for b in best) <= BF16_UNMATCHED, (box, best)
        return
    assert len(recs) == len(ref_recs) > 0
    assert [set(r) for r in recs] == [set(r) for r in ref_recs]
    for r, q in zip(recs, ref_recs):
        assert r["crop_box"] == q["crop_box"]
        np.testing.assert_allclose(r["bbox"], q["bbox"], atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(r["point_coords"], q["point_coords"], atol=1e-4, rtol=0)
        np.testing.assert_allclose([r["predicted_iou"], r["stability_score"]],
                                   [q["predicted_iou"], q["stability_score"]], atol=SCORE_TOL, rtol=0)
        assert r["segmentation"].shape == q["segmentation"].shape
        assert mask_iou(r["segmentation"], q["segmentation"]) >= MIN_IOU
        if np.array_equal(r["segmentation"], q["segmentation"]):
            assert r["rle"] == q["rle"]


def test_generate_matches_jax(pair):
    shipped = pair[0]
    jax_amg, amg = _amgs(pair)
    frame = _scene(1)
    assert_result_matches(amg.generate(frame), jax_amg.generate(frame), shipped)


@pytest.mark.parametrize("keep_logits", [False, True], ids=["binary", "logits"])
def test_generate_batch_matches_jax(pair, keep_logits):
    """B = 2 frames in one device program, each image's cleanup in a thread;
    each image also equals generate on it alone."""
    shipped = pair[0]
    jax_amg, amg = _amgs(pair)
    frames = np.stack([_scene(2), _scene(3)])
    refs = jax_amg.generate_batch(frames, keep_logits=keep_logits)
    outs = amg.generate_batch(frames, keep_logits=keep_logits)
    assert len(outs) == 2
    for out, ref, frame in zip(outs, refs, frames):
        assert_result_matches(out, ref, shipped, logits=keep_logits)
        alone = amg.generate(frame)
        np.testing.assert_array_equal(out.valid, alone.valid)
        np.testing.assert_array_equal(out.point_idx, alone.point_idx)


def test_generate_from_embeddings_matches_jax(pair):
    """The device result of one image's embedding (the port's encoder on a
    frame, fed to both), no cleanup."""
    shipped, cfg = pair[:2]
    jax_amg, amg = _amgs(pair, mask_capacity=16)
    with torch.no_grad():
        emb = amg._encode(torch.from_numpy(_scene(2)[None]), 192, 256).float().numpy()
    ref = jax.device_get(jax_amg.generate_from_embeddings(jnp.asarray(emb), (H, W), (192, 256)))
    out = amg.generate_from_embeddings(torch.from_numpy(emb), (H, W), (192, 256))
    assert out.masks_low_res.shape == (16, 48, 64) and out.boxes.shape == (16, 4)
    host = amg_module.AMGResult(*(x.float().numpy() if x.is_floating_point() else x.numpy() for x in out))
    assert_result_matches(host, ref, shipped)
    if shipped:  # slots may trade places (BF16_*): the conversion of the port's own boxes
        want = jax_amg_module.AMGResult(*([None] + [host.boxes] + [None] * 6)).boxes_xywh
        np.testing.assert_array_equal(out.boxes_xywh.numpy(), want)
    else:
        np.testing.assert_allclose(out.boxes_xywh.numpy(), np.asarray(ref.boxes_xywh), atol=BOX_TOL, rtol=0)


def _raw_result(pair):
    """A JAX host result before the cleanup (min_mask_region_area=0)."""
    cache = pair[-1]
    if "raw" not in cache:
        jax_amg, _ = _amgs(pair, min_mask_region_area=0)
        cache["raw"] = jax_amg.generate(_scene(5))
    return cache["raw"]


@pytest.mark.parametrize("binmasks", [False, True], ids=["from_logits", "binmasks"])
def test_postprocess_small_regions_host_matches_jax(pair, binmasks):
    """The same host result through both packages' host cleanup: the native
    library on both sides, so the outputs are equal."""
    raw = _raw_result(pair)
    kw = dict(input_hw=(192, 256), frame_px_hw=(192, 256))
    if binmasks:
        kw["binmasks"] = np.asarray(raw.masks_low_res) > 0
    ref = jax_amg_module.postprocess_small_regions_host(raw, 400, (H, W), 0.35, **kw)
    out = amg_module.postprocess_small_regions_host(raw, 400, (H, W), 0.35, **kw)
    assert (np.asarray(ref.valid) != np.asarray(raw.valid)).any() or np.any(
        np.asarray(ref.masks_low_res) != np.asarray(raw.masks_low_res))  # the cleanup did something
    assert out.masks_low_res.dtype == np.float32  # pope_tpu's promotes to float64
    for name in ("masks_low_res", "boxes", "areas", "valid", "iou_preds", "stability", "point_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)), err_msg=name)


def test_amg_records_matches_jax(pair):
    """The same host result through both packages' amg_records."""
    shipped = pair[0]
    raw = _raw_result(pair)
    grid = amg_module.build_point_grid(8).astype(np.float32)
    ref = jax_amg_module.amg_records(raw, (H, W), (192, 256), point_grid01=grid)
    out = amg_module.amg_records(raw, (H, W), (192, 256), point_grid01=grid, device="cpu")
    assert_records_match(out, ref, shipped)
    assert all(r["rle"] == jax_native.rle_encode(r["segmentation"]) for r in out)


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_generate_records_matches_jax(pair, crop_n_layers):
    """The records of one frame: single-crop, and the sweep over the whole
    frame and its four crops. The sweep's frame is 192x256: the reference's
    crop-edge filter (20 px) leaves nothing of the 64x80 crops of a 96x128
    frame."""
    shipped = pair[0]
    jax_amg, amg = _amgs(pair, crop_n_layers=crop_n_layers, min_mask_region_area=100)
    frame = _scene(7) if crop_n_layers == 0 else _scene(7, 2 * H, 2 * W)
    ref = jax_amg.generate_records(frame)
    out = amg.generate_records(frame)
    assert_records_match(out, ref, shipped)
    crop_boxes = {tuple(r["crop_box"]) for r in out}
    assert len(crop_boxes) == 1 if crop_n_layers == 0 else len(crop_boxes) >= 3


def test_boxes_xywh_on_numpy_and_tensors():
    boxes = np.array([[1.0, 2.0, 4.0, 8.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    res = amg_module.AMGResult(None, boxes, None, None, None, None, None, None)
    np.testing.assert_array_equal(res.boxes_xywh, [[1, 2, 3, 6], [0, 0, 0, 0]])
    batched = res._replace(boxes=torch.from_numpy(np.stack([boxes, boxes])))
    assert torch.is_tensor(batched.boxes_xywh) and batched.boxes_xywh.shape == (2, 2, 4)
    assert torch.equal(batched.boxes_xywh[1], torch.tensor([[1.0, 2, 3, 6], [0, 0, 0, 0]]))


def test_overflow_is_logged(pair, caplog):
    """A capacity cut below the NMS survivors warns through the port's logger."""
    _, amg = _amgs(pair, mask_capacity=2)
    with caplog.at_level("WARNING", logger=amg_module.logger.name):
        recs = amg.generate_records(_scene(1))
    assert len(recs) <= 2
    assert any("over mask_capacity" in r.message for r in caplog.records)
