"""The slice as a whole: the port's AutomaticMaskGenerator.generate_boxes_batch
against pope_tpu's on a tiny SAM with the same weights, B = 2 non-square
frames (antialiased resize, rect encode with padded windows, chunked
decode at the eval subsample, filters, NMS, the capacity cut and the
small-region cleanup).

The decoder gets the structured surgery of tests/test_amg_oracle.py, so the
masks have O(0.3) structure and their binarization is not sign noise. On
that, the two packages agree exactly: same valid slots, same n_dropped, same
boxes."""

import jax
import numpy as np
import pytest
import torch

from pope_tpu.config import AMGConfig as JaxAMGConfig
from pope_tpu.models.sam import AutomaticMaskGenerator as JaxAMG
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch.config import AMGConfig
from pope_tpu_torch.models.sam import AutomaticMaskGenerator
from tests.test_torch_common import jax_params, port_sam, structure_decoder, tiny_cfg, to_jax

BOX_TOL = 1e-3  # boxes are low-res cell edges times f32 scale factors


def _scene(seed, h=96, w=128):
    """Coloured rectangles on a flat grey field."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 120, np.uint8)
    for _ in range(5):
        y0, x0 = rng.integers(0, h - 20), rng.integers(0, w - 20)
        img[y0 : y0 + rng.integers(10, 35), x0 : x0 + rng.integers(10, 45)] = rng.integers(0, 255, 3)
    return img


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_cfg(False)
    params = structure_decoder(jax_params(cfg, seed=0))
    return cfg, params, port_sam(cfg, params)


@pytest.mark.parametrize(
    "amg_kw",
    [
        # filters open, capacity 8 < NMS survivors: n_dropped > 0
        dict(points_per_side=8, pred_iou_thresh=-1e9, stability_score_thresh=0.0, mask_capacity=8),
        # the default capacity and cleanup, the IoU filter cutting about a
        # quarter of the candidates (this tiny model's stable masks are the
        # frame-filling ones, so a stability cut leaves one box)
        dict(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0),
    ],
    ids=["open_cap8", "filtered"],
)
def test_generate_boxes_batch_matches_jax(pair, amg_kw):
    cfg, params, sam = pair
    frames = np.stack([_scene(1), _scene(2)])
    jax_amg = JaxAMG(JaxSam(cfg), to_jax(params), JaxAMGConfig(**amg_kw), cfg)
    ref_boxes, ref_valid, ref_dropped = jax.device_get(jax_amg.generate_boxes_batch(frames))

    amg = AutomaticMaskGenerator(sam, AMGConfig(**amg_kw), device="cpu")
    boxes, valid, n_dropped = amg.generate_boxes_batch(frames)
    assert boxes.shape == (2, amg.cfg.mask_capacity, 4) and valid.shape == (2, amg.cfg.mask_capacity)
    assert ref_valid.sum() >= 4  # a non-trivial candidate set
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(n_dropped.numpy(), ref_dropped)
    np.testing.assert_allclose(boxes.numpy()[ref_valid], ref_boxes[ref_valid], atol=BOX_TOL, rtol=0)
    if amg_kw.get("mask_capacity") == 8:
        assert (ref_dropped > 0).all()


def test_amg_needs_a_gpu_unless_asked_for_cpu(pair):
    cfg, _, sam = pair
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutomaticMaskGenerator(sam, AMGConfig())
