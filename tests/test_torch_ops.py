"""The port's eval-path ops against pope_tpu's on the same seeded inputs:
the antialiased frame resize and the mask-resize (pixels), and NMS,
connected components, small-region cleanup, mask -> box and stability
(exactly, ties included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.ops import components as jcomp
from pope_tpu.ops import masks as jmasks
from pope_tpu.ops.nms import nms as jnms
from pope_tpu.ops.resize import resize_bilinear_torch as jresize
from pope_tpu_torch.ops import components, masks
from pope_tpu_torch.ops.nms import nms
from pope_tpu_torch.ops.resize import resize_bilinear_antialias, resize_bilinear_torch


@pytest.mark.parametrize(
    "in_hw,out_hw", [((480, 640), (768, 1024)), ((300, 500), (123, 205))], ids=["up", "down"]
)
def test_frame_resize_matches_jax(in_hw, out_hw):
    """jax.image.resize(bilinear, antialias=True) as amg.py calls it, on
    uint8-valued pixels. Two f32 products on both sides: the pixels agree to
    f32 rounding of values up to 255."""
    img = np.random.default_rng(0).integers(0, 256, (2, *in_hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (2, *out_hw, 3), method="bilinear", antialias=True)
    out = resize_bilinear_antialias(torch.from_numpy(img), out_hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=0)


def test_mask_resize_matches_jax():
    """The half-pixel bilinear resize of postprocess_masks, up and down."""
    x = np.random.default_rng(1).normal(0, 1, (3, 48, 64, 1)).astype(np.float32)
    for hw in ((192, 256), (30, 41)):
        ref = jresize(jnp.asarray(x), hw)
        out = resize_bilinear_torch(torch.from_numpy(x), hw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=0)


def test_postprocess_masks_matches_jax():
    """Low-res logits of a rect-encode grid -> the original frame: upsample to
    the padded frame, strip the padding, resize to the original size."""
    from pope_tpu.models.sam.sam import postprocess_masks as jpostprocess
    from pope_tpu_torch.models.sam.sam import postprocess_masks

    x = np.random.default_rng(2).normal(0, 1, (2, 3, 48, 64)).astype(np.float32)
    ref = jpostprocess(jnp.asarray(x), (180, 240), (120, 160))
    out = postprocess_masks(torch.from_numpy(x), (180, 240), (120, 160))
    assert out.shape == (2, 3, 120, 160)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def _blob_masks(seed, n, h, w):
    """Seeded masks of blobs, holes and specks."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, h, w), bool)
    for i in range(n):
        for _ in range(rng.integers(1, 5)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[i, y : y + rng.integers(1, h // 2), x : x + rng.integers(1, w // 2)] = True
        for _ in range(rng.integers(0, 4)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[i, y : y + rng.integers(1, 4), x : x + rng.integers(1, 4)] ^= True
    m[0] = False  # an empty mask
    return m


def _boxes_with_ties(seed, n):
    """Integer-grid boxes (exact IoUs) with repeated boxes and tied scores."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 40, (n, 2))
    wh = rng.integers(1, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[n // 2 :: 5] = boxes[n // 2]  # duplicates
    scores = rng.integers(0, 4, n).astype(np.float32)  # many ties
    valid = rng.uniform(size=n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax_exactly(seed):
    boxes, scores, valid = _boxes_with_ties(seed, 96)
    for thresh in (0.35, 0.7):
        ref = np.asarray(jnms(jnp.asarray(boxes), jnp.asarray(scores), thresh, valid=jnp.asarray(valid)))
        out = nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(out.numpy(), ref)


def test_nms_batched_equals_per_image():
    data = [_boxes_with_ties(s, 40) for s in (3, 4)]
    b, s, v = (torch.from_numpy(np.stack(a)) for a in zip(*data))
    batched = nms(b, s, 0.35, valid=v)
    for i in range(2):
        torch.testing.assert_close(batched[i], nms(b[i], s[i], 0.35, valid=v[i]))


def test_mask_to_box_and_stability_match_jax():
    m = _blob_masks(5, 12, 24, 32)
    np.testing.assert_array_equal(
        masks.batched_mask_to_box(torch.from_numpy(m)).numpy(),
        np.asarray(jmasks.batched_mask_to_box(jnp.asarray(m))),
    )
    logits = np.random.default_rng(6).normal(0, 2, (12, 24, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        masks.calculate_stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy(),
        np.asarray(jmasks.calculate_stability_score(jnp.asarray(logits), 0.0, 1.0)),
    )
    np.testing.assert_array_equal(masks.build_point_grid(8), jmasks.build_point_grid(8))


def test_labels_and_roots_match_jax():
    m = _blob_masks(7, 6, 24, 32)
    lab = components.label_components(torch.from_numpy(m))
    ref = jax.jit(jax.vmap(jcomp.label_components))(m)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref))
    roots = components.component_roots(lab, torch.from_numpy(m), k=16)
    ref_roots = jax.jit(jax.vmap(lambda l, x: jcomp.component_roots(l, x, k=16)))(ref, m)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(ref_roots))


@pytest.mark.parametrize("area", [3, 12])
def test_clean_mask_matches_jax_exactly(area):
    m = _blob_masks(8, 10, 24, 32)
    out, changed = components.clean_mask(torch.from_numpy(m), area, k=8)
    ref, ref_changed = jax.jit(jax.vmap(lambda x: jcomp.clean_mask(x, area, k=8)))(m)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(ref_changed))
    assert changed.any() and not changed.all()
