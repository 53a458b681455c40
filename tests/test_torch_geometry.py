"""The port's crop geometry (pope_tpu_torch/geometry/affine.py) and its
antialiased bicubic resize (ops/resize.py) against pope_tpu's / jax.image's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.geometry.affine import get_affine_transform as jax_affine
from pope_tpu.geometry.affine import get_image_crop_resize as jax_crop
from pope_tpu.geometry.affine import get_K_crop_resize as jax_K_crop
from pope_tpu_torch.geometry import get_affine_transform, get_image_crop_resize, get_K_crop_resize
from pope_tpu_torch.ops.resize import resize_bicubic_antialias

# boxes of all kinds: inside, over the border, non-square, degenerate
BOXES = np.array([
    [10.0, 12.0, 70.0, 50.0],
    [-15.0, 30.0, 40.0, 110.0],
    [60.0, -5.0, 140.0, 95.0],
    [33.3, 21.7, 33.3, 21.7],
    [5.5, 7.25, 91.0, 33.0],
], np.float32)


def test_crop_resize_and_K_match_jax():
    img = np.random.default_rng(0).uniform(0, 1, (96, 128, 3)).astype(np.float32)
    K = np.array([[100.0, 0, 64], [0, 110, 48], [0, 0, 1]], np.float32)
    crops, trans = get_image_crop_resize(torch.from_numpy(img)[None], torch.from_numpy(BOXES)[None], (40, 56))
    K_crop, K_homo = get_K_crop_resize(torch.from_numpy(BOXES), torch.from_numpy(K), (40, 56))
    for i, box in enumerate(BOXES):
        ref_crop, ref_trans = jax_crop(jnp.asarray(img), jnp.asarray(box), (40, 56))
        # pixels in [0, 1]: f32 products reassociated
        np.testing.assert_allclose(crops[0, i].numpy(), np.asarray(ref_crop), atol=1e-5)
        if box[2] == box[0]:
            # a zero-area box is clamped to 1e-3 px: a solve at condition
            # ~1e5 whose last digits both packages get differently; it must
            # only stay finite
            assert np.isfinite(trans[0, i].numpy()).all() and np.isfinite(K_crop[i].numpy()).all()
            continue
        np.testing.assert_allclose(trans[0, i].numpy(), np.asarray(ref_trans), rtol=1e-5, atol=1e-3)
        ref_K, ref_homo = jax_K_crop(jnp.asarray(box), jnp.asarray(K), (40, 56))
        np.testing.assert_allclose(K_crop[i].numpy(), np.asarray(ref_K), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(K_homo[i].numpy(), np.asarray(ref_homo), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("inv", [False, True])
def test_affine_transform(inv):
    center, scale = np.array([40.0, 30.0], np.float32), np.array([50.0, 20.0], np.float32)
    ref = jax_affine(jnp.asarray(center), jnp.asarray(scale), 0.0, (64, 48), inv=inv)
    out = get_affine_transform(torch.from_numpy(center), torch.from_numpy(scale), 0.0, (64, 48), inv=inv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape_in,shape_out", [((37, 37), (14, 14)), ((10, 12), (23, 7))])
def test_bicubic_antialias_matches_jax_image(shape_in, shape_out):
    x = np.random.default_rng(1).normal(0, 1, (2, *shape_in, 4)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *shape_out, 4), method="bicubic")
    out = resize_bicubic_antialias(torch.from_numpy(x), shape_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
