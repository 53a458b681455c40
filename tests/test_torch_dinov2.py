"""The port's DINOv2 (pope_tpu_torch/models/dinov2) against pope_tpu's on the
same seeded weights, carried across by the weights bridge, and the same
numpy-seeded images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.config import DinoV2Config
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.dinov2.model import _interpolate_pos_embed
from pope_tpu.models.dinov2.preprocess import cls_token_cosine as jax_cosine
from pope_tpu.models.dinov2.preprocess import preprocess_image as jax_preprocess
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer, cls_token_cosine, preprocess_image
from pope_tpu_torch.models.dinov2.model import interpolate_pos_embed
from pope_tpu_torch.ops.flash_attention import flash_attention
from pope_tpu_torch.weights import dinov2_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax

# ViT-S/14's base grid (img_size 518 -> 37x37, so a 196 crop resamples the
# pos embed to 14x14) at the width of the tiny JAX test models: embed 64,
# depth 2, 2 heads
TINY = DinoV2Config(embed_dim=64, depth=2, num_heads=2)
# f32 + erf: the same math in another order through two blocks; outputs are
# LayerNorm-ed, O(1)
TOL_F32 = 1e-4
# bf16 + tanh: the JAX path rounds the logits and the softmax weights to
# bf16 and computes gelu in bf16; the port's kernel path keeps logits and
# softmax in f32. A few bf16 ulps of O(1) outputs after two blocks
TOL_BF16 = 0.1


def _fill(name, shape, rng):
    if name == "gamma":  # LayerScale at O(1), not 1e-5: the blocks must count
        return rng.uniform(0.5, 1.5, shape)
    if name == "pos_embed":
        return rng.normal(0, 0.5, shape)
    return None


def _models(cfg, seed=0):
    variables = seeded_variables(JaxDino(cfg), jnp.zeros((1, 196, 196, 3)), seed=seed, fill=_fill)
    port = DinoVisionTransformer(port_config(cfg))
    port.load_state_dict(dinov2_state_from_jax(variables), strict=True)
    return variables, port.eval()


def _images(seed, n=3, side=196):
    return np.random.default_rng(seed).normal(0, 1, (n, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("side", [196, 224])
def test_forward_f32_erf(side):
    variables, port = _models(TINY)
    x = _images(1, side=side)
    ref = JaxDino(TINY).apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL_F32, rtol=0, err_msg=key)


def test_forward_bf16_tanh():
    cfg = dataclasses.replace(TINY, dtype="bfloat16", gelu="tanh")
    variables, port = _models(cfg, seed=1)
    x = _images(2)
    ref = JaxDino(cfg).apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        got, want = out[key].float().numpy(), np.asarray(ref[key], np.float32)
        assert np.abs(got - want).max() < TOL_BF16, key
        assert np.sqrt(np.mean((got - want) ** 2)) < 0.1 * TOL_BF16, key


def test_attention_goes_through_the_kernel_wrapper(monkeypatch):
    """Each block calls flash_attention once (on the card: one launch each)."""
    from pope_tpu_torch.models.dinov2 import model as dino_model

    calls = []
    monkeypatch.setattr(dino_model, "flash_attention", lambda q, k, v: calls.append(q.shape) or flash_attention(q, k, v))
    _, port = _models(TINY)
    with torch.no_grad():
        port(torch.from_numpy(_images(3, n=2)))
    assert calls == [(2, 197, 2, 32)] * TINY.depth


@pytest.mark.parametrize("grid", [(14, 14), (16, 12), (37, 37)])
def test_pos_embed_interpolation(grid):
    """jax.image.resize(..., "bicubic"): Keys a = -0.5, antialiased when it
    shrinks the 37x37 grid."""
    pe = np.random.default_rng(5).normal(0, 1, (1, 1 + 37 * 37, 8)).astype(np.float32)
    ref = _interpolate_pos_embed(jnp.asarray(pe), grid, 14)
    out = interpolate_pos_embed(torch.from_numpy(pe), grid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("center_crop", [True, False])
def test_preprocess_and_cosine(center_crop):
    img = np.random.default_rng(6).uniform(0, 255, (2, 120, 160, 3)).astype(np.float32)
    ref = np.concatenate([np.asarray(jax_preprocess(jnp.asarray(im), center_crop)) for im in img])
    out = preprocess_image(torch.from_numpy(img), center_crop)
    # normalised pixels up to ~2.6: the two resample products reassociated
    # (jax.image contracts both axes in one einsum)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    a, b = np.random.default_rng(7).normal(0, 1, (2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        cls_token_cosine(torch.from_numpy(a[:1]), torch.from_numpy(b)).numpy(),
        np.asarray(jax_cosine(jnp.asarray(a[:1]), jnp.asarray(b))), atol=1e-6,
    )
