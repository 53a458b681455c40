"""The port's matcher (pope_tpu_torch/models/matcher, ops/attention.py,
ops/resize.py::upsample2x_align_corners) against pope_tpu's on the same
seeded weights and BatchNorm statistics, carried across by the weights
bridge."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.config import BackboneConfig, CoarseMatchConfig, LoFTRStageConfig, MatcherConfig
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.matcher.backbone import ResNetFPN as JaxResNetFPN
from pope_tpu.models.matcher.matching import coarse_matching as jax_coarse_matching
from pope_tpu.models.matcher.transformer import sine_position_encoding as jax_pe
from pope_tpu.ops.attention import full_attention as jax_full
from pope_tpu.ops.attention import linear_attention as jax_linear
from pope_tpu.ops.resize import upsample2x_align_corners as jax_upsample
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.matcher.backbone import ResNetFPN
from pope_tpu_torch.models.matcher.matching import coarse_matching
from pope_tpu_torch.models.matcher.transformer import sine_position_encoding
from pope_tpu_torch.ops.attention import full_attention, linear_attention
from pope_tpu_torch.ops.resize import upsample2x_align_corners
from pope_tpu_torch.weights import matcher_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax

# the tiny JAX tests' capacity of 128; thr lowered and no border cut so that
# a randomly initialised matcher keeps matches to compare. The whole-matcher
# tests run narrow (ResNet-FPN 32/48/64, 4 coarse + 2 fine layers); the
# backbone test runs at the shipped widths (128/196/256)
CFG = MatcherConfig(
    backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
    coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross") * 2),
    fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
    match_coarse=CoarseMatchConfig(match_capacity=128, thr=0.0, border_rm=0),
)


def _fill(name, shape, rng):
    # BatchNorm statistics away from flax's init (0 and 1), so a bridge that
    # dropped them would fail
    if name == "mean":
        return rng.normal(0, 0.2, shape)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape)
    return None


def _models(cfg=CFG, seed=0):
    z = jnp.zeros((1, 64, 64, 1))
    variables = seeded_variables(JaxMatcher(cfg), z, z, seed=seed, fill=_fill)
    port = Matcher(port_config(cfg))
    port.load_state_dict(matcher_state_from_jax(variables), strict=True)
    return variables, port.eval()


def _scene(seed):
    """A smooth random grayscale scene (sums of blurred blobs) in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:160, 0:160].astype(np.float32)
    img = np.zeros((160, 160), np.float32)
    for _ in range(40):
        cy, cx, s, a = rng.uniform(0, 160), rng.uniform(0, 160), rng.uniform(3, 12), rng.uniform(-1, 1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return (img - img.min()) / (img.max() - img.min())


def test_backbone_with_batch_stats():
    variables, port = _models(MatcherConfig())
    sub = {"params": variables["params"]["backbone"], "batch_stats": variables["batch_stats"]["backbone"]}
    x = _scene(1)[None, :64, :96, None]
    ref_c, ref_f = jax.jit(JaxResNetFPN().apply)(to_jax(sub), jnp.asarray(x))
    with torch.no_grad():
        out_c, out_f = port.backbone(torch.from_numpy(np.ascontiguousarray(x)))
    for got, want in ((out_c, ref_c), (out_f, ref_f)):
        want = np.asarray(want)
        assert got.shape == want.shape
        # f32 convs in another order through 13 conv layers
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("temp_bug_fix", [False, True])
def test_position_encoding(temp_bug_fix):
    ref = np.asarray(jax_pe(10, 12, 256, temp_bug_fix))
    np.testing.assert_allclose(sine_position_encoding(10, 12, 256, temp_bug_fix).numpy(), ref, atol=2e-6)


@pytest.mark.parametrize("attn", ["linear", "full"])
def test_attention_ops_with_masks(attn):
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, 12, 4, 8)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 9, 4, 8)).astype(np.float32) for _ in range(2))
    qm, km = rng.uniform(size=(2, 12)) > 0.2, rng.uniform(size=(2, 9)) > 0.2
    jf, tf = (jax_linear, linear_attention) if attn == "linear" else (jax_full, full_attention)
    ref = np.asarray(jf(*map(jnp.asarray, (q, k, v)), q_mask=jnp.asarray(qm), kv_mask=jnp.asarray(km)))
    out = tf(*map(torch.from_numpy, (q, k, v)), q_mask=torch.from_numpy(qm), kv_mask=torch.from_numpy(km))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_upsample2x_align_corners():
    x = np.random.default_rng(3).normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(x)))
    np.testing.assert_allclose(upsample2x_align_corners(torch.from_numpy(x)).numpy(), ref, atol=1e-6)
    nchw = upsample2x_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), hw_axes=(2, 3))
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6)


def test_coarse_matching_ties_keep_the_lower_index():
    """Rows without a match all score -1: the capacity cut keeps the lower
    rows first, as jax.lax.top_k does."""
    rng = np.random.default_rng(4)
    conf = rng.uniform(0, 0.01, (2, 36, 20)).astype(np.float32)
    conf[:, 7, 3] = 0.9
    conf[0, 20, 11] = 0.5
    ref = jax_coarse_matching(jnp.asarray(conf), (6, 6), (4, 5), thr=0.2, border_rm=0, capacity=16)
    out = coarse_matching(torch.from_numpy(conf), (6, 6), (4, 5), thr=0.2, border_rm=0, capacity=16)
    for name in ("i_ids", "j_ids", "valid", "n_dropped"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.mconf.numpy(), np.asarray(ref.mconf), atol=0)


def _jax_matcher(cfg=CFG):
    """The JAX matcher's apply, jitted (its eager op-by-op run takes ~20 s)."""
    return jax.jit(functools.partial(JaxMatcher(cfg).apply, return_aux=True))


def _assert_same_matches(out, ref):
    valid = np.asarray(ref.valid)
    assert valid.sum() > 20  # there are matches to compare
    for name in ("valid", "i_ids", "j_ids", "n_dropped"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("mkpts0", "mkpts1"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-3, err_msg=name)
    np.testing.assert_allclose(out.mconf.numpy(), np.asarray(ref.mconf), atol=1e-5)


def test_matcher_prompt_against_shifted_crops():
    """One prompt against three shifted crops of it (other shapes: the
    prompt's backbone runs once and is shared), the retrieval stage's call."""
    variables, port = _models()
    scene = _scene(5)
    image0 = scene[None, 8:88, 8:104, None]  # (1, 80, 96, 1)
    image1 = np.stack([scene[dy:dy + 64, dx:dx + 64] for dy, dx in ((12, 14), (20, 30), (40, 50))])[..., None]
    ref = _jax_matcher()(to_jax(variables), jnp.asarray(image0), jnp.asarray(image1))
    with torch.no_grad():
        out = port(torch.from_numpy(np.ascontiguousarray(image0)), torch.from_numpy(image1), return_aux=True)
    _assert_same_matches(out, ref)
    np.testing.assert_array_equal(out.strong_match_count(0.5).numpy(), np.asarray(ref.strong_match_count(0.5)))


def test_matcher_prompts_batched_against_their_crops():
    """Two prompts with two crops each in one call equal two one-prompt
    calls of the JAX matcher (the pair axis as a batch dimension)."""
    variables, port = _models(seed=1)
    scenes = [_scene(6), _scene(7)]
    image0 = np.stack([s[:72, :88] for s in scenes])[..., None]
    crops = np.stack([s[dy:dy + 64, dx:dx + 64] for s in scenes for dy, dx in ((4, 6), (8, 20))])[..., None]
    with torch.no_grad():
        out = port(torch.from_numpy(np.ascontiguousarray(image0)), torch.from_numpy(crops), return_aux=True)
    jm = _jax_matcher()
    for p in range(2):
        ref = jm(to_jax(variables), jnp.asarray(image0[p:p + 1]), jnp.asarray(crops[2 * p:2 * p + 2]))
        part = type(out)(*(None if x is None else x[2 * p:2 * p + 2] for x in out))
        _assert_same_matches(part, ref)


def test_matcher_same_shapes_one_backbone_call():
    variables, port = _models(seed=2)
    scene = _scene(8)
    image0 = np.stack([scene[:64, :64], scene[30:94, 30:94]])[..., None]
    image1 = np.stack([scene[6:70, 10:74], scene[40:104, 36:100]])[..., None]
    ref = _jax_matcher()(to_jax(variables), jnp.asarray(image0), jnp.asarray(image1))
    with torch.no_grad():
        out = port(torch.from_numpy(image0), torch.from_numpy(image1), return_aux=True)
    _assert_same_matches(out, ref)
