"""Vim and the pose regressor in bfloat16 (the compute dtype pope_tpu's
MkptsRegModel passes to its Vim), and the vim_tiny / vim_small factories,
against pope_tpu on the same seeded weights and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.models.regressor import vim as jvim
from pope_tpu.models.regressor.model import MkptsRegModel as JaxReg
from pope_tpu_torch.models.regressor import vim as tvim
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.weights import regressor_state_from_jax
from tests.test_torch_common import f32, port_config, seeded_variables, to_jax
from tests.test_torch_regressor import TINY, VIM_TEST, _batch, _inputs

# bf16 activations through two Vim blocks and the RMSNorm: the features are
# O(1), and the two packages round the denses' and convs' bf16 outputs at
# different points (XLA keeps excess precision inside its fusions), so the
# features agree to a few bf16 ulps (2^-8 relative); the regressor's f32
# heads read bf16 MLP activations the same way.
TOL_VIM_BF16 = (0.06, 0.01)  # (max abs, mean abs) of O(1) features
TOL_REG_BF16 = 0.05  # max abs of the O(1) pose outputs


def T(x):
    return torch.from_numpy(np.asarray(x))


def test_vim_bf16_matches_jax():
    img = np.random.default_rng(4).normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    cfg = dict(VIM_TEST, dtype="bfloat16")
    jm = jvim.VisionMamba(jvim.VimConfig(**cfg))
    v = seeded_variables(jm, jnp.asarray(img), seed=2)
    model = tvim.VisionMamba(tvim.VimConfig(**cfg))
    model.load_state_dict(regressor_state_from_jax(v))
    with torch.no_grad():
        got = model.eval()(T(img))
    want = jax.jit(jm.apply)(to_jax(v), jnp.asarray(img))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16 and got.shape == (2, 32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    err = np.abs(f32(got) - f32(want))
    assert err.max() < TOL_VIM_BF16[0] and err.mean() < TOL_VIM_BF16[1], (err.max(), err.mean())


@pytest.mark.parametrize("fusion", ["transformer", "cross_attn"])
def test_mkpts_vim_regressor_bf16_matches_jax(fusion):
    """'mkpts+vim' in bf16 builds and runs in both packages and agrees."""
    cfg = dataclasses.replace(TINY, net_mode="mkpts+vim", rotation_mode="6d", fusion=fusion)
    jm = JaxReg(cfg, dtype=jnp.bfloat16)
    b = _batch(cfg, 0)
    v = seeded_variables(jm, *(jnp.asarray(x) for x in _inputs(b)), seed=0)
    model = MkptsRegModel(port_config(cfg), dtype="bfloat16")
    model.load_state_dict(regressor_state_from_jax(v))
    assert model.vim.config.dtype == "bfloat16"
    b = _batch(cfg, 1)
    with torch.no_grad():
        t, R = model.eval()(*(T(x) for x in _inputs(b)))
    jt, jR = jax.jit(jm.apply)(to_jax(v), *(jnp.asarray(x) for x in _inputs(b)))
    assert t.dtype == R.dtype == torch.float32 and t.shape == (2, 3) and R.shape == (2, 3, 3)
    assert np.isfinite(t.numpy()).all() and np.isfinite(R.numpy()).all()
    np.testing.assert_allclose(t.numpy(), f32(jt), atol=TOL_REG_BF16, rtol=0)
    np.testing.assert_allclose(R.numpy(), f32(jR), atol=TOL_REG_BF16, rtol=0)


@pytest.mark.parametrize("name", ["vim_tiny", "vim_small"])
def test_vim_factories_match_jax_shapes(name):
    """The port's factories give pope_tpu's parameter shapes (through the
    bridge's names), without running the 24 blocks."""
    jm = getattr(jvim, name)(num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in regressor_state_from_jax(zeros).items()}
    with torch.device("meta"):
        model = getattr(tvim, name)(num_classes=10)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert model.config == tvim.VimConfig(embed_dim=jm.config.embed_dim, depth=24, num_classes=10)
