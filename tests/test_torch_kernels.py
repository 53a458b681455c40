"""The port's attention kernels (pope_tpu_torch/ops/window_attention.py,
flash_attention.py: windowed and global rel-pos attention, and bias-free
flash attention) against the Pallas kernels they replace.

On the CPU the wrappers run their plain PyTorch versions, which repeat the
CUDA kernels' arithmetic; those are held against the Pallas kernels in
interpret mode, as tests/test_window_attention.py and
tests/test_flash_attention.py run them. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.ops.flash_attention import flash_attention as pallas_attention
from pope_tpu.ops.flash_attention import flash_attention_relpos as pallas_flash
from pope_tpu.ops.window_attention import windowed_attention_relpos as pallas_window
from pope_tpu_torch.ops.cuda_kernels import attention_design
from pope_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from pope_tpu_torch.ops.window_attention import (
    windowed_attention_relpos,
    windowed_attention_relpos_plain,
)

# f32: the same math reassociated (max abs error; outputs are softmax averages
# of v ~ N(0, 1), max |out| about 1 at these shapes). bf16: both keep logits
# and softmax in f32 from the same bf16 inputs, so they differ by the bf16
# rounding of the output and, in the windowed kernel, of the softmax weights:
# a few ulps of the largest output (seen: 2e-3 on max |out| 0.95)
TOL_F32, TOL_BF16_REL = 2e-5, 1e-2


def _assert_close(out, ref, dtype):
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_REL * np.abs(ref).max()
    assert err < tol, (err, tol)


def _window_inputs(seed, BW, nh, d, hk, wk):
    rng = np.random.default_rng(seed)
    N = hk * wk
    qkv = rng.standard_normal((BW, N, 3 * nh * d)).astype(np.float32)
    rel_h = (rng.standard_normal((BW, nh, N, hk)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((BW, nh, N, wk)) * 0.5).astype(np.float32)
    return qkv, rel_h, rel_w


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_plain_matches_pallas(dtype):
    """SAM's window shape: 14x14 windows, d = 80."""
    BW, nh, d, hk, wk = 3, 2, 80, 14, 14
    qkv, rel_h, rel_w = _window_inputs(0, BW, nh, d, hk, wk)
    ref = pallas_window(
        _j(qkv, dtype), _j(rel_h, dtype), _j(rel_w, dtype), nh, d, hk, wk, interpret=True
    )
    out = windowed_attention_relpos(_t(qkv, dtype), _t(rel_h, dtype), _t(rel_w, dtype), nh, d, hk, wk)
    assert out.shape == (BW, hk * wk, nh * d) and out.dtype == getattr(torch, dtype)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hk,wk", [(8, 16), (14, 14)])
def test_flash_plain_matches_pallas(dtype, hk, wk):
    """A rect global grid (8x16) and the window grid, d = 80. The Pallas entry
    takes (B*nh, N, d); the port's takes (B, N, nh, d), here with nh = 1."""
    BH, d = 2, 80
    N = hk * wk
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((BH, N, d)).astype(np.float32) for _ in range(3))
    rel_h = (rng.standard_normal((BH, N, hk)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((BH, N, wk)) * 0.5).astype(np.float32)
    ref = pallas_flash(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), _j(rel_h, dtype), _j(rel_w, dtype),
        hk, wk, q_tile=64, k_tile=N, interpret=True,
    )
    out = flash_attention_relpos(
        *(_t(a, dtype)[:, :, None] for a in (q, k, v)),
        _t(rel_h, dtype)[:, None], _t(rel_w, dtype)[:, None], hk, wk,
    )
    assert out.shape == (BH, N, d)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_over_key_tiles(dtype):
    """A global grid of 4 x 64 keys streamed by the Pallas kernel in two
    128-key tiles (two key rows each, the E_h / E_w expansion of each tile),
    as the long kernel streams SAM's global layers; two heads, d = 80."""
    B, nh, d, hk, wk = 1, 2, 80, 4, 64
    N = hk * wk
    rng = np.random.default_rng(6)
    qkv = rng.standard_normal((B, N, 3, nh, d)).astype(np.float32)
    rel_h = (rng.standard_normal((B, nh, N, hk)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((B, nh, N, wk)) * 0.5).astype(np.float32)
    heads = lambda a: a.transpose(0, 2, 1, 3).reshape(B * nh, N, -1)
    ref = pallas_flash(
        *(_j(heads(qkv[:, :, i]), dtype) for i in range(3)),
        _j(rel_h.reshape(B * nh, N, hk), dtype), _j(rel_w.reshape(B * nh, N, wk), dtype),
        hk, wk, q_tile=128, k_tile=128, interpret=True,
    )
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(B, nh, N, d).transpose(0, 2, 1, 3)
    t = _t(qkv, dtype)
    out = flash_attention_relpos(t[:, :, 0], t[:, :, 1], t[:, :, 2], _t(rel_h, dtype), _t(rel_w, dtype), hk, wk)
    assert out.shape == (B, N, nh * d)
    _assert_close(out, ref.reshape(B, N, nh * d), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(197, 64), (50, 32)])
def test_attention_plain_matches_pallas(dtype, N, d):
    """Bias-free attention at DINOv2's shape (N = 197 tokens, d = 64) and a
    small one. The Pallas entry takes (B*nh, N, d); the port's takes
    (B, N, nh, d) views, here of a (B, N, 3, nh, d) qkv tensor as DINOv2
    hands them over."""
    B, nh = 2, 3
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((B, N, 3, nh, d)).astype(np.float32)
    heads = lambda a: a.transpose(0, 2, 1, 3).reshape(B * nh, N, d)
    ref = pallas_attention(*(_j(heads(qkv[:, :, i]), dtype) for i in range(3)), interpret=True)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(B, nh, N, d).transpose(0, 2, 1, 3)
    t = _t(qkv, dtype)
    out = flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2])
    assert out.shape == (B, N, nh * d) and out.dtype == getattr(torch, dtype)
    _assert_close(out, ref.reshape(B, N, nh * d), dtype)


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    BW, nh, d, hk, wk = 2, 2, 16, 4, 4
    qkv, rel_h, rel_w = (torch.from_numpy(a) for a in _window_inputs(2, BW, nh, d, hk, wk))
    counters = (windowed_attention_relpos, flash_attention_relpos, flash_attention)
    before = [(f.launches, dict(f.launches_by_design), dict(f.launches_by_tokens)) for f in counters]
    out = windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, hk, wk)
    torch.testing.assert_close(out, windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk))
    q, k, v = qkv.view(BW, hk * wk, 3, nh, d).unbind(2)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
    torch.testing.assert_close(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert [(f.launches, f.launches_by_design, f.launches_by_tokens) for f in counters] == before


def test_window_and_flash_plain_agree_in_f32():
    """In f32 the two plain versions compute one function (the windowed one
    reads q/k/v from the qkv layout, the global one from views of it)."""
    BW, nh, d, hk, wk = 2, 3, 24, 5, 7
    qkv, rel_h, rel_w = (torch.from_numpy(a) for a in _window_inputs(3, BW, nh, d, hk, wk))
    q, k, v = qkv.view(BW, hk * wk, 3, nh, d).unbind(2)
    torch.testing.assert_close(
        windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk),
        flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk),
        atol=1e-5, rtol=1e-5,
    )


@pytest.mark.parametrize(
    "dtype,N,d,hk,wk,design",
    [
        (torch.bfloat16, 196, 80, 14, 14, "short"),  # SAM ViT-H's windows
        (torch.bfloat16, 197, 64, 0, 0, "short"),  # DINOv2's crops
        (torch.bfloat16, 3072, 80, 48, 64, "long"),  # SAM ViT-H's global layers
        (torch.bfloat16, 4096, 80, 64, 64, "long"),  # SAM's square 1024^2 grid
        (torch.bfloat16, 512, 80, 8, 64, "long"),
        (torch.bfloat16, 1, 32, 0, 0, "short"),
        (torch.bfloat16, 200, 64, 0, 0, "short"),
        (torch.bfloat16, 201, 64, 0, 0, "short"),  # two passes of 128 keys
        (torch.bfloat16, 256, 80, 16, 16, "short"),
        (torch.bfloat16, 257, 64, 0, 0, "long"),
        (torch.bfloat16, 1000, 32, 0, 0, "long"),
        (torch.bfloat16, 320, 80, 8, 40, "long"),
        (torch.bfloat16, 192, 80, 12, 16, "short"),
        (torch.bfloat16, 200, 32, 1, 200, "long"),  # a grid wider than the short kernel's bias product
        (torch.bfloat16, 600, 64, 1, 600, "stream"),  # rel rows wider than the long kernel stages
        (torch.bfloat16, 196, 48, 14, 14, "stream"),  # a head dim without a tensor-core instantiation
        (torch.bfloat16, 3072, 48, 48, 64, "stream"),
        (torch.float32, 196, 80, 14, 14, "stream"),
        (torch.float32, 3072, 80, 48, 64, "stream"),
    ],
)
def test_attention_design_by_shape(dtype, N, d, hk, wk, design):
    """The shape alone picks the kernel: bf16, N <= 256, d in (32, 64, 80)
    and a bias grid of hk + wk <= 32 take the short kernel; the other bf16
    shapes of those head dims with grids of hk + wk <= 500 the long one; the
    rest, float32 included, the streaming one."""
    assert attention_design(dtype, N, d, hk, wk) == design


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d", [(200, 80), (17, 32)])
def test_attention_plain_matches_pallas_at_short_kernel_edges(dtype, N, d):
    """Bias-free attention at the short kernel's largest one-pass N (200, its
    whole key row in one accumulator) and a ragged small one, against the
    Pallas kernel."""
    B, nh = 1, 2
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((B, N, 3, nh, d)).astype(np.float32)
    heads = lambda a: a.transpose(0, 2, 1, 3).reshape(B * nh, N, d)
    ref = pallas_attention(*(_j(heads(qkv[:, :, i]), dtype) for i in range(3)), interpret=True)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(B, nh, N, d).transpose(0, 2, 1, 3)
    t = _t(qkv, dtype)
    _assert_close(flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2]), ref.reshape(B, N, nh * d), dtype)
