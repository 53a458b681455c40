"""The arithmetic of the float32 "tf32x3" attention kernel
(pope_tpu_torch/csrc/attention_f32.cu), emulated in plain PyTorch on the CPU.

The kernel runs only on the card. Its order of work is emulated here: each f32
operand split into big = rna_tf32(x) and small = rna_tf32(x - big)
(cvt.rna.tf32.f32, emulated by bit operations), each product as
a_small b_big + a_big b_small + a_big b_big, q pre-scaled by d^-1/2 log2(e),
the bias by log2(e), an online softmax in the log2 domain over the kernel's
key tiles with the ragged last tile masked to -inf, and P split again for
P V. The emulation is held against the port's plain versions and against
the Pallas kernels of pope_tpu in interpret mode at the f32 tolerance the
card tests hold the kernel to (tests/test_torch_cuda.py::TOL_F32), and a
single TF32 pass (big . big alone) is shown to miss it: that is why the
kernel takes three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.ops.flash_attention import flash_attention as pallas_attention
from pope_tpu.ops.flash_attention import flash_attention_relpos as pallas_flash
from pope_tpu.ops.window_attention import windowed_attention_relpos as pallas_window
from pope_tpu_torch.ops.cuda_kernels import F32_MAX_GRID, _resolve_design
from pope_tpu_torch.ops.flash_attention import flash_attention_plain, flash_attention_relpos_plain
from pope_tpu_torch.ops.window_attention import windowed_attention_relpos_plain

TOL_F32 = 2e-5  # max abs error; outputs are softmax averages of v ~ N(0, 1)
LOG2E = 1.4426950408889634


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor: round to nearest, ties away from
    zero, keep 10 mantissa bits (the 13 low bits of the f32 pattern become
    0). Adding half a tf32 ulp to the sign-magnitude pattern and cutting
    rounds the magnitude half up, so ties go away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor, passes: int = 3, perm=None) -> torch.Tensor:
    """a @ b as the kernel takes it: one k8 step of the depth at a time (in
    the order `perm` within each step, the identity by default), each step
    as the small cross terms, then big . big (passes=1: big . big alone,
    one TF32 product), summed into one accumulator."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        idx = torch.arange(k0, k0 + 8) if perm is None else k0 + perm
        ab, as_, bb, bs = a_big[..., idx], a_small[..., idx], b_big[..., idx, :], b_small[..., idx, :]
        if passes == 3:
            out = out + as_ @ bb
            out = out + ab @ bs
        out = out + ab @ bb
    return out


# P V's order within an 8-key group: the A fragment holds key 2t at k = t
# and key 2t + 1 at k = t + 4, so V^T's slab holds keys 0, 2, 4, 6, 1, 3, 5, 7
PV_KEY_ORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
SMEM_LIMIT = 232448  # the bytes of shared memory a block may take
LONG_N = 1024  # from this many keys on, 128-query blocks at d_pad 80


def padded_head_dim(d: int) -> int:
    return next(p for p in (32, 64, 80, 128) if d <= p)


def query_tile(d: int, N: int, grid: int = 0) -> int:
    """The kernel's query rows a block (16-byte rows, as these tests' views
    are at d % 4 == 0): 128 at d_pad 80 from LONG_N keys on where the bias
    rows fit, 64 else."""
    dp = padded_head_dim(d)
    if dp == 80 and d % 4 == 0 and N >= LONG_N:
        if 256 + 8 * dp * (128 + 2 * 64) + 4 * 132 * grid <= SMEM_LIMIT:
            return 128
    return 64


def tile_keys(d: int, N: int = 0, grid: int = 0) -> int:
    """The kernel's keys a K / V tile at head dim d (padded to 32, 64, 80 or
    128) on a bias grid of hk + wk = grid (0: no bias): 64, 32 at d_pad 80
    in 64-query blocks, 32 (16 with the bias) at d_pad 128."""
    dp = padded_head_dim(d)
    if dp == 128:
        return 16 if grid else 32
    return 32 if dp == 80 and query_tile(d, N, grid) == 64 else 64


def tf32x3_attention(q, k, v, rel_h=None, rel_w=None, hk: int = 0, wk: int = 0, passes: int = 3):
    """The kernel's order of work on (B, N, nh, d) f32 views (rel_h
    (B, nh, N, hk), rel_w (B, nh, N, wk) or None): the head dim padded with
    zeros to d_pad, S = Q K^T one k8 step of it at a time, the online
    softmax over the kernel's key tiles with the ragged last tile masked
    to -inf, and each tile's P V summed from 0 over 8-key groups in the
    fragment's key order, then added to O. Returns (B, N, nh * d)."""
    B, N, nh, d = q.shape
    dp = padded_head_dim(d)
    TK = tile_keys(d, N, hk + wk)
    scale = torch.tensor(d**-0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    qh, kh, vh = (torch.nn.functional.pad(t.permute(0, 2, 1, 3), (0, dp - d)) for t in (q, k, v))
    qh = qh * scale
    n_pad = -N % TK  # the ragged last tile: zero keys, masked logits
    kh = torch.nn.functional.pad(kh, (0, 0, 0, n_pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, n_pad))
    live = torch.arange(N + n_pad) < N
    bias = None
    if rel_h is not None:
        rh, rw = rel_h * LOG2E, rel_w * LOG2E
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(B, nh, N, N)
        bias = torch.nn.functional.pad(bias, (0, n_pad))
    m = torch.full((B, nh, N), -torch.inf)
    l = torch.zeros(B, nh, N)
    o = torch.zeros(B, nh, N, dp)
    for k0 in range(0, N, TK):
        s = mm3(qh, kh[:, :, k0:k0 + TK].transpose(-1, -2), passes)
        if bias is not None:
            s = s + bias[..., k0:k0 + TK]
        s = s.masked_fill(~live[k0:k0 + TK], -torch.inf)
        mn = torch.maximum(m, s.amax(-1))
        c = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * c + p.sum(-1)
        o = o * c[..., None] + mm3(p, vh[:, :, k0:k0 + TK], passes, PV_KEY_ORDER)
        m = mn
    return (o[..., :d] / l[..., None]).permute(0, 2, 1, 3).reshape(B, N, nh * d)


def _max_err(out, ref) -> float:
    return float(np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32)).max())


def _qkv(seed, B, N, nh, d):
    return np.random.default_rng(seed).standard_normal((B, N, 3, nh, d)).astype(np.float32)


def _pallas_heads(qkv):
    """pope_tpu's flash_attention on the (B*nh, N, d) heads, in interpret
    mode, back to (B, N, nh * d)."""
    B, N, _, nh, d = qkv.shape
    heads = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * nh, N, d))
    ref = pallas_attention(*(heads(qkv[:, :, i]) for i in range(3)), interpret=True)
    return np.asarray(ref).reshape(B, nh, N, d).transpose(0, 2, 1, 3).reshape(B, N, nh * d)


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0**-10  # a tf32 ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0**-23, 1 + 1.5 * one_ulp,
                      3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, 0.0, -0.0], dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the split recovers x to 2^-22 of it, and small is itself tf32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = split(x)
    assert ((big + small - x).abs() <= x.abs() * 2.0**-21).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()


# SSL's two shapes at reduced batch (global crops N = 257: a ragged last key
# tile of 1 and a last query row alone; local crops N = 50), at DINOv2's
# d = 64 and at d = 20 (a head dim the kernel pads to 32); N one below, at
# and one above a key tile (64 keys at d_pad 64, 32 at d_pad 80 and 128),
# 65 leaving a last query tile of one row
SHAPES = [(1, 257, 2, 64), (2, 50, 2, 64), (1, 257, 2, 20), (2, 50, 2, 20),
          (1, 63, 2, 64), (1, 64, 2, 64), (1, 65, 2, 64), (1, 31, 2, 80), (1, 32, 2, 80), (1, 33, 2, 80),
          (1, 33, 1, 128)]


@pytest.mark.parametrize("B,N,nh,d", SHAPES)
def test_tf32x3_matches_plain_and_pallas(B, N, nh, d):
    qkv = _qkv(N + d, B, N, nh, d)
    t = torch.from_numpy(qkv)
    q, k, v = t.unbind(2)
    out = tf32x3_attention(q, k, v)
    assert out.shape == (B, N, nh * d)
    assert _max_err(out, flash_attention_plain(q, k, v)) < TOL_F32
    assert _max_err(out, _pallas_heads(qkv)) < TOL_F32


@pytest.mark.parametrize("B,N,nh,d", SHAPES)
def test_one_tf32_pass_misses_the_f32_tolerance(B, N, nh, d):
    """big . big alone (TF32's 10 mantissa bits) is 1e-4 to 1e-3 off: three
    passes are needed for f32's tolerance."""
    q, k, v = torch.from_numpy(_qkv(N + d, B, N, nh, d)).unbind(2)
    assert _max_err(tf32x3_attention(q, k, v, passes=1), flash_attention_plain(q, k, v)) > 5 * TOL_F32


def _window(seed=3, BW=1, nh=2, d=80, hk=14, wk=14):
    rng = np.random.default_rng(seed)
    N = hk * wk
    qkv = rng.standard_normal((BW, N, 3 * nh * d)).astype(np.float32)
    rel_h = (0.5 * rng.standard_normal((BW, nh, N, hk))).astype(np.float32)
    rel_w = (0.5 * rng.standard_normal((BW, nh, N, wk))).astype(np.float32)
    return qkv, rel_h, rel_w


def test_tf32x3_relpos_window_matches_plain_and_pallas():
    """SAM's 14x14 window at d = 80 with the decomposed bias: against the
    windowed and global plain versions and both Pallas kernels."""
    BW, nh, d, hk, wk = 1, 2, 80, 14, 14
    N = hk * wk
    qkv, rel_h, rel_w = _window(BW=BW, nh=nh, d=d, hk=hk, wk=wk)
    tq, trh, trw = (torch.from_numpy(a) for a in (qkv, rel_h, rel_w))
    q, k, v = tq.view(BW, N, 3, nh, d).unbind(2)
    out = tf32x3_attention(q, k, v, trh, trw, hk, wk)
    assert _max_err(out, windowed_attention_relpos_plain(tq, trh, trw, nh, d, hk, wk)) < TOL_F32
    assert _max_err(out, flash_attention_relpos_plain(q, k, v, trh, trw, hk, wk)) < TOL_F32
    ref = pallas_window(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), nh, d, hk, wk, interpret=True)
    assert _max_err(out, ref) < TOL_F32
    heads = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(BW * nh, N, -1))
    qkv5 = qkv.reshape(BW, N, 3, nh, d)
    ref = pallas_flash(*(heads(qkv5[:, :, i]) for i in range(3)), jnp.asarray(rel_h.reshape(BW * nh, N, hk)),
                       jnp.asarray(rel_w.reshape(BW * nh, N, wk)), hk, wk, q_tile=64, k_tile=N, interpret=True)
    ref = np.asarray(ref).reshape(BW, nh, N, d).transpose(0, 2, 1, 3).reshape(BW, N, nh * d)
    assert _max_err(out, ref) < TOL_F32
    assert _max_err(tf32x3_attention(q, k, v, trh, trw, hk, wk, passes=1), ref) > 5 * TOL_F32


def test_tile_plan_fits_the_widest_grid():
    """The kernel's tiles per padded head dim (tile_keys, query_tile above,
    as csrc/attention_f32.cu's constexpr plan) stage the split Q, K and V^T
    tiles and a 64-query block's bias rows at hk + wk = F32_MAX_GRID in one
    block's shared memory at every padded head dim; kernel 2's grid (48 x
    64) takes 128-query blocks with 64-key tiles, kernel 1's 14 x 14
    windows 64-query blocks with 32-key tiles."""
    for dp in (32, 64, 80, 128):
        tk = tile_keys(dp, 196, F32_MAX_GRID)
        assert 256 + 8 * dp * (64 + 2 * tk) + 4 * 68 * F32_MAX_GRID <= SMEM_LIMIT
        assert tk % 16 == 0 and tile_keys(dp) % 16 == 0
    assert (query_tile(80, 3072, 112), tile_keys(80, 3072, 112)) == (128, 64)
    assert (query_tile(80, 196, 28), tile_keys(80, 196, 28)) == (64, 32)
    assert (query_tile(64, 257), tile_keys(64, 257)) == (64, 64)
    assert (tile_keys(128), tile_keys(128, 473, 474)) == (32, 16)


def test_tf32x3_refuses_what_it_does_not_take():
    """bf16 operands, d > 128 and bias grids past F32_MAX_GRID: ValueError
    before any launch. Every float32 head dim up to 128 is taken, whole
    16-byte chunks or not (the kernel reads other rows 4 bytes at a time)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert _resolve_design("tf32x3", f32, 16, 32) == "tf32x3"
    assert _resolve_design("tf32x3", f32, 16, 30) == "tf32x3"
    assert _resolve_design("tf32x3", f32, 473, 128, 1, 473) == "tf32x3"
    for dtype, N, d, hk, wk in ((bf16, 16, 32, 0, 0), (f32, 16, 160, 0, 0), (f32, 474, 128, 1, 474)):
        with pytest.raises(ValueError, match="does not take"):
            _resolve_design("tf32x3", dtype, N, d, hk, wk)
