"""The last wave of the two bf16 Hopper attention kernels, on the CPU.

Both kernels are persistent and walk their items in waves: heads over the
card's SMs (csrc/attention_short.cu), units of a head's two 128-query tiles
over the clusters the card holds at once (csrc/attention_long.cu). Where the
last, partial wave leaves the card idle, ops/cuda_kernels.py's rule
(`tail_plan`) splits each of its items into s pieces: query tiles in the
short kernel, runs of key tiles in the long one, whose partial softmaxes the
last chunk to arrive merges in the same launch. The kernels run only on the
card (tests/test_torch_cuda.py holds them to their plain versions under
every plan); here:

- the plan at every shape of PERF.md's kernel table, with the H100's 132 SMs
  and 66 resident clusters given (chip_smoke.py fails on the card when the
  card's own plan differs from these);
- the long kernel's chunked softmax and merge emulated in plain PyTorch in
  float32, at its tile sizes (128 keys, or two whole key rows of 8
  ceil(wk / 8) slots each on grids of 32 < wk <= 64) and in its order of
  work (base-2 exponent units, chunk order), held to the port's plain
  versions and to pope_tpu's Pallas kernels in interpret mode at 1e-5 of
  the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pope_tpu.ops.flash_attention import flash_attention as pallas_attention
from pope_tpu.ops.flash_attention import flash_attention_relpos as pallas_relpos
from pope_tpu_torch.ops.cuda_kernels import (
    LONG_MAX_PIECES,
    LONG_ROW_SLOTS,
    LONG_TK,
    LONG_TQ,
    SHORT_TQ,
    long_key_tiles,
    long_plan,
    long_units,
    short_plan,
    tail_plan,
)
from pope_tpu_torch.ops.flash_attention import flash_attention_plain, flash_attention_relpos_plain

H100_SMS, H100_CLUSTERS = 132, 66  # the short kernel's resident blocks, the long kernel's clusters of two
TOL_REL = 1e-5  # f32: max |emulation - reference| / max |reference|
LOG2E = 1.4426950408889634


# ---- the plan


def _plan(design, B, N, nh, d, hk=0, wk=0):
    if design == "short":
        return short_plan(B, N, nh, resident=H100_SMS)
    return long_plan(B, N, nh, d, hk, wk, resident=H100_CLUSTERS)


@pytest.mark.parametrize("key", sorted(chip_smoke.TAIL_ROWS))
def test_every_kernel_row_takes_the_plan_chip_smoke_expects(key):
    """chip_smoke.py's rows (the kernel table's), at the H100's counts: the
    plan it checks on the card."""
    *shape, s = chip_smoke.TAIL_ROWS[key]
    assert _plan(*shape)["s"] == s


def test_plans_at_the_kernel_table_shapes():
    """Split where the last wave leaves the card idle, and only there:
    kernel 3 at demo-dinov2's N = 1025 (30 units on 66 clusters: 2 chunks of
    9 key tiles), kernel 2's sweep crop and portrait crop (208 units: 3 full
    waves and 10, each as 6 chunks), kernel 1 on the serving path's square
    frame (400 heads: 3 full waves and 4, each as 4 one-tile pieces) and one
    640x480 frame (320: 2 and 56, 2 pieces); every eval-path shape whole."""
    n1025 = _plan("long", 1, 1025, 6, 64)
    assert (n1025["units"], n1025["key_tiles"], n1025["split0"], n1025["s"]) == (30, 9, 0, 2)
    for hk, wk, tiles in ((52, 64, 26), (64, 52, 32)):  # crop, portrait crop
        crop = _plan("long", 1, hk * wk, 16, 80, hk, wk)
        assert (crop["units"], crop["key_tiles"], crop["split0"], crop["s"]) == (208, tiles, 198, 6)
    square, frame = _plan("short", 25, 196, 16, 80), _plan("short", 20, 196, 16, 80)
    assert (square["units"], square["split0"], square["s"]) == (400, 396, 4)
    assert (frame["units"], frame["split0"], frame["s"]) == (320, 264, 2)
    unsplit = [("short", 80, 196, 16, 80), ("short", 260, 197, 6, 64), ("short", 80, 196, 16, 80, 0, 0),
               ("long", 4, 3072, 16, 80, 48, 64), ("long", 1, 4096, 16, 80, 64, 64),
               ("long", 4, 3072, 16, 80, 64, 48), ("long", 4, 3072, 16, 80), ("long", 1, 3072, 16, 80, 48, 64)]
    for shape in unsplit:
        plan = _plan(*shape)
        assert (plan["split0"], plan["s"]) == (plan["units"], 1), shape


@pytest.mark.parametrize("units", [1, 29, 30, 33, 34, 65, 66, 67, 100, 131, 132, 133, 208, 400, 1280])
@pytest.mark.parametrize("resident,most", [(66, 8), (132, 2), (132, 4), (66, 1)])
def test_tail_plan_fills_at_most_one_wave(units, resident, most):
    """The full waves run whole; the last wave's r items run as s pieces
    each, 2 <= s <= most, and the r s pieces fit in one wave; a wave whose
    r items cannot take two pieces each (r > resident / 2), or a full last
    wave, splits nothing."""
    split0, s = tail_plan(units, resident, most)
    full, r = divmod(units, resident)
    if s == 1:
        assert split0 == units
        assert r == 0 or most < 2 or 2 * r > resident
    else:
        assert split0 == full * resident and 2 <= s <= most and r * s <= resident
        assert s == min(most, resident // r)


def test_plan_counts_follow_the_kernels_tiles():
    """The units and key tiles long_plan counts are the launcher's:
    ceil(ceil(N / 128) / 2) units a head, K/V tiles of 128 keys or (32 < wk
    <= 64) of two whole key rows; the short kernel's query tiles are 64
    rows, and a piece takes at least one."""
    assert (LONG_TQ, LONG_TK, LONG_ROW_SLOTS, SHORT_TQ) == (128, 128, 64, 64)
    assert long_units(1, 1025, 6) == 6 * 5 and long_units(2, 128, 3) == 6 and long_units(1, 257, 1) == 2
    assert long_key_tiles(1025) == 9 and long_key_tiles(257) == 3
    assert long_key_tiles(3328, 52, 64) == 26 and long_key_tiles(63 * 48, 63, 48) == 32
    assert long_key_tiles(320, 8, 40) == 4 and long_key_tiles(257, 1, 257) == 3  # rows; gathered
    assert long_key_tiles(128, 4, 32) == 1  # wk <= 32: gathered, 128-key tiles
    assert short_plan(1, 196, 16, resident=132)["query_tiles"] == 4
    assert _plan("long", 1, 1025, 6, 64)["s"] <= LONG_MAX_PIECES


# ---- the long kernel's chunked softmax and merge


def chunk_runs(n: int, pieces: int) -> list:
    """csrc/hopper.cuh's piece_of: piece p of an item's n steps is the run
    [p q + min(p, rem), + q + (p < rem)), q = n div pieces, rem = n mod
    pieces: ceil(n / pieces) or one fewer, the longer runs first."""
    q, rem = divmod(n, pieces)
    runs, lo = [], 0
    for p in range(pieces):
        hi = lo + q + (p < rem)
        runs.append((lo, hi))
        lo = hi
    return runs


def test_chunk_runs_partition_the_steps():
    for n in range(1, 33):
        for pieces in range(1, n + 1):
            runs = chunk_runs(n, pieces)
            assert runs[0][0] == 0 and runs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            sizes = [hi - lo for lo, hi in runs]
            assert sorted(sizes, reverse=True) == sizes and set(sizes) <= {-(-n // pieces), n // pieces}
    assert [hi - lo for lo, hi in chunk_runs(9, 2)] == [5, 4]
    assert [hi - lo for lo, hi in chunk_runs(26, 6)] == [5, 5, 4, 4, 4, 4]
    assert [hi - lo for lo, hi in chunk_runs(32, 6)] == [6, 6, 5, 5, 5, 5]


def key_tiles(N: int, hk: int, wk: int) -> list:
    """The kernel's K/V tiles as key indices (-1: a slot that holds no key:
    past N, past wk in a padded key row, or a second key row past an odd
    hk): 128 keys a tile, or on the "rows" grids two key rows of 8 ceil(wk /
    8) slots each."""
    if hk and LONG_ROW_SLOTS // 2 < wk <= LONG_ROW_SLOTS:
        slots = 8 * -(-wk // 8)
        tiles = []
        for kt in range(long_key_tiles(N, hk, wk)):
            keys = [kh * wk + kw if kh < hk and kw < wk else -1
                    for kh in (2 * kt, 2 * kt + 1) for kw in range(slots)]
            tiles.append(torch.tensor(keys))
        return tiles
    return [torch.tensor([k if k < N else -1 for k in range(k0, k0 + LONG_TK)]) for k0 in range(0, N, LONG_TK)]


def chunk_partial(qh, kh, vh, bias, tiles, scale):
    """One key chunk of the long kernel for every query row of one head, in
    f32: the online softmax over the chunk's tiles in the exponent's base-2
    units (without the bias the running maximum is of the raw logits and
    the exponent's scale is d^-1/2 log2 e, one FFMA a logit; with it the
    logits are s d^-1/2 + bias and the scale log2 e), slots that hold no key
    at -inf. Returns the partial the kernel stores: O unnormalised, the row
    maxima times the exponent's scale (m k2), the row sums. A row whose
    every key in the chunk is masked keeps m = -inf, l = 0 and O = 0."""
    k2 = scale * LOG2E if bias is None else LOG2E
    nq, d = qh.shape
    m = torch.full((nq,), -torch.inf)
    l = torch.zeros(nq)
    o = torch.zeros(nq, d)
    for keys in tiles:
        live = keys >= 0
        idx = keys.clamp(min=0)
        s = qh @ kh[idx].T
        x = s if bias is None else s * scale + bias[:, idx]
        x = x.masked_fill(~live, -torch.inf)
        mx = torch.maximum(m, x.amax(-1))
        safe = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)  # a tile with no live key for the row
        corr = torch.exp2((m - safe) * k2)
        p = torch.exp2(x * k2 - (safe * k2)[:, None])
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + p @ torch.where(live[:, None], vh[idx], torch.zeros_like(vh[idx]))
        m = mx
    return o, m * k2, l


def merge(partials):
    """merge_chunks: M = max_i m_i (0 where every m_i is -inf), weights
    2^(m_i - M) (0 for a chunk with m_i = -inf), O = sum_i w_i O_i / sum_i
    w_i l_i, in chunk order."""
    M = torch.stack([m for _, m, _ in partials]).amax(0)
    M = torch.where(M == -torch.inf, torch.zeros_like(M), M)
    o = torch.zeros_like(partials[0][0])
    l = torch.zeros_like(partials[0][2])
    for oi, mi, li in partials:
        w = torch.exp2(mi - M)
        o = o + w[:, None] * oi
        l = l + w * li
    return o / l[:, None]


def long_emulation(q, k, v, pieces: int, rel_h=None, rel_w=None, hk: int = 0, wk: int = 0):
    """The long kernel on (B, N, nh, d) f32 views with every unit split into
    `pieces` key chunks (pieces = 1: the unsplit body), each chunk's partial
    merged as the last chunk to arrive does. Returns (B, N, nh * d)."""
    B, N, nh, d = q.shape
    scale = d ** -0.5
    tiles = key_tiles(N, hk, wk)
    out = torch.empty(B, N, nh, d)
    for b in range(B):
        for h in range(nh):
            bias = None
            if rel_h is not None:
                bias = (rel_h[b, h][:, :, None] + rel_w[b, h][:, None, :]).reshape(N, N)
            partials = [chunk_partial(q[b, :, h], k[b, :, h], v[b, :, h], bias, tiles[lo:hi], scale)
                        for lo, hi in chunk_runs(len(tiles), pieces)]
            out[b, :, h] = merge(partials)
    return out.reshape(B, N, nh * d)


def _rel_err(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _qkv(seed, B, N, nh, d):
    return np.random.default_rng(seed).standard_normal((B, N, 3, nh, d)).astype(np.float32)


def _heads(a):
    """(B, N, nh, d) -> pope_tpu's (B * nh, N, d)"""
    B, N, nh, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * nh, N, d))


def _from_heads(a, B, nh):
    BH, N, d = a.shape
    return np.asarray(a).reshape(B, nh, N, d).transpose(0, 2, 1, 3).reshape(B, N, nh * d)


# N = 257: three 128-key tiles, the last holding one key; N = 1000: eight,
# a ragged last one; chunk counts 2, 3 and every tile its own chunk
NO_BIAS = [(1, 257, 2, 64, 1), (1, 257, 2, 64, 2), (1, 257, 2, 64, 3), (2, 1000, 1, 32, 2),
           (2, 1000, 1, 32, 3), (2, 1000, 1, 32, 8)]


@pytest.mark.parametrize("B,N,nh,d,pieces", NO_BIAS, ids=[f"{N}-{d}-s{s}" for _, N, _, d, s in NO_BIAS])
def test_chunked_softmax_matches_plain_and_pallas(B, N, nh, d, pieces):
    qkv = _qkv(N + pieces, B, N, nh, d)
    q, k, v = torch.from_numpy(qkv).unbind(2)
    out = long_emulation(q, k, v, pieces)
    assert out.shape == (B, N, nh * d) and torch.isfinite(out).all()
    assert _rel_err(out, flash_attention_plain(q, k, v)) < TOL_REL
    ref = pallas_attention(*(_heads(qkv[:, :, i]) for i in range(3)), interpret=True)
    assert _rel_err(out, _from_heads(ref, B, nh)) < TOL_REL


# the "rows" grids: hk = 5 and 7 (odd: the last tile's second key row past
# hk, its slots -inf), wk = 40 (rows of 40 slots), 37 (40 slots, 3 of them
# past wk: -inf) and 52 (56 slots); chunk counts 2, 3 and every tile
ROWS = [(5, 40, 2), (5, 40, 3), (7, 37, 2), (7, 37, 4), (6, 52, 3)]


def _rel(seed, B, nh, N, hk, wk):
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.standard_normal((B, nh, N, hk))).astype(np.float32),
            (0.5 * rng.standard_normal((B, nh, N, wk))).astype(np.float32))


@pytest.mark.parametrize("hk,wk,pieces", ROWS, ids=[f"{hk}x{wk}-s{s}" for hk, wk, s in ROWS])
def test_chunked_softmax_on_key_rows_matches_plain_and_pallas(hk, wk, pieces):
    B, nh, d, N = 1, 2, 80, hk * wk
    assert len(key_tiles(N, hk, wk)) == (hk + 1) // 2 >= pieces
    qkv = _qkv(hk * wk + pieces, B, N, nh, d)
    rel_h, rel_w = _rel(hk + wk, B, nh, N, hk, wk)
    q, k, v = torch.from_numpy(qkv).unbind(2)
    trh, trw = torch.from_numpy(rel_h), torch.from_numpy(rel_w)
    out = long_emulation(q, k, v, pieces, trh, trw, hk, wk)
    assert torch.isfinite(out).all()
    assert _rel_err(out, flash_attention_relpos_plain(q, k, v, trh, trw, hk, wk)) < TOL_REL
    flat = lambda a, n: jnp.asarray(a.reshape(B * nh, N, n))
    ref = pallas_relpos(*(_heads(qkv[:, :, i]) for i in range(3)), flat(rel_h, hk), flat(rel_w, wk), hk, wk,
                        q_tile=N, k_tile=N, interpret=True)
    assert _rel_err(out, _from_heads(ref, B, nh)) < TOL_REL


def test_chunked_softmax_on_a_gathered_grid_matches_plain():
    """A grid the kernel gathers per logit (wk = 20 <= 32): 128-key tiles
    across key rows, a ragged last one."""
    B, nh, d, hk, wk = 1, 2, 64, 15, 20
    N = hk * wk
    qkv = _qkv(7, B, N, nh, d)
    rel_h, rel_w = _rel(8, B, nh, N, hk, wk)
    q, k, v = torch.from_numpy(qkv).unbind(2)
    trh, trw = torch.from_numpy(rel_h), torch.from_numpy(rel_w)
    ref = flash_attention_relpos_plain(q, k, v, trh, trw, hk, wk)
    for pieces in (2, 3):
        assert _rel_err(long_emulation(q, k, v, pieces, trh, trw, hk, wk), ref) < TOL_REL


def test_a_chunk_whose_keys_are_all_masked_weighs_nothing():
    """Key rows 2 and 3 (the whole of tile 1, the second of three chunks)
    masked by rel_h = -inf for every query: that chunk's partial has
    m = -inf, l = 0, O = 0, weighs 2^-inf = 0 in the merge, and the output
    is finite and the plain version's."""
    B, nh, d, hk, wk = 1, 2, 64, 6, 40
    N = hk * wk
    qkv = _qkv(11, B, N, nh, d)
    rel_h, rel_w = _rel(12, B, nh, N, hk, wk)
    rel_h[..., 2:4] = -np.inf
    q, k, v = torch.from_numpy(qkv).unbind(2)
    trh, trw = torch.from_numpy(rel_h), torch.from_numpy(rel_w)
    bias = (trh[0, 0][:, :, None] + trw[0, 0][:, None, :]).reshape(N, N)
    tiles = key_tiles(N, hk, wk)
    o, m, l = chunk_partial(q[0, :, 0], k[0, :, 0], v[0, :, 0], bias, tiles[1:2], d ** -0.5)
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()
    out = long_emulation(q, k, v, 3, trh, trw, hk, wk)
    assert torch.isfinite(out).all()
    assert _rel_err(out, flash_attention_relpos_plain(q, k, v, trh, trw, hk, wk)) < TOL_REL
