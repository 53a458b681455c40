"""Operations, bytes and roofline bound of one call into the port's three
attention entries, from its arguments' shapes (the formulas of
chip_smoke.py's kernel phase): q, k, v and the rel-pos tables read once,
the output written once, 4 B nh Nq Nk d operations. The bound is the
larger of bytes over HBM bandwidth and operations over the tensor cores'
rate (bf16, or 3xTF32 for float32 calls)."""

from __future__ import annotations

from benchmark.counts.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S, TF32X3_FLOP_PER_S


def _rate(dtype) -> float:
    return TF32X3_FLOP_PER_S if str(dtype).endswith("float32") else BF16_FLOP_PER_S


def bound_s(nbytes: float, flops: float, dtype) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / _rate(dtype))


def windowed_attention_relpos(qkv, rel_h, rel_w, nh: int, d: int, hk: int, wk: int) -> tuple:
    """(bytes, flops, dtype): qkv (BW, N, 3 nh d), rel tables (BW, nh, N, hk|wk)."""
    BW, N, _ = qkv.shape
    es = qkv.element_size()
    nbytes = es * (qkv.numel() + rel_h.numel() + rel_w.numel() + BW * N * nh * d)
    return nbytes, 4.0 * BW * nh * N * N * d, qkv.dtype


def flash_attention_relpos(q, k, v, rel_h, rel_w, hk: int, wk: int) -> tuple:
    """q, k, v (B, N, nh, d) views of the qkv output."""
    B, N, nh, d = q.shape
    es = q.element_size()
    nbytes = es * (4 * B * N * nh * d + rel_h.numel() + rel_w.numel())
    return nbytes, 4.0 * B * nh * N * N * d, q.dtype


def flash_attention(q, k, v) -> tuple:
    B, N, nh, d = q.shape
    es = q.element_size()
    return es * 4 * B * N * nh * d, 4.0 * B * nh * N * N * d, q.dtype


ENTRIES = {f.__name__: f for f in (windowed_attention_relpos, flash_attention_relpos, flash_attention)}
