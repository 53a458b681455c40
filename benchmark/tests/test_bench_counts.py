"""The frozen FLOP budget and the attention operations and bytes, against
values worked out by hand."""

import types

import pytest
import torch

from benchmark.counts import attention, flops, peaks


def test_vit_flops_by_hand():
    # 2 tokens, 1 layer, width 4, MLP x4: 2*2*16*(3+1+8) = 768 in the
    # products, 4*2*2*4 = 64 in the attention einsums
    assert flops.vit_flops(2, 1, 4) == 768 + 64
    # windowed: 1 of 2 layers global over 8 tokens, 2 windows of 2x2
    lin = 2 * 2 * 8 * 4 * 4 * 12
    assert flops.vit_flops(8, 2, 4, window=2, n_windows=2) == lin + 4 * 2 * 16 * 4 * 2
    assert flops.vit_flops(8, 2, 4, window=2, n_windows=2, n_global=1) == lin + 4 * 2 * 16 * 4 + 4 * 64 * 4


def test_sam_terms_are_bench_py_s():
    from pope_tpu_torch.bench import bench_config, flop_budget

    cfg = bench_config()
    got = flops.sam_flops(cfg, cfg.amg.eval_decode_subsample)
    want = flop_budget(types.SimpleNamespace(config=cfg))
    assert got["sam_encode"] == pytest.approx(want["sam_encode"], rel=1e-12)
    assert got["amg_decode"] == pytest.approx(want["amg_decode"], rel=1e-12)
    assert flops.token_grid(cfg) == (48, 64)
    img = flops.image_flops(cfg)
    # the full-resolution decode runs 16x the subsampled upscaling
    assert img["amg_decode"] > got["amg_decode"] and img["sam_encode"] == got["sam_encode"]
    assert img["total"] == img["sam_encode"] + img["amg_decode"]


def test_attention_counts_by_hand():
    bf = torch.bfloat16
    qkv = torch.zeros(2, 4, 3 * 2 * 8, dtype=bf)  # BW 2, N 4, nh 2, d 8
    rel_h = torch.zeros(2, 2, 4, 2, dtype=bf)
    rel_w = torch.zeros(2, 2, 4, 2, dtype=bf)
    nbytes, ops, dtype = attention.windowed_attention_relpos(qkv, rel_h, rel_w, 2, 8, 2, 2)
    assert nbytes == 2 * (2 * 4 * 48 + 32 + 32 + 2 * 4 * 16)
    assert ops == 4 * 2 * 2 * 4 * 4 * 8 and dtype == bf
    q = torch.zeros(1, 6, 3, 4)  # float32: the 3xTF32 rate
    nbytes, ops, dtype = attention.flash_attention(q, q, q)
    assert nbytes == 4 * 4 * 6 * 3 * 4 and ops == 4 * 3 * 36 * 4
    assert attention.bound_s(nbytes, ops, dtype) == max(nbytes / peaks.HBM_BYTES_PER_S, ops / 164.83333333333334e12)
    nbytes, ops, _ = attention.flash_attention_relpos(q.to(bf), q.to(bf), q.to(bf), torch.zeros(1, 3, 6, 2, dtype=bf),
                                                      torch.zeros(1, 3, 6, 3, dtype=bf), 2, 3)
    assert nbytes == 2 * (4 * 6 * 3 * 4 + 36 + 54) and ops == 4 * 3 * 36 * 4
