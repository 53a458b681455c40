"""The port's w8a8 dense (pope_tpu_torch/ops/quant.py) and the int8 and
bias-free SAM encoders against pope_tpu's on the same seeded inputs.

The quantizers and the dense epilogue are held bit for bit against
pope_tpu's JITTED functions: every program pope_tpu runs is jitted, and
there XLA rewrites `amax / 127.0` into `amax * f32(1/127)` and fuses the
epilogue's product and bias sum into one FMA. Eager JAX divides instead: the
last test shows that ~3% of its scales then differ in the last bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import pope_tpu.ops.quant as jq
import pope_tpu_torch.ops.quant as tq
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch.utils.bf16_storage import cast_sam_storage
from tests.test_torch_common import f32, jax_params, port_sam, tiny_cfg, to_jax

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape_x=(3, 100, 256), out=192):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, shape_x).astype(np.float32)
    w = (rng.normal(0, 1, (shape_x[-1], out)) / np.sqrt(shape_x[-1])).astype(np.float32)
    b = rng.normal(0, 0.1, out).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_quantizers_bit_equal_to_jax(dt):
    jdt, tdt = DTYPES[dt]
    x, w, _ = _inputs(0)
    j8, js = jax.jit(jq.quantize_rows)(jnp.asarray(x).astype(jdt))
    t8, ts = tq.quantize_rows(torch.from_numpy(x).to(tdt))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 100, 1)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jw8, jws = jax.jit(jq.quantize_weight_cols)(jnp.asarray(w).astype(jdt))
    tw8, tws = tq.quantize_weight_cols(torch.from_numpy(w.T.copy()).to(tdt))  # (out, in)
    assert tws.shape == (192,)
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8).T)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws)[0])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_dense_w8a8_bit_equal_to_jax(dt, bias):
    """f32 and bf16 outputs are exact (0 ulp), with and without the bias."""
    jdt, tdt = DTYPES[dt]
    x, w, b = _inputs(1)
    jw8, jws = jax.jit(jq.quantize_weight_cols)(jnp.asarray(w))
    jb = jnp.asarray(b) if bias else None
    ref = jax.jit(lambda x, w8, ws: jq.dense_w8a8(x, w8, ws, jb, jdt))(jnp.asarray(x).astype(jdt), jw8, jws)
    tw8, tws = tq.quantize_weight_cols(torch.from_numpy(w.T.copy()))
    out = tq.dense_w8a8(torch.from_numpy(x).to(tdt), tw8, tws, torch.from_numpy(b) if bias else None, tdt)
    assert out.dtype == tdt and out.shape == (3, 100, 192)
    np.testing.assert_array_equal(f32(out), f32(ref))


def test_int_mm_is_the_exact_int_product():
    """The int8 product against the plain int64 matmul: exact (|sum| <=
    127^2 * K < 2^31), at a shape _int_mm takes on the card too, and it
    counts one launch a call."""
    rng = np.random.default_rng(2)
    x8 = torch.from_numpy(rng.integers(-127, 128, (40, 640)).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (24, 640)).astype(np.int8))
    before = tq.dense_w8a8.launches
    y = tq.int8_matmul(x8, w8)
    assert tq.dense_w8a8.launches == before + 1
    assert y.dtype == torch.int32
    torch.testing.assert_close(y.long(), x8.long() @ w8.long().t(), rtol=0, atol=0)
    extreme = torch.full((17, 5120), 127, dtype=torch.int8)
    assert int(tq.int8_matmul(extreme, extreme[:8]).max()) == 127 ** 2 * 5120


def test_quantize_rows_roundtrip_and_zero_row():
    """pope_tpu's properties (tests/test_quant.py): error <= scale / 2, the
    row max at +-127, a zero row quantizes to 0 with a finite scale."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((7, 33, 256)).astype(np.float32))
    x8, s = tq.quantize_rows(x)
    assert (x8.float() * s - x).abs().le(s / 2 + 1e-7).all()
    assert x8.abs().amax(-1).min() == 127
    z8, zs = tq.quantize_rows(torch.zeros(3, 16))
    assert z8.sum() == 0 and torch.isfinite(zs).all()
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 128)).astype(np.float32))
    w8, ws = tq.quantize_weight_cols(w)
    assert (w8.float() * ws[:, None] - w).abs().le(ws[:, None] / 2 + 1e-7).all()


def test_dense_w8a8_matches_f32_dense():
    """rel < 2e-2 and cos > 0.999 against the exact f32 product, as
    pope_tpu's test_dense_w8a8_matches_f32_dense."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 196, 384)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((512, 384)) / np.sqrt(384)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    ref = x @ w.t() + b
    out = tq.dense_w8a8(x, *tq.quantize_weight_cols(w), b, torch.float32)
    rel = float((out - ref).norm() / ref.norm())
    cos = float((out * ref).sum() / (out.norm() * ref.norm()))
    assert rel < 2e-2 and cos > 0.999, (rel, cos)


def test_quantdense_state_dict_is_linear_and_make_dense():
    q, lin = tq.QuantDense(64, 48), nn.Linear(64, 48)
    assert {k: v.shape for k, v in q.state_dict().items()} == {k: v.shape for k, v in lin.state_dict().items()}
    q.load_state_dict(lin.state_dict())
    x = torch.randn(2, 10, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out_q, out_d = q(x), lin(x)
    assert out_q.dtype == torch.float32
    assert float((out_q - out_d).norm() / out_d.norm()) < 3e-2
    assert q(x.bfloat16()).dtype == torch.bfloat16
    assert tq.make_dense("none") is nn.Linear and tq.make_dense("") is nn.Linear and tq.make_dense(None) is nn.Linear
    assert tq.make_dense("int8") is tq.QuantDense
    with pytest.raises(ValueError):
        tq.make_dense("int4")


def _int8_cfg(shipped: bool, **enc):
    cfg = tiny_cfg(shipped)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **enc))


def _jax_encode(cfg, params, x):
    jsam = JaxSam(cfg)
    return f32(jax.jit(lambda v, x: jsam.apply(v, x, method=jsam.encode_image))(to_jax(params), x))


def _capture_jax_x8(monkeypatch, sink):
    """Record every int8 activation pope_tpu's jitted encoder makes, in
    call order."""
    real = jq.quantize_rows

    def recording(x, eps=1e-8):
        x8, s = real(x, eps)
        jax.debug.callback(lambda a: sink.append(np.asarray(a)), x8, ordered=True)
        return x8, s

    monkeypatch.setattr(jq, "quantize_rows", recording)


def _capture_port_x8(monkeypatch, sink):
    real = tq.quantize_rows

    def recording(x, eps=1e-8):
        x8, s = real(x, eps)
        sink.append(x8.numpy().copy())
        return x8, s

    monkeypatch.setattr(tq, "quantize_rows", recording)


# Tolerances, (block rel L2, share of int8 entries that differ, whole
# encoder rel L2). Each port block after the first is given pope_tpu's input
# to that block. f32: the attention and LayerNorm reassociate (~1e-7
# relative), so only values within that of a round-half step flip, by one
# int8 level (the forced blocks land within 1e-7 to 4e-5; block 0, given the
# port's own patch embedding, 3e-4). bf16: XLA keeps excess precision inside
# its fusions (`xla_allow_excess_precision`, on by default), so pope_tpu's
# jitted encoder skips bf16 roundings that its source writes and the port
# performs, e.g. the residual sum's before the next LayerNorm; a bf16 ulp
# (2^-8 of a value) is half an int8 step (2^-7 of the row max) of a large
# entry, so 6-36% of the entries of a call flip. With
# XLA_FLAGS=--xla_allow_excess_precision=false a forced block's first int8
# activation is bit-equal to the port's. Through the whole encoder every
# flip moves its product by a step and shifts later activations past more
# round-half points: the flips compound block by block (8% of f32 entries
# differ by the last block of the unforced run), yet the port stays closer
# to pope_tpu's int8 output than either is to the float encoder (f32: 7.7e-3
# against 1.6e-2; bf16: 1.8e-2 against 1.9e-2).
INT8_TOL = {False: (1e-3, 2e-4, 1.2e-2), True: (1.5e-2, 0.3, 3e-2)}


def _block_input(enc, x):
    """The port encoder's input to its first block."""
    from pope_tpu_torch.models.sam.encoder import conv_nhwc

    h = conv_nhwc(enc.patch_embed, x, enc.dtype)
    return h + enc.pos_embed[:, :h.shape[1], :h.shape[2]].to(enc.dtype)


@pytest.mark.parametrize("shipped", [False, True], ids=["f32_erf", "bf16_tanh"])
def test_int8_encoder_matches_jax(monkeypatch, shipped):
    cfg = _int8_cfg(shipped, quantize="int8")
    params = jax_params(cfg, seed=0)
    x = np.random.default_rng(1).uniform(-2, 2, (2, 192, 256, 3)).astype(np.float32)
    jx8, tx8 = [], []
    _capture_jax_x8(monkeypatch, jx8)
    jsam = JaxSam(cfg)
    ref, state = jax.jit(lambda v, x: jsam.apply(v, x, method=jsam.encode_image, capture_intermediates=True))(
        to_jax(params), x)
    jax.effects_barrier()
    blocks_out = [state["intermediates"]["image_encoder"][f"block_{i}"]["__call__"][0]
                  for i in range(cfg.encoder.depth)]
    sam = port_sam(cfg, params)
    enc = sam.image_encoder
    assert isinstance(enc.block_0.mlp_lin1, tq.QuantDense) and isinstance(enc.block_1.qkv, tq.QuantDense)
    tol_block, tol_share, tol_whole = INT8_TOL[shipped]
    _capture_port_x8(monkeypatch, tx8)
    before = tq.dense_w8a8.launches
    with torch.no_grad():
        h = _block_input(enc, torch.from_numpy(x))
        for i in range(cfg.encoder.depth):
            out = getattr(enc, f"block_{i}")(h)
            rel = np.linalg.norm(f32(out) - f32(blocks_out[i])) / np.linalg.norm(f32(blocks_out[i]))
            assert rel <= tol_block, (i, rel)
            h = torch.from_numpy(f32(blocks_out[i])).to(enc.dtype)
    assert tq.dense_w8a8.launches - before == 4 * cfg.encoder.depth
    assert len(jx8) == len(tx8) == 4 * cfg.encoder.depth
    assert all(a.shape == b.shape for a, b in zip(jx8, tx8))
    flips = sum(int((a != b).sum()) for a, b in zip(jx8, tx8))
    size = sum(a.size for a in jx8)
    print(f"int8 encoder ({'bf16' if shipped else 'f32'}): {flips} of {size} int8 entries flip")
    assert flips / size <= tol_share, (flips, size)
    monkeypatch.undo()
    with torch.no_grad():
        whole = f32(sam.encode_image(torch.from_numpy(x)))
    ref = f32(ref)
    assert whole.shape == ref.shape == (2, 12, 16, 64) and np.isfinite(whole).all()
    rel = np.linalg.norm(whole - ref) / np.linalg.norm(ref)
    assert rel <= tol_whole, rel


def test_bf16_storage_leaves_int8_encoder_f32():
    """cast_sam_storage keeps a quantized encoder's weights f32 (they are
    quantized from the f32 master copy), so its output is unchanged."""
    cfg = _int8_cfg(True, quantize="int8")
    params = jax_params(cfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-2, 2, (1, 192, 256, 3)).astype(np.float32))
    sam = port_sam(cfg, params)
    with torch.no_grad():
        ref = sam.encode_image(x)
        cast_sam_storage(sam, cfg.encoder)
        out = sam.encode_image(x)
    assert all(p.dtype == torch.float32 for p in sam.image_encoder.parameters())
    assert torch.equal(out, ref)


# f32: the same reassociation as the rel-pos encoder (test_torch_encoder.py).
# bf16: jax.nn.dot_product_attention rounds the softmax weights to bf16
# before the p . v product where the plain version keeps them f32.
NO_REL_TOL = {False: (2e-5, 2e-6), True: (0.1, 0.015)}  # (max abs, mean abs)


@pytest.mark.parametrize("shipped", [False, True], ids=["f32_erf", "bf16_tanh"])
def test_encoder_without_rel_pos_matches_jax(shipped):
    """use_rel_pos=False: the same parameter tree as pope_tpu's (no rel
    tables: port_sam asserts nothing is missing or left over), and both
    layer kinds through the bias-free attention."""
    cfg = _int8_cfg(shipped, use_rel_pos=False)
    params = jax_params(cfg, seed=4)
    assert not any(k.startswith("rel_pos") for blk in params["params"]["image_encoder"].values()
                   if isinstance(blk, dict) for k in blk)
    sam = port_sam(cfg, params)
    assert not any("rel_pos" in k for k in sam.state_dict())
    x = np.random.default_rng(5).uniform(-2, 2, (2, 192, 256, 3)).astype(np.float32)
    ref = _jax_encode(cfg, params, x)
    with torch.no_grad():
        out = f32(sam.encode_image(torch.from_numpy(x)))
    err = np.abs(out - ref)
    tol_max, tol_mean = NO_REL_TOL[shipped]
    assert err.max() < tol_max and err.mean() < tol_mean, (err.max(), err.mean())


def test_eager_jax_divides_where_jit_multiplies():
    """Why the port multiplies by f32(1/127): pope_tpu's eager quantize_rows
    divides, and its scales then differ from the jitted ones (and the
    port's) in the last bit; the int8 values agree here."""
    x = jnp.asarray(np.random.default_rng(6).normal(0, 3, (3000, 64)).astype(np.float32))
    _, eager = jq.quantize_rows(x)
    _, jitted = jax.jit(jq.quantize_rows)(x)
    _, port = tq.quantize_rows(torch.from_numpy(np.asarray(x)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(jitted))
    differ = float(np.mean(np.asarray(eager) != np.asarray(jitted)))
    assert 0 < differ < 0.1, differ
