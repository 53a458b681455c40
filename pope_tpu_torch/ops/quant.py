"""w8a8 int8 dense layers (port of pope_tpu/ops/quant.py).

Weights are quantized symmetrically per OUTPUT channel and activations
symmetrically per TOKEN (row); the product runs int8 x int8 -> int32
(`torch._int_mm`: the card's int8 tensor-core GEMM, the same call on the
CPU), and the two scales multiply back in f32 afterwards. The JAX package
runs this product as XLA's `dot_general(preferred_element_type=int32)`,
outside any Pallas kernel, so a library product stands here too.

The arithmetic is pope_tpu's, in its order, so the int8 tensors and the
int32 products agree bit for bit: the scale is the abs-max in the input's
dtype, cast to f32, times f32(1/127), then floored at eps; values are
divided by the scale, rounded half to even (jnp.round and torch.round both
do), clamped to [-127, 127]; the output is int32 -> f32 times
(x_scale * w_scale), the product of the scales first, plus the f32 bias,
cast to the output dtype. XLA fuses that product and sum into one FMA (one
rounding); `torch.addcmul` does the same, where a product and a sum would
round twice and miss by thousands of ulps where the bias cancels the
product.

pope_tpu writes the scale as `amax / 127.0`, but every program it runs is
jitted, and XLA's algebraic simplifier rewrites a division by a constant
into a product with the constant's f32 reciprocal (0.00787401572), which
differs from the division in the last bit of about 3% of scales. The port
writes that product: PyTorch's CUDA division by a Python scalar is the same
product anyway, and the CPU's a true division, so the product also keeps the
card and the CPU equal. (The division by the per-row scale is not rewritten
in either package.)

`QuantDense` has `nn.Linear`'s parameters (weight (out, in), bias (out,)),
so the weights bridge maps a pope_tpu `QuantDense` or `Dense` tree
(kernel (in, out) + bias) unchanged, and one state_dict applies quantized or
not. Its weight is quantized inside every call, as pope_tpu's is: a weight
load or an optimizer step needs no cache to be dropped. In a tp-sharded
layer (parallel/mesh.py::shard_params_tp) the input enters replicated, so a
token's scale is taken over its whole row, and each output channel's weight
scale is local to the shard that holds the channel: the sharded product
equals the unsharded one.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# f32(1/127): what XLA turns pope_tpu's `/ 127.0` into in a jitted program
INV_127 = 1.0 / 127.0


def quantize_rows(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-row (last-axis) int8 quantization: (x8, scale) with
    x ~= x8 * scale, scale f32 shaped like x with the last axis size 1."""
    scale = x.abs().amax(dim=-1, keepdim=True).float() * INV_127
    scale = torch.clamp_min(scale, eps)
    x8 = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return x8, scale


def quantize_weight_cols(w: torch.Tensor, eps: float = 1e-8):
    """Symmetric per-output-channel quantization of an (out, in) Linear
    weight: (w8, scale) with w ~= w8 * scale[:, None], scale f32 (out,),
    which broadcasts over an output's (..., out)."""
    scale = w.abs().amax(dim=1).float() * INV_127
    scale = torch.clamp_min(scale, eps)
    w8 = torch.clamp(torch.round(w.float() / scale[:, None]), -127, 127).to(torch.int8)
    return w8, scale


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (out, K) int8 weight -> (M, out) int32. On the card
    `_int_mm` takes a row-major (M, K) operand and a column-major (K, out)
    one, which `w8.t()` of the (out, K) tensor is; it refuses M <= 16 and K
    or out not multiples of 8, and then raises (no float fall back)."""
    dense_w8a8.launches += 1
    return torch._int_mm(x8, w8.t())


def rescale_int32(y: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: torch.Tensor | None, out_dtype) -> torch.Tensor:
    """The epilogue: int32 products (..., out) -> f32 times x_scale * w_scale,
    plus the bias in one rounding, cast to out_dtype."""
    scale = x_scale * w_scale
    y = y.float() * scale if bias is None else torch.addcmul(bias.float(), y.float(), scale)
    return y.to(out_dtype)


def dense_w8a8(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None, out_dtype) -> torch.Tensor:
    """int8 x int8 -> int32 dense over the last axis of x, rescaled to
    out_dtype. x: (..., in); w8: (out, in) int8; w_scale: (out,) f32.
    `dense_w8a8.launches` counts the int8 products."""
    x8, x_scale = quantize_rows(x)
    y = int8_matmul(x8.reshape(-1, x.shape[-1]), w8).view(*x.shape[:-1], -1)
    return rescale_int32(y, x_scale, w_scale, bias, out_dtype)


dense_w8a8.launches = 0


class QuantDense(nn.Linear):
    """nn.Linear with the product on the int8 path (w8a8): the same
    parameter names and shapes, so a state_dict made for nn.Linear loads
    unchanged. The output has the input's dtype (the SAM encoder's `dense`
    helper gives it the compute dtype instead)."""

    def forward(self, x):
        w8, w_scale = quantize_weight_cols(self.weight)
        return dense_w8a8(x, w8, w_scale, self.bias, x.dtype)


def make_dense(quantize: str | None):
    """Linear factory: 'none' / '' / None -> nn.Linear, 'int8' -> QuantDense."""
    if quantize == "int8":
        return QuantDense
    if quantize in ("none", "", None):
        return nn.Linear
    raise ValueError(f"unknown quantize mode: {quantize!r}")
