"""SAM's windowed attention with decomposed rel-pos bias: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of pope_tpu/ops/window_attention.py::windowed_attention_relpos. Per
window (N = hk * wk tokens) and head:

    softmax(q . k^T * d^-1/2 + rel_h[q, k // wk] + rel_w[q, k % wk]) . v

reading q, k and v as column slices of the un-reshaped qkv Dense output and
writing the `proj` input layout. Logits and softmax are f32; the softmax
weights are rounded to the input type before p . v, which accumulates in f32.
On the card it runs one of the hand-written kernels, picked by shape
(`cuda_kernels.attention_design`) and counted per design in
`launches_by_design` (and per token count in `launches_by_tokens`): SAM's 14x14 windows in bf16 take csrc/attention_short.cu
(a whole window-head in shared memory, the bias as a tensor-core product);
larger bf16 windows csrc/attention_long.cu, float32 csrc/attention_f32.cu
(3xTF32 on the tensor cores) and the rest csrc/attention_relpos.cu, which
the global layers' wrapper (ops/flash_attention.py) shares. The
wrapper calls the registered op `torch.ops.pope.windowed_attention_relpos`
(CUDA: the kernel, counted; CPU: the plain version; see ops/flash_attention.py).
"""

from __future__ import annotations

import torch

from pope_tpu_torch.ops.cuda_kernels import DESIGNS, attention_design, launch_attention_relpos
from pope_tpu_torch.ops.flash_attention import count_tokens, register_plain_backward


def _split_qkv(qkv, nh: int, d: int):
    BW, N, _ = qkv.shape
    qkv5 = qkv.view(BW, N, 3, nh, d)
    return qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]


def windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh: int, d: int, hk: int, wk: int):
    """The kernel's arithmetic in plain PyTorch (same shapes as the wrapper)."""
    BW, N, _ = qkv.shape
    q, k, v = _split_qkv(qkv, nh, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(BW, nh, N, N)
    p = torch.softmax(s + bias, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.reshape(BW, N, nh * d).to(qkv.dtype)


@torch.library.custom_op("pope::windowed_attention_relpos", mutates_args=(), device_types="cpu")
def _windowed_attention_relpos_op(qkv: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, nh: int, d: int,
                                  hk: int, wk: int) -> torch.Tensor:
    return windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk)


@_windowed_attention_relpos_op.register_kernel("cuda")
def _(qkv, rel_h, rel_w, nh, d, hk, wk):
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    design = attention_design(qkv.dtype, qkv.shape[1], d, hk, wk)
    out = launch_attention_relpos(*_split_qkv(qkv, nh, d), rel_h, rel_w, hk, wk, design)
    windowed_attention_relpos.launches += 1
    windowed_attention_relpos.launches_by_design[design] += 1
    count_tokens(windowed_attention_relpos, qkv.shape[1])
    return out


@_windowed_attention_relpos_op.register_fake
def _(qkv, rel_h, rel_w, nh, d, hk, wk):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], nh * d))


register_plain_backward(_windowed_attention_relpos_op, windowed_attention_relpos_plain, 3)


def windowed_attention_relpos(qkv, rel_h, rel_w, nh: int, d: int, hk: int, wk: int):
    """Fused windowed attention + decomposed rel-pos bias.

    qkv:   (BW, N, 3*nh*d), the qkv Dense output ([q | k | v] blocks of nh*d
           columns, head h at columns h*d:(h+1)*d).
    rel_h: (BW, nh, N, hk), the q-projected row-bias table (q . Rh).
    rel_w: (BW, nh, N, wk), the q-projected column-bias table (q . Rw).
    Keys are row-major over the (hk, wk) window grid, N = hk * wk.
    Returns (BW, N, nh*d) in qkv.dtype.

    Through `torch.ops.pope.windowed_attention_relpos`: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel attention_design
    picks.
    """
    BW, N, C3 = qkv.shape
    if C3 != 3 * nh * d or N != hk * wk:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not fit nh={nh} d={d} on {hk}x{wk}")
    return torch.ops.pope.windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, hk, wk)


windowed_attention_relpos.launches = 0
windowed_attention_relpos.launches_by_design = dict.fromkeys(DESIGNS, 0)
windowed_attention_relpos.launches_by_tokens = {}
