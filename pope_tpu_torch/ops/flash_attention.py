"""Streaming attention: the CUDA kernels' wrappers and their plain PyTorch
versions.

- `flash_attention_relpos`, with decomposed rel-pos bias, for SAM's global
  layers (port of pope_tpu/ops/flash_attention.py::flash_attention_relpos);
- `flash_attention`, bias-free, for DINOv2's blocks (port of
  pope_tpu/ops/flash_attention.py::flash_attention).

Four hand-written CUDA designs serve both wrappers, picked by shape
(`cuda_kernels.attention_design`; each wrapper counts its launches per design
in `launches_by_design` and per token count N in `launches_by_tokens`):
- "short" (csrc/attention_short.cu) holds a whole head in shared memory and
  its key row in registers: bf16, N <= 256, so DINOv2's 197 tokens;
- "long" (csrc/attention_long.cu) streams 128-key tiles past 128-query
  items (a TMA producer, two wgmma consumer warpgroups of 64 query rows,
  each issuing S of key tile j with P V of tile j - 1 and running tile j's
  softmax while P V runs) with an online softmax, the bias
  rel_h[q, k // wk] + rel_w[q, k % wk] added in registers, so the (N, N)
  logits never reach device memory: the other bf16 shapes, SAM's global
  layers (N = 3072) among them;
- "tf32x3" (csrc/attention_f32.cu, shared with the windowed layers) takes
  float32: K / V tiles of up to 64 keys past 64- or 128-query tiles, split
  into TF32 big and small parts, each product as three TF32 wgmma products,
  about f32's accuracy: the SSL step's f32 DINOv2 (N = 257 and 50), the f32
  SAM configs;
- "stream" (csrc/attention_relpos.cu, shared with the windowed layers) does
  the same with mma.sync or f32 FMAs: the shapes the others do not take.
Logits, softmax statistics and sums are f32; the scale is d^-1/2. In bf16
the kernels round the softmax weights to bf16 for the p . v product on the
tensor cores, where the plain version keeps them f32.

Unlike the JAX entry, which takes (B*nh, N, d) copies, q, k and v are
(B, N, nh, d) views: the encoder passes slices of its qkv Dense output as
they are, and the output comes back in the `proj` input layout. The
bias-free kernels are the sources' HAS_BIAS=false instantiations: no rel
tables, masked key tails, unwritten query tails.

Each wrapper calls one registered op (`torch.ops.pope.flash_attention_relpos`,
`torch.ops.pope.flash_attention`) on every path: its CUDA implementation
launches the kernel on the current stream and counts the launch, its CPU
implementation is the plain version, its fake keeps the output's shape and
dtype. So `torch.export` records the op as one graph node, and an exported
program launches (and counts) the kernel as eager code does. The backward of
every op is the plain version's: the kernels have no VJP.
"""

from __future__ import annotations

import torch

from pope_tpu_torch.ops.cuda_kernels import DESIGNS, attention_design, launch_attention, launch_attention_relpos


def flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk: int, wk: int):
    """The kernel's arithmetic in plain PyTorch (same shapes as the wrapper)."""
    B, N, nh, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(B, nh, N, N)
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.reshape(B, N, nh * d).to(q.dtype)


def count_tokens(wrapper, n_tokens: int) -> None:
    wrapper.launches_by_tokens[n_tokens] = wrapper.launches_by_tokens.get(n_tokens, 0) + 1


def register_plain_backward(op, plain, n_tensors: int):
    """Give the registered `op` the VJP of its plain version, taken from
    its first n_tensors inputs (the rest are ints)."""

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_tensors])
        ctx.rest = inputs[n_tensors:]

    def backward(ctx, grad):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
            out = plain(*xs, *ctx.rest)
            need = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(out, need, grad)) if need else iter(())
        return (*(next(got) if x.requires_grad else None for x in xs), *([None] * len(ctx.rest)))

    op.register_autograd(backward, setup_context=setup_context)


@torch.library.custom_op("pope::flash_attention_relpos", mutates_args=(), device_types="cpu")
def _flash_attention_relpos_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                               rel_w: torch.Tensor, hk: int, wk: int) -> torch.Tensor:
    return flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk)


@_flash_attention_relpos_op.register_kernel("cuda")
def _(q, k, v, rel_h, rel_w, hk, wk):
    design = attention_design(q.dtype, q.shape[1], q.shape[3], hk, wk)
    out = launch_attention_relpos(q, k, v, rel_h, rel_w, hk, wk, design)
    flash_attention_relpos.launches += 1
    flash_attention_relpos.launches_by_design[design] += 1
    count_tokens(flash_attention_relpos, q.shape[1])
    return out


@_flash_attention_relpos_op.register_fake
def _(q, k, v, rel_h, rel_w, hk, wk):
    B, N, nh, d = q.shape
    return q.new_empty((B, N, nh * d))


register_plain_backward(_flash_attention_relpos_op, flash_attention_relpos_plain, 5)


def flash_attention_relpos(q, k, v, rel_h, rel_w, hk: int, wk: int):
    """Fused attention + decomposed rel-pos bias.

    q, k, v: (B, N, nh, d), N = hk * wk keys in row-major (kh, kw) order; on
             CUDA any views with a unit last stride.
    rel_h:   (B, nh, N, hk) bias against the key row.
    rel_w:   (B, nh, N, wk) bias against the key column.
    Returns (B, N, nh*d) in q.dtype.

    Through `torch.ops.pope.flash_attention_relpos`: a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel attention_design picks.
    """
    if q.shape[1] != hk * wk:
        raise ValueError(f"q {tuple(q.shape)} does not fit a {hk}x{wk} key grid")
    return torch.ops.pope.flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)


flash_attention_relpos.launches = 0
flash_attention_relpos.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_attention_relpos.launches_by_tokens = {}


def flash_attention_plain(q, k, v):
    """softmax(q k^T d^-1/2) v in plain PyTorch, f32 logits and softmax (same
    shapes as the wrapper)."""
    B, N, nh, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.reshape(B, N, nh * d).to(q.dtype)


@torch.library.custom_op("pope::flash_attention", mutates_args=(), device_types="cpu")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention_plain(q, k, v)


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v):
    design = attention_design(q.dtype, q.shape[1], q.shape[3])
    out = launch_attention(q, k, v, design)
    flash_attention.launches += 1
    flash_attention.launches_by_design[design] += 1
    count_tokens(flash_attention, q.shape[1])
    return out


@_flash_attention_op.register_fake
def _(q, k, v):
    B, N, nh, d = q.shape
    return q.new_empty((B, N, nh * d))


register_plain_backward(_flash_attention_op, flash_attention_plain, 3)


def flash_attention(q, k, v):
    """Fused bias-free attention, scale d^-1/2 on the true head dim.

    q, k, v: (B, N, nh, d); on CUDA any views with a unit last stride (the
             (B, N, 3, nh, d) view of a qkv Dense output, sliced, is fine).
    Returns (B, N, nh*d) in q.dtype.

    Through `torch.ops.pope.flash_attention`: a CPU tensor takes the plain
    version; a CUDA tensor launches the kernel attention_design picks.
    """
    return torch.ops.pope.flash_attention(q, k, v)


flash_attention.launches = 0
flash_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_attention.launches_by_tokens = {}
