"""Ring attention: exact attention over a token axis sharded on an `sp`
mesh axis (port of pope_tpu/ops/ring_attention.py, which is plain jnp with
no Pallas kernel, so plain torch products are its port).

Each rank keeps f32 running (m, l, acc) for its queries, folds its own K/V
block first, then passes the K/V blocks round the ring S - 1 times,
shifting before each fold. Peak memory is O(N/S x N/S) logits per rank;
the scale is 1/sqrt(d); leading axes (batch, heads) ride along. The ring
shift is differentiable, so the whole is: a rank's loss is its part of the
global one, and a K/V block's gradient comes back to the rank that owns it.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from pope_tpu_torch.parallel.collectives import ring_shift


def _fold(q, k, v, m, l, acc, scale):
    """Online-softmax update of (m, l, acc) with one K/V block, in f32."""
    s = (q @ k.transpose(-1, -2)) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    return m_new, l * alpha + p.sum(dim=-1), acc * alpha[..., None] + p @ v


def ring_attention(mesh: DeviceMesh, axis: str = "sp"):
    """Build an exact sequence-parallel attention: (q, k, v) this rank's
    (..., N / S, d) token blocks (rank r holds tokens [r N/S, (r+1) N/S))
    -> its (..., N / S, d) output block, in the inputs' dtype."""
    S = mesh.shape[mesh.mesh_dim_names.index(axis)]
    group = mesh.get_group(axis)

    def call(q, k, v):
        in_dtype = q.dtype
        scale = 1.0 / (q.shape[-1] ** 0.5)
        q, k, v = (t.float() for t in (q, k, v))
        s = (q @ k.transpose(-1, -2)) * scale
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l, acc = p.sum(dim=-1), p @ v
        for _ in range(S - 1):
            k, v = ring_shift(k, group), ring_shift(v, group)
            m, l, acc = _fold(q, k, v, m, l, acc, scale)
        return (acc / l[..., None]).to(in_dtype)

    return call
