"""Windowed attention with the decomposed rel-pos bias, in the frozen
reference: the plain arithmetic only. Per window (N = hk * wk tokens) and
head, softmax(q . k^T * d^-1/2 + rel_h[q, k // wk] + rel_w[q, k % wk]) . v,
logits and softmax in f32, the weights rounded to the input type before
p . v."""

from __future__ import annotations

import torch


def windowed_attention_relpos(qkv, rel_h, rel_w, nh: int, d: int, hk: int, wk: int):
    """qkv (BW, N, 3 nh d) as the qkv Dense writes it, rel_h (BW, nh, N, hk),
    rel_w (BW, nh, N, wk). Returns (BW, N, nh d)."""
    BW, N, _ = qkv.shape
    qkv5 = qkv.view(BW, N, 3, nh, d)
    q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(BW, nh, N, N)
    p = torch.softmax(s + bias, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.reshape(BW, N, nh * d).to(qkv.dtype)
