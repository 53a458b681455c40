"""Global attention of the frozen reference: the plain arithmetic only
(softmax(q k^T d^-1/2 [+ rel-pos bias]) v with f32 logits and softmax). No
kernel, no registered op."""

from __future__ import annotations

import torch


def flash_attention_relpos(q, k, v, rel_h, rel_w, hk: int, wk: int):
    """q, k, v (B, N, nh, d), N = hk * wk keys; rel_h (B, nh, N, hk) and
    rel_w (B, nh, N, wk) the decomposed bias. Returns (B, N, nh * d)."""
    B, N, nh, d = q.shape
    if N != hk * wk:
        raise ValueError(f"q {tuple(q.shape)} does not fit a {hk}x{wk} key grid")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(B, nh, N, N)
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.reshape(B, N, nh * d).to(q.dtype)


def flash_attention(q, k, v):
    """softmax(q k^T d^-1/2) v over (B, N, nh, d). Returns (B, N, nh * d)."""
    B, N, nh, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.reshape(B, N, nh * d).to(q.dtype)
