"""Attention ops of the matcher's transformer (port of pope_tpu/ops/attention.py).

- `linear_attention`: LoFTR's elu+1 feature-map linear attention,
  O((L + S) d^2), two einsums;
- `full_attention`: softmax attention with 1/sqrt(D) scaling.

Both take (B, N, H, D) tensors and optional (B, N) validity masks
(1 = keep), as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """q (B, L, H, D), k and v (B, S, H, D) -> (B, L, H, D)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
        v = v * kv_mask[:, :, None, None].to(v.dtype)
    v_length = v.shape[1]
    v_scaled = v / v_length  # the reference's overflow guard, kept for bf16
    KV = torch.einsum("bshd,bshv->bhdv", K, v_scaled)
    Z = 1.0 / (torch.einsum("blhd,bhd->blh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv->blhv", Q, KV) * Z[..., None] * v_length


def full_attention(q, k, v, q_mask=None, kv_mask=None):
    """Softmax attention over (B, N, H, D); masked pairs get logit -1e9."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("blhd,bshd->blsh", q, k) * scale
    if kv_mask is not None:
        qm = q_mask if q_mask is not None else torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
        joint = qm[:, :, None, None].bool() & kv_mask[:, None, :, None].bool()
        logits = torch.where(joint, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=2)
    return torch.einsum("blsh,bshd->blhd", attn, v)
