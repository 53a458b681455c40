"""Closed-form rigid / similarity alignment, Kabsch and Umeyama (port of
pope_tpu/solver/umeyama.py), on (..., N, 3) point sets in f32 (on the card
the entry points turn TF32 off, as the JAX package's `f32_matmul` holds its
products)."""

from __future__ import annotations

import torch


def _weighted_centres(P, Q, weights):
    if weights is None:
        weights = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    mu_p = (P * w[..., None]).sum(-2)
    mu_q = (Q * w[..., None]).sum(-2)
    return w, mu_p, mu_q, P - mu_p[..., None, :], Q - mu_q[..., None, :]


def _reflection_fix(d):
    """diag(1, 1, d) for a (...,) sign d."""
    ones = torch.ones_like(d)
    return torch.diag_embed(torch.stack([ones, ones, d], dim=-1))


def kabsch(P, Q, weights=None):
    """The rotation R and translation t minimizing ||R P + t - Q||.
    P, Q: (..., N, 3); weights: optional (..., N). Returns (R (..., 3, 3),
    t (..., 3))."""
    w, mu_p, mu_q, Pc, Qc = _weighted_centres(P, Q, weights)
    H = (Pc * w[..., None]).transpose(-1, -2) @ Qc
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    R = V @ _reflection_fix(torch.sign(torch.linalg.det(V @ Ut))) @ Ut
    return R, mu_q - (R @ mu_p[..., None])[..., 0]


def umeyama_alignment(P, Q, weights=None):
    """The similarity (s, R, t) minimizing ||s R P + t - Q|| (Umeyama 1991).
    P, Q: (..., N, 3); weights: optional (..., N). Returns (s (...,),
    R (..., 3, 3), t (..., 3))."""
    w, mu_p, mu_q, Pc, Qc = _weighted_centres(P, Q, weights)
    cov = (Qc * w[..., None]).transpose(-1, -2) @ Pc
    var_p = (w * Pc.square().sum(-1)).sum(-1)
    U, S, Vt = torch.linalg.svd(cov)
    Dm = _reflection_fix(torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt)))
    R = U @ Dm @ Vt
    s = (S * torch.diagonal(Dm, dim1=-2, dim2=-1)).sum(-1) / torch.clamp(var_p, min=1e-12)
    return s, R, mu_q - s[..., None] * (R @ mu_p[..., None])[..., 0]
