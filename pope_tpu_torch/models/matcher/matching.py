"""Coarse dual-softmax matching and fine sub-pixel refinement with
fixed-capacity outputs (port of pope_tpu/models/matcher/matching.py,
inference: the sinkhorn assignment and the train-time GT padding are not
ported).

Ties break as the JAX package breaks them: the capacity cut is a stable
descending sort (jax.lax.top_k keeps the lower index first), argmax takes
the first maximum, and the mutual-NN test is an exact equality with the row
and column maxima of the f32 confidence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CoarseMatches(NamedTuple):
    i_ids: torch.Tensor  # (B, M) coarse cell index in image0's grid
    j_ids: torch.Tensor  # (B, M) coarse cell index in image1's grid
    mconf: torch.Tensor  # (B, M) confidence, 0 on padded slots
    valid: torch.Tensor  # (B, M) bool
    n_dropped: torch.Tensor  # (B,) mutual-NN matches the capacity cut


def dual_softmax_confidence(feat_c0, feat_c1, temperature: float = 0.1):
    """conf = softmax_rows(sim) * softmax_cols(sim), sim = <f0, f1> / C / T
    (each side scaled by C^-1/2). feat (B, L, C) / (B, S, C) -> (B, L, S)."""
    C = feat_c0.shape[-1]
    sim = torch.einsum("blc,bsc->bls", feat_c0 / C ** 0.5, feat_c1 / C ** 0.5) / temperature
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def _border_mask(h: int, w: int, b: int, device=None):
    """(h*w,) bool, False within `b` cells of any border."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    ok_y = (ys >= b) & (ys < h - b)
    ok_x = (xs >= b) & (xs < w - b)
    return (ok_y[:, None] & ok_x[None, :]).reshape(-1)


def coarse_matching(conf, hw0_c, hw1_c, thr: float = 0.2, border_rm: int = 2,
                    capacity: int = 1024) -> CoarseMatches:
    """Threshold + border removal + mutual-NN selection, the top-`capacity`
    rows by confidence kept, padded slots masked."""
    B, L, S = conf.shape
    keep = conf > thr
    keep &= _border_mask(*hw0_c, border_rm, conf.device)[None, :, None]
    keep &= _border_mask(*hw1_c, border_rm, conf.device)[None, None, :]
    keep &= conf == conf.amax(dim=2, keepdim=True)
    keep &= conf == conf.amax(dim=1, keepdim=True)

    masked = torch.where(keep, conf, torch.zeros_like(conf))
    j_star = masked.argmax(dim=2)  # (B, L)
    row_conf = masked.gather(2, j_star[..., None])[..., 0]
    score = torch.where(keep.any(dim=2), row_conf, torch.full_like(row_conf, -1.0))

    capacity = min(capacity, L)
    top_conf, i_ids = torch.sort(score, dim=1, descending=True, stable=True)
    top_conf, i_ids = top_conf[:, :capacity], i_ids[:, :capacity]
    j_ids = j_star.gather(1, i_ids)
    valid = top_conf > 0.0
    mconf = torch.where(valid, top_conf, torch.zeros_like(top_conf))
    n_dropped = (score > 0.0).sum(dim=1) - valid.sum(dim=1)
    return CoarseMatches(i_ids=i_ids, j_ids=j_ids, mconf=mconf, valid=valid, n_dropped=n_dropped)


def matches_to_coords(ids, w_c: int, scale: float):
    """Grid index -> pixel coords (i % w, i // w) * scale, (..., 2) [x, y]."""
    return torch.stack([(ids % w_c).float() * scale, (ids // w_c).float() * scale], dim=-1)


def extract_fine_windows(feat_f, ids, hw_c, window: int, stride: int):
    """(W x W) windows of fine features centred at coarse cells, as
    F.unfold(kernel=W, stride=stride, padding=W//2) selected at `ids`
    (out-of-bounds taps are zero).

    feat_f (B, Hf, Wf, C); ids (B, M) coarse cell indices on an (h_c, w_c)
    grid. Returns (B, M, W*W, C)."""
    B, Hf, Wf, C = feat_f.shape
    w_c = hw_c[1]
    r = window // 2
    dev = ids.device
    cy = (ids // w_c) * stride
    cx = (ids % w_c) * stride
    d = torch.arange(-r, r + 1, device=dev)
    ry = cy[..., None] + d.repeat_interleave(window)  # (B, M, WW)
    rx = cx[..., None] + d.repeat(window)
    inb = (ry >= 0) & (ry < Hf) & (rx >= 0) & (rx < Wf)
    idx = ry.clamp(0, Hf - 1) * Wf + rx.clamp(0, Wf - 1)
    flat = feat_f.reshape(B, Hf * Wf, C)
    gathered = flat[torch.arange(B, device=dev)[:, None, None], idx]  # (B, M, WW, C)
    return torch.where(inb[..., None], gathered, torch.zeros_like(gathered))


def fine_matching(feat_f0_win, feat_f1_win, window: int):
    """Centre-vs-window correlation -> softmax heatmap -> expected offset.

    feat windows (B, M, WW, C) -> (coords (B, M, 2) in [-1, 1] of image1's
    window, std (B, M) the summed per-axis heatmap standard deviations)."""
    WW = window * window
    C = feat_f0_win.shape[-1]
    center = feat_f0_win[..., WW // 2, :]
    sim = torch.einsum("bmc,bmrc->bmr", center, feat_f1_win) / C ** 0.5
    heat = torch.softmax(sim, dim=-1)
    lin = torch.linspace(-1.0, 1.0, window, device=heat.device)
    gx = lin.repeat(window)  # fast axis = x
    gy = lin.repeat_interleave(window)
    coords = torch.stack([(heat * gx).sum(-1), (heat * gy).sum(-1)], dim=-1)
    grid2 = torch.stack([gx, gy], dim=-1) ** 2
    var = torch.einsum("bmr,rk->bmk", heat, grid2) - coords ** 2
    std = torch.sqrt(torch.clamp(var, min=1e-10)).sum(-1)
    return coords, std
