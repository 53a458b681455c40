"""Coarse dual-softmax matching and fine sub-pixel refinement with
fixed-capacity outputs, the sinkhorn assignment with a learned dustbin and
the train-time GT padding of the fine stage's samples (port of
pope_tpu/models/matcher/matching.py).

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


def sinkhorn_confidence(feat_c0, feat_c1, bin_score, iters: int = 3, prefilter: bool = True):
    """Optimal-transport coarse assignment with a learned dustbin: the
    log-domain Sinkhorn with uniform marginals, real rows and columns of mass
    1 and each dustbin of the other side's count.

    feat (B, L, C) / (B, S, C), bin_score a scalar tensor -> (B, L, S)
    confidence (the dustbin row and column stripped). With `prefilter` (the
    eval-time setting), rows and columns whose transport argmax is the
    dustbin are zeroed."""
    B, L, C = feat_c0.shape
    S = feat_c1.shape[1]
    sim = torch.einsum("blc,bsc->bls", feat_c0 / C ** 0.5, feat_c1 / C ** 0.5)
    alpha = bin_score.to(sim.dtype)
    Z = torch.cat([
        torch.cat([sim, alpha.expand(B, L, 1)], dim=-1),
        torch.cat([alpha.expand(B, 1, S), alpha.expand(B, 1, 1)], dim=-1),
    ], dim=1)  # (B, L+1, S+1)

    dev = sim.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    norm = -torch.log(f32(float(L + S)))
    log_mu = torch.cat([norm.expand(L), (torch.log(f32(float(S))) + norm)[None]])
    log_nu = torch.cat([norm.expand(S), (torch.log(f32(float(L))) + norm)[None]])
    u = torch.zeros(B, L + 1, dtype=Z.dtype, device=dev)
    v = torch.zeros(B, S + 1, dtype=Z.dtype, device=dev)
    for _ in range(iters):
        u = log_mu[None] - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu[None] - torch.logsumexp(Z + u[:, :, None], dim=1)
    assign = torch.exp(Z + u[:, :, None] + v[:, None, :] - norm)
    conf = assign[:, :L, :S]
    if prefilter:
        row_bin = assign[:, :L, :].argmax(dim=2) == S  # (B, L)
        col_bin = assign[:, :, :S].argmax(dim=1) == L  # (B, S)
        conf = conf * (~row_bin[:, :, None]) * (~col_bin[:, None, :])
    return conf


def gt_pad_matches(cm: CoarseMatches, gt_valid, gt_j_of_i, gt_min: int, noise=None) -> CoarseMatches:
    """Train-time GT padding of the fine stage's sample set: the last
    `gt_min` capacity slots, and every slot whose prediction is invalid, take
    ground-truth coarse matches (mconf 0), so that the fine stage trains on
    supervised windows while the predictions are still noise. Predictions
    keep their top-confidence order.

    gt_valid (B, L) bool rows with a GT match; gt_j_of_i (B, L) the GT column
    of each row; noise: an optional (B, L) tensor of U[0, 1) draws that
    decides which GT matches pad (the JAX package draws it from a key);
    without it a fixed hash of the row index does, so that padding does not
    always take the top-left cells."""
    B, M = cm.i_ids.shape
    L = gt_valid.shape[1]
    dev = gt_valid.device
    if noise is None:
        # Knuth's multiplicative hash in uint32 arithmetic (int64, masked)
        h = (torch.arange(L, dtype=torch.int64, device=dev) * 2654435761) & 0xFFFFFFFF
        noise = ((h % 65536).float() / 65536.0)[None, :].expand(B, L)
    gt_score = torch.where(gt_valid, 1.0 + noise.float(), torch.full((B, L), -1.0, device=dev))
    k = min(M, L)
    gt_top, gt_rows = torch.sort(gt_score, dim=1, descending=True, stable=True)
    gt_top, gt_rows = gt_top[:, :k], gt_rows[:, :k]
    if k < M:  # capacity above the grid size: cycle
        reps = -(-M // k)
        gt_top, gt_rows = gt_top.repeat(1, reps)[:, :M], gt_rows.repeat(1, reps)[:, :M]
    gt_ok = gt_top > 0.0
    gt_cols = gt_j_of_i.gather(1, gt_rows)

    slot = torch.arange(M, device=dev)
    use_gt = (slot[None, :] >= M - gt_min) | ~cm.valid
    # the k-th GT slot takes the k-th ranked GT match, cycling when there are
    # fewer GT matches than slots (the reference pads by sampling with
    # replacement)
    gt_rank = torch.clamp(torch.cumsum(use_gt.to(torch.int64), dim=1) - 1, 0, M - 1)
    n_gt = gt_valid.sum(dim=1, keepdim=True)
    gt_rank = torch.where(n_gt > 0, gt_rank % torch.clamp(n_gt, min=1), gt_rank)
    gi = gt_rows.gather(1, gt_rank)
    gj = gt_cols.gather(1, gt_rank)
    gv = gt_ok.gather(1, gt_rank)
    return CoarseMatches(
        i_ids=torch.where(use_gt, gi, cm.i_ids),
        j_ids=torch.where(use_gt, gj, cm.j_ids),
        mconf=torch.where(use_gt, torch.zeros_like(cm.mconf), cm.mconf),
        valid=torch.where(use_gt, gv, cm.valid),
        n_dropped=cm.n_dropped,
    )


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
