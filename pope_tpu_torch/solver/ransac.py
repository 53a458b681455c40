"""Batched essential-matrix RANSAC + pose recovery with static shapes (port of
pope_tpu/solver/ransac.py).

Hypotheses are drawn and scored in parallel: Gumbel-top-k minimal samples,
a batched 8-point null-vector solve (eigh of 9x9 normal matrices) and an
(H, N) Sampson scoring, over guided resampling rounds; each round's best
model is refit with annealed hard-band IRLS, the winner by banded consensus
is decomposed by cheirality and polished by Levenberg-Marquardt on the
essential manifold. 5-7 matches take a multi-start manifold solver.

Differences from the JAX entry, by design:
- every function takes a leading pair dimension, so a batch of pairs is one
  call (the JAX package vmaps it);
- the round noise is an input: a (n_rounds, n_hyps, N) Gumbel tensor (with a
  leading pair dimension when batched), or a torch.Generator that draws it
  on the device. Torch cannot reproduce jax.random's bits, so parity tests
  draw the noise in JAX and pass it in;
- the linear algebra is the JAX package's non-TPU branch: torch.linalg.eigh
  for the 9x9 null vector and torch.linalg.svd for the 3x3 projections (its
  Jacobi solvers are a TPU-only branch). Matrices that are not finite (a
  degenerate sample of padded slots) are zeroed before a decomposition,
  which in torch would raise where LAPACK in JAX returns NaN; those pairs
  come out not `ok` either way;
- jax.jacfwd becomes forward-mode AD (torch.func.jvp) over the 5 update
  parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from pope_tpu_torch.geometry.epipolar import normalize_keypoints, sampson_distance, triangulate_midpoint
from pope_tpu_torch.geometry.pose import skew

LOOSE = 16.0  # loose scoring band, in units of thr^2


class RansacResult(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3) unit translation
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...,) int32
    n_cheirality: torch.Tensor  # (...,) int32 points passing the in-front test
    E: torch.Tensor  # (..., 3, 3)
    ok: torch.Tensor  # (...,) bool: enough points and a usable model


def _finite_or_zero(M):
    bad = ~torch.isfinite(M).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(bad, torch.zeros_like(M), M)


def _nullvec9(AtA):
    return torch.linalg.eigh(_finite_or_zero(AtA)).eigenvectors[..., :, 0]


def _svd3x3(E):
    return torch.linalg.svd(_finite_or_zero(E))


def _select(x, idx):
    """x (*lead, n, *tail) at idx (*lead) along the n axis -> (*lead, *tail)."""
    lead = idx.shape
    xf = x.reshape(-1, *x.shape[len(lead):])
    out = xf[torch.arange(xf.shape[0], device=x.device), idx.reshape(-1)]
    return out.reshape(*lead, *x.shape[len(lead) + 1:])


def _eye(batch_shape, ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(*batch_shape, 3, 3)


def _hartley(pts, w):
    """Weighted Hartley conditioning of (..., K, 2) points: centroid to the
    origin, RMS radius sqrt(2). Returns (normalized pts, (..., 3, 3) T)."""
    n = torch.clamp(w.sum(-1), min=1e-9)
    mean = (pts * w[..., None]).sum(-2) / n[..., None]
    centered = pts - mean[..., None, :]
    rms = torch.sqrt(((centered ** 2).sum(-1) * w).sum(-1) / n)
    s = 2.0 ** 0.5 / torch.clamp(rms, min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], -1),
        torch.stack([zero, s, -s * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)
    return centered * s[..., None, None], T


def _masked_quantile(x, maskf, q: float):
    """Quantile of x (..., N) over entries where maskf > 0."""
    n = torch.clamp(maskf.sum(-1), min=1.0)
    xs = torch.sort(torch.where(maskf > 0, x, torch.full_like(x, float("inf"))), dim=-1).values
    idx = torch.clamp((q * (n - 1.0)).to(torch.int32), 0, x.shape[-1] - 1).long()
    return xs.gather(-1, idx[..., None])[..., 0]


def _eight_point(p0, p1, w=None, project: bool = True):
    """Least-squares essential matrix from (..., K, 2) normalized coords:
    Hartley conditioning, the smallest eigenvector of A^T A, optionally the
    projection onto the essential manifold (singular values (1, 1, 0)), and
    E = T1^T E' T0."""
    if w is None:
        w = torch.ones_like(p0[..., 0])
    q0, T0 = _hartley(p0, w)
    q1, T1 = _hartley(p1, w)
    x0, y0 = q0[..., 0], q0[..., 1]
    x1, y1 = q1[..., 0], q1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1)
    A = A * w[..., None]
    e = _nullvec9(A.transpose(-1, -2) @ A)
    E = T1.transpose(-1, -2) @ e.reshape(*e.shape[:-1], 3, 3) @ T0
    if not project:
        return E
    U, _, Vt = _svd3x3(E)
    return (U * U.new_tensor([1.0, 1.0, 0.0])) @ Vt


def _sampson_residual(E, p0, p1):
    """Signed first-order epipolar residual (sqrt of the Sampson distance)."""
    h0 = torch.cat([p0, torch.ones_like(p0[..., :1])], -1)
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    Ep0 = h0 @ E.transpose(-1, -2)
    Etp1 = h1 @ E
    num = (h1 * Ep0).sum(-1)
    den = torch.sqrt(torch.clamp(
        Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2, min=1e-18))
    return num / den


def _exp_so3(w):
    """Rodrigues, (..., 3) -> (..., 3, 3), as I + A W + B W^2 with a Taylor
    branch near zero so the derivative at w = 0 is finite."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    ths = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / th2s)
    W = skew(w)
    return _eye(w.shape[:-1], w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def _update(params, R0, t0):
    """(E, R, t) after the 5-DoF step params = (rotation (3), tangent (2))."""
    w, phi = params[..., :3], params[..., 3:]
    Rn = _exp_so3(w) @ R0
    ex, ey = t0.new_tensor([1.0, 0.0, 0.0]), t0.new_tensor([0.0, 1.0, 0.0])
    a = torch.where((t0[..., :1].abs() < 0.9), ex, ey)
    b1 = torch.linalg.cross(t0, a)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(t0, b1)
    tn = t0 + phi[..., :1] * b1 + phi[..., 1:] * b2
    tn = tn / torch.clamp(torch.linalg.norm(tn, dim=-1, keepdim=True), min=1e-12)
    return skew(tn) @ Rn, Rn, tn


def refine_pose_gn(R, t, p0, p1, weights, iters: int = 5, damping: float = 1e-6):
    """Levenberg-Marquardt refinement of (R, t) (..., 3, 3) / (..., 3)
    minimizing the weighted Sampson error of (..., N, 2) correspondences;
    R <- exp([w]x) R and t on its 2-D tangent plane, adaptive damping."""
    if R.ndim == 2:  # forward AD mistypes the tangents of 0-dim intermediates
        R, t = refine_pose_gn(R[None], t[None], p0[None], p1[None], weights[None], iters, damping)
        return R[0], t[0]
    sw = torch.sqrt(torch.clamp(weights, min=0.0))
    lam = torch.full(R.shape[:-2], 1e-3, dtype=R.dtype, device=R.device)
    zero = torch.zeros(*R.shape[:-2], 5, dtype=R.dtype, device=R.device)
    basis = torch.eye(5, dtype=R.dtype, device=R.device)
    eye5 = basis.expand(*R.shape[:-2], 5, 5)
    for _ in range(iters):
        def resid(params, R0=R, t0=t):
            return _sampson_residual(_update(params, R0, t0)[0], p0, p1) * sw

        r = resid(zero)
        # forward-mode Jacobian: residual n of a pair depends only on that
        # pair's parameters, so one tangent per parameter serves every pair
        J = torch.stack(
            [torch.func.jvp(resid, (zero,), (basis[i].expand_as(zero),))[1] for i in range(5)], dim=-1
        )  # (..., N, 5)
        JtJ = J.transpose(-1, -2) @ J
        D = torch.diag_embed(torch.clamp(JtJ.diagonal(dim1=-2, dim2=-1), min=1e-12))
        rhs = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        step, _ = torch.linalg.solve_ex(JtJ + lam[..., None, None] * D + damping * eye5, rhs)
        delta = -step
        _, Rn, tn = _update(delta, R, t)
        better = (resid(delta) ** 2).sum(-1) < (r ** 2).sum(-1)
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn, t)
        lam = torch.where(better, torch.clamp(lam / 3.0, min=1e-9), torch.clamp(lam * 10.0, max=1e6))
    return R, t


def recover_pose_from_E(E, p0, p1, weight):
    """Cheirality test over the 4 (R, t) decompositions of E (..., 3, 3):
    (R, t, n_good) of the one with the most weighted points in front of both
    cameras (first on ties)."""
    U, _, Vt = _svd3x3(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    z0, z1 = triangulate_midpoint(p0[..., None, :, :], p1[..., None, :, :], cands_R, cands_t)
    counts = (((z0 > 0) & (z1 > 0)).float() * weight[..., None, :]).sum(-1)  # (..., 4)
    best = counts.argmax(-1)
    return _select(cands_R, best), _select(cands_t, best), _select(counts, best).to(torch.int32)


def _few_point_pose(p0, p1, vmaskf):
    """Pose from 5-7 correspondences: multi-start Levenberg-Marquardt on the
    essential manifold from the least-squares fit's decompositions and six
    canonical translations, cheirality first and cost as the tie-break."""
    E_ls = _eight_point(p0, p1, w=vmaskf)
    U, _, Vt = _svd3x3(E_ls)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = E_ls.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t0 = U[..., :, 2] / torch.clamp(torch.linalg.norm(U[..., :, 2], dim=-1, keepdim=True), min=1e-12)
    eye = _eye(R1.shape[:-2], R1)
    ex, ey, ez = (eye[..., i, :] for i in range(3))
    seeds_R = torch.stack([R1, R1, R2, R2, eye, eye, eye, eye, eye, eye], dim=-3)  # (..., 10, 3, 3)
    seeds_t = torch.stack([t0, -t0, t0, -t0, ex, -ex, ey, -ey, ez, -ez], dim=-2)
    P0, P1 = p0[..., None, :, :], p1[..., None, :, :]
    Pw = vmaskf[..., None, :].expand(*vmaskf.shape[:-1], 10, vmaskf.shape[-1])
    P0x, P1x = P0.expand(*Pw.shape, 2), P1.expand(*Pw.shape, 2)
    Rs, ts = refine_pose_gn(seeds_R, seeds_t, P0x, P1x, Pw, iters=16)
    Es = skew(ts) @ Rs
    costs = (_sampson_residual(Es, P0x, P1x) ** 2 * Pw).sum(-1)  # (..., 10)
    R4, t4, ngood4 = recover_pose_from_E(Es, P0x, P1x, Pw)
    # cheirality first (at n = 5 the algebraic cost cannot split the
    # interpolating solutions), cost strictly below 1 as the tie-break
    cost_rank = 0.5 * costs / (costs.amax(-1, keepdim=True) + 1e-18)
    b = (ngood4.float() - cost_rank).argmax(-1)
    return _select(R4, b), _select(t4, b), _select(Es, b), _select(ngood4, b)


N_HYPS = 2048  # hypotheses per round (the JAX entry's default)


def draw_gumbel(shape, generator: torch.Generator, device=None):
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1), as
    jax.random.gumbel draws it. The logs run in float64: on the CPU, two
    float32 draws of one seed in one process were seen to differ in the last
    bit of the inner log (cause not found), which the outer log magnifies
    near U = 1 (up to 1e-4); in float64 such a bit does not survive the
    rounding to float32, so a seed repeats its noise exactly."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return (-torch.log(-torch.log(u.double()))).float()


@torch.no_grad()
def estimate_pose_ransac(
    kpts0,
    kpts1,
    K0,
    K1,
    valid,
    noise: Union[torch.Tensor, torch.Generator],
    thresh_px: float = 0.5,
    n_hyps: int = N_HYPS,
    sample_size: int = 8,
    refit_iters: int = 1,
    n_rounds: int = 3,
) -> RansacResult:
    """Parallel-hypothesis essential-matrix RANSAC.

    kpts0, kpts1: (N, 2) pixel coords, or (B, N, 2) for a batch of pairs;
    K0, K1: (3, 3) or (B, 3, 3); valid: (N,) or (B, N) bool.
    noise: (n_rounds, n_hyps, N) (or (B, n_rounds, n_hyps, N)) standard
      Gumbel noise, the JAX entry's jax.random.gumbel draws per round; or a
      torch.Generator on kpts0's device that draws it.
    thresh_px: pixel inlier threshold, normalized by the mean focal length.
    Returns a RansacResult with the same leading dimensions as kpts0 less
    the last two; `ok` is False below `sample_size` valid matches (below 5
    on the few-point path).
    """
    single = kpts0.ndim == 2
    if single:
        kpts0, kpts1, K0, K1, valid = (x[None] for x in (kpts0, kpts1, K0, K1, valid))
        if torch.is_tensor(noise):
            noise = noise[None]
    B, N = valid.shape
    if isinstance(noise, torch.Generator):
        noise = draw_gumbel((B, n_rounds, n_hyps, N), noise, device=kpts0.device)
    if noise.shape != (B, n_rounds, n_hyps, N):
        raise ValueError(f"noise {tuple(noise.shape)} != {(B, n_rounds, n_hyps, N)}")
    kpts0, kpts1, K0, K1 = (x.float() for x in (kpts0, kpts1, K0, K1))
    dev = kpts0.device
    p0 = normalize_keypoints(kpts0, K0)
    p1 = normalize_keypoints(kpts1, K1)
    fmean = (K0[:, 0, 0] + K1[:, 1, 1] + K0[:, 0, 0] + K1[:, 1, 1]) / 4.0
    thr = thresh_px / fmean
    thr2 = thr * thr  # (B,)
    n_valid = valid.sum(-1)
    vmaskf = valid.float()
    rows = torch.arange(B, device=dev)

    def band_score(d, mult):
        t = (mult * thr2).reshape(B, *([1] * (d.ndim - 1)))
        return (torch.clamp(1.0 - d / t, min=0.0) * vmaskf.reshape(B, *([1] * (d.ndim - 2)), N)).sum(-1)

    def sample_round(g, log_w):
        """n_hyps Gumbel-top-k minimal samples (half uniform, half guided by
        log_w), an 8-point fit each; the round's best model and score."""
        half = n_hyps // 2
        lw = torch.cat([torch.zeros(B, half, N, device=dev),
                        log_w[:, None].expand(B, n_hyps - half, N)], dim=1)
        scores = torch.where(valid[:, None, :], lw + g, torch.full_like(g, float("-inf")))
        samples = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :sample_size]
        pick = lambda p: p[rows[:, None, None], samples]  # (B, H, k, 2)
        E_h = _eight_point(pick(p0), pick(p1), project=False)
        d = sampson_distance(p0[:, None], p1[:, None], E_h)  # (B, H, N)
        ls = band_score(d, LOOSE) + band_score(d, 4.0)
        b = ls.argmax(-1)
        return E_h[rows, b], ls[rows, b]

    # guided rounds: round 0 uniform, later rounds biased toward the
    # incumbent's low-residual matches
    log_w = torch.zeros(B, N, device=dev)
    E_best = _eye((B,), p0).clone()
    best_ls = torch.full((B,), -1.0, device=dev)
    E_rounds = []
    for r in range(n_rounds):
        E_r, ls_r = sample_round(noise[:, r].float(), log_w)
        better = ls_r > best_ls
        E_best = torch.where(better[:, None, None], E_r, E_best)
        best_ls = torch.maximum(ls_r, best_ls)
        d_best = sampson_distance(p0, p1, E_best)
        scale = torch.maximum(4.0 * thr2, _masked_quantile(d_best, vmaskf, 0.5))
        log_w = -torch.log1p(d_best / scale[:, None])
        E_rounds.append(E_r)
    E_cands = torch.stack(E_rounds + [E_best], dim=1)  # (B, C, 3, 3)
    n_c = E_cands.shape[1]

    # local optimization per candidate: hard-band IRLS refits annealed from
    # the loose band to the strict threshold, kept only if the strict inlier
    # count does not shrink
    P0, P1 = p0[:, None].expand(B, n_c, N, 2), p1[:, None].expand(B, n_c, N, 2)
    vc = valid[:, None, :]
    t2 = thr2[:, None, None]
    E_cur = E_cands
    inl_cur = (sampson_distance(P0, P1, E_cur) < t2) & vc
    for mult in (LOOSE, 4.0, 1.0, 1.0)[: refit_iters + 3]:
        d_cur = sampson_distance(P0, P1, E_cur)
        band = (d_cur < t2 * mult) & vc
        w_soft = band.float() / (1.0 + d_cur / (t2 * mult))
        E_new = _eight_point(P0, P1, w=w_soft)
        inl_new = (sampson_distance(P0, P1, E_new) < t2) & vc
        better = inl_new.sum(-1) >= inl_cur.sum(-1)
        E_cur = torch.where(better[..., None, None], E_new, E_cur)
        inl_cur = torch.where(better[..., None], inl_new, inl_cur)
    d_pol = sampson_distance(P0, P1, E_cur)
    final = band_score(d_pol, 4.0) + inl_cur.sum(-1)
    best_c = final.argmax(-1)
    E_best = E_cur[rows, best_c]
    inl_best = inl_cur[rows, best_c]

    R, t, n_good = recover_pose_from_E(E_best, p0, p1, inl_best.float())

    # polish (R, t), weights at the scale of the residual noise (median over
    # the loose consensus band)
    d_fin = sampson_distance(p0, p1, E_best)
    band_f = (d_fin < LOOSE * thr2[:, None]) & valid
    noise_scale = torch.maximum(thr2, _masked_quantile(d_fin, band_f.float(), 0.5))
    w_fin = band_f.float() / (1.0 + d_fin / noise_scale[:, None])
    R, t = refine_pose_gn(R, t, p0, p1, w_fin)
    E_best = skew(t) @ R

    # 5-7 valid matches: below the 8-point sample, the multi-start solver
    # (branch-free in the JAX package; run here only when a pair needs it)
    few = n_valid < sample_size
    if bool(few.any()):
        R_f, t_f, E_f, n_good_f = _few_point_pose(p0, p1, vmaskf)
        R = torch.where(few[:, None, None], R_f, R)
        t = torch.where(few[:, None], t_f, t)
        E_best = torch.where(few[:, None, None], E_f, E_best)
        n_good = torch.where(few, n_good_f, n_good)

    inl = (sampson_distance(p0, p1, E_best) < thr2[:, None]) & valid
    n_inl = inl.sum(-1).to(torch.int32)
    ok = torch.where(few, n_valid >= 5, n_inl >= sample_size)
    ok &= torch.isfinite(R).flatten(1).all(-1) & torch.isfinite(t).all(-1)
    res = RansacResult(R=R, t=t, inliers=inl, n_inliers=n_inl, n_cheirality=n_good, E=E_best, ok=ok)
    if single:
        res = RansacResult(*(x[0] for x in res))
    return res
