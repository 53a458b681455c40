"""Epipolar geometry: keypoint normalisation, Sampson and symmetric
epipolar distances, E = [t]x R and midpoint triangulation (port of
pope_tpu/geometry/epipolar.py). Batched on leading dimensions, f32."""

from __future__ import annotations

import torch

from pope_tpu_torch.geometry.pose import skew


def essential_from_Rt(R, t):
    """E = [t]x @ R for (..., 3, 3) R and (..., 3) t."""
    return skew(t) @ R


def _homo(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_keypoints(kpts, K):
    """Pixel -> normalized camera coordinates, (p - c) / f.
    kpts (..., N, 2), K (..., 3, 3)."""
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    return (kpts - c[..., None, :]) / f[..., None, :]


def sampson_distance(pts0, pts1, E):
    """Squared first-order (Sampson) epipolar distance on normalized coords:
    pts (..., N, 2), E (..., 3, 3) broadcast -> (..., N)."""
    p0, p1 = _homo(pts0), _homo(pts1)
    Ep0 = p0 @ E.transpose(-1, -2)
    Etp1 = p1 @ E
    p1Ep0 = (p1 * Ep0).sum(-1)
    denom = Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2
    return p1Ep0 ** 2 / torch.clamp(denom, min=1e-12)


def symmetric_epipolar_distance(pts0, pts1, E, K0=None, K1=None):
    """Squared symmetric epipolar distance. pts (..., N, 2) in pixels when
    the K's are given, else normalized; E (..., 3, 3) -> (..., N)."""
    if K0 is not None:
        pts0 = normalize_keypoints(pts0, K0)
    if K1 is not None:
        pts1 = normalize_keypoints(pts1, K1)
    p0, p1 = _homo(pts0), _homo(pts1)
    Ep0 = p0 @ E.transpose(-1, -2)
    p1Ep0 = (p1 * Ep0).sum(-1)
    Etp1 = p1 @ E
    return p1Ep0 ** 2 * (
        1.0 / torch.clamp(Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2, min=1e-12)
        + 1.0 / torch.clamp(Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2, min=1e-12)
    )


def compute_symmetric_epipolar_errors(T_0to1, mkpts0, mkpts1, K0, K1):
    """Per-match squared symmetric epipolar error against a ground-truth
    relative pose T_0to1 (..., 4, 4); mkpts (..., N, 2) in pixels, K's
    (..., 3, 3) -> (..., N)."""
    E = essential_from_Rt(T_0to1[..., :3, :3], T_0to1[..., :3, 3])
    return symmetric_epipolar_distance(mkpts0, mkpts1, E, K0, K1)


def triangulate_midpoint(pts0, pts1, R, t):
    """Depths (z0, z1) of each correspondence in both cameras by the two-ray
    midpoint method; camera 1 at x1 = R x0 + t. pts (..., N, 2) normalized,
    R (..., 3, 3), t (..., 3). Returns two (..., N) tensors."""
    r0, r1 = _homo(pts0), _homo(pts1)
    Rr0 = r0 @ R.transpose(-1, -2)
    a11 = (Rr0 * Rr0).sum(-1)
    a12 = -(Rr0 * r1).sum(-1)
    a22 = (r1 * r1).sum(-1)
    t_ = t[..., None, :]
    b1 = -(Rr0 * t_).sum(-1)
    b2 = (r1 * t_).sum(-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    z0 = (b1 * a22 - a12 * b2) / det
    z1 = (a11 * b2 - a12 * b1) / det
    return z0, z1
