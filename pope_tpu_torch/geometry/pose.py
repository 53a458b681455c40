"""Pose algebra: projection of 3-D points, the cross-product matrix the
solver builds E = [t]x R from, and the angular errors the metrics use (port
of the matching functions of pope_tpu/geometry/pose.py). Batched on leading
dimensions, f32."""

from __future__ import annotations

import torch


def project_points(pts, RT, K):
    """Project (N, 3) points through a (3, 4) [R|t] and a (3, 3) K: ((N, 2)
    pixels, (N,) depths), the depth held at least 1e-4 away from zero with
    its sign kept."""
    pts, RT, K = (torch.as_tensor(x, dtype=torch.float32) for x in (pts, RT, K))
    cam = pts @ RT[:, :3].T + RT[:, 3:].T
    pix = cam @ K.T
    dpt = pix[:, 2]
    small = dpt.abs() < 1e-4
    dpt = torch.where(small & (dpt >= 0), 1e-4, torch.where(small & (dpt < 0), -1e-4, dpt))
    return pix[:, :2] / dpt[:, None], dpt


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zero, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zero], -1),
        ],
        dim=-2,
    )


def rotation_angle_deg(R, R_gt):
    """Angular distance (deg) between rotation matrices."""
    m = R.transpose(-1, -2) @ R_gt
    cos = (m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)).abs())


def translation_angle_deg(t, t_gt):
    """Angle (deg) between translation directions, with the essential
    matrix's sign ambiguity folded: min(err, 180 - err)."""
    n = torch.linalg.norm(t, dim=-1) * torch.linalg.norm(t_gt, dim=-1)
    cos = (t * t_gt).sum(-1) / torch.clamp(n, min=1e-12)
    err = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    return torch.minimum(err, 180.0 - err)


def relative_pose_error(T_0to1, R, t, ignore_gt_t_thr: float = 0.0):
    """(t_err_deg, R_err_deg) against a (..., 4, 4) ground-truth relative pose."""
    t_gt = T_0to1[..., :3, 3]
    t_err = translation_angle_deg(t, t_gt)
    t_err = torch.where(torch.linalg.norm(t_gt, dim=-1) < ignore_gt_t_thr, torch.zeros_like(t_err), t_err)
    return t_err, rotation_angle_deg(R, T_0to1[..., :3, :3])
