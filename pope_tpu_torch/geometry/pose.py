"""Pose algebra: projection of 3-D points, the cross-product matrix the
solver builds E = [t]x R from, the angular errors the metrics use, SE(3)
inverse / composition, and the regressor's rotation parameterizations
(quaternions, Zhou's 6-d) and geodesic loss (port of
pope_tpu/geometry/pose.py). Batched on leading dimensions, f32."""

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


def pose_inverse(pose):
    """Invert a (..., 3, 4) [R|t]: [R^T | -R^T t]."""
    R = pose[..., :3, :3].transpose(-1, -2)
    return torch.cat([R, -R @ pose[..., :3, 3:]], dim=-1)


def pose_compose(pose0, pose1):
    """Apply pose0 first, then pose1: [R1 R0 | R1 t0 + t1]."""
    R0, t0 = pose0[..., :3, :3], pose0[..., :3, 3:]
    R1, t1 = pose1[..., :3, :3], pose1[..., :3, 3:]
    return torch.cat([R1 @ R0, R1 @ t0 + t1], dim=-1)


def to_homo_pose(pose34):
    """(..., 3, 4) -> (..., 4, 4)."""
    pose34 = torch.as_tensor(pose34, dtype=torch.float32)
    bottom = pose34.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*pose34.shape[:-2], 1, 4)
    return torch.cat([pose34, bottom], dim=-2)


def relative_pose(pose0, pose1):
    """T_0to1 = pose1 @ inv(pose0) on (..., 4, 4) (or 3x4) poses."""
    return to_homo_pose(pose1[..., :3, :4]) @ torch.linalg.inv(to_homo_pose(pose0[..., :3, :4]))


def geodesic_distance(X, X1=None, mode: str = "mean"):
    """Geodesic rotation distance (radians) between (B, 3, 3) batches (X1
    None: the identity), cos clamped to +-0.999999; the mean with
    mode="mean", else per item."""
    if X.ndim == 2:
        X = X[None]
    if X1 is None:
        X1 = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape)
    m = X @ X1.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    d = torch.arccos(torch.clamp(cos, -0.999999, 0.999999))
    return d.mean() if mode == "mean" else d


def _normalize(v, eps: float = 1e-8):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def quat_to_matrix(quat):
    """(..., 4) wxyz quaternion (normalized here) -> (..., 3, 3)."""
    w, x, y, z = _normalize(quat).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)], -1)
    row1 = torch.stack([2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)], -1)
    row2 = torch.stack([2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], -2)


def matrix_to_quat(R):
    """(..., 3, 3) -> (..., 4) unit wxyz quaternion, Shepperd's branch by the
    largest diagonal term."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    safe_sqrt = lambda x: torch.sqrt(torch.clamp(x, min=1e-12))
    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)
    s1 = 2.0 * safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = 2.0 * safe_sqrt(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = 2.0 * safe_sqrt(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    q = torch.where((tr > 0)[..., None], q0,
                    torch.where(((m00 >= m11) & (m00 >= m22))[..., None], q1,
                                torch.where((m11 >= m22)[..., None], q2, q3)))
    return _normalize(q)


def o6d_to_matrix(ortho6d):
    """Zhou's continuous 6-d rotation (..., 6) -> (..., 3, 3), columns x, y, z."""
    x = _normalize(ortho6d[..., 0:3])
    z = _normalize(torch.linalg.cross(x, ortho6d[..., 3:6]))
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)
