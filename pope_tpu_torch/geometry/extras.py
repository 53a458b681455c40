"""The rest of the reference's utils/base_utils.py surface (port of
pope_tpu/geometry/extras.py): the fundamental matrix from two intrinsics
and a relative pose, DLT triangulation (tensors, f32), and at the host edge
(numpy copies) the 2-D transformation algebra, farthest-point sampling and
pickle / PLY IO."""

from __future__ import annotations

import pickle

import numpy as np
import torch

from pope_tpu_torch.geometry.pose import skew


def compute_F(K1, K2, R, t):
    """Fundamental matrix from intrinsics and a relative pose
    (base_utils.py:286). K1, K2, R (3, 3); t (3, 1) or (3,)."""
    K1, K2, R = (torch.as_tensor(a, dtype=torch.float32) for a in (K1, K2, R))
    t = torch.as_tensor(t, dtype=torch.float32, device=K1.device).reshape(3, 1)
    A = K1 @ R.T @ t
    return torch.linalg.inv(K2).T @ R @ K1.T @ skew(A[:, 0])


def triangulate_dlt(kpts0, kpts1, pose0, pose1, K0, K1):
    """DLT triangulation of pixel correspondences (base_utils.py:588-594,
    cv2.triangulatePoints semantics). kpts (N, 2); poses (3, 4) world ->
    camera; K (3, 3). Returns (N, 3) world points."""
    ones = torch.ones_like(kpts0[:, :1])
    k0 = torch.cat([kpts0, ones], -1) @ torch.linalg.inv(K0).T
    k1 = torch.cat([kpts1, ones], -1) @ torch.linalg.inv(K1).T
    # rows x * P2 - P0, y * P2 - P1 of each view: (N, 4, 4)
    A = torch.stack([k0[:, 0, None] * pose0[2] - pose0[0], k0[:, 1, None] * pose0[2] - pose0[1],
                     k1[:, 0, None] * pose1[2] - pose1[0], k1[:, 1, None] * pose1[2] - pose1[1]], dim=1)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = vecs[..., 0]
    return X[:, :3] / X[:, 3:]


# ---- 2-D transformation algebra (host, numpy) ----

def transformation_compose_2d(t0: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """Apply t0 then t1 on (2, 3) affines (base_utils.py:609-621)."""
    R = t1[:, :2] @ t0[:, :2]
    t = t1[:, :2] @ t0[:, 2] + t1[:, 2]
    return np.concatenate([R, t[:, None]], 1)


def transformation_inverse_2d(trans: np.ndarray) -> np.ndarray:
    A_ = np.linalg.inv(trans[:2, :2])
    return np.concatenate([A_, -A_ @ trans[:, 2:]], 1)


def transformation_apply_2d(trans: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ trans[:, :2].T + trans[:, 2:].T


def transformation_offset_2d(x: float, y: float) -> np.ndarray:
    return np.concatenate([np.eye(2), np.asarray([x, y])[:, None]], 1).astype(np.float32)


def transformation_scale_2d(scale: float) -> np.ndarray:
    return np.concatenate([np.diag([scale, scale]), np.zeros([2, 1])], 1).astype(np.float32)


def transformation_rotation_2d(ang: float) -> np.ndarray:
    R = np.asarray([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    return np.concatenate([R, np.zeros([2, 1])], 1).astype(np.float32)


def transformation_decompose_2d(M: np.ndarray):
    scale = np.sqrt(np.linalg.det(M[:2, :2]))
    rotation = np.arctan2(M[1, 0], M[0, 0])
    return scale, rotation, M[:2, 2]


def transformation_crop_2d(position, scale: float, angle: float, size: int) -> np.ndarray:
    """Centre `position`, scale, rotate, recentre at size / 2
    (base_utils.py transformation_crop)."""
    M = transformation_offset_2d(-position[0], -position[1])
    M = transformation_compose_2d(M, transformation_scale_2d(scale))
    M = transformation_compose_2d(M, transformation_rotation_2d(angle))
    return transformation_compose_2d(M, transformation_offset_2d(size / 2, size / 2))


# ---- sampling / IO (host) ----

def sample_fps_points(points: np.ndarray, sample_num: int, init_center: bool = True) -> np.ndarray:
    """Farthest-point sampling (base_utils.py:558-586): the centroid (or the
    first point) and then, sample_num - 1 times, the point farthest from
    those taken."""
    sample_num = min(points.shape[0], sample_num)
    cur = points.mean(0) if init_center else points[0]
    out = [cur]
    dist = np.full(points.shape[0], 1e18)
    for _ in range(sample_num - 1):
        dist = np.minimum(dist, np.linalg.norm(points - cur, axis=1))
        cur = points[int(np.argmax(dist))]
        out.append(cur)
    return np.asarray(out)


def save_pickle(data, path: str):
    with open(path, "wb") as f:
        pickle.dump(data, f)


def read_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


_PLY_TYPES = {"float": "f4", "double": "f8", "uchar": "u1", "int": "i4", "uint": "u4", "short": "i2",
              "ushort": "u2", "char": "i1", "float32": "f4", "float64": "f8", "uint8": "u1", "int32": "i4"}


def load_ply_points(path: str) -> np.ndarray:
    """The (x, y, z) vertices of an ascii or binary-little-endian PLY file,
    float32 (N, 3)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert, fmt, props = 0, "ascii", []
        for line in header:
            parts = line.split()
            if parts[:2] == ["element", "vertex"]:
                n_vert = int(parts[2])
            elif parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "property" and n_vert and len(props) < 32:
                props.append((parts[1], parts[2]))
        if fmt == "ascii":
            return np.loadtxt(f, max_rows=n_vert)[:, :3].astype(np.float32)
        dtype = np.dtype([(name, "<" + _PLY_TYPES[t]) for t, name in props])
        data = np.frombuffer(f.read(n_vert * dtype.itemsize), dtype=dtype)
        return np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
