"""Affine crop geometry: box -> 2x3 transform, separable crop + resize,
cv2-style warpAffine, box expansion / clamping, and the intrinsics update
K' = T @ K (port of pope_tpu/geometry/affine.py).

Every tensor function takes leading batch dimensions: boxes (..., 4),
centres and scales (..., 2), K (..., 3, 3), images (..., H, W[, C]). The
arithmetic is f32, as the JAX package's `f32_matmul` holds it (on the card
the entry points turn TF32 off). `get_affine_transform_np` is the float64
host twin.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _third_point(a, b):
    """Perpendicular third point: b + perp(a - b)."""
    d = a - b
    return b + torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def _affine_src_dst(center, scale, rot_deg: float, out_w: float, out_h: float):
    """The 3 source / destination control points of the reference transform."""
    src_w = scale[..., 0]
    rot = math.pi * rot_deg / 180.0
    sn, cs = math.sin(rot), math.cos(rot)
    src_dir = torch.stack([0.5 * src_w * sn, -0.5 * src_w * cs], dim=-1)
    dst0 = center.new_tensor([0.5 * out_w, 0.5 * out_h]).expand_as(center)
    dst1 = dst0 + center.new_tensor([0.0, -0.5 * out_w])
    src0, src1 = center, center + src_dir
    src = torch.stack([src0, src1, _third_point(src0, src1)], dim=-2)  # (..., 3, 2)
    dst = torch.stack([dst0, dst1, _third_point(dst0, dst1)], dim=-2)
    return src, dst


def _solve_affine(src, dst):
    """The exact 2x3 affine mapping 3 src points to 3 dst points
    (cv2.getAffineTransform)."""
    A = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)  # (..., 3, 3)
    Mt, _ = torch.linalg.solve_ex(A, dst)  # A @ M.T = dst; no host sync for the check
    return Mt.transpose(-1, -2)


def get_affine_transform(center, scale, rot_deg: float, output_size, inv: bool = False):
    """(..., 2, 3) affine from a (center, scale, rotation) crop spec.
    output_size = (out_w, out_h); inv=True gives the dst -> src transform."""
    out_w, out_h = output_size
    src, dst = _affine_src_dst(center.float(), scale.float(), rot_deg, float(out_w), float(out_h))
    if inv:
        src, dst = dst, src
    return _solve_affine(src, dst)


def get_affine_transform_np(center, scale, rot_deg: float, output_size, inv: bool = False) -> np.ndarray:
    """Host (numpy, float64) twin of get_affine_transform for one crop."""
    center = np.asarray(center, np.float64)
    src_w = float(np.asarray(scale, np.float64)[0])
    out_w, out_h = float(output_size[0]), float(output_size[1])
    rot = np.pi * float(rot_deg) / 180.0
    third = lambda a, b: b + np.array([-(a - b)[1], (a - b)[0]])
    src1 = center + np.array([0.5 * src_w * np.sin(rot), -0.5 * src_w * np.cos(rot)])
    dst0 = np.array([0.5 * out_w, 0.5 * out_h])
    dst1 = dst0 + np.array([0.0, -0.5 * out_w])
    src = np.stack([center, src1, third(center, src1)])
    dst = np.stack([dst0, dst1, third(dst0, dst1)])
    if inv:
        src, dst = dst, src
    return np.linalg.solve(np.concatenate([src, np.ones((3, 1))], 1), dst).T


def _to_homo3(M):
    """(..., 2, 3) affine -> (..., 3, 3) homogeneous."""
    row = M.new_tensor([0.0, 0.0, 1.0]).expand(*M.shape[:-2], 1, 3)
    return torch.cat([M, row], dim=-2)


def warp_affine(image, M, out_hw):
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT=0): output pixel (x, y)
    samples the source at M^-1 (x, y, 1), bilinear, out-of-bounds taps 0.

    image: (H, W) or (..., H, W, C); M: (..., 2, 3) forward (src -> dst)
    affines with the image's leading dims. Returns (..., out_h, out_w[, C])
    in image.dtype, computed in f32."""
    out_h, out_w = out_hw
    squeeze = image.ndim == 2
    img = image[..., None] if squeeze else image
    H, W = img.shape[-3], img.shape[-2]
    Minv = torch.linalg.inv(_to_homo3(M.float()))[..., :2, :]  # (..., 2, 3)
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (h, w, 3)
    src = torch.einsum("hwk,...jk->...hwj", dst, Minv)  # (..., h, w, 2)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = img.float().reshape(*img.shape[:-3], H * W, img.shape[-1])

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(*xi.shape[:-2], -1, 1)
        v = torch.gather(flat, -2, lin.expand(*lin.shape[:-1], flat.shape[-1])).reshape(*xi.shape, -1)
        return torch.where(valid[..., None], v, 0.0)

    out = (tap(x0i, y0i) * (1 - fx) * (1 - fy) + tap(x0i + 1, y0i) * fx * (1 - fy)
           + tap(x0i, y0i + 1) * (1 - fx) * fy + tap(x0i + 1, y0i + 1) * fx * fy)
    out = out.to(image.dtype)
    return out[..., 0] if squeeze else out


def compact_box(bbox_xywh, compact_percent: float = 0.3):
    """Expand (..., 4) xywh boxes by compact_percent of w / h on each side:
    (..., 4) xyxy, float (the drivers round at the host edge)."""
    x0, y0, w, h = bbox_xywh.unbind(-1)
    return torch.stack([x0 - w * compact_percent, y0 - h * compact_percent,
                        x0 + w + w * compact_percent, y0 + h + h * compact_percent], dim=-1)


def clamped_scale_box(bbox_xywh, src_w: float, src_h: float, scale):
    """Scale (..., 4) xywh boxes about their centres, the scale clamped so a
    box fits the image, then shifted back inside its bounds: (..., 4) xyxy."""
    x, y, bw, bh = bbox_xywh.unbind(-1)
    scale = torch.minimum((src_h - 1.0) / bh, torch.minimum((src_w - 1.0) / bw, torch.as_tensor(scale, dtype=bw.dtype)))
    nw, nh = bw * scale, bh * scale
    cx, cy = x + bw / 2.0, y + bh / 2.0
    x0, y0 = cx - nw / 2.0, cy - nh / 2.0
    x1, y1 = cx + nw / 2.0, cy + nh / 2.0
    # shift inside the bounds (the reference's if-cascade, in its order)
    x1 = torch.where(x0 < 0, x1 - x0, x1)
    x0 = torch.clamp(x0, min=0.0)
    y1 = torch.where(y0 < 0, y1 - y0, y1)
    y0 = torch.clamp(y0, min=0.0)
    x0 = torch.where(x1 > src_w - 1, x0 - (x1 - src_w + 1), x0)
    x1 = torch.clamp(x1, max=src_w - 1.0)
    y0 = torch.where(y1 > src_h - 1, y0 - (y1 - src_h + 1), y0)
    y1 = torch.clamp(y1, max=src_h - 1.0)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _center_scale(box):
    center = torch.stack([(box[..., 0] + box[..., 2]) / 2.0, (box[..., 1] + box[..., 3]) / 2.0], -1)
    # degenerate (zero-area) boxes of padded slots must not poison the batch
    scale = torch.clamp(torch.stack([box[..., 2] - box[..., 0], box[..., 3] - box[..., 1]], -1), min=1e-3)
    return center, scale


def _lerp_matrix(pos, n: int):
    """(..., len(pos), n) interpolation matrix: row o holds the two bilinear
    tap weights of fractional position pos[o]; out-of-range taps get weight
    0 (cv2 BORDER_CONSTANT)."""
    i0 = torch.floor(pos)
    f = pos - i0
    i0i = i0.long()
    cols = torch.arange(n, device=pos.device)
    zero = torch.zeros_like(f)
    w0 = torch.where((i0i >= 0) & (i0i < n), 1.0 - f, zero)
    w1 = torch.where((i0i + 1 >= 0) & (i0i + 1 < n), f, zero)
    return (cols == i0i[..., None]) * w0[..., None] + (cols == (i0i + 1)[..., None]) * w1[..., None]


def crop_resize_bilinear(image, box, out_hw):
    """Axis-aligned crop + resize on the sampling grid of the reference's
    rot=0 warpAffine, as two separable lerps applied as f32 products.

    image: (B, H, W, C) (or (B, H, W)); box: (B, n, 4) xyxy per image.
    Returns (B, n, out_h, out_w, C) (or (B, n, out_h, out_w)) in image.dtype.
    The transform is a uniform-scale similarity from the box width alone
    (both axes scale by out_w / bw), as get_affine_transform builds it.
    """
    out_h, out_w = out_hw
    box = box.float()
    bw = torch.clamp(box[..., 2] - box[..., 0], min=1e-3)
    cx = (box[..., 0] + box[..., 2]) / 2.0
    cy = (box[..., 1] + box[..., 3]) / 2.0
    s = out_w / bw
    dev = box.device
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) - out_w / 2.0) / s[..., None] + cx[..., None]
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) - out_h / 2.0) / s[..., None] + cy[..., None]
    img = image.float()
    squeeze = img.ndim == 3
    if squeeze:
        img = img[..., None]
    ry = _lerp_matrix(ys, img.shape[1])  # (B, n, out_h, H)
    rx = _lerp_matrix(xs, img.shape[2])  # (B, n, out_w, W)
    out = torch.einsum("bnoh,bhwc->bnowc", ry, img)
    out = torch.einsum("bnpw,bnowc->bnopc", rx, out)
    if squeeze:
        out = out[..., 0]
    return out.to(image.dtype)


def get_image_crop_resize(image, box, resize_shape):
    """Crop `box` (B, n, 4) xyxy out of `image` (B, H, W, C) and resize to
    `resize_shape` = (h, w). Returns (crops (B, n, h, w, C), trans_homo
    (B, n, 3, 3))."""
    resize_h, resize_w = int(resize_shape[0]), int(resize_shape[1])
    center, scale = _center_scale(box.float())
    trans = get_affine_transform(center, scale, 0.0, (resize_w, resize_h))
    return crop_resize_bilinear(image, box, (resize_h, resize_w)), _to_homo3(trans)


def get_K_crop_resize(box, K, resize_shape):
    """Intrinsics update for crop + resize: K' = T_homo @ K_homo.
    box (..., 4); K (..., 3, 3) or (..., 3, 4) broadcast against it.
    Returns ((..., 3, 3), (..., 3, 4))."""
    resize_h, resize_w = int(resize_shape[0]), int(resize_shape[1])
    center, scale = _center_scale(box.float())
    T = _to_homo3(get_affine_transform(center, scale, 0.0, (resize_w, resize_h)))
    K = K.float()
    if K.shape[-2:] == (3, 3):
        K = torch.cat([K, torch.zeros_like(K[..., :1])], dim=-1)
    K_crop_homo = T @ K
    return K_crop_homo[..., :3, :3], K_crop_homo
