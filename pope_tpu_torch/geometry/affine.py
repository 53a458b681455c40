"""Affine crop geometry: box -> 2x3 transform, separable crop + resize, and
the intrinsics update K' = T @ K (port of pope_tpu/geometry/affine.py).

Every function takes leading batch dimensions: boxes (..., 4), centres and
scales (..., 2), K (..., 3, 3). The arithmetic is f32, as the JAX package's
`f32_matmul` holds it (on the card the entry points turn TF32 off).
"""

from __future__ import annotations

import math

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


def _to_homo3(M):
    """(..., 2, 3) affine -> (..., 3, 3) homogeneous."""
    row = M.new_tensor([0.0, 0.0, 1.0]).expand(*M.shape[:-2], 1, 3)
    return torch.cat([M, row], dim=-2)


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
