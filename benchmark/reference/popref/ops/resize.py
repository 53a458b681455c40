"""Image resampling with the JAX package's semantics.

Port of pope_tpu/ops/resize.py (the half-pixel bilinear resize that
postprocess_masks uses, and the matcher FPN's align-corners 2x upsample)
plus the antialiased resizes the JAX package gets from `jax.image.resize`:
bilinear for frames (pope_tpu/models/sam/amg.py:126-130, DINOv2's
preprocess) and bicubic for DINOv2's pos-embed grid
(pope_tpu/models/dinov2/model.py:135-149). PyTorch's `F.interpolate` is not
guaranteed to give the same values (its bicubic is a = -0.75 and not
antialiased), so the separable weight matrices are built here the way
`jax.image.scale_and_translate` builds them (a triangle or Keys a = -0.5
cubic kernel widened by the downscale factor, renormalised at the edges) and
applied as two f32 products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _resample_weights(in_size: int, out_size: int, device, kernel=_triangle) -> torch.Tensor:
    """(in_size, out_size) f32 weights of an antialiased resample."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_antialias(x, out_hw, kernel):
    out_h, out_w = out_hw
    wh = _resample_weights(x.shape[1], out_h, x.device, kernel)
    ww = _resample_weights(x.shape[2], out_w, x.device, kernel)
    y = torch.einsum("bhwc,hH->bHwc", x, wh)
    return torch.einsum("bHwc,wW->bHWc", y, ww)


def resize_bilinear_antialias(x, out_hw):
    """(B, H, W, C) f32 -> (B, out_h, out_w, C), antialiased bilinear."""
    return _resize_antialias(x, out_hw, _triangle)


def resize_bicubic_antialias(x, out_hw):
    """(B, H, W, C) f32 -> (B, out_h, out_w, C), antialiased Keys cubic
    (jax.image.resize(..., "bicubic"))."""
    return _resize_antialias(x, out_hw, _keys_cubic)


def _resize_axis_align_corners(x, axis: int, out_size: int):
    """Linear resample along `axis` on the align_corners=True grid, as the
    JAX helper computes it: two gathered taps and a lerp."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size == 1:
        reps = [1] * x.ndim
        reps[axis] = out_size
        return x.repeat(*reps)
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * ((in_size - 1) / (out_size - 1))
    i0 = torch.clamp(torch.floor(pos).long(), 0, in_size - 2)
    frac = pos - i0.float()
    a = x.index_select(axis, i0)
    b = x.index_select(axis, i0 + 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    frac = frac.reshape(shape).to(x.dtype)
    return a * (1 - frac) + b * frac


def upsample2x_align_corners(x, hw_axes=(1, 2)):
    """2x bilinear upsample with align_corners=True (the matcher FPN's
    F.interpolate(scale_factor=2, align_corners=True)); NHWC by default,
    `hw_axes=(2, 3)` for NCHW. Height first, then width, as the JAX helper."""
    ah, aw = hw_axes
    x = _resize_axis_align_corners(x, ah, 2 * x.shape[ah])
    return _resize_axis_align_corners(x, aw, 2 * x.shape[aw])


def resize_bilinear_torch(x, out_hw):
    """Half-pixel bilinear resize of (B, H, W, C), the semantics of
    F.interpolate(mode="bilinear", align_corners=False) that SAM's
    postprocess uses (pope_tpu/ops/resize.py reimplements them in jnp)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
