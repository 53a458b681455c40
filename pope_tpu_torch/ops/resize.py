"""Image resampling with the JAX package's semantics.

Port of pope_tpu/ops/resize.py (the half-pixel bilinear resize that
postprocess_masks uses) plus the antialiased frame resize of
pope_tpu/models/sam/amg.py:126-130, which calls
`jax.image.resize(..., "bilinear", antialias=True)`. PyTorch's
`F.interpolate(antialias=True)` is not guaranteed to give the same pixels, so
the separable weight matrices are built here the way
`jax.image.scale_and_translate` builds them (a triangle kernel widened by
the downscale factor, renormalised at the edges) and applied as two f32
products.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _triangle_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of an antialiased linear resample."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear_antialias(x, out_hw):
    """(B, H, W, C) f32 -> (B, out_h, out_w, C), antialiased bilinear."""
    out_h, out_w = out_hw
    wh = _triangle_weights(x.shape[1], out_h, x.device)
    ww = _triangle_weights(x.shape[2], out_w, x.device)
    y = torch.einsum("bhwc,hH->bHwc", x, wh)
    return torch.einsum("bHwc,wW->bHWc", y, ww)


def resize_bilinear_torch(x, out_hw):
    """Half-pixel bilinear resize of (B, H, W, C), the semantics of
    F.interpolate(mode="bilinear", align_corners=False) that SAM's
    postprocess uses (pope_tpu/ops/resize.py reimplements them in jnp)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
