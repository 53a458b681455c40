"""Connected components and small-region cleanup of binary masks, batched
over leading dims (port of pope_tpu/ops/components.py).

Semantics of segment_anything's `remove_small_regions` (8-connectivity; in
islands mode keep the largest island when all fall below the threshold;
changed=True whenever any small region existed). The labelling is the JAX
package's: each round takes the 8-neighbour minimum and then segmented
min-scans along rows and columns, until a round changes nothing. A batch runs
until its slowest mask converges; a converged mask is a fixed point of a
round, so every mask ends where it would alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_along(x, d: int, axis: int, fill):
    """x shifted by +d along `axis` (element i takes the value at i - d; d may
    be negative), vacated slots filled."""
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = abs(d)
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    if d > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - d)], dim=axis)
    return torch.cat([x.narrow(axis, -d, n + d), pad], dim=axis)


def _segmented_min_scan(lab, working, big: int, axis: int, reverse: bool):
    """Min-scan of `lab` along `axis`, restarting at every background pixel
    (Hillis-Steele doubling with static shifts)."""
    step = -1 if reverse else 1
    flags = ~working | _shift_along(~working, step, axis, True)
    v = torch.where(working, lab, big)
    d = step
    n = lab.shape[axis]
    while abs(d) < n:
        v = torch.where(flags, v, torch.minimum(v, _shift_along(v, d, axis, big)))
        flags = flags | _shift_along(flags, d, axis, True)
        d *= 2
    return torch.where(working, v, big)


def label_components(mask, max_iters: int = 64):
    """8-connected component labels of (..., H, W) bool masks: each foreground
    pixel holds the smallest row-major index of its component, background
    pixels hold H*W. int32."""
    h, w = mask.shape[-2:]
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, big)

    def neighbour_min(lab):
        p = F.pad(lab, (1, 1, 1, 1), value=big)
        m = lab
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                m = torch.minimum(m, p[..., dy : dy + h, dx : dx + w])
        return torch.where(mask, m, big)

    for _ in range(max_iters):
        new = neighbour_min(lab)
        new = _segmented_min_scan(new, mask, big, axis=-1, reverse=False)
        new = _segmented_min_scan(new, mask, big, axis=-1, reverse=True)
        new = _segmented_min_scan(new, mask, big, axis=-2, reverse=False)
        new = _segmented_min_scan(new, mask, big, axis=-2, reverse=True)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    return lab


def component_roots(labels, mask, k: int = 64):
    """The k raster-first component root indices of labelled masks:
    (..., k) int32 ascending (cv2 label order), padded with H*W."""
    h, w = labels.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32, device=labels.device).reshape(h, w)
    is_root = mask & (labels == idx)
    neg = torch.where(is_root, -idx, -h * w).flatten(-2)
    return -torch.sort(neg, dim=-1, descending=True, stable=True).values[..., :k]


def _membership(labels, roots):
    """(..., H*W, k) bool [label_p == root_k]; padding roots match nothing."""
    big = labels.shape[-2] * labels.shape[-1]
    flat = labels.flatten(-2)
    return (flat[..., :, None] == roots[..., None, :]) & (roots[..., None, :] < big)


def remove_small_regions(mask, area_thresh, mode: str, max_iters: int = 64, k: int = 64):
    """Fill small holes ('holes') or drop small islands ('islands') of
    (..., H, W) bool masks. Returns (masks', changed (...,)). At most k
    components per mask are processed (raster-first); the rest stay."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"unknown mode {mode!r}")
    holes = mode == "holes"
    h, w = mask.shape[-2:]
    working = ~mask if holes else mask
    lab = label_components(working, max_iters=max_iters)
    roots = component_roots(lab, working, k=k)
    matches = _membership(lab, roots)
    areas = matches.sum(dim=-2).float()
    real = roots < h * w
    small_root = real & (areas < area_thresh)
    small = (matches & small_root[..., None, :]).any(dim=-1).unflatten(-1, (h, w))
    changed = small_root.any(dim=-1)
    if holes:
        out = mask | small
    else:
        out = mask & ~small
        # all islands small -> keep the largest; argmax takes the first of
        # tied areas, i.e. the raster-first component
        any_kept = out.any(dim=(-2, -1))
        pick = torch.where(real, areas, torch.full_like(areas, -1.0)).argmax(dim=-1, keepdim=True)
        best = roots.gather(-1, pick)[..., None]
        out = torch.where(any_kept[..., None, None], out, working & (lab == best))
    return torch.where(changed[..., None, None], out, mask), changed


def clean_mask(mask, area_thresh, max_iters: int = 64, k: int = 64):
    """Holes-then-islands cleanup of (..., H, W) bool masks; returns
    (masks', changed)."""
    m1, ch1 = remove_small_regions(mask, area_thresh, "holes", max_iters, k)
    m2, ch2 = remove_small_regions(m1, area_thresh, "islands", max_iters, k)
    return m2, ch1 | ch2
