"""Ground-truth supervision of the matcher from depth and pose, static
shapes (port of pope_tpu/train/supervision.py).

warp_kpts unprojects with depth, moves the points rigidly and reprojects
them, keeping those inside image 1 whose depth agrees within 20%;
spvs_coarse builds the one-hot coarse GT from mutually nearest warped grid
cells; spvs_fine gives each used match's target offset in image 1's fine
window. Rounding is half to even, as jnp.round's.
"""

from __future__ import annotations

import torch


def _at(depth, y, x):
    """depth (B, H, W) at integer (B, L) rows y and columns x -> (B, L)."""
    B, H, W = depth.shape
    return depth.reshape(B, H * W).gather(1, (y * W + x).long())


def warp_kpts(kpts0, depth0, depth1, T_0to1, K0, K1):
    """Warp (B, L, 2) pixel keypoints of image 0 into image 1 by depth.
    T_0to1 (B, 3, 4) or (B, 4, 4), K's (B, 3, 3). Returns (valid (B, L)
    bool, warped (B, L, 2))."""
    kl = torch.round(kpts0).to(torch.int64)
    H0, W0 = depth0.shape[1:3]
    d0 = _at(depth0, kl[..., 1].clamp(0, H0 - 1), kl[..., 0].clamp(0, W0 - 1))
    nonzero = d0 != 0

    kpts0_h = torch.cat([kpts0, torch.ones_like(kpts0[..., :1])], dim=-1) * d0[..., None]
    kpts0_cam = torch.einsum("bij,blj->bli", torch.linalg.inv(K0), kpts0_h)
    w_cam = torch.einsum("bij,blj->bli", T_0to1[:, :3, :3], kpts0_cam) + T_0to1[:, None, :3, 3]
    w_depth = w_cam[..., 2]
    w_h = torch.einsum("bij,blj->bli", K1, w_cam)
    w_kpts0 = w_h[..., :2] / (w_h[..., 2:] + 1e-4)

    H1, W1 = depth1.shape[1:3]
    covis = ((w_kpts0[..., 0] > 0) & (w_kpts0[..., 0] < W1 - 1)
             & (w_kpts0[..., 1] > 0) & (w_kpts0[..., 1] < H1 - 1))
    wl = torch.where(covis[..., None], w_kpts0, torch.zeros_like(w_kpts0)).to(torch.int64)  # truncates
    d1 = _at(depth1, wl[..., 1].clamp(0, H1 - 1), wl[..., 0].clamp(0, W1 - 1))
    consistent = ((d1 - w_depth) / torch.where(d1 == 0, torch.full_like(d1, 1e9), d1)).abs() < 0.2
    return nonzero & covis & consistent, w_kpts0


def _grid_pts(h: int, w: int, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(h * w, 2)  # xy order


def spvs_coarse(batch, coarse_scale: int):
    """The one-hot GT confidence matrix of the coarse grids.

    batch: image0 / image1 (B, H, W, 1), depth0 / depth1 (B, Hd, Wd),
    T_0to1 / T_1to0 (B, 4, 4), K0 / K1 (B, 3, 3), optional scale0 / scale1
    (B, 2). Returns conf_matrix_gt (B, L, S) f32, spv_valid (B, L) bool,
    spv_j_of_i (B, L) int64, spv_w_pt0_i (B, L, 2), spv_grid_pt1_i (B, S, 2).
    """
    img0, img1 = batch["image0"], batch["image1"]
    B, H0, W0 = img0.shape[:3]
    H1, W1 = img1.shape[1:3]
    dev = img0.device
    h0, w0, h1, w1 = H0 // coarse_scale, W0 // coarse_scale, H1 // coarse_scale, W1 // coarse_scale
    ones = torch.ones(B, 2, device=dev)
    scale0 = coarse_scale * batch.get("scale0", ones)[:, None]
    scale1 = coarse_scale * batch.get("scale1", ones)[:, None]

    g0 = _grid_pts(h0, w0, dev)[None].expand(B, h0 * w0, 2) * scale0
    g1 = _grid_pts(h1, w1, dev)[None].expand(B, h1 * w1, 2) * scale1
    _, w_pt0 = warp_kpts(g0, batch["depth0"], batch["depth1"], batch["T_0to1"], batch["K0"], batch["K1"])
    _, w_pt1 = warp_kpts(g1, batch["depth1"], batch["depth0"], batch["T_1to0"], batch["K1"], batch["K0"])

    def nearest(w_pt, scale, h, w):
        r = torch.round(w_pt / scale).to(torch.int64)
        oob = (r[..., 0] < 0) | (r[..., 0] >= w) | (r[..., 1] < 0) | (r[..., 1] >= h)
        return torch.where(oob, torch.zeros_like(r[..., 0]), r[..., 0] + r[..., 1] * w)

    nearest1 = nearest(w_pt0, scale1, h1, w1)  # (B, L)
    nearest0 = nearest(w_pt1, scale0, h0, w0)  # (B, S)
    loop_back = nearest0.gather(1, nearest1)
    correct = loop_back == torch.arange(h0 * w0, device=dev)[None]
    correct[:, 0] = False  # the top-left corner is ignored
    # warp validity is not applied: out-of-bounds cells are redirected to
    # index 0, which the corner exclusion drops, as the reference does
    conf_gt = torch.nn.functional.one_hot(nearest1, h1 * w1).float() * correct[..., None]
    return {
        "conf_matrix_gt": conf_gt,
        "spv_valid": correct,
        "spv_j_of_i": nearest1,
        "spv_w_pt0_i": w_pt0,
        "spv_grid_pt1_i": g1,
    }


def spvs_fine(spv, i_ids, j_ids, fine_scale: int, window: int, scale1=None):
    """Each selected match's GT offset in image 1's fine window, normalized
    to [-1, 1] by the window radius: (B, M, 2). Values beyond 1 lie outside
    the window; the loss masks them. `scale1` (B, 2) scales the window as
    the reference does for resized images (the JAX trainer passes none)."""
    radius = window // 2
    take = lambda t, ids: t.gather(1, ids[..., None].expand(*ids.shape, 2))
    w0 = take(spv["spv_w_pt0_i"], i_ids)
    p1 = take(spv["spv_grid_pt1_i"], j_ids)
    s = fine_scale if scale1 is None else fine_scale * scale1[:, None]
    return (w0 - p1) / s / radius
