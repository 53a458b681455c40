"""Host-side drawing utilities, numpy and cv2 (the port's copy of
pope_tpu/utils/draw.py).

Behavioral spec: utils/draw_utils.py — draw_correspondence :27 (side-by-side
pair with match lines), draw_bbox_3d :277 (12 box edges), draw_axis :296
(cv2.projectPoints of the coordinate axes); visual_sam.py:7-18 (random-color
mask rendering); dinov2_utils.plot_pca :9 (JET heatmap of a PCA component).
"""

from __future__ import annotations

import numpy as np


def draw_correspondence(img0, img1, kpts0, kpts1, max_lines: int = 200, color=(0, 255, 0)):
    """Stack two images side by side and draw match lines."""
    import cv2

    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    H = max(h0, h1)
    canvas = np.zeros((H, w0 + w1, 3), np.uint8)
    canvas[:h0, :w0] = img0 if img0.ndim == 3 else cv2.cvtColor(img0, cv2.COLOR_GRAY2BGR)
    canvas[:h1, w0:] = img1 if img1.ndim == 3 else cv2.cvtColor(img1, cv2.COLOR_GRAY2BGR)
    for (x0, y0), (x1, y1) in list(zip(np.asarray(kpts0), np.asarray(kpts1)))[:max_lines]:
        p0 = (int(round(x0)), int(round(y0)))
        p1 = (int(round(x1)) + w0, int(round(y1)))
        cv2.circle(canvas, p0, 2, color, -1)
        cv2.circle(canvas, p1, 2, color, -1)
        cv2.line(canvas, p0, p1, color, 1, cv2.LINE_AA)
    return canvas


BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_bbox_3d(img, corners2d, color=(0, 0, 255), thickness=2):
    """Draw the 12 edges of a projected 3-D box (draw_utils.py:277-293).
    corners2d: (8, 2) in the (-x,-y,-z)..(x,y,z) binary-counting corner order.
    """
    import cv2

    out = img.copy()
    pts = np.asarray(corners2d).round().astype(int)
    for a, b in BOX_EDGES:
        cv2.line(out, tuple(pts[a]), tuple(pts[b]), color, thickness, cv2.LINE_AA)
    return out


def draw_axis(img, R, t, K, length: float = 0.1):
    """Project and draw object axes (draw_utils.py:296-303)."""
    import cv2

    pts3d = np.float32([[0, 0, 0], [length, 0, 0], [0, length, 0], [0, 0, length]])
    rvec, _ = cv2.Rodrigues(np.asarray(R, np.float64))
    pts2d, _ = cv2.projectPoints(pts3d, rvec, np.asarray(t, np.float64).reshape(3, 1), np.asarray(K, np.float64), None)
    pts2d = pts2d.reshape(-1, 2).round().astype(int)
    out = img.copy()
    for end, color in zip(pts2d[1:], [(0, 0, 255), (0, 255, 0), (255, 0, 0)]):
        cv2.line(out, tuple(pts2d[0]), tuple(end), color, 3, cv2.LINE_AA)
    return out


def draw_epipolar_line(F, img0, img1, pt0, color):
    """Draw one point in img0 and its epipolar line l = F @ [pt0; 1] in img1
    (draw_utils.py:105-116). Returns the two annotated images."""
    import cv2

    h1, w1 = img1.shape[:2]
    pt0 = np.asarray(pt0, np.float32)
    a, b, c = (F @ np.array([pt0[0], pt0[1], 1.0], np.float32)).ravel()
    if abs(b) >= 1e-6 * max(abs(a), 1e-12):
        p1 = (0, int(np.clip(round(-c / b), -(1 << 20), 1 << 20)))
        p2 = (int(w1), int(np.clip(round((-a * w1 - c) / b), -(1 << 20), 1 << 20)))
    else:  # near-vertical line x = -c/a (the reference divides by zero here)
        x = int(np.clip(round(-c / a), -(1 << 20), 1 << 20)) if abs(a) > 1e-12 else 0
        p1, p2 = (x, 0), (x, int(h1))
    img0 = cv2.circle(img0, tuple(pt0.round().astype(np.int32)), 5, color, 2)
    img1 = cv2.line(img1, p1, p2, color, 2)
    return img0, img1


def draw_epipolar_lines(F, img0, img1, num: int = 20, seed=None):
    """Random sample of `num` epipolar correspondences, random colors
    (draw_utils.py:118-130). `seed` pins the sampling for tests."""
    rng = np.random.default_rng(seed)
    img0, img1 = img0.copy(), img1.copy()
    h0, w0 = img0.shape[:2]
    for _ in range(num):
        color = [int(c) for c in rng.integers(0, 255, 3)]
        pt = rng.uniform(0, 1, 2) * np.array([w0, h0])
        img0, img1 = draw_epipolar_line(F, img0, img1, pt.astype(np.int32), color)
    return img0, img1


def render_masks(image, masks_bool, seed: int = 0, alpha: float = 0.65):
    """Random-color overlay of boolean masks (visual_sam.py:7-18)."""
    rng = np.random.default_rng(seed)
    out = image.astype(np.float32).copy()
    for m in masks_bool:
        color = rng.uniform(0, 255, 3)
        out[np.asarray(m, bool)] = (1 - alpha) * out[np.asarray(m, bool)] + alpha * color
    return out.astype(np.uint8)


def pca_heatmap(patch_tokens, grid_hw, out_path: str = "headmap.jpg", patch: int = 14):
    """PCA(1) of patch tokens -> JET colormap, resized x`patch`
    (dinov2_utils.plot_pca + visual_dinov2.py:48-61)."""
    import cv2

    tokens = np.asarray(patch_tokens)  # (N, C)
    tokens = tokens - tokens.mean(0, keepdims=True)
    # first principal component via SVD (sklearn-free)
    _, _, vt = np.linalg.svd(tokens, full_matrices=False)
    comp = tokens @ vt[0]
    h, w = grid_hw
    comp = comp.reshape(h, w)
    comp = (comp - comp.min()) / max(comp.max() - comp.min(), 1e-9)
    heat = cv2.applyColorMap((comp * 255).astype(np.uint8), cv2.COLORMAP_JET)
    heat = cv2.resize(heat, (w * patch, h * patch))
    if out_path:
        cv2.imwrite(out_path, heat)
    return heat
