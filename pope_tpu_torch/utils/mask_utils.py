"""Mask/image host utilities (a copy of pope_tpu/utils/mask_utils.py; cv2
imported where used).

Reference behavior: segment_anything/segment_anything/mask_utils.py —
convert_mask_to_polygon :8-24 (largest external contour), common_resize :5
(aspect-preserving resize), letterbox_image :26-43 (pad-to-size with gray),
convert_contour2mask (fillPoly).
"""

from __future__ import annotations

import numpy as np


def convert_mask_to_polygon(mask: np.ndarray) -> np.ndarray:
    """Largest external contour of a binary mask as an (N, 2) polygon."""
    import cv2

    m = np.asarray(mask, np.uint8)
    contours = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_TC89_KCOS)[0]
    if not contours:
        raise ValueError("no contours found")
    contour = max(contours, key=lambda arr: arr.size)
    contour = np.squeeze(contour)
    if contour.size < 6:
        raise ValueError("less than three points detected; cannot build a polygon")
    return contour


def convert_contour2mask(contour: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.asarray(contour, np.int32).reshape(-1, 1, 2)], 1)
    return mask.astype(bool)


def common_resize(image: np.ndarray, target_long_side: int):
    """Aspect-preserving resize with the longer side at target_long_side.
    Returns (resized, scale)."""
    import cv2

    h, w = image.shape[:2]
    scale = target_long_side / max(h, w)
    out = cv2.resize(image, (int(round(w * scale)), int(round(h * scale))))
    return out, scale


def letterbox_image(image: np.ndarray, size_hw, fill: int = 128):
    """Resize keeping aspect and pad to `size_hw` with `fill` gray."""
    import cv2

    th, tw = size_hw
    h, w = image.shape[:2]
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(image, (nw, nh))
    canvas = np.full((th, tw) + image.shape[2:], fill, image.dtype)
    top = (th - nh) // 2
    left = (tw - nw) // 2
    canvas[top : top + nh, left : left + nw] = resized
    return canvas
