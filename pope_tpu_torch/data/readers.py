"""Image/depth/pose readers for the matcher-training datasets (a copy of
pope_tpu/data/readers.py, which the port does not import; cv2 and h5py are
imported on first use).

Reference behavior: src/utils/dataset.py — read_scannet_gray(v2) :174-209
(grayscale [0,1] tensors, fixed 640x480 resize), read_scannet_depth :212-218
(mm -> m), read_scannet_pose :222-230 (cam2world -> world2cam),
read_scannet_intrinsic :233-237, read_megadepth_gray :104-134 (longest-edge
resize to `resize`, divisible-by-df rounding, optional square padding with a
validity mask, scale factors returned), read_megadepth_depth :138-146 (h5).
Outputs are numpy (host side); the training driver moves them to the device
in batches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def get_resized_wh(w: int, h: int, resize: Optional[int]) -> Tuple[int, int]:
    if resize is None:
        return w, h
    scale = resize / max(w, h)
    return int(round(w * scale)), int(round(h * scale))


def get_divisible_wh(w: int, h: int, df: Optional[int]) -> Tuple[int, int]:
    if df is None:
        return w, h
    return max(w // df, 1) * df, max(h // df, 1) * df


def pad_bottom_right(img: np.ndarray, pad_to: int, ret_mask: bool = False):
    h, w = img.shape[:2]
    out = np.zeros((pad_to, pad_to) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    if not ret_mask:
        return out, None
    mask = np.zeros((pad_to, pad_to), bool)
    mask[:h, :w] = True
    return out, mask


def read_scannet_gray(path: str, resize: Tuple[int, int] = (640, 480)) -> np.ndarray:
    """(1, h, w) float grayscale in [0, 1], resized to (w, h)."""
    import cv2

    img = _imread_gray(path)
    img = cv2.resize(img, resize)
    return img[None].astype(np.float32) / 255.0


def read_scannet_grayv2(path: str) -> np.ndarray:
    """Same, without the resize."""
    return _imread_gray(path)[None].astype(np.float32) / 255.0


def read_scannet_depth(path: str) -> np.ndarray:
    import cv2

    depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return depth.astype(np.float32) / 1000.0


def read_scannet_pose(path: str) -> np.ndarray:
    """cam2world on disk -> world2cam (dataset.py:222-230)."""
    cam2world = np.loadtxt(path, delimiter=" ")
    return np.linalg.inv(cam2world)


def read_scannet_intrinsic(path: str) -> np.ndarray:
    intrinsic = np.loadtxt(path, delimiter=" ")
    return intrinsic[:-1, :-1]


def read_megadepth_gray(path: str, resize: Optional[int] = None, df: Optional[int] = None, padding: bool = False):
    """Returns (image (1, h, w) [0,1], mask (h, w) or None, scale [w/w', h/h'])."""
    import cv2

    image = _imread_gray(path)
    h, w = image.shape
    w_new, h_new = get_resized_wh(w, h, resize)
    w_new, h_new = get_divisible_wh(w_new, h_new, df)
    image = cv2.resize(image, (w_new, h_new))
    scale = np.asarray([w / w_new, h / h_new], np.float32)
    mask = None
    if padding:
        image, mask = pad_bottom_right(image, max(h_new, w_new), ret_mask=True)
    return image[None].astype(np.float32) / 255.0, mask, scale


def read_megadepth_depth(path: str, pad_to: Optional[int] = None) -> np.ndarray:
    import h5py

    depth = np.array(h5py.File(path, "r")["depth"])
    if pad_to is not None:
        depth, _ = pad_bottom_right(depth, pad_to, ret_mask=False)
    return depth.astype(np.float32)
