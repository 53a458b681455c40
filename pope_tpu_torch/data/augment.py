"""Training-time photometric augmentations (host, numpy; a copy of
pope_tpu/data/augment.py, so a seed gives the same bytes).

Reference behavior: src/utils/augment.py — DarkAug :4-21 (random gamma +
brightness/contrast drop + blur, always applied) and MobileAug :24-38
(motion blur / color jitter / ISO-like noise, one of), built there on
albumentations; here on cv2 (imported where used) and numpy with the same
parameter ranges.
"""

from __future__ import annotations

import numpy as np


def _rand_gamma(img, rng, lo=80, hi=120):
    gamma = rng.uniform(lo, hi) / 100.0
    x = img.astype(np.float32) / 255.0
    return (np.power(x, gamma) * 255.0).clip(0, 255).astype(np.uint8)


def _brightness_contrast(img, rng, b_lim=(-0.5, 0.0), c_lim=(-0.5, 0.0)):
    b = rng.uniform(*b_lim)
    c = 1.0 + rng.uniform(*c_lim)
    x = img.astype(np.float32)
    mean = x.mean()
    x = (x - mean) * c + mean + 255.0 * b
    return x.clip(0, 255).astype(np.uint8)


def _motion_blur(img, rng, max_k=7):
    import cv2

    k = int(rng.integers(3, max_k + 1)) | 1
    kernel = np.zeros((k, k), np.float32)
    if rng.uniform() < 0.5:
        kernel[k // 2, :] = 1.0
    else:
        kernel[:, k // 2] = 1.0
    kernel /= kernel.sum()
    ang = rng.uniform(0, 180)
    M = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), ang, 1.0)
    kernel = cv2.warpAffine(kernel, M, (k, k))
    s = kernel.sum()
    if s > 0:
        kernel /= s
    return cv2.filter2D(img, -1, kernel)


def _gauss_noise(img, rng, sigma=(5, 25)):
    s = rng.uniform(*sigma)
    noisy = img.astype(np.float32) + rng.normal(0, s, img.shape)
    return noisy.clip(0, 255).astype(np.uint8)


class DarkAug:
    """Low-light simulation: gamma + brightness/contrast drop + blur."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        import cv2

        out = _rand_gamma(img, self.rng)
        out = _brightness_contrast(out, self.rng)
        k = int(self.rng.integers(1, 4)) * 2 + 1
        return cv2.GaussianBlur(out, (k, k), 0)


class MobileAug:
    """Phone-capture artifacts: one of motion blur / jitter / noise."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        choice = self.rng.integers(0, 3)
        if choice == 0:
            return _motion_blur(img, self.rng)
        if choice == 1:
            return _brightness_contrast(img, self.rng, b_lim=(-0.2, 0.2), c_lim=(-0.2, 0.2))
        return _gauss_noise(img, self.rng)


def build_augmentor(method: str | None, seed: int = 0):
    """'dark' | 'mobile' | None (augment.py:41-55)."""
    if method is None or method == "none":
        return None
    if method == "dark":
        return DarkAug(seed)
    if method == "mobile":
        return MobileAug(seed)
    raise ValueError(f"unknown augment method {method}")
