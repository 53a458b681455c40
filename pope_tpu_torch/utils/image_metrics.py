"""Image quality metrics: PSNR and SSIM (a copy of
pope_tpu/utils/image_metrics.py, numpy only).

Behavioral spec: the reference's novel-view app imports img2psnr/ssim from
its external gnt_utils (src/novel_view_render.py:13); these are the standard
formulations (SSIM per Wang et al. 2004 with an 11x11 Gaussian window,
sigma 1.5, K1=0.01, K2=0.03, channel-averaged). LPIPS lives in
utils/lpips.py: the architecture + strict converters are implemented and
parity-tested; the pretrained weights are not in the repository, so the
NVS driver takes them as optional CLI paths.
Host numpy: these score a handful of rendered frames, not a hot path.
"""

from __future__ import annotations

import numpy as np


def psnr(img, ref, data_range: float = 1.0) -> float:
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    mse = np.mean((img - ref) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g)


def _filter2(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """'valid'-mode 2-D correlation via FFT-free separable passes."""
    from numpy.lib.stride_tricks import sliding_window_view

    k = win.shape[0]
    patches = sliding_window_view(img, (k, k))  # (H-k+1, W-k+1, k, k)
    return np.einsum("hwij,ij->hw", patches, win)


def ssim(img, ref, data_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM; channel-averaged for (H, W, C) inputs."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.ndim == 3:
        return float(
            np.mean([ssim(img[..., c], ref[..., c], data_range, win_size, sigma, k1, k2)
                     for c in range(img.shape[-1])])
        )
    win = _gaussian_window(win_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _filter2(img, win)
    mu2 = _filter2(ref, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2(img * img, win) - mu1_sq
    s2 = _filter2(ref * ref, win) - mu2_sq
    s12 = _filter2(img * ref, win) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(np.mean(m))
