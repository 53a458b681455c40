"""Matching-figure plotting (matplotlib, host side; a copy of
pope_tpu/utils/plotting.py).

Reference behavior: src/utils/plotting.py — make_matching_figure :19-58
(side-by-side pair, colored match lines, text overlay), error colormap
:61-77 (green->red by epipolar error vs threshold), make_matching_figures
:80-133 (evaluation-mode figure from a batch), dynamic_alpha :135-151
(line alpha decays with match count).
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np


def error_colormap(err: np.ndarray, thr: float, alpha: float = 1.0) -> np.ndarray:
    """(N,) errors -> (N, 4) RGBA, green below thr fading to red at 2*thr."""
    x = 1.0 - np.clip(err / (2.0 * thr), 0, 1)
    return np.stack([2 - 2 * x, 2 * x, np.zeros_like(x), np.full_like(x, alpha)], -1).clip(0, 1)


def dynamic_alpha(n_matches: int,
                  milestones=(0, 300, 1000, 2000),
                  alphas=(1.0, 0.8, 0.4, 0.2)) -> float:
    """Line alpha by match count (plotting.py:135-151, linear interpolation
    between milestones)."""
    if n_matches == 0:
        return 1.0
    ranges = list(zip(alphas, alphas[1:] + (alphas[-1],)))
    loc = bisect.bisect_right(milestones, n_matches) - 1
    _range = ranges[loc]
    if _range[0] == _range[1]:
        return _range[0]
    return _range[1] + (milestones[loc + 1] - n_matches) / (
        milestones[loc + 1] - milestones[loc]
    ) * (_range[0] - _range[1])


def make_matching_figure(
    img0: np.ndarray,
    img1: np.ndarray,
    mkpts0: np.ndarray,
    mkpts1: np.ndarray,
    color: Optional[np.ndarray] = None,
    kpts0: Optional[np.ndarray] = None,
    kpts1: Optional[np.ndarray] = None,
    text: Optional[list] = None,
    dpi: int = 75,
    path: Optional[str] = None,
):
    """Side-by-side matching figure (plotting.py:19-58)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 6), dpi=dpi)
    for ax, img in zip(axes, (img0, img1)):
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.get_yaxis().set_ticks([])
        ax.get_xaxis().set_ticks([])
        for spine in ax.spines.values():
            spine.set_visible(False)
    plt.tight_layout(pad=1)

    if kpts0 is not None:
        axes[0].scatter(kpts0[:, 0], kpts0[:, 1], c="w", s=2)
    if kpts1 is not None:
        axes[1].scatter(kpts1[:, 0], kpts1[:, 1], c="w", s=2)

    if len(mkpts0) > 0:
        if color is None:
            color = np.tile([0.0, 1.0, 0.0, dynamic_alpha(len(mkpts0))], (len(mkpts0), 1))
        fig.canvas.draw()
        tf_fig = fig.transFigure.inverted()
        f0 = tf_fig.transform(axes[0].transData.transform(mkpts0))
        f1 = tf_fig.transform(axes[1].transData.transform(mkpts1))
        from matplotlib.lines import Line2D

        fig.lines = [
            Line2D((f0[i, 0], f1[i, 0]), (f0[i, 1], f1[i, 1]),
                   transform=fig.transFigure, c=color[i], linewidth=1)
            for i in range(len(mkpts0))
        ]
        axes[0].scatter(mkpts0[:, 0], mkpts0[:, 1], c=color, s=4)
        axes[1].scatter(mkpts1[:, 0], mkpts1[:, 1], c=color, s=4)

    if text:
        fig.text(0.01, 0.99, "\n".join(text), transform=fig.axes[0].transAxes,
                 fontsize=15, va="top", ha="left", color="k")
    if path:
        plt.savefig(path, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return None
    return fig
