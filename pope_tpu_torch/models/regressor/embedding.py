"""NeRF-style sinusoidal feature embedding (port of
pope_tpu/models/regressor/embedding.py): x -> (x, sin(f_0 x), cos(f_0 x),
...), n_freqs bands; the mkpts models use linearly spaced frequencies
1..2^(n-1) (logscale=False)."""

from __future__ import annotations

import torch


def nerf_embedding(x, n_freqs: int = 9, logscale: bool = False):
    """(..., C) -> (..., C * (2 * n_freqs + 1)), channels [x, sin(f0 x),
    cos(f0 x), sin(f1 x), cos(f1 x), ...]."""
    if logscale:
        freqs = 2.0 ** torch.linspace(0.0, n_freqs - 1, n_freqs)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs)
    outs = [x]
    for f in freqs.tolist():
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)
