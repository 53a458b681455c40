"""The benchmark's inputs, made from a seed: 640x480 frames as
`pope_tpu_torch/bench.py::make_dataset` draws them (noise frames, the
target with a filled rectangle), seeded."""

from __future__ import annotations

import numpy as np

H, W = 480, 640


def frame_pairs(seed: int, n: int):
    """(n, H, W, 3) uint8 RGB prompt frames and target frames from the seed:
    uniform noise, the target with a yellow-ish rectangle."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    tgt = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    x0, y0, x1, y1 = 200, 140, 440, 340
    tgt[:, y0:y1 + 1, x0:x1 + 1] = (20, 240, 250)  # RGB of bench.py's BGR (250, 240, 20)
    return ref, tgt


def order(seed: int, n: int) -> np.ndarray:
    """The run's order of a pool of n items, a permutation drawn from its seed."""
    return np.random.default_rng([int(seed) % (2 ** 63), 7]).permutation(n)
