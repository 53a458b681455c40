"""Frame reading and writing for the eval driver and the bench dataset, with
OpenCV as the JAX package uses it: the runner decodes with `cv2.imread` +
`cvtColor(BGR2RGB)` (pope_tpu/pipeline/runner.py::_load_pair_host) and
`bench.py::make_dataset` writes with `cv2.imwrite`. cv2 is imported on first
use, so the port imports without it."""

from __future__ import annotations

import numpy as np


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB frame (gray replicated, alpha dropped)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def write_rgb(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB frame (PNG for a .png path)."""
    import cv2

    if not cv2.imwrite(path, cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2BGR)):
        raise OSError(f"cannot write image {path}")


def reader() -> str:
    """The decoder read_rgb uses, with its version."""
    import cv2

    return f"cv2 {cv2.__version__}"
