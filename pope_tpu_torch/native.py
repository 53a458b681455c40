"""ctypes binding of the host library `native/pope_native.cpp` (port of
pope_tpu/native.py): the column-major RLE codec, 8-connected components,
small-region removal and greedy NMS that the records path runs on the host.

The unchanged C++ source is compiled on first use with the flags of
`native/Makefile` (`g++ -O3 -march=native -fPIC -shared -std=c++17`) into
`build/native/` at the root of the checkout, named by a hash of the source
and the flags, and loaded with ctypes. Concurrent first uses (test workers,
threads) build to a temporary file and `os.replace` it into place. There is no numpy
fallback: when the compiler is missing or the build fails, the first call
raises. ctypes releases the GIL while the C++ runs, so threads overlap.

`remove_small_regions_plain` is the BFS version of `remove_small_regions`
that the tests hold the library against; no path of the port calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import deque
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SOURCE = _ROOT / "native" / "pope_native.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the port's host library is built from "
                           f"{_SOURCE.name} on first use")
    return path


def build() -> Path:
    """Compile native/pope_native.cpp unless the library for this source is
    built already; return the library's path."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libpope_native_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _compiler()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir) / out.name
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {_SOURCE.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The host library, built on first call; raises when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, i32, f32, ptr = ctypes.c_int64, ctypes.c_int32, ctypes.c_float, ctypes.c_void_p
            lib.rle_encode.argtypes = [ptr, i64, i64, ptr]
            lib.rle_encode.restype = i64
            lib.rle_decode.argtypes = [ptr, i64, i64, i64, ptr]
            lib.rle_decode.restype = None
            lib.connected_components.argtypes = [ptr, i64, i64, ctypes.c_uint8, ptr, ptr]
            lib.connected_components.restype = i64
            lib.remove_small_regions.argtypes = [ptr, i64, i64, i64, i32]
            lib.remove_small_regions.restype = i32
            lib.nms_cpu.argtypes = [ptr, ptr, i64, f32, ptr]
            lib.nms_cpu.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _mask_u8(mask) -> np.ndarray:
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got shape {m.shape}")
    return m


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def rle_encode(mask) -> dict:
    """Binary (H, W) mask -> uncompressed column-major RLE
    {"size": [h, w], "counts": [...]}, runs alternating from a run of zeros."""
    m = _mask_u8(mask)
    h, w = m.shape
    counts = np.empty(h * w + 1, np.int64)
    n = library().rle_encode(_ptr(m), h, w, _ptr(counts))
    return {"size": [h, w], "counts": counts[:n].tolist()}


def rle_decode(rle: dict) -> np.ndarray:
    """Inverse of rle_encode: (H, W) bool."""
    h, w = (int(v) for v in rle["size"])
    counts = np.ascontiguousarray(rle["counts"], np.int64)
    if counts.ndim != 1 or (counts < 0).any() or counts.sum() != h * w:
        raise ValueError(f"RLE counts do not cover an {h}x{w} mask")
    out = np.empty((h, w), np.uint8)
    library().rle_decode(_ptr(counts), len(counts), h, w, _ptr(out))
    return out.astype(bool)


def connected_components(mask, value: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """8-connected components of the pixels equal to `value` (0 or 1):
    ((H, W) int32 labels, 0..n-1 in raster order of first pixel and -1
    elsewhere, (n,) int64 areas)."""
    m = _mask_u8(mask)
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    areas = np.empty(h * w, np.int64)
    n = library().connected_components(_ptr(m), h, w, 1 if value else 0, _ptr(labels), _ptr(areas))
    return labels, areas[:n].copy()


def remove_small_regions(mask, area_thresh: int, mode: str) -> Tuple[np.ndarray, bool]:
    """Fill holes (mode "holes") or drop islands (mode "islands") smaller than
    area_thresh; in islands mode, when every island is small, the largest
    stays. Returns ((H, W) bool, changed), changed whenever a small region
    existed (segment_anything's remove_small_regions semantics)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"unknown mode {mode!r}")
    m = _mask_u8(mask).copy()
    h, w = m.shape
    changed = library().remove_small_regions(_ptr(m), h, w, int(area_thresh), 0 if mode == "holes" else 1)
    return m.astype(bool), bool(changed)


def nms_cpu(boxes, scores, iou_threshold: float) -> np.ndarray:
    """Greedy NMS over (N, 4) XYXY boxes in descending score order: (N,) bool
    keep flags."""
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    if b.ndim != 2 or b.shape[1] != 4 or s.shape != (len(b),):
        raise ValueError(f"boxes {b.shape} and scores {s.shape} do not pair up")
    keep = np.empty(len(b), np.uint8)
    library().nms_cpu(_ptr(b), _ptr(s), len(b), ctypes.c_float(iou_threshold), _ptr(keep))
    return keep.astype(bool)


def remove_small_regions_plain(mask, area_thresh: int, mode: str) -> Tuple[np.ndarray, bool]:
    """remove_small_regions by breadth-first labelling in Python: the plain
    version the tests hold the library against (slow)."""
    m = np.asarray(mask, bool).copy()
    h, w = m.shape
    target = mode == "islands"
    seen = np.zeros((h, w), bool)
    comps = []
    for sy in range(h):
        for sx in range(w):
            if seen[sy, sx] or m[sy, sx] != target:
                continue
            comp, queue = [], deque([(sy, sx)])
            seen[sy, sx] = True
            while queue:
                y, x = queue.popleft()
                comp.append((y, x))
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        ny, nx = y + dy, x + dx
                        if 0 <= ny < h and 0 <= nx < w and not seen[ny, nx] and m[ny, nx] == target:
                            seen[ny, nx] = True
                            queue.append((ny, nx))
            comps.append(comp)
    small = [c for c in comps if len(c) < area_thresh]
    if not small:
        return m, False
    # all islands small: the largest (the first of equal areas) stays
    keep = max(comps, key=len) if target and len(small) == len(comps) else None
    for comp in small:
        if comp is not keep:
            for y, x in comp:
                m[y, x] = not target
    return m, True
