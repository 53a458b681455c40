"""Build, load and launch the port's hand-written CUDA kernels.

The sources under `pope_tpu_torch/csrc/` have a plain C interface. On first
use `nvcc` compiles them for Hopper (`sm_90a`), one process per source, all
in parallel, and links them into one shared library under `build/kernels/`
at the root of the checkout, named by a hash of the sources and their
headers so that an edit rebuilds it; `ctypes` loads it. Nothing here runs at
import time: the CPU test suite imports every module and has no `nvcc`.

Four attention designs, picked by shape (`attention_design`):
- "short" (csrc/attention_short.cu): a whole head in shared memory; bf16,
  N <= 256, d in _BF16_HEAD_DIMS, bias grids of hk + wk <= 32;
- "long" (csrc/attention_long.cu): streams 128-key tiles past 128-query
  items, a TMA producer warp and two wgmma consumer warpgroups, each of
  which runs one tile's softmax while its own next products run; clusters
  of two blocks take two items of a head and share each K/V tile (TMA
  multicast); the other bf16 shapes of those head dims, bias grids of
  hk + wk <= 500 (those of 32 < wk <= 64, SAM's global grids, on tiles of
  two whole key rows, each padded to a multiple of 8 slots; the others
  gathered per logit);
- "tf32x3" (csrc/attention_f32.cu): float32 on the tensor cores, each
  product as three TF32 wgmma products of operands split into a rounded
  big and small part; d <= 128, bias grids of hk + wk <= F32_MAX_GRID;
- "stream" (csrc/attention_relpos.cu): the rest (f32 past those limits,
  bf16 head dims without a tensor-core instantiation).

The two bf16 Hopper kernels are persistent: one block an SM ("short") or
the clusters the card holds at once ("long") walk their items (heads; units
of a head's two 128-query tiles) in waves. One rule fills the last wave
(`tail_plan`): whole items for the full waves, and where the last, partial
wave's r items leave the card idle, each runs as s pieces, s = min(the
most pieces an item takes, resident div r), if s >= 2: the long kernel's
over runs of key tiles, merged in the same launch; the short kernel's over
runs of query tiles. `long_plan` and `short_plan` compute it from the shape
and the card's resident count; the wrappers pass it to the C entries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("attention_relpos.cu", "attention_short.cu", "attention_long.cu", "attention_f32.cu")
_HEADERS = ("hopper.cuh",)  # included by the sources: part of the library's hash
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
# the tensor-core bodies' instantiations (launch_bf16, launch_short, launch_long_bias)
_BF16_HEAD_DIMS = (32, 64, 80)
SHORT_MAX_N = 256  # attention_short.cu: a whole head in shared memory, one TMA box of rows
SHORT_MAX_GRID = 32  # and a bias grid of hk + wk <= 32: two k-steps of its bias product
# attention_long.cu: an item's rel rows (128 x (hk + wk) bf16) and one Q stage
# beside two K/V stages fit in shared memory at d = 80 (its launcher refuses
# 501, which tests/test_torch_cuda.py holds it to)
LONG_MAX_GRID = 500
# attention_f32.cu: the query tile's rel rows (64 x (hk + wk) f32) beside the
# split query, K and V tiles fit in shared memory at every padded head dim
# (its MAX_GRID, checked against its tile plan at compile time; its launcher
# refuses 475, which tests/test_torch_cuda.py holds it to)
F32_MAX_GRID = 474
LONG_TQ, LONG_TK = 128, 128  # attention_long.cu: query rows an item, keys a K/V tile
LONG_CLUSTER = 2  # its blocks a cluster (the items of a unit)
LONG_ROW_SLOTS = 64  # its K/V tiles of two whole key rows for 32 < wk <= LONG_ROW_SLOTS (bias_layout)
LONG_MAX_PIECES = 8  # the most key chunks a unit of its last wave is split into
SHORT_TQ = 64  # attention_short.cu: query rows a tile
# query tiles a piece of its last wave takes at most: one (pieces of two, one
# per consumer warpgroup, read 2.4% slower at the square frame's 4 heads in
# turns: a warpgroup alone on its SM runs its tile faster)
SHORT_PIECE_TILES = 1
DESIGNS = ("short", "long", "tf32x3", "stream")  # attention_design's order of preference
_ENTRIES = {"short": "pope_attention_short", "long": "pope_attention_long", "tf32x3": "pope_attention_f32",
            "stream": "pope_attention"}

_lib = None  # the loaded library, once built
_resident = {}  # (device, d, hk, wk) -> the long kernel's resident clusters
_counters = {}  # (device, stream) -> the long kernel's arrival counters, 0 between launches


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from source on first use")


def build() -> tuple[Path, str | None]:
    """Compile the kernels if the library for these sources is not built yet.
    Return its path and the compiler's output (ptxas's registers, shared
    memory and spills per kernel), or None when the library was already
    built."""
    srcs = [_CSRC / s for s in _SOURCES]
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in srcs + [_CSRC / h for h in _HEADERS])
    ).hexdigest()[:16]
    out = _BUILD_DIR / f"libpope_kernels_{digest}.so"
    if out.exists():
        return out, None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / f"{src.stem}.o" for src in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = Path(tmp_dir) / out.name
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out, "".join(logs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pope_attention_relpos.argtypes = [ptr] * 6 + [i64] * 9 + [i32] * 6 + [ctypes.c_float, i32, ptr]
        lib.pope_attention_relpos.restype = i32
        lib.pope_attention.argtypes = [ptr] * 4 + [i64] * 9 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        lib.pope_attention.restype = i32
        relpos = [ptr] * 6 + [i64] * 9 + [i32] * 6 + [ctypes.c_float]
        plain = [ptr] * 4 + [i64] * 9 + [i32] * 4 + [ctypes.c_float]
        # the short and long entries take the last wave's plan (split0,
        # pieces), the long ones its workspace and counters too
        for name, args in (("short_relpos", relpos + [i32] * 2), ("short", plain + [i32] * 2),
                           ("long_relpos", relpos + [i32] * 2 + [ptr] * 2), ("long", plain + [i32] * 2 + [ptr] * 2),
                           ("f32_relpos", relpos), ("f32", plain)):
            fn = getattr(lib, f"pope_attention_{name}")
            fn.argtypes = args + [ptr]
            fn.restype = i32
        lib.pope_attention_long_layout.argtypes = [i32] * 3 + [ctypes.POINTER(ctypes.c_int)] * 7
        lib.pope_attention_long_layout.restype = i32
        lib.pope_cuda_error_string.argtypes = [i32]
        lib.pope_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def long_layout(d: int, hk: int = 0, wk: int = 0) -> dict:
    """The layout csrc/attention_long.cu's launcher picks at head dim d on an
    hk x wk bias grid (0 x 0: no bias): the bias's ("rows": K/V tiles of two
    whole key rows, for 32 < wk <= 64; "gather": per logit; None), the slots
    a key row takes in a tile with "rows" (wk padded to a multiple of 8;
    else 0), its Q stages, K/V stages, dynamic shared memory
    in bytes, blocks per cluster (the blocks that share each K/V tile by TMA
    multicast) and the clusters the card holds at once (the persistent grid,
    in clusters, on this device)."""
    lib = library()
    out = [ctypes.c_int() for _ in range(7)]
    err = lib.pope_attention_long_layout(d, hk, wk, *map(ctypes.byref, out))
    _raise_on(err, "pope_attention_long_layout", lib)
    bias, *rest = (o.value for o in out)
    return {"bias": (None, "gather", "rows")[bias]} | dict(
        zip(("row_slots", "q_stages", "kv_stages", "smem_bytes", "cluster", "resident_clusters"), rest))


def _check_qkv(q, k, v, others=()):
    """The operand checks both entries share: one CUDA device and dtype, one
    shape, unit last stride, a head dim the bodies take. Returns q's shape."""
    B, N, nh, d = q.shape
    tensors = (q, k, v, *others)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("attention kernel: all operands must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"attention kernel takes float32 or bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a unit last stride")
    if d > 128:
        raise ValueError(f"head dim {d} > 128")
    misaligned = any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and (d not in _BF16_HEAD_DIMS or misaligned):
        raise ValueError(f"bfloat16 attention kernel: head dim must be one of {_BF16_HEAD_DIMS} "
                         "and q/k/v rows must start on 16 bytes")
    return B, N, nh, d


def _raise_on(err: int, entry: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed: {lib.pope_cuda_error_string(err).decode()}")


def _takes(design: str, dtype, N: int, d: int, hk: int, wk: int) -> bool:
    """Whether the kernel of `design` takes a shape (hk = wk = 0: no bias)."""
    tensor_cores = dtype == torch.bfloat16 and d in _BF16_HEAD_DIMS
    if design == "short":
        return tensor_cores and N <= SHORT_MAX_N and hk + wk <= SHORT_MAX_GRID
    if design == "long":
        return tensor_cores and hk + wk <= LONG_MAX_GRID
    if design == "tf32x3":
        return dtype == torch.float32 and d <= 128 and hk + wk <= F32_MAX_GRID
    return True


def attention_design(dtype, N: int, d: int, hk: int = 0, wk: int = 0) -> str:
    """The kernel that takes a shape: "short" (csrc/attention_short.cu: a
    whole head in shared memory; bf16, N <= SHORT_MAX_N, d in
    _BF16_HEAD_DIMS and, with a bias, hk + wk <= SHORT_MAX_GRID), "long"
    (csrc/attention_long.cu: the other bf16 shapes of those head dims, bias
    grids of hk + wk <= LONG_MAX_GRID), "tf32x3" (csrc/attention_f32.cu:
    float32 on the tensor cores in 3xTF32, d <= 128, bias grids of hk + wk
    <= F32_MAX_GRID) or "stream" (csrc/attention_relpos.cu: the rest). The
    shape alone decides; a kernel that fails raises."""
    return next(dn for dn in DESIGNS if _takes(dn, dtype, N, d, hk, wk))


def _resolve_design(design, dtype, N: int, d: int, hk: int = 0, wk: int = 0) -> str:
    """`design`, or attention_design's choice when it is None; a design only
    for a shape its kernel takes."""
    design = design or attention_design(dtype, N, d, hk, wk)
    if design not in DESIGNS:
        raise ValueError(f"unknown attention design {design!r}")
    if not _takes(design, dtype, N, d, hk, wk):
        raise ValueError(f"the {design} kernel does not take {dtype} N={N} d={d} on a {hk}x{wk} grid")
    return design


def _views(q, k, v):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr()), (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def launch_attention_relpos(q, k, v, rel_h, rel_w, hk: int, wk: int, design: str | None = None):
    """Run the rel-pos attention kernel for the windowed and the global
    layers: `design` (by default attention_design's choice for the shape)
    "short" is csrc/attention_short.cu, "long" csrc/attention_long.cu,
    "tf32x3" csrc/attention_f32.cu, "stream" csrc/attention_relpos.cu.

    q, k, v: (B, N, nh, d) CUDA views with a unit last stride (slices of the
    qkv Dense output are fine); rel_h (B, nh, N, hk) and rel_w (B, nh, N, wk)
    contiguous, all of one dtype (float32 or bfloat16). In bfloat16 the
    tensor-core bodies also need d in _BF16_HEAD_DIMS and q/k/v rows that
    start on 16 bytes (the float32 tf32x3 body reads other views 4 bytes at
    a time). Returns a new contiguous (B, N, nh * d) tensor."""
    return launch_with_plan(None, q, k, v, rel_h, rel_w, hk, wk, design)


def launch_attention(q, k, v, design: str | None = None):
    """Run the bias-free kernel, softmax(q k^T d^-1/2) v, on the same
    (B, N, nh, d) views and types as launch_attention_relpos, through
    `design` (by default attention_design's choice). Returns a new
    contiguous (B, N, nh * d) tensor."""
    return launch_with_plan(None, q, k, v, design=design)


def launch_with_plan(plan, q, k, v, rel_h=None, rel_w=None, hk: int = 0, wk: int = 0, design: str | None = None):
    """launch_attention_relpos (rel_h and rel_w given) or launch_attention,
    the short or long kernel's last wave run by `plan`: (split0, s) as
    tail_plan gives it (s = 1: nothing split), or None for the rule's plan
    at this shape (long_plan, short_plan). The other designs take None
    only. Tests and tools force plans through it."""
    bias = rel_h is not None
    B, N, nh, d = _check_qkv(q, k, v, (rel_h, rel_w) if bias else ())
    if bias:
        if N != hk * wk or rel_h.shape != (B, nh, N, hk) or rel_w.shape != (B, nh, N, wk):
            raise ValueError(f"rel tables {tuple(rel_h.shape)} {tuple(rel_w.shape)} do not fit "
                             f"q {tuple(q.shape)} on a {hk}x{wk} key grid")
        if not (rel_h.is_contiguous() and rel_w.is_contiguous()):
            raise ValueError("rel tables must be contiguous")
    else:
        hk = wk = 0
    design = _resolve_design(design, q.dtype, N, d, hk, wk)
    if plan is not None and design not in ("short", "long"):
        raise ValueError(f"the {design} kernel takes no plan")
    out = torch.empty((B, N, nh * d), dtype=q.dtype, device=q.device)
    lib = library()
    ptrs, strides = _views(q, k, v)
    entry = _ENTRIES[design] + ("_relpos" if bias else "")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (*ptrs, *((rel_h.data_ptr(), rel_w.data_ptr()) if bias else ()), out.data_ptr(), *strides,
                B, N, nh, d, *((hk, wk) if bias else ()), float(d ** -0.5))
        if design == "stream":
            args += (int(q.dtype == torch.bfloat16),)
        elif design == "short":
            args += plan or _plan_of(short_plan(B, N, nh, device=q.device))
        elif design == "long":
            split0, s = plan or _plan_of(long_plan(B, N, nh, d, hk, wk, device=q.device))
            scratch = _long_scratch(q.device, stream, long_units(B, N, nh) - split0 if s > 1 else 0, s, d)
            args += (split0, s, *(t.data_ptr() if t is not None else None for t in scratch))
        err = getattr(lib, entry)(*args, stream)
    _raise_on(err, entry, lib)
    return out


def tail_plan(units: int, resident: int, pieces_max: int) -> tuple[int, int]:
    """The last wave of a persistent kernel that holds `resident` items at
    once, over `units` items: (split0, s). The first W * resident items run
    whole (W = units div resident); if the r = units mod resident left over
    give s = min(pieces_max, resident div r) >= 2, the items from split0 =
    W * resident on run as s pieces each; else none is split (units, 1)."""
    full, r = divmod(units, resident)
    s = min(pieces_max, resident // r) if r else 1
    return (full * resident, s) if s >= 2 else (units, 1)


def long_units(B: int, N: int, nh: int) -> int:
    """The long kernel's units: (head, pair of 128-query items)."""
    return B * nh * -(-(-(-N // LONG_TQ)) // LONG_CLUSTER)


def long_key_tiles(N: int, hk: int = 0, wk: int = 0) -> int:
    """The long kernel's K/V tiles a unit walks: two whole key rows each on
    a bias grid of LONG_ROW_SLOTS / 2 < wk <= LONG_ROW_SLOTS (its "rows"
    layout), else 128 keys each."""
    if hk and LONG_ROW_SLOTS // 2 < wk <= LONG_ROW_SLOTS:
        return (hk + 1) // 2
    return -(-N // LONG_TK)


def long_plan(B: int, N: int, nh: int, d: int, hk: int = 0, wk: int = 0, resident: int | None = None,
              device=None) -> dict:
    """The long kernel's last wave at a shape (hk = wk = 0: no bias): its
    units, the clusters the card holds at once (`resident`, by default
    long_layout's on `device`), its K/V tiles, and tail_plan's split0 and s
    with at most min(key tiles, LONG_MAX_PIECES) key chunks a unit."""
    tiles = long_key_tiles(N, hk, wk)
    if resident is None:
        dev = torch.device(device if device is not None else "cuda")
        dev = dev.index if dev.index is not None else torch.cuda.current_device()
        key = (dev, d, hk, wk)
        if key not in _resident:
            with torch.cuda.device(dev):
                _resident[key] = long_layout(d, hk, wk)["resident_clusters"]
        resident = _resident[key]
    units = long_units(B, N, nh)
    split0, s = tail_plan(units, resident, min(tiles, LONG_MAX_PIECES))
    return {"units": units, "resident": resident, "key_tiles": tiles, "split0": split0, "s": s}


def short_plan(B: int, N: int, nh: int, resident: int | None = None, device=None) -> dict:
    """The short kernel's last wave at a shape: its heads (units), the SMs
    (`resident`, by default those of `device`), its 64-query tiles, and
    tail_plan's split0 and s with pieces of SHORT_PIECE_TILES tiles."""
    tiles = -(-N // SHORT_TQ)
    if resident is None:
        resident = torch.cuda.get_device_properties(device if device is not None else "cuda").multi_processor_count
    split0, s = tail_plan(B * nh, resident, -(-tiles // SHORT_PIECE_TILES))
    return {"units": B * nh, "resident": resident, "query_tiles": tiles, "split0": split0, "s": s}


def _plan_of(plan: dict) -> tuple[int, int]:
    return plan["split0"], plan["s"]


def _long_scratch(device, stream: int, tail_units: int, s: int, d: int) -> tuple:
    """The long kernel's workspace and arrival counters for `tail_units`
    split units of s key chunks (None, None when nothing is split): each
    chunk's partials, (d/2 + 4) floats a consumer thread of each block of
    the cluster, in a new tensor on the current stream (the caller holds it
    until the launch is queued); the counters (one per tail unit, block and
    consumer warp), zeros kept per device and stream, which every launch
    leaves at 0."""
    if tail_units == 0:
        return None, None
    work = torch.empty(tail_units * s * LONG_CLUSTER * 256 * (d // 2 + 4), dtype=torch.float32, device=device)
    key, need = (work.device.index, stream), tail_units * LONG_CLUSTER * 8
    if key not in _counters or _counters[key].numel() < need:
        _counters[key] = torch.zeros(max(need, 4096), dtype=torch.int32, device=device)
    return work, _counters[key]
