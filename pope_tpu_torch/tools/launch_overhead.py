#!/usr/bin/env python3
"""How much of a short kernel's timed call is the host's, on one NVIDIA GPU.

    python3 pope_tpu_torch/tools/launch_overhead.py [--reps 20] [--rounds 2]

Times kernels 1 and 3 at the main path's shapes (SAM ViT-H's windowed layers:
80 windows x 16 heads, N = 196, d = 80, with the rel-pos bias; DINOv2
ViT-S/14's retrieval forward: 260 crops x 6 heads, N = 197, d = 64) four
ways, each the mean over `--reps` back-to-back calls:
- wrapper_ms: CUDA events around calls of the port's wrapper
  (`windowed_attention_relpos`, `flash_attention`), as chip_smoke.py's
  kernel phase times them;
- direct_ms: CUDA events around calls of the library's C entry with a
  preallocated output, so that little host work lies between two kernels;
- host_ms: the host's wall time to issue the wrapper calls, the card idle
  at the start and the launch queue far from full, so no call waits for it;
- queued_ms: the wrapper again, the card held for about 10 ms before the
  start event (as chip_smoke.py's cuda_ms does), so that every call is
  issued before the first runs.
When host_ms reaches direct_ms, back-to-back wrapper calls leave the card
waiting, and wrapper_ms is the host's pace, not the kernel's; queued_ms is
the card's. It also prints the size of each short-kernel instantiation's
SASS (cuobjdump), to compare the code of two builds.

It imports `pope_tpu_torch` from wherever Python finds it first, so another
checkout is timed with `PYTHONPATH=<checkout> python3 <this file>`; its
kernels are built under that checkout. Prints the card, the package's path
and one JSON line per round and kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch


HOST_LEAD_CYCLES = 20_000_000  # queued_ms: the card sleeps this long before its start event


def cuda_ms(fn, reps: int, lead: int = 0) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(lead)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def sass_sizes(lib) -> dict:
    """Instructions in each short-kernel instantiation's SASS."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    sizes, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(attn_short_kernelI\w+?E)E", line)
            func = m.group(1) if m else None
        elif func and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            sizes[func] = sizes.get(func, 0) + 1
    return sizes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_overhead.py runs on a CUDA card")
    from pope_tpu_torch.ops import cuda_kernels
    from pope_tpu_torch.ops.flash_attention import flash_attention
    from pope_tpu_torch.ops.window_attention import windowed_attention_relpos

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lib_path, _ = cuda_kernels.build()
    lib = cuda_kernels.library()
    print(json.dumps({"card": smi, "package": cuda_kernels.__file__, "library": lib_path.name,
                      "sass_instructions": sass_sizes(lib_path)}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, stream = torch.bfloat16, torch.cuda.current_stream().cuda_stream

    # kernel 1: the windowed layers' qkv Dense output, viewed as q, k, v by the wrapper
    BW, N1, nh1, d1, ws = 80, 196, 16, 80, 14
    qkv1 = torch.randn(BW, N1, 3 * nh1 * d1, device="cuda", generator=g).to(bf16)
    rel_h = (0.5 * torch.randn(BW, nh1, N1, ws, device="cuda", generator=g)).to(bf16)
    rel_w = (0.5 * torch.randn(BW, nh1, N1, ws, device="cuda", generator=g)).to(bf16)
    out1 = torch.empty(BW, N1, nh1 * d1, device="cuda", dtype=bf16)
    q1, k1, v1 = qkv1.view(BW, N1, 3, nh1, d1).unbind(2)
    # kernel 3: DINOv2's blocks
    B3, N3, nh3, d3 = 260, 197, 6, 64
    qkv3 = torch.randn(B3, N3, 3, nh3, d3, device="cuda", generator=g).to(bf16)
    out3 = torch.empty(B3, N3, nh3 * d3, device="cuda", dtype=bf16)
    q3, k3, v3 = qkv3.unbind(2)

    # the direct calls pass the plan the wrappers pick at these shapes (full
    # last waves: nothing split, cuda_kernels.short_plan)
    def strides(q, k, v):
        return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])

    def direct1():
        err = lib.pope_attention_short_relpos(
            q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out1.data_ptr(),
            *strides(q1, k1, v1), BW, N1, nh1, d1, ws, ws, d1 ** -0.5, BW * nh1, 1, stream)
        assert err == 0, err

    def direct3():
        err = lib.pope_attention_short(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out3.data_ptr(),
                                       *strides(q3, k3, v3), B3, N3, nh3, d3, d3 ** -0.5, B3 * nh3, 1, stream)
        assert err == 0, err

    calls = {
        "kernel1": (lambda: windowed_attention_relpos(qkv1, rel_h, rel_w, nh1, d1, ws, ws), direct1),
        "kernel3": (lambda: flash_attention(q3, k3, v3), direct3),
    }
    for rnd in range(args.rounds):
        for name, (wrapper, direct) in calls.items():
            row = {"round": rnd, "kernel": name, "wrapper_ms": cuda_ms(wrapper, args.reps),
                   "direct_ms": cuda_ms(direct, args.reps), "host_ms": host_ms(wrapper, args.reps),
                   "queued_ms": cuda_ms(wrapper, args.reps, HOST_LEAD_CYCLES)}
            print(json.dumps({**row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
