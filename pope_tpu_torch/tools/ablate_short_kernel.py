#!/usr/bin/env python3
"""Where the short attention kernel's time goes, on one NVIDIA GPU.

    python3 pope_tpu_torch/tools/ablate_short_kernel.py [--rounds 2]

Builds csrc/attention_short.cu as it ships and a few variants of it, each a
copy with one text edit that removes or replaces one step, all with nvcc in
parallel into build/ablate/, and times each at the main path's two short
shapes: SAM ViT-H's windowed layers (80 windows x 16 heads, N = 196, d = 80,
with the rel-pos bias) and DINOv2 ViT-S/14's retrieval forward (260 crops x
6 heads, N = 197, d = 64). Variants that skip work give wrong outputs: they
are timings, not kernels. Each round times every variant once, in order;
CUDA-event means over `--reps` launches. Prints the card, ptxas's spills
per variant, and one JSON line per round and variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "pope_tpu_torch" / "csrc" / "attention_short.cu"
OUT = ROOT / "build" / "ablate"

NO_TILES = ("      for (int tq0 = wg; tq0 < ntq; tq0 += 2) {", "      for (int tq0 = wg; tq0 < 0; tq0 += 2) {")
NO_STORES = ("        for (int e = tw; e < 64 * DB; e += 128) {", "        for (int e = tw; e < 0; e += 128) {")
# the producer loads each block's first heads (one per stage) and then only
# signals, so the consumers recompute data already in shared memory
LOADS_ONCE = [
    ("        uint32_t tx = rel_off;\n", "        uint32_t tx = i < a.stages ? rel_off : 0u;\n"),
    ("            tx += rh_bytes + rw_bytes;\n", "            if (i < a.stages) tx += rh_bytes + rw_bytes;\n"),
    ("              bulk_load(st + rel_off, rh, rh_bytes, full(s));\n",
     "              if (i < a.stages) bulk_load(st + rel_off, rh, rh_bytes, full(s));\n"),
    ("              bulk_load(st + rel_off + rh_alloc, rw, rw_bytes, full(s));\n",
     "              if (i < a.stages) bulk_load(st + rel_off + rh_alloc, rw, rw_bytes, full(s));\n"),
    ("        if (lane == 0) {\n#pragma unroll\n          for (int j = 0; j < DK; ++j) {",
     "        if (lane == 0 && i < a.stages) {\n#pragma unroll\n          for (int j = 0; j < DK; ++j) {"),
]
VARIANTS = {
    "shipped": [],
    "loads_only": [NO_TILES],
    "compute_only": LOADS_ONCE,
    "compute_only_no_stores": LOADS_ONCE + [NO_STORES],
    "one_k_step_of_S": [("          for (int ks = 0; ks < DK; ++ks)\n            wgmma_s<SW>",
                         "          for (int ks = 0; ks < 1; ++ks)\n            wgmma_s<SW>")],
    "one_k_step_of_PV": [("          for (int j = 0; j < K::pv_steps; ++j)\n            wgmma_rs<D>",
                          "          for (int j = 0; j < 1; ++j)\n            wgmma_rs<D>")],
    "no_exp": [(f"            e[{i}] = __expf(e[{i}] - mx{i // 2});", f"            e[{i}] = e[{i}] - mx{i // 2};")
               for i in range(4)],
    "stores_from_accumulators": [(
        "        for (int e = tw; e < 64 * DB; e += 128) {",
        "#pragma unroll\n"
        "        for (int nb = 0; nb < DB; ++nb) {\n"
        "          __nv_bfloat16* o = a.out + ((int64_t)b * N + r0) * C + (int64_t)h * D + 8 * nb + 2 * t;\n"
        "          if (r0 < N) *reinterpret_cast<uint32_t*>(o) = pack_bf16(oacc[4 * nb] * inv0, oacc[4 * nb + 1] * inv0);\n"
        "          if (r1 < N) *reinterpret_cast<uint32_t*>(o + 8 * C) =\n"
        "              pack_bf16(oacc[4 * nb + 2] * inv1, oacc[4 * nb + 3] * inv1);\n"
        "        }\n"
        "        for (int e = tw; e < 0; e += 128) {"),
    ],
    "bias_fragments_from_device_memory": [
        ("          const unsigned short* rh = reinterpret_cast<const unsigned short*>(qg + rel_off);\n"
         "          const unsigned short* rw = reinterpret_cast<const unsigned short*>(qg + rel_off + rh_alloc);\n",
         "          const unsigned short* rh = reinterpret_cast<const unsigned short*>(a.rel_h) + (int64_t)bh * N * a.hk;\n"
         "          const unsigned short* rw = reinterpret_cast<const unsigned short*>(a.rel_w) + (int64_t)bh * N * a.wk;\n"),
    ],
    "one_producer_warp": [
        ("constexpr int SHORT_NT = 384;", "constexpr int SHORT_NT = 288;"),
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(PRODUCER_REGS));\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(CONSUMER_REGS));\n', ""),
    ],
}


def build_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the edit's text is not in {SOURCE.name}: {old[:70]!r}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(json.dumps({"variant": name, "spill_stores_per_function": spills}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pope_attention_short_relpos.argtypes = [ptr] * 6 + [i64] * 9 + [i32] * 6 + [ctypes.c_float, ptr]
        lib.pope_attention_short.argtypes = [ptr] * 4 + [i64] * 9 + [i32] * 4 + [ctypes.c_float, ptr]
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_short_kernel.py runs on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs = build_all()

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, stream = torch.bfloat16, torch.cuda.current_stream().cuda_stream
    # kernel 1: windowed layers, the qkv Dense output viewed as q, k, v
    qkv1 = torch.randn(80, 196, 3, 16, 80, device="cuda", generator=g).to(bf16)
    rel_h = (0.5 * torch.randn(80, 16, 196, 14, device="cuda", generator=g)).to(bf16)
    rel_w = (0.5 * torch.randn(80, 16, 196, 14, device="cuda", generator=g)).to(bf16)
    out1 = torch.empty(80, 196, 16 * 80, device="cuda", dtype=bf16)
    # kernel 3: DINOv2's blocks
    qkv3 = torch.randn(260, 197, 3, 6, 64, device="cuda", generator=g).to(bf16)
    out3 = torch.empty(260, 197, 6 * 64, device="cuda", dtype=bf16)

    def views(qkv):
        q, k, v = qkv.unbind(2)
        return [t.data_ptr() for t in (q, k, v)], [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]

    (p1, s1), (p3, s3) = views(qkv1), views(qkv3)

    def kernel1(lib):
        err = lib.pope_attention_short_relpos(*p1, rel_h.data_ptr(), rel_w.data_ptr(), out1.data_ptr(), *s1,
                                              80, 196, 16, 80, 14, 14, 80 ** -0.5, stream)
        assert err == 0, err

    def kernel3(lib):
        err = lib.pope_attention_short(*p3, out3.data_ptr(), *s3, 260, 197, 6, 64, 64 ** -0.5, stream)
        assert err == 0, err

    for rnd in range(args.rounds):
        for name, lib in libs.items():
            row = {"round": rnd, "variant": name, "kernel1_ms": cuda_ms(lambda: kernel1(lib), args.reps),
                   "kernel3_ms": cuda_ms(lambda: kernel3(lib), args.reps), "card": smi}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
