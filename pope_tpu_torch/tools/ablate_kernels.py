#!/usr/bin/env python3
"""Where the attention kernels' time goes, on one NVIDIA GPU.

    python3 pope_tpu_torch/tools/ablate_kernels.py [--kernel short|long|all] [--rounds 2]

Builds csrc/attention_short.cu and csrc/attention_long.cu as they ship and a
few variants of each, every one a copy with text edits that remove or
replace one step, all with nvcc in parallel into build/ablate/, and times
each at the main path's shapes: the short kernel at SAM ViT-H's windowed
layers (80 windows x 16 heads, N = 196, d = 80, with the rel-pos bias) and
DINOv2 ViT-S/14's retrieval forward (260 crops x 6 heads, N = 197, d = 64);
the long kernel at SAM ViT-H's global layers (4 frames x 16 heads, 48 x 64
tokens, d = 80) with the bias and, on the same q/k/v, without it. Variants
that skip work give wrong outputs: they are timings, not kernels. Each
round times every variant once, in order; CUDA-event means over `--reps`
launches. Prints the card, ptxas's spills per variant, and one JSON line
per round and variant. An edit whose text is no longer in its source stops
the script.
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
CSRC = ROOT / "pope_tpu_torch" / "csrc"
SOURCES = {"short": CSRC / "attention_short.cu", "long": CSRC / "attention_long.cu"}
OUT = ROOT / "build" / "ablate"

# ---- the short kernel (kernels 1 and 3)
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
SHORT_VARIANTS = {
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


# ---- the long kernel (kernel 2)
NO_S = ("          wgmma_ss_n128(sacc, desc_b32(Qs + ks * slab, 16), desc_b32(Ks + ks * slab, 16), ks > 0);",
        "          ;")
NO_PV = ("        for (int j = 0; j < 8; ++j) wgmma_rs<D>(oacc, pf[j], desc_b32(Vs + j * 16 * SLAB_ROW, slab), 1);",
         "")
NO_SOFTMAX = [
    ("      softmax_tile<BIAS>(sacc, m, l, corr, rh0, rh1, rw0, rw1, 0, N, a.hk, a.wk, t, c);", ""),
    ("        softmax_tile<BIAS>(sacc, m, l, corr, rh0, rh1, rw0, rw1, kt * TK, N, a.hk, a.wk, t, c);", ""),
]
# the producer loads each block's first items and tiles (one per stage) and
# then only signals, so the consumers recompute data already in shared memory
LONG_LOADS_ONCE = [
    ("      uint32_t tx = rel_off;\n", "      uint32_t tx = it < a.q_stages ? rel_off : 0u;\n"),
    ("          tx += rh_bytes + rw_bytes;\n", "          if (it < a.q_stages) tx += rh_bytes + rw_bytes;\n"),
    ("            bulk_load(st + rel_off, rh, rh_bytes, q_full(qs));\n",
     "            if (it < a.q_stages) bulk_load(st + rel_off, rh, rh_bytes, q_full(qs));\n"),
    ("            bulk_load(st + rel_off + a.rh_alloc, rw, rw_bytes, q_full(qs));\n",
     "            if (it < a.q_stages) bulk_load(st + rel_off + a.rh_alloc, rw, rw_bytes, q_full(qs));\n"),
    ("        for (int j = 0; j < DK; ++j) tma_load_4d(st + j * slab, &tq, q_full(qs), 16 * j, h, q0, b);",
     "        for (int j = 0; j < (it < a.q_stages ? DK : 0); ++j) tma_load_4d(st + j * slab, &tq, q_full(qs), 16 * j, h, q0, b);"),
    ("          mbar_arrive_expect_tx(kv_full(s), 2 * DK * slab);",
     "          mbar_arrive_expect_tx(kv_full(s), kv_i < a.kv_stages ? 2 * DK * slab : 0u);"),
    ("          for (int j = 0; j < DK; ++j) {\n            tma_load_4d(ks + j * slab",
     "          for (int j = 0; j < (kv_i < a.kv_stages ? DK : 0); ++j) {\n            tma_load_4d(ks + j * slab"),
]
# FA3's ping-pong: the two consumer warpgroups take turns at the tensor
# cores (named barriers 3 and 4), one issuing its products while the other
# runs its softmax
PINGPONG = [
    ("    const float c = a.scale;\n",
     "    const float c = a.scale;\n    const int my_turn = 3 + wg, other_turn = 4 - wg;\n"
     '    if (wg == 1) asm volatile("bar.arrive 3, 256;\\n" ::: "memory");\n'),
    ("wgmma_fence();\n      issue", 'asm volatile("bar.sync %0, 256;\\n" ::"r"(my_turn) : "memory");\n      wgmma_fence();\n      issue'),
    ("wgmma_fence();\n        issue",
     'asm volatile("bar.sync %0, 256;\\n" ::"r"(my_turn) : "memory");\n        wgmma_fence();\n        issue'),
    ("      issue_s(kv_base + (uint32_t)(s * a.kv_stage_bytes));\n      wgmma_wait0();",
     '      issue_s(kv_base + (uint32_t)(s * a.kv_stage_bytes));\n'
     '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(other_turn) : "memory");\n      wgmma_wait0();'),
    ("        issue_pv(kv_base + (uint32_t)(sp * a.kv_stage_bytes) + DK * slab);\n",
     "        issue_pv(kv_base + (uint32_t)(sp * a.kv_stage_bytes) + DK * slab);\n"
     '        asm volatile("bar.arrive %0, 256;\\n" ::"r"(other_turn) : "memory");\n'),
    ("      issue_pv(kv_base + (uint32_t)(s * a.kv_stage_bytes) + DK * slab);\n",
     "      issue_pv(kv_base + (uint32_t)(s * a.kv_stage_bytes) + DK * slab);\n"
     '      asm volatile("bar.arrive %0, 256;\\n" ::"r"(other_turn) : "memory");\n'),
    ("      if (tw == 0) mbar_arrive(q_empty(qs));\n    }\n",
     "      if (tw == 0) mbar_arrive(q_empty(qs));\n    }\n"
     '    if (wg == 0) asm volatile("bar.sync 3, 256;\\n" ::: "memory");\n'),
]
# the same with the barrier ids written into each warpgroup's own branch
# instead of a register operand
PINGPONG_IMM = [(old, new.replace('asm volatile("bar.sync %0, 256;\\n" ::"r"(my_turn) : "memory");',
                                  'if (wg == 0) asm volatile("bar.sync 3, 256;\\n" ::: "memory"); '
                                  'else asm volatile("bar.sync 4, 256;\\n" ::: "memory");')
                 .replace('asm volatile("bar.arrive %0, 256;\\n" ::"r"(other_turn) : "memory");',
                          'if (wg == 0) asm volatile("bar.arrive 4, 256;\\n" ::: "memory"); '
                          'else asm volatile("bar.arrive 3, 256;\\n" ::: "memory");'))
                for old, new in PINGPONG]
LONG_VARIANTS = {
    "shipped": [],
    "loads_only": [NO_S, NO_PV, *NO_SOFTMAX],
    "compute_only": LONG_LOADS_ONCE,
    "products_only": NO_SOFTMAX,
    "no_S": [NO_S],
    "no_PV": [NO_PV],
    "no_exp": [(f"    e[{i}] = ex2(fmaf(e[{i}], LOG2E, off[{i // 2}][half]));",
                f"    e[{i}] = fmaf(e[{i}], LOG2E, off[{i // 2}][half]);") for i in range(4)],
    "pingpong": PINGPONG,
    "pingpong_immediate_ids": PINGPONG_IMM,
    # each warpgroup's softmax waits for its own P V as well
    "no_overlap": [("        wgmma_wait1();", "        wgmma_wait0();")],
    "gather_bias": [("  return a.wk == 64 ? launch_long_bias<ROWS64>", "  return false ? launch_long_bias<ROWS64>")],
    "one_q_stage": [("constexpr int MAX_Q_STAGES = 2,", "constexpr int MAX_Q_STAGES = 1,")],
    "two_kv_stages": [("MAX_KV_STAGES = 4;", "MAX_KV_STAGES = 2;")],
    # one producer warp (288 threads) and no setmaxnreg
    "one_producer_warp": [
        ("constexpr int LONG_NT = 384;", "constexpr int LONG_NT = 288;"),
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(LONG_PRODUCER_REGS));\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(LONG_CONSUMER_REGS));\n', ""),
    ],
}
VARIANTS = {"short": SHORT_VARIANTS, "long": LONG_VARIANTS}
ENTRIES = {"short": "pope_attention_short", "long": "pope_attention_long"}


def highest_registers(lib: Path) -> dict:
    """The highest register index each kernel's SASS uses (cuobjdump): what
    ptxas allocated, whatever setmaxnreg asks for at run time."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    top, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*(attn_\w+_kernelI\w+?E)E", line)
        if m or "Function :" in line:
            func = m.group(1) if m else None
        elif func:
            top[func] = max([top.get(func, 0), *map(int, re.findall(r"\bR(\d+)\b", line))])
    return top


def build_all(kernels) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel in kernels:
        src = SOURCES[kernel].read_text()
        for name, edits in VARIANTS[kernel].items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{kernel}/{name}: the edit's text is not in {SOURCES[kernel].name}: {old[:70]!r}")
                text = text.replace(old, new)
            cu = OUT / f"{kernel}_{name}.cu"
            cu.write_text(text)
            procs[kernel, name] = subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-I", str(CSRC), "-shared", "-Xcompiler", "-fPIC",
                 "-o", str(OUT / f"{kernel}_{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{kernel}/{name}: nvcc failed\n{log[-3000:]}")
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        print(json.dumps({"kernel": kernel, "variant": name, "spill_stores_per_function": spills,
                          "registers_per_function": regs,
                          "highest_register_in_sass": highest_registers(OUT / f"{kernel}_{name}.so")}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{kernel}_{name}.so"))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        entry = ENTRIES[kernel]
        getattr(lib, f"{entry}_relpos").argtypes = [ptr] * 6 + [i64] * 9 + [i32] * 6 + [ctypes.c_float, ptr]
        getattr(lib, entry).argtypes = [ptr] * 4 + [i64] * 9 + [i32] * 4 + [ctypes.c_float, ptr]
        libs[kernel, name] = lib
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
    ap.add_argument("--kernel", choices=("short", "long", "all"), default="all")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernels.py runs on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    kernels = ("short", "long") if args.kernel == "all" else (args.kernel,)
    libs = build_all(kernels)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, stream = torch.bfloat16, torch.cuda.current_stream().cuda_stream

    def views(qkv):
        q, k, v = qkv.unbind(2)
        return [t.data_ptr() for t in (q, k, v)], [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]

    def relpos(entry, qkv, rel_h, rel_w, out, hk, wk):
        (p, st), (B, N, _, nh, d) = views(qkv), qkv.shape
        def run(lib):
            err = getattr(lib, entry)(*p, rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), *st,
                                      B, N, nh, d, hk, wk, d ** -0.5, stream)
            assert err == 0, err
        return run

    def plain(entry, qkv, out):
        (p, st), (B, N, _, nh, d) = views(qkv), qkv.shape
        def run(lib):
            err = getattr(lib, entry)(*p, out.data_ptr(), *st, B, N, nh, d, d ** -0.5, stream)
            assert err == 0, err
        return run

    shapes = {}
    if "short" in kernels:
        # kernel 1: windowed layers, the qkv Dense output viewed as q, k, v
        qkv1 = torch.randn(80, 196, 3, 16, 80, device="cuda", generator=g).to(bf16)
        rel_h = (0.5 * torch.randn(80, 16, 196, 14, device="cuda", generator=g)).to(bf16)
        rel_w = (0.5 * torch.randn(80, 16, 196, 14, device="cuda", generator=g)).to(bf16)
        out1 = torch.empty(80, 196, 16 * 80, device="cuda", dtype=bf16)
        # kernel 3: DINOv2's blocks
        qkv3 = torch.randn(260, 197, 3, 6, 64, device="cuda", generator=g).to(bf16)
        out3 = torch.empty(260, 197, 6 * 64, device="cuda", dtype=bf16)
        shapes["short"] = {"kernel1_ms": relpos("pope_attention_short_relpos", qkv1, rel_h, rel_w, out1, 14, 14),
                           "kernel3_ms": plain("pope_attention_short", qkv3, out3)}
    if "long" in kernels:
        # kernel 2: global layers, 4 frames of 48 x 64 tokens
        qkv2 = torch.randn(4, 3072, 3, 16, 80, device="cuda", generator=g).to(bf16)
        rel_h2 = (0.5 * torch.randn(4, 16, 3072, 48, device="cuda", generator=g)).to(bf16)
        rel_w2 = (0.5 * torch.randn(4, 16, 3072, 64, device="cuda", generator=g)).to(bf16)
        out2 = torch.empty(4, 3072, 16 * 80, device="cuda", dtype=bf16)
        shapes["long"] = {"kernel2_ms": relpos("pope_attention_long_relpos", qkv2, rel_h2, rel_w2, out2, 48, 64),
                          "kernel2_no_bias_ms": plain("pope_attention_long", qkv2, out2)}

    for rnd in range(args.rounds):
        for (kernel, name), lib in libs.items():
            row = {"round": rnd, "kernel": kernel, "variant": name}
            row.update({key: cuda_ms(lambda: fn(lib), args.reps) for key, fn in shapes[kernel].items()})
            print(json.dumps({**row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
