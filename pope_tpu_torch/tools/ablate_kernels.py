#!/usr/bin/env python3
"""Where the attention kernels' time goes, on one NVIDIA GPU.

    python3 pope_tpu_torch/tools/ablate_kernels.py [--kernel short|long|f32|all] [--rounds 2]
                                                   [--variants a,b] [--against CSRC] [--plans]

Builds csrc/attention_short.cu, csrc/attention_long.cu and
csrc/attention_f32.cu as they ship and a few variants of each, every one a
copy with text edits that remove or replace one step, all with nvcc in
parallel into build/ablate/, and times each at the main path's shapes: the
short kernel at SAM ViT-H's windowed layers (80 windows x 16 heads, N = 196,
d = 80, with the rel-pos bias) and DINOv2 ViT-S/14's retrieval forward (260
crops x 6 heads, N = 197, d = 64); the long kernel at SAM ViT-H's global
layers (4 frames x 16 heads, 48 x 64 tokens, d = 80) with the bias and, on
the same q/k/v, without it; the f32 (tf32x3) kernel at the SSL step's two
shapes (16 x 6 heads at N = 257 and 64 x 6 at N = 50, d = 64) and at
kernels 1 and 2's shapes in float32. With the f32 kernel it also times
the TF32 products alone, the rates 3xTF32 divides by three: mma.sync's (a
kernel of independent m16n8k8 products, the previous body's) and the
shipped body's wgmma shapes (m64nNk8, from shared memory and from
registers, with one and with six warpgroups an SM); and the SSL shapes
again on q/k/v laid out head by head (each block's rows one contiguous
run, as a block that packed an image's heads would read them) and on rows
off 16 bytes (its 4-byte loads), and 8 x 6 heads at N = 1025. Variants
that skip work give wrong outputs: they are timings, not kernels. Each
round times every variant once, in order; CUDA-event means over `--reps`
launches. Prints the card, ptxas's spills per variant (and the SASS's highest
register and F2FP / PRMT counts per kernel), and one JSON line
per round and variant. An edit whose text is not in its source exactly
once stops the script (tests/test_torch_ablate_kernels.py holds every edit
to that on the CPU).

With `--against CSRC` (a csrc directory of an earlier version, e.g. from
`git archive <commit> pope_tpu_torch/csrc` unpacked under build/), it
builds that version's source of the kernel named by `--kernel` (long, the
default, short or f32) beside the shipped one and times the two in turns
(against, shipped, shipped, against) at that kernel's shapes: for the long
kernel, kernel 2 on the main, square and crop grids and on portrait frames'
(64 x 48, a 64 x 52 crop: key rows of 48 and 56 slots), kernel 3 at d 80 N
= 3072 and at demo-dinov2's N = 1025 (d 64), and d 64 / d 32 at N = 3072;
for the short kernel, kernel 1 at the eval batch's 80 windows, the serving
path's square frame (25) and one 640x480 frame (20), and kernel 3 at
DINOv2's eval shape; for the f32 kernel, the shapes above (the four f32
rows among them). With `--variants` as well, it times the listed variants
and that version once a round each instead. The shipped short and long
kernels run the plan of their last wave that the wrappers pick
(cuda_kernels.short_plan, long_plan); a source without plans (before the
tail split) takes none.

With `--plans` it times the shipped kernels alone at every row whose last
wave the rule splits (kernel 3 at N = 1025, kernel 2's crop and portrait
crop; kernel 1's square and one-frame rows), each under the unsplit plan,
the rule's and the other candidates (s = 2 .. 4 pieces for the short
kernel, 2 .. 8 for the long one), in turns (forward, then backward).
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
SOURCES = {"short": CSRC / "attention_short.cu", "long": CSRC / "attention_long.cu",
           "f32": CSRC / "attention_f32.cu"}
OUT = ROOT / "build" / "ablate"

# ---- the short kernel (kernels 1 and 3)
NO_TILES = ("      for (int tq0 = p.lo + wg; tq0 < p.hi; tq0 += 2) {", "      for (int tq0 = p.lo + wg; tq0 < 0; tq0 += 2) {")
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


# ---- the long kernel (kernel 2, and kernel 3 above 256 tokens)
NO_S = [("        for (int ks = 0; ks < DK; ++ks)\n          wgmma_ss<16 * RB>",
         "        for (int ks = 0; ks < 0; ++ks)\n          wgmma_ss<16 * RB>")]
NO_PV = [("        for (int j = 0; j < RB; ++j) wgmma_rs<D>(", "        for (int j = 0; j < 0; ++j) wgmma_rs<D>(")]
NO_SOFTMAX = [
    ("      softmax_tile<BIAS, RB>(sacc, m, l, corr, rh0, rh1, rw0, rw1, w, p.lo * TK, N, a.hk, a.wk, t, c);", ""),
    ("        softmax_tile<BIAS, RB>(sacc, m, l, corr, rh0, rh1, rw0, rw1, w, kt * TK, N, a.hk, a.wk, t, c);", ""),
]
# the producer loads each block's first items and tiles (one per stage) and
# then only signals, so the consumers recompute data already in shared memory
LONG_LOADS_ONCE = [
    ("      uint32_t tx = rows > 0 ? tile : 0u;\n", "      uint32_t tx = rows > 0 && it < a.q_stages ? tile : 0u;\n"),
    ("        tx += rh_bytes + rw_bytes;\n", "        if (it < a.q_stages) tx += rh_bytes + rw_bytes;\n"),
    ("          if (rows > 0) {\n", "          if (rows > 0 && it < a.q_stages) {\n"),
    ("      if (lane == 0 && rows > 0) load_tile<D>(", "      if (lane == 0 && rows > 0 && it < a.q_stages) load_tile<D>("),
    ("          mbar_arrive_expect_tx(kv_full(s), kv_tx);",
     "          mbar_arrive_expect_tx(kv_full(s), kv_i < a.kv_stages ? kv_tx : 0u);"),
    ("          if (rank == 0) load_kv_tile<D, BIAS>(", "          if (rank == 0 && kv_i < a.kv_stages) load_kv_tile<D, BIAS>("),
    ("          if (rank == cl - 1) load_kv_tile<D, BIAS>(",
     "          if (rank == cl - 1 && kv_i < a.kv_stages) load_kv_tile<D, BIAS>("),
]
LONG_ROUTE = "  if (bias_layout(a.hk, a.wk) == GATHER) return"  # the launcher's choice of the gather
LONG_VARIANTS = {
    "shipped": [],
    "loads_only": [*NO_S, *NO_PV, *NO_SOFTMAX],
    "compute_only": LONG_LOADS_ONCE,
    "products_only": NO_SOFTMAX,
    "no_S": NO_S,
    "no_PV": NO_PV,
    "no_exp": [(f"    e[{i}] = ex2(fmaf(e[{i}], k2, off[{i // 2}][half]));",
                f"    e[{i}] = fmaf(e[{i}], k2, off[{i // 2}][half]);") for i in range(4)],
    # each warpgroup's softmax waits for its own P V as well
    "no_overlap": [("        wgmma_wait1();", "        wgmma_wait0();")],
    # clusters of one block: each block loads its own K/V tiles
    "no_multicast": [("constexpr int LONG_CLUSTER = 2;", "constexpr int LONG_CLUSTER = 1;")],
    # the empty half of a head's last pair (an odd number of items) runs S,
    # the softmax and P V on its stale Q stage instead of only releasing
    # each K/V tile
    "empty_half_computes": [("      if (rows <= 0) {\n        // no queries", "      if (false) {\n        // no queries")],
    # the cluster size as the compile-time constant in every instantiation,
    # and read from LongArgs in every one
    "cluster_constant": [("  const int N = a.N, nh = a.nh, cl = BIAS == NO_BIAS && D == 80 ? LONG_CLUSTER : a.cluster;",
                          "  const int N = a.N, nh = a.nh, cl = LONG_CLUSTER;")],
    "cluster_at_run_time": [("  const int N = a.N, nh = a.nh, cl = BIAS == NO_BIAS && D == 80 ? LONG_CLUSTER : a.cluster;",
                             "  const int N = a.N, nh = a.nh, cl = a.cluster;")],
    "one_q_stage": [("constexpr int MAX_Q_STAGES = 2,", "constexpr int MAX_Q_STAGES = 1,")],
    "two_kv_stages": [("MAX_KV_STAGES = 4;", "MAX_KV_STAGES = 2;")],
    # the remote arrival with release semantics at cluster scope
    "remote_arrive_release_cluster": [(
        "        if (cl > 1) mbar_arrive_cluster(kv_empty(s), (uint32_t)(rank ^ 1));",
        '        if (cl > 1) asm volatile("{\\n.reg .b32 remote;\\nmapa.shared::cluster.u32 remote, %0, %1;\\n"\n'
        '                                 "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\\n}\\n"'
        ' ::"r"(kv_empty(s)), "r"(rank ^ 1) : "memory");')],
    # without the bias, d^-1/2 applied by its own FMUL a logit before the
    # maximum (the exponent's FFMA then scales by log2 e alone)
    "scale_unfolded": [
        ("  const float k2 = BIAS == NO_BIAS ? c * LOG2E : LOG2E;", "  const float k2 = LOG2E;"),
        ("        if (kw >= wk) kw -= wk, ++kh;\n      }\n",
         "        if (kw >= wk) kw -= wk, ++kh;\n      } else {\n"
         "#pragma unroll\n        for (int i = 0; i < 4; ++i) e[i] *= c;\n      }\n"),
    ],
    # every biased grid gathered per logit (walking (kh, kw)), wk = 64 too
    "gather_bias": [(LONG_ROUTE, "  if (true) return")],
    # the grids of wk != 64 back on the per-logit gather as it was before
    # the padded key rows: (kh, kw) by an integer division a logit
    "gathered": [
        (LONG_ROUTE, "  if (a.wk != 64) return"),
        ("    int kh = 0, kw = 0, dkh = 0, dkw = 0;\n"
         "    if constexpr (BIAS == GATHER) {\n"
         "      kh = (k0 + 2 * t) / wk, kw = k0 + 2 * t - kh * wk;\n"
         "      dkh = 8 / wk, dkw = 8 - dkh * wk;\n"
         "    }\n", ""),
        ("        int kh1 = kh, kw1 = kw + 1;\n"
         "        if (kw1 == wk) kw1 = 0, ++kh1;\n"
         "        const int ch = min(kh, hk - 1), ch1 = min(kh1, hk - 1);\n",
         "        int kh = key / wk, kw = key - kh * wk, kh1 = kh, kw1 = kw + 1;\n"
         "        if (kw1 == wk) kw1 = 0, ++kh1;\n"
         "        const int ch = min(kh, hk - 1), ch1 = min(kh1, hk - 1);\n"),
        ("        kh += dkh, kw += dkw;\n        if (kw >= wk) kw -= wk, ++kh;\n", ""),
    ],
    # every key row padded to 64 slots whatever wk, one instantiation for
    # every grid (128-key tiles, S an m64n128 product)
    "row_slots_64": [("int row_blocks(int wk) { return (wk + 7) / 8; }", "int row_blocks(int wk) { return 8; }")],
    # the producer's piece decoded once, at the top of the item, its K/V
    # tiles held through the Q and rel loads (shipped: decoded again before
    # the K/V loop)
    "decode_once": [
        ("      const int unit = piece_of(wi, a.tail, nkt).item;\n"
         "      const int bh = unit / per_head, q0 = ((unit - bh * per_head) * cl + rank) * TQ;\n"
         "      const int b = bh / nh, h = bh - b * nh;\n"
         "      const int rows = max(0, min(TQ, N - q0));  // 0: no queries",
         "      const Piece p = piece_of(wi, a.tail, nkt);\n"
         "      const int bh = p.item / per_head, q0 = ((p.item - bh * per_head) * cl + rank) * TQ;\n"
         "      const int b = bh / nh, h = bh - b * nh;\n"
         "      const int rows = max(0, min(TQ, N - q0));  // 0: no queries"),
        ("      int w = wi;\n      asm volatile(\"\" : \"+r\"(w));\n      const Piece p = piece_of(w, a.tail, nkt);\n", "")],
    # the padded rel_w words by C++ clamps and selects: the compiler holds
    # each slot's compare across the item loop
    "rel_w_pad_in_cxx": [(
        "        load_rel_w<RB>(w, rw0 + 4 * t, rw1 + 4 * t, 2 * t, a.wk);\n",
        "#pragma unroll\n"
        "        for (int cb = 0; cb < RB; ++cb)\n"
        "#pragma unroll\n"
        "          for (int r = 0; r < 2; ++r) {\n"
        "            const uint32_t row = r ? rw1 : rw0;\n"
        "            const int kw = 8 * cb + 2 * t;\n"
        "            uint32_t lo = __float_as_uint(lds_bf16(row + 2 * min(kw, a.wk - 1))) >> 16;\n"
        "            uint32_t hi = __float_as_uint(lds_bf16(row + 2 * min(kw + 1, a.wk - 1))) >> 16;\n"
        "            if (kw >= a.wk) lo = 0xff80u;\n"
        "            if (kw + 1 >= a.wk) hi = 0xff80u;\n"
        "            w[8 * r + cb] = lo | hi << 16;\n"
        "          }\n")],
}

# ---- the f32 kernel (tf32x3: kernels 1, 2 and 3 in float32)
F32_NO_TILE_LOADS = [("      if (k0 + TK < N) {  // the next", "      if (false) {  // the next"),
                     ("      if constexpr (!prefetch<DP, VEC>()) {\n        // d laundered",
                      "      if constexpr (false) {\n        // d laundered")]
F32_STORES = "    store_rows<DP, TK, NT>(Kb, Ks, kc, 1.f);\n    store_v<DP, TK, NT>(Vb, Vs, vc);\n"
# the first tile's stores alone
F32_STORES_ONCE = (F32_STORES, "    if (k0 == 0) {\n  " + F32_STORES.replace("\n    ", "\n      ") + "    }\n")
F32_NO_EXP = [(f"      s[4 * c{o}] = ex2(s[4 * c{o}] - mn{m});", f"      s[4 * c{o}] = s[4 * c{o}] - mn{m};")
              for o, m in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))]
F32_S3 = ("  wgmma_tf32_ss<TK>(s, q_small, k_big, ks > 0);\n"
          "  wgmma_tf32_ss<TK>(s, q_big, k_small, 1);\n"
          "  wgmma_tf32_ss<TK>(s, q_big, k_big, 1);\n")
F32_PV3 = ("  wgmma_tf32_rs<DP>(o, p_small, v_big, j > 0);\n"
           "  wgmma_tf32_rs<DP>(o, p_big, v_small, 1);\n"
           "  wgmma_tf32_rs<DP>(o, p_big, v_big, 1);\n")
F32_VARIANTS = {
    "shipped": [],
    # staging alone: no products, no softmax
    "loads_only": [("    if (!live) continue;", "    continue;")],
    # only the first K / V tiles are loaded; the others split and store them again
    "no_tile_loads": F32_NO_TILE_LOADS,
    # only the first K / V tiles are loaded and stored: products and softmax
    # on them alone
    "no_staging": [*F32_NO_TILE_LOADS, F32_STORES_ONCE],
    # the products and the softmax's other steps, without staging or exp
    "products_only": [*F32_NO_TILE_LOADS, F32_STORES_ONCE, *F32_NO_EXP],
    "no_exp": F32_NO_EXP,
    # big . big alone, in S and in P V
    "one_tf32_product": [
        (F32_S3, "  wgmma_tf32_ss<TK>(s, q_big, k_big, ks > 0);\n"),
        (F32_PV3, "  wgmma_tf32_rs<DP>(o, p_big, v_big, j > 0);\n"),
    ],
    # the per-logit bias gather left out (the biased rows' logits bias-free)
    "no_bias_gather": [("    if constexpr (HAS_BIAS) {\n      int kh", "    if constexpr (false) {\n      int kh")],
    "no_prefetch": [("  return VEC && DP <= 80;", "  return false;")],
    # the rounding by cvt.rna.tf32.f32 (shipped: two integer operations)
    "rounding_by_cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                         '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')],
    # 32-key tiles in every 64-query block (shipped: 64 at d_pad 32 and 64;
    # fewer registers, twice the barriers)
    "tile_keys_32": [("  return DP == 128 ? (HAS_BIAS ? 16 : 32) : DP == 80 && TQ == 64 ? 32 : 64;",
                      "  return DP == 128 ? (HAS_BIAS ? 16 : 32) : DP == 80 && TQ == 128 ? 64 : 32;")],
    # 64 query rows a block at every N (shipped: 128 from 1024 keys on at
    # d_pad 80, each K / V tile loaded and split once for twice the
    # queries), and 128 at every N
    "query_tile_64": [("constexpr int LONG_N = 1024;", "constexpr int LONG_N = 1 << 30;")],
    "query_tile_128": [("constexpr int LONG_N = 1024;", "constexpr int LONG_N = 0;")],
}
VARIANTS = {"short": SHORT_VARIANTS, "long": LONG_VARIANTS, "f32": F32_VARIANTS}
ENTRIES = {"short": "pope_attention_short", "long": "pope_attention_long", "f32": "pope_attention_f32"}

# m16n8k8 TF32 products on the tensor cores, ILP independent accumulators a
# warp, no loads: the warp-level product's own rate (the previous body's)
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int ILP>
__global__ void mma_tf32_rate(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float c[ILP][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < ILP; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                   "{%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(i), "r"(j));
  }
  float s = 0.f;
  for (int j = 0; j < ILP; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_probe(float* out, int blocks, int threads, int iters) {
  mma_tf32_rate<8><<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""

# the shipped body's own tf32 wgmma products (attention_f32.cu's helpers),
# 16 a batch on one accumulator, operands zero in shared memory (the
# 32-byte swizzle), two warpgroups a block: S's m64n64k8 and m64n32k8
# (A and B from shared memory) and P V's m64n64k8 and m64n80k8 (A from
# registers)
WGMMA_PROBE = r"""
#include "attention_f32.cu"
template <int N, bool RS>
__global__ void __launch_bounds__(256) wgmma_tf32_rate(float* out, int iters) {
  __shared__ __align__(1024) float sm[2 * 128 * 8];
  for (int i = threadIdx.x; i < 2 * 128 * 8; i += blockDim.x) sm[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a_addr = smem_u32(sm), b_addr = a_addr + 128 * 32;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  for (int it = 0; it < iters; ++it) {
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (RS) wgmma_tf32_rs<N>(d, a, desc_b32(b_addr, 16), 1);
      else wgmma_tf32_ss<N>(d, desc_b32(a_addr, 16), desc_b32(b_addr, 16), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int wgmma_tf32_probe(int kind, float* out, int blocks, int threads, int iters) {
  if (kind == 0) wgmma_tf32_rate<64, false><<<blocks, threads>>>(out, iters);
  if (kind == 1) wgmma_tf32_rate<32, false><<<blocks, threads>>>(out, iters);
  if (kind == 2) wgmma_tf32_rate<64, true><<<blocks, threads>>>(out, iters);
  if (kind == 3) wgmma_tf32_rate<80, true><<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""
WGMMA_KINDS = (("ss_m64n64k8", 64), ("ss_m64n32k8", 32), ("rs_m64n64k8", 64), ("rs_m64n80k8", 80))


def mma_tf32_tflops(reps: int) -> dict:
    """mma.sync m16n8k8 TF32 products a second on this card (8 warps of 8
    independent accumulators on every SM, no loads), in TFLOP/s."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "mma_tf32_probe.cu", OUT / "mma_tf32_probe.so"
    cu.write_text(MMA_PROBE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_tf32_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")
    ms = cuda_ms(lambda: lib.mma_tf32_probe(out.data_ptr(), blocks, threads, iters), reps)
    flops = blocks * threads // 32 * 8 * iters * 2 * 16 * 8 * 8
    return {"mma_sync_tf32_tflops": flops / ms / 1e9, "ms": ms}


def wgmma_tf32_tflops(reps: int) -> dict:
    """The shipped body's tf32 wgmma products a second on this card (16
    products a batch on one accumulator, no loads), in TFLOP/s, by shape:
    with 6 warpgroups on every SM (3 blocks of two), and with one (a
    dependent chain alone, as one warpgroup of a block waits for its own S
    or P V)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "wgmma_tf32_probe.cu", OUT / "wgmma_tf32_probe.so"
    cu.write_text(WGMMA_PROBE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", str(CSRC), "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.wgmma_tf32_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    out = torch.empty(3 * sms * 256, device="cuda")
    rates = {}
    for label, blocks, threads in (("6_warpgroups_an_sm", 3 * sms, 256), ("1_warpgroup_an_sm", sms, 128)):
        for kind, (name, n) in enumerate(WGMMA_KINDS):
            ms = cuda_ms(lambda: lib.wgmma_tf32_probe(kind, out.data_ptr(), blocks, threads, iters), reps)
            rates[f"{name}_{label}"] = blocks * threads // 128 * iters * 16 * 2 * 64 * n * 8 / ms / 1e9
    return {"wgmma_tf32_tflops": rates}


def sass_profile(lib: Path) -> dict:
    """Per kernel, from its SASS (cuobjdump): the highest register index it
    uses (what ptxas allocated, whatever setmaxnreg asks for at run time) and
    how many F2FP (float pairs to bf16) and PRMT (byte permutes) it holds,
    which shows whether P's packing for P V takes more than one F2FP a pair."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    prof, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*(attn_\w+_kernelI\w+?E)E", line)
        if m or "Function :" in line:
            func = m.group(1) if m else None
            if func:
                prof[func] = {"highest_register": 0, "F2FP": 0, "PRMT": 0}
        elif func:
            p = prof[func]
            p["highest_register"] = max([p["highest_register"], *map(int, re.findall(r"\bR(\d+)\b", line))])
            p["F2FP"] += " F2FP." in line
            p["PRMT"] += " PRMT " in line
    return prof


def variant_source(kernel: str, name: str) -> str:
    """The shipped source of `kernel` with the edits of variant `name`; each
    edit's text must be in the shipped source exactly once."""
    src = SOURCES[kernel].read_text()
    text = src
    for old, new in VARIANTS[kernel][name]:
        if src.count(old) != 1:
            raise SystemExit(f"{kernel}/{name}: the edit's text is in {SOURCES[kernel].name} {src.count(old)} "
                             f"times, not once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def takes_plan(kernel: str, text: str) -> bool:
    """Whether a source of `kernel` takes its last wave's plan in its C
    entries (split0, pieces; the short and long kernels from the tail split
    on, not an earlier version built with --against)."""
    return kernel != "f32" and "float scale, int split0, int pieces," in text


def build_all(kernels, variants=None, against=None) -> dict:
    """Build every variant of `kernels` (or those named in `variants`) and,
    with `against` (a csrc directory of another version), that version's
    source of each kernel as its variant "against"."""
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for kernel in kernels:
        for name in VARIANTS[kernel]:
            if variants is None or name in variants:
                sources[kernel, name] = (variant_source(kernel, name), CSRC)
    if against is not None:
        for kernel in kernels:
            sources[kernel, "against"] = ((Path(against) / SOURCES[kernel].name).read_text(), Path(against))
    procs = {}
    for (kernel, name), (text, include) in sources.items():
        cu = OUT / f"{kernel}_{name}.cu"
        cu.write_text(text)
        procs[kernel, name] = subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-I", str(include), "-shared", "-Xcompiler", "-fPIC",
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
                          "sass": sass_profile(OUT / f"{kernel}_{name}.so")}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"{kernel}_{name}.so"))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        entry = ENTRIES[kernel]
        # the short and long entries take their last wave's plan (and the
        # long ones its workspace), unless the source predates it
        lib.takes_plan = takes_plan(kernel, sources[kernel, name][0])
        plan = ([i32] * 2 + ([ptr] * 2 if kernel == "long" else [])) if lib.takes_plan else []
        getattr(lib, f"{entry}_relpos").argtypes = [ptr] * 6 + [i64] * 9 + [i32] * 6 + [ctypes.c_float] + plan + [ptr]
        getattr(lib, entry).argtypes = [ptr] * 4 + [i64] * 9 + [i32] * 4 + [ctypes.c_float] + plan + [ptr]
        libs[kernel, name] = lib
    return libs


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls. The card
    sleeps about 10 ms before the start event, so that the host has queued
    the calls before the first one runs: a call's ctypes and launch take
    several microseconds of host time, as long as the fastest rows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("short", "long", "f32", "all"), default="all")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", help="comma-separated variants to build (default: all)")
    ap.add_argument("--against", metavar="CSRC",
                    help="a csrc directory of another version of the long, short or f32 kernel (--kernel; a git "
                         "archive of an earlier commit): times it and the shipped one in turns (against, shipped, "
                         "shipped, against) at that design's shapes instead of ablating")
    ap.add_argument("--plans", action="store_true",
                    help="time the shipped short and long kernels under the unsplit plan, the rule's and the other "
                         "candidates, in turns, at every row whose last wave the rule splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_kernels.py runs on a CUDA card")
    sys.path.insert(0, str(ROOT))  # the plans of this checkout's wrappers, run as a script or a module
    from pope_tpu_torch.ops import cuda_kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    kernels = ("short", "long", "f32") if args.kernel == "all" else (args.kernel,)
    if args.against:
        kernels = (args.kernel,) if args.kernel != "all" else ("long",)
    turns = args.against and not args.variants  # else the variants and the earlier version, each once a round
    if args.plans:
        kernels = ("short", "long")
    variants = {"shipped"} if turns or args.plans else (set(args.variants.split(",")) if args.variants else None)
    libs = build_all(kernels, variants, args.against)
    if "f32" in kernels:
        print(json.dumps({"mma_probe": mma_tf32_tflops(args.reps), "card": smi}), flush=True)
        print(json.dumps({"wgmma_probe": wgmma_tf32_tflops(args.reps), "card": smi}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, stream = torch.bfloat16, torch.cuda.current_stream().cuda_stream

    def views(qkv):
        q, k, v = qkv.unbind(2)
        return [t.data_ptr() for t in (q, k, v)], [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]

    def planned(entry, B, N, nh, d, hk=0, wk=0):
        """The plan arguments of `entry` at a shape for a library: none for
        one without plans; else (split0, s), the long kernel's workspace and
        counters after them, for `plan` (None: the wrappers' rule), each
        plan's scratch made once and held."""
        kept = {}
        def plan_args(lib, plan=None):
            if not getattr(lib, "takes_plan", False):
                return ()
            if "long" not in entry:
                return plan or cuda_kernels._plan_of(cuda_kernels.short_plan(B, N, nh))
            plan = plan or cuda_kernels._plan_of(cuda_kernels.long_plan(B, N, nh, d, hk, wk))
            if plan not in kept:
                tail = cuda_kernels.long_units(B, N, nh) - plan[0] if plan[1] > 1 else 0
                kept[plan] = cuda_kernels._long_scratch("cuda", stream, tail, plan[1], d)
            return (*plan, *(t.data_ptr() if t is not None else None for t in kept[plan]))
        return plan_args

    def relpos(entry, qkv, rel_h, rel_w, out, hk, wk):
        (p, st), (B, N, _, nh, d) = views(qkv), qkv.shape
        plan_args = planned(entry, B, N, nh, d, hk, wk)
        def run(lib, plan=None):
            err = getattr(lib, entry)(*p, rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), *st,
                                      B, N, nh, d, hk, wk, d ** -0.5, *plan_args(lib, plan), stream)
            assert err == 0, err
        return run

    def plain(entry, qkv, out):
        (p, st), (B, N, _, nh, d) = views(qkv), qkv.shape
        plan_args = planned(entry, B, N, nh, d)
        def run(lib, plan=None):
            err = getattr(lib, entry)(*p, out.data_ptr(), *st, B, N, nh, d, d ** -0.5, *plan_args(lib, plan),
                                      stream)
            assert err == 0, err
        return run

    def windows(BW, nh=16, d=80, ws=14):
        """Kernel 1 on BW windows of ws x ws, the qkv Dense output viewed as
        q, k, v, with the rel-pos bias"""
        qkv = torch.randn(BW, ws * ws, 3, nh, d, device="cuda", generator=g).to(bf16)
        rel_h = (0.5 * torch.randn(BW, nh, ws * ws, ws, device="cuda", generator=g)).to(bf16)
        rel_w = (0.5 * torch.randn(BW, nh, ws * ws, ws, device="cuda", generator=g)).to(bf16)
        out = torch.empty(BW, ws * ws, nh * d, device="cuda", dtype=bf16)
        return relpos("pope_attention_short_relpos", qkv, rel_h, rel_w, out, ws, ws)

    shapes = {}
    if "short" in kernels:
        # kernel 1: windowed layers (the eval batch's 4 frames x 20 windows);
        # kernel 3: DINOv2's blocks
        qkv3 = torch.randn(260, 197, 3, 6, 64, device="cuda", generator=g).to(bf16)
        out3 = torch.empty(260, 197, 6 * 64, device="cuda", dtype=bf16)
        shapes["short"] = {"kernel1_ms": windows(80), "kernel3_ms": plain("pope_attention_short", qkv3, out3)}
        if args.against or args.plans:
            # the serving path's square frame (25 windows) and one 640x480
            # frame (20): last waves of 4 and 56 heads on 132 SMs
            shapes["short"] |= {"kernel1_square_ms": windows(25), "kernel1_one_frame_ms": windows(20)}
    def global_grid(B, hk, wk, nh, d, bias=True):
        """q/k/v views of a (B, N, 3, nh, d) tensor on an hk x wk grid, with
        the rel-pos bias or without it"""
        N = hk * wk
        qkv = torch.randn(B, N, 3, nh, d, device="cuda", generator=g).to(bf16)
        out = torch.empty(B, N, nh * d, device="cuda", dtype=bf16)
        if not bias:
            return plain("pope_attention_long", qkv, out)
        rel_h = (0.5 * torch.randn(B, nh, N, hk, device="cuda", generator=g)).to(bf16)
        rel_w = (0.5 * torch.randn(B, nh, N, wk, device="cuda", generator=g)).to(bf16)
        return relpos("pope_attention_long_relpos", qkv, rel_h, rel_w, out, hk, wk)

    if "long" in kernels:
        # kernel 2: global layers, 4 frames of 48 x 64 tokens, with the bias
        # and, on q/k/v of the same shape, without it (kernel 3 at d 80); the
        # sweep's 52 x 64 crops, demo-dinov2's 1025 tokens (6 heads of d 64,
        # fewer items than SMs), portrait frames (4 of 64 x 48 tokens, a
        # 64 x 52 crop) and a 20 x 55 grid (9 items a head), all three on
        # whole key rows
        shapes["long"] = {"kernel2_ms": global_grid(4, 48, 64, 16, 80),
                          "kernel2_no_bias_ms": global_grid(4, 48, 64, 16, 80, bias=False),
                          "kernel2_crop_ms": global_grid(1, 52, 64, 16, 80),
                          "kernel3_n1025_d64_ms": global_grid(1, 25, 41, 6, 64, bias=False),
                          "kernel2_portrait_ms": global_grid(4, 64, 48, 16, 80),
                          "kernel2_portrait_crop_ms": global_grid(1, 64, 52, 16, 80),
                          "d80_20x55_ms": global_grid(2, 20, 55, 16, 80)}
        if args.against:
            # the serving path's square frame and the other head dims
            shapes["long"] |= {"kernel2_square_ms": global_grid(1, 64, 64, 16, 80),
                               "d64_n3072_ms": global_grid(4, 48, 64, 16, 64),
                               "d64_n3072_no_bias_ms": global_grid(4, 48, 64, 16, 64, bias=False),
                               "d32_n3072_ms": global_grid(4, 48, 64, 16, 32),
                               "d32_n3072_no_bias_ms": global_grid(4, 48, 64, 16, 32, bias=False)}

    if "f32" in kernels:
        f32 = torch.float32
        qkv_g = torch.randn(16, 257, 3, 6, 64, device="cuda", generator=g)
        qkv_l = torch.randn(64, 50, 3, 6, 64, device="cuda", generator=g)
        out_g, out_l = torch.empty(16, 257, 384, device="cuda"), torch.empty(64, 50, 384, device="cuda")
        qkv1f = torch.randn(80, 196, 3, 16, 80, device="cuda", generator=g)
        rel1 = [0.5 * torch.randn(80, 16, 196, 14, device="cuda", generator=g) for _ in "hw"]
        qkv2f = torch.randn(4, 3072, 3, 16, 80, device="cuda", generator=g)
        rel2 = [0.5 * torch.randn(4, 16, 3072, n, device="cuda", generator=g) for n in (48, 64)]
        out1f, out2f = (torch.empty(*x.shape[:2], 16 * 80, device="cuda", dtype=f32) for x in (qkv1f, qkv2f))
        # rows off 16 bytes (one element into a buffer): the 4-byte load path
        shifted = torch.randn(qkv_g.numel() + 1, device="cuda", generator=g)[1:].view(qkv_g.shape)
        qkv_1025 = torch.randn(8, 1025, 3, 6, 64, device="cuda", generator=g)
        out_1025 = torch.empty(8, 1025, 384, device="cuda")
        # (B, N, 3, nh, d) views of (3, B, nh, N, d): a head's rows contiguous
        by_head = [torch.randn(3, x.shape[0], 6, x.shape[1], 64, device="cuda", generator=g).permute(1, 3, 0, 2, 4)
                   for x in (qkv_g, qkv_l)]
        shapes["f32"] = {"ssl_n257_ms": plain("pope_attention_f32", qkv_g, out_g),
                         "ssl_n50_ms": plain("pope_attention_f32", qkv_l, out_l),
                         "ssl_n257_heads_contiguous_ms": plain("pope_attention_f32", by_head[0], out_g),
                         "ssl_n50_heads_contiguous_ms": plain("pope_attention_f32", by_head[1], out_l),
                         "ssl_n257_4byte_loads_ms": plain("pope_attention_f32", shifted, out_g),
                         "n1025_ms": plain("pope_attention_f32", qkv_1025, out_1025),
                         "kernel1_f32_ms": relpos("pope_attention_f32_relpos", qkv1f, *rel1, out1f, 14, 14),
                         "kernel2_f32_ms": relpos("pope_attention_f32_relpos", qkv2f, *rel2, out2f, 48, 64)}

    if args.plans:
        # every row the rule splits, under the unsplit plan, the rule's and
        # the other candidates
        rows = [("short", key, cuda_kernels.short_plan(BW, 196, 16), 4)
                for key, BW in (("kernel1_square_ms", 25), ("kernel1_one_frame_ms", 20))]
        for key, (B, N, nh, d, hk, wk) in (("kernel3_n1025_d64_ms", (1, 1025, 6, 64, 0, 0)),
                                           ("kernel2_crop_ms", (1, 3328, 16, 80, 52, 64)),
                                           ("kernel2_portrait_crop_ms", (1, 3328, 16, 80, 64, 52))):
            plan = cuda_kernels.long_plan(B, N, nh, d, hk, wk)
            rows.append(("long", key, plan, min(plan["key_tiles"], cuda_kernels.LONG_MAX_PIECES)))
        for rnd in range(args.rounds):
            for kernel, key, plan, most in rows:
                fn, lib = shapes[kernel][key], libs[kernel, "shipped"]
                units, resident, rule = plan["units"], plan["resident"], cuda_kernels._plan_of(plan)
                full = units - units % resident  # the whole waves' items, run whole in every candidate
                plans = {"unsplit": (units, 1), "rule": rule}
                plans |= {f"s{s}": (full, s) for s in range(2, most + 1)}
                order = list(plans) + list(plans)[::-1]
                turns = {name: [] for name in plans}
                for name in order:
                    turns[name].append(cuda_ms(lambda: fn(lib, plans[name]), args.reps))
                print(json.dumps({"round": rnd, "kernel": kernel, "shape": key, "units": units, "resident": resident,
                                  "rule": rule, "plans": plans,
                                  "ms": {name: sum(t) / len(t) for name, t in turns.items()}, "turns_ms": turns,
                                  "card": smi}), flush=True)
        return 0
    if turns:
        kernel = kernels[0]
        old, new = libs[kernel, "against"], libs[kernel, "shipped"]
        for rnd in range(args.rounds):
            for key, fn in shapes[kernel].items():
                turns = [cuda_ms(lambda lib=lib: fn(lib), args.reps) for lib in (old, new, new, old)]
                print(json.dumps({"round": rnd, "shape": key, "against_ms": (turns[0] + turns[3]) / 2,
                                  "shipped_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns, "card": smi}),
                      flush=True)
        return 0
    for rnd in range(args.rounds):
        for (kernel, name), lib in libs.items():
            row = {"round": rnd, "kernel": kernel, "variant": name}
            row.update({key: cuda_ms(lambda: fn(lib), args.reps) for key, fn in shapes[kernel].items()})
            print(json.dumps({**row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
