// Long-sequence attention for Hopper (sm_90a), bf16, with or without SAM's
// decomposed relative-position bias:
//
//   out[b, n, h*d:(h+1)*d] = softmax_k(q_n . k_k * d^-1/2
//                                      [+ rel_h[b, h, n, k / wk]
//                                       + rel_w[b, h, n, k % wk]]) . v
//
// for any N, d in {32, 64, 80} and, with the bias, N = hk * wk keys in
// row-major order on a grid of hk + wk <= 500.  It replaces, on the main
// path, kernel 2: pope_tpu/ops/flash_attention.py::flash_attention_relpos
// (_attn_bias_kernel + _stream_body), SAM ViT-H's 4 global layers, per B=4
// batch of 640x480 frames 4 x 16 heads, N = 48 * 64 = 3072, d = 80.  That is
// 193.3 GFLOP on 170 MB: operations bound it, 0.195 ms at 989 TFLOP/s; the
// B * nh * N^2 = 604 M exponentials take 0.155 ms more on the special-function
// units (about 3.9 T ex2/s) unless they overlap the products.  It also takes
// every other bf16 shape that attention_short.cu does not (N > 256, grids of
// hk + wk > 32), the bias-free flash_attention above N = 256 included;
// ops/cuda_kernels.py::attention_design picks one by shape, and a failure
// here raises, it never falls back.
//
// What held the streaming kernel (attention_relpos.cu, mma.sync) at 7.4x its
// bound, and the design here:
//   - mma.sync m16n8k16 cannot reach Hopper's tensor rate.  Here S = Q K^T is
//     an m64n128k16 wgmma with both operands in shared memory (d/16 k-steps)
//     and O += P V an m64n{d}k16 wgmma with P from registers (bf16 A
//     fragments) and V as the MN-major B operand (8 k-steps per key tile);
//   - every 64-row block read the head's whole K and V from L2 (3.0 GB per
//     launch).  Here an item is 128 query rows (64 per consumer warpgroup),
//     which halves that, and blocks are persistent (one per SM) and walk the
//     items head-major, so the query tiles of a head run side by side and
//     its 0.98 MB of K and V comes from L2, not device memory;
//   - the bias was gathered per logit from shared memory with a running
//     (kh, kw) wrap.  Here, as the Pallas kernel's key tiles cover whole key
//     rows, a K/V tile is two whole key rows, each padded to 8 RB slots, RB
//     = ceil(wk / 8): K's and V's TMA maps are 5-D, (d, nh, wk, hk, B), a
//     box two rows of 8 RB slots, slots past wk read as zeros, and S is an
//     m64n{16 RB} product (96 keys at a portrait frame's wk = 48, 112 at
//     its crops' 52, 128 at wk = 64).  Each thread's accumulator columns
//     then have the same kw in every tile: its rel_w values per row are
//     read once per item into RB registers (bf16 pairs, -inf in a slot past
//     wk, so that a padded key weighs 0 without a pass of its own), its
//     rel_h values are 2 per row per tile (-inf for a second row past an
//     odd hk), and each logit is one FFMA (s * d^-1/2 + rel_w), the rel_h
//     term folded into the exponent's offset.
//     That takes every grid of 32 < wk <= 64, SAM's global grids all.
//     Padding every row to 64 slots, one instantiation for all, read 11-16%
//     slower at 4 x 64x48 and 7-9% at 64x52 (variant "row_slots_64").  Other
//     grids (wk <= 32 or > 64; no SAM caller at 1024 px) gather both terms
//     per logit from the staged slabs, walking (kh, kw) along the thread's
//     keys;
//   - loads, S, softmax and P V ran in series in every warp.  Here one
//     producer warp keeps Q (with the item's rel slabs) and 128-key K/V tiles
//     in flight by TMA through mbarrier rings (2 Q stages, 2-4 K/V stages);
//     each consumer warpgroup issues S of tile j and P V of tile j - 1
//     together and runs the softmax of tile j while P V runs (FA3's
//     intra-warpgroup overlap), and the two warpgroups' products and
//     softmaxes interleave on the SM.  FA3's ping-pong (named barriers that
//     make the warpgroups take turns at the tensor cores) measured no faster
//     here, and with named barriers shared by the two warpgroups ptxas held
//     every thread at the 168 registers of a 384-thread block, ignoring the
//     consumers' setmaxnreg, so the d = 80 bias instantiations spilled.
// (Times in this note: tools/ablate_kernels.py --kernel long on an NVIDIA
// H100 80GB HBM3 at 700 W.)  Every operand tile is d/16 slabs of 128 rows
// of 32 bytes (16 bf16 columns) under the 32-byte swizzle, one TMA box a
// slab: S = Q K^T is d/16 k16 steps, one a slab, and P V one m64n{d}k16 a
// 16-key step with V MN-major across the slabs.  Q and K at d = 80 as a
// 64-column slab under the 128-byte swizzle beside a 16-column one measured
// within 1% of this at every shape (S is not what holds this body), and V
// split the same way (P V an m64n64 beside an m64n16) 0.04-0.07 ms slower,
// the short product costing about what a long one does; neither ships.
// The other TMA maps are 4-D (d, nh, N, B) over the strided q/k/v views,
// rows past N read as zeros.
//
// Blocks run in clusters of two.  A cluster takes two query items of the
// same head side by side, and each K/V tile is loaded once for both: block
// 0 of the cluster loads K, block 1 V, each with TMA multicast into both
// blocks, which halves the 1.5 GB a launch read from L2 at kernel 2's shape
// (loads alone: 0.26 ms, from 0.31-0.34).  A K/V stage is refilled only
// after the consumers of both blocks have released it: each consumer warp
// arrives on its own block's empty barrier and, across the cluster, on its
// peer's, with the plain arrive (release semantics at cluster scope cost
// 0.2-0.3 ms a launch, variant "remote_arrive_release_cluster").  A head
// with an odd number of items leaves the second block of its last pair
// without queries: that block loads no Q, computes and writes nothing (its
// consumers release each K/V tile as it lands), and still loads its half of
// every K/V tile and arrives on every barrier its peer counts.
// A block's producer leaves only once the consumers of both blocks have
// released every stage (a cluster barrier at the end, shared by producer
// and consumers, made ptxas ignore setmaxnreg as named barriers do).  The
// grid is the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), at most one block per SM.
//
// The last wave.  Where it would leave clusters idle (demo-dinov2's N = 1025
// at 6 heads: 30 units for 66 clusters; a sweep crop's 208 units: 3 full
// waves and 10), its units run split into key chunks: whole units for the
// full waves, and the last wave's r units as s = min(8, clusters div r)
// chunks each where that is 2 or more (ops/cuda_kernels.py::long_plan
// decides and passes split0 and s).  A chunk runs the same body over its
// run of K/V tiles and leaves its unnormalised O, row maxima and sums in a
// workspace; the last of a unit's chunks to arrive merges them in the same
// launch (merge_chunks; a second launch would cost 2-4 us, a fifth of the
// N = 1025 row).
//
// Ragged key tails are masked, ragged query tails are not written.  The
// output leaves through shared memory (the warpgroup's own Q rows, dead
// after its last S, in the same swizzled layout) as 16-byte stores of whole
// row segments.
//
// Budget at kernel 2's shape: a Q stage is 20 KB of Q and 28 KB of rel slabs
// (48 KB), a K/V stage 40 KB (whatever RB: a tile of 16 RB keys fills the
// first 16 RB rows of its slabs); 2 + 3 stages take 216 KB of the 227 KB a
// block may use, every stage on 1024 bytes (one Q stage and four K/V stages
// measured 4% slower).  Registers: S 8 RB f32 accumulators a thread (64
// at RB = 8), O d/2, P's fragments RB x 4, the rows' rel_w words 2 RB; the producer warpgroup
// gives its registers to the consumers (setmaxnreg 40 / 232), and ptxas
// uses them (tools/ablate_kernels.py prints the highest register each
// instantiation's SASS reaches).  What holds the body is the softmax and
// its dependence on S (kernel 2's shape: products alone 0.27 ms, loads
// alone 0.26, the whole 0.47).
//
// Precision as the other kernels: f32 logits, softmax statistics and O, P
// rounded to bf16 for P V, bf16 output.  The softmax runs in base 2 (ex2 of
// logits scaled by log2 e), which is the same function; without the bias the
// scale d^-1/2 log2 e and the row maximum are one FFMA per logit (8% faster
// than a multiply by d^-1/2 first, variant "scale_unfolded").

#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int LONG_NT = 384;  // 2 consumer warpgroups + 1 producer warpgroup
// registers per thread after setmaxnreg: a register-file quarter holds one
// warp of each warpgroup, 2 x 232 + 40 <= 512 per lane
constexpr int LONG_CONSUMER_REGS = 232, LONG_PRODUCER_REGS = 40;
constexpr int TQ = 128;  // query rows per item, 64 per consumer warpgroup
constexpr int TK = 128;  // keys per K/V tile
constexpr int MAX_Q_STAGES = 2, MAX_KV_STAGES = 4;
// blocks per cluster: the query items of one head side by side, each K/V
// tile loaded once for all of them by TMA multicast
constexpr int LONG_CLUSTER = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t SLAB = TQ * SLAB_ROW;  // one 16-column slab of an operand tile (TQ = TK rows)

// the bias's layout: none, gathered per logit, or whole key rows (two a K/V
// tile, each padded to a multiple of 8 slots, at most ROW_SLOTS) with
// per-thread rel_w words
enum Bias { NO_BIAS = 0, GATHER = 1, ROWS = 2 };
constexpr int ROW_SLOTS = TK / 2;

// The layout of an hk x wk grid (hk = 0: no bias): whole key rows where a
// row fills more than half of ROW_SLOTS, else gathered.
int bias_layout(int hk, int wk) { return hk == 0 ? NO_BIAS : wk > ROW_SLOTS / 2 && wk <= ROW_SLOTS ? ROWS : GATHER; }
// ROWS: the 8-slot blocks of a key row, wk padded to a multiple of 8 (RB)
int row_blocks(int wk) { return (wk + 7) / 8; }

struct LongArgs {
  const __nv_bfloat16* rel_h;  // (B, nh, N, hk), contiguous
  const __nv_bfloat16* rel_w;  // (B, nh, N, wk)
  __nv_bfloat16* out;          // (B, N, nh * d)
  int B, N, nh, hk, wk;
  int rel_bulk;  // the rel slabs start and end on 16 bytes: 1-D bulk copies
  int q_stages, kv_stages;
  int q_stage_bytes, kv_stage_bytes;  // multiples of 1024
  int rh_alloc;                       // bytes of an item's rel_h slab, a multiple of 16
  // blocks per cluster, LONG_CLUSTER, read here by every instantiation but
  // the bias-free d = 80 one: the constant made ptxas spill 16 bytes in five
  // bias instantiations and slowed the bias-free d = 32 and 64 ones
  int cluster;
  float scale;                        // d^-1/2
  // the last wave's plan: units from tail.split0 on run as tail.pieces key
  // chunks each (pieces = 1: none split); each chunk's partials go to
  // `work`, and the last to arrive of a unit's chunks, per consumer warp,
  // merges them (`counters`: arrivals per tail unit, block of the cluster
  // and consumer warp, 0 between launches)
  TailPlan tail;
  float* work;
  int* counters;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared-memory loads by 32-bit address (a generic pointer takes two registers)
__device__ __forceinline__ float lds_bf16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return __uint_as_float((uint32_t)v << 16);
}

// rel_h of key row kh from its staged entry at `at`, or -inf where kh is
// past hk: a load predicated in one asm statement, which measured faster
// than a select of -inf after the load and than an instantiation of its own
// for odd hk that left the other grids' tiles unmasked (which read 4-7%
// slower: ptxas schedules that body worse)
__device__ __forceinline__ float lds_rel_h(uint32_t at, int kh, int hk) {
  uint32_t v;
  asm volatile(
      "{\n.reg .pred p;\n.reg .b16 h, z;\nmov.b16 h, 0xff80;\nmov.b16 z, 0;\nsetp.lt.s32 p, %2, %3;\n"
      "@p ld.shared.u16 h, [%1];\nmov.b32 %0, {z, h};\n}\n"
      : "=r"(v)
      : "r"(at), "r"(kh), "r"(hk)
      : "memory");
  return __uint_as_float(v);
}

// rel_w of slots kw = 2t + KW0 and kw + 1 of a staged row as a bf16 pair,
// -inf (0xff80) in a slot past wk; `at` is the shared address of slot 2t.
// One asm statement: written in C++, the compiler hoisted each slot's
// compare out of the item loop and held them across it, 13-22 registers
// more (variant "rel_w_pad_in_cxx").
template <int KW0>
__device__ __forceinline__ uint32_t rel_w_pair(uint32_t at, int t2, int wk) {
  uint32_t v;
  asm volatile(
      "{\n.reg .pred p, q;\n.reg .b32 kw;\n.reg .b16 lo, hi;\n"
      "add.s32 kw, %2, %4;\nsetp.lt.s32 p, kw, %3;\nadd.s32 kw, kw, 1;\nsetp.lt.s32 q, kw, %3;\n"
      "mov.b16 lo, 0xff80;\nmov.b16 hi, 0xff80;\n"
      "@p ld.shared.u16 lo, [%1+%5];\n@q ld.shared.u16 hi, [%1+%6];\n"
      "mov.b32 %0, {lo, hi};\n}\n"
      : "=r"(v)
      : "r"(at), "r"(t2), "r"(wk), "n"(KW0), "n"(2 * KW0), "n"(2 * KW0 + 2)
      : "memory");
  return v;
}

// this thread's rel_w words of an item (rows r0 and r1 from their slot 2t
// at at0 and at1): slots 8 cb + 2t, +1 in w[cb] and w[8 + cb], cb < RB
template <int RB, int CB = 0>
__device__ __forceinline__ void load_rel_w(uint32_t (&w)[16], uint32_t at0, uint32_t at1, int t2, int wk) {
  if constexpr (CB < RB) {
    w[CB] = rel_w_pair<8 * CB>(at0, t2, wk);
    w[8 + CB] = rel_w_pair<8 * CB>(at1, t2, wk);
    load_rel_w<RB, CB + 1>(w, at0, at1, t2, wk);
  }
}

// One operand tile (rows row0 .. row0 + 127 of head h in frame b) by TMA
// into its d/16 slabs at dst, completing on bar; multicast to the blocks of
// the cluster in `mask` (0: this block alone).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row0, int h,
                                          int b, uint16_t mask) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if (mask) tma_load_4d_multicast(dst + j * SLAB, map, bar, mask, 16 * j, h, row0, b);
    else tma_load_4d(dst + j * SLAB, map, bar, 16 * j, h, row0, b);
  }
}

// K/V tile kt: keys kt * 128 .. kt * 128 + 127 by the 4-D map, or (ROWS) key
// rows 2 kt and 2 kt + 1 by the 5-D map, each at slots 0-63 of its half
template <int D, int BIAS>
__device__ __forceinline__ void load_kv_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int kt, int h,
                                             int b, uint16_t mask) {
  if constexpr (BIAS == ROWS) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (mask) tma_load_5d_multicast(dst + j * SLAB, map, bar, mask, 16 * j, h, 0, 2 * kt, b);
      else tma_load_5d(dst + j * SLAB, map, bar, 16 * j, h, 0, 2 * kt, b);
    }
  } else {
    load_tile<D>(dst, map, bar, kt * TK, h, b, mask);
  }
}

// The byte offset of 16-byte chunk ch (columns 8 ch .. 8 ch + 7) of row r in
// an operand tile, where TMA's 32-byte swizzle puts it: chunk (ch mod 2) xor
// (r / 4 mod 2) of the row in slab ch / 2.
__device__ __forceinline__ uint32_t chunk_offset(int r, int ch) {
  return (ch >> 1) * SLAB + r * SLAB_ROW + (((ch & 1) ^ ((r >> 2) & 1)) << 4);
}

// The online softmax of one K/V tile (2 RB blocks of 8 keys: 128 keys, or
// with ROWS two key rows of 8 RB slots) for this thread's rows r0 and r1
// (rows rr0, rr1 of the staged rel slabs): the logits x = s * scale + bias
// become the weights p = 2^((x - m) log2 e) in s, m (the row maxima of x) and
// l (this thread's part of the row sums) are updated, and corr gets the
// factor by which O must be rescaled.  Without the bias, m holds the maxima
// of s itself and p = 2^(s k2 - m k2) with k2 = scale log2 e: one FFMA a
// logit.  Accumulator layout of m64n{16 RB}:
// s[4 * blk + {0, 1}] are row r0's keys 8 blk + 2t + {0, 1}, s[4 * blk +
// {2, 3}] row r1's.  rh0 and rh1 are the shared addresses of the two rows'
// rel_h entries, rw0 and rw1 of their rel_w entries; ROWS holds its rel_w
// values instead in registers, as the words w (bf16 pairs: row r0's slots
// 8i + 2t, +1 in w[i], row r1's in w[8 + i], i < RB), and reads k0 (tile
// kt's kt * 128) as key rows from k0 / 64.
template <int BIAS, int RB>
__device__ __forceinline__ void softmax_tile(float (&s)[8 * RB], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             uint32_t rh0, uint32_t rh1, uint32_t rw0, uint32_t rw1,
                                             const uint32_t (&w)[16], int k0, int N, int hk, int wk, int t,
                                             float c) {
  const float k2 = BIAS == NO_BIAS ? c * LOG2E : LOG2E;  // the exponent's scale of m's units
  float off[2][2];  // row maxima, less rel_h of the tile's first and second key row (ROWS)
  float mx0, mx1;
  if constexpr (BIAS == ROWS) {
    // the tile is key rows kh0 and kh0 + 1; a second row past hk (the last
    // tile of an odd hk) gets rel_h -inf, so its offset below is -inf and
    // its weights 0
    const int kh0 = k0 / ROW_SLOTS;
    const float h00 = lds_bf16(rh0 + 2 * kh0), h10 = lds_bf16(rh1 + 2 * kh0);
    const float h01 = lds_rel_h(rh0 + 2 * kh0 + 2, kh0 + 1, hk), h11 = lds_rel_h(rh1 + 2 * kh0 + 2, kh0 + 1, hk);
    float mh[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int cb = 0; cb < RB; ++cb) {
      const uint32_t w0 = w[cb], w1 = w[8 + cb];
      const float b00 = __uint_as_float(w0 << 16), b01 = __uint_as_float(w0 & 0xffff0000u);
      const float b10 = __uint_as_float(w1 << 16), b11 = __uint_as_float(w1 & 0xffff0000u);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* e = &s[4 * (RB * half + cb)];
        e[0] = fmaf(e[0], c, b00);
        e[1] = fmaf(e[1], c, b01);
        e[2] = fmaf(e[2], c, b10);
        e[3] = fmaf(e[3], c, b11);
      }
    }
#pragma unroll
    for (int blk = 0; blk < 2 * RB; ++blk) {
      const float* e = &s[4 * blk];
      mh[0][blk / RB] = fmaxf(mh[0][blk / RB], fmaxf(e[0], e[1]));
      mh[1][blk / RB] = fmaxf(mh[1][blk / RB], fmaxf(e[2], e[3]));
    }
    mx0 = fmaxf(mh[0][0] + h00, mh[0][1] + h01);
    mx1 = fmaxf(mh[1][0] + h10, mh[1][1] + h11);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    mx0 = fmaxf(m[0], mx0);
    mx1 = fmaxf(m[1], mx1);
    off[0][0] = mx0 - h00, off[0][1] = mx0 - h01;
    off[1][0] = mx1 - h10, off[1][1] = mx1 - h11;
  } else {
    // masked as the maxima are taken (a separate pass spilled with the
    // gathered bias and slowed the bias-free d 32 and 64)
    const bool ragged = k0 + TK > N;
    mx0 = -INFINITY, mx1 = -INFINITY;
    // GATHER: (kh, kw) of this thread's first key, then walked 8 keys (dkh
    // rows and dkw slots) a column block
    int kh = 0, kw = 0, dkh = 0, dkw = 0;
    if constexpr (BIAS == GATHER) {
      kh = (k0 + 2 * t) / wk, kw = k0 + 2 * t - kh * wk;
      dkh = 8 / wk, dkw = 8 - dkh * wk;
    }
#pragma unroll
    for (int blk = 0; blk < 2 * RB; ++blk) {
      float* e = &s[4 * blk];
      const int key = k0 + 8 * blk + 2 * t;
      if constexpr (BIAS == GATHER) {
        int kh1 = kh, kw1 = kw + 1;
        if (kw1 == wk) kw1 = 0, ++kh1;
        const int ch = min(kh, hk - 1), ch1 = min(kh1, hk - 1);
        e[0] = fmaf(e[0], c, lds_bf16(rh0 + 2 * ch) + lds_bf16(rw0 + 2 * kw));
        e[1] = fmaf(e[1], c, lds_bf16(rh0 + 2 * ch1) + lds_bf16(rw0 + 2 * kw1));
        e[2] = fmaf(e[2], c, lds_bf16(rh1 + 2 * ch) + lds_bf16(rw1 + 2 * kw));
        e[3] = fmaf(e[3], c, lds_bf16(rh1 + 2 * ch1) + lds_bf16(rw1 + 2 * kw1));
        kh += dkh, kw += dkw;
        if (kw >= wk) kw -= wk, ++kh;
      }
      if (ragged) {
        if (key >= N) e[0] = e[2] = -INFINITY;
        if (key + 1 >= N) e[1] = e[3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(e[0], e[1]));
      mx1 = fmaxf(mx1, fmaxf(e[2], e[3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    mx0 = fmaxf(m[0], mx0);
    mx1 = fmaxf(m[1], mx1);
    off[0][0] = off[0][1] = mx0;
    off[1][0] = off[1][1] = mx1;
  }
  // every tile holds a live key, so the new maxima are finite; the first
  // tile's corr is 2^-inf = 0
  corr[0] = ex2((m[0] - mx0) * k2);
  corr[1] = ex2((m[1] - mx1) * k2);
  m[0] = mx0;
  m[1] = mx1;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half) off[r][half] *= -k2;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int blk = 0; blk < 2 * RB; ++blk) {
    float* e = &s[4 * blk];
    const int half = blk / RB;
    e[0] = ex2(fmaf(e[0], k2, off[0][half]));
    e[1] = ex2(fmaf(e[1], k2, off[0][half]));
    e[2] = ex2(fmaf(e[2], k2, off[1][half]));
    e[3] = ex2(fmaf(e[3], k2, off[1][half]));
    ls0 += e[0] + e[1];
    ls1 += e[2] + e[3];
  }
  l[0] = l[0] * corr[0] + ls0;
  l[1] = l[1] * corr[1] + ls1;
}

// P as bf16 A fragments of the RB k-steps of P V (k-step j: n-blocks 2j, 2j + 1)
template <int RB>
__device__ __forceinline__ void pack_p(const float (&s)[8 * RB], uint32_t (&pf)[RB][4]) {
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// A key chunk's partials of a split unit, per (tail unit, chunk, block of the
// cluster, consumer warp): D/2 + 4 words a lane, lane-minor (128-byte
// stores and loads a word): O's D/2 accumulators unnormalised, then the
// two rows' maxima in the exponent's base-2 units (m k2) and their sums.
// The warp stores its chunk's partial and arrives on its counter; the last
// chunk's warp to arrive merges every chunk's in chunk order (so the output
// is the same from launch to launch whichever arrives last):
//   M = max_i m_i,  O = sum_i 2^(m_i - M) O_i,  l = sum_i 2^(m_i - M) l_i,
// a chunk with m_i = -inf weighing 0, and resets the counter for the next
// launch.  Per warp and not per warpgroup: a barrier shared by the two
// consumer warpgroups makes ptxas ignore setmaxnreg (see above).  Returns
// whether this warp merged (o, l0, l1 then hold the unit's whole rows).
template <int D>
__device__ __forceinline__ bool merge_chunks(float (&o)[D / 2], const float (&m)[2], float& l0, float& l1, float k2,
                                             float* work, int* counters, int pieces, int tu, int chunk, int rank,
                                             int cl, int cw, int lane) {
  constexpr int W = D / 2 + 4;
  const int64_t chunk_stride = (int64_t)cl * 8 * W * 32;
  float* const first = work + (((int64_t)tu * pieces * cl + rank) * 8 + cw) * W * 32 + lane;
  float* const mine = first + chunk * chunk_stride;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) __stcg(mine + 32 * i, o[i]);
  __stcg(mine + 32 * (D / 2), m[0] * k2);
  __stcg(mine + 32 * (D / 2 + 1), m[1] * k2);
  __stcg(mine + 32 * (D / 2 + 2), l0);
  __stcg(mine + 32 * (D / 2 + 3), l1);
  __threadfence();
  __syncwarp();
  int* const count = counters + ((int64_t)tu * cl + rank) * 8 + cw;
  int last = 0;
  if (lane == 0) last = atomicAdd(count, 1) == pieces - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return false;
  __threadfence();
  float M0 = -INFINITY, M1 = -INFINITY;
  for (int ch = 0; ch < pieces; ++ch) {
    M0 = fmaxf(M0, __ldcg(first + ch * chunk_stride + 32 * (D / 2)));
    M1 = fmaxf(M1, __ldcg(first + ch * chunk_stride + 32 * (D / 2 + 1)));
  }
  // a row with no live key in any chunk (a query row past N, not written)
  if (M0 == -INFINITY) M0 = 0.f;
  if (M1 == -INFINITY) M1 = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  l0 = l1 = 0.f;
  for (int ch = 0; ch < pieces; ++ch) {
    const float* p = first + ch * chunk_stride;
    const float w0 = ex2(__ldcg(p + 32 * (D / 2)) - M0), w1 = ex2(__ldcg(p + 32 * (D / 2 + 1)) - M1);
    l0 = fmaf(w0, __ldcg(p + 32 * (D / 2 + 2)), l0);
    l1 = fmaf(w1, __ldcg(p + 32 * (D / 2 + 3)), l1);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      o[i] = fmaf(w0, __ldcg(p + 32 * i), o[i]);
      o[i + 1] = fmaf(w0, __ldcg(p + 32 * (i + 1)), o[i + 1]);
      o[i + 2] = fmaf(w1, __ldcg(p + 32 * (i + 2)), o[i + 2]);
      o[i + 3] = fmaf(w1, __ldcg(p + 32 * (i + 3)), o[i + 3]);
    }
  }
  if (lane == 0) *count = 0;
  return true;
}

// Shared memory: q_stages Q stages (an item's Q tile, then its rel_h and
// rel_w rows, [row][hk] and [row][wk] bf16), then kv_stages K/V stages (K's
// tile then V's), then the mbarriers: Q full / empty, K/V full / empty.  A
// tile is D/16 slabs of 128 rows x 32 B.  A unit is (b * nh + h, pair of
// 128-query tiles), numbered head-major; cluster i takes work items i, i +
// clusters, ..., and its block of rank r the unit's tile r.  A work item is
// a unit below a.tail.split0 and one of a unit's a.tail.pieces key chunks
// from it on (piece_of); both blocks of a cluster take the same chunk.
template <int D, int BIAS, int RB>
__global__ void __launch_bounds__(LONG_NT, 1)
    attn_long_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const LongArgs a) {
  constexpr int DK = D / 16;  // k-steps of S, slabs per operand tile
  constexpr int DB = D / 8;   // 8-column blocks of O, 16-byte chunks of an output row
  constexpr uint32_t tile = DK * SLAB;
  constexpr uint32_t kv_tx = 2 * DK * 16 * RB * SLAB_ROW;  // the bytes of a K and a V tile (2 tile at RB = 8)
  constexpr uint32_t rel_off = tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t kv_base = base + (uint32_t)(a.q_stages * a.q_stage_bytes);
  const uint32_t bars = kv_base + (uint32_t)(a.kv_stages * a.kv_stage_bytes);
  auto q_full = [&](int s) { return bars + 8u * s; };
  auto q_empty = [&](int s) { return bars + 8u * (MAX_Q_STAGES + s); };
  auto kv_full = [&](int s) { return bars + 8u * (2 * MAX_Q_STAGES + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (2 * MAX_Q_STAGES + MAX_KV_STAGES + s); };
  // the cluster size: the constant in the bias-free d = 80 instantiation (6%
  // faster there; 11% slower at d = 64, variant "cluster_constant"), read
  // from LongArgs in the others (variant "cluster_at_run_time")
  const int N = a.N, nh = a.nh, cl = BIAS == NO_BIAS && D == 80 ? LONG_CLUSTER : a.cluster;
  // K/V tiles: two key rows each (ROWS), else 128 keys
  const int ntq = (N + TQ - 1) / TQ, nkt = BIAS == ROWS ? (a.hk + 1) / 2 : (N + TK - 1) / TK;
  const int per_head = (ntq + cl - 1) / cl;  // units of a head
  const int rank = (int)cluster_ctarank();
  const int unit0 = blockIdx.x / cl, units_step = gridDim.x / cl;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the rel slabs that do not start and end on 16 bytes: plain copies by a
  // warp of their own, which arrives on q_full beside the TMA warp's
  const bool plain_rel = BIAS != NO_BIAS && !a.rel_bulk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.q_stages; ++s) {
      mbar_init(q_full(s), plain_rel ? 2 : 1);
      mbar_init(q_empty(s), 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < a.kv_stages; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 8 * cl);  // one arrival per consumer warp of every block the stage feeds
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's barriers are set before any multicast or arrival reaches them
  cluster_sync();

  if (warp >= 8) {
    // producer warpgroup: hands its registers to the consumers; one warp
    // works, and its lane 0 issues the copies (a second copies the rel
    // slabs where TMA cannot: done by the first, with the piece decode, the
    // copy loops took more than its 40 registers and every bias
    // instantiation spilled 16-32 bytes; without their unrolling a 20 x 55
    // grid, whose rel_w slabs sit off 16 bytes, read 3.5x slower)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LONG_PRODUCER_REGS));
    if (warp > 9 || (warp == 9 && !plain_rel)) return;
    if (warp == 9) {
      int it = 0;
      for (int wi = unit0; wi < a.tail.n_work; wi += units_step, ++it) {
        const int unit = piece_of(wi, a.tail, nkt).item;
        const int bh = unit / per_head, q0 = ((unit - bh * per_head) * cl + rank) * TQ;
        const int rows = max(0, min(TQ, N - q0));
        const int qs = it % a.q_stages;
        mbar_wait(q_empty(qs), ((uint32_t)(it / a.q_stages) & 1u) ^ 1u);
        const __nv_bfloat16* rh = a.rel_h + ((int64_t)bh * N + q0) * a.hk;
        const __nv_bfloat16* rw = a.rel_w + ((int64_t)bh * N + q0) * a.wk;
        __nv_bfloat16* dh = reinterpret_cast<__nv_bfloat16*>(gbase + qs * a.q_stage_bytes + rel_off);
        __nv_bfloat16* dw = reinterpret_cast<__nv_bfloat16*>(gbase + qs * a.q_stage_bytes + rel_off + a.rh_alloc);
        for (int e = lane; e < rows * a.hk; e += 32) dh[e] = rh[e];
        for (int e = lane; e < rows * a.wk; e += 32) dw[e] = rw[e];
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(q_full(qs));
      }
      return;
    }
    // in a cluster, block 0 loads K and block 1 V, each into both blocks
    const uint16_t mask = cl > 1 ? (uint16_t)((1u << cl) - 1u) : (uint16_t)0;
    int kv_i = 0, it = 0;
    for (int wi = unit0; wi < a.tail.n_work; wi += units_step, ++it) {
      const int unit = piece_of(wi, a.tail, nkt).item;
      const int bh = unit / per_head, q0 = ((unit - bh * per_head) * cl + rank) * TQ;
      const int b = bh / nh, h = bh - b * nh;
      const int rows = max(0, min(TQ, N - q0));  // 0: no queries (the second half of a head's last pair)
      const int qs = it % a.q_stages;
      mbar_wait(q_empty(qs), ((uint32_t)(it / a.q_stages) & 1u) ^ 1u);
      const uint32_t st = base + (uint32_t)(qs * a.q_stage_bytes);
      uint32_t tx = rows > 0 ? tile : 0u;
      if (BIAS != NO_BIAS && !plain_rel) {
        const __nv_bfloat16* rh = a.rel_h + ((int64_t)bh * N + q0) * a.hk;
        const __nv_bfloat16* rw = a.rel_w + ((int64_t)bh * N + q0) * a.wk;
        const uint32_t rh_bytes = (uint32_t)(rows * a.hk * 2), rw_bytes = (uint32_t)(rows * a.wk * 2);
        tx += rh_bytes + rw_bytes;
        if (lane == 0) {
          mbar_arrive_expect_tx(q_full(qs), tx);
          if (rows > 0) {
            bulk_load(st + rel_off, rh, rh_bytes, q_full(qs));
            bulk_load(st + rel_off + a.rh_alloc, rw, rw_bytes, q_full(qs));
          }
        }
      } else if (lane == 0) {  // no bias, or the rel slabs copied by warp 9
        mbar_arrive_expect_tx(q_full(qs), tx);
      }
      if (lane == 0 && rows > 0) load_tile<D>(st, &tq, q_full(qs), q0, h, b, 0);
      // the piece's K/V tiles, decoded again here from a copy of wi the
      // compiler cannot see through: decoded with the unit and held from
      // there, the square grid's launch read 4.5% slower in turns (variant
      // "decode_once")
      int w = wi;
      asm volatile("" : "+r"(w));
      const Piece p = piece_of(w, a.tail, nkt);
      for (int kt = p.lo; kt < p.hi; ++kt, ++kv_i) {
        const int s = kv_i % a.kv_stages;
        mbar_wait(kv_empty(s), ((uint32_t)(kv_i / a.kv_stages) & 1u) ^ 1u);
        if (lane == 0) {
          const uint32_t ks = kv_base + (uint32_t)(s * a.kv_stage_bytes);
          mbar_arrive_expect_tx(kv_full(s), kv_tx);  // K and V, whichever block loads them
          if (rank == 0) load_kv_tile<D, BIAS>(ks, &tk, kv_full(s), kt, h, b, mask);
          if (rank == cl - 1) load_kv_tile<D, BIAS>(ks + tile, &tv, kv_full(s), kt, h, b, mask);
        }
      }
      __syncwarp();
    }
    // the tail: until the consumers of both blocks have released every
    // stage, so that no arrival from the peer reaches this block after it
    // leaves (its own consumers wait for every multicast into it)
    for (int i = 0; i < a.kv_stages; ++i, ++kv_i)
      mbar_wait(kv_empty(kv_i % a.kv_stages), ((uint32_t)(kv_i / a.kv_stages) & 1u) ^ 1u);
  } else {
    // consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(LONG_CONSUMER_REGS));
    const int wg = warp >> 2, tw = threadIdx.x & 127, wq = tw >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int lr0 = wg * 64 + wq * 16 + g, lr1 = lr0 + 8;  // this thread's two rows of an item
    const int64_t C = (int64_t)nh * D;
    const float c = a.scale;

    float sacc[8 * RB];
#pragma unroll
    for (int i = 0; i < 8 * RB; ++i) sacc[i] = 0.f;
    float oacc[D / 2];
    uint32_t pf[RB][4];
    uint32_t w[16];  // ROWS: this thread's rel_w words of the item
    // a K/V stage is free once this block's and the peer's consumers are done with it
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(kv_empty(s));
        if (cl > 1) mbar_arrive_cluster(kv_empty(s), (uint32_t)(rank ^ 1));
      }
    };
    int kv_i = 0, it = 0;
    for (int wi = unit0; wi < a.tail.n_work; wi += units_step, ++it) {
      const Piece p = piece_of(wi, a.tail, nkt);
      const int bh = p.item / per_head, q0 = ((p.item - bh * per_head) * cl + rank) * TQ;
      const int b = bh / nh, h = bh - b * nh;
      const int qs = it % a.q_stages;
      mbar_wait(q_full(qs), (uint32_t)(it / a.q_stages) & 1u);
      const int rows = min(TQ, N - q0);
      if (rows <= 0) {
        // no queries (the second half of a head's last pair): each K/V tile
        // is released as it lands, for the peer's producer
        for (int kt = p.lo; kt < p.hi; ++kt, ++kv_i) {
          const int s = kv_i % a.kv_stages;
          mbar_wait(kv_full(s), (uint32_t)(kv_i / a.kv_stages) & 1u);
          release(s);
        }
        if (tw == 0) mbar_arrive(q_empty(qs));
        continue;
      }
      const uint32_t qst = base + (uint32_t)(qs * a.q_stage_bytes);
      const uint32_t Qs = qst + wg * 64 * SLAB_ROW;
      unsigned char* qg = gbase + (qs * a.q_stage_bytes);
      // the shared addresses of rows r0 and r1 of the item's rel_h and rel_w
      // slabs; rows past N read the last row's (GATHER; ROWS reads its own
      // rows, whatever they hold: those rows are not written)
      const int rr0 = BIAS == ROWS ? lr0 : min(lr0, rows - 1), rr1 = BIAS == ROWS ? lr1 : min(lr1, rows - 1);
      const uint32_t rh_s = qst + rel_off, rw_s = rh_s + a.rh_alloc;
      const uint32_t rh0 = rh_s + 2 * rr0 * a.hk, rh1 = rh_s + 2 * rr1 * a.hk;
      const uint32_t rw0 = rw_s + 2 * rr0 * a.wk, rw1 = rw_s + 2 * rr1 * a.wk;
      if constexpr (BIAS == ROWS) {
        // the 16 rel_w words this thread's accumulator columns read in every
        // tile, held in registers for the item
        load_rel_w<RB>(w, rw0 + 4 * t, rw1 + 4 * t, 2 * t, a.wk);
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

      // S = Q K^T: one k16 step a slab
      auto issue_s = [&](uint32_t Ks) {
#pragma unroll
        for (int ks = 0; ks < DK; ++ks)
          wgmma_ss<16 * RB>(sacc, desc_b32(Qs + ks * SLAB, 16), desc_b32(Ks + ks * SLAB, 16), ks > 0);
        wgmma_commit();
      };
      // O += P V: one m64n{D}k16 a 16-key step, V MN-major across the slabs
      auto issue_pv = [&](uint32_t Vs) {
#pragma unroll
        for (int j = 0; j < RB; ++j) wgmma_rs<D>(oacc, pf[j], desc_b32(Vs + j * 16 * SLAB_ROW, SLAB), 1);
        wgmma_commit();
      };

      // the first tile: S alone
      int s = kv_i % a.kv_stages;
      mbar_wait(kv_full(s), (uint32_t)(kv_i / a.kv_stages) & 1u);
      fence_regs(sacc);
      wgmma_fence();
      issue_s(kv_base + (uint32_t)(s * a.kv_stage_bytes));
      wgmma_wait0();
      fence_regs(sacc);
      softmax_tile<BIAS, RB>(sacc, m, l, corr, rh0, rh1, rw0, rw1, w, p.lo * TK, N, a.hk, a.wk, t, c);
      pack_p<RB>(sacc, pf);

      // tile kt: S of kt and P V of kt - 1 issued together; the softmax of
      // kt runs while P V does
      for (int kt = p.lo + 1; kt < p.hi; ++kt) {
        const int sp = s;
        ++kv_i;
        s = kv_i % a.kv_stages;
        mbar_wait(kv_full(s), (uint32_t)(kv_i / a.kv_stages) & 1u);
        fence_regs(sacc);
        fence_regs(oacc);
        fence_regs(pf);
        wgmma_fence();
        issue_s(kv_base + (uint32_t)(s * a.kv_stage_bytes));
        issue_pv(kv_base + (uint32_t)(sp * a.kv_stage_bytes) + tile);
        wgmma_wait1();
        fence_regs(sacc);
        softmax_tile<BIAS, RB>(sacc, m, l, corr, rh0, rh1, rw0, rw1, w, kt * TK, N, a.hk, a.wk, t, c);
        wgmma_wait0();
        fence_regs(oacc);
        fence_regs(pf);
        release(sp);
#pragma unroll
        for (int i = 0; i < D / 2; i += 4) {
          oacc[i] *= corr[0];
          oacc[i + 1] *= corr[0];
          oacc[i + 2] *= corr[1];
          oacc[i + 3] *= corr[1];
        }
        pack_p<RB>(sacc, pf);
      }

      // P V of the last tile
      fence_regs(oacc);
      fence_regs(pf);
      wgmma_fence();
      issue_pv(kv_base + (uint32_t)(s * a.kv_stage_bytes) + tile);
      wgmma_wait0();
      fence_regs(oacc);
      fence_regs(pf);
      release(s);
      ++kv_i;

      // epilogue: normalise, stage the rows in this warpgroup's own Q rows
      // (dead since its last S) in the tile's swizzled layout, then 16-byte
      // stores of whole row segments: the warpgroup's 64 rows, or, for a
      // key chunk of a split unit, the 16 rows of each warp that merged
      float l0 = l[0], l1 = l[1];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      }
      const bool split = p.item >= a.tail.split0;
      const bool merged =
          split && merge_chunks<D>(oacc, m, l0, l1, BIAS == NO_BIAS ? c * LOG2E : LOG2E, a.work, a.counters,
                                   a.tail.pieces, p.item - a.tail.split0, p.part, rank, cl, warp, lane);
      if (!split || merged) {
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
        for (int nb = 0; nb < DB; ++nb) {
          *reinterpret_cast<uint32_t*>(qg + chunk_offset(lr0, nb) + 4 * t) =
              pack_bf16(oacc[4 * nb] * inv0, oacc[4 * nb + 1] * inv0);
          *reinterpret_cast<uint32_t*>(qg + chunk_offset(lr1, nb) + 4 * t) =
              pack_bf16(oacc[4 * nb + 2] * inv1, oacc[4 * nb + 3] * inv1);
        }
      }
      if (!split) {
        bar_sync_wg(1 + wg);
        for (int e = tw; e < 64 * DB; e += 128) {
          const int r = wg * 64 + e / DB, ch = e % DB, n = q0 + r;
          if (n >= N) break;
          const uint4 v = *reinterpret_cast<const uint4*>(qg + chunk_offset(r, ch));
          *reinterpret_cast<uint4*>(a.out + ((int64_t)b * N + n) * C + (int64_t)h * D + ch * 8) = v;
        }
      } else if (merged) {
        __syncwarp();
        for (int e = lane; e < 16 * DB; e += 32) {
          const int r = wg * 64 + wq * 16 + e / DB, ch = e % DB, n = q0 + r;
          if (n >= N) break;
          const uint4 v = *reinterpret_cast<const uint4*>(qg + chunk_offset(r, ch));
          *reinterpret_cast<uint4*>(a.out + ((int64_t)b * N + n) * C + (int64_t)h * D + ch * 8) = v;
        }
      }
      // the stage's generic reads and writes before the producer's next TMA
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync_wg(1 + wg);
      if (tw == 0) mbar_arrive(q_empty(qs));
    }
  }
}

// The shared-memory layout at head dim d with an hk x wk bias grid (0 x 0: no
// bias): the Q stage (an item's Q slabs and rel rows, in 1024-byte units) and
// K/V stage sizes, and the most Q stages, then K/V stages, that fit in
// SMEM_LIMIT beside the alignment slack and the mbarriers. Returns the dynamic
// shared memory in bytes, or 0 when not even one Q and two K/V stages fit.
int long_layout(int d, int hk, int wk, LongArgs* a) {
  const int tile = d / 16 * (int)SLAB;
  a->rh_alloc = hk > 0 ? (TQ * hk * 2 + 15) / 16 * 16 : 0;
  const int rw_alloc = wk > 0 ? (TQ * wk * 2 + 15) / 16 * 16 : 0;
  a->q_stage_bytes = (tile + a->rh_alloc + rw_alloc + 1023) / 1024 * 1024;
  a->kv_stage_bytes = 2 * tile;
  a->cluster = LONG_CLUSTER;
  const int fixed = 1024 + 16 * (MAX_Q_STAGES + MAX_KV_STAGES);
  a->q_stages = a->kv_stages = 0;
  for (int qs = MAX_Q_STAGES; qs >= 1 && a->q_stages == 0; --qs)
    for (int kvs = MAX_KV_STAGES; kvs >= 2; --kvs)
      if (qs * a->q_stage_bytes + kvs * a->kv_stage_bytes + fixed <= SMEM_LIMIT) {
        a->q_stages = qs, a->kv_stages = kvs;
        break;
      }
  return a->q_stages == 0 ? 0 : a->q_stages * a->q_stage_bytes + a->kv_stages * a->kv_stage_bytes + fixed;
}

// The launch configuration of the long kernel: `grid` blocks in clusters of
// LONG_CLUSTER, `smem` bytes of shared memory each.
cudaLaunchConfig_t long_config(int grid, int smem, cudaStream_t stream, cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = LONG_CLUSTER;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(LONG_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of LONG_CLUSTER blocks with `smem` bytes each that the card
// holds at once (cudaOccupancyMaxActiveClusters: a cluster's blocks share a
// GPC), the persistent grid's size; 0 on an error.  Asked once per device,
// layout and instantiation.
template <int D, int BIAS, int RB>
int resident_clusters(int smem) {
  static int key_dev = -1, key_smem = -1, clusters = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != key_dev || smem != key_smem) {
    if (cudaFuncSetAttribute(attn_long_kernel<D, BIAS, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess)
      return 0;
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = long_config(LONG_CLUSTER, smem, nullptr, &cluster);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(attn_long_kernel<D, BIAS, RB>), &cfg) !=
        cudaSuccess)
      return 0;
    key_dev = dev, key_smem = smem, clusters = n;
  }
  return clusters;
}

// A 5-D (d, nh, wk, hk, B) map over a (B, N, nh, d) K or V view on the hk x
// wk key grid; boxes of 16 columns x 1 head x two key rows of 8 RB slots,
// slots past wk and rows past hk read as zeros.
template <int D, int RB>
bool make_rows_map(CUtensorMap* map, const View& x, const LongArgs& a) {
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)a.nh, (cuuint64_t)a.wk, (cuuint64_t)a.hk,
                              (cuuint64_t)a.B};
  const cuuint64_t strides[4] = {(cuuint64_t)x.sh * 2, (cuuint64_t)x.sn * 2, (cuuint64_t)(x.sn * a.wk) * 2,
                                 (cuuint64_t)x.sb * 2};
  const cuuint32_t box[5] = {16, 1, 8 * RB, 2, 1};
  return encode_map(map, x.ptr, 5, dims, strides, box);
}

template <int D, int BIAS, int RB>
cudaError_t launch_long_d(const View& q, const View& k, const View& v, LongArgs a, cudaStream_t stream) {
  const int N = a.N;
  const int smem = long_layout(D, BIAS != NO_BIAS ? a.hk : 0, BIAS != NO_BIAS ? a.wk : 0, &a);
  if (smem == 0) return cudaErrorInvalidValue;
  if (BIAS != NO_BIAS) {
    const uintptr_t p = (uintptr_t)a.rel_h | (uintptr_t)a.rel_w;
    a.rel_bulk = p % 16 == 0 && ((int64_t)N * a.hk * 2) % 16 == 0 && ((int64_t)N * a.wk * 2) % 16 == 0;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q.ptr, q.sb, q.sn, q.sh, a.B, N, a.nh, D, TQ)) return cudaErrorInvalidValue;
  if constexpr (BIAS == ROWS) {
    if (!make_rows_map<D, RB>(&tk, k, a) || !make_rows_map<D, RB>(&tv, v, a)) return cudaErrorInvalidValue;
  } else if (!make_map(&tk, k.ptr, k.sb, k.sn, k.sh, a.B, N, a.nh, D, TK) ||
             !make_map(&tv, v.ptr, v.sb, v.sn, v.sh, a.B, N, a.nh, D, TK)) {
    return cudaErrorInvalidValue;
  }
  // a multiple of the cluster size: the clusters the card holds at once, at
  // most one block per SM
  const int cl = a.cluster, resident = resident_clusters<D, BIAS, RB>(smem);
  if (resident == 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(attn_long_kernel<D, BIAS, RB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t units = (int64_t)a.B * a.nh * ((N + TQ * cl - 1) / (TQ * cl));
  // the plan: the units from split0 on as `pieces` runs of their K/V tiles
  const int nkt = BIAS == ROWS ? (a.hk + 1) / 2 : (N + TK - 1) / TK;
  if (!make_tail(&a.tail, units, nkt, a.tail.split0, a.tail.pieces) ||
      (a.tail.pieces > 1 && (!a.work || !a.counters)))
    return cudaErrorInvalidValue;
  const int grid = cl * std::min(a.tail.n_work, resident);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = long_config(grid, smem, stream, &cluster);
  void* args[] = {&tq, &tk, &tv, &a};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(attn_long_kernel<D, BIAS, RB>), args);
}

// RB: 8-key blocks a half tile (ROWS: 8 RB slots a key row)
template <int BIAS, int RB = 8>
cudaError_t launch_long_bias(const View& q, const View& k, const View& v, const LongArgs& a, int d,
                             cudaStream_t stream) {
  switch (d) {
    case 32: return launch_long_d<32, BIAS, RB>(q, k, v, a, stream);
    case 64: return launch_long_d<64, BIAS, RB>(q, k, v, a, stream);
    case 80: return launch_long_d<80, BIAS, RB>(q, k, v, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_long(const View& q, const View& k, const View& v, const LongArgs& a, int d, bool has_bias,
                        cudaStream_t stream) {
  const bool grid_ok = has_bias ? a.hk >= 1 && a.wk >= 1 && a.N == a.hk * a.wk : true;
  if (!tma_views_ok(q, k, v) || !grid_ok || a.N < 1 || a.B < 1 || a.nh < 1) return cudaErrorInvalidValue;
  if (!has_bias) return launch_long_bias<NO_BIAS>(q, k, v, a, d, stream);
  if (bias_layout(a.hk, a.wk) == GATHER) return launch_long_bias<GATHER>(q, k, v, a, d, stream);
  switch (row_blocks(a.wk)) {
    case 5: return launch_long_bias<ROWS, 5>(q, k, v, a, d, stream);
    case 6: return launch_long_bias<ROWS, 6>(q, k, v, a, d, stream);
    case 7: return launch_long_bias<ROWS, 7>(q, k, v, a, d, stream);
    default: return launch_long_bias<ROWS, 8>(q, k, v, a, d, stream);
  }
}

}  // namespace

// The long kernel with the rel-pos bias (SAM's global layers), bf16 only,
// N = hk * wk, d in {32, 64, 80}, hk + wk <= 500.  Strides in elements.
// The plan of the last wave (ops/cuda_kernels.py::long_plan): with pieces
// >= 2, the units from split0 on run as `pieces` key chunks each (at most
// one a K/V tile), their partials in `work` ((units - split0) * pieces * 2
// blocks * 256 consumer threads * (d/2 + 4) floats) and arrivals in
// `counters` ((units - split0) * 2 * 8 ints, 0 before the launch and after
// it); pieces <= 1 splits nothing.  Returns the launch's error, or
// cudaErrorInvalidValue for shapes or plans it does not take.
extern "C" int pope_attention_long_relpos(const void* q, const void* k, const void* v, const void* rel_h,
                                          const void* rel_w, void* out, int64_t sq_b, int64_t sq_n,
                                          int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h,
                                          int64_t sv_b, int64_t sv_n, int64_t sv_h, int B, int N, int nh,
                                          int d, int hk, int wk, float scale, int split0, int pieces,
                                          void* work, void* counters, void* stream) {
  LongArgs a{};
  a.rel_h = static_cast<const __nv_bfloat16*>(rel_h);
  a.rel_w = static_cast<const __nv_bfloat16*>(rel_w);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.N = N, a.nh = nh, a.hk = hk, a.wk = wk, a.scale = scale;
  a.tail.split0 = split0, a.tail.pieces = pieces;  // the plan as asked; the launcher completes it
  a.work = static_cast<float*>(work), a.counters = static_cast<int*>(counters);
  return launch_long({q, sq_b, sq_n, sq_h}, {k, sk_b, sk_n, sk_h}, {v, sv_b, sv_n, sv_h}, a, d, true,
                     static_cast<cudaStream_t>(stream));
}

// The layout the launcher picks at head dim d on an hk x wk bias grid (0 x
// 0: the bias-free kernel): the bias's (Bias: 0 none, 1 gathered, 2 whole
// key rows) and, with rows, the slots a key row takes in a K/V tile (else
// 0), Q stages, K/V stages, the dynamic shared memory in bytes, the blocks
// per cluster and the clusters the card holds at once. Returns 0, or
// cudaErrorInvalidValue when nothing fits.
extern "C" int pope_attention_long_layout(int d, int hk, int wk, int* bias, int* row_slots, int* q_stages,
                                          int* kv_stages, int* smem, int* cluster, int* resident) {
  LongArgs a{};
  *bias = bias_layout(hk, wk);
  const int rb = *bias == ROWS ? row_blocks(wk) : 8;
  *row_slots = *bias == ROWS ? 8 * rb : 0;
  *smem = long_layout(d, hk, wk, &a);
  *q_stages = a.q_stages, *kv_stages = a.kv_stages, *cluster = LONG_CLUSTER, *resident = 0;
  if (*smem == 0) return (int)cudaErrorInvalidValue;
  switch ((d * 4 + *bias) * 16 + rb) {
#define POPE_LONG_RESIDENT(D, BIAS, RB) \
  case (D * 4 + BIAS) * 16 + RB: *resident = resident_clusters<D, BIAS, RB>(*smem); break;
#define POPE_LONG_RESIDENT_D(D)                                                                   \
  POPE_LONG_RESIDENT(D, NO_BIAS, 8) POPE_LONG_RESIDENT(D, GATHER, 8) POPE_LONG_RESIDENT(D, ROWS, 5) \
      POPE_LONG_RESIDENT(D, ROWS, 6) POPE_LONG_RESIDENT(D, ROWS, 7) POPE_LONG_RESIDENT(D, ROWS, 8)
    POPE_LONG_RESIDENT_D(32) POPE_LONG_RESIDENT_D(64) POPE_LONG_RESIDENT_D(80)
#undef POPE_LONG_RESIDENT_D
#undef POPE_LONG_RESIDENT
    default: return (int)cudaErrorInvalidValue;
  }
  return *resident == 0 ? (int)cudaErrorInvalidValue : 0;
}

// The bias-free long kernel (flash_attention above N = 256), bf16 only; the
// plan as above.
extern "C" int pope_attention_long(const void* q, const void* k, const void* v, void* out, int64_t sq_b,
                                   int64_t sq_n, int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h,
                                   int64_t sv_b, int64_t sv_n, int64_t sv_h, int B, int N, int nh, int d,
                                   float scale, int split0, int pieces, void* work, void* counters,
                                   void* stream) {
  LongArgs a{};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.N = N, a.nh = nh, a.scale = scale;
  a.tail.split0 = split0, a.tail.pieces = pieces;  // the plan as asked; the launcher completes it
  a.work = static_cast<float*>(work), a.counters = static_cast<int*>(counters);
  return launch_long({q, sq_b, sq_n, sq_h}, {k, sk_b, sk_n, sk_h}, {v, sv_b, sv_n, sv_h}, a, d, false,
                     static_cast<cudaStream_t>(stream));
}
