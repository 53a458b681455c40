// Short-sequence attention for Hopper (sm_90a): one (batch, head) at a time,
// its whole Q, K, V and rel-pos slabs held in shared memory, bf16 only:
//
//   out[b, n, h*d:(h+1)*d] = softmax_k(q_n . k_k * d^-1/2
//                                      [+ rel_h[b, h, n, k / wk]
//                                       + rel_w[b, h, n, k % wk]]) . v
//
// for N <= 256 keys, d in {32, 64, 80} and, with the bias, N = hk * wk on a
// grid of hk + wk <= 32.  Longer bf16 sequences (SAM's global layers at N =
// 3072) take attention_long.cu, float32 attention_relpos.cu;
// ops/cuda_kernels.py::attention_design picks one by shape, and a failure
// here raises, it never falls back.  The Hopper building blocks (mbarriers,
// TMA, wgmma, tensor maps) are in hopper.cuh, shared with attention_long.cu.
//
// Replaces, on the main path:
//   - kernel 1, pope_tpu/ops/window_attention.py::windowed_attention_relpos
//     (_window_attn_kernel): SAM ViT-H's 28 windowed layers, per B=4 batch of
//     640x480 frames 80 windows x 16 heads, N = 196 (14x14), d = 80.  It moves
//     174.6 MB (qkv 120.4 MB read, rel tables 14.0 MB, output 40.1 MB) for
//     15.7 GFLOP of live work: bytes bound it, 0.052 ms at 3.35 TB/s;
//   - kernel 3, pope_tpu/ops/flash_attention.py::flash_attention
//     (_attn_kernel): DINOv2 ViT-S/14's 12 blocks in the retrieval forward,
//     4 pairs x 65 crops x 6 heads, N = 197, d = 64.  157.3 MB (118.0 MB read,
//     39.3 MB written) for 15.5 GFLOP: bytes bound it, 0.047 ms.
//
// What held the streaming kernel back at these shapes, and the design here:
//   - it read each head's K and V once per 64-query tile (4 times at N = 196)
//     and its 4-tile pipelines never reached a steady state.  Here a block
//     is persistent (one per SM) and walks the B * nh heads; each head's Q, K
//     and V come in once, by TMA (cp.async.bulk.tensor over 4-D (d, nh, N, B)
//     maps of the strided q/k/v views, rows past N zero-filled), the rel
//     slabs by 1-D bulk copies, into a ring of 2 head stages, so the next
//     head's loads are in flight while this one computes.  One producer warp
//     issues the copies; two consumer warpgroups take the 64-row query tiles
//     of a head in turn (N = 196/197: 4 tiles, 2 each);
//   - 64 x 64 tiles did 59% live work at N = 196/197.  Here, up to N = 200,
//     S = Q K^T is one m64n200k16 wgmma per k-step, so the whole key row sits
//     in registers and the softmax is exact in one pass, without rescaling;
//     P V takes P from registers (bf16 A fragments) and V from shared memory
//     as an MN-major B operand, over 13 k-steps (208 keys).  Live work
//     196^2 / (256 * 200) = 75%.  From 201 to 256 keys the row is two passes
//     of m64n128 with one online rescale between them (Keys<WIDE>): one
//     accumulator of 256 keys does not fit beside O and P.  (S as 5-7 chunks
//     of m64n40 with a runtime count made ptxas serialise the wgmmas and
//     spill);
//   - the bias is a third wgmma product, not a per-logit gather (see the
//     kernel's note);
//   - the output leaves through shared memory (the tile's own Q rows, which
//     are dead once S is done) as 16-byte stores of whole 128/160-byte row
//     segments;
//   - a grid of one persistent block an SM runs B * nh heads in waves of
//     132, and a last wave of few heads left most SMs idle (the serving
//     path's square frame: 400 heads, 3 full waves and 4; one 640x480
//     frame: 320, 2 and 56).  Here the heads of the last wave run split into
//     runs of their query tiles where that fills the card: whole heads for
//     the full waves, and the last wave's r heads as s = min(ntq, SMs div
//     r) pieces each where that is 2 or more (one tile a piece at the square
//     frame: pieces of two, one a consumer warpgroup, read 2.4% slower)
//     (ops/cuda_kernels.py::short_plan decides and passes split0 and s).  A
//     piece's block loads its head whole, as a whole head's does, and its
//     consumers take only the piece's tiles: the key row stays whole in
//     registers, so no merge is needed.
// d = 80 rows (160 B) fit neither the 64- nor the 128-byte swizzle atom, so
// every operand is laid out as d/16 column slabs of 32-byte rows with the
// 32-byte swizzle, one TMA box per slab; a k16 step of wgmma is exactly one
// slab, for every d.
//
// Budget at kernel 1's shape, per stage: Q and K 5 slabs x 200 rows x 32 B,
// V 5 x 208 x 32 B, 97.3 KB, plus 11.0 KB of rel slabs; two stages, the
// 12.8 KB key-grid table and the barriers take 225.5 KB of the 227 KB a block
// may use (kernel 3: 2 x 76 KB).  Shapes whose stages do not fit twice (256
// rows at d = 80) run one.  Registers: S is 100 f32 accumulators a thread
// (64 a pass above 200 keys), O d/2, P's fragments 13 x 4.  The block is 2
// consumer warpgroups and a producer warpgroup (one working warp), 384
// threads at one block per SM that start at 168 registers each; setmaxnreg
// gives the consumers 232 and leaves the producer 40.  ptxas reports no
// spills for the 12 instantiations (d x bias x the two key widths).
//
// Precision as the streaming kernel: f32 logits and softmax, P rounded to
// bf16 for P V, f32 accumulation, bf16 output.

#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int MAX_N = 256;   // the largest TMA box of rows
constexpr int SHORT_NT = 384;  // 2 consumer warpgroups + 1 producer warpgroup
// registers per thread after setmaxnreg: a register-file quarter holds one
// warp of each warpgroup, 2 x 232 + 40 <= 512 per lane
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

struct ShortArgs {
  const __nv_bfloat16* rel_h;  // (B, nh, N, hk), contiguous
  const __nv_bfloat16* rel_w;  // (B, nh, N, wk)
  __nv_bfloat16* out;          // (B, N, nh * d)
  int B, N, nh, hk, wk;
  int rel_bulk;     // the rel slabs start and end on 16 bytes: 1-D bulk copies
  int stages;       // 1 or 2
  int stage_bytes;  // a multiple of 1024
  float scale;
  // the last wave's plan: heads from tail.split0 on run as tail.pieces runs
  // of their query tiles each (pieces = 1: none split)
  TailPlan tail;
};

// D[64 x 200] (+)= A[64 x 16] . B[200 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n200(float (&d)[100], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99"
      "}, %100, %101, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 200] += A[64 x 16] . B[200 x 16]^T, A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n200(float (&d)[100], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99"
      "}, {%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One pass of S over SW keys: Q K^T (A and B from shared memory), and the
// bias product (A from registers)
template <int SW>
__device__ __forceinline__ void wgmma_s(float (&d)[SW / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (SW == 128) wgmma_ss_n128(d, da, db, acc);
  if constexpr (SW == 200) wgmma_ss_n200(d, da, db, acc);
}
template <int SW>
__device__ __forceinline__ void wgmma_bias(float (&d)[SW / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (SW == 128) wgmma_rs_n128(d, a, db);
  if constexpr (SW == 200) wgmma_rs_n200(d, a, db);
}

// The two key widths: N <= 200 in one pass of m64n200 over the whole key
// row (P V over 13 k-steps, 208 keys, the last 8 with P = 0); 200 < N <= 256
// in two passes of m64n128 with an online rescale between them, since 256
// keys in one accumulator (128 registers a thread) do not fit beside O and
// P without spills.
template <bool WIDE>
struct Keys {
  static constexpr int rows = WIDE ? 256 : 200;    // Q and K rows held, and E's
  static constexpr int v_rows = WIDE ? 256 : 208;  // V rows held
  static constexpr int sw = WIDE ? 128 : 200;      // keys per pass of S
  static constexpr int passes = WIDE ? 2 : 1;
  static constexpr int pv_steps = (sw + 15) / 16;  // P V k-steps per pass
};

// Shared memory: 2 (or 1) stages, each of Q, K and V as D/16 slabs of rows x
// 32 B (200, 200 and 208 rows up to N = 200; 256 above), then the rel_h and
// rel_w slabs of the head (bf16, [q][hk] and [q][wk], each rounded up to 16
// B); with the bias, the key-grid table E (2 slabs of `rows` x 32 B); then
// the stages' mbarriers.
//
// The bias is a third product on the tensor cores.  E[k][c] = 1 where c =
// k / wk or c = hk + k % wk (0 past key N - 1 and column hk + wk - 1), so
// once S = Q K^T is scaled, S += [rel_h | rel_w] . E^T adds rel_h[q, k / wk]
// + rel_w[q, k % wk] to every logit, exactly (two products with 1 per
// logit), in 2 k-steps whose A fragments are the staged tables' rows.  It
// takes grids with hk + wk <= 32.  A gather of the two table entries of each
// logit was much slower, and so were A fragments read from device memory
// (tools/ablate_short_kernel.py measures the latter).
template <int D, bool HAS_BIAS, bool WIDE>
__global__ void __launch_bounds__(SHORT_NT, 1)
    attn_short_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const ShortArgs a) {
  using K = Keys<WIDE>;
  constexpr int DK = D / 16;  // k-steps of S, slabs per operand
  constexpr int DB = D / 8;   // 8-column blocks of O, 16-byte chunks of an output row
  constexpr int SW = K::sw;
  constexpr uint32_t qk_slab = K::rows * SLAB_ROW, v_slab = K::v_rows * SLAB_ROW;
  constexpr uint32_t rel_off = DK * (2 * qk_slab + v_slab);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  const int N = a.N, nh = a.nh, BH = a.B * a.nh;
  const int ntq = (N + 63) / 64;  // 64-query tiles of a head
  const uint32_t rh_bytes = HAS_BIAS ? (uint32_t)(N * a.hk * 2) : 0u;
  const uint32_t rh_alloc = (rh_bytes + 15u) & ~15u;
  const uint32_t E = base + (uint32_t)(a.stages * a.stage_bytes);
  const uint32_t bars = E + (HAS_BIAS ? 2u * qk_slab : 0u);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 16u + 8u * s; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: hands its registers to the consumers; one warp
    // stays, and its lane 0 issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 8) {
      int i = 0;
      for (int wi = blockIdx.x; wi < a.tail.n_work; wi += gridDim.x, ++i) {
        // a piece's producer loads its head whole
        const int bh = piece_of(wi, a.tail, ntq).item;
        const int s = i % a.stages;
        mbar_wait(empty(s), ((uint32_t)(i / a.stages) & 1u) ^ 1u);
        const uint32_t st = base + (uint32_t)(s * a.stage_bytes);
        const int b = bh / nh, h = bh - b * nh;
        uint32_t tx = rel_off;
        if constexpr (HAS_BIAS) {
          const __nv_bfloat16* rh = a.rel_h + (int64_t)bh * N * a.hk;
          const __nv_bfloat16* rw = a.rel_w + (int64_t)bh * N * a.wk;
          const uint32_t rw_bytes = (uint32_t)(N * a.wk * 2);
          if (a.rel_bulk) {
            tx += rh_bytes + rw_bytes;
            if (lane == 0) {
              mbar_arrive_expect_tx(full(s), tx);
              bulk_load(st + rel_off, rh, rh_bytes, full(s));
              bulk_load(st + rel_off + rh_alloc, rw, rw_bytes, full(s));
            }
          } else {  // slabs that do not start and end on 16 bytes: plain copies
            __nv_bfloat16* dh = reinterpret_cast<__nv_bfloat16*>(gbase + (st - base) + rel_off);
            __nv_bfloat16* dw = reinterpret_cast<__nv_bfloat16*>(gbase + (st - base) + rel_off + rh_alloc);
            for (int e = lane; e < N * a.hk; e += 32) dh[e] = rh[e];
            for (int e = lane; e < N * a.wk; e += 32) dw[e] = rw[e];
            __threadfence_block();
            __syncwarp();
            if (lane == 0) mbar_arrive_expect_tx(full(s), tx);
          }
        } else {
          if (lane == 0) mbar_arrive_expect_tx(full(s), tx);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < DK; ++j) {
            tma_load_4d(st + j * qk_slab, &tq, full(s), 16 * j, h, 0, b);
            tma_load_4d(st + DK * qk_slab + j * qk_slab, &tk, full(s), 16 * j, h, 0, b);
            tma_load_4d(st + 2 * DK * qk_slab + j * v_slab, &tv, full(s), 16 * j, h, 0, b);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // consumers: warpgroup wg takes query tiles wg, wg + 2, ... of each head
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, tw = threadIdx.x & 127, wq = tw >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int64_t C = (int64_t)nh * D;
    if constexpr (HAS_BIAS) {
      unsigned char* eg = gbase + (E - base);
      for (int idx = threadIdx.x; idx < K::rows * 32; idx += 256) {
        const int k = idx >> 5, c = idx & 31, cw = c - a.hk;
        const bool one = k < N && (c < a.hk ? c == k / a.wk : cw < a.wk && cw == k % a.wk);
        *reinterpret_cast<__nv_bfloat16*>(eg + (c >> 4) * qk_slab + k * SLAB_ROW +
                                          ((((c >> 3) & 1) ^ ((k >> 2) & 1)) << 4) + (c & 7) * 2) =
            __float2bfloat16(one ? 1.f : 0.f);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // E is read by wgmma
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
    }
    int i = 0;
    for (int wi = blockIdx.x; wi < a.tail.n_work; wi += gridDim.x, ++i) {
      const Piece p = piece_of(wi, a.tail, ntq);
      const int bh = p.item;
      const int s = i % a.stages;
      mbar_wait(full(s), (uint32_t)(i / a.stages) & 1u);
      const uint32_t st = base + (uint32_t)(s * a.stage_bytes);
      const uint32_t Qs = st, Ks = st + DK * qk_slab, Vs = st + 2 * DK * qk_slab;
      unsigned char* qg = gbase + (st - base);
      const int b = bh / nh, h = bh - b * nh;

      for (int tq0 = p.lo + wg; tq0 < p.hi; tq0 += 2) {
        // rows r0 and r1 of this thread; in pass ps its keys are
        // ps * SW + 8 * blk + 2t (+1), blk over the SW / 8 n-blocks of 8 keys
        const int r0 = tq0 * 64 + wq * 16 + g, r1 = r0 + 8;

        // [rel_h | rel_w] rows r0, r1 as A fragments (columns 2t, 2t + 1 and
        // 2t + 8, 2t + 9 of each 16-column k-step) from the staged slabs
        uint32_t bfrag[2][4];
        if constexpr (HAS_BIAS) {
          const unsigned short* rh = reinterpret_cast<const unsigned short*>(qg + rel_off);
          const unsigned short* rw = reinterpret_cast<const unsigned short*>(qg + rel_off + rh_alloc);
          auto bias_at = [&](int row, int c) -> uint32_t {
            row = min(row, N - 1);
            const int cw = c - a.hk;
            const uint32_t v = c < a.hk ? rh[row * a.hk + c] : rw[row * a.wk + min(cw, a.wk - 1)];
            return cw < a.wk ? v : 0u;
          };
#pragma unroll
          for (int kb = 0; kb < 2; ++kb)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int c = 16 * kb + 8 * half + 2 * t;
              bfrag[kb][2 * half] = bias_at(r0, c) | bias_at(r0, c + 1) << 16;
              bfrag[kb][2 * half + 1] = bias_at(r1, c) | bias_at(r1, c + 1) << 16;
            }
        }

        float oacc[D / 2];
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial row sums
#pragma unroll 1  // unrolled, the two passes spilled
        for (int ps = 0; ps < K::passes; ++ps) {
          // S = Q K^T over this pass's keys, then scale [+ bias]
          float sacc[SW / 2];
#pragma unroll
          for (int q = 0; q < SW / 2; ++q) sacc[q] = 0.f;
          fence_regs(sacc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < DK; ++ks)
            wgmma_s<SW>(sacc, desc_b32(Qs + ks * qk_slab + tq0 * 64 * SLAB_ROW, 16),
                        desc_b32(Ks + ks * qk_slab + ps * SW * SLAB_ROW, 16), ks > 0);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(sacc);
#pragma unroll
          for (int q = 0; q < SW / 2; ++q) sacc[q] *= a.scale;
          if constexpr (HAS_BIAS) {
            fence_regs(sacc);
            fence_regs(bfrag);
            wgmma_fence();
            wgmma_bias<SW>(sacc, bfrag[0], desc_b32(E + ps * SW * SLAB_ROW, 16));
            wgmma_bias<SW>(sacc, bfrag[1], desc_b32(E + qk_slab + ps * SW * SLAB_ROW, 16));
            wgmma_commit();
            wgmma_wait0();
            fence_regs(sacc);
            fence_regs(bfrag);
          }

          // mask the keys past N; softmax over the row, exact in one pass,
          // rescaling the first pass's O and sums in the second
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int blk = 0; blk < SW / 8; ++blk) {
            float* e = &sacc[4 * blk];
            const int key = ps * SW + blk * 8 + 2 * t;
            if (key >= N) e[0] = e[2] = -INFINITY;
            if (key + 1 >= N) e[1] = e[3] = -INFINITY;
            mx0 = fmaxf(mx0, fmaxf(e[0], e[1]));
            mx1 = fmaxf(mx1, fmaxf(e[2], e[3]));
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
          }
          if (ps > 0) {
            const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
            l0 *= c0;
            l1 *= c1;
            fence_regs(oacc);
#pragma unroll
            for (int q = 0; q < D / 2; q += 4) {
              oacc[q] *= c0;
              oacc[q + 1] *= c0;
              oacc[q + 2] *= c1;
              oacc[q + 3] *= c1;
            }
          }
          m0 = mx0;
          m1 = mx1;
#pragma unroll
          for (int q = 0; q < SW / 2; q += 4) {
            float* e = &sacc[q];
            e[0] = __expf(e[0] - mx0);
            e[1] = __expf(e[1] - mx0);
            e[2] = __expf(e[2] - mx1);
            e[3] = __expf(e[3] - mx1);
            l0 += e[0] + e[1];
            l1 += e[2] + e[3];
          }

          // O (+)= P V: P as bf16 A fragments (k-step j: n-blocks 2j and
          // 2j + 1; at N <= 200 the last k-step's keys 200..207 lie past the S
          // row, P = 0)
          uint32_t pf[K::pv_steps][4];
#pragma unroll
          for (int j = 0; j < K::pv_steps; ++j) {
            const float* e0 = &sacc[8 * j];
            pf[j][0] = pack_bf16(e0[0], e0[1]);
            pf[j][1] = pack_bf16(e0[2], e0[3]);
            if (2 * j + 1 < SW / 8) {
              const float* e1 = &sacc[8 * j + 4];
              pf[j][2] = pack_bf16(e1[0], e1[1]);
              pf[j][3] = pack_bf16(e1[2], e1[3]);
            } else {
              pf[j][2] = pf[j][3] = 0u;
            }
          }
          if (ps == 0) {
#pragma unroll
            for (int q = 0; q < D / 2; ++q) oacc[q] = 0.f;
          }
          fence_regs(oacc);
          fence_regs(pf);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < K::pv_steps; ++j)
            wgmma_rs<D>(oacc, pf[j], desc_b32(Vs + (ps * SW + j * 16) * SLAB_ROW, v_slab), ps > 0 || j > 0);
          wgmma_commit();
          wgmma_wait0();
          fence_regs(oacc);
          fence_regs(pf);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }

        // epilogue: normalise, stage the tile in its own Q rows with the
        // 32-byte swizzle, then 16-byte stores of whole row segments.  The
        // rows are dead: S of this tile is done in all four warps, since each
        // has issued P V, which the warpgroup issues together.  (4-byte stores
        // straight from the accumulators and TMA stores of the staged tile
        // were both slower.)
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
        for (int nb = 0; nb < DB; ++nb) {
          unsigned char* col = qg + (nb >> 1) * qk_slab + 4 * t;
          const int hh = nb & 1;
          if (r0 < N)
            *reinterpret_cast<uint32_t*>(col + r0 * SLAB_ROW + ((hh ^ ((r0 >> 2) & 1)) << 4)) =
                pack_bf16(oacc[4 * nb] * inv0, oacc[4 * nb + 1] * inv0);
          if (r1 < N)
            *reinterpret_cast<uint32_t*>(col + r1 * SLAB_ROW + ((hh ^ ((r1 >> 2) & 1)) << 4)) =
                pack_bf16(oacc[4 * nb + 2] * inv1, oacc[4 * nb + 3] * inv1);
        }
        bar_sync_wg(1 + wg);
        for (int e = tw; e < 64 * DB; e += 128) {
          const int n = tq0 * 64 + e / DB, ch = e % DB;
          if (n >= N) break;
          const uint4 v = *reinterpret_cast<const uint4*>(qg + (ch >> 1) * qk_slab + n * SLAB_ROW +
                                                          (((ch & 1) ^ ((n >> 2) & 1)) << 4));
          *reinterpret_cast<uint4*>(a.out + ((int64_t)b * N + n) * C + (int64_t)h * D + ch * 8) = v;
        }
      }
      // the stage's generic reads and writes before the producer's next TMA
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync_wg(1 + wg);
      if (tw == 0) mbar_arrive(empty(s));
    }
  }
}

template <int D, bool HAS_BIAS, bool WIDE>
cudaError_t launch_short_d(const View& q, const View& k, const View& v, ShortArgs a, cudaStream_t stream) {
  using K = Keys<WIDE>;
  constexpr int DK = D / 16;
  const int N = a.N;
  const int rel = HAS_BIAS ? (N * a.hk * 2 + 15) / 16 * 16 + (N * a.wk * 2 + 15) / 16 * 16 : 0;
  a.stage_bytes = (DK * (2 * K::rows + K::v_rows) * SLAB_ROW + rel + 1023) / 1024 * 1024;
  const int fixed = 1024 + (HAS_BIAS ? 2 * K::rows * SLAB_ROW : 0) + 32;  // alignment slack, E, the mbarriers
  a.stages = 2 * a.stage_bytes + fixed <= SMEM_LIMIT ? 2 : 1;
  if (a.stage_bytes + fixed > SMEM_LIMIT) return cudaErrorInvalidValue;
  const int smem = a.stages * a.stage_bytes + fixed;
  if (HAS_BIAS) {
    const uintptr_t p = (uintptr_t)a.rel_h | (uintptr_t)a.rel_w;
    a.rel_bulk = p % 16 == 0 && (N * a.hk * 2) % 16 == 0 && (N * a.wk * 2) % 16 == 0;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q.ptr, q.sb, q.sn, q.sh, a.B, N, a.nh, D, K::rows) ||
      !make_map(&tk, k.ptr, k.sb, k.sn, k.sh, a.B, N, a.nh, D, K::rows) ||
      !make_map(&tv, v.ptr, v.sb, v.sn, v.sh, a.B, N, a.nh, D, K::v_rows))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const cudaError_t err = cudaFuncSetAttribute(attn_short_kernel<D, HAS_BIAS, WIDE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the plan: the heads from split0 on as `pieces` runs of their query tiles
  if (!make_tail(&a.tail, (int64_t)a.B * a.nh, (N + 63) / 64, a.tail.split0, a.tail.pieces))
    return cudaErrorInvalidValue;
  const int grid = std::min(a.tail.n_work, sms);
  attn_short_kernel<D, HAS_BIAS, WIDE><<<grid, SHORT_NT, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <bool HAS_BIAS>
cudaError_t launch_short(const View& q, const View& k, const View& v, const ShortArgs& a, int d,
                         cudaStream_t stream) {
  const bool grid_ok = HAS_BIAS ? a.hk >= 1 && a.wk >= 1 && a.N == a.hk * a.wk && a.hk + a.wk <= 32 : true;
  if (!tma_views_ok(q, k, v) || !grid_ok || a.N < 1 || a.N > MAX_N || a.B < 1 || a.nh < 1)
    return cudaErrorInvalidValue;
  const bool wide = a.N > Keys<false>::sw;
  switch (d) {
    case 32: return wide ? launch_short_d<32, HAS_BIAS, true>(q, k, v, a, stream)
                         : launch_short_d<32, HAS_BIAS, false>(q, k, v, a, stream);
    case 64: return wide ? launch_short_d<64, HAS_BIAS, true>(q, k, v, a, stream)
                         : launch_short_d<64, HAS_BIAS, false>(q, k, v, a, stream);
    case 80: return wide ? launch_short_d<80, HAS_BIAS, true>(q, k, v, a, stream)
                         : launch_short_d<80, HAS_BIAS, false>(q, k, v, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The short kernel with the rel-pos bias (SAM's windowed layers), bf16 only,
// N = hk * wk <= 256, d in {32, 64, 80}.  Strides in elements.  The plan of
// the last wave (ops/cuda_kernels.py::short_plan): with pieces >= 2 the
// heads from split0 on run as `pieces` runs of their 64-query tiles each (at
// most one a tile); pieces <= 1 splits nothing.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes or plans it does
// not take.
extern "C" int pope_attention_short_relpos(const void* q, const void* k, const void* v, const void* rel_h,
                                           const void* rel_w, void* out, int64_t sq_b, int64_t sq_n,
                                           int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h,
                                           int64_t sv_b, int64_t sv_n, int64_t sv_h, int B, int N, int nh,
                                           int d, int hk, int wk, float scale, int split0, int pieces,
                                           void* stream) {
  ShortArgs a{};
  a.rel_h = static_cast<const __nv_bfloat16*>(rel_h);
  a.rel_w = static_cast<const __nv_bfloat16*>(rel_w);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.N = N, a.nh = nh, a.hk = hk, a.wk = wk, a.scale = scale;
  a.tail.split0 = split0, a.tail.pieces = pieces;  // the plan as asked; the launcher completes it
  return launch_short<true>({q, sq_b, sq_n, sq_h}, {k, sk_b, sk_n, sk_h}, {v, sv_b, sv_n, sv_h}, a, d,
                            static_cast<cudaStream_t>(stream));
}

// The bias-free short kernel (DINOv2's blocks), bf16 only, N <= 256; the
// plan as above.
extern "C" int pope_attention_short(const void* q, const void* k, const void* v, void* out, int64_t sq_b,
                                    int64_t sq_n, int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h,
                                    int64_t sv_b, int64_t sv_n, int64_t sv_h, int B, int N, int nh, int d,
                                    float scale, int split0, int pieces, void* stream) {
  ShortArgs a{};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.N = N, a.nh = nh, a.scale = scale;
  a.tail.split0 = split0, a.tail.pieces = pieces;  // the plan as asked; the launcher completes it
  return launch_short<false>({q, sq_b, sq_n, sq_h}, {k, sk_b, sk_n, sk_h}, {v, sv_b, sv_n, sv_h}, a, d,
                             static_cast<cudaStream_t>(stream));
}
