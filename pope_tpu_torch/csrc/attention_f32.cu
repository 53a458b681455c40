// Float32 attention on Hopper's tensor cores (sm_90a), with or without SAM's
// decomposed relative-position bias:
//
//   out[b, n, h*d:(h+1)*d] = softmax_k(q_n . k_k * d^-1/2
//                                      [+ rel_h[b, h, n, k / wk]
//                                       + rel_w[b, h, n, k % wk]]) . v
//
// with the bias over a (hk x wk) key grid, N = hk * wk keys, keys in
// row-major order.  The "tf32x3" design, for float32 operands: it replaces
// the float32 bodies of the Pallas TPU kernels pope_tpu/ops/flash_attention.py::
// flash_attention (DINOv2 in f32: the SSL step, extract_cls_features,
// DINOv2Poser), flash_attention_relpos and pope_tpu/ops/window_attention.py::
// windowed_attention_relpos (the f32 SAM encoder configs).  The C entries
// pope_attention_f32 and pope_attention_f32_relpos take the same (B, N, nh,
// d) views and bias tables as attention_relpos.cu's.
//
// 3xTF32.  Each f32 operand x is split as big = rna_tf32(x) and small =
// rna_tf32(x - big) (cvt.rna.tf32.f32: round to nearest, ties away, 10
// mantissa bits), and each product is a_small b_big + a_big b_small +
// a_big b_big on the tensor cores, accumulated in f32: about f32's accuracy
// (the dropped a_small b_small is 2^-22 of the product) at a third of the
// 494.7 TFLOP/s TF32 rate.  Both halves are rounded explicitly: a tf32
// product reads only the top 19 bits of a register, so an unrounded big
// would leave small nothing to correct.  The logits, the online softmax
// (max, exp2, sum, correction, in the log2 domain: q is pre-scaled by
// d^-1/2 log2(e) and the bias tables by log2(e)) and the output stay f32.
//
// What bounds each row on an H100.  Kernel 2 in f32 (SAM ViT-H's global
// layers, B = 4, 16 heads, N = 3072, d = 80) and SSL's global crops (16
// images x 6 heads, N = 257, d = 64) are bound by their operations: 193 and
// 1.62 GFLOP, 1.17 and 0.0098 ms at 494.7 / 3 TFLOP/s.  SSL's local crops
// (64 x 6, N = 50: 19.7 MB for 0.25 GFLOP) and kernel 1 in f32 (80 windows
// of 14x14, 16 heads, d = 80) are bound by their bytes at 3.35 TB/s.  So
// the products must run at the tensor cores' own rate, and a block's fixed
// cost (its Q tile, its first K / V tile, its epilogue) must stay small.
//
// Design.  Every product is a wgmma (m64nNk8 .tf32), one warpgroup per 64
// query rows: the warp-level m16n8k8 product reaches about half of the
// TF32 peak alone, wgmma the card's own rate (tools/ablate_kernels.py
// --kernel f32 times both).  tf32 wgmma takes both shared-memory operands
// K-major and has no transpose bit, so every operand is laid out with the
// reduced dimension contiguous, in slabs of 8 tf32 (32 bytes, one k8 step)
// a row under the 32-byte swizzle (hopper.cuh's desc_b32):
//   - S = Q K^T: A = Q and B = K from shared memory, in d_pad / 8 slabs
//     each, the head dim contiguous as the views hold it;
//   - P V: A = P from registers, B = V^T (keys contiguous, one slab of
//     d_pad rows per 8 keys).  wgmma's f32 accumulator and its tf32 A
//     fragment have the warp-level m16n8k8's C and A layouts: a thread
//     holds columns 2t and 2t + 1 of each 8-key group of S, and A's k = t
//     and t + 4.  So key 2t of a group goes to k = t and key 2t + 1 to
//     k = t + 4: P stays in the registers it is in, split there, and V^T's
//     slab holds the group's even keys in its first 16-byte chunk and the
//     odd ones in its second.
// Operands are split once, when staged: TMA cannot split, so the block's
// threads load each tile global -> registers, split it and store big and
// small into their own slabs (Q pre-scaled, once; V transposed in the same
// pass, a thread per column and key quadruple; every 16-byte store phase
// conflict-free).  A fence.proxy.async orders those generic stores before
// the products read them through the async proxy.  Each product runs over
// the split halves in the order small.big, big.small, big.big, one k8 step
// at a time.  A tile's P V is summed from 0 and joins O in one f32 add: the
// tensor cores' f32 sums round toward 0, which over thousands of keys in
// one accumulator would bias O by ~1e-4 of itself.
// What hides the loads: on the 16-byte path at d_pad <= 80 the next
// tile's loads are issued into registers before this tile's products and
// split into shared memory after them; two 64-query blocks share an SM
// where shared memory allows (SSL, kernel 1), so one block's softmax and
// staging run beside the other's products.  At d_pad = 128 and on the
// 4-byte path (rows off 16 bytes) each tile is loaded after the barrier.
// Issuing S of tile j + 1 beside P V of tile j (K staged a tile ahead of
// V, the softmax under P V) read slower at every row: its second S
// accumulator spilled (PERF.md).
// Tiles.  One block per (b * nh + h, query tile), heads fastest, so that
// every head's partial last query tile comes last.  Query tiles are 64
// rows (one warpgroup), or 128 (two, sharing every K / V tile) at d_pad =
// 80 from 1024 keys on: kernel 2 stages each K / V tile once for 128
// queries.  K / V tiles (tile_keys) are 64 keys: S's m64n64 reads its B
// operand at the tensor cores' rate (m64n32's two operands from shared
// memory do not keep up).  32 at d_pad = 80 in 64-query blocks and at
// d_pad = 128 (16 with the bias), where registers (O, the tile's P V sum,
// S, P's two halves, the prefetch) or the query tile's bias rows at the
// widest grid (hk + wk = 474, 64 x 474 f32, 121 KB) leave no more room.
// Ragged tails: keys past N read as key N - 1 and are masked to -inf
// before the max; query rows past N are computed and not written; a
// warpgroup without a row skips the products.  Head dims are padded with
// zeros to the instantiation's d_pad (32, 64, 80 or 128).
// The bias is gathered per logit from the query tile's rel_h / rel_w rows,
// staged transposed, a thread's two rows side by side (one 8-byte load).
// The other choice, a product of [rel_h | rel_w] with a 0/1 key-grid
// table as attention_short.cu does in bf16, would run a depth of hk + wk
// (112 at kernel 2, 474 at the widest grid) against the head dim's 80 for
// every K / V tile: more tensor work than S itself, against a gather that
// costs kernel 2 about 3% (the no_bias_gather ablation).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int LONG_N = 1024;   // from this many keys on, 128-query blocks (d_pad = 80)
constexpr int MAX_GRID = 474;  // the widest bias grid (hk + wk) taken: ops/cuda_kernels.py::F32_MAX_GRID

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* rel_h;
  const void* rel_w;
  void* out;
  int64_t sq_b, sq_n, sq_h;  // element strides of the (B, N, nh, d) views
  int64_t sk_b, sk_n, sk_h;
  int64_t sv_b, sv_n, sv_h;
  int B, N, nh, d, hk, wk;
  float scale;
};

// A block holds TQ query rows, a warpgroup (128 threads) per 64
template <int TQ>
__host__ __device__ constexpr int threads() {
  return 2 * TQ;
}

// row stride of the transposed bias tables
template <int TQ>
__host__ __device__ constexpr int ldr() {
  return TQ + 4;
}

// The keys a K / V tile holds, per padded head dim (the source note)
template <int DP, bool HAS_BIAS, int TQ>
__host__ __device__ constexpr int tile_keys() {
  return DP == 128 ? (HAS_BIAS ? 16 : 32) : DP == 80 && TQ == 64 ? 32 : 64;
}

// whether the next tile's loads are in flight during this tile's products
template <int DP, bool VEC>
__host__ __device__ constexpr bool prefetch() {
  return VEC && DP <= 80;
}

// Shared memory: 256 bytes of alignment; Q, K and V^T as big and small
// slabs of 32-byte rows (Q d_pad / 8 slabs of TQ rows, K d_pad / 8 of TK
// rows, V^T TK / 8 of d_pad rows); the transposed bias rows
template <int DP, bool HAS_BIAS, int TQ>
__host__ __device__ constexpr size_t smem_bytes(int grid) {
  return 256 + (size_t)8 * DP * (TQ + 2 * tile_keys<DP, HAS_BIAS, TQ>()) + (size_t)4 * ldr<TQ>() * grid;
}

// round to nearest tf32, ties away from zero (cvt.rna.tf32.f32's rounding,
// in two integer operations: half a tf32 ulp added to the magnitude's bits,
// the 13 low bits cut).  The same bits for every finite x; a NaN may come
// out as inf, and then its small part is NaN, so a NaN still reaches the
// output
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small (to 2^-22 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(float4 x, float mul, uint4& big, uint4& small) {
  split(x.x * mul, big.x, small.x);
  split(x.y * mul, big.y, small.y);
  split(x.z * mul, big.z, small.z);
  split(x.w * mul, big.w, small.w);
}

// Float offset of 16-byte chunk h (0 or 1) of row r in a slab of 32-byte
// rows under the 32-byte swizzle (the chunk index flips with bit 2 of the
// row, as wgmma's layout type 3 reads it from a 256-byte aligned slab)
__device__ __forceinline__ int swz(int r, int h) {
  return r * 8 + ((h ^ (r >> 2)) & 1) * 4;
}

// The tf32 products: D[64 x N] (+)= A[64 x 8] . B[N x 8]^T with A and B
// K-major in shared memory (S = Q K^T over one k8 step of the head dim), and
// with A from registers (P V over 8 keys)
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_tf32_ss_n16(d, da, db, acc);
  if constexpr (N == 32) wgmma_tf32_ss_n32(d, da, db, acc);
  if constexpr (N == 64) wgmma_tf32_ss_n64(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, db, acc);
  if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, db, acc);
  if constexpr (N == 80) wgmma_tf32_rs_n80(d, a, db, acc);
  if constexpr (N == 128) wgmma_tf32_rs_n128(d, a, db, acc);
}

// S (+)= Q K^T over k-step ks in 3xTF32, the small cross terms first (the
// operands' shared-memory descriptors)
template <int TK>
__device__ __forceinline__ void product_s(float (&s)[TK / 2], uint64_t q_big, uint64_t q_small, uint64_t k_big,
                                          uint64_t k_small, int ks) {
  wgmma_tf32_ss<TK>(s, q_small, k_big, ks > 0);
  wgmma_tf32_ss<TK>(s, q_big, k_small, 1);
  wgmma_tf32_ss<TK>(s, q_big, k_big, 1);
}

// O (+)= P V over 8-key group j in 3xTF32, the small cross terms first
template <int DP>
__device__ __forceinline__ void product_pv(float (&o)[DP / 2], const uint32_t (&p_big)[4],
                                           const uint32_t (&p_small)[4], uint64_t v_big, uint64_t v_small, int j) {
  wgmma_tf32_rs<DP>(o, p_small, v_big, j > 0);
  wgmma_tf32_rs<DP>(o, p_big, v_small, 1);
  wgmma_tf32_rs<DP>(o, p_big, v_big, 1);
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The staging of an operand tile is split in two: the global loads of a
// thread's chunks, all issued at once into registers, then the split and
// the shared stores.  Loads and stores in one loop would wait out an L2
// round trip per chunk.  A thread keeps its row (Q, K) or column (V) of the
// tile and walks the rest in steps whose offsets are constants, so that a
// chunk's addresses are a base and a constant.  Rows past N are read as
// row N - 1 in the ragged last tile (keys there are masked to -inf, query
// rows there are not written), so only the columns past d need a
// predicate: zeros in Q and K, any finite value in V (its columns past d
// are not written).
template <int TOTAL, int NT>
struct Chunks {
  static_assert(TOTAL % NT == 0, "a tile's chunks are a whole number a thread");
  static constexpr int PER = TOTAL / NT;  // chunks a thread holds
  float4 x[PER];
};

// Columns c..c + 3 of a row, c < d: one 16-byte load (VEC: the view's rows
// start on 16 bytes and hold whole 16-byte chunks), else four 4-byte ones,
// those past d zeros (left = d - c)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int left) {
  if constexpr (VEC) {
    return left > 0 ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    // loads of columns clamped to d - 1, then zeros past d: no predicate a load
    const int m = max(left, 1) - 1;
    const float* q = p + min(left - 1, 0);
    float4 x = make_float4(q[0], q[min(m, 1)], q[min(m, 2)], q[min(m, 3)]);
    x.x = left > 0 ? x.x : 0.f;
    x.y = left > 1 ? x.y : 0.f;
    x.z = left > 2 ? x.z : 0.f;
    x.w = left > 3 ? x.w : 0.f;
    return x;
  }
}

// A tile of ROWS rows (Q or K): thread tid holds 16-byte chunk h = tid & 1
// of row (tid >> 1) % ROWS in slabs (tid >> 1) / ROWS + step * NT / (2 ROWS).
// A store phase of 8 threads covers 4 rows x 2 chunks, 128 distinct bytes;
// two threads load a row's 32 bytes
template <int DP, int ROWS, int NT>
struct RowTile {
  static_assert((NT / 2) % ROWS == 0, "whole rows a step");
  static constexpr int SLABS_A_STEP = NT / 2 / ROWS, STEPS = DP / 8 / SLABS_A_STEP;
  static_assert(STEPS * SLABS_A_STEP == DP / 8, "whole slabs a thread");
  static __device__ __forceinline__ int row() { return (threadIdx.x >> 1) % ROWS; }
  static __device__ __forceinline__ int half() { return threadIdx.x & 1; }
  static __device__ __forceinline__ int slab(int step) { return (threadIdx.x >> 1) / ROWS + step * SLABS_A_STEP; }
};

// Rows [row0, row0 + ROWS) of a (N, d) operand with row stride sn
template <int DP, int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_rows(Chunks<ROWS * DP / 4, NT>& ch, const float* src, int64_t sn, int row0,
                                          int N, int d) {
  using T = RowTile<DP, ROWS, NT>;
  const float* p = src + (int64_t)min(row0 + T::row(), N - 1) * sn + 4 * T::half();
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int c = 8 * T::slab(it) + 4 * T::half();
    ch.x[it] = load4<VEC>(p + 8 * T::slab(it), d - c);
  }
}

// ... times mul, split into the big and small slabs (d_pad / 8 slabs of
// ROWS rows each, at shared addresses big and small)
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void store_rows(uint32_t big, uint32_t small, const Chunks<ROWS * DP / 4, NT>& ch,
                                           float mul) {
  using T = RowTile<DP, ROWS, NT>;
  const uint32_t base = 4 * swz(T::row(), T::half());
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    uint4 b, m;
    split4(ch.x[it], mul, b, m);
    const uint32_t off = base + T::slab(it) * ROWS * 32;
    sts128(big + off, b);
    sts128(small + off, m);
  }
}

// V's tile, by units: column n of keys 8 j + e + 2 q, q = 0..3 (the even
// keys of 8-key group j for e = 0, the odd ones for e = 1).  Thread tid
// holds column nb CW + tid % CW of quadruple g = 2 j + e = g0 + tid / CW,
// (nb, g0) stepping through the tile; consecutive threads take consecutive
// columns, so a warp's loads of one key are runs of the row and its 16-byte
// stores fill distinct banks
template <int DP, int TK, int NT>
struct VTile {
  static constexpr int G = TK / 4;                                 // quadruples of the tile
  static constexpr int TPG = G < NT / 16 ? G : NT / 16;            // quadruples a step
  static constexpr int CW = NT / TPG;                              // columns a step
  static_assert(G % TPG == 0 && DP % CW == 0, "whole columns and quadruples a step");
  static __device__ __forceinline__ int col(int step) { return step * TPG / G * CW + threadIdx.x % CW; }
  static __device__ __forceinline__ int quad(int step) { return step * TPG % G + threadIdx.x / CW; }
};

template <int DP, int TK, int NT>
__device__ __forceinline__ void load_v(Chunks<TK * DP / 4, NT>& ch, const float* src, int64_t sn, int k0, int N, int d) {
  using T = VTile<DP, TK, NT>;
  const bool ragged = k0 + TK > N;
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int g = T::quad(it), key = k0 + 8 * (g >> 1) + (g & 1);
    const float* p = src + min(T::col(it), d - 1);
    if (ragged) {
      ch.x[it] = make_float4(p[(int64_t)min(key, N - 1) * sn], p[(int64_t)min(key + 2, N - 1) * sn],
                             p[(int64_t)min(key + 4, N - 1) * sn], p[(int64_t)min(key + 6, N - 1) * sn]);
    } else {
      const float* r = p + (int64_t)key * sn;
      ch.x[it] = make_float4(r[0], r[2 * sn], r[4 * sn], r[6 * sn]);
    }
  }
}

// ... split into V^T's slabs: slab j, row n, 16-byte chunk e.  Row n of
// slab j is then k = 0..7 of P V's k-step j as the A fragment holds P:
// k = t is key 2t of the group, k = t + 4 key 2t + 1
template <int DP, int TK, int NT>
__device__ __forceinline__ void store_v(uint32_t big, uint32_t small, const Chunks<TK * DP / 4, NT>& ch) {
  using T = VTile<DP, TK, NT>;
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int g = T::quad(it);
    uint4 b, m;
    split4(ch.x[it], 1.f, b, m);
    const uint32_t off = 4 * ((g >> 1) * DP * 8 + swz(T::col(it), g & 1));
    sts128(big + off, b);
    sts128(small + off, m);
  }
}

template <int DP, bool HAS_BIAS, int TQ, bool VEC>
__global__ void __launch_bounds__(threads<TQ>(), 1) attn_f32_kernel(const Args a) {
  constexpr int NT = threads<TQ>(), LDR = ldr<TQ>();
  constexpr int KS = DP / 8;  // k-steps of S
  constexpr int TK = tile_keys<DP, HAS_BIAS, TQ>();
  constexpr int NTK = TK / 8;  // 8-key groups of a tile: k-steps of P V
  constexpr uint32_t QSLAB = TQ * 32, KSLAB = TK * 32, VSLAB = DP * 32;  // bytes a slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t Qb = (raw + 255u) & ~255u;  // the swizzle's period
  const uint32_t Qs = Qb + KS * QSLAB;       // Q times d^-1/2 log2(e)
  const uint32_t Kb = Qs + KS * QSLAB;
  const uint32_t Ks = Kb + KS * KSLAB;
  const uint32_t Vb = Ks + KS * KSLAB;  // V^T
  const uint32_t Vs = Vb + NTK * VSLAB;
  float* RhT = reinterpret_cast<float*>(smem_raw + (Vs + NTK * VSLAB - raw));  // hk x LDR, times log2(e)
  float* RwT = RhT + LDR * a.hk;                                                // wk x LDR

  const int N = a.N, d = a.d, hk = a.hk, wk = a.wk;
  const int bh = blockIdx.x;
  const int b = bh / a.nh, h = bh % a.nh;
  const int q0 = blockIdx.y * TQ;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the accumulators' row group and thread-in-group

  const float* qp = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;

  // the query tile's and the first K / V tile's loads all in flight at once
  Chunks<TK * DP / 4, NT> kc;
  Chunks<TK * DP / 4, NT> vc;
  {
    Chunks<TQ * DP / 4, NT> qc;
    load_rows<DP, TQ, NT, VEC>(qc, qp, a.sq_n, q0, N, d);
    load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, 0, N, d);
    load_v<DP, TK, NT>(vc, vp, a.sv_n, 0, N, d);
    store_rows<DP, TQ, NT>(Qb, Qs, qc, a.scale * LOG2E);
  }
  if constexpr (HAS_BIAS) {
    // row r of the tile at 16 (r / 16) + 2 (r % 8) + (r / 8) % 2 of a
    // table row: a thread's rows r0 and r0 + 8 side by side, one 8-byte load
    const float* rhp = static_cast<const float*>(a.rel_h) + ((int64_t)bh * N + q0) * hk;
    const float* rwp = static_cast<const float*>(a.rel_w) + ((int64_t)bh * N + q0) * wk;
    for (int i = threadIdx.x; i < TQ * hk; i += NT) {
      const int r = i / hk, c = i - r * hk;
      RhT[c * LDR + (r & ~15) + 2 * (r & 7) + (r >> 3 & 1)] = q0 + r < N ? rhp[i] * LOG2E : 0.f;
    }
    for (int i = threadIdx.x; i < TQ * wk; i += NT) {
      const int r = i / wk, c = i - r * wk;
      RwT[c * LDR + (r & ~15) + 2 * (r & 7) + (r >> 3 & 1)] = q0 + r < N ? rwp[i] * LOG2E : 0.f;
    }
  }

  const int r0 = (threadIdx.x >> 5) * 16 + g, r1 = r0 + 8;  // this thread's rows of the tile
  const int rp = (threadIdx.x >> 5) * 16 + 2 * g;           // the two in a bias table row
  const bool live = q0 + 64 * wg < N;                       // the warpgroup holds a query row
  // descriptors of the warpgroup's 64 query rows and of the K / V^T slabs;
  // a slab further is its bytes / 16 further in the start address field
  const uint64_t dqb = desc_b32(Qb + wg * 64 * 32, 16), dqs = desc_b32(Qs + wg * 64 * 32, 16);
  const uint64_t dkb = desc_b32(Kb, 16), dks = desc_b32(Ks, 16), dvb = desc_b32(Vb, 16), dvs = desc_b32(Vs, 16);
  const int dkh = 8 / max(wk, 1), dkw = 8 - dkh * wk;  // 8 keys further on the grid
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  for (int k0 = 0; k0 < N; k0 += TK) {
    if (k0 > 0) {
      __syncthreads();  // the previous tile's products are done
      if constexpr (!prefetch<DP, VEC>()) {
        // d laundered: its per-chunk column bounds are recomputed here, not
        // held in registers across the loop
        int dl = d;
        asm volatile("" : "+r"(dl));
        load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, k0, N, dl);
        load_v<DP, TK, NT>(vc, vp, a.sv_n, k0, N, dl);
      }
    }
    store_rows<DP, TK, NT>(Kb, Ks, kc, 1.f);
    store_v<DP, TK, NT>(Vb, Vs, vc);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores above are read by wgmma
    __syncthreads();
    if constexpr (prefetch<DP, VEC>()) {
      if (k0 + TK < N) {  // the next tile's loads in flight during this tile's products
        load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, k0 + TK, N, d);
        load_v<DP, TK, NT>(vc, vp, a.sv_n, k0 + TK, N, d);
      }
    }
    if (!live) continue;

    // S = Q K^T; this thread's logits s[4 c + e] are rows r0 (e < 2) and r1
    // of keys k0 + 8 c + 2t + (e & 1)
    float s[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      product_s<TK>(s, dqb + ks * QSLAB / 16, dqs + ks * QSLAB / 16, dkb + ks * KSLAB / 16, dks + ks * KSLAB / 16,
                    ks);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // the bias, from the tables' rows of this thread's keys (a key past N
    // reads the last row; it is masked below)
    if constexpr (HAS_BIAS) {
      int kh = (k0 + 2 * t) / wk, kw = k0 + 2 * t - kh * wk;
#pragma unroll
      for (int c = 0; c < NTK; ++c) {
        const int kh1 = kw + 1 < wk ? kh : kh + 1, kw1 = kw + 1 < wk ? kw + 1 : 0;
        const float2 h0 = *reinterpret_cast<const float2*>(RhT + min(kh, hk - 1) * LDR + rp);
        const float2 h1 = *reinterpret_cast<const float2*>(RhT + min(kh1, hk - 1) * LDR + rp);
        const float2 w0 = *reinterpret_cast<const float2*>(RwT + kw * LDR + rp);
        const float2 w1 = *reinterpret_cast<const float2*>(RwT + kw1 * LDR + rp);
        s[4 * c] += h0.x + w0.x;
        s[4 * c + 1] += h1.x + w1.x;
        s[4 * c + 2] += h0.y + w0.y;
        s[4 * c + 3] += h1.y + w1.y;
        kh += dkh;
        kw += dkw;
        if (kw >= wk) kw -= wk, ++kh;
      }
    }
    if (k0 + TK > N) {  // the ragged last tile: keys past N masked
#pragma unroll
      for (int c = 0; c < NTK; ++c) {
        const int key = k0 + c * 8 + 2 * t;
        if (key >= N) s[4 * c] = s[4 * c + 2] = -INFINITY;
        if (key + 1 >= N) s[4 * c + 1] = s[4 * c + 3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NTK; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a live key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int c = 0; c < NTK; ++c) {
      s[4 * c] = ex2(s[4 * c] - mn0);
      s[4 * c + 1] = ex2(s[4 * c + 1] - mn0);
      s[4 * c + 2] = ex2(s[4 * c + 2] - mn1);
      s[4 * c + 3] = ex2(s[4 * c + 3] - mn1);
      l0 += s[4 * c] + s[4 * c + 1];
      l1 += s[4 * c + 2] + s[4 * c + 3];
    }

    // O = O c + P V: group j's logits, split, are the A fragment of k-step
    // j ({row r0 at k = t, r1 at t, r0 at t + 4, r1 at t + 4}); the tile's
    // sum starts from 0 and joins O in one f32 add
    uint32_t pb[NTK][4], ps[NTK][4];
#pragma unroll
    for (int j = 0; j < NTK; ++j) {
      split(s[4 * j], pb[j][0], ps[j][0]);
      split(s[4 * j + 2], pb[j][1], ps[j][1]);
      split(s[4 * j + 1], pb[j][2], ps[j][2]);
      split(s[4 * j + 3], pb[j][3], ps[j][3]);
    }
    float ot[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) ot[i] = 0.f;
    fence_regs(ot);
    fence_regs(pb);
    fence_regs(ps);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NTK; ++j) product_pv<DP>(ot, pb[j], ps[j], dvb + j * VSLAB / 16, dvs + j * VSLAB / 16, j);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(ot);
    fence_regs(pb);
    fence_regs(ps);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 4) {
      o[i] = fmaf(o[i], c0, ot[i]);
      o[i + 1] = fmaf(o[i + 1], c0, ot[i + 1]);
      o[i + 2] = fmaf(o[i + 2], c1, ot[i + 2]);
      o[i + 3] = fmaf(o[i + 3], c1, ot[i + 3]);
    }
  }
  if (!live) return;

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int n0 = q0 + r0, n1 = q0 + r1;
  const int64_t C = (int64_t)a.nh * d;
  float* out0 = static_cast<float*>(a.out) + ((int64_t)b * N + n0) * C + (int64_t)h * d + 2 * t;
  float* out1 = out0 + 8 * C;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = c * 8 + 2 * t;
    const float* e = &o[4 * c];
    if constexpr (VEC) {
      if (col < d) {  // d % 4 == 0: the pair (col, col + 1) is whole, on 8 bytes
        if (n0 < N) *reinterpret_cast<float2*>(out0 + c * 8) = make_float2(e[0] * inv0, e[1] * inv0);
        if (n1 < N) *reinterpret_cast<float2*>(out1 + c * 8) = make_float2(e[2] * inv1, e[3] * inv1);
      }
    } else {
      if (col < d && n0 < N) out0[c * 8] = e[0] * inv0;
      if (col + 1 < d && n0 < N) out0[c * 8 + 1] = e[1] * inv0;
      if (col < d && n1 < N) out1[c * 8] = e[2] * inv1;
      if (col + 1 < d && n1 < N) out1[c * 8 + 1] = e[3] * inv1;
    }
  }
}

template <int DP, bool HAS_BIAS, int TQ, bool VEC>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  static_assert(smem_bytes<DP, HAS_BIAS, 64>(HAS_BIAS ? MAX_GRID : 0) <= SMEM_LIMIT,
                "64-query blocks must stage the widest bias grid");
  const size_t smem = smem_bytes<DP, HAS_BIAS, TQ>(a.hk + a.wk);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(attn_f32_kernel<DP, HAS_BIAS, TQ, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // heads fastest: the last (partial) query tiles of all heads come last
  const dim3 grid(a.B * a.nh, (a.N + TQ - 1) / TQ);
  attn_f32_kernel<DP, HAS_BIAS, TQ, VEC><<<grid, threads<TQ>(), smem, stream>>>(a);
  return cudaGetLastError();
}

// 128-query blocks at d_pad = 80 from LONG_N keys on (the bias rows
// permitting), where loading and splitting each K / V tile once for 128
// queries instead of 64 pays; 64 else.  4-byte loads (not VEC) in 64-query
// blocks
template <int DP, bool HAS_BIAS>
cudaError_t launch_dp(const Args& a, bool vec, cudaStream_t stream) {
  if (!vec) return launch_tile<DP, HAS_BIAS, 64, false>(a, stream);
  if constexpr (DP == 80) {
    if (a.N >= LONG_N && smem_bytes<DP, HAS_BIAS, 128>(a.hk + a.wk) <= SMEM_LIMIT)
      return launch_tile<DP, HAS_BIAS, 128, true>(a, stream);
  }
  return launch_tile<DP, HAS_BIAS, 64, true>(a, stream);
}

template <bool HAS_BIAS>
cudaError_t launch(const Args& a, void* stream) {
  const bool grid_ok = HAS_BIAS ? a.hk >= 1 && a.wk >= 1 && a.N == a.hk * a.wk && a.hk + a.wk <= MAX_GRID
                                : a.hk == 0 && a.wk == 0 && a.N >= 1;
  if (!grid_ok || a.d < 1 || a.d > 128 || a.B < 1 || a.nh < 1 || (a.N + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  // 16-byte loads where q/k/v rows start on 16 bytes and hold whole 16-byte
  // chunks (the qkv views of every caller at d % 4 == 0), 4-byte ones else
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  const int64_t strides = a.sq_b | a.sq_n | a.sq_h | a.sk_b | a.sk_n | a.sk_h | a.sv_b | a.sv_n | a.sv_h;
  if (ptrs % 4 != 0) return cudaErrorInvalidValue;
  const bool vec = ptrs % 16 == 0 && strides % 4 == 0 && a.d % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // head dims padded to an instantiation: DINOv2 and SAM ViT-B/L 64, ViT-H
  // 80; 32 and 128 for the rest
  if (a.d <= 32) return launch_dp<32, HAS_BIAS>(a, vec, st);
  if (a.d <= 64) return launch_dp<64, HAS_BIAS>(a, vec, st);
  if (a.d <= 80) return launch_dp<80, HAS_BIAS>(a, vec, st);
  return launch_dp<128, HAS_BIAS>(a, vec, st);
}

}  // namespace

// The rel-pos kernel in float32: the windowed layers (ops/window_attention.py)
// and the global layers (ops/flash_attention.py).  Strides are in elements.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes or views it does not take.
extern "C" int pope_attention_f32_relpos(const void* q, const void* k, const void* v, const void* rel_h,
                                         const void* rel_w, void* out, int64_t sq_b, int64_t sq_n,
                                         int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h, int64_t sv_b,
                                         int64_t sv_n, int64_t sv_h, int B, int N, int nh, int d, int hk, int wk,
                                         float scale, void* stream) {
  const Args a{q,    k,    v,    rel_h, rel_w, out, sq_b, sq_n, sq_h, sk_b, sk_n,
               sk_h, sv_b, sv_n, sv_h,  B,     N,   nh,   d,    hk,   wk,   scale};
  return launch<true>(a, stream);
}

// The bias-free kernel in float32 (ops/flash_attention.py::flash_attention),
// any N.
extern "C" int pope_attention_f32(const void* q, const void* k, const void* v, void* out, int64_t sq_b,
                                  int64_t sq_n, int64_t sq_h, int64_t sk_b, int64_t sk_n, int64_t sk_h,
                                  int64_t sv_b, int64_t sv_n, int64_t sv_h, int B, int N, int nh, int d,
                                  float scale, void* stream) {
  const Args a{q,    k,    v,    nullptr, nullptr, out, sq_b, sq_n, sq_h, sk_b, sk_n,
               sk_h, sv_b, sv_n, sv_h,    B,       N,   nh,   d,    0,    0,    scale};
  return launch<false>(a, stream);
}
