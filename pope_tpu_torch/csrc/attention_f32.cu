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
// 495 TFLOP/s TF32 rate.  Both halves are rounded explicitly: a tf32 mma
// reads only the top 19 bits of a register, so an unrounded big would leave
// small nothing to correct.  The logits, the online softmax (max, exp2,
// sum, correction, in the log2 domain: q is pre-scaled by d^-1/2 log2(e) and
// the bias tables by log2(e)) and the output stay f32.
//
// What bounds it on an H100.  SSL's global crops (16 images x 6 heads, N =
// 257, d = 64) do 1.62 GFLOP on 25 MB: operations bound it, 0.0098 ms at
// 495/3 TFLOP/s.  The local crops (64 x 6, N = 50) move 19.7 MB for 0.25
// GFLOP: bytes bound them, 0.0059 ms at 3.35 TB/s.  Kernel 2 in f32 (SAM
// ViT-H's global layers, B = 4, 16 heads, N = 3072, d = 80) is bound by its
// 193 GFLOP, 1.17 ms; kernel 1 in f32 (80 windows of 14x14) by its bytes.
//
// Design.  mma.sync m16n8k8 tf32, not wgmma: tf32 wgmma takes its B operand
// K-major only (no transpose bit for 32-bit types) and its A operand from
// registers in a fixed layout, which would cost a transposing pass for V and
// a register shuffle for P; with mma.sync both vanish (below), and every
// fragment is one 16-byte shared load.  mma.sync reaches about half of the
// card's TF32 peak (tools/ablate_kernels.py --kernel f32 times it alone;
// PERF.md), so 3xTF32 on it tops out near a sixth.  One block per (b * nh +
// h, query tile), heads fastest so that every head's partial last query
// tile comes last; each warp owns 16 query rows.  Query tiles are 64 rows
// (4 warps), or 128 (8 warps) at d_pad = 80 from 1024 keys on: every K / V
// tile is staged once a block, and at kernel 2's 3072 keys staging it for 64
// queries took a third of the time.  K and V stream through shared memory
// in tiles of 16 keys (32 at d_pad = 80), split once when staged: every
// thread loads chunks of 4 columns of the strided rows (one 16-byte load
// where the rows start on 16 bytes and hold whole 16-byte chunks, as every
// caller's qkv views at d % 4 == 0 do; four 4-byte loads else, in 64-query
// blocks and 16-key tiles), splits them and stores big and small side by side,
// so that a B fragment {big b0, big b1, small b0, small b1} is one 16-byte
// shared load.  The query tile is staged the same way, pre-scaled,
// once.  Two orderings make the fragments line up without moving data in
// registers:
//   - the depth of S = Q K^T (the head dim) is read in the order 2t, 2t + 1
//     for the fragment's k = t, t + 4, in Q and K alike (a sum over the head
//     dim does not care about its order), so the split pair of columns
//     (2t, 2t + 1) is one unit of Q's and K's staged rows;
//   - the depth of P V (the keys) likewise: the S accumulator holds columns
//     2t and 2t + 1 of each 8-key group, which are then exactly the A
//     fragment's k = t and t + 4, and V is staged with keys 2t and 2t + 1 of
//     each group side by side.  So P goes from the accumulator to the A
//     operand of P V in the registers it is in, split there.
// A shared row of Q or K is 2 d_pad + 16 floats (16 mod 32: the 8 lanes of a
// 16-byte load phase hit 32 distinct banks); V's units lie in the order the
// lanes read them.  Head dims are padded with zeros to the instantiation's
// DP (32, 64, 80 or 128): padded columns add 0 to the logits and are not
// written.  Ragged tails: keys past N are zeros, masked to -inf before the
// max; the products run over whole tiles all the same, since skipping 8-key
// groups put a branch around each product and cost more than it saved
// (the skip_empty_key_groups ablation).  Query rows past N are computed (as
// zeros) and not written; a warp without a row skips the products.  The
// bias is gathered per logit from the query tile's rel_h / rel_w rows,
// staged transposed, as attention_relpos.cu's bf16 body does.
// What hides the loads: at d_pad <= 80 (16-byte path) the next tile's loads are
// issued into registers before this tile's products and split into shared
// memory after them; three blocks share an SM at d_pad <= 64 (54 KB of
// shared memory, 168 registers a thread), so one block's softmax and
// staging overlap another's products.  At d_pad = 128 the prefetch's
// registers would spill beside the 64 accumulators; it loads each tile
// after the barrier instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int LONG_N = 1024;  // from this many keys on, 128-query blocks (d_pad = 80)

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

// A block holds TQ query rows, 16 a warp: 2 TQ threads
template <int TQ>
__host__ __device__ constexpr int threads() {
  return 2 * TQ;
}

// row stride of the transposed bias tables
template <int TQ>
__host__ __device__ constexpr int ldr() {
  return TQ + 4;
}

// Per padded head dim (measured on an H100: PERF.md): the keys a K / V tile
// holds, whether the next tile's loads are in flight during this tile's
// products, and the blocks an SM holds (registers: 3 blocks of 64 rows
// leave each thread 168).  The 4-byte load path (not VEC) needs more
// registers for its loads: it takes 16-key tiles and no prefetch, which
// would spill beside the accumulators otherwise
template <int DP, bool VEC>
__host__ __device__ constexpr int tile_keys() {
  return DP == 80 && VEC ? 32 : 16;
}

template <int DP, bool VEC>
__host__ __device__ constexpr bool prefetch() {
  return VEC && DP <= 80;
}

template <int DP, int TQ>
__host__ __device__ constexpr int min_blocks() {
  return TQ == 64 && DP <= 64 ? 3 : 1;
}

// floats in a staged row of Q or K: DP / 8 k-steps of 4 split units
template <int DP>
__host__ __device__ constexpr int split_row() {
  return 2 * DP + 16;
}

template <int DP, int TQ, bool VEC>
size_t smem_bytes(int hk, int wk) {
  constexpr int R = split_row<DP>(), TK = tile_keys<DP, VEC>();
  return sizeof(float) * ((size_t)TQ * R + (size_t)TK * R + (size_t)2 * TK * DP + (size_t)ldr<TQ>() * (hk + wk));
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (to 2^-22 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small cross terms first; b = {big b0, big b1,
// small b0, small b1} as staged
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                     const uint4 b) {
  mma_tf32(c, a_small, b.x, b.y);
  mma_tf32(c, a_big, b.z, b.w);
  mma_tf32(c, a_big, b.x, b.y);
}

__device__ __forceinline__ uint4 lds128(const float* p) { return *reinterpret_cast<const uint4*>(p); }

// The staging of an operand tile is split in two: the global loads of a
// thread's chunks of 4 columns, all issued at once into registers, then the
// split and the shared stores.  Loads and stores in one loop would wait out
// an L2 round trip per chunk: the compiler may not move a global load above
// a shared store it cannot tell apart from it.
template <int TOTAL, int NT>
struct Chunks {
  static constexpr int PER = (TOTAL + NT - 1) / NT;  // chunks a thread holds
  float4 x[PER];
};

// Columns c..c + 3 of a row, c < d (ok): one 16-byte load (VEC: the view's
// rows start on 16 bytes and hold whole 16-byte chunks), else four 4-byte
// ones, those past d zeros (left = d - c)
template <bool VEC>
__device__ __forceinline__ float4 load4(bool ok, const float* p, int left) {
  if constexpr (VEC) {
    return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
    // loads of columns clamped to d - 1, then zeros past d: no predicate a load
    const int m = left - 1;
    float4 x = make_float4(p[0], p[m < 1 ? m : 1], p[m < 2 ? m : 2], p[m < 3 ? m : 3]);
    x.y = left > 1 ? x.y : 0.f;
    x.z = left > 2 ? x.z : 0.f;
    x.w = left > 3 ? x.w : 0.f;
    return x;
  }
}

// Rows [row0, row0 + ROWS) of a (N, d) operand with row stride sn, in
// chunks of 4 columns; rows past N and columns past d are zeros
template <int DP, int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_rows(Chunks<ROWS * DP / 4, NT>& ch, const float* src, int64_t sn, int row0,
                                          int N, int d) {
  constexpr int C4 = DP / 4;
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int i = threadIdx.x + it * NT, r = i / C4, c = (i - r * C4) * 4, n = row0 + r;
    ch.x[it] = load4<VEC>(i < ROWS * C4 && n < N && c < d, src + n * sn + c, d - c);
  }
}

// ... times mul, split into rows of split_row<DP>() floats: for k-step ks
// and t in 0..3 the unit {big(c), big(c + 1), small(c), small(c + 1)},
// c = 8 ks + 2 t
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void store_rows(float* dst, const Chunks<ROWS * DP / 4, NT>& ch, float mul) {
  constexpr int C4 = DP / 4, R = split_row<DP>();
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int i = threadIdx.x + it * NT, r = i / C4, c = (i - r * C4) * 4;
    if (i < ROWS * C4) {
      const float4 x = ch.x[it];
      uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
      split(x.x * mul, b0, s0);
      split(x.y * mul, b1, s1);
      split(x.z * mul, b2, s2);
      split(x.w * mul, b3, s3);
      float* u = dst + r * R + (c / 8) * 16 + (c % 8) * 2;  // units t = (c % 8) / 2 and the next
      *reinterpret_cast<uint4*>(u) = make_uint4(b0, b1, s0, s1);
      *reinterpret_cast<uint4*>(u + 4) = make_uint4(b2, b3, s2, s3);
    }
  }
}

// V's keys [k0, k0 + TK) in key pairs: chunk i holds columns c..c + 3 of
// keys a = k0 + 8 ks + 2 t (x) and a + 1 (y)
template <int DP, int TK, int NT>
struct VChunks {
  static constexpr int TOTAL = TK / 2 * DP / 4, PER = (TOTAL + NT - 1) / NT;
  float4 x[PER], y[PER];
};

template <int DP>
__device__ __forceinline__ void v_chunk(int i, int& t, int& c, int& ks) {
  constexpr int C4 = DP / 4;
  const int rest = i >> 2;
  t = i & 3;
  c = (rest % C4) * 4;
  ks = rest / C4;
}

template <int DP, int TK, int NT, bool VEC>
__device__ __forceinline__ void load_v(VChunks<DP, TK, NT>& ch, const float* src, int64_t sn, int k0, int N, int d) {
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int i = threadIdx.x + it * NT;
    int t, c, ks;
    v_chunk<DP>(i, t, c, ks);
    const int a = k0 + ks * 8 + 2 * t;
    const bool ok = i < ch.TOTAL && c < d;
    ch.x[it] = load4<VEC>(ok && a < N, src + a * sn + c, d - c);
    ch.y[it] = load4<VEC>(ok && a + 1 < N, src + (a + 1) * sn + c, d - c);
  }
}

// ... split: for 8-key step ks, column c and t in 0..3, the unit
// {big(v[a][c]), big(v[a + 1][c]), small(v[a][c]), small(v[a + 1][c])} at
// ((ks DP + c) 4 + t) 4: the B fragment of P V that lane (g = c % 8, t)
// reads
template <int DP, int TK, int NT>
__device__ __forceinline__ void store_v(float* dst, const VChunks<DP, TK, NT>& ch) {
#pragma unroll
  for (int it = 0; it < ch.PER; ++it) {
    const int i = threadIdx.x + it * NT;
    int t, c, ks;
    v_chunk<DP>(i, t, c, ks);
    if (i < ch.TOTAL) {
      const float va[4] = {ch.x[it].x, ch.x[it].y, ch.x[it].z, ch.x[it].w};
      const float vb[4] = {ch.y[it].x, ch.y[it].y, ch.y[it].z, ch.y[it].w};
      float* u = dst + ((ks * DP + c) * 4 + t) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ba, bb, sa, sb;
        split(va[j], ba, sa);
        split(vb[j], bb, sb);
        *reinterpret_cast<uint4*>(u + j * 16) = make_uint4(ba, bb, sa, sb);
      }
    }
  }
}

template <int DP, bool HAS_BIAS, int TQ, bool VEC>
__global__ void __launch_bounds__(threads<TQ>(), (min_blocks<DP, TQ>())) attn_f32_kernel(const Args a) {
  constexpr int NT = threads<TQ>(), LDR = ldr<TQ>();
  constexpr int R = split_row<DP>();
  constexpr int KS = DP / 8;   // k-steps of S = Q K^T; n-tiles of O
  constexpr int TK = tile_keys<DP, VEC>();
  constexpr int NTK = TK / 8;  // n-tiles of S; k-steps of P V
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // TQ x R, split, times d^-1/2 log2(e)
  float* Ks = Qs + TQ * R;         // TK x R, split
  float* Vs = Ks + TK * R;         // 2 TK DP, split key pairs
  float* RhT = Vs + 2 * TK * DP;   // hk x LDR, times log2(e): RhT[kh][query]
  float* RwT = RhT + LDR * a.hk;   // wk x LDR

  const int N = a.N, d = a.d, hk = a.hk, wk = a.wk;
  const int bh = blockIdx.x;
  const int b = bh / a.nh, h = bh % a.nh;
  const int q0 = blockIdx.y * TQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma row group and thread-in-group

  const float* qp = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;

  // the query tile's and the first K / V tile's loads all in flight at once
  Chunks<TK * DP / 4, NT> kc;
  VChunks<DP, TK, NT> vc;
  {
    Chunks<TQ * DP / 4, NT> qc;
    load_rows<DP, TQ, NT, VEC>(qc, qp, a.sq_n, q0, N, d);
    load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, 0, N, d);
    load_v<DP, TK, NT, VEC>(vc, vp, a.sv_n, 0, N, d);
    store_rows<DP, TQ, NT>(Qs, qc, a.scale * LOG2E);
  }
  if constexpr (HAS_BIAS) {
    const float* rhp = static_cast<const float*>(a.rel_h) + ((int64_t)bh * N + q0) * hk;
    const float* rwp = static_cast<const float*>(a.rel_w) + ((int64_t)bh * N + q0) * wk;
    for (int i = threadIdx.x; i < TQ * hk; i += NT) {
      const int r = i / hk, c = i - r * hk;
      RhT[c * LDR + r] = q0 + r < N ? rhp[i] * LOG2E : 0.f;
    }
    for (int i = threadIdx.x; i < TQ * wk; i += NT) {
      const int r = i / wk, c = i - r * wk;
      RwT[c * LDR + r] = q0 + r < N ? rwp[i] * LOG2E : 0.f;
    }
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows of the tile
  const bool live = q0 + warp * 16 < N;       // the warp holds a query row
  float o[KS][4];
#pragma unroll
  for (int nt = 0; nt < KS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  for (int k0 = 0; k0 < N; k0 += TK) {
    if (k0 > 0) {
      __syncthreads();  // the previous tile's readers are done
      if constexpr (!prefetch<DP, VEC>()) {
        load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, k0, N, d);
        load_v<DP, TK, NT, VEC>(vc, vp, a.sv_n, k0, N, d);
      }
    }
    store_rows<DP, TK, NT>(Ks, kc, 1.f);
    store_v<DP, TK, NT>(Vs, vc);
    __syncthreads();
    if constexpr (prefetch<DP, VEC>()) {
      if (k0 + TK < N) {  // the next tile's loads in flight during this tile's products
        load_rows<DP, TK, NT, VEC>(kc, kp, a.sk_n, k0 + TK, N, d);
        load_v<DP, TK, NT, VEC>(vc, vp, a.sv_n, k0 + TK, N, d);
      }
    }
    if (!live) continue;

    // S = Q K^T
    float s[NTK][4];
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint4 x0 = lds128(Qs + r0 * R + ks * 16 + t * 4);
      const uint4 x1 = lds128(Qs + r1 * R + ks * 16 + t * 4);
      const uint32_t qb[4] = {x0.x, x1.x, x0.y, x1.y}, qs[4] = {x0.z, x1.z, x0.w, x1.w};
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt)
        mma3(s[nt], qb, qs, lds128(Ks + (nt * 8 + g) * R + ks * 16 + t * 4));
    }

    // bias and mask; this thread's keys are k0 + 8 nt + 2t (+1)
    if constexpr (HAS_BIAS) {
      int kh = (k0 + 2 * t) / wk, kw = k0 + 2 * t - kh * wk;
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
        if (nt > 0) {
          kw += 8;
          while (kw >= wk) {
            kw -= wk;
            ++kh;
          }
        }
        const int key = k0 + nt * 8 + 2 * t;
        const int kh1 = kw + 1 < wk ? kh : kh + 1, kw1 = kw + 1 < wk ? kw + 1 : 0;
        if (key < N) {  // the tables hold rows of live keys only
          s[nt][0] += RhT[kh * LDR + r0] + RwT[kw * LDR + r0];
          s[nt][2] += RhT[kh * LDR + r1] + RwT[kw * LDR + r1];
        }
        if (key + 1 < N) {
          s[nt][1] += RhT[kh1 * LDR + r0] + RwT[kw1 * LDR + r0];
          s[nt][3] += RhT[kh1 * LDR + r1] + RwT[kw1 * LDR + r1];
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const int key = k0 + nt * 8 + 2 * t;
      if (key >= N) s[nt][0] = s[nt][2] = -INFINITY;
      if (key + 1 >= N) s[nt][1] = s[nt][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a live key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O = O c + P V: group j's accumulator, split, is the A fragment of
    // k-step j (k = t holds key 2t, k = t + 4 key 2t + 1).  The tile's sum
    // starts from 0 and joins O in one f32 add: the tensor cores' f32 sums
    // round toward 0, which over thousands of keys in one accumulator would
    // bias O by ~1e-4 of itself
    float ot[KS][4];
#pragma unroll
    for (int nt = 0; nt < KS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[nt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NTK; ++j) {
      uint32_t pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) mma3(ot[nt], pb, ps, lds128(Vs + ((j * DP + nt * 8 + g) * 4 + t) * 4));
    }
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      o[nt][0] = fmaf(o[nt][0], c0, ot[nt][0]);
      o[nt][1] = fmaf(o[nt][1], c0, ot[nt][1]);
      o[nt][2] = fmaf(o[nt][2], c1, ot[nt][2]);
      o[nt][3] = fmaf(o[nt][3], c1, ot[nt][3]);
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
  for (int nt = 0; nt < KS; ++nt) {
    const int col = nt * 8 + 2 * t;
    if constexpr (VEC) {
      if (col < d) {  // d % 4 == 0: the pair (col, col + 1) is whole, on 8 bytes
        if (n0 < N) *reinterpret_cast<float2*>(out0 + nt * 8) = make_float2(o[nt][0] * inv0, o[nt][1] * inv0);
        if (n1 < N) *reinterpret_cast<float2*>(out1 + nt * 8) = make_float2(o[nt][2] * inv1, o[nt][3] * inv1);
      }
    } else {
      if (col < d && n0 < N) out0[nt * 8] = o[nt][0] * inv0;
      if (col + 1 < d && n0 < N) out0[nt * 8 + 1] = o[nt][1] * inv0;
      if (col < d && n1 < N) out1[nt * 8] = o[nt][2] * inv1;
      if (col + 1 < d && n1 < N) out1[nt * 8 + 1] = o[nt][3] * inv1;
    }
  }
}

template <int DP, bool HAS_BIAS, int TQ, bool VEC>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, TQ, VEC>(a.hk, a.wk);
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
// queries instead of 64 pays (kernel 2's 3072 keys: 1.48x); 64 else, where
// fewer, larger blocks lose (PERF.md).  4-byte loads (not VEC) in 64-query
// blocks
template <int DP, bool HAS_BIAS>
cudaError_t launch_dp(const Args& a, bool vec, cudaStream_t stream) {
  if (!vec) return launch_tile<DP, HAS_BIAS, 64, false>(a, stream);
  if constexpr (DP == 80) {
    if (a.N >= LONG_N && smem_bytes<DP, 128, true>(a.hk, a.wk) <= SMEM_LIMIT)
      return launch_tile<DP, HAS_BIAS, 128, true>(a, stream);
  }
  return launch_tile<DP, HAS_BIAS, 64, true>(a, stream);
}

template <bool HAS_BIAS>
cudaError_t launch(const Args& a, void* stream) {
  const bool grid_ok = HAS_BIAS ? a.hk >= 1 && a.wk >= 1 && a.N == a.hk * a.wk
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
