// Streaming attention for Hopper (sm_90a), with or without SAM's decomposed
// relative-position bias:
//
//   out[b, n, h*d:(h+1)*d] = softmax_k(q_n . k_k * d^-1/2
//                                      [+ rel_h[b, h, n, k / wk]
//                                       + rel_w[b, h, n, k % wk]]) . v
//
// with the bias over a (hk x wk) key grid, N = hk * wk keys, keys in
// row-major order.
//
// The streaming design, the first of the three that replace the Pallas TPU
// kernels of the JAX package (pope_tpu/ops/flash_attention.py::
// flash_attention_relpos and flash_attention, pope_tpu/ops/
// window_attention.py::windowed_attention_relpos).  The main path no longer
// runs it: SAM's windows and DINOv2's 197 tokens take attention_short.cu,
// SAM's global layers attention_long.cu.  It takes what those two do not:
// float32, head dims other than 32, 64 and 80 (in float32), bias grids of
// hk + wk > 500; ops/cuda_kernels.py::attention_design decides by shape,
// and launch_attention(_relpos)(..., design="stream") forces it, as
// chip_smoke.py does to time it beside the newer designs.
// The bias and the bias-free kernels are one template each (HAS_BIAS); the
// bias-free instantiation drops the rel-table staging and the per-logit
// gather.  The C entries are pope_attention_relpos and pope_attention, both
// taking views of their callers' qkv layouts.  In
// bf16 the softmax weights are rounded to bf16 for the p . v product, as the
// TPU's windowed kernel does; the TPU's global kernel kept them in f32,
// which the bf16 tolerance its tests hold it to allows.
//
// Layout.  q, k and v are read through strides as (B, N, nh, d) views with a
// unit last stride, so both callers hand over column slices of the qkv Dense
// output (B, N, 3 * nh * d) as they are: no reshape or transpose copy.  The
// bias tables rel_h (B, nh, N, hk) and rel_w (B, nh, N, wk) are contiguous.
// The output (B, N, nh * d) is the `proj` Dense input layout.
//
// Design.  One block per (b * nh + h, 64-query tile).  Keys and values
// stream through shared memory in 64-key tiles with an f32 online softmax
// (FlashAttention-2 order), and the bias is gathered directly: key k of a
// tile reads Rh[q][k / wk] + Rw[q][k % wk] from the query tile's rel_h /
// rel_w rows, staged in shared memory.  The TPU kernels had to expand the
// tables with 0/1 matmuls because Mosaic has no gather.  Two bodies, by
// dtype:
//   - bf16 (the global layers on the main path): tensor cores through mma.sync m16n8k16 with f32
//     accumulation, 4 warps of 16 query rows, FlashAttention-2's reuse of
//     the S accumulators as the A operand of P V (attn_relpos_mma_kernel).
//     It takes head dims 32, 64 and 80 and q/k/v rows that can be read 16
//     bytes at a time; the wrapper raises on anything else;
//   - float32 (the f32 encoder configs): f32 FMAs on the CUDA cores, 256
//     threads owning 4 x 4 logits each (attn_relpos_kernel).
//
// What bounds it on an H100.  Kernel-2 shapes (SAM ViT-H global layer, B=4
// 640x480 frames: 64 heads, N = 3072, d = 80) do ~193 GFLOP on ~170 MB:
// operations bound it, ~195 us at the 989 TFLOP/s bf16 tensor-core peak.
// mma.sync reaches a fraction of that peak (wgmma is Hopper's full-rate
// path), each 64-row block reads its head's whole K and V, and there is no
// TMA / warp-specialised pipeline: it took 7.4x the bound there, which is
// why those shapes moved to attention_long.cu.  At the short shapes (N =
// 196/197) this design read K and V once per 64-query tile and did 59% live
// work, which is why those moved to attention_short.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;     // query rows per block
constexpr int TK = 64;     // keys per streamed tile
constexpr int NT = 256;    // threads per block, 16 x 16
constexpr int DMAX = 128;  // largest head dim
constexpr int DC = DMAX / 16;

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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int d, int hk, int wk) {
  return sizeof(float) * ((size_t)TQ * (d + 1) + (size_t)TK * (d + 1) + (size_t)TK * d +
                          (size_t)TQ * (TK + 1) + (size_t)TQ * hk + (size_t)TQ * wk);
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(NT) attn_relpos_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d, hk = a.hk, wk = a.wk, N = a.N;
  const int ld = d + 1;
  float* Qs = smem;                  // TQ x ld, pre-scaled
  float* Ks = Qs + TQ * ld;          // TK x ld
  float* Vs = Ks + TK * ld;          // TK x d
  float* Ps = Vs + TK * d;           // TQ x (TK + 1)
  float* Rh = Ps + TQ * (TK + 1);    // TQ x hk
  float* Rw = Rh + TQ * hk;          // TQ x wk

  const int bh = blockIdx.y;
  const int b = bh / a.nh, h = bh % a.nh;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* qp = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;
  const float* rhp = static_cast<const float*>(a.rel_h) + (int64_t)bh * N * hk;
  const float* rwp = static_cast<const float*>(a.rel_w) + (int64_t)bh * N * wk;

  for (int i = tid; i < TQ * d; i += NT) {
    const int r = i / d, c = i - r * d, n = q0 + r;
    Qs[r * ld + c] = n < N ? qp[n * a.sq_n + c] * a.scale : 0.f;
  }
  if constexpr (HAS_BIAS) {
    for (int i = tid; i < TQ * hk; i += NT) {
      const int n = q0 + i / hk;
      Rh[i] = n < N ? rhp[(int64_t)q0 * hk + i] : 0.f;
    }
    for (int i = tid; i < TQ * wk; i += NT) {
      const int n = q0 + i / wk;
      Rw[i] = n < N ? rwp[(int64_t)q0 * wk + i] : 0.f;
    }
  }

  const int dcols = (d + 15) / 16;
  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) o[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TK * d; i += NT) {
      const int r = i / d, c = i - r * d, n = k0 + r;
      const bool ok = n < N;
      Ks[r * ld + c] = ok ? kp[n * a.sk_n + c] : 0.f;
      Vs[r * d + c] = ok ? vp[n * a.sv_n + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    int kh[4] = {0, 0, 0, 0}, kw[4] = {0, 0, 0, 0};
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = k0 + tx + 16 * j;
      live[j] = n < N;
      if constexpr (HAS_BIAS) {
        kh[j] = n / wk;
        kw[j] = n - kh[j] * wk;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) {
          s[i][j] = -INFINITY;
        } else if constexpr (HAS_BIAS) {
          s[i][j] += Rh[r * hk + kh[j]] + Rw[r * wk + kw[j]];
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[r * (TK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) o[i][jj] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < TK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (TK + 1) + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        if (jj < dcols) {
          const int c = tx + 16 * jj;
          const float vv = c < d ? Vs[kk * d + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][jj] = fmaf(pv[i], vv, o[i][jj]);
        }
      }
    }
  }

  float* op = static_cast<float*>(a.out);
  const int64_t C = (int64_t)a.nh * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty + 16 * i;
    if (n >= N) continue;
    const float inv = 1.f / l[i];
    float* row = op + ((int64_t)b * N + n) * C + (int64_t)h * d;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int c = tx + 16 * jj;
      if (jj < dcols && c < d) row[c] = o[i][jj] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (mma.sync m16n8k16, f32 accumulate).
//
// One block of 4 warps per (b * nh + h, 64-query tile); each warp owns 16
// query rows and keeps their q fragments, its slice of the output and the
// row statistics in registers.  K and V tiles of 64 keys stream into a
// double buffer in shared memory with cp.async, the next tile's copy in
// flight while the current one is computed.  Per tile: S = Q K^T (K
// fragments by ldmatrix), scale + gathered bias + mask on the accumulators,
// online softmax (row max and sum over the 4 lanes that share a row), then
// the accumulators are repacked as the A operand of P V (FlashAttention-2's
// register reuse), V fragments by ldmatrix.trans.  P is rounded to bf16 for
// that product, as in the TPU's windowed kernel; the TPU's global kernel
// kept P in f32, which is within the bf16 tolerance the two are held to.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = 32 * MMA_WARPS;
constexpr int KPAD = 8;  // bf16 padding of a shared K / V row (conflict-free ldmatrix)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem_ptr),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int LDR = TQ + 4;  // row stride of the transposed bias tables

size_t mma_smem_bytes(int d, int hk, int wk) {
  return sizeof(__nv_bfloat16) * 4 * (size_t)TK * (d + KPAD) + sizeof(float) * (size_t)LDR * (hk + wk);
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(MMA_NT) attn_relpos_mma_kernel(const Args a) {
  constexpr int DK = D / 16;  // k-steps of S = Q K^T
  constexpr int DN = D / 8;   // n-tiles of O, even as D % 16 == 0
  constexpr int LD = D + KPAD;
  constexpr int CH = D / 8;   // 16-byte chunks per K / V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Kbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 x TK x LD
  __nv_bfloat16* Vbuf = Kbuf + 2 * TK * LD;                            // 2 x TK x LD
  // bias tables transposed, RhT[kh][q] and RwT[kw][q]: the 8 query rows x
  // 4 key columns a warp gathers at once fall in 32 distinct banks
  float* RhT = reinterpret_cast<float*>(Vbuf + 2 * TK * LD);  // hk x LDR
  float* RwT = RhT + LDR * a.hk;                              // wk x LDR

  const int N = a.N, hk = a.hk, wk = a.wk;
  const int bh = blockIdx.y;
  const int b = bh / a.nh, h = bh % a.nh;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma row group and thread-in-group

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq_b + h * a.sq_h;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk_b + h * a.sk_h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv_b + h * a.sv_h;
  const __nv_bfloat16* rhp = static_cast<const __nv_bfloat16*>(a.rel_h) + (int64_t)bh * N * hk;
  const __nv_bfloat16* rwp = static_cast<const __nv_bfloat16*>(a.rel_w) + (int64_t)bh * N * wk;

  auto load_tile = [&](int k0, int buf) {
    __nv_bfloat16* Ks = Kbuf + buf * TK * LD;
    __nv_bfloat16* Vs = Vbuf + buf * TK * LD;
    for (int i = tid; i < TK * CH; i += MMA_NT) {
      const int r = i / CH, c = (i - r * CH) * 8, n = k0 + r;
      const int nn = n < N ? n : N - 1;  // a valid address; zero-filled below
      const int bytes = n < N ? 16 : 0;
      cp_async16(Ks + r * LD + c, kp + nn * a.sk_n + c, bytes);
      cp_async16(Vs + r * LD + c, vp + nn * a.sv_n + c, bytes);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  if constexpr (HAS_BIAS) {
    for (int i = tid; i < TQ * hk; i += MMA_NT) {
      const int r = i / hk, c = i - r * hk;
      RhT[c * LDR + r] = q0 + r < N ? __bfloat162float(rhp[(int64_t)q0 * hk + i]) : 0.f;
    }
    for (int i = tid; i < TQ * wk; i += MMA_NT) {
      const int r = i / wk, c = i - r * wk;
      RwT[c * LDR + r] = q0 + r < N ? __bfloat162float(rwp[(int64_t)q0 * wk + i]) : 0.f;
    }
  }

  // this warp's 16 query rows as A fragments: rows r0 = g and r1 = g + 8
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int n0 = q0 + r0, n1 = q0 + r1;
  uint32_t qf[DK][4];
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    const int c = ks * 16 + 2 * t;
    const uint32_t* row0 = reinterpret_cast<const uint32_t*>(qp + n0 * a.sq_n + c);
    const uint32_t* row1 = reinterpret_cast<const uint32_t*>(qp + n1 * a.sq_n + c);
    qf[ks][0] = n0 < N ? row0[0] : 0u;
    qf[ks][1] = n1 < N ? row1[0] : 0u;
    qf[ks][2] = n0 < N ? row0[4] : 0u;
    qf[ks][3] = n1 < N ? row1[4] : 0u;
  }

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // l: per-thread partial sums

  // ldmatrix lane roles: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;

  const int n_tiles = (N + TK - 1) / TK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * TK;
    if (it + 1 < n_tiles) {
      load_tile(k0 + TK, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = Kbuf + (it & 1) * TK * LD;
    const __nv_bfloat16* Vs = Vbuf + (it & 1) * TK * LD;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two key n-tiles
    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK; ++ks) {
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale, bias and mask; this thread's keys are k0 + 2t + 8 nt (+1)
    if constexpr (HAS_BIAS) {
      int kh = (k0 + 2 * t) / wk, kw = k0 + 2 * t - kh * wk;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
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
          s[nt][0] = s[nt][0] * a.scale + RhT[kh * LDR + r0] + RwT[kw * LDR + r0];
          s[nt][2] = s[nt][2] * a.scale + RhT[kh * LDR + r1] + RwT[kw * LDR + r1];
        }
        if (key + 1 < N) {
          s[nt][1] = s[nt][1] * a.scale + RhT[kh1 * LDR + r0] + RwT[kw1 * LDR + r0];
          s[nt][3] = s[nt][3] * a.scale + RhT[kh1 * LDR + r1] + RwT[kw1 * LDR + r1];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= a.scale;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
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
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= c0;
      o[dn][1] *= c0;
      o[dn][2] *= c1;
      o[dn][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O += P V: one ldmatrix.x4.trans gives the B fragments of two dim n-tiles
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const uint32_t pf[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vrow = Vs + (j * 16 + (mi & 1) * 8 + mr) * LD;
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + (dp * 2 + (mi >> 1)) * 8);
        mma_bf16(o[2 * dp], pf, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out);
  const int64_t C = (int64_t)a.nh * D;
  __nv_bfloat16* out0 = op + ((int64_t)b * N + n0) * C + (int64_t)h * D + 2 * t;
  __nv_bfloat16* out1 = op + ((int64_t)b * N + n1) * C + (int64_t)h * D + 2 * t;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    if (n0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out0 + dn * 8) =
          __floats2bfloat162_rn(o[dn][0] * inv0, o[dn][1] * inv0);
    if (n1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out1 + dn * 8) =
          __floats2bfloat162_rn(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

template <int D, bool HAS_BIAS>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D, a.hk, a.wk);
  cudaError_t err = cudaFuncSetAttribute(attn_relpos_mma_kernel<D, HAS_BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, a.B * a.nh);
  attn_relpos_mma_kernel<D, HAS_BIAS><<<grid, MMA_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

bool valid_args(const Args& a, bool has_bias) {
  const bool grid_ok = has_bias ? a.hk >= 1 && a.wk >= 1 && a.N == a.hk * a.wk
                                : a.hk == 0 && a.wk == 0 && a.N >= 1;
  return a.d >= 1 && a.d <= DMAX && grid_ok && a.B >= 1 && a.nh >= 1;
}

template <bool HAS_BIAS>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d, a.hk, a.wk);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_relpos_kernel<HAS_BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, a.B * a.nh);
  attn_relpos_kernel<HAS_BIAS><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool HAS_BIAS>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const uintptr_t ptrs = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  const int64_t strides = a.sq_b | a.sq_n | a.sq_h | a.sk_b | a.sk_n | a.sk_h | a.sv_b | a.sv_n |
                          a.sv_h;
  if (ptrs % 16 != 0 || strides % 8 != 0) return cudaErrorInvalidValue;
  // the head dims of the shipped configs (SAM ViT-B/L and DINOv2 64, ViT-H
  // 80) and the tests' 32
  switch (a.d) {
    case 32: return launch_mma<32, HAS_BIAS>(a, stream);
    case 64: return launch_mma<64, HAS_BIAS>(a, stream);
    case 80: return launch_mma<80, HAS_BIAS>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool HAS_BIAS>
cudaError_t launch(const Args& a, int is_bf16, void* stream) {
  if (!valid_args(a, HAS_BIAS)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16<HAS_BIAS>(a, st) : launch_f32<HAS_BIAS>(a, st);
}

}  // namespace

// The rel-pos kernels: the windowed layers (ops/window_attention.py) and the
// global layers (ops/flash_attention.py).  Strides are in elements.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// the kernels do not take.
extern "C" int pope_attention_relpos(const void* q, const void* k, const void* v,
                                     const void* rel_h, const void* rel_w, void* out,
                                     int64_t sq_b, int64_t sq_n, int64_t sq_h, int64_t sk_b,
                                     int64_t sk_n, int64_t sk_h, int64_t sv_b, int64_t sv_n,
                                     int64_t sv_h, int B, int N, int nh, int d, int hk, int wk,
                                     float scale, int is_bf16, void* stream) {
  const Args a{q,    k,    v,    rel_h, rel_w, out, sq_b, sq_n, sq_h, sk_b, sk_n,
               sk_h, sv_b, sv_n, sv_h,  B,     N,   nh,   d,    hk,   wk,   scale};
  return launch<true>(a, is_bf16, stream);
}

// The bias-free kernel (ops/flash_attention.py::flash_attention), any N.
extern "C" int pope_attention(const void* q, const void* k, const void* v, void* out,
                              int64_t sq_b, int64_t sq_n, int64_t sq_h, int64_t sk_b,
                              int64_t sk_n, int64_t sk_h, int64_t sv_b, int64_t sv_n,
                              int64_t sv_h, int B, int N, int nh, int d, float scale,
                              int is_bf16, void* stream) {
  const Args a{q,    k,    v,    nullptr, nullptr, out, sq_b, sq_n, sq_h, sk_b, sk_n,
               sk_h, sv_b, sv_n, sv_h,    B,       N,   nh,   d,    0,    0,    scale};
  return launch<false>(a, is_bf16, stream);
}

extern "C" const char* pope_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
