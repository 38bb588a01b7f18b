// Shared device code of the kernels in this directory.
//
// - Mma<T>: a 16x16x16 warp-level matrix product with fp32 accumulators.
//   bf16 runs on the tensor cores through nvcuda::wmma (mma.sync); fp32
//   takes the same tiling with fp32 FMA on the CUDA cores, so both compute
//   types share every kernel below.
// - stage_rows / stage_rows_scaled: a (64, D) tile of a row-major plane
//   into shared memory (the attention kernels, forward and backward).
// - ln_stats: per-row LayerNorm statistics (fp32, two passes), read by the
//   GEMM prologue.
// - gemm: a tiled (M, K) x (K, N) product, A and W row-major, with an
//   optional LayerNorm applied while the A tile is staged into shared
//   memory and one of four epilogues (QKV scatter, QKV scatter with a
//   bias, bias, bias + act).
//
// Rounding follows the TPU kernels (vitx/kernels/mha_block.py::_kernel,
// vitx/kernels/mlp_block.py::_kernel): products accumulate in fp32 and
// every intermediate is cast to the compute dtype exactly where they cast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace vitx {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value after a cast to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16 bytes of bf16 (8) or fp32 (4) as floats, and back (the LayerNorm
// kernels' one-pass routes)
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint4 v;
  uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    p[i] = *reinterpret_cast<uint32_t*>(&t);
  }
  return v;
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__host__ __device__ constexpr int align_up(int v, int a) {
  return (v + a - 1) / a * a;
}

// ---------------------------------------------------------------------------
// Warp-level 16x16x16 product. Acc holds a 16x16 fp32 tile; store() writes
// it row-major to shared memory, which is how every epilogue reads it.
// ---------------------------------------------------------------------------

template <typename T> struct Mma;

template <> struct Mma<bf16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  template <bool B_COL>
  using FragB = wmma::fragment<
      wmma::matrix_b, 16, 16, 16, bf16,
      typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type>;

  __device__ static void zero(Acc& c) { wmma::fill_fragment(c, 0.0f); }
  __device__ static void load_a(FragA& f, const bf16* p, int ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
  template <typename FB>
  __device__ static void load_b(FB& f, const bf16* p, int ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
  template <typename FB>
  __device__ static void mma(Acc& c, const FragA& a, const FB& b) {
    wmma::mma_sync(c, a, b, c);
  }
  __device__ static void store(float* dst, const Acc& c, int ld) {
    wmma::store_matrix_sync(dst, c, ld, wmma::mem_row_major);
  }
};

// fp32: lane l owns row l/2, columns 8*(l%2) .. +8 of the tile.
template <> struct Mma<float> {
  struct Acc { float v[8]; };
  struct FragA { const float* p; int ld; };
  template <bool B_COL> struct FragB { const float* p; int ld; };

  __device__ static void zero(Acc& c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c.v[j] = 0.0f;
  }
  __device__ static void load_a(FragA& f, const float* p, int ld) {
    f.p = p;
    f.ld = ld;
  }
  template <bool B_COL>
  __device__ static void load_b(FragB<B_COL>& f, const float* p, int ld) {
    f.p = p;
    f.ld = ld;
  }
  template <bool B_COL>
  __device__ static void mma(Acc& c, const FragA& a, const FragB<B_COL>& b) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = a.p[r * a.ld + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = B_COL ? b.p[(c0 + j) * b.ld + k] : b.p[k * b.ld + c0 + j];
        c.v[j] = fmaf(av, bv, c.v[j]);
      }
    }
  }
  __device__ static void store(float* dst, const Acc& c, int ld) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + c0 + j] = c.v[j];
  }
};

// Rows [row0, row0 + 64) x cols [0, DP) of a (rows, D) plane into shared
// memory with row stride ld; zero beyond nrows and beyond D. NT threads.
template <typename T, int DP, int NT>
__device__ void stage_rows(T* dst, int ld, const T* __restrict__ src, int row0,
                           int nrows, int D) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC == 0) {
    for (int idx = threadIdx.x; idx < 64 * (DP / VEC); idx += NT) {
      const int r = idx / (DP / VEC), c = (idx % (DP / VEC)) * VEC;
      const int t = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < nrows && c < D) v = *reinterpret_cast<const uint4*>(src + (size_t)t * D + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      const int t = row0 + r;
      dst[r * ld + c] = (t < nrows && c < D) ? src[(size_t)t * D + c] : from_f<T>(0.0f);
    }
  }
}

// The same tile, each element cast(src * f) with f = fac[r] (a per-row
// factor in shared memory) or, when fac is null, f = uni: the rounding of
// jnp's (a.astype(f32) * f).astype(dtype). 16-byte loads when D allows.
template <typename T, int DP, int NT>
__device__ void stage_rows_scaled(T* dst, int ld, const T* __restrict__ src, int row0,
                                  int nrows, int D, const float* fac, float uni) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC == 0) {
    for (int idx = threadIdx.x; idx < 64 * (DP / VEC); idx += NT) {
      const int r = idx / (DP / VEC), c = (idx % (DP / VEC)) * VEC;
      const int t = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < nrows && c < D) {
        v = *reinterpret_cast<const uint4*>(src + (size_t)t * D + c);
        const float f = fac ? fac[r] : uni;
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(to_f(e[j]) * f);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      const int t = row0 + r;
      float v = 0.0f;
      if (t < nrows && c < D) v = to_f(src[(size_t)t * D + c]) * (fac ? fac[r] : uni);
      dst[r * ld + c] = from_f<T>(v);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm statistics: one warp per row of x (M, K). stats[r] = mean,
// stats[M + r] = 1/sqrt(var + eps), both fp32, var from a second pass over
// (x - mean) as at mha_block.py:51-55.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void ln_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                                int M, int K, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float s = 0.0f;
  for (int k = lane; k < K; k += 32) s += to_f(xr[k]);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f(xr[k]) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / (float)K;
  if (lane == 0) {
    stats[row] = mean;
    stats[M + row] = 1.0f / sqrtf(var + eps);
  }
}

template <typename T>
inline cudaError_t launch_ln_stats(const T* x, float* stats, int M, int K,
                                   float eps, cudaStream_t s) {
  ln_stats_kernel<T><<<(M + 7) / 8, 256, 0, s>>>(x, stats, M, K, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Activations, in fp32, in the forms of vitx/kernels/mlp_block.py:34-64.
// ---------------------------------------------------------------------------

enum Act { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2 };

__device__ __forceinline__ float gelu_erf_poly(float x) {
  const float xs = x * 0.7071067811865475f;
  const float a = fabsf(xs);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sgn = xs > 0.0f ? 1.0f : (xs < 0.0f ? -1.0f : 0.0f);
  const float erf = sgn * (1.0f - poly * expf(-a * a));
  return 0.5f * x * (1.0f + erf);
}

__device__ __forceinline__ float gelu_tanh_exp(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  const float t = 1.0f - 2.0f / (expf(2.0f * u) + 1.0f);
  return 0.5f * x * (1.0f + t);
}

__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_GELU) return gelu_erf_poly(x);
  if (act == ACT_GELU_TANH) return gelu_tanh_exp(x);
  return fmaxf(x, 0.0f);
}

// ---------------------------------------------------------------------------
// Tiled GEMM: out = epilogue(prologue(A) @ W), A (M, K), W (K, N).
// Block tile 128 x 128 x 32, 8 warps as 2 x 4, each warp 64 x 32 (4 x 2
// tiles of 16 x 16). The next K tile is read into registers while the
// current one is multiplied (double-buffered shared memory).
// ---------------------------------------------------------------------------

// EPI_QKV_BIAS: EPI_QKV with an fp32 bias added to the accumulator before
// the one cast (B8, vitx/kernels/mha_block.py:518-521); EPI_QKV's code is
// unchanged by it.
enum Epi { EPI_QKV = 0, EPI_BIAS = 1, EPI_BIAS_ACT = 2, EPI_QKV_BIAS = 3 };

struct GemmArgs {
  const void* a;           // (M, K) compute dtype
  const void* w;           // (K, N) compute dtype
  int M, N, K;
  const float* ln_stats;   // (2, M) mean / rstd of A's rows (LN prologue)
  const float* ln_g;       // (K,) LN scale
  const float* ln_b;       // (K,) LN bias
  const float* bias;       // (N,) fp32 (EPI_BIAS, EPI_BIAS_ACT, EPI_QKV_BIAS)
  void* out;
  void* pre_act;           // EPI_BIAS_ACT: also write cast(A @ W + bias) here
                           // when not null (the stash of the MLP's VJP)
  int act;                 // EPI_BIAS_ACT
  int T, H, D;             // EPI_QKV(_BIAS): rows are (b, t); out is (3, B, H, T, D)
};

constexpr int GBM = 128, GBN = 128, GBK = 32, GNT = 256;
constexpr int CS_LD = 20;  // per-warp 16x16 fp32 staging tile, padded

template <typename T> struct GemmSmem {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDA = GBK + PAD;
  static constexpr int LDB = GBN + PAD;
  static constexpr int A_BYTES = align_up(2 * GBM * LDA * (int)sizeof(T), 128);
  static constexpr int B_BYTES = align_up(2 * GBK * LDB * (int)sizeof(T), 128);
  static constexpr int C_BYTES = 8 * 16 * CS_LD * 4;
  static constexpr int BYTES = A_BYTES + B_BYTES + C_BYTES;
};

template <typename T>
__device__ __forceinline__ void unpack8(const uint4* src, float* f) {
  if constexpr (sizeof(T) == 2) {
    const bf16* h = reinterpret_cast<const bf16*>(src);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
  } else {
    const float* h = reinterpret_cast<const float*>(src);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = h[e];
  }
}

template <typename T, int EPI, bool LN>
__global__ void __launch_bounds__(GNT)
gemm_kernel(const GemmArgs args) {
  using S = GemmSmem<T>;
  using M_ = Mma<T>;
  constexpr int VEC = 16 / sizeof(T);                 // elements per 16 bytes
  constexpr int A_IT = GBM * GBK / (VEC * GNT);
  constexpr int B_IT = GBK * GBN / (VEC * GNT);
  constexpr int A_VPR = GBK / VEC;                    // vectors per A row
  constexpr int B_VPR = GBN / VEC;

  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + S::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem + S::A_BYTES + S::B_BYTES);

  const T* __restrict__ A = static_cast<const T*>(args.a);
  const T* __restrict__ W = static_cast<const T*>(args.w);
  const int M = args.M, N = args.N, K = args.K;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bool a_vec = (K % VEC) == 0, b_vec = (N % VEC) == 0;

  uint4 ra[A_IT], rb[B_IT];

  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int idx = tid + i * GNT;
      const int r = idx / A_VPR, k = k0 + (idx % A_VPR) * VEC;
      const int gr = m0 + r;
      if (gr < M && a_vec && k + VEC <= K) {
        ra[i] = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k);
      } else {
        T* e = reinterpret_cast<T*>(&ra[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          e[j] = (gr < M && k + j < K) ? A[(size_t)gr * K + k + j] : from_f<T>(0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int idx = tid + i * GNT;
      const int r = idx / B_VPR, c = n0 + (idx % B_VPR) * VEC;
      const int gk = k0 + r;
      if (gk < K && b_vec && c + VEC <= N) {
        rb[i] = *reinterpret_cast<const uint4*>(W + (size_t)gk * N + c);
      } else {
        T* e = reinterpret_cast<T*>(&rb[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          e[j] = (gk < K && c + j < N) ? W[(size_t)gk * N + c + j] : from_f<T>(0.0f);
      }
    }
  };

  auto store_shared = [&](int buf, int k0) {
    T* as = As + buf * GBM * S::LDA;
    T* bs = Bs + buf * GBK * S::LDB;
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int idx = tid + i * GNT;
      const int r = idx / A_VPR, kk = (idx % A_VPR) * VEC;
      if constexpr (LN) {
        const int gr = m0 + r;
        const int k = k0 + kk;
        T* e = reinterpret_cast<T*>(&ra[i]);
        if (gr < M) {
          const float mean = args.ln_stats[gr], rstd = args.ln_stats[M + gr];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float v =
                k + j < K ? ((to_f(e[j]) - mean) * rstd) * args.ln_g[k + j] + args.ln_b[k + j]
                          : 0.0f;
            e[j] = from_f<T>(v);
          }
        }
      }
      *reinterpret_cast<uint4*>(as + r * S::LDA + kk) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int idx = tid + i * GNT;
      const int r = idx / B_VPR, c = (idx % B_VPR) * VEC;
      *reinterpret_cast<uint4*>(bs + r * S::LDB + c) = rb[i];
    }
  };

  typename M_::Acc acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) M_::zero(acc[i][j]);

  const int nk = (K + GBK - 1) / GBK;
  load_global(0);
  store_shared(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_global((kt + 1) * GBK);
    const T* as = As + buf * GBM * S::LDA + (wm * 64) * S::LDA;
    const T* bs = Bs + buf * GBK * S::LDB + wn * 32;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      typename M_::FragA fa[4];
      typename M_::template FragB<false> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) M_::load_a(fa[i], as + i * 16 * S::LDA + kk, S::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) M_::load_b(fb[j], bs + kk * S::LDB + j * 16, S::LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) M_::mma(acc[i][j], fa[i], fb[j]);
    }
    if (kt + 1 < nk) store_shared(buf ^ 1, (kt + 1) * GBK);
    __syncthreads();
  }

  // epilogue: stage each 16x16 tile in shared memory, then every lane owns
  // 8 consecutive columns of one row
  float* cs = Cs + warp * 16 * CS_LD;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const int E = N / 3;  // EPI_QKV, EPI_QKV_BIAS
  constexpr bool QKV = EPI == EPI_QKV || EPI == EPI_QKV_BIAS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      M_::store(cs, acc[i][j], CS_LD);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c0;
      if (gr < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[r * CS_LD + c0 + e];
        alignas(16) T o[8];
        alignas(16) T pre[8];
        if constexpr (EPI == EPI_QKV) {
          // q, k and v are all written unscaled: the attention kernels
          // scale q as they stage it
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = from_f<T>(v[e]);
        } else if constexpr (EPI == EPI_QKV_BIAS) {
          // column gc + e of the (E, 3E) flattening is element (s, h, d)
          // of the (3, H, D) bias
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = from_f<T>(v[e] + (gc + e < N ? args.bias[gc + e] : 0.0f));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float bias = gc + e < N ? args.bias[gc + e] : 0.0f;
            float y = v[e] + bias;
            if constexpr (EPI == EPI_BIAS_ACT) {
              pre[e] = from_f<T>(y);
              y = apply_act(to_f(pre[e]), args.act);
            }
            o[e] = from_f<T>(y);
          }
        }
        T* out = static_cast<T*>(args.out);
        if constexpr (QKV) {
          const int D = args.D, H = args.H, Tq = args.T;
          const int b = gr / Tq, t = gr - b * Tq, B = M / Tq;
          if (D % 8 == 0 && gc + 8 <= N) {
            const int s = gc / E, rem = gc - s * E, h = rem / D, d = rem - h * D;
            T* dst = out + ((((size_t)s * B + b) * H + h) * Tq + t) * D + d;
#pragma unroll
            for (int q = 0; q < 8 / VEC; ++q)
              reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(o)[q];
          } else {
            for (int e = 0; e < 8 && gc + e < N; ++e) {
              const int n = gc + e;
              const int s = n / E, rem = n - s * E, h = rem / D, d = rem - h * D;
              out[((((size_t)s * B + b) * H + h) * Tq + t) * D + d] = o[e];
            }
          }
        } else {
          T* dst = out + (size_t)gr * N + gc;
          T* pdst = EPI == EPI_BIAS_ACT && args.pre_act
                        ? static_cast<T*>(args.pre_act) + (size_t)gr * N + gc
                        : nullptr;
          if (b_vec && N % 8 == 0 && gc + 8 <= N) {
#pragma unroll
            for (int q = 0; q < 8 / VEC; ++q)
              reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(o)[q];
            if (pdst) {
#pragma unroll
              for (int q = 0; q < 8 / VEC; ++q)
                reinterpret_cast<uint4*>(pdst)[q] = reinterpret_cast<const uint4*>(pre)[q];
            }
          } else {
            for (int e = 0; e < 8 && gc + e < N; ++e) dst[e] = o[e];
            if (pdst)
              for (int e = 0; e < 8 && gc + e < N; ++e) pdst[e] = pre[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, int EPI, bool LN>
inline cudaError_t launch_gemm(const GemmArgs& args, cudaStream_t s) {
  constexpr int bytes = GemmSmem<T>::BYTES;
  auto kern = gemm_kernel<T, EPI, LN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((args.N + GBN - 1) / GBN, (args.M + GBM - 1) / GBM);
  kern<<<grid, GNT, bytes, s>>>(args);
  return cudaGetLastError();
}

}  // namespace vitx
