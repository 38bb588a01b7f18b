// B2: the attention backward for Hopper (sm_90a), at every T.
//
// Replaces vitx/kernels/flash_attention.py::_bwd_kernel_nq1 (launched by
// _bwd_nq1 from _bwd for T <= 1024, which the fused MHA block's VJP calls)
// and, past T = 1024 or past _bwd's VMEM budget, the q-chunked
// _bwd_kernel (B6, launched by _bwd itself; T padded to 128, dk and dv in
// fp32 scratch over query chunks): the same function, whose padded rows
// add exactly 0. q, k, v, do (B, H, T, D) -> dq, dk, dv in the input
// dtype, q unscaled. Both launches tile queries and keys in blocks of 64
// and mask the ragged last tile, so no shared memory grows with T.
// With qs = cast(q * scale), s = qs k^T (fp32), m = rowmax(s),
// pu = exp(s - m) and l = rowsum(pu), both fp32, linv = 1 / l:
//   dv = cast(pu)^T cast(do * linv)
//   dp = do v^T                              (fp32)
//   delta = rowsum(pu * dp) * linv           (from the fp32 pu)
//   e = cast(pu * (dp - delta))
//   dq = (e k) * (scale * linv), then cast
//   dk = e^T cast(q * (scale * linv))
// -- the rounding points of flash_attention.py:297-310.
//
// What bounds it on the H100: 10*B*H*T^2*D operations against
// 7*B*H*T*D elements in and out; at ViT-B/16 (T = 197, D = 64) that is
// ~280 operations per byte, just under the card's ~295, so bytes bound it
// by a little. The TPU kernel holds a head's whole (T, T) fp32 score block
// in VMEM (grid (B, H/hc)); here that block (155 KB at T = 197) does not
// fit beside the q/k/v/do tiles, and m, l and delta each need a whole key
// row while dk and dv each need a whole query column. So two launches,
// with no atomics and a fixed summation order:
//   1. dq_kernel: one block per (b*h, 64 queries), 4 warps of 16 rows.
//      Three passes over 64-key chunks staged in shared memory: the row
//      max; l and rowsum(pu * dp); then e and dq += e k. It writes m, linv
//      and delta (fp32, 3 x B*H*T) for launch 2, and dq.
//   2. dkdv_kernel: one block per (b*h, 64 keys). For every 64-query tile
//      it recomputes pu^T and e^T (keys x queries) from m, linv, delta,
//      then accumulates dv += cast(pu)^T cast(do * linv) and
//      dk += e^T cast(q * scale * linv) in registers.
// Both recompute q k^T (launch 1 three times, launch 2 once) and do v^T
// (twice, once): 20*B*H*T^2*D operations where 10 would do. Products use
// mma.sync through nvcuda::wmma (fp32 on the CUDA cores), as K1 does.

#include "common.cuh"

namespace vitx {

constexpr int BT = 64;    // queries (launch 1) or keys (launch 2) per block
constexpr int BNT = 128;  // 4 warps x 16 rows

template <typename T, int DP> struct BwdSmem {
  static constexpr int LD = DP + 16 / (int)sizeof(T);    // a (64, DP) tile's row
  static constexpr int LDW = BT + 16 / (int)sizeof(T);   // a per-warp (16, 64) tile's row
  static constexpr int LDE = 16 + 16 / (int)sizeof(T);   // a per-warp (16, 16) tile's row
  static constexpr int TILE = align_up(64 * LD * (int)sizeof(T), 128);
  static constexpr int STAGE = 4 * 16 * CS_LD * 4;       // fp32 (16, 16) per warp
  static constexpr int E16 = align_up(4 * 16 * LDE * (int)sizeof(T), 128);
  static constexpr int W64 = align_up(4 * 16 * LDW * (int)sizeof(T), 128);
  // launch 1: qs, do, k, v tiles; s and dp stages; e (16 x 16) per warp
  static constexpr int DQ_BYTES = 4 * TILE + 2 * STAGE + E16;
  // launch 2: k, v, qs|qn, do|don tiles; s and dp stages; pu and e (16 x 64)
  // per warp; m, linv, delta and a row factor for the 64 queries of a tile
  static constexpr int DKDV_BYTES = 4 * TILE + 2 * STAGE + 2 * W64 + 4 * BT * 4;
};

// q, k, v, dout, dq: (B*H, T, D) planes; stats: (3, B*H*T) fp32 m|linv|delta
template <typename T, int DP>
__global__ void __launch_bounds__(BNT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
          int BH, int ntok, int D, float scale) {
  using S = BwdSmem<T, DP>;
  using M_ = Mma<T>;
  constexpr int ND = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = reinterpret_cast<T*>(smem + S::TILE);
  T* Ks = reinterpret_cast<T*>(smem + 2 * S::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 3 * S::TILE);
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::TILE);
  float* Ps = reinterpret_cast<float*>(smem + 4 * S::TILE + S::STAGE);
  T* Es = reinterpret_cast<T*>(smem + 4 * S::TILE + 2 * S::STAGE);

  const int bh = blockIdx.x, q0 = blockIdx.y * BT;
  const size_t off = (size_t)bh * ntok * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float* sw = Ss + warp * 16 * CS_LD;
  float* dpw = Ps + warp * 16 * CS_LD;
  T* ew = Es + warp * 16 * S::LDE;
  const T* qw = Qs + warp * 16 * S::LD;
  const T* ow = Os + warp * 16 * S::LD;

  stage_rows_scaled<T, DP, BNT>(Qs, S::LD, q + off, q0, ntok, D, nullptr, scale);
  stage_rows<T, DP, BNT>(Os, S::LD, dout + off, q0, ntok, D);

  // s (16 x 16) for keys [j*16, j*16 + 16) of the staged chunk -> sw
  auto logits = [&](int j) {
    typename M_::Acc s;
    M_::zero(s);
#pragma unroll
    for (int dk = 0; dk < ND; ++dk) {
      typename M_::FragA a;
      typename M_::template FragB<true> b;
      M_::load_a(a, qw + dk * 16, S::LD);
      M_::load_b(b, Ks + j * 16 * S::LD + dk * 16, S::LD);
      M_::mma(s, a, b);
    }
    M_::store(sw, s, CS_LD);
  };
  // dp = do v^T (16 x 16) for the same keys -> dpw
  auto dprobs = [&](int j) {
    typename M_::Acc s;
    M_::zero(s);
#pragma unroll
    for (int dk = 0; dk < ND; ++dk) {
      typename M_::FragA a;
      typename M_::template FragB<true> b;
      M_::load_a(a, ow + dk * 16, S::LD);
      M_::load_b(b, Vs + j * 16 * S::LD + dk * 16, S::LD);
      M_::mma(s, a, b);
    }
    M_::store(dpw, s, CS_LD);
  };

  // pass 1: the row max of the fp32 logits
  float m = -CUDART_INF_F;
  for (int kc = 0; kc < ntok; kc += BT) {
    __syncthreads();
    stage_rows<T, DP, BNT>(Ks, S::LD, k + off, kc, ntok, D);
    __syncthreads();
    for (int j = 0; j < BT / 16 && kc + j * 16 < ntok; ++j) {
      logits(j);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kc + j * 16 + c0 + e < ntok) m = fmaxf(m, sw[r * CS_LD + c0 + e]);
      __syncwarp();
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: l = sum of pu, and sum of pu * dp
  float l = 0.0f, pd = 0.0f;
  for (int kc = 0; kc < ntok; kc += BT) {
    __syncthreads();
    stage_rows<T, DP, BNT>(Ks, S::LD, k + off, kc, ntok, D);
    stage_rows<T, DP, BNT>(Vs, S::LD, v + off, kc, ntok, D);
    __syncthreads();
    for (int j = 0; j < BT / 16 && kc + j * 16 < ntok; ++j) {
      logits(j);
      dprobs(j);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (kc + j * 16 + c0 + e < ntok) {
          const float pu = expf(sw[r * CS_LD + c0 + e] - m);
          l += pu;
          pd += pu * dpw[r * CS_LD + c0 + e];
        }
      }
      __syncwarp();
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  pd += __shfl_xor_sync(0xffffffffu, pd, 1);
  const float linv = 1.0f / l;
  const float delta = pd * linv;
  const int t = q0 + warp * 16 + r;
  if ((lane & 1) == 0 && t < ntok) {
    const size_t n = (size_t)BH * ntok;
    const size_t i = (size_t)bh * ntok + t;
    stats[i] = m;
    stats[n + i] = linv;
    stats[2 * n + i] = delta;
  }

  // pass 3: e = cast(pu * (dp - delta)), dq += e k
  typename M_::Acc acc[ND];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) M_::zero(acc[dt]);
  for (int kc = 0; kc < ntok; kc += BT) {
    __syncthreads();
    stage_rows<T, DP, BNT>(Ks, S::LD, k + off, kc, ntok, D);
    stage_rows<T, DP, BNT>(Vs, S::LD, v + off, kc, ntok, D);
    __syncthreads();
    for (int j = 0; j < BT / 16 && kc + j * 16 < ntok; ++j) {
      logits(j);
      dprobs(j);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float ev = 0.0f;
        if (kc + j * 16 + c0 + e < ntok) {
          const float pu = expf(sw[r * CS_LD + c0 + e] - m);
          ev = pu * (dpw[r * CS_LD + c0 + e] - delta);
        }
        ew[r * S::LDE + c0 + e] = from_f<T>(ev);
      }
      __syncwarp();
      typename M_::FragA ef;
      M_::load_a(ef, ew, S::LDE);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        typename M_::template FragB<false> kf;
        M_::load_b(kf, Ks + j * 16 * S::LD + dt * 16, S::LD);
        M_::mma(acc[dt], ef, kf);
      }
      __syncwarp();
    }
  }

  const float f = scale * linv;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    M_::store(sw, acc[dt], CS_LD);
    __syncwarp();
    if (t < ntok) {
      T* dst = dq + off + (size_t)t * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = dt * 16 + c0 + e;
        if (d < D) dst[d] = from_f<T>(sw[r * CS_LD + c0 + e] * f);
      }
    }
    __syncwarp();
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(BNT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
            const float* __restrict__ stats, int BH, int ntok, int D, float scale) {
  using S = BwdSmem<T, DP>;
  using M_ = Mma<T>;
  constexpr int ND = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + S::TILE);
  T* As = reinterpret_cast<T*>(smem + 2 * S::TILE);   // qs, then qn
  T* Bs = reinterpret_cast<T*>(smem + 3 * S::TILE);   // do, then don
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::TILE);
  float* Ds = reinterpret_cast<float*>(smem + 4 * S::TILE + S::STAGE);
  T* Pw = reinterpret_cast<T*>(smem + 4 * S::TILE + 2 * S::STAGE);
  T* Ew = reinterpret_cast<T*>(smem + 4 * S::TILE + 2 * S::STAGE + S::W64);
  float* st_m = reinterpret_cast<float*>(smem + 4 * S::TILE + 2 * S::STAGE + 2 * S::W64);
  float* st_linv = st_m + BT;
  float* st_delta = st_linv + BT;
  float* st_fac = st_delta + BT;

  const int bh = blockIdx.x, k0 = blockIdx.y * BT;
  const size_t off = (size_t)bh * ntok * D;
  const size_t n = (size_t)BH * ntok;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float* sw = Ss + warp * 16 * CS_LD;
  float* dpw = Ds + warp * 16 * CS_LD;
  T* pw = Pw + warp * 16 * S::LDW;
  T* ew = Ew + warp * 16 * S::LDW;
  const T* kw = Ks + warp * 16 * S::LD;
  const T* vw = Vs + warp * 16 * S::LD;
  const int key = k0 + warp * 16 + r;

  stage_rows<T, DP, BNT>(Ks, S::LD, k + off, k0, ntok, D);
  stage_rows<T, DP, BNT>(Vs, S::LD, v + off, k0, ntok, D);

  typename M_::Acc dk_acc[ND], dv_acc[ND];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    M_::zero(dk_acc[dt]);
    M_::zero(dv_acc[dt]);
  }

  for (int qc = 0; qc < ntok; qc += BT) {
    __syncthreads();   // the previous tile's products are done with As, Bs
    stage_rows_scaled<T, DP, BNT>(As, S::LD, q + off, qc, ntok, D, nullptr, scale);
    stage_rows<T, DP, BNT>(Bs, S::LD, dout + off, qc, ntok, D);
    if (threadIdx.x < BT) {
      const int t = qc + threadIdx.x;
      const bool ok = t < ntok;
      const size_t i = (size_t)bh * ntok + t;
      st_m[threadIdx.x] = ok ? stats[i] : 0.0f;
      st_linv[threadIdx.x] = ok ? stats[n + i] : 0.0f;
      st_delta[threadIdx.x] = ok ? stats[2 * n + i] : 0.0f;
    }
    __syncthreads();
    const int nj = min(BT / 16, (ntok - qc + 15) / 16);
    for (int j = 0; j < nj; ++j) {
      // s^T and dp^T: (16 keys of this warp) x (16 queries j*16..)
      typename M_::Acc s, dp;
      M_::zero(s);
      M_::zero(dp);
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        typename M_::FragA a;
        typename M_::template FragB<true> b;
        M_::load_a(a, kw + dd * 16, S::LD);
        M_::load_b(b, As + j * 16 * S::LD + dd * 16, S::LD);
        M_::mma(s, a, b);
        M_::load_a(a, vw + dd * 16, S::LD);
        M_::load_b(b, Bs + j * 16 * S::LD + dd * 16, S::LD);
        M_::mma(dp, a, b);
      }
      M_::store(sw, s, CS_LD);
      M_::store(dpw, dp, CS_LD);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = j * 16 + c0 + e;   // query within the tile
        float pu = 0.0f, ev = 0.0f;
        if (key < ntok && qc + c < ntok) {
          pu = expf(sw[r * CS_LD + c0 + e] - st_m[c]);
          ev = pu * (dpw[r * CS_LD + c0 + e] - st_delta[c]);
        }
        pw[r * S::LDW + c] = from_f<T>(pu);
        ew[r * S::LDW + c] = from_f<T>(ev);
      }
      __syncwarp();
    }
    __syncthreads();   // every warp is done reading qs and do
    if (threadIdx.x < BT) st_fac[threadIdx.x] = scale * st_linv[threadIdx.x];
    __syncthreads();
    stage_rows_scaled<T, DP, BNT>(As, S::LD, q + off, qc, ntok, D, st_fac, 0.0f);
    stage_rows_scaled<T, DP, BNT>(Bs, S::LD, dout + off, qc, ntok, D, st_linv, 0.0f);
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      typename M_::FragA pf, ef;
      M_::load_a(pf, pw + j * 16, S::LDW);
      M_::load_a(ef, ew + j * 16, S::LDW);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        typename M_::template FragB<false> b;
        M_::load_b(b, Bs + j * 16 * S::LD + dt * 16, S::LD);
        M_::mma(dv_acc[dt], pf, b);
        M_::load_b(b, As + j * 16 * S::LD + dt * 16, S::LD);
        M_::mma(dk_acc[dt], ef, b);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    M_::store(sw, dk_acc[dt], CS_LD);
    M_::store(dpw, dv_acc[dt], CS_LD);
    __syncwarp();
    if (key < ntok) {
      T* dkr = dk + off + (size_t)key * D;
      T* dvr = dv + off + (size_t)key * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = dt * 16 + c0 + e;
        if (d < D) {
          dkr[d] = from_f<T>(sw[r * CS_LD + c0 + e]);
          dvr[d] = from_f<T>(dpw[r * CS_LD + c0 + e]);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int DP>
cudaError_t run_bwd(const T* q, const T* k, const T* v, const T* dout, T* dq, T* dk, T* dv,
                    float* stats, int BH, int ntok, int D, cudaStream_t s) {
  using S = BwdSmem<T, DP>;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(BH, (ntok + BT - 1) / BT);
  auto k1 = dq_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DQ_BYTES);
  if (err != cudaSuccess) return err;
  k1<<<grid, BNT, S::DQ_BYTES, s>>>(q, k, v, dout, dq, stats, BH, ntok, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto k2 = dkdv_kernel<T, DP>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, S::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  k2<<<grid, BNT, S::DKDV_BYTES, s>>>(q, k, v, dout, dk, dv, stats, BH, ntok, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, float* stats, int BH, int ntok, int D,
                     cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto w = [](void* p) { return static_cast<T*>(p); };
  if (D <= 16)
    return run_bwd<T, 16>(c(q), c(k), c(v), c(dout), w(dq), w(dk), w(dv), stats, BH, ntok,
                          D, s);
  if (D <= 32)
    return run_bwd<T, 32>(c(q), c(k), c(v), c(dout), w(dq), w(dk), w(dv), stats, BH, ntok,
                          D, s);
  if (D <= 64)
    return run_bwd<T, 64>(c(q), c(k), c(v), c(dout), w(dq), w(dk), w(dv), stats, BH, ntok,
                          D, s);
  if (D <= 128)
    return run_bwd<T, 128>(c(q), c(k), c(v), c(dout), w(dq), w(dk), w(dv), stats, BH, ntok,
                           D, s);
  return cudaErrorInvalidValue;
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq, dk, dv: (B*H, T, D)
// contiguous, D <= 128. Scratch from the caller: stats (3*B*H*T fp32).
// Returns the first CUDA error of the launches (0 when all were accepted).
extern "C" int vitx_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, void* dq, void* dk, void* dv,
                                  float* stats, int BH, int T, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::dispatch<vitx::bf16>(q, k, v, dout, dq, dk, dv, stats, BH, T, D, s);
  else
    err = vitx::dispatch<float>(q, k, v, dout, dq, dk, dv, stats, BH, T, D, s);
  return static_cast<int>(err);
}
