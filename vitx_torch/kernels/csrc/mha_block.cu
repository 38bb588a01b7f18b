// K1: the fused attention half of an encoder block for Hopper (sm_90a).
//
// Replaces vitx/kernels/mha_block.py::_kernel (launched by _fused_fwd,
// entry fused_mha_block), with and without its stash:
//   out = (concat_h softmax(q_h k_h^T) v_h) @ Wo + bo,  q|k|v = LN(x) @ Wqkv
// The stash (unscaled q, k, v as (B, H, T, D) planes and o_all (B, T, E),
// the residuals of the VJP) is what launches 2 and 4 read anyway: the
// wrapper returns views of the qkv and o_all buffers, at no extra cost.
//
// What bounds it on the H100: the two projections are 8/9 of its FLOPs
// (2*B*T*E*4E against 4*B*H*T^2*D for attention), so it is bound by the
// tensor cores, not by memory: at ViT-B/16 it does ~1700 operations per
// byte it must move. The TPU kernel keeps Wqkv and Wo (4.7 MB in bf16)
// resident in VMEM, one image per grid step; an SM has 227 KB of shared
// memory, so here the products are tiled and the kernel is four launches:
//   1. ln_stats_kernel: fp32 mean / rstd per row of x;
//   2. gemm_kernel<EPI_QKV>: LN applied while the A tile is staged, then
//      x_ln @ Wqkv with fp32 accumulation; q, k, v are cast to the compute
//      dtype and scattered, unscaled, into (3, B, H, T, D) planes;
//   3. attention_kernel: one block per (b*h, 64 queries), q scaled by
//      1/sqrt(D) in fp32 and cast again as it is staged; key/value chunks
//      of 64 rows are staged in shared memory; a first pass finds each
//      row's max logit, a second recomputes the logits, takes
//      p = exp(s - max) in fp32, sums l over the fp32 p, multiplies the
//      compute-dtype cast of p with v, and divides by l after the product
//      -- the rounding points of mha_block.py:74-84 exactly;
//   4. gemm_kernel<EPI_BIAS>: o_all @ Wo in fp32 plus bo in fp32, one cast.
// The intermediates qkv (3*B*T*E) and o_all (B*T*E) make a round trip
// through device memory; keeping them on chip is the first thing a faster
// version removes. The products use mma.sync through nvcuda::wmma; wgmma,
// TMA and warp specialisation are not used yet.

#include "common.cuh"

namespace vitx {

constexpr int AQ = 64;    // queries per block (4 warps x 16 rows)
constexpr int AKC = 64;   // keys per staged chunk
constexpr int ANT = 128;

template <typename T, int DP> struct AttnSmem {
  static constexpr int LD = DP + 16 / (int)sizeof(T);
  static constexpr int LDP = 16 + 16 / (int)sizeof(T);
  static constexpr int Q_BYTES = align_up(AQ * LD * (int)sizeof(T), 128);
  static constexpr int KV_BYTES = align_up(AKC * LD * (int)sizeof(T), 128);
  static constexpr int S_BYTES = 4 * 16 * CS_LD * 4;
  static constexpr int P_BYTES = align_up(4 * 16 * LDP * (int)sizeof(T), 128);
  static constexpr int BYTES = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES;
};

// qkv: (3, B, H, T, D), q unscaled; o_all: (B, T, E)
template <typename T, int DP>
__global__ void __launch_bounds__(ANT)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ o_all, int B, int ntok,
                 int H, int D, float q_scale) {
  using S = AttnSmem<T, DP>;
  using M_ = Mma<T>;
  constexpr int ND = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + S::Q_BYTES);
  T* Vs = reinterpret_cast<T*>(smem + S::Q_BYTES + S::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem + S::Q_BYTES + 2 * S::KV_BYTES);
  T* Ps = reinterpret_cast<T*>(smem + S::Q_BYTES + 2 * S::KV_BYTES + S::S_BYTES);

  const int bh = blockIdx.x, q0 = blockIdx.y * AQ;
  const int b = bh / H, h = bh - b * H;
  const size_t plane = (size_t)B * H * ntok * D;
  const T* qp = qkv + ((size_t)b * H + h) * ntok * D;
  const T* kp = qp + plane;
  const T* vp = qp + 2 * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float* sw = Ss + warp * 16 * CS_LD;
  T* pw = Ps + warp * 16 * S::LDP;

  // q = cast(cast(q) * scale), as mha_block.py:74 scales the stashed q0
  stage_rows_scaled<T, DP, ANT>(Qs, S::LD, qp, q0, ntok, D, nullptr, q_scale);
  typename M_::FragA qf[ND];

  // pass 1: the row max of the fp32 logits
  float m = -CUDART_INF_F;
  for (int kc = 0; kc < ntok; kc += AKC) {
    __syncthreads();
    stage_rows<T, DP, ANT>(Ks, S::LD, kp, kc, ntok, D);
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int dk = 0; dk < ND; ++dk)
        M_::load_a(qf[dk], Qs + warp * 16 * S::LD + dk * 16, S::LD);
    }
    for (int j = 0; j < AKC / 16 && kc + j * 16 < ntok; ++j) {
      typename M_::Acc s;
      M_::zero(s);
#pragma unroll
      for (int dk = 0; dk < ND; ++dk) {
        typename M_::template FragB<true> kf;
        M_::load_b(kf, Ks + j * 16 * S::LD + dk * 16, S::LD);
        M_::mma(s, qf[dk], kf);
      }
      M_::store(sw, s, CS_LD);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (kc + j * 16 + c0 + e < ntok) m = fmaxf(m, sw[r * CS_LD + c0 + e]);
      __syncwarp();
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: p = exp(s - m) in fp32, l = sum of fp32 p, o = cast(p) @ v
  float l = 0.0f;
  typename M_::Acc o[ND];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) M_::zero(o[dt]);
  for (int kc = 0; kc < ntok; kc += AKC) {
    __syncthreads();
    stage_rows<T, DP, ANT>(Ks, S::LD, kp, kc, ntok, D);
    stage_rows<T, DP, ANT>(Vs, S::LD, vp, kc, ntok, D);
    __syncthreads();
    for (int j = 0; j < AKC / 16 && kc + j * 16 < ntok; ++j) {
      typename M_::Acc s;
      M_::zero(s);
#pragma unroll
      for (int dk = 0; dk < ND; ++dk) {
        typename M_::template FragB<true> kf;
        M_::load_b(kf, Ks + j * 16 * S::LD + dk * 16, S::LD);
        M_::mma(s, qf[dk], kf);
      }
      M_::store(sw, s, CS_LD);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float p = 0.0f;
        if (kc + j * 16 + c0 + e < ntok) p = expf(sw[r * CS_LD + c0 + e] - m);
        l += p;
        pw[r * S::LDP + c0 + e] = from_f<T>(p);
      }
      __syncwarp();
      typename M_::FragA pf;
      M_::load_a(pf, pw, S::LDP);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        typename M_::template FragB<false> vf;
        M_::load_b(vf, Vs + j * 16 * S::LD + dt * 16, S::LD);
        M_::mma(o[dt], pf, vf);
      }
      __syncwarp();
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  const int E = H * D;
  const int t = q0 + warp * 16 + r;
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    M_::store(sw, o[dt], CS_LD);
    __syncwarp();
    if (t < ntok) {
      T* dst = o_all + ((size_t)b * ntok + t) * E + h * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = dt * 16 + c0 + e;
        if (d < D) dst[d] = from_f<T>(sw[r * CS_LD + c0 + e] / l);
      }
    }
    __syncwarp();
  }
}

template <typename T, int DP>
cudaError_t launch_attention(const T* qkv, T* o_all, int B, int T_, int H, int D,
                             float q_scale, cudaStream_t s) {
  constexpr int bytes = AttnSmem<T, DP>::BYTES;
  auto kern = attention_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T_ + AQ - 1) / AQ);
  kern<<<grid, ANT, bytes, s>>>(qkv, o_all, B, T_, H, D, q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mha(const void* x, const void* wqkv, const void* wo, const float* bo,
                    const float* g, const float* b, void* out, void* qkv, void* o_all,
                    float* stats, int B, int T_, int E, int H, float eps,
                    cudaStream_t s) {
  const int M = B * T_, D = E / H;
  cudaError_t err = launch_ln_stats<T>(static_cast<const T*>(x), stats, M, E, eps, s);
  if (err != cudaSuccess) return err;

  GemmArgs qa = {};
  qa.a = x; qa.w = wqkv; qa.M = M; qa.N = 3 * E; qa.K = E;
  qa.ln_stats = stats; qa.ln_g = g; qa.ln_b = b;
  qa.out = qkv; qa.T = T_; qa.H = H; qa.D = D;
  err = launch_gemm<T, EPI_QKV, true>(qa, s);
  if (err != cudaSuccess) return err;

  const T* q = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(o_all);
  const float sc = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));  // 1.0 / D**0.5
  if (D <= 16) err = launch_attention<T, 16>(q, o, B, T_, H, D, sc, s);
  else if (D <= 32) err = launch_attention<T, 32>(q, o, B, T_, H, D, sc, s);
  else if (D <= 64) err = launch_attention<T, 64>(q, o, B, T_, H, D, sc, s);
  else if (D <= 128) err = launch_attention<T, 128>(q, o, B, T_, H, D, sc, s);
  else err = launch_attention<T, 256>(q, o, B, T_, H, D, sc, s);
  if (err != cudaSuccess) return err;

  GemmArgs oa = {};
  oa.a = o_all; oa.w = wo; oa.M = M; oa.N = E; oa.K = E;
  oa.bias = bo; oa.out = out;
  return launch_gemm<T, EPI_BIAS, false>(oa, s);
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16. Scratch from the caller: qkv
// (3*B*T*E elements), o_all (B*T*E), stats (2*B*T fp32). Returns the
// first CUDA error of the launches (0 when all were accepted).
extern "C" int vitx_mha_block(int dtype, const void* x, const void* wqkv, const void* wo,
                              const float* bo, const float* g, const float* b, void* out,
                              void* qkv, void* o_all, float* stats, int B, int T, int E,
                              int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::run_mha<vitx::bf16>(x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, B, T, E,
                                    H, eps, s);
  else
    err = vitx::run_mha<float>(x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, B, T, E, H,
                               eps, s);
  return static_cast<int>(err);
}
