// K1 and B7: the fused attention half of an encoder block for Hopper
// (sm_90a).
//
// K1 replaces vitx/kernels/mha_block.py::_kernel (launched by _fused_fwd,
// entry fused_mha_block), with and without its stash:
//   out = (concat_h softmax(q_h k_h^T) v_h) @ Wo + bo,  q|k|v = LN(x) @ Wqkv
// The stash (unscaled q, k, v as (B, H, T, D) planes and o_all (B, T, E),
// the residuals of the VJP) is what launches 2 and 4 read anyway: the
// wrapper returns views of the qkv and o_all buffers, at no extra cost.
// B7 (entry vitx_mha_block_mean_probs) replaces
// vitx/kernels/mha_block.py::_kernel_hchunk in its head-mean-probs mode
// (launched by _chunked_fwd, entry fused_mha_block_with_mean_probs): the
// same function plus probs (B, T, T) fp32, the mean over heads of the
// softmax. The TPU kernel's head chunks, per-chunk (q, k, v) column order
// and LN cached in scratch exist because ViT-L@384's weights and fp32 qkv
// overflow VMEM (mha_block.py:167-172); here K1 already tiles the
// products, so B7 is K1's pipeline with the attention launch in its
// PROBS_MEAN form (attention_fwd.cuh). _kernel_hchunk's no-probs mode is
// the function of _kernel, and K1 serves it at every shape.
//
// What bounds it on the H100: the two projections are 8/9 of its FLOPs
// (2*B*T*E*4E against 4*B*H*T^2*D for attention), so it is bound by the
// tensor cores, not by memory: at ViT-B/16 it does ~1700 operations per
// byte it must move (B7 adds the (B, T, T) fp32 probs, ~1.3 MB an image at
// T = 577, and stays bound by operations). The TPU kernel keeps Wqkv and
// Wo (4.7 MB in bf16) resident in VMEM, one image per grid step; an SM has
// 227 KB of shared memory, so here the products are tiled and the kernel
// is four launches:
//   1. ln_stats_kernel: fp32 mean / rstd per row of x;
//   2. gemm_kernel<EPI_QKV>: LN applied while the A tile is staged, then
//      x_ln @ Wqkv with fp32 accumulation; q, k, v are cast to the compute
//      dtype and scattered, unscaled, into (3, B, H, T, D) planes;
//   3. attention_kernel (attention_fwd.cuh): one block per (b*h, 64
//      queries) -- per (b, 64 queries) over the heads in order for B7 --
//      q scaled by 1/sqrt(D) in fp32 and cast again as it is staged; the
//      rounding points of mha_block.py:74-84 exactly;
//   4. gemm_kernel<EPI_BIAS>: o_all @ Wo in fp32 plus bo in fp32, one cast.
// The intermediates qkv (3*B*T*E) and o_all (B*T*E) make a round trip
// through device memory; keeping them on chip is the first thing a faster
// version removes. The products use mma.sync through nvcuda::wmma; wgmma,
// TMA and warp specialisation are not used yet.

#include "attention_fwd.cuh"

namespace vitx {

template <typename T, int MODE>
cudaError_t run_mha(const void* x, const void* wqkv, const void* wo, const float* bo,
                    const float* g, const float* b, void* out, void* qkv, void* o_all,
                    float* stats, float* probs, int B, int T_, int E, int H, float eps,
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

  const size_t plane = (size_t)B * H * T_ * D;
  AttnArgs aa = {};
  aa.q = qkv;
  aa.k = static_cast<const T*>(qkv) + plane;
  aa.v = static_cast<const T*>(qkv) + 2 * plane;
  aa.o = o_all;                       // (B, T, E): head h at columns h*D
  aa.o_sb = (long long)T_ * E; aa.o_sh = D; aa.o_st = E;
  aa.probs = probs;
  aa.B = B; aa.H = H; aa.T = T_; aa.D = D;
  aa.q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));  // 1.0 / D**0.5
  err = launch_attention<T, MODE>(aa, s);
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
    err = vitx::run_mha<vitx::bf16, vitx::PROBS_NONE>(x, wqkv, wo, bo, g, b, out, qkv, o_all,
                                                      stats, nullptr, B, T, E, H, eps, s);
  else
    err = vitx::run_mha<float, vitx::PROBS_NONE>(x, wqkv, wo, bo, g, b, out, qkv, o_all,
                                                 stats, nullptr, B, T, E, H, eps, s);
  return static_cast<int>(err);
}

// B7: vitx_mha_block plus probs (B*T*T fp32), the head mean of the
// softmax, written in full by the kernel.
extern "C" int vitx_mha_block_mean_probs(int dtype, const void* x, const void* wqkv,
                                         const void* wo, const float* bo, const float* g,
                                         const float* b, void* out, void* qkv, void* o_all,
                                         float* stats, float* probs, int B, int T, int E,
                                         int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::run_mha<vitx::bf16, vitx::PROBS_MEAN>(x, wqkv, wo, bo, g, b, out, qkv, o_all,
                                                      stats, probs, B, T, E, H, eps, s);
  else
    err = vitx::run_mha<float, vitx::PROBS_MEAN>(x, wqkv, wo, bo, g, b, out, qkv, o_all,
                                                 stats, probs, B, T, E, H, eps, s);
  return static_cast<int>(err);
}
