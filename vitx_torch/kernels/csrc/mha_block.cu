// K1, B7 and B8: the fused attention half of an encoder block for Hopper
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
// products, so B7 is K1's pipeline with its attention launch in a
// probabilities form: on the sm90 route K1's own attention (B5's sm90
// body, its row statistics into a scratch) followed by the head-mean pass
// of attention_probs_sm90.cuh (launch 3b below); otherwise the PROBS_MEAN
// form of attention_fwd.cuh. _kernel_hchunk's no-probs mode is the
// function of _kernel, and K1 serves it at every shape.
// B8 (entry vitx_mha_block_tome) replaces vitx/kernels/mha_block.py::
// _kernel_tome (launched by _tome_fwd, entry fused_mha_block_tome), ToMe's
// attention half: K1 with an fp32 QKV bias added to the accumulator before
// the cast (the EPI_QKV_BIAS epilogue), an fp32 bias per key, log(size),
// added to the fp32 logits (the KBIAS attention: attention_fwd_sm90.cuh on
// the sm90 route, attention_fwd.cuh otherwise), and k_mean (B, T, D), the
// head mean of the cast k, the merge metric. It also
// serves _kernel_hchunk_tome (B9, launched by _chunked_tome_fwd), which is
// _kernel_tome cut into head chunks, with out and k_mean summed across the
// chunks in fp32 scratch, only because ViT-L@384's weights and fp32 qkv
// overflow VMEM (mha_block.py:680-684): here the products are tiled at
// every T, so there is no head-chunk grid and no scratch, and one entry
// computes B9's function (B9 sums k/H per chunk, then across chunks; B8
// sums k over the heads, then divides: the two differ in fp32 ulps).
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
//   2. the QKV GEMM with the LN prologue: LN(x), rounded, @ Wqkv with fp32
//      accumulation; q, k, v are cast to the compute dtype and scattered,
//      unscaled, into (3, B, H, T, D) planes;
//   3. the attention, per (b*h, 64 queries) -- on the earlier route per
//      (b, 64 queries) over the heads in order for B7 -- with the rounding
//      points of mha_block.py:74-84 (one moved, on the sm90 route: see
//      below);
//   3b. (B7 on the sm90 route) attention_probs_sm90<D, true>: per (b, 64
//      queries, 128 keys), the heads in order, probs from qs k^T and launch
//      3's row statistics, written once (its source note says how it
//      rounds);
//   4. the out-projection GEMM: o_all @ Wo in fp32 plus bo in fp32, one
//      cast;
//   5. (B8 only) head_mean_kernel: k_mean = cast(sum_h k_h / H), the fp32
//      sum over the heads of the k plane that launch 2 wrote, in head order
//      by one thread per element (no atomics: the same bits every call).
// Routes, chosen by the caller and passed as ``route`` (an entry refuses
// one the inputs cannot take with sm90::ERR_ROUTE, before any launch):
//   - ROUTE_GEMM_SM90 (bf16, E a multiple of 8 and at most 4096, x and
//     the weights 16-byte aligned): launches 2 and 4 on gemm_sm90.cuh --
//     wgmma fed by TMA through a ring of stages, the LN applied to the A
//     fragments in registers, persistent blocks; otherwise common.cuh's
//     gemm_kernel (mma.sync, register-staged loads), which fp32 needs;
//   - ROUTE_ATTN_SM90 (K1, B7 and B8: bf16 at D = 32, 64 or 128): launch 3
//     on B5's sm90 body (attention_fwd_sm90.cuh): one pass over the keys with an
//     online softmax on wgmma, q, k and v read by TMA from launch 2's
//     planes, o written straight into o_all and the row statistics into
//     K1's stash or B7's scratch; B8's key bias is its KBIAS form, one fp32
//     add per logit after the scale. Its p is rounded after exp(s -
//     running max) rather than exp(s - final max), the one rounding point
//     that moves against _kernel and _kernel_tome, as it does for B5. B7's
//     out is then K1's on its full route, bit for bit, and launch 3b adds
//     the probabilities. Otherwise attention_fwd.cuh (mma.sync, two passes
//     over the keys, a third for B7's probabilities), which fp32 and other
//     D take.
// B8 is bound as K1 is: the projections' operations; k_mean reads the k
// plane once more (B*T*E elements) and writes B*T*D, and the per-key bias
// adds 16 floats per 64-key tile to each consumer thread's reads (L2).
// The intermediates qkv (3*B*T*E) and o_all (B*T*E) make a round trip
// through device memory; keeping them on chip is the next thing a faster
// version removes.

#include "attention_fwd.cuh"
#include "attention_fwd_sm90.cuh"
#include "gemm_sm90.cuh"
#include "attention_probs_sm90.cuh"

namespace vitx {

// k_mean[b, t, d] = cast(sum over h, in order, of k[b, h, t, d] in fp32, / H)
template <typename T>
__global__ void head_mean_kernel(const T* __restrict__ k, T* __restrict__ km, int H,
                                 long long plane, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = i / plane, td = i - b * plane;   // plane = T * D
  const T* kp = k + b * H * plane + td;
  float sum = to_f(kp[0]);
  for (int h = 1; h < H; ++h) sum += to_f(kp[h * plane]);
  km[i] = from_f<T>(sum / (float)H);
}

enum Route { ROUTE_GEMM_SM90 = 1, ROUTE_ATTN_SM90 = 2 };

// MODE: the attention's probabilities (K1, B7); TOME: B8's QKV bias, key
// bias and k_mean (with PROBS_NONE). route: the Route bits the caller
// chose; ERR_ROUTE, before any launch, for one the inputs cannot take (B7
// on ROUTE_ATTN_SM90 also needs attn_stats, the body's (2, B*H*T) fp32
// statistics, which its pass reads).
template <typename T, int MODE, bool TOME>
int run_mha(int route, const void* x, const void* wqkv, const void* wo, const float* bo,
            const float* g, const float* b, void* out, void* qkv, void* o_all, float* stats,
            float* attn_stats, float* probs, const float* qkv_bias, const float* key_bias,
            void* k_mean, int B, int T_, int E, int H, float eps, cudaStream_t s) {
  const int M = B * T_, D = E / H;
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  const bool gemm90 = route & ROUTE_GEMM_SM90, attn90 = route & ROUTE_ATTN_SM90;
  if (route & ~(ROUTE_GEMM_SM90 | ROUTE_ATTN_SM90)) return sm90::ERR_ROUTE;
  if (gemm90 && !(BF16 && gemm_sm90_ok(x, wqkv, E, 3 * E, true) &&
                  gemm_sm90_ok(o_all, wo, E, E, false)))
    return sm90::ERR_ROUTE;
  // the body and B7's head-mean pass at D 32, 64 and 128
  if (attn90 && !(BF16 && (D == 32 || D == 64 || D == 128) &&
                  (MODE == PROBS_NONE || attn_stats != nullptr)))
    return sm90::ERR_ROUTE;

  int err = static_cast<int>(launch_ln_stats<T>(static_cast<const T*>(x), stats, M, E, eps, s));
  if (err != 0) return err;

  GemmArgs qa = {};
  qa.a = x; qa.w = wqkv; qa.M = M; qa.N = 3 * E; qa.K = E;
  qa.ln_stats = stats; qa.ln_g = g; qa.ln_b = b;
  qa.out = qkv; qa.T = T_; qa.H = H; qa.D = D;
  if constexpr (TOME) {
    qa.bias = qkv_bias;
    err = gemm_route<T, EPI_QKV_BIAS, true>(qa, gemm90, s);
  } else {
    err = gemm_route<T, EPI_QKV, true>(qa, gemm90, s);
  }
  if (err != 0) return err;

  const size_t plane = (size_t)B * H * T_ * D;
  const void* k_plane = static_cast<const T*>(qkv) + plane;
  if (attn90) {
    // q, k, v: the (B, H, T, D) planes of launch 2; o: o_all (B, T, E)
    const void* in[3] = {qkv, k_plane, static_cast<const T*>(qkv) + 2 * plane};
    const long long HTD = (long long)H * T_ * D, TD = (long long)T_ * D;
    const long long strides[9] = {HTD, TD, D, HTD, TD, D, HTD, TD, D};
    FwdArgs fa = {};
    fa.o = static_cast<bf16*>(o_all);
    fa.o_sb = (long long)T_ * E; fa.o_sh = D; fa.o_st = E;
    fa.stats = attn_stats;
    fa.key_bias = key_bias;
    fa.H = H; fa.T = T_;
    fa.scale = sm90::attention_scale(D);
    err = launch_attention_fwd_sm90<TOME>(in, strides, fa, B, D, s);
    if constexpr (MODE == PROBS_MEAN) {
      if (err != 0) return err;
      err = launch_attention_probs_sm90<true>(qkv, k_plane, attn_stats, probs, B, H, T_, D,
                                              fa.scale, s);
    }
  } else {
    AttnArgs aa = {};
    aa.q = qkv;
    aa.k = k_plane;
    aa.v = static_cast<const T*>(qkv) + 2 * plane;
    aa.o = o_all;                       // (B, T, E): head h at columns h*D
    aa.o_sb = (long long)T_ * E; aa.o_sh = D; aa.o_st = E;
    aa.probs = probs;
    aa.key_bias = key_bias;
    aa.stats = attn_stats;
    aa.B = B; aa.H = H; aa.T = T_; aa.D = D;
    aa.q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));  // 1.0 / D**0.5
    err = static_cast<int>(launch_attention<T, MODE, TOME>(aa, s));
  }
  if (err != 0) return err;

  GemmArgs oa = {};
  oa.a = o_all; oa.w = wo; oa.M = M; oa.N = E; oa.K = E;
  oa.bias = bo; oa.out = out;
  err = gemm_route<T, EPI_BIAS, false>(oa, gemm90, s);
  if constexpr (TOME) {
    if (err != 0) return err;
    const long long n = (long long)B * T_ * D;
    head_mean_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const T*>(k_plane), static_cast<T*>(k_mean), H, (long long)T_ * D, n);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16. route: the Route bits (above).
// Scratch from the caller: qkv (3*B*T*E elements), o_all (B*T*E), stats
// (2*B*T fp32). attn_stats: null, or (2*B*H*T fp32) for the attention's
// row max and 1 / l (the stash of a forward under grad). Returns the first
// error of the launches (0 when all were accepted): a cudaError_t, a
// tensor-map code or ERR_ROUTE of sm90.cuh.
extern "C" int vitx_mha_block(int dtype, int route, const void* x, const void* wqkv,
                              const void* wo, const float* bo, const float* g, const float* b,
                              void* out, void* qkv, void* o_all, float* stats,
                              float* attn_stats, int B, int T, int E, int H, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vitx::run_mha<vitx::bf16, vitx::PROBS_NONE, false>(
        route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, attn_stats, nullptr, nullptr,
        nullptr, nullptr, B, T, E, H, eps, s);
  return vitx::run_mha<float, vitx::PROBS_NONE, false>(
      route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, attn_stats, nullptr, nullptr,
      nullptr, nullptr, B, T, E, H, eps, s);
}

// B7: vitx_mha_block plus probs (B*T*T fp32), the head mean of the
// softmax, written in full by the kernels. route: the Route bits, as for
// vitx_mha_block; ROUTE_ATTN_SM90 needs attn_stats, a (2*B*H*T fp32)
// scratch for the attention's row statistics (null otherwise).
extern "C" int vitx_mha_block_mean_probs(int dtype, int route, const void* x, const void* wqkv,
                                         const void* wo, const float* bo, const float* g,
                                         const float* b, void* out, void* qkv, void* o_all,
                                         float* stats, float* probs, float* attn_stats, int B,
                                         int T, int E, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vitx::run_mha<vitx::bf16, vitx::PROBS_MEAN, false>(
        route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, attn_stats, probs, nullptr,
        nullptr, nullptr, B, T, E, H, eps, s);
  return vitx::run_mha<float, vitx::PROBS_MEAN, false>(
      route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, attn_stats, probs, nullptr,
      nullptr, nullptr, B, T, E, H, eps, s);
}

// B8: vitx_mha_block with bqkv ((3, H, D) fp32, added before the QKV cast),
// log_size ((B, T) fp32, added to the logits over each key) and k_mean
// (B*T*D elements, written in full: the head mean of the cast k). route:
// the Route bits, as for vitx_mha_block.
extern "C" int vitx_mha_block_tome(int dtype, int route, const void* x, const void* wqkv,
                                   const void* wo, const float* bo, const float* g,
                                   const float* b, void* out, void* qkv, void* o_all,
                                   float* stats, const float* bqkv, const float* log_size,
                                   void* k_mean, int B, int T, int E, int H, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vitx::run_mha<vitx::bf16, vitx::PROBS_NONE, true>(
        route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, nullptr, nullptr, bqkv,
        log_size, k_mean, B, T, E, H, eps, s);
  return vitx::run_mha<float, vitx::PROBS_NONE, true>(
      route, x, wqkv, wo, bo, g, b, out, qkv, o_all, stats, nullptr, nullptr, bqkv, log_size,
      k_mean, B, T, E, H, eps, s);
}
