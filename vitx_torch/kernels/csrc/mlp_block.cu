// K2: the fused MLP half of an encoder block for Hopper (sm_90a).
//
// Replaces vitx/kernels/mlp_block.py::_kernel (launched by _fused_fwd,
// entry fused_mlp_block), with and without its stash:
//   out = act(LN(x) @ W1 + b1) @ W2 + b2
// The stash is hp = cast(LN(x) @ W1 + b1) (B*T, M), the residual of the
// VJP: the epilogue of launch 2 writes it beside ha when asked to.
//
// What bounds it on the H100: two products of 2*B*T*E*M operations each
// against ~2*B*T*E elements in and out, so the tensor cores, not memory,
// are the limit (~3000 operations per byte at ViT-B/16 if ha stayed on
// chip). The TPU kernel keeps W1 and W2 (9.4 MB in bf16) in VMEM, one image
// per grid step; here the products are tiled and the kernel is three
// launches:
//   1. ln_stats_kernel: fp32 mean / rstd per row of x;
//   2. the W1 GEMM with the LN prologue (EPI_BIAS_ACT): LN(x), rounded, @
//      W1 in fp32, + b1 in fp32, cast to the compute dtype, the activation
//      in fp32 (mlp_block.py:34-64: the A-S polynomial erf for gelu, tanh
//      through exp for gelu_tanh), cast -> ha (B*T, M); with the stash, the
//      cast pre-activation hp as well;
//   3. the W2 GEMM (EPI_BIAS): ha @ W2 in fp32, + b2 in fp32, one cast.
// route 1 (bf16, E and M multiples of 8, E at most 4096, x and the weights
// 16-byte aligned)
// runs launches 2 and 3 on gemm_sm90.cuh: wgmma fed by TMA through a ring
// of stages, the LN applied to the A fragments in registers, persistent
// blocks, W1 and W2 read in place; route 0 on common.cuh's gemm_kernel
// (mma.sync, register-staged loads), which fp32 needs. The caller chooses;
// a route the inputs cannot take returns sm90::ERR_ROUTE before any launch.
// The hidden activation ha (B*T*M elements, 4x the block's input) makes a
// round trip through device memory; keeping it on chip is the next thing a
// faster version removes.

#include "gemm_sm90.cuh"

namespace vitx {

template <typename T>
int run_mlp(int route, const void* x, const void* w1, const float* b1, const void* w2,
            const float* b2, const float* g, const float* b, void* out, void* ha, void* hp,
            float* stats, int rows, int E, int Mh, int act, float eps, cudaStream_t s) {
  const bool use90 = route == 1;
  if (route != 0 && !(use90 && std::is_same<T, bf16>::value && gemm_sm90_ok(x, w1, E, Mh, true) &&
                      gemm_sm90_ok(ha, w2, Mh, E, false)))
    return sm90::ERR_ROUTE;
  int err = static_cast<int>(launch_ln_stats<T>(static_cast<const T*>(x), stats, rows, E, eps, s));
  if (err != 0) return err;

  GemmArgs up = {};
  up.a = x; up.w = w1; up.M = rows; up.N = Mh; up.K = E;
  up.ln_stats = stats; up.ln_g = g; up.ln_b = b;
  up.bias = b1; up.act = act; up.out = ha; up.pre_act = hp;
  err = gemm_route<T, EPI_BIAS_ACT, true>(up, use90, s);
  if (err != 0) return err;

  GemmArgs down = {};
  down.a = ha; down.w = w2; down.M = rows; down.N = E; down.K = Mh;
  down.bias = b2; down.out = out;
  return gemm_route<T, EPI_BIAS, false>(down, use90, s);
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16; route: 1 the sm90 GEMM, 0 gemm_kernel;
// act: 0 gelu, 1 gelu_tanh, 2 relu. Scratch from the caller: ha (rows*Mh
// elements), stats (2*rows fp32). hp (rows*Mh elements) receives the
// stash, or is null for none. Returns the first error of the launches (0
// when all were accepted): a cudaError_t, a tensor-map code or ERR_ROUTE.
extern "C" int vitx_mlp_block(int dtype, int route, const void* x, const void* w1,
                              const float* b1, const void* w2, const float* b2, const float* g,
                              const float* b, void* out, void* ha, void* hp, float* stats,
                              int rows, int E, int Mh, int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vitx::run_mlp<vitx::bf16>(route, x, w1, b1, w2, b2, g, b, out, ha, hp, stats, rows,
                                     E, Mh, act, eps, s);
  return vitx::run_mlp<float>(route, x, w1, b1, w2, b2, g, b, out, ha, hp, stats, rows, E, Mh,
                              act, eps, s);
}
