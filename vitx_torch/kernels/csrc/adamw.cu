// B12: the fused AdamW update for Hopper (sm_90a).
//
// Replaces vitx/kernels/adamw.py::_kernel (launched by _fused_leaf, entry
// fused_adamw, selected by make_optimizer(fused=True)): one pass over one
// fp32 leaf that reads p, g, mu, nu and writes p, mu, nu in place, with the
// update of adamw.py:46-53 in its order of operations:
//   mu' = b1 * mu + (1 - b1) * g
//   nu' = b2 * nu + ((1 - b2) * g) * g
//   p'  = p - lr * ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd * p)
// with lr, c1 = 1 - b1^t and c2 = 1 - b2^t computed by the caller. The
// gradient may be fp32 or bf16 and is upcast (adamw.py:62). Every product
// and sum is rounded on its own (__fmul_rn, __fadd_rn: no contraction into
// an FMA), so the kernel and its plain torch version agree to the bit.
//
// What bounds it on the H100: bytes, ~28 bytes per fp32 element (four
// reads, three writes) for ~15 operations. The TPU kernel needs leaves of
// >= 65536 elements in rows of 1024 (its (8, 128) tiling, adamw.py:69-90);
// here any fp32 leaf takes it: a grid-stride loop, one element per thread
// per step, neighbouring threads on neighbouring addresses.

#include "common.cuh"

namespace vitx {

struct AdamScalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

template <typename G>
__global__ void __launch_bounds__(256)
adamw_kernel(float* __restrict__ p, const G* __restrict__ g, float* __restrict__ mu,
             float* __restrict__ nu, long long n, const AdamScalars a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float gi = to_f(g[i]);
    const float pi = p[i];
    const float m2 = __fadd_rn(__fmul_rn(a.b1, mu[i]), __fmul_rn(a.omb1, gi));
    const float v2 = __fadd_rn(__fmul_rn(a.b2, nu[i]), __fmul_rn(__fmul_rn(a.omb2, gi), gi));
    const float mh = __fdiv_rn(m2, a.c1);
    const float vh = __fdiv_rn(v2, a.c2);
    const float u = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps)),
                              __fmul_rn(a.wd, pi));
    p[i] = __fsub_rn(pi, __fmul_rn(a.lr, u));
    mu[i] = m2;
    nu[i] = v2;
  }
}

}  // namespace vitx

// gdtype: the gradient's type, 0 = float32, 1 = bfloat16; p, mu, nu fp32,
// all n elements, contiguous. b1/omb1 and b2/omb2 are beta and 1 - beta,
// each rounded once from double. Returns the launch's CUDA error.
extern "C" int vitx_adamw(int gdtype, float* p, const void* g, float* mu, float* nu,
                          long long n, float lr, float c1, float c2, float b1, float omb1,
                          float b2, float omb2, float eps, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const vitx::AdamScalars a = {lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks per SM, grid-stride
  if (blocks < 1) blocks = 1;
  if (gdtype == 1)
    vitx::adamw_kernel<vitx::bf16><<<(unsigned)blocks, 256, 0, s>>>(
        p, static_cast<const vitx::bf16*>(g), mu, nu, n, a);
  else
    vitx::adamw_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        p, static_cast<const float*>(g), mu, nu, n, a);
  return static_cast<int>(cudaGetLastError());
}
