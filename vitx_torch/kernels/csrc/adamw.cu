// B12: the fused AdamW update for Hopper (sm_90a).
//
// Replaces vitx/kernels/adamw.py::_kernel (launched by _fused_leaf, entry
// fused_adamw, selected by make_optimizer(fused=True)): one pass over fp32
// leaves that reads p, g, mu, nu and writes p, mu, nu in place, with the
// update of adamw.py:46-53 in its order of operations:
//   mu' = b1 * mu + (1 - b1) * g
//   nu' = b2 * nu + ((1 - b2) * g) * g
//   p'  = p - lr * ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd * p)
// with lr, c1 = 1 - b1^t and c2 = 1 - b2^t computed by the caller. The
// gradient may be fp32 or bf16 and is upcast (adamw.py:62). Every product
// and sum is rounded on its own (__fmul_rn, __fadd_rn: no contraction into
// an FMA), so the kernels and their plain torch version agree to the bit.
//
// What bounds it on the H100: bytes, ~28 bytes per fp32 element (four
// reads, three writes) for ~15 operations. The TPU kernel needs leaves of
// >= 65536 elements in rows of 1024 (its (8, 128) tiling, adamw.py:69-90);
// here any fp32 leaf takes it. Two kernels:
//   - adamw_kernel, one leaf a launch (entry vitx_adamw): a grid-stride
//     loop, one element per thread per step;
//   - adamw_multi_kernel, every leaf of a step in one launch (entry
//     vitx_adamw_multi; one launch per gradient dtype). A step of ViT-B/16
//     has 21 leaves, the LayerNorm scales and biases among them too small
//     to fill the card, and one launch per leaf ran them one after another.
//     Here a table of the leaves (pointers, sizes, first chunks) rides in a
//     __grid_constant__ parameter, persistent blocks take fixed chunks of
//     ADAM_CHUNK elements across the leaf boundaries, and each thread moves
//     16-byte vectors of p, mu, nu and fp32 g (8 bytes of bf16 g),
//     ADAM_UNROLL of each stream in flight, with evict-first loads and
//     stores (__ldcs, __stcs: every byte is touched once). A leaf whose
//     pointers are not co-aligned runs scalar; otherwise its first 0-3
//     elements (to the 16-byte boundary) and its last 0-3 run scalar in its
//     first chunk.

#include "common.cuh"

namespace vitx {

struct AdamScalars {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

// one element's update, in adamw.py:46-53's order
__device__ __forceinline__ void adam_step(float& p, float g, float& m, float& v,
                                          const AdamScalars& a) {
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float mh = __fdiv_rn(m2, a.c1);
  const float vh = __fdiv_rn(v2, a.c2);
  const float u = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps)), __fmul_rn(a.wd, p));
  p = __fsub_rn(p, __fmul_rn(a.lr, u));
  m = m2;
  v = v2;
}

template <typename G>
__global__ void __launch_bounds__(256)
adamw_kernel(float* __restrict__ p, const G* __restrict__ g, float* __restrict__ mu,
             float* __restrict__ nu, long long n, const AdamScalars a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float pi = p[i], mi = mu[i], vi = nu[i];
    adam_step(pi, to_f(g[i]), mi, vi, a);
    p[i] = pi;
    mu[i] = mi;
    nu[i] = vi;
  }
}

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_UNROLL = 2;                                   // vectors in flight per stream
constexpr int ADAM_CHUNK_VEC = ADAM_THREADS * ADAM_UNROLL;       // 16-byte vectors a chunk
constexpr int ADAM_CHUNK = 4 * ADAM_CHUNK_VEC;                   // elements a chunk
constexpr int ADAM_MAX_LEAVES = 64;                              // leaves a launch

struct AdamLeaf {
  float* p;
  const void* g;
  float* mu;
  float* nu;
  long long n;        // elements, > 0
  long long chunk0;   // the leaf's first chunk in the launch
  int head;           // scalar elements before the 16-byte body (0-3); -1: all scalar
  int pad;
};

struct AdamTable {
  AdamLeaf leaf[ADAM_MAX_LEAVES];
  long long chunks;   // over all leaves
  int n_leaves;
};
static_assert(sizeof(AdamTable) + sizeof(AdamScalars) <= 4096,
              "the leaf table must fit the 4 KB of kernel parameters");

__device__ __forceinline__ float4 load_g4(const float* g, long long v) {
  return __ldcs(reinterpret_cast<const float4*>(g) + v);
}
__device__ __forceinline__ float4 load_g4(const bf16* g, long long v) {
  const uint2 r = __ldcs(reinterpret_cast<const uint2*>(g) + v);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename G>
__global__ void __launch_bounds__(ADAM_THREADS)
adamw_multi_kernel(const __grid_constant__ AdamTable t, const AdamScalars a) {
  for (long long c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    // the leaf of chunk c: the last whose first chunk is <= c
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const AdamLeaf& L = t.leaf[lo];
    const long long k = c - L.chunk0;
    float* p = L.p;
    float* mu = L.mu;
    float* nu = L.nu;
    const G* g = static_cast<const G*>(L.g);
    auto scalar = [&](long long i) {
      float pi = p[i], mi = mu[i], vi = nu[i];
      adam_step(pi, to_f(g[i]), mi, vi, a);
      p[i] = pi;
      mu[i] = mi;
      nu[i] = vi;
    };
    if (L.head < 0) {   // pointers not co-aligned: the chunk element by element
      const long long e0 = k * ADAM_CHUNK;
      const long long e1 = e0 + ADAM_CHUNK < L.n ? e0 + ADAM_CHUNK : L.n;
      for (long long i = e0 + threadIdx.x; i < e1; i += ADAM_THREADS) scalar(i);
      continue;
    }
    const int h = L.head;
    const long long nvec = (L.n - h) >> 2;
    if (k == 0) {   // the head before the 16-byte body and the tail after it
      const long long tail0 = h + 4 * nvec;
      const int i = threadIdx.x;
      if (i < h) scalar(i);
      else if (i < h + (int)(L.n - tail0)) scalar(tail0 + (i - h));
    }
    float4* p4 = reinterpret_cast<float4*>(p + h);
    float4* m4 = reinterpret_cast<float4*>(mu + h);
    float4* n4 = reinterpret_cast<float4*>(nu + h);
    const G* gb = g + h;
    const long long v0 = k * ADAM_CHUNK_VEC + threadIdx.x;
    float4 pv[ADAM_UNROLL], gv[ADAM_UNROLL], mv[ADAM_UNROLL], vv[ADAM_UNROLL];
#pragma unroll
    for (int u = 0; u < ADAM_UNROLL; ++u) {
      const long long v = v0 + u * ADAM_THREADS;
      if (v < nvec) {
        pv[u] = __ldcs(p4 + v);
        gv[u] = load_g4(gb, v);
        mv[u] = __ldcs(m4 + v);
        vv[u] = __ldcs(n4 + v);
      }
    }
#pragma unroll
    for (int u = 0; u < ADAM_UNROLL; ++u) {
      const long long v = v0 + u * ADAM_THREADS;
      if (v < nvec) {
        adam_step(pv[u].x, gv[u].x, mv[u].x, vv[u].x, a);
        adam_step(pv[u].y, gv[u].y, mv[u].y, vv[u].y, a);
        adam_step(pv[u].z, gv[u].z, mv[u].z, vv[u].z, a);
        adam_step(pv[u].w, gv[u].w, mv[u].w, vv[u].w, a);
        __stcs(p4 + v, pv[u]);
        __stcs(m4 + v, mv[u]);
        __stcs(n4 + v, vv[u]);
      }
    }
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

// One launch over n_leaves (1 to ADAM_MAX_LEAVES) leaves whose gradients
// share gdtype: ptrs[4*i .. 4*i+3] = p, g, mu, nu of leaf i (fp32 but g,
// contiguous), numels[i] its elements (> 0); the scalars as for
// vitx_adamw. Returns the launch's CUDA error, or cudaErrorInvalidValue
// for a leaf count or size it cannot take.
extern "C" int vitx_adamw_multi(int gdtype, int n_leaves, const long long* ptrs,
                                const long long* numels, float lr, float c1, float c2,
                                float b1, float omb1, float b2, float omb2, float eps,
                                float wd, void* stream) {
  using namespace vitx;
  if (n_leaves < 1 || n_leaves > ADAM_MAX_LEAVES)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t = {};
  t.n_leaves = n_leaves;
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long n = numels[i];
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned long long ap = ptrs[4 * i], ag = ptrs[4 * i + 1], am = ptrs[4 * i + 2],
                             an = ptrs[4 * i + 3];
    // the body starts where p is 16-byte aligned; mu, nu and g must be
    // aligned there too (g: 16 bytes in fp32, 8 in bf16)
    const int mis = (int)((ap & 15) >> 2);
    const bool g_ok = gdtype == 1 ? (ag & 1) == 0 && (int)((ag & 7) >> 1) == mis
                                  : (ag & 15) == (ap & 15);
    const bool co = (ap & 3) == 0 && (am & 15) == (ap & 15) && (an & 15) == (ap & 15) && g_ok;
    AdamLeaf& L = t.leaf[i];
    L.p = reinterpret_cast<float*>(ap);
    L.g = reinterpret_cast<const void*>(ag);
    L.mu = reinterpret_cast<float*>(am);
    L.nu = reinterpret_cast<float*>(an);
    L.n = n;
    L.chunk0 = chunks;
    if (co) {
      const int h = (4 - mis) & 3;
      L.head = n < h ? (int)n : h;
      const long long nvec = (n - L.head) >> 2;
      const long long c = (nvec + ADAM_CHUNK_VEC - 1) / ADAM_CHUNK_VEC;
      chunks += c > 0 ? c : 1;
    } else {
      L.head = -1;
      chunks += (n + ADAM_CHUNK - 1) / ADAM_CHUNK;
    }
  }
  t.chunks = chunks;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // persistent: at most 8 blocks of 256 threads an SM (2048 threads)
  const long long blocks = chunks < 8LL * sms ? chunks : 8LL * sms;
  const AdamScalars a = {lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gdtype == 1)
    adamw_multi_kernel<bf16><<<(unsigned)blocks, ADAM_THREADS, 0, s>>>(t, a);
  else
    adamw_multi_kernel<float><<<(unsigned)blocks, ADAM_THREADS, 0, s>>>(t, a);
  return static_cast<int>(cudaGetLastError());
}
