// B10: the LayerNorm forward for Hopper (sm_90a), plain and with a residual add.
//
// Replaces vitx/kernels/layer_norm.py::_ln_kernel (two pallas_calls in
// _ln_fwd; entries fused_layer_norm and fused_add_layer_norm). For rows of
// width E, scale and bias fp32, statistics in fp32 with two passes (as
// _stats, layer_norm.py:46-52):
//   y = ((x - mean) * inv) * scale + bias,  inv = 1 / sqrt(var + eps)
// cast once to x's dtype. The add variant first forms s = cast(x + r) in
// fp32, writes s, and normalises the cast s (layer_norm.py:62-66), so its
// sum equals torch's x + r bit for bit and its statistics are those of
// the tensor it returns.
//
// What bounds it on the H100: bytes. It reads x (and r) and writes y (and
// s), ~8 operations per element: at (256 x 197, 768) bf16 that is 155 MB,
// 0.046 ms at 3.35 TB/s (the add variant 310 MB, 0.093 ms). The TPU kernel
// holds (512, E) row blocks in VMEM; here one warp owns a row, eight rows
// a block, with no shared memory and no atomics: the lanes stride over the
// row, 16 bytes a load where E and the pointers allow, and warp shuffles
// sum the statistics in a fixed order, so two calls agree bit for bit.
// The mean, variance and output passes each read the row again (from L1:
// a row is 1.5 KB at E = 768 bf16); the add variant recomputes cast(x + r)
// in each pass rather than reading back what it wrote. Any E, no E % 128
// gate (that is a fact of the TPU's lanes).

#include "common.cuh"

namespace vitx {

constexpr int LNF_NT = 256;   // 8 warps, one row each

// V consecutive elements at p in fp32; V * sizeof(T) == 16 is one load
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vals(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename T, int V, bool ADD>
__global__ void __launch_bounds__(LNF_NT)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ sum, T* __restrict__ y, int R, int E, float eps) {
  const int row = blockIdx.x * (LNF_NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const size_t off = (size_t)row * E;
  // elements c .. c + V of the row in fp32: x's, or the cast sum x + r
  auto load = [&](int c, float* v) {
    load_vals<T, V>(x + off + c, v);
    if constexpr (ADD) {
      float w[V];
      load_vals<T, V>(r + off + c, w);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = round_to<T>(v[j] + w[j]);
    }
  };

  float s = 0.0f;
  for (int c = lane * V; c < E; c += 32 * V) {
    float v[V];
    load(c, v);
    if constexpr (ADD) store_vals<T, V>(sum + off + c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
  }
  const float mean = warp_sum(s) / (float)E;

  float q = 0.0f;
  for (int c = lane * V; c < E; c += 32 * V) {
    float v[V];
    load(c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean;
      q += d * d;
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(q) / (float)E + eps);

  for (int c = lane * V; c < E; c += 32 * V) {
    float v[V];
    load(c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = ((v[j] - mean) * inv) * scale[c + j] + bias[c + j];
    store_vals<T, V>(y + off + c, v);
  }
}

template <typename T, int V, bool ADD>
cudaError_t launch_ln_fwd(const void* x, const void* r, const float* scale, const float* bias,
                          void* sum, void* y, int R, int E, float eps, cudaStream_t s) {
  const int blocks = (R + LNF_NT / 32 - 1) / (LNF_NT / 32);
  ln_fwd_kernel<T, V, ADD><<<blocks, LNF_NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, bias, static_cast<T*>(sum),
      static_cast<T*>(y), R, E, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_ln_fwd(const void* x, const void* r, const float* scale, const float* bias,
                       void* sum, void* y, int R, int E, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool add = r != nullptr;
  const bool vec = E % V == 0 && aligned(x) && aligned(y) && (!add || (aligned(r) && aligned(sum)));
  if (add)
    return vec ? launch_ln_fwd<T, V, true>(x, r, scale, bias, sum, y, R, E, eps, s)
               : launch_ln_fwd<T, 1, true>(x, r, scale, bias, sum, y, R, E, eps, s);
  return vec ? launch_ln_fwd<T, V, false>(x, r, scale, bias, sum, y, R, E, eps, s)
             : launch_ln_fwd<T, 1, false>(x, r, scale, bias, sum, y, R, E, eps, s);
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16 (x, r, sum, y); scale, bias fp32 (E,).
// x, y (and r, sum): (R, E) contiguous, R and E >= 1. r and sum are both
// null for the plain variant and both set for the add variant. Returns
// the CUDA error of the launch (0 when it was accepted).
extern "C" int vitx_ln_fwd(int dtype, const void* x, const void* r, const float* scale,
                           const float* bias, void* sum, void* y, int R, int E, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::run_ln_fwd<vitx::bf16>(x, r, scale, bias, sum, y, R, E, eps, s);
  else
    err = vitx::run_ln_fwd<float>(x, r, scale, bias, sum, y, R, E, eps, s);
  return static_cast<int>(err);
}
