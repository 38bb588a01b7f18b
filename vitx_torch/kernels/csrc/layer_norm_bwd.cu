// B3: the LayerNorm backward for Hopper (sm_90a).
//
// Replaces vitx/kernels/layer_norm.py::_ln_bwd3_kernel (launched by
// _ln_bwd3_call, entry ln_bwd), which every LayerNorm backward of a train
// step runs through on the TPU. For rows x, dy of width E and an fp32
// scale s, with the statistics recomputed in fp32 (two passes, as
// layer_norm.py:46-52):
//   xhat = (x - mean) * inv,  gs = dy * s
//   dx = inv * (gs - mean(gs) - xhat * mean(gs * xhat))   (cast to x's dtype)
//   dscale = sum over rows of dy * xhat,  dbias = sum over rows of dy (fp32)
//
// What bounds it on the H100: bytes. It reads x and dy and writes dx,
// ~25 operations per element: at ViT-B/16 batch 128 bf16 (25,216 rows of
// 768) the bound is ~0.035 ms. The TPU kernel holds (bb, T, E) blocks in
// VMEM and writes (B, 2, E) partial column sums; here a row's statistics
// and the column sums need different thread layouts, so three launches,
// with no atomics and a fixed summation order:
//   1. rows_kernel: one warp per row: mean, inv, the two row means, dx;
//      writes mean and inv (fp32) per row for launch 2;
//   2. cols_kernel: one thread per column and chunk of 64 rows: partial
//      sums of dy * xhat and dy, (chunks, 2, E) fp32;
//   3. reduce_kernel: one thread per column: the partials summed in chunk
//      order into dscale and dbias.
// Launch 2 reads x and dy a second time (from L2 for the most part).

#include "common.cuh"

namespace vitx {

constexpr int LN_ROWS_PER_CHUNK = 64;
constexpr int LN_NT = 256;

template <typename T>
__global__ void __launch_bounds__(LN_NT)
rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
            const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ stats,
            int R, int E, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const T* xr = x + (size_t)row * E;
  const T* gr = dy + (size_t)row * E;
  float s = 0.0f;
  for (int c = lane; c < E; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / (float)E;
  float v = 0.0f;
  for (int c = lane; c < E; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) / (float)E + eps);
  float a1 = 0.0f, a2 = 0.0f;
  for (int c = lane; c < E; c += 32) {
    const float gs = to_f(gr[c]) * scale[c];
    a1 += gs;
    a2 += gs * ((to_f(xr[c]) - mean) * inv);
  }
  const float m1 = warp_sum(a1) / (float)E;
  const float m2 = warp_sum(a2) / (float)E;
  T* dr = dx + (size_t)row * E;
  for (int c = lane; c < E; c += 32) {
    const float gs = to_f(gr[c]) * scale[c];
    const float xhat = (to_f(xr[c]) - mean) * inv;
    dr[c] = from_f<T>(inv * (gs - m1 - xhat * m2));
  }
  if (lane == 0) {
    stats[row] = mean;
    stats[R + row] = inv;
  }
}

template <typename T>
__global__ void __launch_bounds__(LN_NT)
cols_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ stats, float* __restrict__ part, int R, int E) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int chunk = blockIdx.y;
  if (col >= E) return;
  const int r0 = chunk * LN_ROWS_PER_CHUNK;
  const int r1 = min(R, r0 + LN_ROWS_PER_CHUNK);
  float ds = 0.0f, db = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const float g = to_f(dy[(size_t)r * E + col]);
    const float xhat = (to_f(x[(size_t)r * E + col]) - stats[r]) * stats[R + r];
    ds += g * xhat;
    db += g;
  }
  part[((size_t)chunk * 2) * E + col] = ds;
  part[((size_t)chunk * 2 + 1) * E + col] = db;
}

__global__ void __launch_bounds__(LN_NT)
reduce_kernel(const float* __restrict__ part, float* __restrict__ dscale,
              float* __restrict__ dbias, int chunks, int E) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= E) return;
  float ds = 0.0f, db = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    ds += part[((size_t)c * 2) * E + col];
    db += part[((size_t)c * 2 + 1) * E + col];
  }
  dscale[col] = ds;
  dbias[col] = db;
}

template <typename T>
cudaError_t run_ln_bwd(const void* x, const float* scale, const void* dy, void* dx,
                       float* dscale, float* dbias, float* stats, float* part, int R, int E,
                       float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  rows_kernel<T><<<(R + LN_NT / 32 - 1) / (LN_NT / 32), LN_NT, 0, s>>>(
      xt, scale, gt, static_cast<T*>(dx), stats, R, E, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = (R + LN_ROWS_PER_CHUNK - 1) / LN_ROWS_PER_CHUNK;
  const int cb = (E + LN_NT - 1) / LN_NT;
  cols_kernel<T><<<dim3(cb, chunks), LN_NT, 0, s>>>(xt, gt, stats, part, R, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<cb, LN_NT, 0, s>>>(part, dscale, dbias, chunks, E);
  return cudaGetLastError();
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx); scale, dscale, dbias fp32.
// x, dy, dx: (R, E) contiguous. Scratch from the caller: stats (2*R fp32),
// part (2*E*ceil(R/64) fp32). Returns the first CUDA error of the launches.
extern "C" int vitx_ln_bwd(int dtype, const void* x, const float* scale, const void* dy,
                           void* dx, float* dscale, float* dbias, float* stats, float* part,
                           int R, int E, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::run_ln_bwd<vitx::bf16>(x, scale, dy, dx, dscale, dbias, stats, part, R, E,
                                       eps, s);
  else
    err = vitx::run_ln_bwd<float>(x, scale, dy, dx, dscale, dbias, stats, part, R, E, eps,
                                  s);
  return static_cast<int>(err);
}
