// B3: the LayerNorm backward for Hopper (sm_90a).
//
// Replaces vitx/kernels/layer_norm.py::_ln_bwd3_kernel (line 173, its
// pallas_call at :199, entry ln_bwd), which every LayerNorm backward of a
// train step runs through on the TPU, and, on the 2-D (R, E) view,
// _ln_bwd_kernel (line 114, B11). For rows x, dy of width E and an fp32
// scale s, with the statistics recomputed in fp32 (two passes, as
// layer_norm.py:46-52):
//   xhat = (x - mean) * inv,  gs = dy * s
//   dx = inv * (gs - mean(gs) - xhat * mean(gs * xhat))   (cast to x's dtype)
//   dscale = sum over rows of dy * xhat,  dbias = sum over rows of dy (fp32)
//
// What bounds it on the H100: bytes. It reads x and dy and writes dx,
// ~25 operations per element: at ViT-B/16 batch 128 bf16 (25,216 rows of
// 768) that is 116 MB, ~0.035 ms at 3.35 TB/s. The TPU kernel holds
// (bb, T, E) blocks in VMEM and writes (B, 2, E) partial column sums. Two
// routes, chosen by the caller (layer_norm.py::ln_bwd_route) and passed as
// ``route``; the entry refuses one the inputs cannot take (ERR_ROUTE)
// before any launch:
//   - LN_ROUTE_ONEPASS (bf16 and fp32, E a multiple of the 16-byte vector
//     and at most 4096, x, dy and dx 16-byte aligned): x and dy read from
//     device memory once, in two launches:
//       1. onepass_kernel: a near-persistent grid (the caller's ``blocks``,
//          a few per SM), each block a contiguous range of rows. A row
//          group of WPR warps (one warp up to E 1024 in bf16, 512 in fp32)
//          holds a row in registers as 16-byte vectors, at most 4 a
//          thread, and loads its next row while it computes this one. The
//          statistics, the two row means and dx come from the registers;
//          dx leaves by 16-byte stores. Each thread owns fixed columns and
//          adds dy * xhat and dy into fp32 registers over its group's
//          rows; the block adds its groups in group order in shared memory
//          and writes (blocks, 2, E) partials.
//       2. part_reduce_kernel: the partials summed per column in a fixed
//          order (eight strided runs over the blocks, then the eight in
//          order) into dscale and dbias.
//     No atomics: the same bits every call (for a given ``blocks``).
//   - otherwise (0): three launches with scalar 2-byte reads:
//       1. rows_kernel: one warp per row: mean, inv, the two row means, dx;
//          writes mean and inv (fp32) per row for launch 2;
//       2. cols_kernel: one thread per column and chunk of 64 rows: partial
//          sums of dy * xhat and dy, (chunks, 2, E) fp32;
//       3. reduce_kernel: one thread per column: the partials summed in
//          chunk order into dscale and dbias.
//     Launch 2 reads x and dy a second time (from L2 for the most part).

#include "common.cuh"
#include "sm90.cuh"   // ERR_ROUTE

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

// --- LN_ROUTE_ONEPASS ---------------------------------------------------------

constexpr int LN_ROUTE_ONEPASS = 1;
constexpr int LN1_NT = 256;       // threads of a block
constexpr int LN1_MAX_E = 4096;
constexpr int LN1_MAX_NV = 4;     // 16-byte vectors of x (and of dy) a thread holds

// Shared memory of onepass_kernel, in floats: the scale (E), the block's
// column sums (2 x E) and the row groups' cross-warp sums (3 rounds x
// groups x WPR pairs).
template <int WPR> __host__ __device__ constexpr int ln1_smem_floats(int E) {
  return 3 * E + 3 * (LN1_NT / (32 * WPR)) * WPR * 2;
}

template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(LN1_NT, NV <= 3 ? 2 : 1)
onepass_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part, int R,
               int E, int rows_per_block, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int GT = 32 * WPR;           // threads of a row group
  constexpr int GROUPS = LN1_NT / GT;    // row groups of a block
  extern __shared__ float4 ln1_smem[];
  float* s_scale = reinterpret_cast<float*>(ln1_smem);
  float* s_col = s_scale + E;                  // 2 x E
  float* s_red = s_col + 2 * E;                // 3 x GROUPS x WPR x 2

  const int group = threadIdx.x / GT, tg = threadIdx.x % GT;
  const int wig = tg >> 5, lane = threadIdx.x & 31;   // warp in its group
  const int nvec = E / VEC;
  const float fe = (float)E;
  for (int c = threadIdx.x; c < E; c += LN1_NT) s_scale[c] = scale[c];
  __syncthreads();

  // (a, b) summed over the row group: the warps' butterflies, then the
  // warps in order; every thread of the group gets the same two values
  auto group_sum = [&](float a, float b, int round) -> float2 {
    a = warp_sum(a);
    b = warp_sum(b);
    if constexpr (WPR > 1) {
      float* red = s_red + (round * GROUPS + group) * WPR * 2;
      if (lane == 0) {
        red[2 * wig] = a;
        red[2 * wig + 1] = b;
      }
      sm90::named_bar(1 + group, GT);
      a = red[0];
      b = red[1];
#pragma unroll
      for (int w = 1; w < WPR; ++w) {
        a += red[2 * w];
        b += red[2 * w + 1];
      }
    }
    return make_float2(a, b);
  };

  // this thread's vectors j: columns (j*GT + tg)*VEC .. + VEC, where below E
  auto valid = [&](int j) { return j * GT + tg < nvec; };
  uint4 xv[NV], gv[NV], xn[NV], gn[NV];
  auto load_row = [&](int row, uint4 (&xa)[NV], uint4 (&ga)[NV]) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * E);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + (size_t)row * E);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (valid(j)) {
        xa[j] = __ldg(xr + j * GT + tg);
        ga[j] = __ldg(gr + j * GT + tg);
      }
    }
  };

  float ds[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[j][e] = db[j][e] = 0.0f;
  }

  const int r0 = blockIdx.x * rows_per_block, r1 = min(R, r0 + rows_per_block);
  int row = r0 + group;
  if (row < r1) load_row(row, xv, gv);
  for (; row < r1; row += GROUPS) {
    if (row + GROUPS < r1) load_row(row + GROUPS, xn, gn);   // the next row, in flight
    float f[VEC], g[VEC];
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a += f[e];
    }
    const float mean = group_sum(a, 0.0f, 0).x / fe;
    a = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = f[e] - mean;
        a += d * d;
      }
    }
    const float inv = 1.0f / sqrtf(group_sum(a, 0.0f, 1).x / fe + eps);
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
      unpack16(gv[j], g);
      const float* sc = s_scale + (j * GT + tg) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gs = g[e] * sc[e];
        a1 += gs;
        a2 += gs * ((f[e] - mean) * inv);
      }
    }
    const float2 ms = group_sum(a1, a2, 2);
    const float m1 = ms.x / fe, m2 = ms.y / fe;
    uint4* dr = reinterpret_cast<uint4*>(dx + (size_t)row * E);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
      unpack16(gv[j], g);
      const float* sc = s_scale + (j * GT + tg) * VEC;
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gs = g[e] * sc[e];
        const float xhat = (f[e] - mean) * inv;
        o[e] = inv * (gs - m1 - xhat * m2);
        ds[j][e] += g[e] * xhat;
        db[j][e] += g[e];
      }
      dr[j * GT + tg] = pack16(o);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xv[j] = xn[j];
      gv[j] = gn[j];
    }
  }

  // the block's column sums: group 0's, plus group 1's, ... in order; the
  // last group writes them to the block's partials
  float* dst = part + (size_t)blockIdx.x * 2 * E;
  for (int gi = 0; gi < GROUPS; ++gi) {
    if (group == gi) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!valid(j)) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int c = (j * GT + tg) * VEC + e;
          float a = ds[j][e], b = db[j][e];
          if (gi > 0) {
            a = s_col[c] + a;
            b = s_col[E + c] + b;
          }
          if (gi + 1 < GROUPS) {
            s_col[c] = a;
            s_col[E + c] = b;
          } else {
            dst[c] = a;
            dst[E + c] = b;
          }
        }
      }
    }
    if (gi + 1 < GROUPS) __syncthreads();
  }
}

// dscale[c] and dbias[c] from part (blocks, 2, E): per column, eight
// strided runs over the blocks (run i: blocks i, i + 8, ...), then the
// eight runs in order. blockIdx.y: 0 dscale, 1 dbias.
__global__ void __launch_bounds__(256)
part_reduce_kernel(const float* __restrict__ part, float* __restrict__ dscale,
                   float* __restrict__ dbias, int blocks, int E) {
  __shared__ float run[8][33];
  const int cx = threadIdx.x & 31, py = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cx, w = blockIdx.y;
  float s = 0.0f;
  if (col < E)
    for (int p = py; p < blocks; p += 8) s += part[((size_t)p * 2 + w) * E + col];
  run[py][cx] = s;
  __syncthreads();
  if (py == 0 && col < E) {
    float t = run[0][cx];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += run[i][cx];
    (w == 0 ? dscale : dbias)[col] = t;
  }
}

template <typename T, int WPR, int NV>
cudaError_t launch_onepass(const void* x, const float* scale, const void* dy, void* dx,
                           float* dscale, float* dbias, float* part, int R, int E, int blocks,
                           int rows_per_block, float eps, cudaStream_t s) {
  const int bytes = ln1_smem_floats<WPR>(E) * (int)sizeof(float);
  auto kern = onepass_kernel<T, WPR, NV>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, LN1_NT, bytes, s>>>(static_cast<const T*>(x), scale, static_cast<const T*>(dy),
                                     static_cast<T*>(dx), part, R, E, rows_per_block, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  part_reduce_kernel<<<dim3((E + 31) / 32, 2), 256, 0, s>>>(part, dscale, dbias, blocks, E);
  return cudaGetLastError();
}

template <typename T, int WPR>
cudaError_t onepass_nv(int nv, const void* x, const float* scale, const void* dy, void* dx,
                       float* dscale, float* dbias, float* part, int R, int E, int blocks,
                       int rows_per_block, float eps, cudaStream_t s) {
  switch (nv) {
    case 1: return launch_onepass<T, WPR, 1>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                             blocks, rows_per_block, eps, s);
    case 2: return launch_onepass<T, WPR, 2>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                             blocks, rows_per_block, eps, s);
    case 3: return launch_onepass<T, WPR, 3>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                             blocks, rows_per_block, eps, s);
    case 4: return launch_onepass<T, WPR, 4>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                             blocks, rows_per_block, eps, s);
  }
  return cudaErrorInvalidValue;
}

// The row group and vectors a thread of the one-pass route takes at E:
// WPR the fewest warps (1, 2, 4 or 8) whose threads hold a row in at most
// LN1_MAX_NV vectors each, NV the vectors a thread then holds.
template <typename T>
cudaError_t run_ln_bwd_onepass(const void* x, const float* scale, const void* dy, void* dx,
                               float* dscale, float* dbias, float* part, int R, int E,
                               int blocks, int rows_per_block, float eps, cudaStream_t s) {
  const int nvec = E / (16 / (int)sizeof(T));
  int wpr = 1;
  while (nvec > LN1_MAX_NV * 32 * wpr) wpr *= 2;
  const int nv = (nvec + 32 * wpr - 1) / (32 * wpr);
  switch (wpr) {
    case 1: return onepass_nv<T, 1>(nv, x, scale, dy, dx, dscale, dbias, part, R, E, blocks,
                                    rows_per_block, eps, s);
    case 2: return onepass_nv<T, 2>(nv, x, scale, dy, dx, dscale, dbias, part, R, E, blocks,
                                    rows_per_block, eps, s);
    case 4: return onepass_nv<T, 4>(nv, x, scale, dy, dx, dscale, dbias, part, R, E, blocks,
                                    rows_per_block, eps, s);
    case 8:
      if constexpr (sizeof(T) == 4)   // fp32 past E 2048
        return onepass_nv<T, 8>(nv, x, scale, dy, dx, dscale, dbias, part, R, E, blocks,
                                rows_per_block, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx); scale, dscale, dbias fp32.
// x, dy, dx: (R, E) contiguous. route: LN_ROUTE_ONEPASS or 0 (above).
// Scratch from the caller: on the one-pass route, part (blocks * 2 * E
// fp32) for a grid of ``blocks`` blocks of ``rows_per_block`` rows each
// (blocks * rows_per_block >= R > (blocks - 1) * rows_per_block), stats
// unused (null); on route 0, stats (2*R fp32) and part (2*E*ceil(R/64)
// fp32), blocks and rows_per_block unused. Returns the first error of the
// launches: a cudaError_t, or ERR_ROUTE of sm90.cuh for a route the inputs
// cannot take.
extern "C" int vitx_ln_bwd(int dtype, int route, const void* x, const float* scale,
                           const void* dy, void* dx, float* dscale, float* dbias, float* stats,
                           float* part, int R, int E, int blocks, int rows_per_block, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == vitx::LN_ROUTE_ONEPASS) {
    const int vec = dtype == 1 ? 8 : 4;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                           reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
    if (E % vec != 0 || E > vitx::LN1_MAX_E || !aligned) return vitx::sm90::ERR_ROUTE;
    if (blocks < 1 || rows_per_block < 1 || (long long)blocks * rows_per_block < R ||
        (long long)(blocks - 1) * rows_per_block >= R)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1)
      err = vitx::run_ln_bwd_onepass<vitx::bf16>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                                 blocks, rows_per_block, eps, s);
    else
      err = vitx::run_ln_bwd_onepass<float>(x, scale, dy, dx, dscale, dbias, part, R, E,
                                            blocks, rows_per_block, eps, s);
    return static_cast<int>(err);
  }
  if (route != 0) return vitx::sm90::ERR_ROUTE;
  if (dtype == 1)
    err = vitx::run_ln_bwd<vitx::bf16>(x, scale, dy, dx, dscale, dbias, stats, part, R, E,
                                       eps, s);
  else
    err = vitx::run_ln_bwd<float>(x, scale, dy, dx, dscale, dbias, stats, part, R, E, eps,
                                  s);
  return static_cast<int>(err);
}
