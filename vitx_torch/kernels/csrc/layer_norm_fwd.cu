// B10: the LayerNorm forward for Hopper (sm_90a), plain and with a residual add.
//
// Replaces vitx/kernels/layer_norm.py::_ln_kernel (line 59, two pallas_calls
// in _ln_fwd; entries fused_layer_norm and fused_add_layer_norm). For rows
// of width E, scale and bias fp32, statistics in fp32 with two passes (as
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
// holds (512, E) row blocks in VMEM. Two routes, chosen by the caller
// (layer_norm.py::ln_fwd_route) and passed as ``route``; the entry refuses
// one the inputs cannot take (ERR_ROUTE) before any launch:
//   - LNF_ROUTE_ONEPASS (bf16 and fp32, E a multiple of the 16-byte vector
//     and at most 4096, every pointer 16-byte aligned; every model's
//     widths): ln_fwd_onepass_kernel, B3's one-pass layout
//     (layer_norm_bwd.cu): a near-persistent grid (the caller's
//     ``blocks``, two an SM), each block a contiguous range of rows; a row
//     group of WPR warps (one up to E 1024 in bf16, 512 in fp32) holds a
//     row in registers as 16-byte vectors, at most 4 a thread, read from
//     device memory once. The next row's loads are issued as soon as the
//     row in hand is in registers (in the add variant: summed, cast and
//     written), so they fly while this row reduces. The two statistics
//     come from the registers in a fixed order (each thread's vectors in
//     order, the warp's butterfly, the group's warps in order), y leaves
//     by 16-byte stores. Scale and bias are read once a block into
//     registers, as 16-byte vectors of the columns a thread owns, and
//     serve every row the thread walks. No shared memory beyond the
//     warps' partial sums, no atomics: the same bits every call.
//   - otherwise (0): ln_fwd_kernel, one warp a row, eight rows a block: the
//     lanes stride over the row, 16 bytes a load where E and the pointers
//     allow, walking it three times (the sum, the centred squares, the
//     output; each from L1 after the first), warp shuffles between the
//     walks, scale and bias read per element; the add variant recomputes
//     cast(x + r) in each walk rather than reading back what it wrote. Any
//     E, no E % 128 gate (that is a fact of the TPU's lanes).

#include "common.cuh"
#include "sm90.cuh"   // ERR_ROUTE, named_bar

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

// --- LNF_ROUTE_ONEPASS ---------------------------------------------------------

constexpr int LNF_ROUTE_ONEPASS = 1;
constexpr int LNF1_NT = 256;       // threads of a block
constexpr int LNF1_MAX_E = 4096;
constexpr int LNF1_MAX_NV = 4;     // 16-byte vectors of a row a thread holds

template <typename T, int WPR, int NV, bool ADD>
__global__ void __launch_bounds__(LNF1_NT, NV <= 3 ? 2 : 1)
ln_fwd_onepass_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      T* __restrict__ sum, T* __restrict__ y, int R, int E,
                      int rows_per_block, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int GT = 32 * WPR;           // threads of a row group
  constexpr int GROUPS = LNF1_NT / GT;   // row groups of a block
  __shared__ float s_red[2][GROUPS][WPR];

  const int group = threadIdx.x / GT, tg = threadIdx.x % GT;
  const int wig = tg >> 5, lane = threadIdx.x & 31;   // warp in its group
  const int nvec = E / VEC;
  const float fe = (float)E;

  // a summed over the row group: the warps' butterflies, then the warps in
  // order; every thread of the group gets the same value. Two rounds a row,
  // each with its own slots: a round's slots are written again only after
  // every thread of the group has passed the other round's barrier.
  auto group_sum = [&](float a, int round) -> float {
    a = warp_sum(a);
    if constexpr (WPR > 1) {
      if (lane == 0) s_red[round][group][wig] = a;
      sm90::named_bar(1 + group, GT);
      a = s_red[round][group][0];
#pragma unroll
      for (int w = 1; w < WPR; ++w) a += s_red[round][group][w];
    }
    return a;
  };

  // this thread's vectors j: columns (j*GT + tg)*VEC .. + VEC, where below E
  auto valid = [&](int j) { return j * GT + tg < nvec; };

  // scale and bias of those columns, for every row this thread walks
  float sc[NV][VEC], bi[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (!valid(j)) continue;
    const float4* s4 = reinterpret_cast<const float4*>(scale) + (j * GT + tg) * (VEC / 4);
    const float4* b4 = reinterpret_cast<const float4*>(bias) + (j * GT + tg) * (VEC / 4);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 a = __ldg(s4 + q), c = __ldg(b4 + q);
      sc[j][4 * q] = a.x; sc[j][4 * q + 1] = a.y; sc[j][4 * q + 2] = a.z; sc[j][4 * q + 3] = a.w;
      bi[j][4 * q] = c.x; bi[j][4 * q + 1] = c.y; bi[j][4 * q + 2] = c.z; bi[j][4 * q + 3] = c.w;
    }
  }

  uint4 xv[NV], xn[NV], rn[NV];   // the row in hand; the next row's x (and r) in flight
  auto load_row = [&](int row) {
    const size_t off = (size_t)row * E;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (valid(j)) {
        xn[j] = __ldg(reinterpret_cast<const uint4*>(x + off) + j * GT + tg);
        if constexpr (ADD) rn[j] = __ldg(reinterpret_cast<const uint4*>(r + off) + j * GT + tg);
      }
    }
  };

  const int r0 = blockIdx.x * rows_per_block, r1 = min(R, r0 + rows_per_block);
  int row = r0 + group;
  if (row < r1) load_row(row);
  for (; row < r1; row += GROUPS) {
    float f[VEC];
    // the row in hand: x, or s = cast(x + r), written once
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      if constexpr (ADD) {
        float g[VEC];
        unpack16(xn[j], f);
        unpack16(rn[j], g);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = round_to<T>(f[e] + g[e]);
        xv[j] = pack16(f);
        reinterpret_cast<uint4*>(sum + (size_t)row * E)[j * GT + tg] = xv[j];
      } else {
        xv[j] = xn[j];
      }
    }
    if (row + GROUPS < r1) load_row(row + GROUPS);   // the next row, in flight

    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) a += f[e];
    }
    const float mean = group_sum(a, 0) / fe;
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
    const float inv = 1.0f / sqrtf(group_sum(a, 1) / fe + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * E);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!valid(j)) continue;
      unpack16(xv[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = ((f[e] - mean) * inv) * sc[j][e] + bi[j][e];
      yr[j * GT + tg] = pack16(f);
    }
  }
}

template <typename T, int WPR, int NV>
cudaError_t launch_ln_fwd_onepass(const void* x, const void* r, const float* scale,
                                  const float* bias, void* sum, void* y, int R, int E,
                                  int blocks, int rows_per_block, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (r != nullptr)
    ln_fwd_onepass_kernel<T, WPR, NV, true><<<blocks, LNF1_NT, 0, s>>>(
        xt, static_cast<const T*>(r), scale, bias, static_cast<T*>(sum), static_cast<T*>(y), R,
        E, rows_per_block, eps);
  else
    ln_fwd_onepass_kernel<T, WPR, NV, false><<<blocks, LNF1_NT, 0, s>>>(
        xt, nullptr, scale, bias, nullptr, static_cast<T*>(y), R, E, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename T, int WPR>
cudaError_t ln_fwd_onepass_nv(int nv, const void* x, const void* r, const float* scale,
                              const float* bias, void* sum, void* y, int R, int E, int blocks,
                              int rows_per_block, float eps, cudaStream_t s) {
  switch (nv) {
    case 1: return launch_ln_fwd_onepass<T, WPR, 1>(x, r, scale, bias, sum, y, R, E, blocks,
                                                    rows_per_block, eps, s);
    case 2: return launch_ln_fwd_onepass<T, WPR, 2>(x, r, scale, bias, sum, y, R, E, blocks,
                                                    rows_per_block, eps, s);
    case 3: return launch_ln_fwd_onepass<T, WPR, 3>(x, r, scale, bias, sum, y, R, E, blocks,
                                                    rows_per_block, eps, s);
    case 4: return launch_ln_fwd_onepass<T, WPR, 4>(x, r, scale, bias, sum, y, R, E, blocks,
                                                    rows_per_block, eps, s);
  }
  return cudaErrorInvalidValue;
}

// The row group and vectors a thread takes at E, as layer_norm_bwd.cu's
// one-pass route: WPR the fewest warps (1, 2, 4 or 8) whose threads hold a
// row in at most LNF1_MAX_NV vectors each, NV the vectors a thread then
// holds (layer_norm.py::onepass_grid).
template <typename T>
cudaError_t run_ln_fwd_onepass(const void* x, const void* r, const float* scale,
                               const float* bias, void* sum, void* y, int R, int E, int blocks,
                               int rows_per_block, float eps, cudaStream_t s) {
  const int nvec = E / (16 / (int)sizeof(T));
  int wpr = 1;
  while (nvec > LNF1_MAX_NV * 32 * wpr) wpr *= 2;
  const int nv = (nvec + 32 * wpr - 1) / (32 * wpr);
  switch (wpr) {
    case 1: return ln_fwd_onepass_nv<T, 1>(nv, x, r, scale, bias, sum, y, R, E, blocks,
                                           rows_per_block, eps, s);
    case 2: return ln_fwd_onepass_nv<T, 2>(nv, x, r, scale, bias, sum, y, R, E, blocks,
                                           rows_per_block, eps, s);
    case 4: return ln_fwd_onepass_nv<T, 4>(nv, x, r, scale, bias, sum, y, R, E, blocks,
                                           rows_per_block, eps, s);
    case 8:
      if constexpr (sizeof(T) == 4)   // fp32 past E 2048
        return ln_fwd_onepass_nv<T, 8>(nv, x, r, scale, bias, sum, y, R, E, blocks,
                                       rows_per_block, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16 (x, r, sum, y); scale, bias fp32 (E,).
// x, y (and r, sum): (R, E) contiguous, R and E >= 1. r and sum are both
// null for the plain variant and both set for the add variant. route:
// LNF_ROUTE_ONEPASS, for a grid of ``blocks`` blocks of ``rows_per_block``
// rows each (blocks * rows_per_block >= R > (blocks - 1) * rows_per_block),
// or 0, the earlier kernel (blocks and rows_per_block unused). Returns the
// CUDA error of the launch (0 when it was accepted), or ERR_ROUTE of
// sm90.cuh for a route the inputs cannot take.
extern "C" int vitx_ln_fwd(int dtype, int route, const void* x, const void* r,
                           const float* scale, const float* bias, void* sum, void* y, int R,
                           int E, int blocks, int rows_per_block, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == vitx::LNF_ROUTE_ONEPASS) {
    const int vec = dtype == 1 ? 8 : 4;
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                           reinterpret_cast<uintptr_t>(scale) |
                           reinterpret_cast<uintptr_t>(bias) |
                           reinterpret_cast<uintptr_t>(sum) | reinterpret_cast<uintptr_t>(y);
    if (E % vec != 0 || E > vitx::LNF1_MAX_E || (ptrs & 15) != 0) return vitx::sm90::ERR_ROUTE;
    if (blocks < 1 || rows_per_block < 1 || (long long)blocks * rows_per_block < R ||
        (long long)(blocks - 1) * rows_per_block >= R)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1)
      err = vitx::run_ln_fwd_onepass<vitx::bf16>(x, r, scale, bias, sum, y, R, E, blocks,
                                                 rows_per_block, eps, s);
    else
      err = vitx::run_ln_fwd_onepass<float>(x, r, scale, bias, sum, y, R, E, blocks,
                                            rows_per_block, eps, s);
    return static_cast<int>(err);
  }
  if (route != 0) return vitx::sm90::ERR_ROUTE;
  if (dtype == 1)
    err = vitx::run_ln_fwd<vitx::bf16>(x, r, scale, bias, sum, y, R, E, eps, s);
  else
    err = vitx::run_ln_fwd<float>(x, r, scale, bias, sum, y, R, E, eps, s);
  return static_cast<int>(err);
}
