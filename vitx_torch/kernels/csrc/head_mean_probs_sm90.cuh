// The head-mean attention probabilities on Hopper (sm_90a): the pass after
// B5's sm90 body (attention_fwd_sm90.cuh) has written each row's statistics.
// B7's caller (mha_block.cu, entry vitx_mha_block_mean_probs) runs it; it
// replaces the PROBS_MEAN mode of attention_fwd.cuh on the sm90 route, i.e.
// the probabilities half of vitx/kernels/mha_block.py::_kernel_hchunk
// (mha_block.py:174, its pallas_call at :298 through _chunked_fwd).
//
// Over the unscaled q and k planes (B, H, T, 64) bf16 that the QKV GEMM
// wrote and the statistics stats (2, B*H*T) fp32 -- m, the row max of the
// scaled logits, then linv = 1 / l -- that the body wrote for the same q
// and k:
//   probs[b, t, u] = (sum over h, in order, of exp(s_h[t, u] - m_h[t]) *
//                     linv_h[t]) / H,     s_h = scale * (q_h k_h^T)  (fp32)
// (B, T, T) fp32, every element written once.
//
// Rounding points against vitx (mha_block.py:206-218), which takes m from
// the whole row and sums p / (l * H):
//   - m and l come from the body's online softmax: l is summed over 64-key
//     tiles and rescaled by exp(m_old - m_new) as the running max moves;
//   - p is exp(s - m) times linv (one fused multiply-add into the head
//     sum), not a division by l * H; the sum over the heads is divided by H
//     once, at the end;
//   - s is the wgmma's fp32 sum of q k^T, times the scale 2^-3, exact at
//     D = 64 (the body's s, bit for bit: the same m64n64k16 products over
//     the same swizzled tiles);
//   - exp is exp2f((s - m) * log2 e), as in the body.
// Each moves a probability by a few fp32 ulps; rows still sum to 1 within
// 1e-5 (PERF.md).
//
// What bounds it on the H100: per call at (32, 577, 16 heads), 170 M
// exponentials (the SFU: ~0.05 ms), 21.8 GFLOP of q k^T (~0.02 ms) and the
// 42.6 MB written (~0.013 ms); q and k (38 MB) stay in L2 and are re-read
// once per key tile and query tile. attention_fwd.cuh's mean mode instead
// ran one block per (image, 64 queries) over the 16 heads in series, with
// q k^T three times per head and a read-modify-write of the output in
// device memory per head. The design:
//   - one block per (image, 64 queries, 128 keys): 1600 blocks at (32,
//     577), one consumer warpgroup and one producer warp, two blocks an SM;
//   - the producer keeps each head's q tile and two 64-key k tiles in a
//     three-stage ring by TMA, signalling an mbarrier per stage (a k tile
//     wholly past T is not loaded: its columns are never stored);
//   - the consumer warpgroup loops over the heads in order: s = q k^T as
//     2 x 4 wgmma m64n64k16 from shared memory, the stage released, then
//     exp, linv and the head sum in fp32 registers (64 floats a thread);
//     the next head's statistics are loaded under the products;
//   - after the last head the sum is divided by H and each element stored
//     once with a 4-byte store, rows and columns past T skipped (the output
//     row is 4T bytes, not a multiple of 16 at T 577, so no TMA store).
// The order over the heads is fixed and there are no atomics: the same
// bits from call to call.

#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vitx {

constexpr int HMP_NS = 3;                  // stages of the q/k ring
constexpr int HMP_KEYS = 128;              // keys a block: two 64-key tiles
constexpr int HMP_THREADS = 128 + 32;      // a consumer warpgroup and a producer warp

struct HmpSmem {
  static constexpr int STAGE = 3 * sm90::TILE_BYTES;           // q, k keys 0-63, k keys 64-127
  static constexpr int BAR = HMP_NS * STAGE;                   // full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * 2 * HMP_NS + 1024;    // + the base's alignment
};

__global__ void __launch_bounds__(HMP_THREADS, 2)
head_mean_probs_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, const float* __restrict__ stats,
                     float* __restrict__ probs, int H, int T, float scale) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + HmpSmem::BAR);
  uint64_t* empty = full + HMP_NS;
  constexpr int TE = TILE_BYTES / 2;   // elements of a tile

  const int k0 = blockIdx.x * HMP_KEYS, q0 = blockIdx.y * 64, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HMP_NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane == 0) {
      const bool two = k0 + 64 < T;   // the second k tile holds keys below T
      for (int h = 0; h < H; ++h) {
        const int s = h % HMP_NS;
        if (h >= HMP_NS) mbar_wait(&empty[s], (h / HMP_NS - 1) & 1);
        bf16* st = reinterpret_cast<bf16*>(smem + s * HmpSmem::STAGE);
        mbar_arrive_expect_tx(&full[s], (two ? 3 : 2) * TILE_BYTES);
        tma_load_tile(st, &tq, &full[s], q0, h, b);
        tma_load_tile(st + TE, &tk, &full[s], k0, h, b);
        if (two) tma_load_tile(st + 2 * TE, &tk, &full[s], k0 + 64, h, b);
      }
    }
    return;
  }

  // this thread's rows (the accumulator layout of sm90.cuh) and their
  // statistics for a head; a row past T reads nothing and is not stored
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const size_t bht = (size_t)gridDim.z * H * T;
  auto load_stats = [&](int h, float (&m)[2], float (&linv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      const size_t i = ((size_t)b * H + h) * T + t;
      m[r] = t < T ? stats[i] : 0.0f;
      linv[r] = t < T ? stats[bht + i] : 0.0f;
    }
  };
  float m[2], linv[2], m_next[2], linv_next[2];
  load_stats(0, m, linv);

  // acc0 / sc0: keys k0 .. k0+63; acc1 / sc1: keys k0+64 .. k0+127
  float acc0[32], acc1[32], sc0[32], sc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;

  for (int h = 0; h < H; ++h) {
    const int s = h % HMP_NS;
    mbar_wait(&full[s], (h / HMP_NS) & 1);
    const bf16* st = reinterpret_cast<const bf16*>(smem + s * HmpSmem::STAGE);
    const uint64_t dq = desc_sw128(st), dk0 = desc_sw128(st + TE),
                   dk1 = desc_sw128(st + 2 * TE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc0, desc_kstep(dq, kk), desc_kstep(dk0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc1, desc_kstep(dq, kk), desc_kstep(dk1, kk), kk);
    wg_commit();
    if (h + 1 < H) load_stats(h + 1, m_next, linv_next);
    wg_wait<0>();
    fence_acc(sc0);
    fence_acc(sc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      acc0[i] = fmaf(exp2f((sc0[i] * scale - m[r]) * LOG2E), linv[r], acc0[i]);
      acc1[i] = fmaf(exp2f((sc1[i] * scale - m[r]) * LOG2E), linv[r], acc1[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = m_next[r];
      linv[r] = linv_next[r];
    }
  }

  const float hf = (float)H;
  const int cbase = k0 + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T) continue;
    float* dst = probs + ((size_t)b * T + t) * T;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c0 = cbase + 8 * nb + e, c1 = c0 + 64;
        if (c0 < T) dst[c0] = acc0[4 * nb + 2 * r + e] / hf;
        if (c1 < T) dst[c1] = acc1[4 * nb + 2 * r + e] / hf;
      }
    }
  }
}

// Launch the pass over q, k bf16 (B, H, T, 64) contiguous planes (16-byte
// aligned) and stats (2, B*H*T) fp32 as attention_fwd_sm90 writes them,
// into probs (B, T, T) fp32. Returns 0, the CUDA error of the launch, or a
// tensor-map code of sm90.cuh.
inline int launch_head_mean_probs_sm90(const void* q, const void* k, const float* stats,
                                       float* probs, int B, int H, int T, float scale,
                                       cudaStream_t s) {
  const long long TD = (long long)T * 64, HTD = H * TD;
  CUtensorMap maps[2];
  int err = sm90::make_tile_map(&maps[0], q, B, H, T, HTD, TD, 64);
  if (err != 0) return err;
  err = sm90::make_tile_map(&maps[1], k, B, H, T, HTD, TD, 64);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(head_mean_probs_sm90,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       HmpSmem::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + HMP_KEYS - 1) / HMP_KEYS, (T + 63) / 64, B);
  head_mean_probs_sm90<<<grid, HMP_THREADS, HmpSmem::BYTES, s>>>(maps[0], maps[1], stats,
                                                                 probs, H, T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vitx
