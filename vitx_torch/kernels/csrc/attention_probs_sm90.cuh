// The attention probabilities on Hopper (sm_90a), bf16 at head widths 32,
// 64 and 128: the pass after B5's sm90 body (attention_fwd_sm90.cuh) has
// written each row's statistics, in two forms, the template's MEAN:
//   - MEAN = true, the head mean: B7's caller (mha_block.cu, entry
//     vitx_mha_block_mean_probs) and B5's head-mean mode
//     (flash_attention_sm90.cu, entry vitx_attention_fwd_probs_sm90) run
//     it. It replaces the PROBS_MEAN mode of attention_fwd.cuh on the sm90
//     route: the probabilities half of vitx/kernels/mha_block.py::
//     _kernel_hchunk (mha_block.py:174, its pallas_call at :298 through
//     _chunked_fwd) and of vitx/kernels/flash_attention.py::_fwd_kernel
//     (line 132, its pallas_call at :206) with mean_probs;
//   - MEAN = false, every head's probabilities: B5's full mode (the same
//     entry), which replaces attention_fwd.cuh's PROBS_FULL mode, i.e.
//     _fwd_kernel's probs output.
//
// Over the unscaled q and k planes (B, H, T, D) bf16 (the QKV GEMM's, or
// B5's own inputs) and the statistics stats (2, B*H*T) fp32 -- m, the row
// max of the logits, then linv = 1 / l -- that the body wrote for the same
// q and k:
//   MEAN:  probs[b, t, u] = (sum over h, in order, of exp(s_h[t, u] -
//          m_h[t]) * linv_h[t]) / H                          (B, T, T) fp32
//   full:  probs[b, h, t, u] = exp(s_h[t, u] - m_h[t]) * linv_h[t]
//                                                         (B, H, T, T) fp32
// with s_h = qs_h k_h^T in fp32, qs = cast(q * scale), the body's logits;
// every element written once.
//
// Rounding points against vitx (mha_block.py:206-218, flash_attention.py:
// 142-157), which takes m from the whole row and divides p by l (and by
// l * H for the mean):
//   - m and l come from the body's online softmax: l is summed over 64-key
//     tiles and rescaled by exp(m_old - m_new) as the running max moves;
//   - p is exp(s - m) times linv (one fused multiply-add into the head
//     sum; in the full mode a multiply, the fma's addend 0), not a division
//     by l; the head sum is divided by H once, at the end;
//   - s is the body's, bit for bit: the same m64n64k16 products over the
//     same swizzled tiles, from the same qs. At D 64 the scale is 2^-3, so
//     qs is q * scale exactly and s is the wgmma's fp32 sum of q k^T times
//     the scale, the tile used as it arrives. At D 32 and 128 (2^-2.5,
//     2^-3.5, the fp32 of 1 / sqrt(D) that vitx uses) the body rounds qs =
//     cast(q * scale) into its q tile before its first product, and so does
//     the pass: in place in each stage's q tile, once per head, then
//     fence.proxy.async and the consumers' barrier before the wgmma reads
//     it. A pass that scaled the fp32 product instead would form other
//     logits than the m and l it reads, and exp(s - m) could pass 1;
//   - exp is exp2f((s - m) * log2 e), as in the body.
// Each moves a probability by a few fp32 ulps; rows still sum to 1 within
// 1e-5 (PERF.md). The full mode's head mean, summed in head order and
// divided by H, is the mean mode's value within an fp32 rounding of each
// product (the fma).
//
// What bounds it on the H100: in the mean mode per call at (32, 577, 16
// heads of 64), 170 M exponentials (the SFU: ~0.05 ms), 21.8 GFLOP of
// q k^T (~0.02 ms) and the 42.6 MB written (~0.013 ms); q and k (38 MB)
// stay in L2 and are re-read once per key tile and query tile. At huge14's
// (8, 257, 10 heads of 128) the same kinds of work, 5.3 M exponentials,
// 1.4 GFLOP and 2.1 MB written, are small enough that the launch and the
// tail of the grid count. The full mode writes H times more for the same
// work: at (2, 16, 577) the 42.6 MB of probabilities are its bound (~0.013
// ms). attention_fwd.cuh's modes instead made three passes over the keys
// per head, q k^T each time, without wgmma or TMA, and its mean mode ran
// one block per (image, 64 queries) over the heads in series with a
// read-modify-write of the output in device memory per head. The design:
//   - one block per (image, 64 queries, 128 keys) in the mean mode: 1600
//     blocks at (32, 577); per (image * head, 64 queries, 128 keys) in the
//     full mode: 1600 at (2, 16, 577). One consumer warpgroup and one
//     producer warp, two blocks an SM;
//   - the producer keeps each head's q tile and two 64-key k tiles
//     (sm90.cuh's Tile<D>: one box at D 32 and 64, two at 128) in a ring of
//     NS stages by TMA (the full mode: one stage, one head), signalling an
//     mbarrier per stage (a k tile wholly past T is not loaded: its columns
//     are never stored);
//   - the consumer warpgroup loops over the heads in order: at D != 64 it
//     first rounds the stage's q tile to qs (64 x D bf16, D/16 16-byte
//     chunks a thread); then s = q k^T as 2 x D/16 wgmma m64n64k16 from
//     shared memory, the stage released, then exp, linv and the head sum in
//     fp32 registers (64 floats a thread, at every D); the next head's
//     statistics are loaded under the products;
//   - the mean mode divides the sum by H after the last head and stores
//     each element once with a 4-byte store from the accumulator layout;
//     the full mode stages each warp's 16 rows x 128 keys through shared
//     memory (8-byte writes, a row pitch of 136 floats: no bank conflicts)
//     and writes row-contiguous runs, 32 consecutive floats a warp store.
//     Rows and columns past T are skipped. An output row is 4T bytes, not a
//     multiple of 16 at T 577, so no TMA store.
// Stages and occupancy per width (ApSmem; 228 KB of shared memory an SM,
// two blocks an SM by __launch_bounds__, which caps a thread at 200
// registers): a
// stage is q and two k tiles, 3 * 64 * D * 2 bytes -- 12 KB at D 32, 24 KB
// at 64, 48 KB at 128. The mean mode keeps three stages at D 32 and 64
// (37 KB and 73 KB a block) and two at D 128 (97 KB; three would be 145
// KB, one block an SM); the full mode one stage and its 34 KB staging
// area (47 KB, 59 KB and 83 KB a block; KB here 1024 bytes). Every width holds two blocks an
// SM. The accumulators do not grow with D, so neither do the registers
// (the build phase prints ptxas's count per instantiation).
// The order over the heads is fixed and there are no atomics: the same
// bits from call to call.

#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vitx {

constexpr int AP_KEYS = 128;              // keys a block: two 64-key tiles
constexpr int AP_THREADS = 128 + 32;      // a consumer warpgroup and a producer warp

template <int D, bool MEAN> struct ApSmem {
  static constexpr int TB = sm90::Tile<D>::BYTES;                // a (64, D) tile
  static constexpr int NS = MEAN ? (D == 128 ? 2 : 3) : 1;      // stages of the q/k ring
  static constexpr int STAGE = 3 * TB;                          // q, k keys 0-63, k keys 64-127
  static constexpr int PITCH = AP_KEYS + 8;                     // floats a staged output row
  static constexpr int OUT = NS * STAGE;                        // full: (64, PITCH) fp32
  static constexpr int BAR = OUT + (MEAN ? 0 : 64 * PITCH * 4); // full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * 2 * NS + 1024;         // + the base's alignment
};

template <int D, bool MEAN>
__global__ void __launch_bounds__(AP_THREADS, 2)
attention_probs_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, const float* __restrict__ stats,
                     float* __restrict__ probs, int H, int T, float scale) {
  using namespace sm90;
  using S = ApSmem<D, MEAN>;
  using G = Tile<D>;
  constexpr int NS = S::NS;
  constexpr bool QS = D != 64;   // qs rounded into the q tile before the products
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + NS;

  // the mean mode: z = b, the heads 0 .. H-1 in order; the full mode:
  // z = b * H + h, that head alone
  const int k0 = blockIdx.x * AP_KEYS, q0 = blockIdx.y * 64, z = blockIdx.z;
  const int b = MEAN ? z : z / H, h0 = MEAN ? 0 : z - b * H, nh = MEAN ? H : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane == 0) {
      const bool two = k0 + 64 < T;   // the second k tile holds keys below T
      for (int i = 0; i < nh; ++i) {
        const int s = i % NS, h = h0 + i;
        if (i >= NS) mbar_wait(&empty[s], (i / NS - 1) & 1);
        unsigned char* st = smem + s * S::STAGE;
        mbar_arrive_expect_tx(&full[s], (two ? 3 : 2) * G::BYTES);
        tma_load_tile_d<D>(st, &tq, &full[s], q0, h, b);
        tma_load_tile_d<D>(st + G::BYTES, &tk, &full[s], k0, h, b);
        if (two) tma_load_tile_d<D>(st + 2 * G::BYTES, &tk, &full[s], k0 + 64, h, b);
      }
    }
    return;
  }

  // this thread's rows (the accumulator layout of sm90.cuh) and their
  // statistics for a head; a row past T reads nothing and is not stored
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const size_t bht = (size_t)gridDim.z * (MEAN ? H : 1) * T;
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
  load_stats(h0, m, linv);

  // acc0 / sc0: keys k0 .. k0+63; acc1 / sc1: keys k0+64 .. k0+127
  float acc0[32], acc1[32], sc0[32], sc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;

  for (int i = 0; i < nh; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    unsigned char* st = smem + s * S::STAGE;
    if constexpr (QS) {   // qs = cast(q * scale), the body's rounding, in place
      scale_rows<D, true>(st, st, 0, 64, [scale](int) { return scale; }, threadIdx.x, 128);
      fence_proxy_async();
      named_bar(1, 128);
    }
    const uint64_t dq = desc_tile<D>(st), dk0 = desc_tile<D>(st + G::BYTES),
                   dk1 = desc_tile<D>(st + 2 * G::BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss(sc0, desc_k<D>(dq, kk), desc_k<D>(dk0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss(sc1, desc_k<D>(dq, kk), desc_k<D>(dk1, kk), kk);
    wg_commit();
    if (i + 1 < nh) load_stats(h0 + i + 1, m_next, linv_next);
    wg_wait<0>();
    fence_acc(sc0);
    fence_acc(sc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);

    // the logits: the product itself (QS), or it times the scale (D 64)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const float s0 = QS ? sc0[j] : sc0[j] * scale, s1 = QS ? sc1[j] : sc1[j] * scale;
      acc0[j] = fmaf(exp2f((s0 - m[r]) * LOG2E), linv[r], acc0[j]);
      acc1[j] = fmaf(exp2f((s1 - m[r]) * LOG2E), linv[r], acc1[j]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = m_next[r];
      linv[r] = linv_next[r];
    }
  }

  const int cbase = k0 + 2 * (lane & 3);
  if constexpr (MEAN) {
    const float hf = (float)H;
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
  } else {
    // this warp's 16 rows through its own part of the staging area, then
    // each row out as runs of 32 consecutive floats
    float* stage = reinterpret_cast<float*>(smem + S::OUT) + warp * 16 * S::PITCH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* srow = stage + ((lane >> 2) + 8 * r) * S::PITCH + 2 * (lane & 3);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        *reinterpret_cast<float2*>(srow + 8 * nb) =
            make_float2(acc0[4 * nb + 2 * r], acc0[4 * nb + 2 * r + 1]);
        *reinterpret_cast<float2*>(srow + 64 + 8 * nb) =
            make_float2(acc1[4 * nb + 2 * r], acc1[4 * nb + 2 * r + 1]);
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int t = q0 + 16 * warp + rr;
      if (t >= T) break;
      float* dst = probs + ((size_t)z * T + t) * T + k0;
      const float* src = stage + rr * S::PITCH;
#pragma unroll
      for (int c = lane; c < AP_KEYS; c += 32)
        if (k0 + c < T) dst[c] = src[c];
    }
  }
}

template <int D, bool MEAN>
int launch_attention_probs_sm90_d(const void* q, const void* k, const float* stats, float* probs,
                                  int B, int H, int T, float scale, cudaStream_t s) {
  const long long TD = (long long)T * D, HTD = H * TD;
  CUtensorMap maps[2];
  int err = sm90::make_tile_map<D>(&maps[0], q, B, H, T, HTD, TD, D);
  if (err != 0) return err;
  err = sm90::make_tile_map<D>(&maps[1], k, B, H, T, HTD, TD, D);
  if (err != 0) return err;
  using Sm = ApSmem<D, MEAN>;
  auto kern = attention_probs_sm90<D, MEAN>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + AP_KEYS - 1) / AP_KEYS, (T + 63) / 64, MEAN ? B : B * H);
  kern<<<grid, AP_THREADS, Sm::BYTES, s>>>(maps[0], maps[1], stats, probs, H, T, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch the pass over q, k bf16 (B, H, T, D) contiguous planes (16-byte
// aligned), D 32, 64 or 128, and stats (2, B*H*T) fp32 as attention_fwd_sm90
// writes them, into probs: (B, T, T) fp32 for MEAN, else (B, H, T, T) fp32
// (B * H at most 65535, the grid's z); scale is sm90::attention_scale(D).
// Returns 0, the CUDA error of the launch, a tensor-map code of sm90.cuh,
// or ERR_ROUTE for another D.
template <bool MEAN>
int launch_attention_probs_sm90(const void* q, const void* k, const float* stats, float* probs,
                                int B, int H, int T, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_attention_probs_sm90_d<32, MEAN>(q, k, stats, probs, B, H, T, scale, s);
    case 64: return launch_attention_probs_sm90_d<64, MEAN>(q, k, stats, probs, B, H, T, scale, s);
    case 128:
      return launch_attention_probs_sm90_d<128, MEAN>(q, k, stats, probs, B, H, T, scale, s);
    default: return sm90::ERR_ROUTE;
  }
}

}  // namespace vitx
