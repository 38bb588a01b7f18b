// The attention forward on Hopper (sm_90a): wgmma, TMA and an online
// softmax, bf16 at head widths 32, 64 and 128. One body, five callers: B5
// (flash_attention_sm90.cu; in its probability modes followed by
// attention_probs_sm90.cuh, which reads the row statistics), K1's
// attention, B7's (followed by the same pass's head mean) and, with the
// KBIAS flag, B8's (mha_block.cu); each source builds its own copies.
//
// Over q, k, v (B, H, T, D) bf16 views, q unscaled -> o (b, h, t, d) at
// b*o_sb + h*o_sh + t*o_st + d (B5: (B, H, T, D); K1: straight into
// o_all (B, T, E)) and, for the backward, the row statistics stats (2, B,
// H, T) fp32: the row max m of the logits and linv = 1 / l, what
// attention_bwd_sm90.cu reads.
//
// The function, per (b, h) and query row, over 64-key tiles j:
//   s_j = qs k_j^T (fp32), qs = cast(q * scale)
//   m_j = max(m_{j-1}, rowmax(s_j)), alpha = exp(m_{j-1} - m_j)
//   p_j = exp(s_j - m_j), l = l * alpha + rowsum(p_j)        (fp32)
//   acc = acc * alpha + cast(p_j) v_j                         (fp32)
//   o = cast(acc / l), the division after the product as in vitx.
// At D = 64 the scale is 2^-3, so cast(q * scale) is q * scale exactly and
// s = scale * (q k^T) exactly up to the order of the fp32 sum: the tile is
// used as it arrives. At D = 32 and 128 the scale (2^-2.5, 2^-3.5, as
// the fp32 of 1 / sqrt(D) that vitx uses) is no power of two: the
// consumers round qs = cast(q * scale) into the q tile, in place, once,
// before the first product, and the logits are the product itself. One
// rounding point moves against vitx
// (flash_attention.py:102-157, mha_block.py:74-84): p is cast to bf16
// after exp(s - m_j), the running max, rather than exp(s - m), the final
// one; the two differ only where m_j < m, by the rescale of an
// already-rounded value (an ulp of bf16 at most, then weighted by alpha <
// 1). Keys past T are masked to -inf in the kernel: TMA fills them with
// zeros, which are logits of 0.
// KBIAS (B8, ToMe's proportional attention, vitx/kernels/mha_block.py:
// 529-536): an fp32 bias per key, key_bias (B, T), joins each logit after
// the scale and before the max: s = scale * (q k^T) + kb[key], the order of
// vitx's cast(q * scale) k^T + log_size. B8 then shares K1's moved
// rounding point above. A (B, T) fp32 row is 4T bytes, a multiple of 16
// only where T % 4 == 0 (not at 197, 54, 577), so TMA cannot load it: each
// consumer thread reads its 16 keys of a tile from device memory (the
// whole bias is B*T*4 bytes, ~200 KB at b256, and stays in L2) a tile
// ahead, so their latency hides under the softmax and p v of the tile
// before rather than under the tile's own s = q k^T alone (PERF.md), each
// load guarded by key < T so that no read falls past row b. Without
// KBIAS (K1, B5) the code is as before.
//
// The layout (measured on the H100, PERF.md):
//   - one block per (b*h, 64 queries): one consumer warpgroup and one
//     producer warp, under 128 registers a thread at D 64, so three blocks
//     share an SM and one block's softmax runs while another's products do
//     (faster than two consumer warpgroups a block, and than issuing
//     tile j's s before tile j-1's p v inside a warpgroup);
//   - the producer loads the q tile once, then keeps the k and v tiles of a
//     two-stage ring in flight by TMA, signalling an mbarrier per stage;
//   - the consumer warpgroup runs s = q k^T as D/16 wgmma m64n64k16 from
//     shared memory, keeps s, the running max and sum and the o
//     accumulator in registers, turns p into the bf16 A operand of the
//     p v wgmma (m64nDk16) without a shared-memory round trip, and
//     releases the stage.
// Per width (sm90.cuh's Tile<D>):
//   - D 128: a tile is two 128-byte-swizzled boxes; s takes 8 k16 steps
//     across both, and p v is one m64n128k16 a key slice whose B operand
//     (v, MN-major) spans both boxes. The o accumulator is 64 floats a
//     thread beside s's 32, so the kernel is held to two blocks an SM
//     (__launch_bounds__; ptxas reports 138 registers, 161 with KBIAS),
//     which is also what the shared memory holds (q 16 KB and a two-stage
//     k/v ring of 64 KB).
//   - D 32: one 64-byte-swizzled box a tile, 2 k16 steps for s and an
//     m64n32k16 p v; 20 KB of shared memory and 96 registers a thread, so
//     four blocks share an SM. The exps and the fp32 softmax bound it
//     there: as many logits as at D 64 for half the products.

#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vitx {

constexpr int FWD_NS = 2;   // stages of the k/v ring
constexpr int FWD_THREADS = 128 + 32;   // a consumer warpgroup and a producer warp

struct FwdArgs {
  bf16* o;                  // (b, h, t, d) at b*o_sb + h*o_sh + t*o_st + d
  long long o_sb, o_sh, o_st;
  float* stats;             // null, or (2, B*H*T): m | 1/l
  int H, T;
  float scale;
  const float* key_bias;    // KBIAS: (B, T) fp32, added to the logits over the keys
                            // (last, so the fields before keep their offsets)
};

template <int D, int NS> struct FwdSmem {
  static constexpr int TB = sm90::Tile<D>::BYTES;
  static constexpr int Q = 0;                                  // a tile
  static constexpr int K = Q + TB;                             // NS tiles
  static constexpr int V = K + NS * TB;                        // NS tiles
  static constexpr int BAR = V + NS * TB;                      // q, full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;  // + the base's alignment
};

// (launch bounds: at D 128 the registers are held to two blocks an SM, for
// the o accumulator's sake)
template <int D, int NS, bool KBIAS>
__global__ void __launch_bounds__(FWD_THREADS, D == 128 ? 2 : 1)
attention_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using S = FwdSmem<D, NS>;
  using G = sm90::Tile<D>;
  using namespace sm90;
  constexpr bool QS = D != 64;   // qs rounded into the q tile before the first product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  unsigned char* Qs = smem + S::Q;
  unsigned char* Ks = smem + S::K;
  unsigned char* Vs = smem + S::V;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  const int T = a.T, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * 64;
  const int nkt = (T + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, G::BYTES);
      tma_load_tile_d<D>(Qs, &tq, qbar, q0, h, b);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], (j / NS - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * G::BYTES);
        tma_load_tile_d<D>(Ks + s * G::BYTES, &tk, &full[s], 64 * j, h, b);
        tma_load_tile_d<D>(Vs + s * G::BYTES, &tv, &full[s], 64 * j, h, b);
      }
    }
    return;
  }

  mbar_wait(qbar, 0);
  if constexpr (QS) {   // qs = cast(q * scale), vitx's rounding, in place
    const float qscale = a.scale;
    scale_rows<D, true>(Qs, Qs, 0, 64, [qscale](int) { return qscale; }, threadIdx.x, 128);
    fence_proxy_async();
    named_bar(1, 128);
  }
  const uint64_t dq = desc_tile<D>(Qs);

  float o[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  const int cbase = 2 * (lane & 3);

  // KBIAS: this thread's 16 key biases of tile jt, kb[n] for the keys 8n +
  // cbase and 8n + cbase + 1, loaded a tile ahead (under the softmax and
  // the p v product of the tile before); keys past T are not read
  float kb[KBIAS ? 16 : 1];
  const float* kb_row = KBIAS ? a.key_bias + (size_t)b * T : nullptr;
  auto load_kb = [&](int jt) {
    if constexpr (KBIAS) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = 64 * jt + 8 * (n >> 1) + cbase + (n & 1);
        kb[n] = col < T ? kb_row[col] : 0.0f;
      }
    }
  };
  load_kb(0);

  for (int j = 0; j < nkt; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    const uint64_t dk = desc_tile<D>(Ks + s * G::BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss(sc, desc_k<D>(dq, kk), desc_k<D>(dk, kk), kk);
    wg_commit();
    wg_wait<0>();
    fence_acc(sc);

    // the fp32 logits (plus the key bias), keys past T at -inf; the new
    // running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 64 * j + 8 * (i >> 2) + cbase + (i & 1);
      // the logit: the product itself (QS), or it times the scale (D 64)
      const float lg = QS ? sc[i] : sc[i] * a.scale;
      if constexpr (KBIAS)
        sc[i] = col < T ? __fadd_rn(lg, kb[2 * (i >> 2) + (i & 1)]) : -CUDART_INF_F;
      else
        sc[i] = col < T ? lg : -CUDART_INF_F;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    if (j + 1 < nkt) load_kb(j + 1);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);   // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f((sc[i] - m[r]) * LOG2E);
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[4][4];
    acc_to_a(sc, pa);

    const uint64_t dv = desc_tile<D>(Vs + s * G::BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], desc_rows<D>(dv, kk));
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T) continue;
    bf16* dst = a.o + b * a.o_sb + h * a.o_sh + (long long)t * a.o_st;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const float v0 = o[4 * nb + 2 * r] / l[r], v1 = o[4 * nb + 2 * r + 1] / l[r];
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb + cbase) = __floats2bfloat162_rn(v0, v1);
    }
    if (a.stats != nullptr && (lane & 3) == 0) {
      const size_t n = (size_t)gridDim.y * T, i = (size_t)bh * T + t;
      a.stats[i] = m[r];
      a.stats[n + i] = 1.0f / l[r];
    }
  }
}

template <int D, bool KBIAS>
int launch_attention_fwd_sm90_d(const void* const qkv[3], const long long* strides,
                                const FwdArgs& a, int B, cudaStream_t s) {
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int err = sm90::make_tile_map<D>(&maps[i], qkv[i], B, a.H, a.T, strides[3 * i],
                                           strides[3 * i + 1], strides[3 * i + 2]);
    if (err != 0) return err;
  }
  using Sm = FwdSmem<D, FWD_NS>;
  auto kern = attention_fwd_sm90<D, FWD_NS, KBIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + 63) / 64, B * a.H);
  kern<<<grid, FWD_THREADS, Sm::BYTES, s>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

// Launch the body over q, k, v bf16 (B, H, T, D) views at qkv[0..2], D 32,
// 64 or 128, element strides strides[3*i .. 3*i+2] = (sb, sh, st) of view
// i, each a multiple of 8, the last dim contiguous, pointers 16-byte
// aligned; a.o, its strides, a.stats, a.scale (sm90::attention_scale(D)) and
// (KBIAS) a.key_bias as FwdArgs says. Returns 0, the CUDA error of the
// launch, a tensor-map code of sm90.cuh, or ERR_ROUTE for another D.
template <bool KBIAS>
int launch_attention_fwd_sm90(const void* const qkv[3], const long long* strides,
                              const FwdArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch_attention_fwd_sm90_d<32, KBIAS>(qkv, strides, a, B, s);
    case 64: return launch_attention_fwd_sm90_d<64, KBIAS>(qkv, strides, a, B, s);
    case 128: return launch_attention_fwd_sm90_d<128, KBIAS>(qkv, strides, a, B, s);
    default: return sm90::ERR_ROUTE;
  }
}

}  // namespace vitx
