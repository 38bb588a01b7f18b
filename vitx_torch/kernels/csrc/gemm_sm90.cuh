// The LN-prologue GEMM of K1, K2, B7 and B8 on Hopper (sm_90a): wgmma, TMA
// and a ring of stages, bf16.
//
//   out = epilogue(prologue(A) @ W),  A (M, K), W (K, N), both row-major
//
// It replaces the products of vitx/kernels/mha_block.py::_kernel (the QKV
// projection with the LayerNorm in front of it, and the out-projection),
// of mlp_block.py::_kernel (LN -> W1 -> act, then W2), and of B7's and
// B8's kernels, with the rounding points of those kernels: the LN output
// h = cast(((x - mean) * rstd) * g + b) is rounded to bf16 before the
// product (mha_block.py:51-55); products accumulate in fp32; each epilogue
// casts where common.cuh's gemm_kernel casts (EPI_QKV cast(acc),
// EPI_QKV_BIAS cast(acc + bqkv), EPI_BIAS cast(acc + b), EPI_BIAS_ACT pre =
// cast(acc + b1), out = cast(act(pre)) with act in fp32 -- its divisions
// within 2 ulp, act_fast -- pre also written to pre_act when that is not
// null). The statistics mean / rstd come from
// ln_stats_kernel (common.cuh), fp32, one pass over x before the GEMM.
//
// What bounds it on the H100: 2*M*N*K operations against (M*K + K*N +
// M*N) bf16 elements -- at base16 b256 (M = 50432) ~700 operations a
// byte for the QKV projection, beyond the card's ridge of ~295, so the
// tensor cores bound it; the earlier kernel (gemm_kernel, mma.sync fed by
// register-staged ordinary loads) reached 8-10 % of their peak there.
// The design (each choice measured on the H100, PERF.md):
//   - a block tile of 128 x 256 outputs, K in steps of 64; 384 threads:
//     two consumer warpgroups, each owning 64 rows of the tile, and a
//     producer warpgroup (registers are handed out per warpgroup to a
//     kernel on wgmma; setmaxnreg gives the producer's to the consumers,
//     40 / 232; one thread issues the loads). Wide tiles cut the bytes a
//     block reads from L2 per operation (at 128 x 128 the card would need
//     ~15 TB/s of L2 reads to keep its tensor cores busy); 256 columns
//     measured faster than 192;
//   - the producer keeps a ring of G9_NS stages in flight by TMA, each
//     stage two (64 rows x 64 k) boxes of A and four (64 k x 64 n) boxes
//     of W, signalled by a "full" mbarrier per stage and released by an
//     "empty" one; W is read in place, its (64 k, 64 n) box being the
//     MN-major B operand of wgmma (no transposed copy of the weights);
//   - the consumer warpgroup reads its 64 x 16 slices of A out of the
//     swizzled stage into the register A fragment (16-byte chunk c of row r
//     at chunk c ^ (r % 8)), applies the LayerNorm in fp32 (g and b staged
//     in shared memory, zero past K, so the ragged last step adds exactly
//     0; K up to G9_MAX_LN_K; the row statistics and g, b read without a
//     branch: a value the fragments depend on that is defined in a
//     divergent path makes ptxas serialise every wgmma, C7520, which cost
//     the LN GEMMs 2-4x), rounds to bf16, and issues wgmma m64n64k16
//     with A from registers (sm90::wgmma_rs), one per 64-column box: each
//     A fragment serves four independent accumulators. Without LN (the
//     out-projection, W2) the same path runs with the transform off. Two
//     k-steps' products are in flight at a time (wait_group 1, the
//     fragments alternating between two register sets), so the tensor
//     cores have the next step queued while the warpgroup reads and
//     normalises;
//   - the block is persistent: it walks output tiles (n fastest, so the
//     blocks in flight share A's row blocks and all of W in L2) and the
//     producer fills the ring for the next tile while the consumers run
//     the epilogue of this one;
//   - the epilogue stages each warp's 16 rows of a 64-column box in shared
//     memory as cast(acc + bias) and stores 16-byte chunks from there:
//     coalesced rows, and a small loop instead of 128 unrolled activations
//     or index decodes a thread. The EPI_QKV scatter decodes (b, t) per
//     row, as a 128-row tile straddles images, and (q|k|v, head, d) per
//     8-column chunk;
//   - TMA zero-fills rows past M, columns past N and K; a box that lies
//     wholly past M or N is not loaded (its stale products are never
//     stored); the epilogue masks its stores.
// The route (this GEMM or gemm_kernel) is the caller's explicit choice:
// gemm_route refuses a shape or pointer TMA cannot take (ERR_ROUTE).

#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vitx {

constexpr int G9_BM = 128, G9_BN = 256, G9_BK = 64;
constexpr int G9_NB = G9_BN / 64;                  // 64-column boxes of W per stage
constexpr int G9_NS = 4;                           // stages of the ring
// two consumer warpgroups and a producer warpgroup: registers are handed
// out per warpgroup to a kernel on wgmma, so the producer is a whole one
// and gives its registers to the consumers (setmaxnreg)
constexpr int G9_THREADS = 3 * 128;
constexpr int G9_PRODUCER_REGS = 40, G9_CONSUMER_REGS = 232;
// the largest K of an LN GEMM: g and b (fp32) are staged in shared memory
// beside the ring and the epilogue's tiles
constexpr int G9_MAX_LN_K = 4096;
// the epilogue stages each warp's 16 rows x 64 columns in shared memory,
// rows 72 bf16 (144 bytes) apart so the rows of a store fall on
// different banks
constexpr int G9_EP_LD = 72;
constexpr int G9_EP_WARP = 16 * G9_EP_LD;

struct Gemm9Smem {
  static constexpr int A_STAGE = 2 * sm90::TILE_BYTES;         // two (64 rows, 64 k) boxes
  static constexpr int W_STAGE = G9_NB * sm90::TILE_BYTES;     // four (64 k, 64 n) boxes
  static constexpr int A = 0;
  static constexpr int W = A + G9_NS * A_STAGE;
  static constexpr int BAR = W + G9_NS * W_STAGE;              // full[NS], empty[NS]
  static constexpr int EPI = BAR + 16 * G9_NS;                 // 8 warps' (16, 64) bf16
  static constexpr int LN = EPI + 8 * G9_EP_WARP * 2;          // g[kp], b[kp] (fp32)
  // + the base's alignment
  static constexpr int bytes(int kp, bool ln) { return LN + (ln ? 8 * kp : 0) + 1024; }
};

// (x - mean) * rstd * g + b on a pair of bf16 in a register, rounded back
// to a bf16 pair (the low half is the lower column).
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float mean, float rstd, float2 g,
                                            float2 b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return sm90::pack_bf16(((f.x - mean) * rstd) * g.x + b.x, ((f.y - mean) * rstd) * g.y + b.y);
}

// Keep the compiler from reusing an A fragment's registers before the
// products that read them asynchronously have completed.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[k][j])::"memory");
}

// Per-thread constants of the consumer warpgroups: warpgroup wg owns rows
// 64*wg .. +63 of each tile; in it, warp wq and lane l hold rows r0 = 16*wq
// + l/4 and r0 + 8 of the accumulator and of the A fragment (sm90.cuh's
// register layout), columns cq = 2*(l % 4) (+1, +8, +9) of each 16-wide
// slice. rowoff: the byte offset in a swizzled (64, 64) box of row r0's
// first element of column cq; chunk c of that row lies at chunk c ^ sw.
// gs, bs: LN's g and b staged in shared memory, zero past K.
struct FragPos {
  int wg, r0, cq, rowoff, sw;
  const float* gs;
  const float* bs;
};

// The A fragments of k-step kt from ring slot it, once its stage has
// arrived: slice kk's registers {row r0, r0 + 8} x {columns 16kk + cq,
// 16kk + 8 + cq}; with LN each value normalised with its row's mean / rstd
// and its column's g / b (zero past K: the ragged last k-step normalises
// its zero-filled columns to exactly 0), then rounded to bf16.
template <bool LN>
__device__ __forceinline__ void load_frags(uint32_t (&f)[4][4], const unsigned char* As,
                                           uint64_t* full, int it, int kt, const FragPos& p,
                                           const GemmArgs& args, const float (&mean)[2],
                                           const float (&rstd)[2]) {
  using namespace sm90;
  const int s = it % G9_NS;
  mbar_wait(&full[s], (it / G9_NS) & 1);
  const unsigned char* box = As + s * Gemm9Smem::A_STAGE + p.wg * TILE_BYTES;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int o0 = p.rowoff + (((2 * kk) ^ p.sw) << 4);
    const int o1 = p.rowoff + (((2 * kk + 1) ^ p.sw) << 4);
    f[kk][0] = *reinterpret_cast<const uint32_t*>(box + o0);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(box + o0 + 1024);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(box + o1);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(box + o1 + 1024);
    if constexpr (LN) {
      const int k = kt * G9_BK + 16 * kk + p.cq;
      const float2 g0 = *reinterpret_cast<const float2*>(p.gs + k);
      const float2 g1 = *reinterpret_cast<const float2*>(p.gs + k + 8);
      const float2 b0 = *reinterpret_cast<const float2*>(p.bs + k);
      const float2 b1 = *reinterpret_cast<const float2*>(p.bs + k + 8);
      f[kk][0] = ln_pair(f[kk][0], mean[0], rstd[0], g0, b0);
      f[kk][1] = ln_pair(f[kk][1], mean[1], rstd[1], g0, b0);
      f[kk][2] = ln_pair(f[kk][2], mean[0], rstd[0], g1, b1);
      f[kk][3] = ln_pair(f[kk][3], mean[1], rstd[1], g1, b1);
    }
  }
}

// One k-step of a consumer warpgroup: the products of fragments f against
// the nbox W boxes of ring slot it, committed as one group; then the
// previous k-step's group (which read fragments g) is waited for and its
// stage released, and g is refilled with the next k-step's fragments. At
// most two groups are in flight, so the tensor cores have the next
// k-step's products queued while this thread reads and normalises.
template <bool LN>
__device__ __forceinline__ void k_step(float (&acc)[G9_NB][32], uint32_t (&f)[4][4],
                                       uint32_t (&g)[4][4], const unsigned char* As,
                                       const unsigned char* Ws, uint64_t* full, uint64_t* empty,
                                       int it, int kt, int nk, int nbox, const FragPos& p,
                                       int lane, const GemmArgs& args, const float (&mean)[2],
                                       const float (&rstd)[2]) {
  using namespace sm90;
  const unsigned char* w = Ws + (it % G9_NS) * Gemm9Smem::W_STAGE;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nb = 0; nb < G9_NB; ++nb)
      if (nb < nbox) wgmma_rs(acc[nb], f[kk], desc_rows<64>(desc_tile<64>(w + nb * TILE_BYTES), kk));
  }
  wg_commit();
  if (kt > 0) {
    wg_wait<1>();
    fence_frag(g);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % G9_NS]);
  }
  if (kt + 1 < nk) load_frags<LN>(g, As, full, it + 1, kt + 1, p, args, mean, rstd);
}

// common.cuh's apply_act with its divisions as __fdividef (within 2 ulp of
// the IEEE quotient, in fp32, before the bf16 cast; 0 for an infinite
// denominator, as the IEEE one): the IEEE division's slow path is a
// subroutine call, which cost W1's epilogue a fifth of the kernel's time
// on the H100.
__device__ __forceinline__ float act_fast(float x, int act) {
  if (act == ACT_GELU) {
    const float xs = x * 0.7071067811865475f;
    const float a = fabsf(xs);
    const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
    const float poly =
        t * (0.254829592f +
             t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    const float sgn = xs > 0.0f ? 1.0f : (xs < 0.0f ? -1.0f : 0.0f);
    const float erf = sgn * (1.0f - poly * expf(-a * a));
    return 0.5f * x * (1.0f + erf);
  }
  if (act == ACT_GELU_TANH) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    const float t = 1.0f - __fdividef(2.0f, expf(2.0f * u) + 1.0f);
    return 0.5f * x * (1.0f + t);
  }
  return fmaxf(x, 0.0f);
}

// Store 8 staged bf16 of row row, columns col .. col + 7 (col a multiple
// of 8, N a multiple of 8): EPI_BIAS the value cast(acc + b) as staged;
// EPI_BIAS_ACT pre = that value into pre_act (when not null) and
// cast(act(pre)) into out, act in fp32 (act_fast); EPI_QKV(_BIAS) into the (3, B, H,
// T, D) planes, 16 bytes at once when the 8 columns lie in one head (D a
// multiple of 8), element by element otherwise.
template <int EPI>
__device__ __forceinline__ void store_chunk(const GemmArgs& args, const bf16* src, int row,
                                            int col) {
  uint4 v = *reinterpret_cast<const uint4*>(src);
  bf16* out = static_cast<bf16*>(args.out);
  const int N = args.N;
  if constexpr (EPI == EPI_QKV || EPI == EPI_QKV_BIAS) {
    // column n of the (E, 3E) flattening is element (s, h, d) of (3, H, D)
    const int E = N / 3, D = args.D, H = args.H, T = args.T, B = args.M / T;
    const int b = row / T, t = row - b * T;
    if (D % 8 == 0) {
      const int s = col / E, rem = col - s * E, h = rem / D, d = rem - h * D;
      *reinterpret_cast<uint4*>(out + ((((size_t)s * B + b) * H + h) * T + t) * D + d) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int j = 0; j < 8; ++j) {
        const int n = col + j;
        const int s = n / E, rem = n - s * E, h = rem / D, d = rem - h * D;
        out[((((size_t)s * B + b) * H + h) * T + t) * D + d] = e[j];
      }
    }
  } else {
    const size_t at = (size_t)row * N + col;
    if constexpr (EPI == EPI_BIAS_ACT) {
      if (args.pre_act != nullptr)
        *reinterpret_cast<uint4*>(static_cast<bf16*>(args.pre_act) + at) = v;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(act_fast(__bfloat162float(e[j]), args.act));
    }
    *reinterpret_cast<uint4*>(out + at) = v;
  }
}

template <int EPI, bool LN>
__global__ void __launch_bounds__(G9_THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const GemmArgs args) {
  using S = Gemm9Smem;
  using namespace sm90;
  extern __shared__ unsigned char g9_smem_raw[];
  unsigned char* smem = align_1024(g9_smem_raw);
  unsigned char* As = smem + S::A;
  unsigned char* Ws = smem + S::W;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + G9_NS;

  const int M = args.M, N = args.N, K = args.K;
  const int nk = (K + G9_BK - 1) / G9_BK;
  const int kp = nk * G9_BK;
  float* gs = reinterpret_cast<float*>(smem + S::LN);
  float* bs = gs + kp;
  const int tiles_n = (N + G9_BN - 1) / G9_BN;
  const int ntiles = ((M + G9_BM - 1) / G9_BM) * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G9_NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // the consumer warps
    }
    mbar_init_fence();
  }
  if constexpr (LN) {
    // branch-free (clamped reads, selects): a value the A fragments depend
    // on that is defined in a divergent path makes ptxas serialise every
    // wgmma of the function (C7520; one wait per wgmma in the SASS, and
    // the LN GEMMs 2-4x slower on the H100)
    for (int k = threadIdx.x; k < kp; k += G9_THREADS) {
      const int kc = min(k, K - 1);
      const float gv = args.ln_g[kc], bv = args.ln_b[kc];
      gs[k] = k < K ? gv : 0.0f;
      bs[k] = k < K ? bv : 0.0f;
    }
  }
  __syncthreads();

  if (warp >= 8) {   // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G9_PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * G9_BM, n0 = (tile % tiles_n) * G9_BN;
        const bool a1 = m0 + 64 < M;
        const int nbox = min(G9_NB, (N - n0 + 63) / 64);
        const uint32_t bytes = (1 + (int)a1 + nbox) * TILE_BYTES;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % G9_NS;
          if (it >= G9_NS) mbar_wait(&empty[s], (it / G9_NS - 1) & 1);
          unsigned char* a = As + s * S::A_STAGE;
          unsigned char* w = Ws + s * S::W_STAGE;
          mbar_arrive_expect_tx(&full[s], bytes);
          tma_load_2d(a, &ta, &full[s], kt * G9_BK, m0);
          if (a1) tma_load_2d(a + TILE_BYTES, &ta, &full[s], kt * G9_BK, m0 + 64);
          for (int nb = 0; nb < nbox; ++nb)
            tma_load_2d(w + nb * TILE_BYTES, &tw, &full[s], n0 + 64 * nb, kt * G9_BK);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G9_CONSUMER_REGS));
  FragPos p;
  p.wg = warp >> 2;
  p.r0 = 16 * (warp & 3) + (lane >> 2);
  p.cq = 2 * (lane & 3);
  p.rowoff = p.r0 * 128 + 2 * p.cq;
  p.sw = p.r0 & 7;
  p.gs = gs;
  p.bs = bs;

  float acc[G9_NB][32];
  uint32_t fa[4][4], fb[4][4];
  float mean[2] = {0.0f, 0.0f}, rstd[2] = {0.0f, 0.0f};

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * G9_BM, n0 = (tile % tiles_n) * G9_BN;
    const int nbox = min(G9_NB, (N - n0 + 63) / 64);
    const int row0 = m0 + 64 * p.wg + p.r0;
    if constexpr (LN) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        // rows past M arrive as zeros and are never stored: they take the
        // last row's statistics (a clamped read, no branch, as above)
        const int row = min(row0 + 8 * hi, M - 1);
        mean[hi] = args.ln_stats[row];
        rstd[hi] = args.ln_stats[M + row];
      }
    }
#pragma unroll
    for (int nb = 0; nb < G9_NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;

    // k-steps in pairs, the fragments alternating between fa and fb
    load_frags<LN>(fa, As, full, it, 0, p, args, mean, rstd);
    for (int kt = 0; kt < nk; kt += 2) {
      k_step<LN>(acc, fa, fb, As, Ws, full, empty, it, kt, nk, nbox, p, lane, args, mean, rstd);
      ++it;
      if (kt + 1 < nk) {
        k_step<LN>(acc, fb, fa, As, Ws, full, empty, it, kt + 1, nk, nbox, p, lane, args, mean,
                   rstd);
        ++it;
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int nb = 0; nb < G9_NB; ++nb) fence_acc(acc[nb]);
    fence_frag(fa);
    fence_frag(fb);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % G9_NS]);

    // the epilogue, one 64-column box at a time: the warp stages its 16
    // rows, cast(acc + bias) -- d[4q + 2hi + c] is local row l/4 + 8hi,
    // column 8q + cq + c -- then stores 16-byte chunks of 8 columns
    bf16* ep = reinterpret_cast<bf16*>(smem + S::EPI) + warp * G9_EP_WARP;
    const int wrow0 = m0 + 64 * p.wg + 16 * (warp & 3);
#pragma unroll
    for (int nb = 0; nb < G9_NB; ++nb) {
      if (nb >= nbox) break;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int cl = 8 * q + p.cq;
        const int col = n0 + 64 * nb + cl;
        float bias0 = 0.0f, bias1 = 0.0f;
        if constexpr (EPI != EPI_QKV) {
          if (col < N) {
            bias0 = __ldg(args.bias + col);
            bias1 = __ldg(args.bias + col + 1);
          }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<__nv_bfloat162*>(ep + ((lane >> 2) + 8 * hi) * G9_EP_LD + cl) =
              __floats2bfloat162_rn(acc[nb][4 * q + 2 * hi] + bias0,
                                    acc[nb][4 * q + 2 * hi + 1] + bias1);
      }
      __syncwarp();
#pragma unroll 1
      for (int i = lane; i < 16 * 8; i += 32) {
        const int rl = i >> 3, c8 = 8 * (i & 7);
        const int row = wrow0 + rl, col = n0 + 64 * nb + c8;
        if (row < M && col < N) store_chunk<EPI>(args, ep + rl * G9_EP_LD + c8, row, col);
      }
      __syncwarp();
    }
  }
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Whether this GEMM can take (M, K) x (K, N) at pointers a and w: K and N
// multiples of 8 (16-byte rows, what TMA addresses), both operands 16-byte
// aligned, and with the LN prologue (ln) K at most G9_MAX_LN_K.
inline bool gemm_sm90_ok(const void* a, const void* w, int K, int N, bool ln) {
  return K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && (!ln || K <= G9_MAX_LN_K);
}

template <int EPI, bool LN>
inline int launch_gemm_sm90(const GemmArgs& args, cudaStream_t s) {
  if (!gemm_sm90_ok(args.a, args.w, args.K, args.N, LN)) return sm90::ERR_ROUTE;
  CUtensorMap ta, tw;
  int err = sm90::make_matrix_map(&ta, args.a, args.M, args.K);
  if (err != 0) return err;
  err = sm90::make_matrix_map(&tw, args.w, args.K, args.N);
  if (err != 0) return err;
  const int bytes = Gemm9Smem::bytes((args.K + G9_BK - 1) / G9_BK * G9_BK, LN);
  auto kern = gemm_sm90_kernel<EPI, LN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = ((args.M + G9_BM - 1) / G9_BM) * ((args.N + G9_BN - 1) / G9_BN);
  const int grid = ntiles < num_sms() ? ntiles : num_sms();
  kern<<<grid, G9_THREADS, bytes, s>>>(ta, tw, args);
  return static_cast<int>(cudaGetLastError());
}

// The product on the route the caller chose: use90 = this GEMM (bf16
// only), else gemm_kernel (common.cuh: fp32, and bf16 shapes TMA cannot
// take).
template <typename T, int EPI, bool LN>
inline int gemm_route(const GemmArgs& args, bool use90, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (use90) return launch_gemm_sm90<EPI, LN>(args, s);
  } else {
    if (use90) return sm90::ERR_ROUTE;
  }
  return static_cast<int>(launch_gemm<T, EPI, LN>(args, s));
}

}  // namespace vitx
