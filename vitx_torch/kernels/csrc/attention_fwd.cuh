// The attention forward shared by K1/B7/B8 (mha_block.cu) and B5
// (flash_attention_fwd.cu): per (image, head, 64 queries), over unscaled
// q, k, v planes of (B*H, T, D),
//   qs = cast(cast(q) * scale)                 (stage_rows_scaled)
//   s = qs k^T (fp32), m = rowmax(s)
//   p = exp(s - m), l = rowsum(p)              (both fp32)
//   o = (cast(p) v) / l, then cast             (the division after the product)
// and, with probabilities asked for,
//   PROBS_FULL: probs[b, h] = p / l            (B, H, T, T) fp32
//   PROBS_MEAN: probs[b] = (sum_h p_h / l_h) / H  (B, T, T) fp32
// -- the rounding points of vitx/kernels/flash_attention.py:102-157 and of
// vitx/kernels/mha_block.py:74-84 (the mean: the kernel takes B5's form
// sum(p/l)/H, where mha_block.py:217 sums p/(l*H); the two differ in fp32
// ulps).
//
// One block of 4 warps owns 64 query rows (a warp 16 of them). Key/value
// chunks of 64 rows are staged in shared memory, and each pass over them
// recomputes s:
//   pass 1: m;   pass 2: l and o;   pass 3 (probs only): p / l.
// l is known only after the whole key row, so the probabilities cost a
// third q k^T instead of a (64, T) fp32 row block in shared memory (148 KB
// at T = 577, too large at T = 1024): any T runs, the ragged key tail is
// masked in the kernel (no padding) and T > 1024 needs nothing more.
// With a.stats (K1 under grad), each row's m and 1 / l are written after
// pass 2 for the backward.
// KBIAS (B8, ToMe's proportional attention): an fp32 bias per key,
// key_bias (B, T), is added to the fp32 logits before the max, in every
// pass that recomputes s (vitx/kernels/mha_block.py:535); each block stages
// it with its 64-key chunk. Without it (K1, B5, B7) the code is as before.
//
// PROBS_MEAN: a block owns (image, 64 queries) and loops over the heads in
// order, adding each head's p / l to its own rows of the output in device
// memory (the same thread reads and writes an element at every head), so
// the head sum has one fixed order and no atomics: the result is the same
// bit for bit from call to call. Its parallelism is B * ceil(T / 64)
// blocks (10 per image at T = 577) against 132 SMs.

#pragma once

#include "common.cuh"

namespace vitx {

enum ProbsMode { PROBS_NONE = 0, PROBS_FULL = 1, PROBS_MEAN = 2 };

constexpr int AQ = 64;    // queries per block (4 warps x 16 rows)
constexpr int AKC = 64;   // keys per staged chunk
constexpr int ANT = 128;

template <typename T, int DP> struct AttnSmem {
  static constexpr int LD = DP + 16 / (int)sizeof(T);
  static constexpr int LDP = 16 + 16 / (int)sizeof(T);
  static constexpr int Q_BYTES = align_up(AQ * LD * (int)sizeof(T), 128);
  static constexpr int KV_BYTES = align_up(AKC * LD * (int)sizeof(T), 128);
  static constexpr int S_BYTES = 4 * 16 * CS_LD * 4;
  static constexpr int P_BYTES = align_up(4 * 16 * LDP * (int)sizeof(T), 128);
  static constexpr int BYTES = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES;
};

struct AttnArgs {
  const void* q;        // (B*H, T, D) planes, q unscaled
  const void* k;
  const void* v;
  void* o;              // element (b, h, t, d) at b*o_sb + h*o_sh + t*o_st + d
  long long o_sb, o_sh, o_st;
  float* probs;         // PROBS_FULL (B, H, T, T), PROBS_MEAN (B, T, T) fp32
  const float* key_bias;  // KBIAS: (B, T) fp32, added to the logits over the keys
  float* stats;         // null, or (2, B*H*T) fp32: each row's m | 1/l, what the
                        // backward of attention_bwd_sm90.cu reads (PROBS_NONE)
  int B, H, T, D;
  float q_scale;
};

template <typename T, int DP, int MODE, bool KBIAS>
__global__ void __launch_bounds__(ANT)
attention_kernel(const AttnArgs a) {
  using S = AttnSmem<T, DP>;
  using M_ = Mma<T>;
  constexpr int ND = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + S::Q_BYTES);
  T* Vs = reinterpret_cast<T*>(smem + S::Q_BYTES + S::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem + S::Q_BYTES + 2 * S::KV_BYTES);
  T* Ps = reinterpret_cast<T*>(smem + S::Q_BYTES + 2 * S::KV_BYTES + S::S_BYTES);
  float* kb = reinterpret_cast<float*>(smem + S::BYTES);   // KBIAS: AKC keys

  const int H = a.H, ntok = a.T, D = a.D;
  const int q0 = blockIdx.y * AQ;
  int b, h_begin, h_end;
  if (MODE == PROBS_MEAN) {
    b = blockIdx.x;
    h_begin = 0;
    h_end = H;
  } else {
    b = blockIdx.x / H;
    h_begin = blockIdx.x - b * H;
    h_end = h_begin + 1;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float* sw = Ss + warp * 16 * CS_LD;
  T* pw = Ps + warp * 16 * S::LDP;
  const int t = q0 + warp * 16 + r;   // this lane's query

  for (int h = h_begin; h < h_end; ++h) {
    const size_t off = ((size_t)b * H + h) * ntok * D;
    const T* qp = static_cast<const T*>(a.q) + off;
    const T* kp = static_cast<const T*>(a.k) + off;
    const T* vp = static_cast<const T*>(a.v) + off;

    // s (16 x 16) of this warp's rows and keys [j*16, j*16 + 16) of the
    // staged chunk -> sw
    typename M_::FragA qf[ND];
    auto logits = [&](int j) {
      typename M_::Acc s;
      M_::zero(s);
#pragma unroll
      for (int dk = 0; dk < ND; ++dk) {
        typename M_::template FragB<true> kf;
        M_::load_b(kf, Ks + j * 16 * S::LD + dk * 16, S::LD);
        M_::mma(s, qf[dk], kf);
      }
      M_::store(sw, s, CS_LD);
    };

    // the key biases of the chunk at kc, staged beside its keys
    auto stage_kb = [&](int kc) {
      if constexpr (KBIAS) {
        for (int i = threadIdx.x; i < AKC; i += ANT)
          kb[i] = kc + i < ntok ? a.key_bias[(size_t)b * ntok + kc + i] : 0.0f;
      }
    };
    // this lane's logit e of sw's keys [j*16, j*16 + 16), with its key bias
    auto logit = [&](int j, int e) {
      float v = sw[r * CS_LD + c0 + e];
      if constexpr (KBIAS) v += kb[j * 16 + c0 + e];
      return v;
    };

    __syncthreads();   // the previous head is done with Qs
    // q = cast(cast(q) * scale), as flash_attention.py:108 scales q
    stage_rows_scaled<T, DP, ANT>(Qs, S::LD, qp, q0, ntok, D, nullptr, a.q_scale);

    // pass 1: the row max of the fp32 logits
    float m = -CUDART_INF_F;
    for (int kc = 0; kc < ntok; kc += AKC) {
      __syncthreads();
      stage_rows<T, DP, ANT>(Ks, S::LD, kp, kc, ntok, D);
      stage_kb(kc);
      __syncthreads();
      if (kc == 0) {
#pragma unroll
        for (int dk = 0; dk < ND; ++dk)
          M_::load_a(qf[dk], Qs + warp * 16 * S::LD + dk * 16, S::LD);
      }
      for (int j = 0; j < AKC / 16 && kc + j * 16 < ntok; ++j) {
        logits(j);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (kc + j * 16 + c0 + e < ntok) m = fmaxf(m, logit(j, e));
        __syncwarp();
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

    // pass 2: p = exp(s - m) in fp32, l = sum of fp32 p, o = cast(p) @ v
    float l = 0.0f;
    typename M_::Acc o[ND];
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) M_::zero(o[dt]);
    for (int kc = 0; kc < ntok; kc += AKC) {
      __syncthreads();
      stage_rows<T, DP, ANT>(Ks, S::LD, kp, kc, ntok, D);
      stage_rows<T, DP, ANT>(Vs, S::LD, vp, kc, ntok, D);
      stage_kb(kc);
      __syncthreads();
      for (int j = 0; j < AKC / 16 && kc + j * 16 < ntok; ++j) {
        logits(j);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float p = 0.0f;
          if (kc + j * 16 + c0 + e < ntok) p = expf(logit(j, e) - m);
          l += p;
          pw[r * S::LDP + c0 + e] = from_f<T>(p);
        }
        __syncwarp();
        typename M_::FragA pf;
        M_::load_a(pf, pw, S::LDP);
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          typename M_::template FragB<false> vf;
          M_::load_b(vf, Vs + j * 16 * S::LD + dt * 16, S::LD);
          M_::mma(o[dt], pf, vf);
        }
        __syncwarp();
      }
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    if (MODE == PROBS_NONE && a.stats != nullptr && (lane & 1) == 0 && t < ntok) {
      const size_t n = (size_t)a.B * H * ntok, i = ((size_t)b * H + h) * ntok + t;
      a.stats[i] = m;
      a.stats[n + i] = 1.0f / l;
    }

#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      M_::store(sw, o[dt], CS_LD);
      __syncwarp();
      if (t < ntok) {
        T* dst = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + t * a.o_st;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = dt * 16 + c0 + e;
          if (d < D) dst[d] = from_f<T>(sw[r * CS_LD + c0 + e] / l);
        }
      }
      __syncwarp();
    }

    if constexpr (MODE != PROBS_NONE) {
      // pass 3: p / l, recomputed from s with the final m and l
      float* row = MODE == PROBS_FULL
                       ? a.probs + (((size_t)b * H + h) * ntok + t) * ntok
                       : a.probs + ((size_t)b * ntok + t) * ntok;
      for (int kc = 0; kc < ntok; kc += AKC) {
        __syncthreads();
        stage_rows<T, DP, ANT>(Ks, S::LD, kp, kc, ntok, D);
        stage_kb(kc);
        __syncthreads();
        for (int j = 0; j < AKC / 16 && kc + j * 16 < ntok; ++j) {
          logits(j);
          __syncwarp();
          if (t < ntok) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int col = kc + j * 16 + c0 + e;
              if (col < ntok) {
                const float pv = expf(logit(j, e) - m) / l;
                if (MODE == PROBS_FULL) {
                  row[col] = pv;
                } else {
                  float acc = h == 0 ? pv : row[col] + pv;
                  if (h == H - 1) acc = acc / (float)H;
                  row[col] = acc;
                }
              }
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <typename T, int DP, int MODE, bool KBIAS>
cudaError_t launch_attention_dp(const AttnArgs& a, cudaStream_t s) {
  constexpr int bytes = AttnSmem<T, DP>::BYTES + (KBIAS ? AKC * 4 : 0);
  auto kern = attention_kernel<T, DP, MODE, KBIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(MODE == PROBS_MEAN ? a.B : a.B * a.H, (a.T + AQ - 1) / AQ);
  kern<<<grid, ANT, bytes, s>>>(a);
  return cudaGetLastError();
}

// The head dim rounded up to the staged tile width: 16, 32, 64, 128 or 256.
template <typename T, int MODE, bool KBIAS = false>
cudaError_t launch_attention(const AttnArgs& a, cudaStream_t s) {
  if (a.D <= 16) return launch_attention_dp<T, 16, MODE, KBIAS>(a, s);
  if (a.D <= 32) return launch_attention_dp<T, 32, MODE, KBIAS>(a, s);
  if (a.D <= 64) return launch_attention_dp<T, 64, MODE, KBIAS>(a, s);
  if (a.D <= 128) return launch_attention_dp<T, 128, MODE, KBIAS>(a, s);
  if (a.D <= 256) return launch_attention_dp<T, 256, MODE, KBIAS>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace vitx
