// B2's function (and B6's past T = 1024) on Hopper (sm_90a): the attention
// backward on wgmma and TMA, bf16 at head width 64, in two deterministic
// launches that take the forward's output and row statistics.
//
// Replaces vitx/kernels/flash_attention.py::_bwd_kernel_nq1 and the
// q-chunked _bwd_kernel for bf16 q, k, v, do with D = 64, the head width
// of every model the port runs; fp32 and other D keep
// flash_attention_bwd.cu. Inputs: q (unscaled), k, v, do and o, bf16
// (B, H, T, 64) views with any 16-byte-multiple strides (K1's o_all and
// the backward's do are read in their (B, T, H, D) layouts), and stats
// (2, B, H, T) fp32 from the forward: the row max m of the logits and
// linv = 1 / l. Outputs dq, dk, dv, bf16 views with any such strides (the
// fused block writes them straight into its (B*T, 3, H, D) dqkv).
//
// With s = qs k^T (fp32), pu = exp(s - m), the rounding points of
// flash_attention.py:297-310:
//   delta = rowsum(do * o)                  (fp32; see below)
//   e = cast(pu * (dp - delta)),  dp = do v^T (fp32)
//   dq = cast((e k) * scale * linv)
//   dv = cast(pu)^T cast(do * linv)
//   dk = e^T cast(q * scale * linv)
// At D = 64 the scale is 2^-3: qs = q * scale exactly, so s = scale *
// (q k^T) and no tile is rescaled for the logits. delta is FA2's identity
// rowsum(do * o) = rowsum(p * dp) for vitx's rowsum(pu * dp) * linv: its
// rounding point moves from the fp32 pu * dp to the bf16 o of the forward
// (tests/test_torch_attn_sm90.py measures the cost against vitx).
//
// What bounds it on the H100: 10*B*H*T^2*D operations of the function
// against 7*B*H*T*D bf16 elements (q, k, v, do in; dq, dk, dv out): at
// T = 197 ~280 operations a byte, about the card's ridge; at T = 1025
// operations. This kernel does 14*B*H*T^2*D (s and dp are computed in
// both launches) where the earlier one did 20 (flash_attention_bwd.cu
// rebuilt m, l and delta with three extra q k^T passes), with no atomics
// and a fixed order of every sum, so a call gives the same bits every
// time:
//   A. dq_kernel_sm90: one block per (b*h, 64 queries): one consumer
//      warpgroup and one producer warp, two blocks an SM (166 registers a
//      thread). The producer loads q, do and o once and keeps the k and v
//      tiles of a two-stage ring in flight by TMA. The warpgroup computes
//      delta for its rows (written out for launch B), then per key tile s
//      and dp by wgmma from shared memory, e in registers, and dq += e k
//      with e as the register A operand and k read MN-major from the same
//      tile.
//   B. dkdv_kernel_sm90: one block per (b*h, 64 keys), one consumer
//      warpgroup with k and v resident (three blocks an SM, 128 registers
//      a thread), and the producer streaming q, do
//      and the 64 queries' m, linv and delta through the ring. s^T = k q^T
//      and dp^T = v do^T by wgmma; pu^T and e^T in registers; then the
//      arrived q and do tiles are rescaled in shared memory, in place, to
//      cast(q * scale * linv) and cast(do * linv) -- vitx's rounding
//      points -- and dv += cast(pu)^T don, dk += e^T qn take pu^T and e^T
//      as register A operands. Rescaling the arrived tile costs a read and
//      a write of 16 KB of shared memory per query tile; having launch A
//      write qn and don instead would add 4*B*H*T*D bytes of device
//      memory traffic, a half more than the function's own 7, at T = 197
//      where the kernel sits near the ridge.
// Measured on the H100 (PERF.md): two warpgroups a block and overlapping a
// tile's products with the next tile's elementwise work inside a
// warpgroup were both slower than more blocks an SM, which overlap one
// block's exps with another's products.

#include "common.cuh"
#include "sm90.cuh"

namespace vitx {

constexpr int BWD_NS = 2;    // stages of the rings
constexpr int BWD_THREADS = 128 + 32;   // a consumer warpgroup and a producer warp

struct Out {
  bf16* p;
  long long sb, sh, st;
};

struct BwdArgs {
  Out dq, dk, dv;
  const float* stats;   // (2, B*H*T): m | linv
  float* delta;         // (B*H*T), written by launch A
  int H, T;
  float scale;
};

// Rows row0 and row0 + 8 of an m64n64 accumulator, each value times f[r],
// to bf16 at out (rows at or past T skipped).
__device__ __forceinline__ void store_rows(const Out& out, int b, int h, int row0, int T,
                                           const float (&acc)[32], const float (&f)[2]) {
  const int cbase = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T) continue;
    bf16* dst = out.p + b * out.sb + h * out.sh + (long long)t * out.st;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb + cbase) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * r] * f[r], acc[4 * nb + 2 * r + 1] * f[r]);
  }
}

template <int NS> struct DqSmem {
  static constexpr int Q = 0;                                   // a tile each:
  static constexpr int DO = Q + sm90::TILE_BYTES;
  static constexpr int O = DO + sm90::TILE_BYTES;
  static constexpr int K = O + sm90::TILE_BYTES;                // NS tiles each:
  static constexpr int V = K + NS * sm90::TILE_BYTES;
  static constexpr int DELTA = V + NS * sm90::TILE_BYTES;       // 64 fp32
  static constexpr int BAR = DELTA + 64 * 4;                    // q, full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;
};

template <int NS>
__global__ void __launch_bounds__(BWD_THREADS, 1)
dq_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap to, const BwdArgs a) {
  using S = DqSmem<NS>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + S::DO);
  bf16* Os = reinterpret_cast<bf16*>(smem + S::O);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::V);
  float* sdelta = reinterpret_cast<float*>(smem + S::DELTA);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;
  constexpr int TE = TILE_BYTES / 2;

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
      mbar_arrive_expect_tx(qbar, 3 * TILE_BYTES);
      tma_load_tile(Qs, &tq, qbar, q0, h, b);
      tma_load_tile(DOs, &tdo, qbar, q0, h, b);
      tma_load_tile(Os, &to, qbar, q0, h, b);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], (j / NS - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_tile(Ks + s * TE, &tk, &full[s], 64 * j, h, b);
        tma_load_tile(Vs + s * TE, &tv, &full[s], 64 * j, h, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const size_t n = (size_t)gridDim.y * T;
  mbar_wait(qbar, 0);

  // delta = rowsum(do * o): two threads a row, four 16-byte chunks each
  // (both tiles carry the same swizzle, so a chunk of one meets the same
  // columns of the other)
  {
    const int r = tid >> 1, half = tid & 1;
    const uint4* dr = reinterpret_cast<const uint4*>(DOs + r * 64) + 4 * half;
    const uint4* orow = reinterpret_cast<const uint4*>(Os + r * 64) + 4 * half;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint4 x = dr[c], y = orow[c];
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
      const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(to_f(xe[e]), to_f(ye[e]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sdelta[r] = acc;
      const int t = q0 + r;
      if (t < T) a.delta[(size_t)bh * T + t] = acc;
    }
  }
  named_bar(1, 128);

  const int rl = 16 * warp + (lane >> 2);   // rows rl and rl + 8 of the tile
  float ml2[2], linv[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + rl + 8 * r;
    const size_t i = (size_t)bh * T + t;
    ml2[r] = t < T ? a.stats[i] * LOG2E : 0.0f;
    linv[r] = t < T ? a.stats[n + i] : 0.0f;
    dlt[r] = sdelta[rl + 8 * r];
  }
  const float sl2 = a.scale * LOG2E;
  const int cbase = 2 * (lane & 3);
  const uint64_t dqd = desc_sw128(Qs), dod = desc_sw128(DOs);

  float acc[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = dp[i] = 0.0f;
  for (int j = 0; j < nkt; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    const uint64_t dk = desc_sw128(Ks + s * TE), dv = desc_sw128(Vs + s * TE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, desc_kstep(dqd, kk), desc_kstep(dk, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, desc_kstep(dod, kk), desc_kstep(dv, kk), kk);
    wg_commit();
    wg_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = 64 * j + 8 * (i >> 2) + cbase + (i & 1);
      const float pu = col < T ? exp2f(sc[i] * sl2 - ml2[r]) : 0.0f;
      sc[i] = pu * (dp[i] - dlt[r]);
    }
    uint32_t ea[4][4];
    acc_to_a(sc, ea);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ea[kk], desc_rowstep(dk, kk));
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float f[2] = {a.scale * linv[0], a.scale * linv[1]};
  store_rows(a.dq, b, h, q0 + rl, T, acc, f);
}

template <int NS> struct DkvSmem {
  static constexpr int K = 0;                                   // a tile each:
  static constexpr int V = K + sm90::TILE_BYTES;
  static constexpr int Q = V + sm90::TILE_BYTES;                // NS tiles each:
  static constexpr int DO = Q + NS * sm90::TILE_BYTES;
  // NS x (m * log2e | linv | delta) x 64 fp32
  static constexpr int ST = DO + NS * sm90::TILE_BYTES;
  static constexpr int BAR = ST + NS * 3 * 64 * 4;              // kv, full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;
};

template <int NS>
__global__ void __launch_bounds__(BWD_THREADS, 1)
dkdv_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const BwdArgs a) {
  using S = DkvSmem<NS>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + S::DO);
  float* St = reinterpret_cast<float*>(smem + S::ST);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;
  constexpr int TE = TILE_BYTES / 2;

  const int T = a.T, H = a.H;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * 64;
  const int nqt = (T + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t n = (size_t)gridDim.y * T;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes, after their stats stores
      mbar_init(&empty[s], 4);   // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * TILE_BYTES);
      tma_load_tile(Ks, &tk, kvbar, k0, h, b);
      tma_load_tile(Vs, &tv, kvbar, k0, h, b);
    }
    for (int i = 0; i < nqt; ++i) {
      const int s = i % NS;
      if (i >= NS) mbar_wait(&empty[s], (i / NS - 1) & 1);
      float* st = St + s * 192;
      for (int r = lane; r < 64; r += 32) {
        const int t = 64 * i + r;
        const size_t idx = (size_t)bh * T + t;
        st[r] = t < T ? a.stats[idx] * LOG2E : 0.0f;
        st[64 + r] = t < T ? a.stats[n + idx] : 0.0f;
        st[128 + r] = t < T ? a.delta[idx] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_tile(Qs + s * TE, &tq, &full[s], 64 * i, h, b);
        tma_load_tile(DOs + s * TE, &tdo, &full[s], 64 * i, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  mbar_wait(kvbar, 0);
  const int rl = 16 * warp + (lane >> 2);
  bool kvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kvalid[r] = k0 + rl + 8 * r < T;
  const float sl2 = a.scale * LOG2E;
  const int cbase = 2 * (lane & 3);
  const uint64_t kd = desc_sw128(Ks), vd = desc_sw128(Vs);

  float dka[32], dva[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = sc[i] = dp[i] = 0.0f;
  for (int it = 0; it < nqt; ++it) {
    const int s = it % NS;
    mbar_wait(&full[s], (it / NS) & 1);
    const uint64_t qd = desc_sw128(Qs + s * TE), dod = desc_sw128(DOs + s * TE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, desc_kstep(kd, kk), desc_kstep(qd, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, desc_kstep(vd, kk), desc_kstep(dod, kk), kk);
    wg_commit();
    wg_wait<0>();
    fence_acc(sc);
    fence_acc(dp);

    // pu^T and e^T: rows are keys, columns the tile's queries
    const float* st = St + s * 192;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i >> 2) + cbase + (i & 1);
      const bool ok = 64 * it + qc < T && kvalid[(i >> 1) & 1];
      const float pu = ok ? exp2f(sc[i] * sl2 - st[qc]) : 0.0f;
      sc[i] = pu;
      dp[i] = pu * (dp[i] - st[128 + qc]);
    }
    uint32_t pa[4][4], ea[4][4];
    acc_to_a(sc, pa);
    acc_to_a(dp, ea);

    // q -> cast(q * scale * linv) and do -> cast(do * linv), in place: a
    // row of the swizzled tile is one query, whatever the chunk order
    named_bar(1, 128);   // every warp is done reading q and do as they arrived
    for (int idx = threadIdx.x; idx < 2 * 512; idx += 128) {
      const int c = idx & 511, row = c >> 3;
      const bool is_do = idx >= 512;
      uint4* p = reinterpret_cast<uint4*>((is_do ? DOs : Qs) + s * TE) + c;
      const float f = is_do ? st[64 + row] : a.scale * st[64 + row];
      uint4 x = *p;
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(to_f(e[u]) * f);
      *p = x;
    }
    fence_proxy_async();
    named_bar(1, 128);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dva, pa[kk], desc_rowstep(dod, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dka, ea[kk], desc_rowstep(qd, kk));
    wg_commit();
    wg_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows(a.dk, b, h, k0 + rl, T, dka, one);
  store_rows(a.dv, b, h, k0 + rl, T, dva, one);
}

}  // namespace vitx

// q, k, v, do, o (in) and dq, dk, dv (out): bf16 (B, H, T, 64) views whose
// element strides (sb, sh, st) are views[3*i .. 3*i+2] in that order, each
// a multiple of 8, the last dim contiguous, pointers 16-byte aligned.
// stats: (2, B*H*T) fp32 from the forward; delta: (B*H*T) fp32 scratch.
// Returns 0, the first CUDA error of the launches, or a tensor-map code of
// sm90.cuh.
extern "C" int vitx_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const void* o, void* dq, void* dk,
                                       void* dv, const float* stats, float* delta,
                                       const long long* views, int B, int H, int T,
                                       void* stream) {
  using namespace vitx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tk, tv, tdo, to;
  const void* in[5] = {q, k, v, dout, o};
  CUtensorMap* maps[5] = {&tq, &tk, &tv, &tdo, &to};
  for (int i = 0; i < 5; ++i) {
    const int err = sm90::make_tile_map(maps[i], in[i], B, H, T, views[3 * i],
                                        views[3 * i + 1], views[3 * i + 2]);
    if (err != 0) return err;
  }
  BwdArgs a;
  void* outs[3] = {dq, dk, dv};
  Out* dst[3] = {&a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 3; ++i) {
    dst[i]->p = static_cast<bf16*>(outs[i]);
    dst[i]->sb = views[15 + 3 * i];
    dst[i]->sh = views[16 + 3 * i];
    dst[i]->st = views[17 + 3 * i];
  }
  a.stats = stats;
  a.delta = delta;
  a.H = H; a.T = T;
  a.scale = 0.125f;   // 1 / sqrt(64)

  const dim3 grid((T + 63) / 64, B * H);
  using SA = DqSmem<BWD_NS>;
  auto ka = dq_kernel_sm90<BWD_NS>;
  cudaError_t err =
      cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, SA::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka<<<grid, BWD_THREADS, SA::BYTES, s>>>(tq, tk, tv, tdo, to, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using SB = DkvSmem<BWD_NS>;
  auto kb = dkdv_kernel_sm90<BWD_NS>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, SB::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, BWD_THREADS, SB::BYTES, s>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}
