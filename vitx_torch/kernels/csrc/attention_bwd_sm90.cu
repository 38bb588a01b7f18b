// B2's function (and B6's past T = 1024) on Hopper (sm_90a): the attention
// backward on wgmma and TMA, bf16 at head widths 32, 64 and 128, in two
// deterministic launches that take the forward's output and row
// statistics.
//
// Replaces vitx/kernels/flash_attention.py::_bwd_kernel_nq1 and the
// q-chunked _bwd_kernel for bf16 q, k, v, do with D = 32 (MAE's decoder),
// 64 (the ViT-B/L family) or 128 (huge14, base16_hd128); fp32 and other D
// keep flash_attention_bwd.cu. Inputs: q (unscaled), k, v, do and o, bf16
// (B, H, T, D) views with any 16-byte-multiple strides (K1's o_all and
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
// (q k^T) and no tile is rescaled for the logits. At D = 32 and 128 it is
// not (sm90.cuh's scale_rows rounds qs = cast(q * scale) in shared
// memory, and s is the product itself): launch A rounds its q tile in
// place once; launch B needs q in two roundings, qs for s^T and cast(q *
// scale * linv) from the unscaled q for dk, so it writes qs into a tile of
// its own (QS) and keeps the arrived q until it is rescaled to the second.
// delta is FA2's identity
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
//      warpgroup and one producer warp (125 registers a thread at D 64,
//      114 at D 32: three blocks an SM). The producer loads q, do and o
//      once and keeps the k and v tiles of a two-stage ring in flight by
//      TMA. The warpgroup computes delta for its rows (written out for
//      launch B), then per key tile s and dp by wgmma from shared memory,
//      e in registers, and dq += e k with e as the register A operand and
//      k read MN-major from the same tile.
//   B. dkdv_kernel_sm90: one block per (b*h, 64 keys), one consumer
//      warpgroup with k and v resident (168 registers a thread at D 64,
//      two blocks an SM by registers), and the producer streaming q, do
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
// Per width (sm90.cuh's Tile<D>; registers as ptxas reports them):
//   - D 128: both launches are held to two blocks an SM by
//     __launch_bounds__, which ptxas meets with at most 168 registers a
//     thread (two blocks of five warps put three warps on some of the SM's
//     four schedulers, each with a quarter of the register file).
//   - D 128, launch A (160 registers): dq is 64 floats a thread beside s
//     and dp (32 each). q, do, o and a two-stage k/v ring are 112 KB, a
//     few hundred bytes past what lets two blocks share an SM with the
//     alignment slack, so o (read only for delta) arrives in the ring's
//     second v slot, which the producer fills with v only after the
//     consumers have released o (an mbarrier).
//   - D 128, launch B: dk and dv are 128 floats a thread, which leave no
//     room for s^T and dp^T of 64 queries (32 each). So each arrived
//     query tile is taken in two halves of 32 queries: s^T and dp^T are
//     m64n32 products (16 floats each), and dv, dk take the half as two
//     k16 steps of m64n128; QS holds one half (8 KB); a half whose
//     queries all lie past T is skipped. K, V, the two-stage q/do ring and
//     QS are 105 KB, two blocks an SM; ptxas still spills ~300 bytes a
//     thread. Its in-place passes go one 16-byte chunk at a time, which
//     spilled less and ran faster than unrolling them (PERF.md).
//   - D 32: one 64-byte-swizzled box a tile, every accumulator a quarter
//     of D 128's, the whole query tile at once (QS 4 KB).

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

// Rows row0 and row0 + 8 of an m64nN accumulator, each value times f[r],
// to bf16 at out (rows at or past T skipped).
template <int N>
__device__ __forceinline__ void store_rows(const Out& out, int b, int h, int row0, int T,
                                           const float (&acc)[N / 2], const float (&f)[2]) {
  const int cbase = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T) continue;
    bf16* dst = out.p + b * out.sb + h * out.sh + (long long)t * out.st;
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb + cbase) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * r] * f[r], acc[4 * nb + 2 * r + 1] * f[r]);
  }
}

template <int D, int NS> struct DqSmem {
  static constexpr int TB = sm90::Tile<D>::BYTES;
  // D 128: o in the second stage's v slot (the header note)
  static constexpr bool O_IN_RING = D == 128 && NS >= 2;
  static constexpr int Q = 0;                                   // a tile each:
  static constexpr int DO = Q + TB;
  static constexpr int K = DO + TB;                             // NS tiles each:
  static constexpr int V = K + NS * TB;
  static constexpr int O = O_IN_RING ? V + TB : V + NS * TB;    // a tile
  static constexpr int DELTA = O_IN_RING ? V + NS * TB : O + TB;   // 64 fp32
  static constexpr int BAR = DELTA + 64 * 4;                    // q, full[NS], empty[NS], ofree
  static constexpr int BYTES = BAR + 8 * (2 + 2 * NS) + 1024;
};

template <int D, int NS>
__global__ void __launch_bounds__(BWD_THREADS, D == 128 ? 2 : 1)
dq_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap to, const BwdArgs a) {
  using S = DqSmem<D, NS>;
  using G = sm90::Tile<D>;
  using namespace sm90;
  constexpr bool QS = D != 64;   // qs rounded into the q tile before the first product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  unsigned char* Qs = smem + S::Q;
  unsigned char* DOs = smem + S::DO;
  unsigned char* Os = smem + S::O;
  unsigned char* Ks = smem + S::K;
  unsigned char* Vs = smem + S::V;
  float* sdelta = reinterpret_cast<float*>(smem + S::DELTA);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;
  uint64_t* ofree = empty + NS;   // O_IN_RING: the consumers are done with o

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
    mbar_init(ofree, 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 3 * G::BYTES);
      tma_load_tile_d<D>(Qs, &tq, qbar, q0, h, b);
      tma_load_tile_d<D>(DOs, &tdo, qbar, q0, h, b);
      tma_load_tile_d<D>(Os, &to, qbar, q0, h, b);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], (j / NS - 1) & 1);
        if (S::O_IN_RING && j == 1) mbar_wait(ofree, 0);
        mbar_arrive_expect_tx(&full[s], 2 * G::BYTES);
        tma_load_tile_d<D>(Ks + s * G::BYTES, &tk, &full[s], 64 * j, h, b);
        tma_load_tile_d<D>(Vs + s * G::BYTES, &tv, &full[s], 64 * j, h, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const size_t n = (size_t)gridDim.y * T;
  mbar_wait(qbar, 0);

  // delta = rowsum(do * o): two threads a row, D/16 16-byte chunks each
  // (both tiles carry the same swizzle, so a chunk of one meets the same
  // columns of the other)
  {
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int j = half * (D / 16) + c, box = j / G::CPR, p = j % G::CPR;
      const int off = box * G::BOX_BYTES + r * G::ROW_BYTES + 16 * p;
      uint4 x = *reinterpret_cast<const uint4*>(DOs + off);
      uint4 y = *reinterpret_cast<const uint4*>(Os + off);
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
  if constexpr (S::O_IN_RING) {   // o's slot may take v now
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(ofree);
  }
  if constexpr (QS) {   // qs = cast(q * scale), vitx's rounding, in place
    const float qscale = a.scale;
    scale_rows<D, true>(Qs, Qs, 0, 64, [qscale](int) { return qscale; }, tid, 128);
    fence_proxy_async();
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
  // exp(s - m) as exp2(s * sl2 - m * log2e): s the product itself (QS), or
  // it times the scale (D 64)
  const float sl2 = QS ? LOG2E : a.scale * LOG2E;
  const int cbase = 2 * (lane & 3);
  const uint64_t dqd = desc_tile<D>(Qs), dod = desc_tile<D>(DOs);

  float acc[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
  for (int j = 0; j < nkt; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    const uint64_t dk = desc_tile<D>(Ks + s * G::BYTES), dv = desc_tile<D>(Vs + s * G::BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss(sc, desc_k<D>(dqd, kk), desc_k<D>(dk, kk), kk);
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss(dp, desc_k<D>(dod, kk), desc_k<D>(dv, kk), kk);
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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ea[kk], desc_rows<D>(dk, kk));
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float f[2] = {a.scale * linv[0], a.scale * linv[1]};
  store_rows<D>(a.dq, b, h, q0 + rl, T, acc, f);
}

// queries of a query tile that launch B takes at once: half the tile at
// D 128 (the header note)
template <int D> constexpr int DKDV_QW = D == 128 ? 32 : 64;

template <int D, int NS> struct DkvSmem {
  static constexpr int TB = sm90::Tile<D>::BYTES;
  static constexpr int K = 0;                                   // a tile each:
  static constexpr int V = K + TB;
  static constexpr int Q = V + TB;                              // NS tiles each:
  static constexpr int DO = Q + NS * TB;
  // D != 64: qs of DKDV_QW<D> queries (a Tile<D>'s boxes of that many rows)
  static constexpr int QS = DO + NS * TB;
  static constexpr int QS_BYTES = D == 64 ? 0 : DKDV_QW<D> * D * 2;
  // NS x (m * log2e | linv | delta) x 64 fp32
  static constexpr int ST = QS + QS_BYTES;
  static constexpr int BAR = ST + NS * 3 * 64 * 4;              // kv, full[NS], empty[NS]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NS) + 1024;
};

template <int D, int NS>
__global__ void __launch_bounds__(BWD_THREADS, D == 128 ? 2 : D == 32 ? 3 : 1)
dkdv_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const BwdArgs a) {
  using S = DkvSmem<D, NS>;
  using G = sm90::Tile<D>;
  using namespace sm90;
  constexpr bool QS = D != 64;
  constexpr int QW = DKDV_QW<D>;   // queries a step: s^T and dp^T are m64nQW
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align_1024(smem_raw);
  unsigned char* Ks = smem + S::K;
  unsigned char* Vs = smem + S::V;
  unsigned char* Qs = smem + S::Q;
  unsigned char* DOs = smem + S::DO;
  unsigned char* QSs = smem + S::QS;
  float* St = reinterpret_cast<float*>(smem + S::ST);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;

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
      mbar_arrive_expect_tx(kvbar, 2 * G::BYTES);
      tma_load_tile_d<D>(Ks, &tk, kvbar, k0, h, b);
      tma_load_tile_d<D>(Vs, &tv, kvbar, k0, h, b);
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
        mbar_arrive_expect_tx(&full[s], 2 * G::BYTES);
        tma_load_tile_d<D>(Qs + s * G::BYTES, &tq, &full[s], 64 * i, h, b);
        tma_load_tile_d<D>(DOs + s * G::BYTES, &tdo, &full[s], 64 * i, h, b);
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
  const float sl2 = QS ? LOG2E : a.scale * LOG2E;
  const float scale = a.scale;
  const int cbase = 2 * (lane & 3);
  const uint64_t kd = desc_tile<D>(Ks), vd = desc_tile<D>(Vs);
  const uint64_t qsd = desc_tile<D>(QSs);   // QW rows: boxes QW * ROW_BYTES apart

  float dka[D / 2], dva[D / 2], sc[QW / 2], dp[QW / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < QW / 2; ++i) sc[i] = dp[i] = 0.0f;
  for (int it = 0; it < nqt; ++it) {
    const int s = it % NS;
    mbar_wait(&full[s], (it / NS) & 1);
    unsigned char* qt = Qs + s * G::BYTES;
    unsigned char* dot = DOs + s * G::BYTES;
    const uint64_t qd = desc_tile<D>(qt), dod = desc_tile<D>(dot);
    const float* st = St + s * 192;
#pragma unroll
    for (int r0 = 0; r0 < 64; r0 += QW) {
      if (QW < 64 && 64 * it + r0 >= T) break;   // the step's queries all lie past T
      if constexpr (QS) {   // QS = cast(q[r0 .. r0 + QW) * scale), the logits' operand
        scale_rows<D, false>(qt, QSs, r0, QW, [scale](int) { return scale; }, threadIdx.x, 128);
        fence_proxy_async();
        named_bar(1, 128);
      }
      // s^T = k qs^T and dp^T = v do^T over this step's queries: B is the
      // rows r0 .. r0 + QW of QS (or, at D 64, of the arrived q) and of do
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk) {
        const uint64_t bq = QS ? desc_k<D, QW * G::ROW_BYTES>(qsd, kk) : desc_k<D>(qd, kk);
        wgmma_ss(sc, desc_k<D>(kd, kk), bq, kk);
      }
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk)
        wgmma_ss(dp, desc_k<D>(vd, kk), desc_k<D>(dod, kk) + r0 * G::ROW_BYTES / 16, kk);
      wg_commit();
      wg_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // pu^T and e^T: rows are keys, columns the step's queries
#pragma unroll
      for (int i = 0; i < QW / 2; ++i) {
        const int qc = r0 + 8 * (i >> 2) + cbase + (i & 1);
        const bool ok = 64 * it + qc < T && kvalid[(i >> 1) & 1];
        const float pu = ok ? exp2f(sc[i] * sl2 - st[qc]) : 0.0f;
        sc[i] = pu;
        dp[i] = pu * (dp[i] - st[128 + qc]);
      }
      uint32_t pa[QW / 16][4], ea[QW / 16][4];
      acc_to_a(sc, pa);
      acc_to_a(dp, ea);

      // q -> cast(q * scale * linv) and do -> cast(do * linv), in place,
      // rows r0 .. r0 + QW: a row of the swizzled tile is one query,
      // whatever the chunk order
      named_bar(1, 128);   // every warp is done reading these rows as they arrived
      scale_rows<D, true>(qt, qt, r0, QW, [&](int row) { return scale * st[64 + row]; },
                          threadIdx.x, 128);
      scale_rows<D, true>(dot, dot, r0, QW, [&](int row) { return st[64 + row]; },
                          threadIdx.x, 128);
      fence_proxy_async();
      named_bar(1, 128);

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        wgmma_rs(dva, pa[kk], desc_rows<D>(dod, r0 / 16 + kk));
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk)
        wgmma_rs(dka, ea[kk], desc_rows<D>(qd, r0 / 16 + kk));
      wg_commit();
      wg_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<D>(a.dk, b, h, k0 + rl, T, dka, one);
  store_rows<D>(a.dv, b, h, k0 + rl, T, dva, one);
}

// Build the five tensor maps of the Tile<D> boxes, then launch A and B.
template <int D>
int run_bwd_sm90(const void* const in[5], const BwdArgs& a, const long long* views, int B,
                 cudaStream_t s) {
  CUtensorMap m[5];
  for (int i = 0; i < 5; ++i) {
    const int err = sm90::make_tile_map<D>(&m[i], in[i], B, a.H, a.T, views[3 * i],
                                           views[3 * i + 1], views[3 * i + 2]);
    if (err != 0) return err;
  }
  const dim3 grid((a.T + 63) / 64, B * a.H);
  using SA = DqSmem<D, BWD_NS>;
  auto ka = dq_kernel_sm90<D, BWD_NS>;
  cudaError_t err =
      cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, SA::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka<<<grid, BWD_THREADS, SA::BYTES, s>>>(m[0], m[1], m[2], m[3], m[4], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using SB = DkvSmem<D, BWD_NS>;
  auto kb = dkdv_kernel_sm90<D, BWD_NS>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, SB::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, BWD_THREADS, SB::BYTES, s>>>(m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vitx

// q, k, v, do, o (in) and dq, dk, dv (out): bf16 (B, H, T, D) views, D 32,
// 64 or 128, whose element strides (sb, sh, st) are views[3*i .. 3*i+2] in
// that order, each a multiple of 8, the last dim contiguous, pointers
// 16-byte aligned. stats: (2, B*H*T) fp32 from the forward; delta: (B*H*T)
// fp32 scratch. Returns 0, the first CUDA error of the launches, a
// tensor-map code of sm90.cuh, or ERR_ROUTE for another D.
extern "C" int vitx_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const void* o, void* dq, void* dk,
                                       void* dv, const float* stats, float* delta,
                                       const long long* views, int B, int H, int T, int D,
                                       void* stream) {
  using namespace vitx;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* in[5] = {q, k, v, dout, o};
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
  a.scale = sm90::attention_scale(D);
  switch (D) {
    case 32: return run_bwd_sm90<32>(in, a, views, B, s);
    case 64: return run_bwd_sm90<64>(in, a, views, B, s);
    case 128: return run_bwd_sm90<128>(in, a, views, B, s);
    default: return sm90::ERR_ROUTE;
  }
}
