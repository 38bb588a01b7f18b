// Hopper (sm_90a) building blocks of the attention kernels
// (attention_fwd_sm90.cuh, attention_bwd_sm90.cu) and of the LN-prologue
// GEMM (gemm_sm90.cuh).
//
// - Tiles arrive by TMA (cp.async.bulk.tensor) into shared memory with the
//   128-byte swizzle: a (64 rows, 64 bf16) box, one 128-byte row per
//   token, 16-byte chunk c of row r stored at chunk c ^ (r % 8). Every tile
//   starts on a 1024-byte boundary, so the swizzle phase is the row index.
//   Rows past the tensor's extent arrive as zeros; the kernels mask them.
// - Completion is tracked by mbarriers in shared memory: a "full" barrier
//   per ring stage that the TMA's byte count completes, an "empty" barrier
//   the consumers arrive on when they are done with the stage.
// - Products are wgmma m64n64k16 bf16 -> fp32, the accumulator in
//   registers (32 floats a thread). A comes from shared memory (a
//   descriptor) or from registers; B from shared memory, K-major (the tile
//   as it lies: rows of 64 contiguous bf16 along the contraction) or
//   MN-major (rows along the contraction, 64 contiguous bf16 of N each).
//   Both readings take the same swizzled tile, so one K or V tile serves as
//   k^T for the logits and as k for dq += e k.
// - The attention kernels' (64 rows, D) tiles at head width D (Tile<D>):
//   at D 64 the box above; at D 128 two such boxes side by side, 8 KB
//   apart (a TMA box under the 128-byte swizzle is at most 128 bytes
//   wide), so a K-major reading over D steps into the second box after
//   four k16 steps and an MN-major operand of width 128 finds its second
//   64 columns one box on (the descriptor's leading byte offset); at D 32
//   one (64, 32) box of 64-byte rows under the 64-byte swizzle (16-byte
//   chunk c of row r at chunk c ^ ((r / 2) % 4), 8-row groups 512 bytes
//   apart).
//
// Register layout of an m64n64 fp32 accumulator d[32] in warp w (0..3) of
// the warpgroup, lane l: d[4*nb + 2*hi + c] holds row 16*w + l/4 + 8*hi,
// column 8*nb + 2*(l%4) + c. The A fragment of the k-th 16-column slice
// of the same rows is {pack(d[8k], d[8k+1]), pack(d[8k+2], d[8k+3]),
// pack(d[8k+4], d[8k+5]), pack(d[8k+6], d[8k+7])}: an accumulator turns
// into the A operand of the next product without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <cmath>

namespace vitx {
namespace sm90 {

constexpr int TILE_ROWS = 64;                  // rows of a TMA box and of a wgmma
constexpr int TILE_BYTES = 64 * 64 * 2;        // a (64, 64) bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

// A (64 rows, D) bf16 tile of q, k, v, do or o at head width D: NBOX boxes
// of (64, BOX_COLS), BOX_BYTES each, side by side; ROW_BYTES, a box row,
// is the swizzle's span (128 or 64 bytes).
template <int D> struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head width 32, 64 or 128");
  static constexpr int BOX_COLS = D < 64 ? D : 64;
  static constexpr int NBOX = D / BOX_COLS;
  static constexpr int ROW_BYTES = 2 * BOX_COLS;
  static constexpr int BOX_BYTES = TILE_ROWS * ROW_BYTES;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr int KSTEPS = D / 16;          // k16 steps over D
  static constexpr int KPB = BOX_COLS / 16;      // of them in one box
  static constexpr int CPR = BOX_COLS / 8;       // 16-byte chunks in a box row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p in shared memory, where the
// tiles start (the launch asks for 1024 bytes more than the tiles need).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------------

// One box of a 4-D map (D, T, H, B) at (c0, t0, h, b) into dst,
// completing the box's bytes of the barrier's transaction count.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int t0, int h, int b, int c0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(t0), "r"(h), "r"(b)
      : "memory");
}

// A whole Tile<D> of rows t0 .. t0 + 63 at (h, b): its NBOX boxes
// (Tile<D>::BYTES of the barrier's count).
template <int D>
__device__ __forceinline__ void tma_load_tile_d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int t0, int h, int b) {
  using G = Tile<D>;
#pragma unroll
  for (int i = 0; i < G::NBOX; ++i)
    tma_load_tile(static_cast<unsigned char*>(dst) + i * G::BOX_BYTES, map, bar, t0, h, b,
                  i * G::BOX_COLS);
}

// One (64 rows, 64 columns) box of a 2-D map at column c0, row r0 into
// dst (the GEMM's A and W tiles).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// Shared memory written by ordinary stores, made visible to wgmma and TMA
// (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over ``count`` threads (a multiple of 32) with id ``id`` (1..15;
// 0 is __syncthreads).
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- tiles in shared memory ---------------------------------------------------

// Rows r0 .. r0 + rows - 1 of a Tile<D> as TMA wrote it (r0 a multiple of
// 8), each bf16 times f(row) in fp32 and rounded back to bf16: in place
// (INPLACE), or into a tile of ``rows`` rows at dst, its boxes rows *
// ROW_BYTES apart, row r0 + r at its row r -- the same swizzle phase, so
// the copy is one that TMA could have written. Spread over ``n`` threads
// (this one ``tid``), a 16-byte chunk each; the caller fences
// (fence_proxy_async) and synchronises before a wgmma reads the result.
// At D 128 the chunks go one at a time (the caller's accumulators leave
// few registers); narrower tiles unroll (measured on the H100, PERF.md).
template <int D, bool INPLACE, typename F>
__device__ __forceinline__ void scale_rows(unsigned char* src, unsigned char* dst, int r0,
                                           int rows, F f, int tid, int n) {
  using G = Tile<D>;
  const int per_box = rows * G::CPR;
#pragma unroll (D == 128 ? 1 : 4)
  for (int idx = tid; idx < G::NBOX * per_box; idx += n) {
    const int box = idx / per_box, rem = idx - box * per_box;
    const int r = rem / G::CPR, c = rem - r * G::CPR;
    uint4* from = reinterpret_cast<uint4*>(src + box * G::BOX_BYTES + (r0 + r) * G::ROW_BYTES) + c;
    uint4* to = INPLACE ? from
                        : reinterpret_cast<uint4*>(dst + box * rows * G::ROW_BYTES +
                                                   r * G::ROW_BYTES) + c;
    const float fr = f(r0 + r);
    uint4 x = *from;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * fr);
    *to = x;
  }
}

// --- wgmma ---------------------------------------------------------------------

// Descriptor of a Tile<D> at ``tile`` (1024-aligned): start address, leading
// and stride byte offsets in 16-byte units, and the box's swizzle (layout 1:
// 128 bytes, 2: 64 bytes). The stride offset steps over 8-row groups (8 *
// ROW_BYTES); the leading one to the next column block, one box on, which
// only an MN-major operand of width 128 reads (at D 64, one block, it
// holds 1024 bytes). The GEMM's (rows, 64) boxes take Tile<64>'s.
template <int D> __device__ __forceinline__ uint64_t desc_tile(const void* tile) {
  using G = Tile<D>;
  const uint64_t addr = smem_u32(tile);
  const uint64_t lbo = D == 64 ? 64 : G::BOX_BYTES >> 4;
  return ((addr & 0x3FFFF) >> 4) | (lbo << 16) | ((uint64_t)(8 * G::ROW_BYTES >> 4) << 32) |
         ((uint64_t)(G::ROW_BYTES == 128 ? 1 : 2) << 62);
}
// The K-major reading's k16 step kk over D: box kk / KPB (boxes BOXB
// bytes apart: a Tile<D>'s, or those of a tile of fewer rows), 32 bytes a
// step within its rows.
template <int D, int BOXB = Tile<D>::BOX_BYTES>
__device__ __forceinline__ uint64_t desc_k(uint64_t d, int kk) {
  return d + (kk / Tile<D>::KPB) * (BOXB >> 4) + 2 * (kk % Tile<D>::KPB);
}
// The MN-major reading's step over 16 rows (16 * ROW_BYTES bytes).
template <int D> __device__ __forceinline__ uint64_t desc_rows(uint64_t d, int k) {
  return d + k * Tile<D>::ROW_BYTES;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product's start and its wait.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VITX_WG_D32                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B^T, A (64 x 16) and B (64 x 16) both K-major in shared memory.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VITX_WG_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (64 x 16) bf16 in registers (the fragment above), B (16 x 64)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VITX_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VITX_WG_D32

#define VITX_WG_D16 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define VITX_WG_D64 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B^T with N = 32: A (64 x 16) and B (32 x 16), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : VITX_WG_D16
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B with N = 32 and N = 128: A (64 x 16) bf16 in registers, B
// (16 x N) MN-major in shared memory (at N 128 two 64-column blocks, the
// descriptor's leading byte offset apart).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : VITX_WG_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VITX_WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VITX_WG_D16
#undef VITX_WG_D64

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of an accumulator's 16-column slices (four of an
// m64n64 one, two of an m64n32), each value rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[k][j] = pack_bf16(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
  }
}

// --- host: tensor maps ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (the CUDA
// runtime has it open already), so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Make the primary context of the calling thread's device current on the
// thread, as the runtime does at a thread's first call that needs one. The
// encode is a driver call and needs a current context; a thread that has
// made no such runtime call yet has none (autograd's backward thread when
// its first kernel is one of these, its buffers all from the caching
// allocator).
inline void bind_primary_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// The fp32 scale vitx uses at head width D: 1 / sqrt(D) (a power of two
// only at D 64).
inline float attention_scale(int D) { return static_cast<float>(1.0 / sqrt((double)D)); }

// Error codes of the entry points beyond cudaError_t's range.
constexpr int ERR_NO_ENCODE = 10000;     // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 20000;    // + the CUresult of the encode
constexpr int ERR_ROUTE = 30000;         // a route asked for that the inputs cannot take

// The map of a bf16 (B, H, T, D) view with element strides sb, sh, st (the
// last dim contiguous), boxes of Tile<D>'s (64 tokens, BOX_COLS channels)
// with its swizzle (128 bytes; 64 at D 32) and zeros past T. Returns 0 or
// one of the codes above.
template <int D>
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int H, int T, long long sb,
                         long long sh, long long st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  bind_primary_context();
  const cuuint64_t dims[4] = {D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {Tile<D>::BOX_COLS, TILE_ROWS, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Tile<D>::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                  : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// The map of a row-major bf16 (rows, cols) matrix, cols a multiple of 8
// (16-byte rows), boxes of (64 rows, 64 columns) with the 128-byte swizzle
// and zeros outside the matrix. Returns 0 or one of the codes above.
inline int make_matrix_map(CUtensorMap* map, const void* base, int rows, int cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  bind_primary_context();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, TILE_ROWS};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

}  // namespace sm90
}  // namespace vitx
