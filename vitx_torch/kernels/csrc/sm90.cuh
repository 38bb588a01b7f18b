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

namespace vitx {
namespace sm90 {

constexpr int TILE_ROWS = 64;                  // rows of a TMA box and of a wgmma
constexpr int TILE_BYTES = 64 * 64 * 2;        // a (64, 64) bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

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

// One (64, 64) box of a 4-D map (D, T, H, B) at (0, t0, h, b) into dst,
// completing ``bytes`` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int t0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(t0), "r"(h), "r"(b)
      : "memory");
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

// --- wgmma ---------------------------------------------------------------------

// Descriptor of a 1024-aligned swizzled (rows, 64 bf16) tile: start address,
// leading byte offset and stride byte offset (1024 bytes, eight 128-byte
// rows) in 16-byte units, layout 1 = 128-byte swizzle. The leading offset is
// not read for the K-major reading; for the MN-major one it would step to a
// second 64-wide column block, which a 64-wide tile does not have.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}
// Step the K-major reading by 16 columns (32 bytes) within the swizzled row.
__device__ __forceinline__ uint64_t desc_kstep(uint64_t d, int k) { return d + 2 * k; }
// Step the MN-major reading by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_rowstep(uint64_t d, int k) { return d + 128 * k; }

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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VITX_WG_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
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

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of an accumulator's four 16-column slices, each value
// rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
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

// Error codes of the entry points beyond cudaError_t's range.
constexpr int ERR_NO_ENCODE = 10000;     // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 20000;    // + the CUresult of the encode
constexpr int ERR_ROUTE = 30000;         // a route asked for that the inputs cannot take

// The map of a bf16 (B, H, T, 64) view with element strides sb, sh, st (the
// last dim contiguous), boxes of (64 tokens, 64 channels) with the 128-byte
// swizzle and zeros past T. Returns 0 or one of the codes above.
inline int make_tile_map(CUtensorMap* map, const void* base, int B, int H, int T, long long sb,
                         long long sh, long long st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  bind_primary_context();
  const cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, TILE_ROWS, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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
