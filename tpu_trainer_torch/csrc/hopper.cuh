// Hopper (sm_90a) building blocks shared by the port's TMA/wgmma kernels
// (the bf16/fp16 flash forward in flash_attn.cu, the bf16/fp16 gmm in
// grouped_matmul.cu): mbarriers, TMA tile loads, wgmma shared-memory
// descriptors, the wgmma instructions in inline PTX, and the host-side
// encoding of a TMA tensor map through the function pointer that the CUDA
// runtime hands out for it (so the libraries need no -lcuda).
//
// Shared-memory operands use the 128-byte swizzle throughout: a TMA box
// whose inner extent is 64 16-bit elements (128 bytes) lands as rows of
// 128 bytes, XOR-swizzled in 1024-byte groups of 8 rows, which is the
// canonical layout wgmma reads (every tile base 1024-byte aligned).
// - K-major operand (consecutive along the reduction): rows of 64 k; one
//   k16 step is a 32-byte advance of the start address inside the row;
//   8-row groups 1024 bytes apart (SBO); LBO unused.
// - MN-major operand (consecutive along M or N; the transpose bit): each
//   k row holds 64 m/n; one k16 step is 16 rows = 2048 bytes; 8-k-row
//   groups 1024 bytes apart (SBO); 64-wide m/n chunks LBO bytes apart.
//
// Accumulator layout of wgmma m64nNk16 (f32): warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8 (g = lane / 4); for n8 block j,
// d[4j + 0..1] are (row 16w + g, cols 8j + 2 (lane % 4) + 0..1) and
// d[4j + 2..3] the same columns of row 16w + g + 8. A 16-bit A operand in
// registers for k16 step kk is the same pattern: {d[8kk + 2r],
// d[8kk + 2r + 1]} rounded into register r (r < 4), low half first.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

template <int N>
struct Shape {};
template <typename T>
struct Elem {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "1" as completed, so a producer's first wait on an
// empty slot with parity 1 passes).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA loads (zero-filled outside the tensor) ------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an in-flight wgmma reads or writes, so the compiler
// moves no access to them across the fence/wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two f32 values rounded into one register of 16-bit operands, the first
// in the low half.
__device__ __forceinline__ uint32_t pack2(Elem<__nv_bfloat16>, float a,
                                          float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(Elem<__half>, float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma_ss: D[64, N] (+)= A[64, 16] B[16, N], A and B in shared memory
// (descriptors; A K-major). wgmma_rs: the same with A in registers.
// TRANS_B: 0 for a K-major B, 1 for an MN-major B. scale_d 0 overwrites D.
// Each (shape, form) the kernels use is written once below, as a macro of
// the operand type (its PTX name and its C type), and stamped out for bf16
// and fp16.

// The f32 accumulators d[0, 32) or d[0, 64) as in-out asm operands, and
// their places %0.. in the instruction.
#define HOPPER_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_D16(i) \
  HOPPER_D4(i), HOPPER_D4(i + 4), HOPPER_D4(i + 8), HOPPER_D4(i + 12)
#define HOPPER_D32 HOPPER_D16(0), HOPPER_D16(16)
#define HOPPER_D64 HOPPER_D32, HOPPER_D16(32), HOPPER_D16(48)
#define HOPPER_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "                  \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "              \
  "%25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "                  \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "              \
  "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "              \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "              \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "              \
  "%61, %62, %63}"

// m64n128k16, A and B from shared memory (operands after d: %64 da,
// %65 db, %66 scale_d, %67 TRANS_B).
#define HOPPER_WGMMA_SS_N128(PTX, CT)                                        \
  template <int TRANS_B>                                                     \
  __device__ __forceinline__ void wgmma_ss(Shape<128>, Elem<CT>,             \
                                           float (&d)[64], uint64_t da,      \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %66, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX  \
                 " " HOPPER_R64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"          \
                 : HOPPER_D64                                                \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));           \
  }

// m64n64k16 and m64n128k16 with A in registers (operands after the
// accumulators: the four A registers, then db, scale_d, TRANS_B).
#define HOPPER_WGMMA_RS_N64(PTX, CT)                                         \
  template <int TRANS_B>                                                     \
  __device__ __forceinline__ void wgmma_rs(Shape<64>, Elem<CT>,              \
                                           float (&d)[32],                   \
                                           const uint32_t (&a)[4],           \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %37, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX   \
                 " " HOPPER_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, "     \
                 "%38;\n}\n"                                                 \
                 : HOPPER_D32                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(scale_d), "n"(TRANS_B));                              \
  }

#define HOPPER_WGMMA_RS_N128(PTX, CT)                                        \
  template <int TRANS_B>                                                     \
  __device__ __forceinline__ void wgmma_rs(Shape<128>, Elem<CT>,             \
                                           float (&d)[64],                   \
                                           const uint32_t (&a)[4],           \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %69, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX  \
                 " " HOPPER_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, "     \
                 "%70;\n}\n"                                                 \
                 : HOPPER_D64                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(scale_d), "n"(TRANS_B));                              \
  }

HOPPER_WGMMA_SS_N128("bf16", __nv_bfloat16)
HOPPER_WGMMA_SS_N128("f16", __half)
HOPPER_WGMMA_RS_N64("bf16", __nv_bfloat16)
HOPPER_WGMMA_RS_N64("f16", __half)
HOPPER_WGMMA_RS_N128("bf16", __nv_bfloat16)
HOPPER_WGMMA_RS_N128("f16", __half)

#undef HOPPER_WGMMA_RS_N128
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_SS_N128
#undef HOPPER_R64
#undef HOPPER_R32
#undef HOPPER_D64
#undef HOPPER_D32
#undef HOPPER_D16
#undef HOPPER_D4

}  // namespace hopper

// -- host side ---------------------------------------------------------------

namespace hopper_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled tensor map over a 16-bit tensor of `rank` dims (dims[0]
// innermost; strides in bytes of dims 1..rank-1), boxes of `box`
// elements, 128-byte swizzle, zeros outside the tensor.
inline cudaError_t make_map(CUtensorMap* map, bool fp16, int rank,
                            const void* base, const cuuint64_t* dims,
                            const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map,
      fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Streaming multiprocessors of the current device (a persistent grid's
// width).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

}  // namespace hopper_host
