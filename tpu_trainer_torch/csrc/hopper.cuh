// Hopper (sm_90a) building blocks shared by the port's TMA/wgmma kernels
// (the bf16/fp16 flash forward and backwards in flash_attn.cu, the bf16/fp16
// gmm and tgmm in grouped_matmul.cu, the head + CE forward in head_ce.cu):
// mbarriers, TMA tile loads and stores, 1-D bulk copies and bulk f32
// reductions, the fixed-order accumulation across blocks (Turn, the fused
// backward's dq), warpgroup register reallocation, transposed 8x8 matrix
// stores (stmatrix), wgmma shared-memory descriptors, the wgmma
// instructions in inline PTX, and the host-side encoding of a TMA tensor
// map through the function pointer that the CUDA runtime hands out for it
// (so the libraries need no -lcuda).
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
// empty slot with parity 1 passes). The loop is inside the PTX, so the
// compiler sees no data-dependent branch around the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
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

// -- TMA store (clipped at the tensor's edges) -------------------------------

// The box at {c0, c1} of a 2-D tensor map from shared memory at `src`
// (laid out as the map's swizzle says); tracked by the issuing thread's bulk
// groups (bulk_commit, then bulk_wait_read before `src` is written again).
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// -- 1-D bulk copies and reductions ------------------------------------------

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing as transactions on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] over `bytes` of f32 (a multiple of 16), shared to global,
// performed by the memory system as one bulk operation; tracked by the
// issuing thread's bulk groups.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the thread's bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until the thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, bulk copies out of shared memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for global memory: orders the async proxy's global writes (a
// completed bulk reduction) against this thread's generic-proxy accesses
// around it (the release and acquire of a Turn).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Named barrier over `threads` threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- fixed-order accumulation across blocks ----------------------------------
//
// Several blocks add their f32 parts into one region of global memory, each
// with a rank 0, 1, 2, ... that the work's shape fixes. A Turn is an int32
// counter in global memory for that region, zeroed before the kernel; the
// part of rank r is added after the parts 0..r-1 and before r+1, so the sum
// is bitwise the same from run to run. One thread calls wait(r), the adds
// are issued and completed (a bulk reduction waited with bulk_wait(), or
// plain stores ordered by a barrier of the threads that made them), and the
// same thread calls pass().
//
// Deadlock freedom is the caller's: a waiting block must wait only on ranks
// held by blocks of a lower linear block index, which were dispatched
// before it, so the earliest unfinished rank can always proceed. Blocks
// that are not yet resident give no such guarantee: a persistent grid
// that assumes all of its blocks are on the card at once must not wait.
struct Turn {
  int* counter;

  // Spins (acquire, gpu scope) until `rank` parts have been added.
  __device__ __forceinline__ void wait(int rank) const {
    int v;
    do {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(counter)
                   : "memory");
    } while (v != rank);
    fence_proxy_async_global();
  }

  // This rank's adds are complete: hands the region to the next rank
  // (release, gpu scope).
  __device__ __forceinline__ void pass() const {
    fence_proxy_async_global();
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
  }
};

// Warpgroup register reallocation: the whole warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit values stored transposed: register i of each
// thread holds its pair of matrix i in the mma fragment layout (row lane /
// 4, columns 2 (lane % 4) + 0..1, low half first), and lane 8 i + r gives
// the address of row r of matrix i as stored, i.e. of the 16 bytes that
// receive the matrix's column r.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
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
// (descriptors). wgmma_rs: the same with A in registers. TRANS_B: 0 for a
// K-major B, 1 for an MN-major B; TRANS_A likewise for A in shared memory.
// scale_d 0 overwrites D.
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
#define HOPPER_D128 \
  HOPPER_D64, HOPPER_D16(64), HOPPER_D16(80), HOPPER_D16(96), HOPPER_D16(112)
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

#define HOPPER_R128                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127}"

// m64n64k16, m64n128k16 and m64n256k16, A and B from shared memory
// (operands after the accumulators: da, db, scale_d, TRANS_A, TRANS_B).
#define HOPPER_WGMMA_SS_N64(PTX, CT)                                         \
  template <int TRANS_B, int TRANS_A = 0>                                    \
  __device__ __forceinline__ void wgmma_ss(Shape<64>, Elem<CT>,              \
                                           float (&d)[32], uint64_t da,      \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %34, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX   \
                 " " HOPPER_R32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"        \
                 : HOPPER_D32                                                \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),            \
                   "n"(TRANS_B));                                            \
  }

#define HOPPER_WGMMA_SS_N128(PTX, CT)                                        \
  template <int TRANS_B, int TRANS_A = 0>                                    \
  __device__ __forceinline__ void wgmma_ss(Shape<128>, Elem<CT>,             \
                                           float (&d)[64], uint64_t da,      \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %66, 0;\n"                                  \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX  \
                 " " HOPPER_R64 ", %64, %65, p, 1, 1, %67, %68;\n}\n"        \
                 : HOPPER_D64                                                \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),            \
                   "n"(TRANS_B));                                            \
  }

#define HOPPER_WGMMA_SS_N256(PTX, CT)                                        \
  template <int TRANS_B, int TRANS_A = 0>                                    \
  __device__ __forceinline__ void wgmma_ss(Shape<256>, Elem<CT>,             \
                                           float (&d)[128], uint64_t da,     \
                                           uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, %130, 0;\n"                                 \
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTX "." PTX  \
                 " " HOPPER_R128 ", %128, %129, p, 1, 1, %131, %132;\n}\n"   \
                 : HOPPER_D128                                               \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A),            \
                   "n"(TRANS_B));                                            \
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

HOPPER_WGMMA_SS_N64("bf16", __nv_bfloat16)
HOPPER_WGMMA_SS_N64("f16", __half)
HOPPER_WGMMA_SS_N128("bf16", __nv_bfloat16)
HOPPER_WGMMA_SS_N128("f16", __half)
HOPPER_WGMMA_SS_N256("bf16", __nv_bfloat16)
HOPPER_WGMMA_SS_N256("f16", __half)
HOPPER_WGMMA_RS_N64("bf16", __nv_bfloat16)
HOPPER_WGMMA_RS_N64("f16", __half)
HOPPER_WGMMA_RS_N128("bf16", __nv_bfloat16)
HOPPER_WGMMA_RS_N128("f16", __half)

#undef HOPPER_WGMMA_RS_N128
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_SS_N256
#undef HOPPER_WGMMA_SS_N128
#undef HOPPER_WGMMA_SS_N64
#undef HOPPER_R128
#undef HOPPER_R64
#undef HOPPER_R32
#undef HOPPER_D128
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
