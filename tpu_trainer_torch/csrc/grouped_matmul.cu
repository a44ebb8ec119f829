// Grouped (ragged) matmuls for dropless MoE on Hopper (sm_90a): gmm, the
// row groups of lhs times their own expert's weights, and tgmm, the
// per-group lhs^T dout (the weight gradient).
//
// Replaces the Pallas TPU kernels tpu_trainer/ops/grouped_matmul.py::
// _gmm_kernel (grouped_matmul.py:232, the pallas_call at :289) and
// ::_tgmm_kernel (:254, the pallas_call at :324). The Python wrappers are
// tpu_trainer_torch/ops/grouped_matmul.py::gmm_cuda and ::tgmm_cuda.
//
// Operands: lhs [G, K] rows sorted by group, group e owning rows
// [offsets[e], offsets[e + 1]) (offsets = [0, cumsum(group_sizes)], int32
// [E + 1] on the device: no host synchronisation); rhs [E, K, N] (or, with
// trans_rhs, [E, N, K] read as its transpose: the dgrad gmm(dout, rhs^T)
// takes the forward's weights as they are, with no transposed copy);
// out [G, N] in lhs's dtype, rows past offsets[E] zero. tgmm: lhs [G, H],
// dout [G, N] -> f32 [E, H, N], zero for an empty group.
//
// Bound on this card, at the MoE path's shapes (G = 16384 routed rows,
// H = 768, I = 3072, E = 8, bf16): 2*G*H*I = 77 GFLOP against ~60 MB of
// operands, ~1300 flops a byte, far above the H100's ~295 flops/byte
// balance point (989 TFLOP/s bf16 dense over 3.35 TB/s, NVIDIA data
// sheet): both kernels are bound by operations. chip_smoke.py computes the
// bounds from each run's group sizes (rows per group, not a padded
// capacity).
//
// Design (a plain first version; the TPU kernels walk a scalar-prefetched
// (tile, group) schedule on one core, which a GPU does not need):
// - gmm: one block per (128-row tile, 128-column tile) that owns its
//   output tile. Thread 0 finds the first group overlapping the tile's rows
//   by binary search in offsets; the block loops over the groups the tile
//   overlaps (one for a tile inside a group, more at a boundary), each
//   with the rows outside the group loaded as zeros, and accumulates all of
//   them in one f32 accumulator, written once. No atomics.
// - tgmm: one block per (expert, 128-row tile of H, 128-column tile of N),
//   walking its group's rows in 32-row chunks, rows past the group zero;
//   an empty group's block writes its zeros.
// - 16-bit inputs: nvcuda::wmma 16x16x16 fragments with f32 accumulators,
//   8 warps as 2 x 4, each warp a 64 x 32 sub-tile; operand tiles move
//   global -> shared with 16-byte loads into rows padded by 8 elements
//   (bank spread). f32 inputs: the same tiles with the products on the CUDA
//   cores, an 8 x 8 micro tile a thread (exact f32 fused multiply-adds).
//   K and N must be multiples of 8 (the wrappers check).
//
// Plain C interface (nvcc into a shared library, loaded with ctypes); each
// entry returns cudaGetLastError() after its launch, on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // output rows a block
constexpr int BN = 128;  // output columns a block
constexpr int BK = 32;   // reduction chunk
constexpr int NT = 256;  // threads a block (8 warps)
constexpr int PAD = 8;   // 16-bit shared rows padded by 8 elements

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// A [ROWS, COLS] tile of a row-major global matrix (ld elements a row) at
// (row0, col0) into shared memory; rows outside [r_lo, r_hi) and columns
// at or past c_hi read as zero. 16-byte loads, all of a thread's loads
// issued before its stores. TRANS: stored column by column
// (dst[c * dst_ld + r]), else row by row (dst[r * dst_ld + c]).
template <typename T, int ROWS, int COLS, bool TRANS>
__device__ __forceinline__ void load_tile(T* dst, int dst_ld, const T* src,
                                          size_t ld, int row0, int r_lo,
                                          int r_hi, int col0, int c_hi) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = COLS / kVec;
  constexpr int kN = ROWS * kPerRow;
  constexpr int kPer = (kN + NT - 1) / NT;
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / kPerRow;
    const int gr = row0 + r;
    const int gc = col0 + (e - r * kPerRow) * kVec;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kN && gr >= r_lo && gr < r_hi && gc < c_hi)
      v[i] = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(gr) * ld + gc);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e >= kN) continue;
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kVec;
    if (TRANS) {
      const T* x = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int t = 0; t < kVec; ++t) dst[(c + t) * dst_ld + r] = x[t];
    } else {
      *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = v[i];
    }
  }
}

// The block's [BM, BN] f32 accumulator for 16-bit inputs: warp w owns rows
// (w / 4) * 64 + [0, 64) and columns (w % 4) * 32 + [0, 32), 4 x 2
// fragments. A_COL: element (m, k) of A at A[k * lda + m], else
// A[m * lda + k]; B_COL: element (k, n) at B[n * ldb + k], else
// B[k * ldb + n].
template <typename T>
struct WmmaAcc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[4][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }

  template <bool A_COL, bool B_COL>
  __device__ __forceinline__ void step(const T* A, int lda, const T* B,
                                       int ldb) {
    using namespace nvcuda;
    using ALayout =
        typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16;
        wmma::load_matrix_sync(
            a[i], A_COL ? A + k0 * lda + row : A + row * lda + k0, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        wmma::load_matrix_sync(
            b[j], B_COL ? B + col * ldb + k0 : B + k0 * ldb + col, ldb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }

  // out[(m0 + m) * ld + n0 + n] for m0 + m < m_hi, n0 + n < n_hi, through
  // this warp's 256-float staging slice.
  template <typename O>
  __device__ __forceinline__ void store(O* out, size_t ld, int m0, int n0,
                                        int m_hi, int n_hi, float* stage) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
    float* st = stage + warp * 256;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        nvcuda::wmma::store_matrix_sync(st, c[i][j], 16,
                                        nvcuda::wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int e = lane * 8 + t;
          const int gm = m0 + wm * 64 + i * 16 + (e >> 4);
          const int gn = n0 + wn * 32 + j * 16 + (e & 15);
          if (gm < m_hi && gn < n_hi)
            out[static_cast<size_t>(gm) * ld + gn] = from_f32<O>(st[e]);
        }
        __syncwarp();
      }
  }
};

// The f32 accumulator: thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i and columns tx + 16 j (i, j < 8) of the tile, from A stored
// [BK][BM] and B stored [BK][BN] in shared memory.
struct SimtAcc {
  float c[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* A, const float* B) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[k * BM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <typename O>
  __device__ __forceinline__ void store(O* out, size_t ld, int m0, int n0,
                                        int m_hi, int n_hi, float*) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
        if (gm < m_hi && gn < n_hi)
          out[static_cast<size_t>(gm) * ld + gn] = from_f32<O>(c[i][j]);
      }
  }
};

template <typename T>
using AccOf = typename std::conditional<std::is_same<T, float>::value,
                                        SimtAcc, WmmaAcc<T>>::type;

// Shared memory of both kernels: the A and B tiles (16-bit: padded rows;
// f32: [BK][BM] and [BK][BN]) and the 16-bit epilogue's staging.
constexpr int kTileBytes = BK * BM * 4;  // >= 16-bit padded tiles
static_assert(BM * (BK + PAD) * 2 <= kTileBytes, "A tile");
static_assert(BN * (BK + PAD) * 2 <= kTileBytes, "B tile");
static_assert(BK * (BM + PAD) * 2 <= kTileBytes, "A tile (tgmm)");

template <typename T, bool B_TRANS>
__global__ void __launch_bounds__(NT)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ offsets, T* __restrict__ out, int G,
               int K, int N, int E) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  __shared__ __align__(128) unsigned char a_raw[kTileBytes];
  __shared__ __align__(128) unsigned char b_raw[kTileBytes];
  __shared__ __align__(128) float stage[8 * 256];
  __shared__ int first_group;
  T* As = reinterpret_cast<T*>(a_raw);
  T* Bs = reinterpret_cast<T*>(b_raw);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_end = min(m0 + BM, G);
  if (threadIdx.x == 0) {
    // The first group whose rows end past m0 (E when none does).
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (offsets[mid + 1] > m0) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    first_group = lo;
  }
  __syncthreads();

  AccOf<T> acc;
  acc.zero();
  for (int e = first_group; e < E; ++e) {
    const int g0 = offsets[e];
    if (g0 >= m_end) break;
    const int lo = max(g0, m0);
    const int hi = min(offsets[e + 1], m_end);
    if (lo >= hi) continue;  // an empty group
    const T* w = rhs + static_cast<size_t>(e) * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous chunk's readers are done
      if constexpr (kF32) {
        load_tile<T, BM, BK, true>(As, BM, lhs, K, m0, lo, hi, k0, K);
        if (B_TRANS) {
          load_tile<T, BN, BK, true>(Bs, BN, w, K, n0, 0, N, k0, K);
        } else {
          load_tile<T, BK, BN, false>(Bs, BN, w, N, k0, 0, K, n0, N);
        }
        __syncthreads();
        acc.step(As, Bs);
      } else {
        load_tile<T, BM, BK, false>(As, BK + PAD, lhs, K, m0, lo, hi, k0, K);
        if (B_TRANS) {
          load_tile<T, BN, BK, false>(Bs, BK + PAD, w, K, n0, 0, N, k0, K);
        } else {
          load_tile<T, BK, BN, false>(Bs, BN + PAD, w, N, k0, 0, K, n0, N);
        }
        __syncthreads();
        acc.template step<false, B_TRANS>(As, BK + PAD, Bs,
                                          B_TRANS ? BK + PAD : BN + PAD);
      }
    }
  }
  acc.store(out, N, m0, n0, G, N, stage);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ offsets, float* __restrict__ out,
                int G, int H, int N) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  __shared__ __align__(128) unsigned char a_raw[kTileBytes];
  __shared__ __align__(128) unsigned char b_raw[kTileBytes];
  __shared__ __align__(128) float stage[8 * 256];
  T* As = reinterpret_cast<T*>(a_raw);
  T* Bs = reinterpret_cast<T*>(b_raw);
  const int m0 = blockIdx.x * BM;  // rows of H
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int lo = min(offsets[e], G);
  const int hi = min(offsets[e + 1], G);

  AccOf<T> acc;
  acc.zero();
  for (int r0 = lo; r0 < hi; r0 += BK) {
    __syncthreads();  // the previous chunk's readers are done
    // A^T: the chunk's lhs rows [BK][BM] read as A (m = h, k = row).
    if constexpr (kF32) {
      load_tile<T, BK, BM, false>(As, BM, lhs, H, r0, lo, hi, m0, H);
      load_tile<T, BK, BN, false>(Bs, BN, dout, N, r0, lo, hi, n0, N);
      __syncthreads();
      acc.step(As, Bs);
    } else {
      load_tile<T, BK, BM, false>(As, BM + PAD, lhs, H, r0, lo, hi, m0, H);
      load_tile<T, BK, BN, false>(Bs, BN + PAD, dout, N, r0, lo, hi, n0, N);
      __syncthreads();
      acc.template step<true, false>(As, BM + PAD, Bs, BN + PAD);
    }
  }
  acc.store(out + static_cast<size_t>(e) * H * N, N, m0, n0, H, N, stage);
}

template <typename T>
struct TypeTag {
  using type = T;
};

template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(TypeTag<float>{});
    case 1:
      return f(TypeTag<__nv_bfloat16>{});
    case 2:
      return f(TypeTag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_dims(int G, int K, int N, int E) {
  return G <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 != 0 || N % 8 != 0 ||
         (N + BN - 1) / BN > 65535;
}

}  // namespace

// out [G, N] (lhs's dtype) = the row groups of lhs [G, K] times rhs[e]
// ([E, K, N]; trans_rhs: rhs [E, N, K] read as rhs[e]^T). offsets: int32
// [E + 1]. dtype: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int gmm_launch(const void* lhs, const void* rhs,
                          const void* offsets, void* out, int G, int K, int N,
                          int E, int dtype, int trans_rhs, void* stream) {
  if (bad_dims(G, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((G + BM - 1) / BM, (N + BN - 1) / BN);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int* off = static_cast<const int*>(offsets);
    if (trans_rhs) {
      gmm_kernel<T, true><<<grid, NT, 0, st>>>(
          static_cast<const T*>(lhs), static_cast<const T*>(rhs), off,
          static_cast<T*>(out), G, K, N, E);
    } else {
      gmm_kernel<T, false><<<grid, NT, 0, st>>>(
          static_cast<const T*>(lhs), static_cast<const T*>(rhs), off,
          static_cast<T*>(out), G, K, N, E);
    }
    return cudaGetLastError();
  }));
}

// out [E, H, N] f32 = per group e, lhs[rows of e]^T dout[rows of e]
// (lhs [G, H], dout [G, N]); zeros for an empty group.
extern "C" int tgmm_launch(const void* lhs, const void* dout,
                           const void* offsets, void* out, int G, int H,
                           int N, int E, int dtype, void* stream) {
  if (bad_dims(G, H, N, E) || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((H + BM - 1) / BM, (N + BN - 1) / BN, E);
  return static_cast<int>(by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    tgmm_kernel<T><<<grid, NT, 0, st>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(dout),
        static_cast<const int*>(offsets), static_cast<float*>(out), G, H, N);
    return cudaGetLastError();
  }));
}

extern "C" const char* gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
