// Causal flash attention for training on Hopper (sm_90a): the forward with
// fused RoPE, counter-based attention dropout and packed-sequence segment
// ids, the fused backward, the split backward (a dk/dv kernel and a dq
// kernel, segment-aware), and a dump of the dropout keep mask.
//
// Replaces the Pallas TPU kernels tpu_trainer/ops/flash.py::_fwd_kernel
// (flash.py:250, the pallas_call at :543), ::_bwd_fused_kernel
// (flash.py:577, the pallas_call at :1167), ::_bwd_dkv_kernel (flash.py:762,
// the pallas_call at :1114) and ::_bwd_dq_kernel (flash.py:892, the
// pallas_call at :1146), and the test-only mask dump
// tpu_trainer/validate.py::kern (validate.py:65). The Python wrappers are
// tpu_trainer_torch/ops/flash.py::flash_attention (an autograd.Function),
// ::flash_backward_dkv, ::flash_backward_dq and ::keep_mask_cuda.
//
// Bound on this card, at the training shape (b=8, s=1024, 12 heads of 64,
// causal): the forward does 4*d flops per causal (q, k) pair per head
// against q/k/v read and o and the rotated q/k written, 2 bytes an
// element: ~170 flops a byte, under the H100's ~295 flops/byte balance
// point for bf16 tensor cores (989 TFLOP/s over 3.35 TB/s, NVIDIA data
// sheet), so its least time is set by bytes. The backward does 10*d flops
// a pair (the split pair 14*d: both kernels recompute S and dP) against
// ~8 such tensors and sits on the operations side. With segment ids the
// pairs are those inside one document. chip_smoke.py computes the bounds
// from each run's shapes and segments.
//
// Design:
// - One thread block per (q tile, head, batch) in the forward and in the
//   split dq kernel, walking the causally needed k tiles in a loop (the
//   TPU walks a sequential grid axis); one block per (k tile, head, batch)
//   in the fused backward and the split dk/dv kernel, walking the q tiles
//   at or below the diagonal. Tiles are 64x64 for bf16/fp16 and 32x32 for
//   f32 (shared memory), the ragged edge (s not a multiple of the tile)
//   masked in the kernel, so every s runs here.
// - The products QK^T, PV, dO V^T, P^T dO, dS^T Q and dS K run on the tensor
//   cores through nvcuda::wmma 16x16x16 bf16/fp16 fragments with f32
//   accumulators, operands staged in shared memory; f32 inputs take the
//   same structure with the products on the CUDA cores (exact f32). The
//   online softmax, masking, dropout and RoPE are scalar f32 code over the
//   f32 score tile in shared memory.
// - RoPE as in flash.py:195-214: f32 rotation, 1/sqrt(d) folded into q,
//   cast to the compute type. A prologue pass of the forward call rotates
//   q and k once and writes them as the backward's residuals (flash.py:
//   275-280); the flash kernel reads its tiles from them, so no k tile is
//   rotated again by every q tile that reads it. The backward un-rotates
//   dq and dk (flash.py:217-223).
// - Tiles move global -> shared with 16-byte loads, each thread's loads
//   issued together before its stores (one memory latency a tile, not one
//   an element).
// - Dropout: the keep test is dropout_hash::keep over global positions
//   (csrc/dropout_hash.cuh), salt batch * heads + head: bitwise the masks
//   of the JAX kernel in interpret mode, in every kernel. The softmax
//   normaliser sums the undropped weights; o = acc / (l * (1 - rate)).
// - Segment ids (int32 [b, s], 0 = padding) as flash.py:226-242 and
//   :432-458: a tile pair whose q rows and k columns share no segment id
//   interval ([min, max] of each tile, computed by every warp from the ids
//   in shared memory) is skipped, as the causal skip skips tiles above the
//   diagonal; the others mask element by element. Masked scores take
//   -1e30, not -inf, when segments are on (flash.py:79-90): a q row whose
//   first processed k tile lies wholly in another segment then keeps a
//   finite running max, and the first tile with a valid column wipes the
//   garbage through alpha = exp(-1e30 - m) = 0. Every row attends to
//   itself, so its diagonal tile always has a valid column.
// - The TPU's fused kernel keeps the whole dq row resident across
//   sequential grid steps (flash.py:698-747). Blocks here run in no order,
//   so the fused kernel adds its dq contribution into a zeroed f32 buffer
//   with atomicAdd and a small pass un-rotates and casts it (the summation
//   order of dq changes from run to run). The split pair recomputes S and
//   dP in each kernel (7 products a tile pair, not 5) but needs no atomics:
//   the dq kernel owns its q tile, accumulates dq in registers over its
//   k-tile walk, un-rotates and writes it once, deterministic. dk and dv
//   are owned by one block in both backwards, accumulate in registers over
//   the q-tile walk and are deterministic. One f32 shared region serves in
//   turn as S and dP, the tile's dQ part and the dK/dV (dQ) staging, so
//   two backward blocks fit an SM at d <= 128.
// - GQA: kv head = head / group (flash.py:516-525). The backwards write f32
//   per-query-head dk/dv partials; the wrapper group-sums and rounds once.
//
// Plain C interface (nvcc into a shared library, loaded with ctypes); each
// entry returns cudaGetLastError() after its launches, on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[M, N] (f32, row-major, ldc) = or += A[M, K] * B[K, N], all in shared
// memory. A_COL: A stored column-major (element (m, k) at A[k * lda + m]);
// B_COL: element (k, n) at B[n * ldb + k]. M, N, K multiples of 16. The
// whole block calls it; each warp owns whole 16x16 output fragments.
template <typename T, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void tile_mma(const T* A, int lda, const T* B,
                                         int ldb, float* C, int ldc, int M,
                                         int N, int K) {
  if constexpr (std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
      const int m = e / N;
      const int n = e - m * N;
      float c = ACC ? C[m * ldc + n] : 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? A[k * lda + m] : A[m * lda + k];
        const float b = B_COL ? B[n * ldb + k] : B[k * ldb + n];
        c = fmaf(a, b, c);
      }
      C[m * ldc + n] = c;
    }
  } else {
    using namespace nvcuda;
    using ALayout =
        typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int tn = N / 16;
    const int frags = (M / 16) * tn;
    for (int f = warp; f < frags; f += nwarps) {
      const int i = f / tn;
      const int j = f - i * tn;
      float* cp = C + i * 16 * ldc + j * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC) {
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
        const T* ap = A_COL ? A + k0 * lda + i * 16 : A + i * 16 * lda + k0;
        const T* bp = B_COL ? B + j * 16 * ldb + k0 : B + k0 * ldb + j * 16;
        wmma::load_matrix_sync(a, ap, lda);
        wmma::load_matrix_sync(b, bp, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
}

// An [M, N] f32 tile accumulated in registers across calls (the
// backward's dK and dV over its q-tile loop): each warp owns whole 16x16
// WMMA fragments (f32 inputs: each thread owns M*N/NT elements).
template <typename T, int M, int N, int NT>
struct Acc {
  static constexpr int kWarps = NT / 32;
  static constexpr int kFrags = (M / 16) * (N / 16) / kWarps;
  static_assert((M / 16) * (N / 16) % kWarps == 0, "fragments per warp");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[kFrags];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kFrags; ++i) nvcuda::wmma::fill_fragment(f[i], 0.f);
  }

  // this += A[M, K] * B[K, N] (layouts as tile_mma's).
  template <bool A_COL, bool B_COL>
  __device__ __forceinline__ void mma(const T* A, int lda, const T* B,
                                      int ldb, int K) {
    using namespace nvcuda;
    using ALayout =
        typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using BLayout =
        typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kFrags; ++i) {
      const int fi = warp + i * kWarps;
      const int r = fi / (N / 16);
      const int c = fi - r * (N / 16);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> b;
        wmma::load_matrix_sync(
            a, A_COL ? A + k0 * lda + r * 16 : A + r * 16 * lda + k0, lda);
        wmma::load_matrix_sync(
            b, B_COL ? B + c * 16 * ldb + k0 : B + k0 * ldb + c * 16, ldb);
        wmma::mma_sync(f[i], a, b, f[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kFrags; ++i) {
      const int fi = warp + i * kWarps;
      const int r = fi / (N / 16);
      const int c = fi - r * (N / 16);
      nvcuda::wmma::store_matrix_sync(C + r * 16 * ldc + c * 16, f[i], ldc,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

template <int M, int N, int NT>
struct Acc<float, M, N, NT> {
  static constexpr int kPer = M * N / NT;
  static_assert(M * N % NT == 0, "elements per thread");
  float v[kPer];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = 0.f;
  }

  template <bool A_COL, bool B_COL>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B,
                                      int ldb, int K) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * NT;
      const int m = e / N;
      const int n = e - m * N;
      float c = v[i];
      for (int k = 0; k < K; ++k)
        c = fmaf(A_COL ? A[k * lda + m] : A[m * lda + k],
                 B_COL ? B[n * ldb + k] : B[k * ldb + n], c);
      v[i] = c;
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * NT;
      C[(e / N) * ldc + e % N] = v[i];
    }
  }
};

// RoPE of element c of a row x (stride-1 over d), f32, rounded like the
// plain PyTorch version: (x * cos + rotate_half(x) * sin), no FMA
// contraction.
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* x, int c, float cs,
                                           float sn) {
  const float xv = to_f32(x[c]);
  const float xr = c < D / 2 ? -to_f32(x[c + D / 2]) : to_f32(x[c - D / 2]);
  return __fadd_rn(__fmul_rn(xv, cs), __fmul_rn(xr, sn));
}

// The rotation's transpose applied to a gradient row g (f32):
// g * cos + rotate_half^T(g * sin), rotate_half^T([a, b]) = [b, -a].
template <int D>
__device__ __forceinline__ float unrope_elem(const float* g, int c,
                                             const float* cos_row,
                                             const float* sin_row) {
  const float rt = c < D / 2 ? __fmul_rn(g[c + D / 2], sin_row[c + D / 2])
                             : -__fmul_rn(g[c - D / 2], sin_row[c - D / 2]);
  return __fadd_rn(__fmul_rn(g[c], cos_row[c]), rt);
}

// Copy rows [row0, row0 + ROWS) of one head of [b, s, heads, D] tensors
// into shared memory ([ROWS, D], zeros past s): 16-byte loads, all of a
// thread's loads issued before its stores so their latencies overlap. A
// second tensor of the same geometry (src_b) rides along when given.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tiles(T* dst_a, const T* src_a, T* dst_b,
                                           const T* src_b, size_t head_base,
                                           int row0, int s, int heads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kN = ROWS * kPerRow;
  constexpr int kPer = (kN + NT - 1) / NT;
  uint4 ra[kPer], rb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / kPerRow;
    ra[i] = make_uint4(0u, 0u, 0u, 0u);
    rb[i] = ra[i];
    if (e < kN && row0 + r < s) {
      const size_t off = head_base +
                         static_cast<size_t>(row0 + r) * heads * D +
                         (e - r * kPerRow) * kVec;
      ra[i] = *reinterpret_cast<const uint4*>(src_a + off);
      if (src_b != nullptr) rb[i] = *reinterpret_cast<const uint4*>(src_b + off);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < kN) {
      *reinterpret_cast<uint4*>(dst_a + e * kVec) = ra[i];
      if (dst_b != nullptr) *reinterpret_cast<uint4*>(dst_b + e * kVec) = rb[i];
    }
  }
}

// Segment ids of rows [row0, row0 + N) of one batch row into shared memory
// (rows past s are not read; the element masks test row < s themselves).
template <int N>
__device__ __forceinline__ void load_seg(int* seg_s, const int* seg, int row0,
                                         int s) {
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    seg_s[i] = row0 + i < s ? seg[row0 + i] : 0;
}

// [min, max] of the first n ids in shared memory, computed by each warp on
// its own (so every thread holds it and a skip is uniform over the block).
__device__ __forceinline__ int2 seg_range(const int* seg_s, int n) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    lo = min(lo, seg_s[i]);
    hi = max(hi, seg_s[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// Some q row of [q0, q0 + nq) may share a segment with some k column of
// [k0, k0 + nk): the interval test of flash.py::_seg_predicates, sound for
// any id layout (equal ids force overlapping intervals).
__device__ __forceinline__ bool seg_overlap(const int* qseg_s, int nq,
                                            const int* kseg_s, int nk) {
  const int2 q = seg_range(qseg_s, nq);
  const int2 k = seg_range(kseg_s, nk);
  return q.x <= k.y && k.x <= q.y;
}

// The forward's residuals, once per call: qs = RoPE(q) * scale (q * scale
// without RoPE) and ks = RoPE(k), f32 math cast to T (flash.py:195-214).
// One thread an element of q, then of k (nk = 0 without RoPE).
template <typename T, int D>
__global__ void rope_prep_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const float* __restrict__ cos,
                                 const float* __restrict__ sin,
                                 T* __restrict__ qs, T* __restrict__ ks,
                                 size_t nq, size_t nk, int s, int h, int kvh,
                                 float scale) {
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < nq + nk; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const bool is_q = idx < nq;
    const size_t i = is_q ? idx : idx - nq;
    const T* src = is_q ? q : k;
    const int heads = is_q ? h : kvh;
    const int c = static_cast<int>(i % D);
    const int row = static_cast<int>((i / (static_cast<size_t>(heads) * D)) % s);
    const float x = cos != nullptr
                        ? rope_elem<T, D>(src + (i - c), c, cos[row * D + c],
                                          sin[row * D + c])
                        : to_f32(src[i]);
    if (is_q) {
      qs[i] = from_f32<T>(__fmul_rn(x, scale));
    } else {
      ks[i] = from_f32<T>(x);
    }
  }
}

struct FwdParams {
  const void* q;      // [b, s, h, D]
  const void* k;      // [b, s, kvh, D]
  const void* v;      // [b, s, kvh, D]
  const float* cos;   // [s, D] or null (no RoPE)
  const float* sin;   // [s, D] or null
  void* o;            // [b, s, h, D]
  float* lse;         // [b, h, s]
  void* qs;           // [b, s, h, D]: RoPE'd q times scale
  void* ks;           // [b, s, kvh, D]: RoPE'd k (only with RoPE)
  const int* seg;     // [b, s] segment ids or null (no segments)
  int b, s, h, kvh, causal, dropout;
  float scale, keep_prob;
  uint32_t seed, threshold;
};

// The value of a masked score: -inf without segments, the finite _SEG_MASK
// with them (see the segment note at the top).
constexpr float kSegMask = -1e30f;

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_kernel(FwdParams p) {
  constexpr int BQ = BT;
  constexpr int BK = BT;
  const int iq = blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int s = p.s, h = p.h, kvh = p.kvh;
  const int group = h / kvh;
  const int ikv = ih / group;
  const int q0 = iq * BQ;
  const T* qs = static_cast<const T*>(p.qs);
  // k tiles: the prologue's rotated k with RoPE, k itself without.
  const T* kt = static_cast<const T*>(p.cos != nullptr ? p.ks : p.k);
  const T* v = static_cast<const T*>(p.v);
  const uint32_t key = dropout_hash::stream_key(
      p.seed, static_cast<uint32_t>(ib * h + ih));

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);           // [BQ, D]
  T* k_s = q_s + BQ * D;                             // [BK, D]
  T* v_s = k_s + BK * D;                             // [BK, D]
  T* p_s = v_s + BK * D;                             // [BQ, BK]
  float* s_s = reinterpret_cast<float*>(p_s + BQ * BK);  // [BQ, BK]
  float* o_s = s_s + BQ * BK;                        // [BQ, D]
  float* m_s = o_s + BQ * D;                         // [BQ]
  float* l_s = m_s + BQ;                             // [BQ]
  float* a_s = l_s + BQ;                             // [BQ]
  int* qseg_s = reinterpret_cast<int*>(a_s + BQ);    // [BQ]
  int* kseg_s = qseg_s + BQ;                         // [BK]
  const int* seg =
      p.seg != nullptr ? p.seg + static_cast<size_t>(ib) * s : nullptr;
  const float mask_val = seg != nullptr ? kSegMask : -INFINITY;

  // q tile: the prologue's rotated and scaled q.
  load_tiles<T, D, BQ, kFwdThreads>(
      q_s, qs, nullptr, nullptr,
      (static_cast<size_t>(ib) * s * h + ih) * D, q0, s, h);
  if (seg != nullptr) load_seg<BQ>(qseg_s, seg, q0, s);
  for (int e = tid; e < BQ * D; e += blockDim.x) o_s[e] = 0.f;
  for (int r = tid; r < BQ; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int nk = (s + BK - 1) / BK;
  const int jend = p.causal ? min(iq + 1, nk) : nk;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers of k_s / v_s are done
    if (seg != nullptr) {
      load_seg<BK>(kseg_s, seg, k0, s);
      __syncthreads();
      if (!seg_overlap(qseg_s, min(BQ, s - q0), kseg_s, min(BK, s - k0)))
        continue;
    }
    load_tiles<T, D, BK, kFwdThreads>(
        k_s, kt, v_s, v, (static_cast<size_t>(ib) * s * kvh + ikv) * D, k0,
        s, kvh);
    __syncthreads();

    tile_mma<T, false, true, false>(q_s, D, k_s, D, s_s, BK, BQ, BK, D);
    __syncthreads();

    // Mask, online softmax over the undropped weights, dropout on p.
    for (int r = warp; r < BQ; r += nwarps) {
      const int row = q0 + r;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        const int col = k0 + c;
        const bool valid = col < s && (!p.causal || col <= row) &&
                           (seg == nullptr || qseg_s[r] == kseg_s[c]);
        const float sv = valid ? s_s[r * BK + c] : mask_val;
        s_s[r * BK + c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const int col = k0 + c;
        float pv = expf(s_s[r * BK + c] - m_new);
        sum += pv;
        if (p.dropout &&
            !dropout_hash::keep(key, static_cast<uint32_t>(row),
                                static_cast<uint32_t>(col),
                                static_cast<uint32_t>(s), p.threshold))
          pv = 0.f;
        p_s[r * BK + c] = from_f32<T>(pv);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += blockDim.x) o_s[e] *= a_s[e / D];
    __syncthreads();
    tile_mma<T, false, false, true>(p_s, BK, v_s, D, o_s, D, BQ, D, BK);
  }
  __syncthreads();

  T* o = static_cast<T*>(p.o);
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = q0 + r;
    if (row < s) {
      const float denom = p.dropout ? l_s[r] * p.keep_prob : l_s[r];
      o[((static_cast<size_t>(ib) * s + row) * h + ih) * D + c] =
          from_f32<T>(o_s[e] / denom);
    }
  }
  for (int r = tid; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    if (row < s)
      p.lse[(static_cast<size_t>(ib) * h + ih) * s + row] =
          m_s[r] + logf(l_s[r]);
  }
}

// delta[b, h, s] = rowsum(dO * O) in f32: one warp per (b, s, h) row.
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, int b, int s, int h) {
  const int warps = blockDim.x >> 5;
  const size_t rowi = static_cast<size_t>(blockIdx.x) * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (rowi >= static_cast<size_t>(b) * s * h) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += to_f32(o[rowi * D + c]) * to_f32(dout[rowi * D + c]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int ih = static_cast<int>(rowi % h);
    const size_t bs = rowi / h;
    const int row = static_cast<int>(bs % s);
    const int ib = static_cast<int>(bs / s);
    delta[(static_cast<size_t>(ib) * h + ih) * s + row] = acc;
  }
}

// Floats of the backward's shared f32 region: S and dP, or one dQ part,
// or one of dK / dV at the end.
template <int D, int BT>
__host__ __device__ constexpr int bwd_f32_region() {
  return 2 * BT * BT > BT * D ? 2 * BT * BT : BT * D;
}

struct BwdParams {
  const void* qs;     // [b, s, h, D]: the forward's scaled (RoPE'd) q
  const void* ks;     // [b, s, kvh, D]: RoPE'd k (or k without RoPE)
  const void* v;      // [b, s, kvh, D]
  const void* dout;   // [b, s, h, D]
  const float* lse;   // [b, h, s]
  const float* delta; // [b, h, s]
  const float* cos;   // [s, D] or null
  const float* sin;   // [s, D] or null
  const int* seg;     // [b, s] segment ids or null
  float* dq_acc;      // fused: [b, s, h, D] f32, zeroed: scaled-space dq
  void* dq;           // split dq kernel: [b, s, h, D] in T
  float* dk;          // [b, s, h, D] f32 per-query-head partials
  float* dv;          // [b, s, h, D] f32 per-query-head partials
  int b, s, h, kvh, causal, dropout;
  float scale, keep_prob;
  uint32_t seed, threshold;
};

// One (q tile, k tile) pair's score gradients from S = Q K^T and dP = dO
// V^T in the f32 region: P = exp(S - lse) (0 where masked), dropped P into
// pd_s (when given) and dS = P (dP' - delta) into ds_s, dP' = dP masked and
// divided by 1 - rate under dropout. The masked score of the TPU kernels
// (-inf or -1e30) gives exp(.) = 0 in f32 either way.
template <typename T, int BQ, int BK>
__device__ __forceinline__ void score_grads(
    const BwdParams& p, const float* s_s, const float* dp_s,
    const float* lse_s, const float* dl_s, const int* qseg_s,
    const int* kseg_s, T* pd_s, T* ds_s, int q0, int k0, uint32_t key) {
  const int s = p.s;
  for (int e = threadIdx.x; e < BQ * BK; e += blockDim.x) {
    const int r = e / BK;
    const int c = e - r * BK;
    const int row = q0 + r;
    const int col = k0 + c;
    const bool valid = row < s && col < s && (!p.causal || col <= row) &&
                       (p.seg == nullptr || qseg_s[r] == kseg_s[c]);
    const float pv = valid ? expf(s_s[e] - lse_s[r]) : 0.f;
    float dpv = dp_s[e];
    float pdv = pv;
    if (p.dropout) {
      const bool kp = dropout_hash::keep(
          key, static_cast<uint32_t>(row), static_cast<uint32_t>(col),
          static_cast<uint32_t>(s), p.threshold);
      pdv = kp ? pv : 0.f;
      dpv = kp ? dpv / p.keep_prob : 0.f;
    }
    if (pd_s != nullptr) pd_s[e] = from_f32<T>(pdv);
    ds_s[e] = from_f32<T>(pv * (dpv - dl_s[r]));
  }
}

// lse and delta of q rows [q0, q0 + BQ) of one (batch, head).
template <int BQ>
__device__ __forceinline__ void load_rows(const BwdParams& p, float* lse_s,
                                          float* dl_s, int ib, int ih,
                                          int q0) {
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    const size_t off = (static_cast<size_t>(ib) * p.h + ih) * p.s + row;
    lse_s[r] = row < p.s ? p.lse[off] : INFINITY;
    dl_s[r] = row < p.s ? p.delta[off] : 0.f;
  }
}

// One block per (k tile, head, batch), walking the q tiles at or below the
// diagonal; dK and dV in registers. DQ: the fused backward, which also adds
// each q tile's dQ part into dq_acc with atomics. Without DQ: the split
// backward's dk/dv kernel (tpu_trainer/ops/flash.py::_bwd_dkv_kernel).
template <typename T, int D, int BT, bool DQ>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_kernel(BwdParams p) {
  constexpr int BQ = BT;
  constexpr int BK = BT;
  const int jk = blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = p.s, h = p.h, kvh = p.kvh;
  const int group = h / kvh;
  const int ikv = ih / group;
  const int k0 = jk * BK;
  const T* qs = static_cast<const T*>(p.qs);
  const T* ks = static_cast<const T*>(p.ks);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const uint32_t key = dropout_hash::stream_key(
      p.seed, static_cast<uint32_t>(ib * h + ih));
  const int* seg =
      p.seg != nullptr ? p.seg + static_cast<size_t>(ib) * s : nullptr;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BK, D]
  T* v_s = k_s + BK * D;                    // [BK, D]
  T* q_s = v_s + BK * D;                    // [BQ, D]
  T* do_s = q_s + BQ * D;                   // [BQ, D]
  T* pd_s = do_s + BQ * D;                  // [BQ, BK] dropped p
  T* ds_s = pd_s + BQ * BK;                 // [BQ, BK] dS
  // One f32 region, used in turn as S and dP, as this q tile's dQ part,
  // and at the end as the staging of dK and then dV.
  float* f_s = reinterpret_cast<float*>(ds_s + BQ * BK);
  float* s_s = f_s;                         // [BQ, BK]
  float* dp_s = f_s + BQ * BK;              // [BQ, BK]
  float* dq_s = f_s;                        // [BQ, D]
  float* lse_s = f_s + bwd_f32_region<D, BT>();  // [BQ]
  float* dl_s = lse_s + BQ;                 // [BQ]
  int* qseg_s = reinterpret_cast<int*>(dl_s + BQ);  // [BQ]
  int* kseg_s = qseg_s + BQ;                // [BK]

  // dK and dV accumulate in registers over the whole q-tile walk.
  Acc<T, BK, D, kBwdThreads> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  load_tiles<T, D, BK, kBwdThreads>(
      k_s, ks, v_s, v, (static_cast<size_t>(ib) * s * kvh + ikv) * D, k0, s,
      kvh);
  if (seg != nullptr) load_seg<BK>(kseg_s, seg, k0, s);

  const int nq = (s + BQ - 1) / BQ;
  for (int i = p.causal ? jk : 0; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();  // the previous q tile's readers (of dq_s too) are done
    if (seg != nullptr) {
      load_seg<BQ>(qseg_s, seg, q0, s);
      __syncthreads();
      if (!seg_overlap(qseg_s, min(BQ, s - q0), kseg_s, min(BK, s - k0)))
        continue;
    }
    load_tiles<T, D, BQ, kBwdThreads>(
        q_s, qs, do_s, dout, (static_cast<size_t>(ib) * s * h + ih) * D, q0,
        s, h);
    load_rows<BQ>(p, lse_s, dl_s, ib, ih, q0);
    __syncthreads();

    tile_mma<T, false, true, false>(q_s, D, k_s, D, s_s, BK, BQ, BK, D);
    tile_mma<T, false, true, false>(do_s, D, v_s, D, dp_s, BK, BQ, BK, D);
    __syncthreads();
    score_grads<T, BQ, BK>(p, s_s, dp_s, lse_s, dl_s, qseg_s, kseg_s, pd_s,
                           ds_s, q0, k0, key);
    __syncthreads();

    // dV += P_drop^T dO; dK += dS^T Q (q already carries 1/sqrt(d)).
    dv_acc.template mma<true, false>(pd_s, BK, do_s, D, BQ);
    dk_acc.template mma<true, false>(ds_s, BK, q_s, D, BQ);
    if constexpr (DQ) {
      // dQ_part = dS K into the f32 region (S and dP are consumed).
      tile_mma<T, false, false, false>(ds_s, BK, k_s, D, dq_s, D, BQ, D, BK);
      __syncthreads();
      for (int e = tid; e < BQ * D; e += blockDim.x) {
        const int r = e / D;
        const int c = e - r * D;
        const int row = q0 + r;
        if (row < s)
          atomicAdd(&p.dq_acc[((static_cast<size_t>(ib) * s + row) * h + ih) *
                                  D + c],
                    dq_s[e] * p.scale);
      }
    }
  }

  // dK (un-rotated) then dV (/(1 - rate)) through the f32 region.
  const bool rope = p.cos != nullptr;
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
    (which == 0 ? dk_acc : dv_acc).store(f_s, D);
    __syncthreads();
    float* out = which == 0 ? p.dk : p.dv;
    for (int e = tid; e < BK * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int row = k0 + r;
      if (row >= s) continue;
      float g = f_s[e];
      if (which == 0 && rope)
        g = unrope_elem<D>(f_s + r * D, c, p.cos + row * D, p.sin + row * D);
      if (which == 1 && p.dropout) g /= p.keep_prob;
      out[((static_cast<size_t>(ib) * s + row) * h + ih) * D + c] = g;
    }
  }
}

// The split backward's dq kernel (tpu_trainer/ops/flash.py::_bwd_dq_kernel):
// one block per (q tile, head, batch) walking the causally needed k tiles,
// dQ = sum over k tiles of dS K in registers, scaled, un-rotated and
// written once in T: no atomics, deterministic.
template <typename T, int D, int BT>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int BQ = BT;
  constexpr int BK = BT;
  const int iq = blockIdx.x;
  const int ih = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = p.s, h = p.h, kvh = p.kvh;
  const int group = h / kvh;
  const int ikv = ih / group;
  const int q0 = iq * BQ;
  const T* qs = static_cast<const T*>(p.qs);
  const T* ks = static_cast<const T*>(p.ks);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const uint32_t key = dropout_hash::stream_key(
      p.seed, static_cast<uint32_t>(ib * h + ih));
  const int* seg =
      p.seg != nullptr ? p.seg + static_cast<size_t>(ib) * s : nullptr;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ, D]
  T* do_s = q_s + BQ * D;                   // [BQ, D]
  T* k_s = do_s + BQ * D;                   // [BK, D]
  T* v_s = k_s + BK * D;                    // [BK, D]
  T* ds_s = v_s + BK * D;                   // [BQ, BK] dS
  // S and dP, then at the end the staging of dQ.
  float* f_s = reinterpret_cast<float*>(ds_s + BQ * BK);
  float* s_s = f_s;                         // [BQ, BK]
  float* dp_s = f_s + BQ * BK;              // [BQ, BK]
  float* lse_s = f_s + bwd_f32_region<D, BT>();  // [BQ]
  float* dl_s = lse_s + BQ;                 // [BQ]
  int* qseg_s = reinterpret_cast<int*>(dl_s + BQ);  // [BQ]
  int* kseg_s = qseg_s + BQ;                // [BK]

  Acc<T, BQ, D, kBwdThreads> dq_acc;
  dq_acc.zero();
  load_tiles<T, D, BQ, kBwdThreads>(
      q_s, qs, do_s, dout, (static_cast<size_t>(ib) * s * h + ih) * D, q0, s,
      h);
  load_rows<BQ>(p, lse_s, dl_s, ib, ih, q0);
  if (seg != nullptr) load_seg<BQ>(qseg_s, seg, q0, s);

  const int nk = (s + BK - 1) / BK;
  const int jend = p.causal ? min(iq + 1, nk) : nk;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous k tile's readers are done
    if (seg != nullptr) {
      load_seg<BK>(kseg_s, seg, k0, s);
      __syncthreads();
      if (!seg_overlap(qseg_s, min(BQ, s - q0), kseg_s, min(BK, s - k0)))
        continue;
    }
    load_tiles<T, D, BK, kBwdThreads>(
        k_s, ks, v_s, v, (static_cast<size_t>(ib) * s * kvh + ikv) * D, k0,
        s, kvh);
    __syncthreads();

    tile_mma<T, false, true, false>(q_s, D, k_s, D, s_s, BK, BQ, BK, D);
    tile_mma<T, false, true, false>(do_s, D, v_s, D, dp_s, BK, BQ, BK, D);
    __syncthreads();
    score_grads<T, BQ, BK>(p, s_s, dp_s, lse_s, dl_s, qseg_s, kseg_s,
                           static_cast<T*>(nullptr), ds_s, q0, k0, key);
    __syncthreads();
    dq_acc.template mma<false, false>(ds_s, BK, k_s, D, BK);
  }

  // dQ * scale, un-rotated, cast once.
  __syncthreads();
  dq_acc.store(f_s, D);
  __syncthreads();
  for (int e = tid; e < BQ * D; e += blockDim.x) f_s[e] *= p.scale;
  __syncthreads();
  T* dq = static_cast<T*>(p.dq);
  const bool rope = p.cos != nullptr;
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    const int row = q0 + r;
    if (row >= s) continue;
    const float g = rope ? unrope_elem<D>(f_s + r * D, c, p.cos + row * D,
                                          p.sin + row * D)
                         : f_s[e];
    dq[((static_cast<size_t>(ib) * s + row) * h + ih) * D + c] =
        from_f32<T>(g);
  }
}

// dq = unrotate(dq_acc) cast to T, one thread per element.
template <typename T, int D>
__global__ void dq_finalize_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ cos,
                                   const float* __restrict__ sin,
                                   T* __restrict__ dq, size_t n, int s,
                                   int h) {
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % D);
    float g = acc[idx];
    if (cos != nullptr) {
      const int row = static_cast<int>((idx / (static_cast<size_t>(h) * D)) % s);
      g = unrope_elem<D>(acc + (idx - c), c, cos + row * D, sin + row * D);
    }
    dq[idx] = from_f32<T>(g);
  }
}

__global__ void keep_mask_kernel(uint8_t* __restrict__ out, uint32_t key,
                                 int seq, uint32_t threshold, int bq, int bk,
                                 int kmajor) {
  const int nqt = (seq + bq - 1) / bq;
  const int nkt = (seq + bk - 1) / bk;
  const int t = blockIdx.x;
  const int a = kmajor ? t % nqt : t / nkt;
  const int c = kmajor ? t / nqt : t % nkt;
  for (int e = threadIdx.x; e < bq * bk; e += blockDim.x) {
    const int row = a * bq + e / bk;
    const int col = c * bk + e % bk;
    if (row < seq && col < seq)
      out[static_cast<size_t>(row) * seq + col] = dropout_hash::keep(
          key, static_cast<uint32_t>(row), static_cast<uint32_t>(col),
          static_cast<uint32_t>(seq), threshold);
  }
}

template <typename T>
constexpr int tile_of() {
  return sizeof(T) == 4 ? 32 : 64;
}

template <typename T, int D>
size_t fwd_smem() {
  constexpr int B = tile_of<T>();
  return sizeof(T) * (3 * B * D + B * B) +
         sizeof(float) * (B * B + B * D + 3 * B) + sizeof(int) * 2 * B;
}

// The fused backward and the split dk/dv kernel (one layout).
template <typename T, int D>
size_t bwd_smem() {
  constexpr int B = tile_of<T>();
  return sizeof(T) * (4 * B * D + 2 * B * B) +
         sizeof(float) * (bwd_f32_region<D, B>() + 2 * B) +
         sizeof(int) * 2 * B;
}

template <typename T, int D>
size_t dq_smem() {
  constexpr int B = tile_of<T>();
  return sizeof(T) * (4 * B * D + B * B) +
         sizeof(float) * (bwd_f32_region<D, B>() + 2 * B) +
         sizeof(int) * 2 * B;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr int B = tile_of<T>();
  const size_t nq = static_cast<size_t>(p.b) * p.s * p.h * D;
  const size_t nk =
      p.cos != nullptr ? static_cast<size_t>(p.b) * p.s * p.kvh * D : 0;
  const size_t work = (nq + nk + 255) / 256;
  rope_prep_kernel<T, D><<<static_cast<unsigned>(work < 65535 ? work : 65535),
                           256, 0, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k), p.cos, p.sin,
      static_cast<T*>(p.qs), static_cast<T*>(p.ks), nq, nk, p.s, p.h, p.kvh,
      p.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem<T, D>();
  auto kernel = flash_fwd_kernel<T, D, B>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.s + B - 1) / B, p.h, p.b);
  kernel<<<grid, kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_delta(const BwdParams& p, const void* o, float* delta,
                         cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(p.b) * p.s * p.h;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(p.dout), delta, p.b,
      p.s, p.h);
  return cudaGetLastError();
}

// The fused backward (DQ) or the split dk/dv kernel, after delta.
template <typename T, int D, bool DQ>
cudaError_t launch_kv(const BwdParams& p, const void* o, float* delta,
                      cudaStream_t stream) {
  constexpr int B = tile_of<T>();
  cudaError_t err = launch_delta<T, D>(p, o, delta, stream);
  if (err != cudaSuccess) return err;
  if (DQ) {
    err = cudaMemsetAsync(p.dq_acc, 0,
                          static_cast<size_t>(p.b) * p.s * p.h * D *
                              sizeof(float),
                          stream);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = bwd_smem<T, D>();
  auto kernel = flash_bwd_kernel<T, D, B, DQ>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  BwdParams q = p;
  q.delta = delta;
  dim3 grid((p.s + B - 1) / B, p.h, p.b);
  kernel<<<grid, kBwdThreads, smem, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DQ) return err;
  const size_t n = static_cast<size_t>(p.b) * p.s * p.h * D;
  const unsigned blocks =
      static_cast<unsigned>(n / 256 + 1 < 65535 ? n / 256 + 1 : 65535);
  dq_finalize_kernel<T, D><<<blocks, 256, 0, stream>>>(
      p.dq_acc, p.cos, p.sin, static_cast<T*>(p.dq), n, p.s, p.h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int B = tile_of<T>();
  const size_t smem = dq_smem<T, D>();
  auto kernel = flash_bwd_dq_kernel<T, D, B>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.s + B - 1) / B, p.h, p.b);
  kernel<<<grid, kBwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
struct TypeTag {
  using type = T;
};

// f(TypeTag<T>, std::integral_constant<int, D>) for the dtype code
// (0 = float32, 1 = bfloat16, 2 = float16) and head dim (64 or 128).
template <typename F>
cudaError_t dispatch(int dtype, int d, F&& f) {
  auto by_d = [&](auto tag) -> cudaError_t {
    switch (d) {
      case 64:
        return f(tag, std::integral_constant<int, 64>{});
      case 128:
        return f(tag, std::integral_constant<int, 128>{});
      default:
        return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case 0:
      return by_d(TypeTag<float>{});
    case 1:
      return by_d(TypeTag<__nv_bfloat16>{});
    case 2:
      return by_d(TypeTag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_dims(int b, int s, int h, int kvh) {
  return b <= 0 || s <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 ||
         s >= (1 << 16);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. cos/sin null: no RoPE
// (then ks may be null). seg: int32 [b, s] segment ids or null. lse:
// [b, h, s] f32. Returns a cudaError_t code.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* cos, const void* sin, void* o,
                              void* lse, void* qs, void* ks, const void* seg,
                              int b, int s, int h, int kvh, int d, int dtype,
                              int causal, float scale, uint32_t seed,
                              uint32_t threshold, float keep_prob, int dropout,
                              void* stream) {
  if (bad_dims(b, s, h, kvh) || (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{q, k, v, static_cast<const float*>(cos),
              static_cast<const float*>(sin), o, static_cast<float*>(lse), qs,
              ks, static_cast<const int*>(seg), b, s, h, kvh, causal, dropout,
              scale, keep_prob, seed, threshold};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    return launch_fwd<typename decltype(t)::type, decltype(dd)::value>(p, st);
  }));
}

// The fused backward. qs / ks / v / o / dout in `dtype`; lse [b, h, s] f32;
// delta [b, h, s] f32 scratch; dq_acc [b, s, h, d] f32 scratch; dq
// [b, s, h, d] in dtype; dk / dv [b, s, h, d] f32 per-query-head partials.
extern "C" int flash_attn_bwd(const void* qs, const void* ks, const void* v,
                              const void* o, const void* dout, const void* lse,
                              const void* cos, const void* sin, void* delta,
                              void* dq_acc, void* dq, void* dk, void* dv, int b,
                              int s, int h, int kvh, int d, int dtype,
                              int causal, float scale, uint32_t seed,
                              uint32_t threshold, float keep_prob, int dropout,
                              void* stream) {
  if (bad_dims(b, s, h, kvh) || (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{qs, ks, v, dout, static_cast<const float*>(lse), nullptr,
              static_cast<const float*>(cos), static_cast<const float*>(sin),
              nullptr, static_cast<float*>(dq_acc), dq,
              static_cast<float*>(dk), static_cast<float*>(dv), b, s, h, kvh,
              causal, dropout, scale, keep_prob, seed, threshold};
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    return launch_kv<typename decltype(t)::type, decltype(dd)::value, true>(
        p, o, dl, st);
  }));
}

// The split backward's first half: delta (written to `delta`, which the dq
// half reads) and the dk/dv kernel. seg: int32 [b, s] or null. dk / dv
// [b, s, h, d] f32 per-query-head partials.
extern "C" int flash_attn_bwd_dkv(const void* qs, const void* ks,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  const void* cos, const void* sin,
                                  const void* seg, void* delta, void* dk,
                                  void* dv, int b, int s, int h, int kvh,
                                  int d, int dtype, int causal, float scale,
                                  uint32_t seed, uint32_t threshold,
                                  float keep_prob, int dropout,
                                  void* stream) {
  if (bad_dims(b, s, h, kvh) || (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{qs, ks, v, dout, static_cast<const float*>(lse), nullptr,
              static_cast<const float*>(cos), static_cast<const float*>(sin),
              static_cast<const int*>(seg), nullptr, nullptr,
              static_cast<float*>(dk), static_cast<float*>(dv), b, s, h, kvh,
              causal, dropout, scale, keep_prob, seed, threshold};
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    return launch_kv<typename decltype(t)::type, decltype(dd)::value, false>(
        p, o, dl, st);
  }));
}

// The split backward's second half: dq [b, s, h, d] in dtype from the
// residuals and the delta of flash_attn_bwd_dkv.
extern "C" int flash_attn_bwd_dq(const void* qs, const void* ks,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* cos, const void* sin,
                                 const void* seg, void* dq, int b, int s,
                                 int h, int kvh, int d, int dtype, int causal,
                                 float scale, uint32_t seed,
                                 uint32_t threshold, float keep_prob,
                                 int dropout, void* stream) {
  if (bad_dims(b, s, h, kvh) || (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{qs, ks, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(cos), static_cast<const float*>(sin),
              static_cast<const int*>(seg), nullptr, dq, nullptr, nullptr, b,
              s, h, kvh, causal, dropout, scale, keep_prob, seed, threshold};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    return launch_dq<typename decltype(t)::type, decltype(dd)::value>(p, st);
  }));
}

// out: [seq, seq] uint8 keep mask of stream (seed, salt), generated tile by
// tile ([bq, bk] tiles, q-major or k-major block order).
extern "C" int flash_attn_keep_mask(void* out, uint32_t seed, uint32_t salt,
                                    int seq, uint32_t threshold, int bq,
                                    int bk, int kmajor, void* stream) {
  if (seq <= 0 || seq >= (1 << 16) || bq <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((seq + bq - 1) / bq) * ((seq + bk - 1) / bk);
  keep_mask_kernel<<<tiles, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), dropout_hash::stream_key(seed, salt), seq,
      threshold, bq, bk, kmajor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
