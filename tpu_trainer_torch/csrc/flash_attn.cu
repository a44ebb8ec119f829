// Causal flash attention for training on Hopper (sm_90a): the forward with
// fused RoPE, counter-based attention dropout and packed-sequence segment
// ids, the fused backward (causal or not), the split backward (a dk/dv kernel and a dq
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
// The bf16/fp16 forward (flash_fwd_tma_kernel, replacing _fwd_kernel on
// the training path): what held the first version back was not the
// card's bytes or operations but the way to the tensor cores. Its 16x16
// WMMA products read their operands from shared memory and wrote the f32
// score tile there, a warp per row ran the softmax over it in scalar
// code, the f32 output accumulator lived in shared memory with a separate
// rescale pass, K/V loads were synchronous, and six barriers a k tile
// serialised it all: 45x its bound. This design:
// - A block owns a 128-row q tile of one (head, batch): warps 0-7 are two
//   consumer warpgroups of 64 rows, warp 8 a producer. The producer loads
//   the q tile once and keeps K/V tiles (BK = 128 keys, a little faster
//   than 64 on the card) arriving by TMA
//   (cp.async.bulk.tensor over a CUtensorMap of the [b, s, kvh, d]
//   layout, rows strided by kvh*d, zero-filled past s, 64-column boxes so
//   a 256-byte d = 128 row fits the 128-byte swizzle) into a ring of 2-3
//   stages completed on mbarriers; consumers free a stage with one
//   arrival per warp. GQA blocks of one kv head read the same tiles
//   through L2.
// - S = Q K^T is a wgmma (m64n128k16, A and B from shared memory) into f32
//   registers: no score tile in shared memory. Each thread derives the
//   global (row, col) of its accumulator elements from the wgmma layout
//   (hopper.cuh) and applies there the causal, ragged and segment masks
//   and the dropout hash; row max and row sum take two shuffles over the
//   four lanes of a row; alpha = exp(m_old - m_new) rescales the O
//   registers. O += P V is a wgmma with P as the register A operand (the
//   f32 scores rounded in place into 16-bit pairs) and V read MN-major
//   from shared memory through the descriptor's transpose bit. O stays in
//   registers to the epilogue, which divides by l (1 - rate) and writes o
//   and lse once, masked at s.
// - A warpgroup skips the products of a k tile wholly above its rows'
//   diagonal (it still frees the stage), and masks element by element
//   only on tiles that touch the diagonal, the ragged edge or segments.
// - The q tiles with the most causal work launch first (blockIdx.y
//   counts down from the last tile), so the heavy blocks do not form the
//   tail.
// - The f32 instantiation (flash_fwd_kernel, 32x32 tiles on the CUDA
//   cores) is a checking path, not the training path, and keeps the first
//   design below.
//
// The bf16/fp16 fused backward (flash_bwd_tma_kernel, replacing
// _bwd_fused_kernel on the training path). It is bound by operations (10*d
// flops a causal pair per head); the first version ran at 58x that bound
// for the same reasons as the first forward (WMMA from shared memory, the
// f32 S and dP tiles in shared memory walked one thread an element,
// synchronous loads, six barriers a q tile), plus 4096 scalar dq atomics a
// tile pair and three passes around it. This design:
// - A block owns a 128-key tile of one (head, batch): warps 0-7 are two
//   consumer warpgroups of 64 keys each, warpgroup 2 the producer, which
//   gives its registers away (setmaxnreg 24; consumers 240: without it
//   ptxas serialises the wgmma for want of registers, and d = 128 still
//   spills 8 bytes). The producer loads K and V
//   once and keeps 64-row Q and dO tiles, with the tile's lse and delta
//   rows (1-D bulk copies on the same mbarrier), arriving through a ring of
//   2-3 stages. The k tiles with the most causal work launch first.
// - Scores transposed, keys as M: S^T = K Q^T and dP^T = V dO^T are wgmma
//   (m64n64k16, both operands K-major in shared memory) into registers. Each
//   element of S^T sits at (key, q), so the causal test is q >= key, the
//   hash is keep(row = q, col = key), and lse and delta broadcast along the
//   columns. P^T and dS^T = P^T (dP'^T - delta) are formed in registers
//   and feed dV += P_drop^T dO and dK += dS^T Q as the register A operand,
//   dO and Q read MN-major through the transpose bit: dK and dV never leave
//   registers until the epilogue, which un-rotates dK within the thread
//   (columns c and c +- d/2 are the same thread's) and writes dk/dv once,
//   in T at group 1 (bitwise what the group sum of one f32 value gives)
//   and as f32 per-query-head partials under GQA.
// - dQ: dS^T is stored once in T into shared memory (128-byte swizzled
//   rows, conflict free) and read back as an MN-major A operand of dQ_part
//   = dS K (K MN-major), 64 columns at a time; the f32 part goes to one of
//   the warpgroup's shared buffers, and a reducer warp of the producer
//   warpgroup adds it into dq_acc [b, h, s_pad, d] (a q tile's rows
//   contiguous; 25 MB at the training shape, inside the 50 MB L2) with one
//   cp.reduce.async.bulk .add.f32.
// - dq in one fixed order (the TPU kernel keeps a q tile's dq resident over
//   its sequential grid, one order; blocks here run in no order): the parts
//   of one q tile come from the 64-key sub-tiles at or above the diagonal
//   and are added in ascending sub-tile order. One int32 turn a (b, h, q
//   tile), zeroed by the pre-pass: the reducer waits (acquire) until the
//   turn equals its block's rank, adds its warpgroups' parts one after the
//   other, each waited complete, and passes the turn (release). dq is then
//   bitwise the same from run to run (hopper.cuh Turn; the deadlock
//   argument is beside the reducer).
// - Around the kernel: one pre-pass computes delta = rowsum(dO * O) with
//   16-byte loads, pads lse (+inf past s, so rows past s get p = 0) and
//   zeroes dq_acc and the turns; a finalize pass un-rotates and casts dq.
//
// The bf16/fp16 split dk/dv kernel (flash_bwd_tma_kernel<..., DQ = false>,
// replacing _bwd_dkv_kernel on the packed path) is the same kernel without
// the dq products, their stage and the reducer, plus segments as the
// forward has them: the block's tile list keeps the q tiles whose id
// interval meets its 128 keys' (computed alike by producer and consumers
// from the ids; a warpgroup also skips a listed tile that misses its own 64
// keys), each thread loads its two keys' ids once, each q tile's ids arrive
// with its ring stage (from a padded copy the pre-pass writes), and
// segmented tiles test qseg == kseg element by element. It writes dk/dv in
// T at group 1 (f32 partials under GQA) and leaves delta [b, h, s_pad] for
// the split dq kernel. Its first design wrote f32 S and dP tiles to shared
// memory, walked them one element a thread, loaded tiles synchronously and
// always wrote f32 partials: 41x its bound.
//
// The bf16/fp16 split dq kernel (flash_bwd_dq_tma_kernel, replacing
// _bwd_dq_kernel on the packed path) is the forward's structure with the
// backward's chain. Its first design (nvcuda::wmma 16x16 products through
// shared memory, S and dP as f32 tiles there walked one element a thread,
// synchronous K/V loads, the segment ids reloaded and tested for every k
// tile, four to five barriers a tile) ran at 44x its bound. This design:
// - A block owns a 128-row q tile of one (head, batch): warps 0-7 are two
//   consumer warpgroups of 64 rows, warpgroup 2 the producer (setmaxnreg
//   24; consumers 240). The producer loads Q and dO once and keeps 64-key
//   K/V tiles arriving through a ring of 3 stages (DqTmaSmem says why),
//   each with its keys' segment ids, written by the producer warp's lanes
//   before the stage completes (no padded copy needed). The q tiles with
//   the most causal work launch first.
// - S = Q K^T and dP = dO V^T are SS wgmma into f32 registers; each thread's
//   two rows' lse, delta and ids are loaded once. dS = P (dP' - delta) is
//   formed in registers (masks and the hash only on tiles that touch the
//   diagonal, the ragged edge or segments), rounded in place into 16-bit
//   pairs and fed as the register A operand of dQ += dS K, K read MN-major
//   through the transpose bit. dQ stays in registers over the whole k walk.
// - Segments: producer and consumers walk one block-uniform list of k tiles
//   whose id interval meets the q tile's (seg_range_g, the dk/dv kernel's
//   rule mirrored); a warpgroup skips a listed tile that misses its own 64
//   rows but still frees the stage.
// - The epilogue scales dQ and un-rotates it within the thread (columns c
//   and c + d/2 are the same thread's) and writes dq once in T, masked at s:
//   no atomics and no turns, bitwise the same from run to run.
// - The f32 instantiations and the mask dump keep the first design below.
//
// The first design, which the f32 forward, backwards and dq kernel keep:
// - One thread block per (q tile, head, batch) in the f32 forward and in
//   the split dq kernel, walking the causally needed k tiles in a loop (the
//   TPU walks a sequential grid axis); one block per (k tile, head, batch)
//   in the fused backward and the split dk/dv kernel, walking the q tiles
//   at or below the diagonal. Tiles are 32x32 (shared memory), the ragged
//   edge (s not a multiple of the tile) masked in the kernel, so every s
//   runs here.
// - The products run on the CUDA cores in exact f32, operands staged in
//   shared memory. Masking, dropout and the score gradients are scalar f32
//   code over the f32 score tile in shared memory.
// - RoPE as in flash.py:195-214: f32 rotation, 1/sqrt(d) folded into q,
//   cast to the compute type. A prologue pass of the forward call rotates
//   q and k once and writes them as the backward's residuals (flash.py:
//   275-280); the flash kernel reads its tiles from them, so no k tile is
//   rotated again by every q tile that reads it. The backward un-rotates
//   dq and dk (flash.py:217-223).
// - The first design's tiles move global -> shared with 16-byte loads,
//   each thread's loads issued together before its stores.
// - Dropout: the keep test is dropout_hash::keep over global positions
//   (csrc/dropout_hash.cuh), salt batch * heads + head: bitwise the masks
//   of the JAX kernel in interpret mode, in every kernel. The softmax
//   normaliser sums the undropped weights; o = acc / (l * (1 - rate)).
// - Segment ids (int32 [b, s], 0 = padding) as flash.py:226-242 and
//   :432-458: a tile pair whose q rows and k columns share no segment id
//   interval ([min, max] of each tile, computed by every warp from the ids,
//   so every warp takes the same skips) is skipped, as the causal skip skips tiles above the
//   diagonal; the others mask element by element. Masked scores take
//   -1e30, not -inf, when segments are on (flash.py:79-90): a q row whose
//   first processed k tile lies wholly in another segment then keeps a
//   finite running max, and the first tile with a valid column wipes the
//   garbage through alpha = exp(-1e30 - m) = 0. Every row attends to
//   itself, so its diagonal tile always has a valid column.
// - The TPU's fused kernel keeps the whole dq row resident across
//   sequential grid steps (flash.py:698-747). Blocks here run in no order,
//   so the f32 fused kernel adds its dq contribution into a zeroed f32
//   buffer in ascending k-tile order (a Turn a q tile, as the TMA kernel)
//   and a small pass un-rotates and casts it. The split pair recomputes S and
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
#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "hopper.cuh"

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
// memory, on the CUDA cores in exact f32 (the checking path's products).
// A_COL: A stored column-major (element (m, k) at A[k * lda + m]); B_COL:
// element (k, n) at B[n * ldb + k]. The whole block calls it.
template <typename T, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void tile_mma(const T* A, int lda, const T* B,
                                         int ldb, float* C, int ldc, int M,
                                         int N, int K) {
  static_assert(std::is_same<T, float>::value, "the f32 checking path only");
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
}

// An [M, N] f32 tile accumulated in registers across calls (the f32
// backwards' dK and dV over their q-tile walk, the f32 dq kernel's dQ):
// each thread owns M*N/NT elements.
template <typename T, int M, int N, int NT>
struct Acc {
  static_assert(std::is_same<T, float>::value, "the f32 checking path only");
  static constexpr int kPer = M * N / NT;
  static_assert(M * N % NT == 0, "elements per thread");
  float v[kPer];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = 0.f;
  }

  // this += A[M, K] * B[K, N] (layouts as tile_mma's).
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

// -- the bf16/fp16 forward: TMA ring, wgmma, softmax in registers -----------

constexpr int kFwdBQ = 128;          // q rows a block: two warpgroups of 64
constexpr int kFwdBK = 128;          // keys a K/V tile
constexpr int kFwdConsumers = 256;   // two consumer warpgroups
constexpr int kFwdTmaThreads = kFwdConsumers + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: ~2 ulp; 2^-inf = 0). Its error is far below
// the 16-bit rounding of p that follows.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the forward at head dim D: the q tile (D / 64 boxes of
// [128][64]), a ring of K/V stages (each D / 64 boxes of [BK][64] for K,
// then for V), the segment ids of each warpgroup's current k tile
// (double-buffered), the mbarriers, and slack to align the tiles to 1024
// bytes.
template <int D>
struct FwdTmaSmem {
  static constexpr int BK = kFwdBK;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kFwdBQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSegOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kSegOffset + 2 * 2 * BK * 4;
  // q barrier, then full[kStages], then empty[kStages]
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

struct FwdTmaParams {
  CUtensorMap q;  // qs [b, s, h, D]: boxes {64, 1, 128, 1}
  CUtensorMap k;  // k tiles [b, s, kvh, D]: boxes {64, 1, BK, 1}
  CUtensorMap v;  // v [b, s, kvh, D]: boxes {64, 1, BK, 1}
  FwdParams f;
};

// [min, max] segment id of positions [r0, min(r0 + n, s)) of one batch
// row, computed by one warp (every lane holds it).
__device__ __forceinline__ int2 seg_range_g(const int* seg, int r0, int n,
                                            int s) {
  int lo = INT_MAX, hi = INT_MIN;
  const int end = min(r0 + n, s);
  for (int i = r0 + (threadIdx.x & 31); i < end; i += 32) {
    const int x = __ldg(seg + i);
    lo = min(lo, x);
    hi = max(hi, x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// Whether k tile [k0, k0 + kFwdBK) may share a segment with the q tile whose
// id interval is qr (always without segments). Every warp evaluates it
// alike, so producer and consumers walk the same tile list.
__device__ __forceinline__ bool fwd_tile_needed(const int* seg, int2 qr,
                                                int k0, int s) {
  if (seg == nullptr) return true;
  const int2 kr = seg_range_g(seg, k0, kFwdBK, s);
  return qr.x <= kr.y && kr.x <= qr.y;
}

// One block per (128-row q tile, head, batch); the q tiles with the most
// causal work launch first (blockIdx.y counts down the diagonal). Warps
// 0-7 are two consumer warpgroups, each owning 64 q rows; warp 8 is the
// producer.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdTmaThreads, 1)
    flash_fwd_tma_kernel(const __grid_constant__ FwdTmaParams p) {
  using namespace hopper;
  using L = FwdTmaSmem<D>;
  constexpr int BK = kFwdBK;
  constexpr int S = L::kStages;
  const FwdParams& f = p.f;
  const int s = f.s, h = f.h;
  const int ih = blockIdx.x % h;
  const int ib = blockIdx.x / h;
  const int nq = (s + kFwdBQ - 1) / kFwdBQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);
  const int q0 = iq * kFwdBQ;
  const int ikv = ih / (h / f.kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* seg =
      f.seg != nullptr ? f.seg + static_cast<size_t>(ib) * s : nullptr;
  const int nk = (s + BK - 1) / BK;
  const int jend = f.causal ? min((q0 + kFwdBQ + BK - 1) / BK, nk) : nk;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(base);
  const uint32_t ring = q_s + L::kQBytes;
  int* kseg_s = reinterpret_cast<int*>(base + L::kSegOffset);  // [2][2][BK]
  const uint32_t bars = smem_u32(base + L::kBarOffset);
  const uint32_t q_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + S + st); };
  auto k_tile = [&](int st) { return ring + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return ring + st * L::kStageBytes + L::kTileBytes; };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kFwdConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int2 qr = seg != nullptr ? seg_range_g(seg, q0, kFwdBQ, s)
                                 : make_int2(0, 0);

  if (warp == kFwdConsumers / 32) {
    // Producer: q once, then the needed K/V tiles through the ring.
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(q_s + c * kFwdBQ * 128, &p.q, q_bar, c * 64, ih, q0, ib);
    }
    int n = 0;
    for (int j = 0; j < jend; ++j) {
      if (!fwd_tile_needed(seg, qr, j * BK, s)) continue;
      const int st = n % S;
      if (lane == 0) {
        mbar_wait(empty(st), ((n / S) & 1) ^ 1);
        mbar_expect_tx(full(st), L::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_tile(st) + c * BK * 128, &p.k, full(st), c * 64, ikv,
                      j * BK, ib);
          tma_load_4d(v_tile(st) + c * BK * 128, &p.v, full(st), c * 64, ikv,
                      j * BK, ib);
        }
      }
      __syncwarp();
      ++n;
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread holds rows row_a and row_b = row_a + 8 of each accumulator.
  const int wg = warp >> 2;
  const int t4 = lane & 3;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + 16 * (warp & 3) + (lane >> 2);
  const int row_b = row_a + 8;
  const bool wg_live = wg_row0 < s;
  const float mask_val = seg != nullptr ? kSegMask : -INFINITY;
  const uint32_t key = dropout_hash::stream_key(
      f.seed, static_cast<uint32_t>(ib * h + ih));
  const int qseg_a = seg != nullptr && row_a < s ? __ldg(seg + row_a) : -2;
  const int qseg_b = seg != nullptr && row_b < s ? __ldg(seg + row_b) : -2;
  const Elem<T> et{};

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_bar, 0);

  int n = 0;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * BK;
    if (!fwd_tile_needed(seg, qr, k0, s)) continue;
    const int st = n % S;
    const uint32_t parity = (n / S) & 1;
    int* kseg = kseg_s + (wg * 2 + (n & 1)) * BK;
    ++n;
    if (seg != nullptr) {
      // This warpgroup's copy of the tile's segment ids (the buffer it
      // overwrites was last read two tiles ago, before the barrier of the
      // tile in between).
      const int i = tid & 127;
      if (i < BK) kseg[i] = k0 + i < s ? __ldg(seg + k0 + i) : -1;
      named_barrier(1 + wg, 128);
    }
    mbar_wait(full(st), parity);
    if (wg_live && (!f.causal || k0 <= wg_row0 + 63)) {
      // S = Q K^T: [64, BK] f32 in registers.
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = desc_sw128(
            q_s + (kk / 4) * kFwdBQ * 128 + wg * 64 * 128 + (kk % 4) * 32, 16,
            1024);
        const uint64_t db =
            desc_sw128(k_tile(st) + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                       1024);
        wgmma_ss<0>(Shape<BK>{}, et, sc, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Masks: the causal diagonal, the ragged edge (TMA's zero rows past s
      // score 0, a valid-looking value), and the segments.
      if (seg != nullptr || k0 + BK > s ||
          (f.causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * jj + 2 * t4 + (e & 1);
            const int col = k0 + c;
            const int row = e < 2 ? row_a : row_b;
            bool ok = col < s && (!f.causal || col <= row);
            if (seg != nullptr) ok = ok && (e < 2 ? qseg_a : qseg_b) == kseg[c];
            if (!ok) sc[4 * jj + e] = mask_val;
          }
      }
      // Online softmax over the undropped weights: the row max over the
      // four lanes that share a row, rescale of l and O by alpha.
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * jj], sc[4 * jj + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a =
          mn_a == -INFINITY ? 1.f : fast_exp2((m_a - mn_a) * kLog2e);
      const float alpha_b =
          mn_b == -INFINITY ? 1.f : fast_exp2((m_b - mn_b) * kLog2e);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv =
              fast_exp2((sc[4 * jj + e] - (e < 2 ? mu_a : mu_b)) * kLog2e);
          if (e < 2) {
            sum_a += pv;
          } else {
            sum_b += pv;
          }
          if (f.dropout &&
              !dropout_hash::keep(
                  key, static_cast<uint32_t>(e < 2 ? row_a : row_b),
                  static_cast<uint32_t>(k0 + 8 * jj + 2 * t4 + (e & 1)),
                  static_cast<uint32_t>(s), f.threshold))
            pv = 0.f;
          sc[4 * jj + e] = pv;
        }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        o[4 * jj] *= alpha_a;
        o[4 * jj + 1] *= alpha_a;
        o[4 * jj + 2] *= alpha_b;
        o[4 * jj + 3] *= alpha_b;
      }
      // P (dropped, rounded to T) as the register A operand of O += P V.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2(et, sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            desc_sw128(v_tile(st) + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<1>(Shape<D>{}, et, o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  if (!wg_live) return;

  // Epilogue: l over the row's four lanes; o = acc / (l (1 - rate)) and
  // lse = m + log l, masked at s.
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float keep = f.dropout ? f.keep_prob : 1.f;
  const float inv_a = 1.f / (l_a * keep), inv_b = 1.f / (l_b * keep);
  T* o_base = static_cast<T*>(f.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    if (row >= s) continue;
    const float inv = half == 0 ? inv_a : inv_b;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o_base + ((static_cast<size_t>(ib) * s + row) * h + ih) * D);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      orow[(8 * jj + 2 * t4) / 2] = pack2(et, o[4 * jj + 2 * half] * inv,
                                          o[4 * jj + 2 * half + 1] * inv);
    if (t4 == 0)
      f.lse[(static_cast<size_t>(ib) * h + ih) * s + row] =
          (half == 0 ? m_a : m_b) + logf(half == 0 ? l_a : l_b);
  }
}

// The backwards' per-row f32 inputs (lse / delta) are padded to a multiple
// of this many rows, the TMA backward's q tile.
constexpr int kRowPad = 64;

__host__ __device__ constexpr int pad_rows(int s) {
  return (s + kRowPad - 1) / kRowPad * kRowPad;
}

// delta[b, h, s_pad] = rowsum(dO * O) in f32: one warp per (b, s, h) row.
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
    delta[(static_cast<size_t>(ib) * h + ih) * pad_rows(s) + row] = acc;
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
  const float* delta; // [b, h, s_pad], s_pad = s rounded up to kRowPad
  const float* cos;   // [s, D] or null
  const float* sin;   // [s, D] or null
  const int* seg;     // [b, s] segment ids or null
  float* dq_acc;      // fused: [b, s, h, D] f32, zeroed: scaled-space dq
  void* dq;           // split dq kernel: [b, s, h, D] in T
  float* dk;          // [b, s, h, D] f32 per-query-head partials
  float* dv;          // [b, s, h, D] f32 per-query-head partials
  int* turns;         // fused: zeroed int32 turns, one a (b, h, q tile)
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
    const size_t hb = static_cast<size_t>(ib) * p.h + ih;
    lse_s[r] = row < p.s ? p.lse[hb * p.s + row] : INFINITY;
    dl_s[r] = row < p.s ? p.delta[hb * pad_rows(p.s) + row] : 0.f;
  }
}

// One block per (k tile, head, batch), walking the q tiles at or below the
// diagonal; dK and dV in registers. DQ: the fused backward, which also adds
// each q tile's dQ part into dq_acc, in ascending k-tile order (a Turn per
// q tile: the blocks that reach q tile i are k tiles 0..i under causal
// masking, all of them without, and k tile jk holds rank jk; a block waits
// only on blocks of a lower blockIdx.x of its (head, batch), dispatched
// before it). Without DQ: the split backward's dk/dv kernel
// (tpu_trainer/ops/flash.py::_bwd_dkv_kernel). The f32 instantiations only
// (the checking path); bf16/fp16 take flash_bwd_tma_kernel.
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
      const hopper::Turn turn{p.turns + (static_cast<size_t>(ib) * h + ih) * nq + i};
      if (tid == 0) turn.wait(jk);
      __syncthreads();
      for (int e = tid; e < BQ * D; e += blockDim.x) {
        const int r = e / D;
        const int c = e - r * D;
        const int row = q0 + r;
        if (row < s) {
          float* acc =
              p.dq_acc + ((static_cast<size_t>(ib) * s + row) * h + ih) * D + c;
          *acc += dq_s[e] * p.scale;
        }
      }
      __syncthreads();
      if (tid == 0) turn.pass();
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

// dq [b, s, h, D] = unrotate(dq_acc) cast to T. dq_acc is [b, s, h, D]
// (the f32 fused backward) or, HEAD_MAJOR, [b, h, s_pad, D]
// (flash_bwd_tma_kernel, whose q tiles reduce into contiguous rows). A
// thread takes columns [c, c + 4) of one row and their rotation partners
// [c + D/2, c + D/2 + 4) (16-byte loads), rounded like unrope_elem.
template <typename T, int D, bool HEAD_MAJOR>
__global__ void dq_finalize_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ cos,
                                   const float* __restrict__ sin,
                                   T* __restrict__ dq, size_t rows, int s,
                                   int h, int s_pad) {
  constexpr int kPer = D / 8;  // threads a row
  for (size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < rows * kPer; t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t bsh = t / kPer;  // (batch, position, head)
    const int c = static_cast<int>(t % kPer) * 4;
    const int row = static_cast<int>((bsh / h) % s);
    const float* src =
        HEAD_MAJOR ? acc + ((bsh / (static_cast<size_t>(h) * s) * h +
                             bsh % h) * s_pad + row) * D
                   : acc + bsh * D;
    const float4 lo = *reinterpret_cast<const float4*>(src + c);
    const float4 hi = *reinterpret_cast<const float4*>(src + c + D / 2);
    float a[4] = {lo.x, lo.y, lo.z, lo.w}, b[4] = {hi.x, hi.y, hi.z, hi.w};
    if (cos != nullptr) {
      const float* cr = cos + static_cast<size_t>(row) * D;
      const float* sr = sin + static_cast<size_t>(row) * D;
      const float4 cl = *reinterpret_cast<const float4*>(cr + c);
      const float4 ch = *reinterpret_cast<const float4*>(cr + c + D / 2);
      const float4 sl = *reinterpret_cast<const float4*>(sr + c);
      const float4 sh = *reinterpret_cast<const float4*>(sr + c + D / 2);
      const float cla[4] = {cl.x, cl.y, cl.z, cl.w};
      const float cha[4] = {ch.x, ch.y, ch.z, ch.w};
      const float sla[4] = {sl.x, sl.y, sl.z, sl.w};
      const float sha[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ga = a[i], gb = b[i];
        a[i] = __fadd_rn(__fmul_rn(ga, cla[i]), __fmul_rn(gb, sha[i]));
        b[i] = __fadd_rn(__fmul_rn(gb, cha[i]), -__fmul_rn(ga, sla[i]));
      }
    }
    T oa[4], ob[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oa[i] = from_f32<T>(a[i]);
      ob[i] = from_f32<T>(b[i]);
    }
    using V = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
    *reinterpret_cast<V*>(dq + bsh * D + c) = *reinterpret_cast<V*>(oa);
    *reinterpret_cast<V*>(dq + bsh * D + c + D / 2) =
        *reinterpret_cast<V*>(ob);
  }
}

// -- the bf16/fp16 backwards: TMA ring, wgmma, transposed scores ------------

constexpr int kBwdBQ = 64;             // q rows a ring stage
constexpr int kBwdBK = 128;            // keys a block: two warpgroups of 64
constexpr int kBwdConsumers = 256;     // two consumer warpgroups
constexpr int kBwdTmaThreads = kBwdConsumers + 128;  // + a producer warpgroup

// The TMA backwards' pre-pass, one call: delta = rowsum(dO * O) in f32 into
// delta_pad [b, h, s_pad] (0 past s), lse * log2(e) into lse_pad [b, h,
// s_pad] (+inf past s, so rows past s get p = 0); for the split dk/dv
// kernel with segments, the ids into seg_pad [b, s_pad] (-1 past s); for
// the fused backward, dq_acc [b, h, s_pad, D] and the dq turns [b, h,
// s_pad / 64] zeroed. D / 8 threads a row, one 16-byte load of o and of do
// each.
template <typename T, int D>
__global__ void bwd_prep_kernel(const T* __restrict__ o,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const int* __restrict__ seg,
                                float* __restrict__ lse_pad,
                                float* __restrict__ delta_pad,
                                int* __restrict__ seg_pad,
                                float* __restrict__ dq_acc,
                                int* __restrict__ turns, size_t rows, int s,
                                int h, int s_pad) {
  constexpr int kPer = D / 8;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row = t / kPer;  // [b, h, s_pad] order
  const int c = static_cast<int>(t % kPer);
  const bool valid = row < rows;
  const int sp = static_cast<int>(row % s_pad);
  const size_t bh = row / s_pad;
  float acc = 0.f;
  if (valid && sp < s) {
    const size_t off =
        ((bh / h * s + sp) * h + bh % h) * D + static_cast<size_t>(c) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += to_f32(av[i]) * to_f32(bv[i]);
  }
#pragma unroll
  for (int x = kPer / 2; x > 0; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (!valid) return;
  if (dq_acc != nullptr) {
    float4* z = reinterpret_cast<float4*>(dq_acc + row * D + c * 8);
    z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    z[1] = z[0];
  }
  if (c != 0) return;
  delta_pad[row] = acc;
  lse_pad[row] = sp < s ? lse[bh * s + sp] * kLog2e : INFINITY;
  if (turns != nullptr && sp % kBwdBQ == 0) turns[row / kBwdBQ] = 0;
  if (seg_pad != nullptr && bh % h == 0) {
    const size_t ib = bh / h;
    seg_pad[ib * s_pad + sp] = sp < s ? seg[ib * s + sp] : -1;
  }
}

// Shared memory of the TMA backward at head dim D (tiles 1024-byte aligned):
// the block's K and V tiles (D / 64 boxes of [128 keys][64] each), a ring of
// Q and dO tiles (D / 64 boxes of [64 q][64] each); DQ (the fused backward):
// each warpgroup's dS^T tile ([64 keys][64 q] in T, 128-byte swizzled rows);
// each warpgroup's f32 [64 q][D] buffers (DQ: its dQ parts, the sources of
// the ordered bulk reductions, two at D = 64; the dK/dV staging of the
// epilogue in both kernels); the ring's lse, delta and segment-id rows; and
// the mbarriers.
template <int D, bool DQ>
struct BwdTmaSmem {
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kDqBufs = DQ && D == 64 ? 2 : 1;
  static constexpr int kKBytes = kBwdBK * D * 2;  // K tile; V the same
  static constexpr int kQBytes = kBwdBQ * D * 2;  // one Q or dO tile
  static constexpr int kRingOffset = 2 * kKBytes;
  static constexpr int kDsOffset = kRingOffset + kStages * 2 * kQBytes;
  static constexpr int kDqOffset = kDsOffset + (DQ ? 2 * 64 * kBwdBQ * 2 : 0);
  static constexpr int kDqBytes = kBwdBQ * D * 4;  // one f32 [64, D] buffer
  static constexpr int kRowsOffset = kDqOffset + 2 * kDqBufs * kDqBytes;
  static constexpr int kRowBytes = 3 * kBwdBQ * 4;  // lse, delta, ids
  static constexpr int kBarOffset = kRowsOffset + kStages * kRowBytes;
  // kv barrier, full[kStages], empty[kStages], dq_full[2][kDqBufs],
  // dq_empty[2][kDqBufs]
  static constexpr int kBytes =
      kBarOffset + 8 * (1 + 2 * kStages + 4 * kDqBufs) + 1024;
  static constexpr uint32_t kStageTx = 2 * kQBytes + 2 * kBwdBQ * 4;
};

struct BwdTmaParams {
  CUtensorMap q;   // qs [b, s, h, D]: boxes {64, 1, 64, 1}
  CUtensorMap d;   // dout [b, s, h, D]: the same boxes
  CUtensorMap k;   // ks [b, s, kvh, D]: boxes {64, 1, 128, 1}
  CUtensorMap v;   // v [b, s, kvh, D]: the same boxes
  BwdParams f;     // lse / delta: the pre-pass's lse_pad / delta_pad;
                   // DQ: dq_acc [b, h, s_pad, D] and turns [b, h, s_pad /
                   // 64]; dk / dv in T [b, s, kvh, D] at group 1, else f32
                   // [b, s, h, D] partials; seg: [b, s] ids or null
  const int* seg_pad;  // the pre-pass's [b, s_pad] ids (with f.seg)
  int s_pad;
};

// One block per (128-key tile, head, batch), k tiles with the most causal
// work first (blockIdx.y = 0 is the first k tile). Warps 0-7 are two
// consumer warpgroups, each owning 64 keys with dK and dV in registers over
// the whole q walk; warpgroup 2 is the producer: warp 8 loads, and under DQ
// warp 9 adds the dQ parts into dq_acc in their fixed order. DQ: the fused
// backward (dq, dk, dv; no segments). Without DQ: the split backward's
// dk/dv kernel (tpu_trainer/ops/flash.py::_bwd_dkv_kernel), with segments.
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(kBwdTmaThreads, 1)
    flash_bwd_tma_kernel(const __grid_constant__ BwdTmaParams p) {
  using namespace hopper;
  using L = BwdTmaSmem<D, DQ>;
  constexpr int S = L::kStages;
  constexpr int NB = L::kDqBufs;
  constexpr int BQ = kBwdBQ;
  const BwdParams& f = p.f;
  const int s = f.s, h = f.h;
  const int ih = blockIdx.x % h;
  const int ib = blockIdx.x / h;
  const int k0 = blockIdx.y * kBwdBK;
  const int ikv = ih / (h / f.kvh);
  const int nq = (s + BQ - 1) / BQ;
  const int i0 = f.causal ? k0 / BQ : 0;  // first q tile with a row >= k0
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* seg = (DQ || f.seg == nullptr)
                       ? nullptr
                       : f.seg + static_cast<size_t>(ib) * s;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t k_s = smem_u32(base);
  const uint32_t v_s = k_s + L::kKBytes;
  const uint32_t ring = k_s + L::kRingOffset;
  const uint32_t bars = smem_u32(base + L::kBarOffset);
  const uint32_t kv_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + S + st); };
  auto dq_full = [&](int wg, int bf) {
    return bars + 8 * (1 + 2 * S + wg * NB + bf);
  };
  auto dq_empty = [&](int wg, int bf) {
    return bars + 8 * (1 + 2 * S + 2 * NB + wg * NB + bf);
  };
  auto q_tile = [&](int st) { return ring + st * 2 * L::kQBytes; };
  auto do_tile = [&](int st) { return q_tile(st) + L::kQBytes; };
  // Warpgroup wg's f32 buffer bf.
  auto dq_buf = [&](int wg, int bf) {
    return reinterpret_cast<float*>(base + L::kDqOffset +
                                    (wg * NB + bf) * L::kDqBytes);
  };
  // lse, then delta, then (as int) the segment ids of stage st's q tile.
  auto rows = [&](int st) {
    return reinterpret_cast<float*>(base + L::kRowsOffset +
                                    st * L::kRowBytes);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kBwdConsumers / 32);
    }
    for (int wg = 0; wg < 2; ++wg)
      for (int bf = 0; bf < NB; ++bf) {
        mbar_init(dq_full(wg, bf), 4);
        mbar_init(dq_empty(wg, bf), 1);
      }
    fence_barrier_init();
  }
  __syncthreads();

  // Segments: the block walks the q tiles whose id interval meets its
  // keys' (flash.py::_seg_predicates' interval test). Each warp evaluates it
  // alike, so producer and consumers walk one list (a mismatch hangs).
  const int2 kr =
      seg != nullptr ? seg_range_g(seg, k0, kBwdBK, s) : make_int2(0, 0);
  auto tile_needed = [&](int i, int2* qr) {
    if (seg == nullptr) return true;
    *qr = seg_range_g(seg, i * BQ, BQ, s);
    return qr->x <= kr.y && kr.x <= qr->y;
  };
  // The first q tile each warpgroup computes: under causal masking the one
  // holding its first key's row; none when its keys start past s.
  auto first_tile = [&](int wg) {
    const int kw0 = k0 + 64 * wg;
    return kw0 >= s ? nq : (f.causal ? kw0 / BQ : 0);
  };

  if (warp >= kBwdConsumers / 32) {
    regs_dealloc<24>();
    if (warp == kBwdConsumers / 32) {
      // Producer: K and V once, then Q, dO, lse, delta (and the ids) of
      // each q tile the block walks through the ring.
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_s + c * kBwdBK * 128, &p.k, kv_bar, c * 64, ikv, k0,
                      ib);
          tma_load_4d(v_s + c * kBwdBK * 128, &p.v, kv_bar, c * 64, ikv, k0,
                      ib);
        }
      }
      const size_t rbase = (static_cast<size_t>(ib) * h + ih) * p.s_pad;
      const uint32_t tx = L::kStageTx + (seg != nullptr ? BQ * 4 : 0);
      int n = 0;
      for (int i = i0; i < nq; ++i) {
        int2 qr;
        if (!tile_needed(i, &qr)) continue;
        const int st = n % S;
        if (lane == 0) {
          mbar_wait(empty(st), ((n / S) & 1) ^ 1);
          mbar_expect_tx(full(st), tx);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(q_tile(st) + c * BQ * 128, &p.q, full(st), c * 64,
                        ih, i * BQ, ib);
            tma_load_4d(do_tile(st) + c * BQ * 128, &p.d, full(st), c * 64,
                        ih, i * BQ, ib);
          }
          bulk_load(smem_u32(rows(st)), f.lse + rbase + i * BQ, BQ * 4,
                    full(st));
          bulk_load(smem_u32(rows(st) + BQ), f.delta + rbase + i * BQ,
                    BQ * 4, full(st));
          if (seg != nullptr)
            bulk_load(smem_u32(rows(st) + 2 * BQ),
                      p.seg_pad + static_cast<size_t>(ib) * p.s_pad + i * BQ,
                      BQ * 4, full(st));
        }
        __syncwarp();
        ++n;
      }
    } else if (DQ && warp == kBwdConsumers / 32 + 1 && lane == 0) {
      // The dQ reducer. Q tile i receives the parts of the 64-key
      // sub-tiles at or above the causal diagonal (all of them without
      // causal masking): sub-tiles 0..i, of blocks 0..i / 2. They are added
      // in ascending sub-tile order, whatever the timing: this block holds
      // rank blockIdx.y among the blocks that reach tile i (blocks y <=
      // i / 2 under causal masking, all of them without), waits on tile
      // i's turn until the blocks before it have added their parts, adds
      // its warpgroups' parts in order (each waited complete), and passes
      // the turn. No deadlock: a block waits only on blocks of a lower
      // blockIdx.y of the same (head, batch), which the grid's order
      // (blockIdx.x fastest) dispatched before it, and those wait only on
      // blocks before them; block 0 waits on none.
      const int first0 = first_tile(0), first1 = first_tile(1);
      const size_t hb = static_cast<size_t>(ib) * h + ih;
      for (int i = first0; i < nq; ++i) {
        const Turn turn{f.turns + hb * (p.s_pad / BQ) + i};
        turn.wait(static_cast<int>(blockIdx.y));
        for (int wg = 0; wg < 2; ++wg) {
          const int m = i - (wg == 0 ? first0 : first1);
          if (m < 0) continue;
          mbar_wait(dq_full(wg, m % NB), (m / NB) & 1);
          bulk_reduce_add_f32(f.dq_acc + (hb * p.s_pad + i * BQ) * D,
                              smem_u32(dq_buf(wg, m % NB)), BQ * D * 4);
          bulk_commit();
          bulk_wait();
          mbar_arrive(dq_empty(wg, m % NB));
        }
        turn.pass();
      }
    }
  } else {
    regs_alloc<240>();
    // Consumers: warpgroup wg owns keys [kw0, kw0 + 64); this thread holds
    // key rows key_a and key_b = key_a + 8 of each transposed accumulator
    // (S^T, dP^T: [64 keys, 64 q]; dK, dV: [64 keys, D]).
    const int wg = warp >> 2;
    const int t4 = lane & 3;
    const int g8 = lane >> 2;
    const int kw0 = k0 + 64 * wg;
    const int ra = 16 * (warp & 3) + g8;  // key_a - kw0; also a q row of dQ
    const int key_a = kw0 + ra;
    const int key_b = key_a + 8;
    const float inv_keep = 1.f / f.keep_prob;
    const uint32_t hkey = dropout_hash::stream_key(
        f.seed, static_cast<uint32_t>(ib * h + ih));
    const Elem<T> et{};
    const uint32_t kw_s = k_s + wg * 64 * 128;  // this warpgroup's K rows
    const uint32_t vw_s = v_s + wg * 64 * 128;
    const uint32_t ds_s = smem_u32(base + L::kDsOffset) + wg * 64 * BQ * 2;
    // The warpgroup computes the q tiles [ifirst, nq) of the block's list;
    // with segments only those whose ids meet its own 64 keys'. It still
    // takes its turn in freeing the ring stages of the others.
    const int ifirst = first_tile(wg);
    const int2 wr =
        seg != nullptr ? seg_range_g(seg, kw0, 64, s) : make_int2(0, 0);
    const int kseg_a = seg != nullptr && key_a < s ? __ldg(seg + key_a) : -2;
    const int kseg_b = seg != nullptr && key_b < s ? __ldg(seg + key_b) : -2;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_bar, 0);

    int n = 0, m = 0;  // ring stages walked; dQ parts written
    for (int i = i0; i < nq; ++i) {
      int2 qr;
      if (!tile_needed(i, &qr)) continue;
      const int st = n % S;
      const int q0 = i * BQ;
      mbar_wait(full(st), (n / S) & 1);
      ++n;
      if (i < ifirst ||
          (seg != nullptr && !(qr.x <= wr.y && wr.x <= qr.y))) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
        continue;
      }
      // S^T = K Q^T and dP^T = V dO^T, keys as M: [64, 64] f32 each.
      float sc[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kBwdBK * 128 + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        wgmma_ss<0>(Shape<64>{}, et, sc, desc_sw128(kw_s + ko, 16, 1024),
                    desc_sw128(q_tile(st) + qo, 16, 1024), kk > 0 ? 1 : 0);
        wgmma_ss<0>(Shape<64>{}, et, dp, desc_sw128(vw_s + ko, 16, 1024),
                    desc_sw128(do_tile(st) + qo, 16, 1024), kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T = exp(S^T - lse) and dS^T = P^T (dP'^T - delta), with lse (in
      // log2 units), delta and the q ids broadcast along the columns (q)
      // and the masks and the dropout hash at (row = q, col = key). Only
      // the diagonal tile, the ragged key edge and segmented tiles need the
      // element masks (q rows past s have lse = +inf, so p = 0 there). A
      // masked element gets p = 0, what the reference's masked score
      // (-inf, or _SEG_MASK = -1e30 with segments) gives.
      const float* lse_r = rows(st);
      const float* dl_r = lse_r + BQ;
      const int* qseg_r = reinterpret_cast<const int*>(lse_r + 2 * BQ);
      const bool edge = seg != nullptr || kw0 + 63 >= s ||
                        (f.causal && q0 < kw0 + 63);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * t4;
        const float2 lz = *reinterpret_cast<const float2*>(lse_r + c);
        const float2 dz = *reinterpret_cast<const float2*>(dl_r + c);
        const int2 qz = seg != nullptr
                            ? *reinterpret_cast<const int2*>(qseg_r + c)
                            : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_a : key_b;
          const int q = q0 + c + (e & 1);
          float pv = fast_exp2(
              fmaf(sc[4 * jj + e], kLog2e, -((e & 1) ? lz.y : lz.x)));
          if (edge) {
            bool ok = key < s && (!f.causal || q >= key);
            if (seg != nullptr)
              ok = ok && ((e & 1) ? qz.y : qz.x) == (e < 2 ? kseg_a : kseg_b);
            if (!ok) pv = 0.f;
          }
          float dpv = dp[4 * jj + e];
          float pdv = pv;
          if (f.dropout) {
            const bool kp = dropout_hash::keep(
                hkey, static_cast<uint32_t>(q), static_cast<uint32_t>(key),
                static_cast<uint32_t>(s), f.threshold);
            pdv = kp ? pv : 0.f;
            dpv = kp ? dpv * inv_keep : 0.f;
          }
          sc[4 * jj + e] = pdv;
          dp[4 * jj + e] = pv * (dpv - ((e & 1) ? dz.y : dz.x));
        }
      }
      // P_drop^T and dS^T rounded to T as register A operands (k16 step kk
      // covers q columns 16 kk ..); DQ: dS^T also into shared memory, the A
      // operand (MN-major, q consecutive) of dQ = dS K.
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack2(et, sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          da[kk][r] = pack2(et, dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          if constexpr (DQ) {
            // register r holds row ra (+ 8 for odd r), n8 block 2 kk + r / 2
            const int row = ra + 8 * (r & 1);
            const int chunk = (2 * kk + (r >> 1)) ^ g8;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             ds_s + row * 128 + chunk * 16 + 4 * t4),
                         "r"(da[kk][r])
                         : "memory");
          }
        }
      if constexpr (DQ) {
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }

      // dV += P_drop^T dO and dK += dS^T Q (dO, Q MN-major); DQ: then
      // dQ_part = dS K in 64-column chunks (dS^T and K both MN-major) into
      // one of the warpgroup's dQ buffers, which the reducer adds into
      // dq_acc in order.
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<1>(Shape<D>{}, et, dv, pa[kk],
                    desc_sw128(do_tile(st) + kk * 16 * 128, BQ * 128, 1024),
                    1);
        wgmma_rs<1>(Shape<D>{}, et, dk, da[kk],
                    desc_sw128(q_tile(st) + kk * 16 * 128, BQ * 128, 1024),
                    1);
      }
      wgmma_commit();
      if constexpr (DQ) {
        float* dq_s = dq_buf(wg, m % NB);
        mbar_wait(dq_empty(wg, m % NB), ((m / NB) & 1) ^ 1);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          float dq[32];
#pragma unroll
          for (int x = 0; x < 32; ++x) dq[x] = 0.f;
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1, 1>(
                Shape<64>{}, et, dq,
                desc_sw128(ds_s + kk * 16 * 128, 64 * 128, 1024),
                desc_sw128(kw_s + ch * kBwdBK * 128 + kk * 16 * 128,
                           kBwdBK * 128, 1024),
                kk > 0 ? 1 : 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 64 * ch + 8 * jj + 2 * t4;
            *reinterpret_cast<float2*>(dq_s + ra * D + col) =
                make_float2(dq[4 * jj] * f.scale, dq[4 * jj + 1] * f.scale);
            *reinterpret_cast<float2*>(dq_s + (ra + 8) * D + col) =
                make_float2(dq[4 * jj + 2] * f.scale,
                            dq[4 * jj + 3] * f.scale);
          }
        }
        // The part is complete once each warp's writes are: one arrival a
        // warp, after the fence that orders them before the bulk read.
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(dq_full(wg, m % NB));
        ++m;
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    // Epilogue, through this warpgroup's first f32 buffer (DQ: once the
    // reducer has added its last part, and with it every earlier one): dK,
    // then dV, row by row into shared memory, then out with 16-byte reads,
    // each thread taking columns [c, c + 4) of a key row and their rotation
    // partners c + D/2 (dK un-rotated as unrope_elem rounds it; dV / (1 -
    // rate)). T at group 1, else f32 per-query-head partials.
    if constexpr (DQ) {
      if (m > 0) mbar_wait(dq_empty(wg, (m - 1) % NB), ((m - 1) / NB) & 1);
    }
    float* stage = dq_buf(wg, 0);
    const bool rope = f.cos != nullptr;
    const bool direct = h == f.kvh;
    auto stage_rows = [&](const float (&acc)[D / 2]) {
      named_barrier(1 + wg, 128);  // the staging tile is free
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t4;
        *reinterpret_cast<float2*>(stage + ra * D + col) =
            make_float2(acc[4 * jj], acc[4 * jj + 1]);
        *reinterpret_cast<float2*>(stage + (ra + 8) * D + col) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
      named_barrier(1 + wg, 128);
    };
    for (int which = 0; which < 2; ++which) {
      if (which == 0) {
        stage_rows(dk);
      } else {
        stage_rows(dv);
      }
      float* out = which == 0 ? f.dk : f.dv;
      for (int w = tid & 127; w < 64 * D / 8; w += 128) {
        const int r = w / (D / 8);
        const int c = (w % (D / 8)) * 4;
        const int key = kw0 + r;
        if (key >= s) continue;
        const float4 lo = *reinterpret_cast<const float4*>(stage + r * D + c);
        const float4 hi =
            *reinterpret_cast<const float4*>(stage + r * D + c + D / 2);
        float va[4] = {lo.x, lo.y, lo.z, lo.w};
        float vb[4] = {hi.x, hi.y, hi.z, hi.w};
        if (which == 0 && rope) {
          const float* cr = f.cos + static_cast<size_t>(key) * D;
          const float* sr = f.sin + static_cast<size_t>(key) * D;
          const float4 cl = __ldg(reinterpret_cast<const float4*>(cr + c));
          const float4 ch =
              __ldg(reinterpret_cast<const float4*>(cr + c + D / 2));
          const float4 sl = __ldg(reinterpret_cast<const float4*>(sr + c));
          const float4 sh =
              __ldg(reinterpret_cast<const float4*>(sr + c + D / 2));
          const float cla[4] = {cl.x, cl.y, cl.z, cl.w};
          const float cha[4] = {ch.x, ch.y, ch.z, ch.w};
          const float sla[4] = {sl.x, sl.y, sl.z, sl.w};
          const float sha[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float ga = va[x], gb = vb[x];
            va[x] = __fadd_rn(__fmul_rn(ga, cla[x]), __fmul_rn(gb, sha[x]));
            vb[x] = __fadd_rn(__fmul_rn(gb, cha[x]), -__fmul_rn(ga, sla[x]));
          }
        }
        if (which == 1 && f.dropout) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            va[x] /= f.keep_prob;
            vb[x] /= f.keep_prob;
          }
        }
        if (direct) {
          T* o = static_cast<T*>(static_cast<void*>(out)) +
                 ((static_cast<size_t>(ib) * s + key) * f.kvh + ikv) * D + c;
          *reinterpret_cast<uint2*>(o) =
              make_uint2(pack2(et, va[0], va[1]), pack2(et, va[2], va[3]));
          *reinterpret_cast<uint2*>(o + D / 2) =
              make_uint2(pack2(et, vb[0], vb[1]), pack2(et, vb[2], vb[3]));
        } else {
          float* o = out + ((static_cast<size_t>(ib) * s + key) * h + ih) * D + c;
          *reinterpret_cast<float4*>(o) = make_float4(va[0], va[1], va[2], va[3]);
          *reinterpret_cast<float4*>(o + D / 2) =
              make_float4(vb[0], vb[1], vb[2], vb[3]);
        }
      }
    }
  }
}

// -- the bf16/fp16 split dq kernel: TMA ring, wgmma, dQ in registers --------

constexpr int kDqBQ = 128;                // q rows a block: two warpgroups of 64
constexpr int kDqConsumers = 256;         // two consumer warpgroups
constexpr int kDqTmaThreads = kDqConsumers + 128;  // + a producer warpgroup

// Shared memory of the split dq kernel at head dim D (tiles 1024-byte
// aligned): the block's Q and dO tiles (D / 64 boxes of [128 q][64] each), a
// ring of K/V stages (D / 64 boxes of [BK keys][64] for K, then for V), the
// segment ids of each stage's keys, and the mbarriers. BK = 64 keys: at
// D = 128 S, dP and dQ in f32 registers would not fit beside a 128-key
// tile, and at D = 64 a 128-key tile (or a ring of 2 or 4 stages) measured
// the same time and spilled (scripts/torch_kernel_variants.py).
template <int D>
struct DqTmaSmem {
  static constexpr int BK = 64;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kDqBQ * D * 2;    // the Q or the dO tile
  static constexpr int kTileBytes = BK * D * 2;    // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingOffset = 2 * kQBytes;
  static constexpr int kSegOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kBarOffset = kSegOffset + kStages * BK * 4;
  // q barrier, then full[kStages], then empty[kStages]
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

struct DqTmaParams {
  CUtensorMap q;   // qs [b, s, h, D]: boxes {64, 1, 128, 1}
  CUtensorMap d;   // dout [b, s, h, D]: the same boxes
  CUtensorMap k;   // ks [b, s, kvh, D]: boxes {64, 1, BK, 1}
  CUtensorMap v;   // v [b, s, kvh, D]: the same boxes
  BwdParams f;     // lse [b, h, s]; delta [b, h, s_pad]; dq [b, s, h, D] in
                   // T; seg [b, s] ids or null
};

// The split backward's dq kernel (tpu_trainer/ops/flash.py::_bwd_dq_kernel),
// bf16/fp16: one block per (128-row q tile, head, batch), the q tiles with
// the most causal work first (blockIdx.y counts down the diagonal). Warps 0-7
// are two consumer warpgroups of 64 q rows with dQ in registers over the
// whole k walk; warpgroup 2 is the producer (warp 8 loads). The f32
// instantiation takes flash_bwd_dq_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kDqTmaThreads, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ DqTmaParams p) {
  using namespace hopper;
  using L = DqTmaSmem<D>;
  constexpr int BK = L::BK;
  constexpr int S = L::kStages;
  const BwdParams& f = p.f;
  const int s = f.s, h = f.h;
  const int ih = blockIdx.x % h;
  const int ib = blockIdx.x / h;
  const int nq = (s + kDqBQ - 1) / kDqBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kDqBQ;
  const int ikv = ih / (h / f.kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* seg =
      f.seg != nullptr ? f.seg + static_cast<size_t>(ib) * s : nullptr;
  const int nk = (s + BK - 1) / BK;
  const int jend = f.causal ? min((q0 + kDqBQ + BK - 1) / BK, nk) : nk;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(base);
  const uint32_t do_s = q_s + L::kQBytes;
  const uint32_t ring = q_s + L::kRingOffset;
  int* kseg_ring = reinterpret_cast<int*>(base + L::kSegOffset);  // [S][BK]
  const uint32_t bars = smem_u32(base + L::kBarOffset);
  const uint32_t q_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + S + st); };
  auto k_tile = [&](int st) { return ring + st * L::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kDqConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Segments: the block walks the k tiles whose id interval meets its q
  // tile's (the dk/dv kernel's rule, mirrored). Each warp evaluates it alike,
  // so producer and consumers walk one list (a mismatch hangs).
  const int2 qr =
      seg != nullptr ? seg_range_g(seg, q0, kDqBQ, s) : make_int2(0, 0);
  auto tile_needed = [&](int j, int2* kr) {
    if (seg == nullptr) return true;
    *kr = seg_range_g(seg, j * BK, BK, s);
    return qr.x <= kr->y && kr->x <= qr.y;
  };

  if (warp >= kDqConsumers / 32) {
    regs_dealloc<24>();
    if (warp == kDqConsumers / 32) {
      // Producer: Q and dO once, then K, V and the keys' ids of each k tile
      // the block walks. The ids (-1 past s) are written by the warp's lanes
      // into the stage before lane 0's arrival completes it.
      if (lane == 0) {
        mbar_expect_tx(q_bar, 2 * L::kQBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(q_s + c * kDqBQ * 128, &p.q, q_bar, c * 64, ih, q0, ib);
          tma_load_4d(do_s + c * kDqBQ * 128, &p.d, q_bar, c * 64, ih, q0,
                      ib);
        }
      }
      int n = 0;
      for (int j = 0; j < jend; ++j) {
        int2 kr;
        if (!tile_needed(j, &kr)) continue;
        const int st = n % S;
        const int k0 = j * BK;
        mbar_wait(empty(st), ((n / S) & 1) ^ 1);
        if (seg != nullptr) {
          int* ids = kseg_ring + st * BK;
          for (int i = lane; i < BK; i += 32)
            ids[i] = k0 + i < s ? __ldg(seg + k0 + i) : -1;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(full(st), L::kStageBytes);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(k_tile(st) + c * BK * 128, &p.k, full(st), c * 64,
                        ikv, k0, ib);
            tma_load_4d(v_tile(st) + c * BK * 128, &p.v, full(st), c * 64,
                        ikv, k0, ib);
          }
        }
        __syncwarp();
        ++n;
      }
    }
    return;
  }

  regs_alloc<240>();
  // Consumers: warpgroup wg owns q rows [wg_row0, wg_row0 + 64); this thread
  // holds rows row_a and row_b = row_a + 8 of each accumulator (S, dP: [64,
  // BK]; dQ: [64, D]), and their lse (log2 units), delta and segment ids.
  const int wg = warp >> 2;
  const int t4 = lane & 3;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + 16 * (warp & 3) + (lane >> 2);
  const int row_b = row_a + 8;
  const bool wg_live = wg_row0 < s;
  const size_t hb = static_cast<size_t>(ib) * h + ih;
  const int s_pad = pad_rows(s);
  // Rows past s: lse = +inf, so p = 0 there (nothing of them is written).
  const float lse_a = row_a < s ? f.lse[hb * s + row_a] * kLog2e : INFINITY;
  const float lse_b = row_b < s ? f.lse[hb * s + row_b] * kLog2e : INFINITY;
  const float dl_a = row_a < s ? f.delta[hb * s_pad + row_a] : 0.f;
  const float dl_b = row_b < s ? f.delta[hb * s_pad + row_b] : 0.f;
  const int qseg_a = seg != nullptr && row_a < s ? __ldg(seg + row_a) : -2;
  const int qseg_b = seg != nullptr && row_b < s ? __ldg(seg + row_b) : -2;
  const int2 wr =
      seg != nullptr ? seg_range_g(seg, wg_row0, 64, s) : make_int2(0, 0);
  const float inv_keep = 1.f / f.keep_prob;
  const uint32_t hkey = dropout_hash::stream_key(
      f.seed, static_cast<uint32_t>(ib * h + ih));
  const Elem<T> et{};

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_bar, 0);

  int n = 0;
  for (int j = 0; j < jend; ++j) {
    const int k0 = j * BK;
    int2 kr;
    if (!tile_needed(j, &kr)) continue;
    const int st = n % S;
    mbar_wait(full(st), (n / S) & 1);
    ++n;
    // The warpgroup computes the listed tiles that reach its rows: not
    // wholly above their diagonal, and with segments meeting their ids. It
    // frees every stage either way.
    if (wg_live && (!f.causal || k0 <= wg_row0 + 63) &&
        (seg == nullptr || (wr.x <= kr.y && kr.x <= wr.y))) {
      // S = Q K^T and dP = dO V^T: [64, BK] f32 each.
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qo = (kk / 4) * kDqBQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_ss<0>(Shape<BK>{}, et, sc, desc_sw128(q_s + qo, 16, 1024),
                    desc_sw128(k_tile(st) + ko, 16, 1024), kk > 0 ? 1 : 0);
        wgmma_ss<0>(Shape<BK>{}, et, dp, desc_sw128(do_s + qo, 16, 1024),
                    desc_sw128(v_tile(st) + ko, 16, 1024), kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP' - delta), P = exp(S - lse), into sc. The masks (causal,
      // ragged keys, segments) only on tiles that touch the diagonal, the
      // ragged edge or segments; a masked element gets p = 0, what the
      // reference's masked score (-inf, or -1e30 with segments) gives.
      const bool edge = seg != nullptr || k0 + BK > s ||
                        (f.causal && k0 + BK - 1 > wg_row0);
      const int* kseg = kseg_ring + st * BK;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const int c = 8 * jj + 2 * t4;
        const int2 kz = seg != nullptr ? *reinterpret_cast<const int2*>(kseg + c)
                                       : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_a : row_b;
          const int col = k0 + c + (e & 1);
          float pv = fast_exp2(
              fmaf(sc[4 * jj + e], kLog2e, -(e < 2 ? lse_a : lse_b)));
          if (edge) {
            bool ok = col < s && (!f.causal || col <= row);
            if (seg != nullptr)
              ok = ok && ((e & 1) ? kz.y : kz.x) == (e < 2 ? qseg_a : qseg_b);
            if (!ok) pv = 0.f;
          }
          float dpv = dp[4 * jj + e];
          if (f.dropout)
            dpv = dropout_hash::keep(hkey, static_cast<uint32_t>(row),
                                     static_cast<uint32_t>(col),
                                     static_cast<uint32_t>(s), f.threshold)
                      ? dpv * inv_keep
                      : 0.f;
          sc[4 * jj + e] = pv * (dpv - (e < 2 ? dl_a : dl_b));
        }
      }
      // dQ += dS K: dS rounded to T as the register A operand (k16 step kk
      // covers keys 16 kk ..), K read MN-major through the transpose bit.
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack2(et, sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(dq);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(Shape<D>{}, et, dq, da[kk],
                    desc_sw128(k_tile(st) + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }
  if (!wg_live) return;

  // Epilogue: dq = unrotate(scale * dQ), cast to T once, masked at s.
  // Columns c and c + D/2 (the rotation's partners) are this thread's:
  // n8 blocks jj and jj + D/16. Rounded as unrope_elem rounds.
  T* out = static_cast<T*>(f.dq);
  const bool rope = f.cos != nullptr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? row_a : row_b;
    if (row >= s) continue;
    T* orow = out + ((static_cast<size_t>(ib) * s + row) * h + ih) * D;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const int c = 8 * jj + 2 * t4;
      float a[2], b[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[e] = dq[4 * jj + 2 * half + e] * f.scale;
        b[e] = dq[4 * (jj + D / 16) + 2 * half + e] * f.scale;
      }
      if (rope) {
        const float2 cl = __ldg(reinterpret_cast<const float2*>(
            f.cos + static_cast<size_t>(row) * D + c));
        const float2 ch = __ldg(reinterpret_cast<const float2*>(
            f.cos + static_cast<size_t>(row) * D + c + D / 2));
        const float2 sl = __ldg(reinterpret_cast<const float2*>(
            f.sin + static_cast<size_t>(row) * D + c));
        const float2 sh = __ldg(reinterpret_cast<const float2*>(
            f.sin + static_cast<size_t>(row) * D + c + D / 2));
        const float cla[2] = {cl.x, cl.y}, cha[2] = {ch.x, ch.y};
        const float sla[2] = {sl.x, sl.y}, sha[2] = {sh.x, sh.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ga = a[e], gb = b[e];
          a[e] = __fadd_rn(__fmul_rn(ga, cla[e]), __fmul_rn(gb, sha[e]));
          b[e] = __fadd_rn(__fmul_rn(gb, cha[e]), -__fmul_rn(ga, sla[e]));
        }
      }
      *reinterpret_cast<uint32_t*>(orow + c) = pack2(et, a[0], a[1]);
      *reinterpret_cast<uint32_t*>(orow + c + D / 2) = pack2(et, b[0], b[1]);
    }
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

// The first design's square tile: only its f32 instantiations remain (the
// checking path; every 16-bit call takes a TMA/wgmma kernel).
template <typename T>
constexpr int tile_of() {
  static_assert(std::is_same<T, float>::value, "the f32 checking path only");
  return 32;
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
cudaError_t launch_fwd_tma(const FwdParams& p, cudaStream_t stream) {
  using L = FwdTmaSmem<D>;
  FwdTmaParams a;
  a.f = p;
  const bool fp16 = std::is_same<T, __half>::value;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dq[4] = {D, static_cast<cuuint64_t>(p.h),
                            static_cast<cuuint64_t>(p.s),
                            static_cast<cuuint64_t>(p.b)};
  const cuuint64_t sq[3] = {D * e, p.h * D * e,
                            static_cast<cuuint64_t>(p.s) * p.h * D * e};
  const cuuint64_t dk[4] = {D, static_cast<cuuint64_t>(p.kvh),
                            static_cast<cuuint64_t>(p.s),
                            static_cast<cuuint64_t>(p.b)};
  const cuuint64_t sk[3] = {D * e, p.kvh * D * e,
                            static_cast<cuuint64_t>(p.s) * p.kvh * D * e};
  const cuuint32_t box_q[4] = {64, 1, kFwdBQ, 1};
  const cuuint32_t box_kv[4] = {64, 1, kFwdBK, 1};
  cudaError_t err = hopper_host::make_map(&a.q, fp16, 4, p.qs, dq, sq, box_q);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&a.k, fp16, 4,
                                p.cos != nullptr ? p.ks : p.k, dk, sk,
                                box_kv);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&a.v, fp16, 4, p.v, dk, sk, box_kv);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tma_kernel<T, D>;
  err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.h * p.b, (p.s + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, kFwdTmaThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
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
  if constexpr (std::is_same<T, float>::value) {
    constexpr int B = tile_of<T>();
    const size_t smem = fwd_smem<T, D>();
    auto kernel = flash_fwd_kernel<T, D, B>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.s + B - 1) / B, p.h, p.b);
    kernel<<<grid, kFwdThreads, smem, stream>>>(p);
    return cudaGetLastError();
  } else {
    return launch_fwd_tma<T, D>(p, stream);
  }
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

template <typename T, int D, bool HEAD_MAJOR>
cudaError_t launch_dq_finalize(const BwdParams& p, int s_pad,
                               cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(p.b) * p.s * p.h;
  const size_t n = rows * (D / 8);
  const unsigned blocks =
      static_cast<unsigned>(n / 256 + 1 < 65535 ? n / 256 + 1 : 65535);
  dq_finalize_kernel<T, D, HEAD_MAJOR><<<blocks, 256, 0, stream>>>(
      p.dq_acc, p.cos, p.sin, static_cast<T*>(p.dq), rows, p.s, p.h, s_pad);
  return cudaGetLastError();
}

// The first design's fused backward (DQ) or split dk/dv kernel, the f32
// checking path, after delta.
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
    if (err == cudaSuccess)
      err = cudaMemsetAsync(p.turns, 0,
                            static_cast<size_t>(p.b) * p.h *
                                ((p.s + B - 1) / B) * sizeof(int),
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
  if constexpr (DQ) {
    if (err != cudaSuccess) return err;
    return launch_dq_finalize<T, D, false>(p, 0, stream);
  }
  return err;
}

// The bf16/fp16 backwards: the pre-pass, flash_bwd_tma_kernel<DQ> and (DQ)
// the finalize. scratch: delta_pad then lse_pad, [b, h, s_pad] f32 each,
// then (with segments) seg_pad [b, s_pad] int32; DQ: p.dq_acc [b, h, s_pad,
// D] f32 and p.turns [b, h, s_pad / 64] int32.
template <typename T, int D, bool DQ>
cudaError_t launch_bwd_tma(const BwdParams& p, const void* o, float* scratch,
                           cudaStream_t stream) {
  using L = BwdTmaSmem<D, DQ>;
  const int s_pad = pad_rows(p.s);
  const size_t rows = static_cast<size_t>(p.b) * p.h * s_pad;
  float* delta_pad = scratch;
  float* lse_pad = scratch + rows;
  int* seg_pad =
      p.seg != nullptr ? reinterpret_cast<int*>(scratch + 2 * rows) : nullptr;
  const size_t threads = rows * (D / 8);
  bwd_prep_kernel<T, D><<<static_cast<unsigned>((threads + 255) / 256), 256,
                          0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(p.dout), p.lse, p.seg,
      lse_pad, delta_pad, seg_pad, DQ ? p.dq_acc : nullptr,
      DQ ? p.turns : nullptr, rows, p.s, p.h, s_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  BwdTmaParams a;
  a.f = p;
  a.f.lse = lse_pad;
  a.f.delta = delta_pad;
  a.seg_pad = seg_pad;
  a.s_pad = s_pad;
  const bool fp16 = std::is_same<T, __half>::value;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dq[4] = {D, static_cast<cuuint64_t>(p.h),
                            static_cast<cuuint64_t>(p.s),
                            static_cast<cuuint64_t>(p.b)};
  const cuuint64_t sq[3] = {D * e, p.h * D * e,
                            static_cast<cuuint64_t>(p.s) * p.h * D * e};
  const cuuint64_t dk[4] = {D, static_cast<cuuint64_t>(p.kvh),
                            static_cast<cuuint64_t>(p.s),
                            static_cast<cuuint64_t>(p.b)};
  const cuuint64_t sk[3] = {D * e, p.kvh * D * e,
                            static_cast<cuuint64_t>(p.s) * p.kvh * D * e};
  const cuuint32_t box_q[4] = {64, 1, kBwdBQ, 1};
  const cuuint32_t box_k[4] = {64, 1, kBwdBK, 1};
  err = hopper_host::make_map(&a.q, fp16, 4, p.qs, dq, sq, box_q);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&a.d, fp16, 4, p.dout, dq, sq, box_q);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&a.k, fp16, 4, p.ks, dk, sk, box_k);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&a.v, fp16, 4, p.v, dk, sk, box_k);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_tma_kernel<T, D, DQ>;
  err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.h * p.b, (p.s + kBwdBK - 1) / kBwdBK);
  kernel<<<grid, kBwdTmaThreads, L::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DQ) return err;
  return launch_dq_finalize<T, D, true>(p, s_pad, stream);
}

// The split dq kernel: the first design for f32 (the checking path),
// flash_bwd_dq_tma_kernel for bf16/fp16.
template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int B = tile_of<T>();
    const size_t smem = dq_smem<T, D>();
    auto kernel = flash_bwd_dq_kernel<T, D, B>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.s + B - 1) / B, p.h, p.b);
    kernel<<<grid, kBwdThreads, smem, stream>>>(p);
    return cudaGetLastError();
  } else {
    using L = DqTmaSmem<D>;
    DqTmaParams a;
    a.f = p;
    const bool fp16 = std::is_same<T, __half>::value;
    const cuuint64_t e = sizeof(T);
    const cuuint64_t dq[4] = {D, static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.s),
                              static_cast<cuuint64_t>(p.b)};
    const cuuint64_t sq[3] = {D * e, p.h * D * e,
                              static_cast<cuuint64_t>(p.s) * p.h * D * e};
    const cuuint64_t dk[4] = {D, static_cast<cuuint64_t>(p.kvh),
                              static_cast<cuuint64_t>(p.s),
                              static_cast<cuuint64_t>(p.b)};
    const cuuint64_t sk[3] = {D * e, p.kvh * D * e,
                              static_cast<cuuint64_t>(p.s) * p.kvh * D * e};
    const cuuint32_t box_q[4] = {64, 1, kDqBQ, 1};
    const cuuint32_t box_k[4] = {64, 1, L::BK, 1};
    cudaError_t err = hopper_host::make_map(&a.q, fp16, 4, p.qs, dq, sq, box_q);
    if (err == cudaSuccess)
      err = hopper_host::make_map(&a.d, fp16, 4, p.dout, dq, sq, box_q);
    if (err == cudaSuccess)
      err = hopper_host::make_map(&a.k, fp16, 4, p.ks, dk, sk, box_k);
    if (err == cudaSuccess)
      err = hopper_host::make_map(&a.v, fp16, 4, p.v, dk, sk, box_k);
    if (err != cudaSuccess) return err;
    auto kernel = flash_bwd_dq_tma_kernel<T, D>;
    err = allow_smem(kernel, L::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid(p.h * p.b, (p.s + kDqBQ - 1) / kDqBQ);
    kernel<<<grid, kDqTmaThreads, L::kBytes, stream>>>(a);
    return cudaGetLastError();
  }
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

// Length in int32 of the fused backward's `turns` scratch: one a (b, h, q
// tile) of the kernel that `dtype` selects.
extern "C" long long flash_attn_bwd_turns(int b, int s, int h, int dtype) {
  constexpr int kF32Tile = tile_of<float>();
  const int tiles =
      dtype == 0 ? (s + kF32Tile - 1) / kF32Tile : pad_rows(s) / kBwdBQ;
  return static_cast<long long>(b) * h * tiles;
}

// The fused backward. qs / ks / v / o / dout in `dtype`; lse [b, h, s] f32;
// dq [b, s, h, d] in dtype. Scratch, with s_pad = s rounded up to 64:
// delta 2 * b * h * s_pad f32, dq_acc b * h * s_pad * d f32, turns of
// flash_attn_bwd_turns int32. dk / dv: f32 [b, s, h, d] per-query-head partials,
// except for bf16/fp16 at h == kvh, where they are dk / dv themselves, [b,
// s, kvh, d] in dtype. dq, dk and dv are bitwise the same from run to run.
extern "C" int flash_attn_bwd(const void* qs, const void* ks, const void* v,
                              const void* o, const void* dout, const void* lse,
                              const void* cos, const void* sin, void* delta,
                              void* dq_acc, void* turns, void* dq, void* dk,
                              void* dv, int b,
                              int s, int h, int kvh, int d, int dtype,
                              int causal, float scale, uint32_t seed,
                              uint32_t threshold, float keep_prob, int dropout,
                              void* stream) {
  if (bad_dims(b, s, h, kvh) || (cos == nullptr) != (sin == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{qs, ks, v, dout, static_cast<const float*>(lse), nullptr,
              static_cast<const float*>(cos), static_cast<const float*>(sin),
              nullptr, static_cast<float*>(dq_acc), dq,
              static_cast<float*>(dk), static_cast<float*>(dv),
              static_cast<int*>(turns), b, s, h, kvh, causal, dropout, scale,
              keep_prob, seed, threshold};
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    if constexpr (std::is_same<T, float>::value) {
      return launch_kv<T, D, true>(p, o, dl, st);
    } else {
      return launch_bwd_tma<T, D, true>(p, o, dl, st);
    }
  }));
}

// The split backward's first half: delta and the dk/dv kernel. seg: int32
// [b, s] or null. `delta`: scratch of 2 * b * h * s_pad + b * s_pad floats
// (s_pad = s rounded up to 64), whose first b * h * s_pad hold delta [b, h,
// s_pad] for the dq half. dk / dv: as flash_attn_bwd's.
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
              static_cast<float*>(dk), static_cast<float*>(dv), nullptr, b, s,
              h, kvh, causal, dropout, scale, keep_prob, seed, threshold};
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto t, auto dd) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value;
    if constexpr (std::is_same<T, float>::value) {
      return launch_kv<T, D, false>(p, o, dl, st);
    } else {
      return launch_bwd_tma<T, D, false>(p, o, dl, st);
    }
  }));
}

// The split backward's second half: dq [b, s, h, d] in dtype from the
// residuals and the delta [b, h, s_pad] of flash_attn_bwd_dkv.
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
              static_cast<const int*>(seg), nullptr, dq, nullptr, nullptr,
              nullptr, b, s, h, kvh, causal, dropout, scale, keep_prob, seed,
              threshold};
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
