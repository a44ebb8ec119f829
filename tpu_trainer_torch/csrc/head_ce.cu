// Fused LM-head + cross-entropy forward for Hopper (sm_90a): logits of the
// tied head, stored vocab-major in the compute type, with the softmax
// statistics folded in while each logits tile is still on the chip.
//
// Replaces the Pallas TPU kernel tpu_trainer/ops/head_ce.py::
// _head_ce_fwd_kernel (head_ce.py:67, the pallas_call at :144). The Python
// wrapper is tpu_trainer_torch/ops/head_ce.py::head_ce_forward.
//
// Bound on this card: operations. At the training shape (T = 8192 tokens,
// H = 768, V = 50257) the product is 2*T*V*H = 632 GFLOP against some
// 0.9 GB to move (E and x once, the bf16 logits written once), ~700 flops
// a byte, above the H100's ~295 flops/byte bf16 balance point (989 TFLOP/s
// over 3.35 TB/s, NVIDIA data sheet): the tensor cores are the limit.
//
// Design:
// - The logits product is in this kernel: nvcuda::wmma 16x16x16 bf16/fp16
//   fragments with f32 accumulators, a 128 (vocab) x 128 (token) tile per
//   block, the hidden dim walked in chunks of 32 staged in shared memory.
//   The next chunk is fetched into registers (16-byte loads) while the
//   current one is multiplied, so its memory latency hides behind the
//   products.
// - Each tile is stored vocab-major [V, T] in the compute type (the layout
//   the backward's two matrix products consume, head_ce.py:73-90). Rows at
//   or past V are masked to -1e30. The label logit is taken from the f32
//   accumulator before rounding (head_ce.py:92-95).
// - The TPU carries (max, scaled exp-sum, label logit) across vocab tiles
//   in scratch over a sequential grid (head_ce.py:97-119). Here the vocab
//   is split across blocks: block (token tile, split) walks its split's
//   vocab tiles in a loop with the running statistics of its 128 tokens in
//   registers (two threads a token, each over half of a tile's rows), writes
//   per-split partials, and a small
//   second kernel merges the splits (the recombination flash_decode.cu
//   uses). The split count fills the card: T/128 token tiles alone are
//   fewer blocks than SMs at T = 8192.
//
// Plain C interface (nvcc into a shared library, loaded with ctypes);
// head_ce_fwd returns cudaGetLastError() after its launches, on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along the vocab x 2 along tokens
constexpr int kBV = 128;       // vocab rows of a tile
constexpr int kBT = 128;       // tokens of a tile
constexpr int kKC = 32;        // hidden chunk staged in shared memory
constexpr float kNeg = -1e30f; // -inf stand-in (no inf - inf)
static_assert(kThreads == 2 * kBT, "two threads a token in the statistics");

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __float2half(0.f);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Stage rows [r0, r0 + kRows) x cols [k0, k0 + kKC) of a row-major
// [n_rows, H] matrix into dst[kRows][kKC], zero past either edge, one
// element at a time: the path for H % (16 / sizeof(T)) != 0, where rows
// do not start 16-byte aligned.
template <typename T, int kRows>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int n_rows,
                                      int k0, int H) {
  for (int e = threadIdx.x; e < kRows * kKC; e += blockDim.x) {
    const int r = e / kKC;
    const int c = e - r * kKC;
    dst[e] = (r0 + r < n_rows && k0 + c < H)
                 ? src[static_cast<size_t>(r0 + r) * H + k0 + c]
                 : zero<T>();
  }
}

// The register half of a software pipeline over hidden chunks: fetch
// (16-byte loads into registers) the chunk the block will multiply next
// while the tensor cores work on the current one, then put it in shared
// memory after the next barrier. Needs H % (16 / sizeof(T)) == 0.
template <typename T, int kRows>
struct ChunkRegs {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPer = kRows * (kKC / kVec) / kThreads;
  uint4 r[kPer];

  __device__ __forceinline__ void fetch(const T* src, int r0, int n_rows,
                                        int k0, int H) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int row = e / (kKC / kVec);
      const int c = (e - row * (kKC / kVec)) * kVec;
      r[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < n_rows && k0 + c < H)
        r[i] = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r0 + row) * H + k0 + c);
    }
  }

  __device__ __forceinline__ void put(T* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      *reinterpret_cast<uint4*>(dst + (threadIdx.x + i * kThreads) * kVec) =
          r[i];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) head_ce_tile_kernel(
    const T* __restrict__ x,         // [T, H]
    const T* __restrict__ emb,       // [V, H]
    const int* __restrict__ labels,  // [T]
    T* __restrict__ logits_t,        // [V, T]
    float* __restrict__ m_part,      // [n_splits, T]
    float* __restrict__ s_part,      // [n_splits, T]
    float* __restrict__ ll_part,     // [n_splits, T]
    int n_tok, int H, int V, int tiles_per_split) {
  using namespace nvcuda;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  const int nv = (V + kBV - 1) / kBV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(nv, vt_begin + tiles_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wv = warp & 3;   // vocab rows wv*32 .. +32
  const int wt = warp >> 2;  // tokens wt*64 .. +64
  const bool vec = (H % (16 / sizeof(T))) == 0;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* e_s = reinterpret_cast<T*>(smem_raw);               // [kBV, kKC]
  T* x_s = e_s + kBV * kKC;                              // [kBT, kKC]
  float* c_s = reinterpret_cast<float*>(x_s + kBT * kKC);  // [kBV, kBT]
  float* red_s = c_s + kBV * kBT;                        // [3, kBT]

  // Running statistics of token t0 + tid (threads < kBT).
  const int tok = t0 + tid;
  const bool own = tid < kBT && tok < n_tok;
  // The label of this thread's token (both threads of a token read it).
  const int label =
      t0 + tid % kBT < n_tok ? labels[t0 + tid % kBT] : -1;
  float run_m = kNeg, run_s = 0.f, run_ll = 0.f;

  // One flat loop over this split's (vocab tile, hidden chunk) pairs, so
  // the fetch of the next pair's chunk (into registers, vec only) overlaps
  // the current pair's products.
  const int nkc = (H + kKC - 1) / kKC;
  const int total = (vt_end - vt_begin) * nkc;
  ChunkRegs<T, kBV> e_next;
  ChunkRegs<T, kBT> x_next;
  if (vec && total > 0) {
    e_next.fetch(emb, vt_begin * kBV, V, 0, H);
    x_next.fetch(x, t0, n_tok, 0, H);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  for (int it = 0; it < total; ++it) {
    const int v0 = (vt_begin + it / nkc) * kBV;
    const int k0 = (it % nkc) * kKC;
    if (k0 == 0) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);
    }
    __syncthreads();  // the previous chunk's readers are done
    if (vec) {
      e_next.put(e_s);
      x_next.put(x_s);
    } else {
      stage<T, kBV>(e_s, emb, v0, V, k0, H);
      stage<T, kBT>(x_s, x, t0, n_tok, k0, H);
    }
    __syncthreads();
    if (vec && it + 1 < total) {
      const int nv0 = (vt_begin + (it + 1) / nkc) * kBV;
      const int nk0 = ((it + 1) % nkc) * kKC;
      e_next.fetch(emb, nv0, V, nk0, H);
      x_next.fetch(x, t0, n_tok, nk0, H);
    }
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], e_s + (wv * 32 + a * 16) * kKC + kk,
                               kKC);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wmma::load_matrix_sync(fb[b], x_s + (wt * 64 + b * 16) * kKC + kk,
                               kKC);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    if (k0 + kKC < H) continue;

    // The tile's last chunk: logits and statistics.
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wmma::store_matrix_sync(
            c_s + (wv * 32 + a * 16) * kBT + wt * 64 + b * 16, acc[a][b], kBT,
            wmma::mem_row_major);
    __syncthreads();

    // Vocab-major logits in the compute type (coalesced along tokens).
    for (int e = tid; e < kBV * kBT; e += blockDim.x) {
      const int r = e / kBT;
      const int c = e - r * kBT;
      if (v0 + r < V && t0 + c < n_tok)
        logits_t[static_cast<size_t>(v0 + r) * n_tok + t0 + c] =
            from_f32<T>(c_s[e]);
    }
    // Online statistics: two threads a token, each over half the tile's
    // rows (rows past V count as -1e30); the upper half hands its partial
    // (max, exp-sum, label logit) to the lower through shared memory.
    {
      const int col = tid % kBT;
      const int r0 = (tid / kBT) * (kBV / 2);
      float mx = kNeg, hit = 0.f;
      for (int r = r0; r < r0 + kBV / 2; ++r) {
        const float lg = v0 + r < V ? c_s[r * kBT + col] : kNeg;
        mx = fmaxf(mx, lg);
        if (v0 + r == label) hit += lg;
      }
      float sum = 0.f;
      for (int r = r0; r < r0 + kBV / 2; ++r) {
        const float lg = v0 + r < V ? c_s[r * kBT + col] : kNeg;
        sum += expf(lg - mx);
      }
      if (tid >= kBT) {
        red_s[col] = mx;
        red_s[kBT + col] = sum;
        red_s[2 * kBT + col] = hit;
      }
      __syncthreads();
      if (tid < kBT) {
        const float m1 = red_s[col];
        const float m_tile = fmaxf(mx, m1);
        const float s_tile =
            sum * expf(mx - m_tile) + red_s[kBT + col] * expf(m1 - m_tile);
        const float m_new = fmaxf(run_m, m_tile);
        run_s = run_s * expf(run_m - m_new) + s_tile * expf(m_tile - m_new);
        run_m = m_new;
        run_ll += hit + red_s[2 * kBT + col];
      }
    }
  }
  if (own) {
    const size_t o = static_cast<size_t>(split) * n_tok + tok;
    m_part[o] = run_m;
    s_part[o] = run_s;
    ll_part[o] = run_ll;
  }
}

__global__ void head_ce_merge_kernel(const float* __restrict__ m_part,
                                     const float* __restrict__ s_part,
                                     const float* __restrict__ ll_part,
                                     float* __restrict__ lse,
                                     float* __restrict__ ll, int n_tok,
                                     int n_splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tok) return;
  float m = kNeg;
  for (int i = 0; i < n_splits; ++i)
    m = fmaxf(m, m_part[static_cast<size_t>(i) * n_tok + t]);
  float s = 0.f, l = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const size_t o = static_cast<size_t>(i) * n_tok + t;
    s += s_part[o] * expf(m_part[o] - m);
    l += ll_part[o];
  }
  lse[t] = m + logf(s);
  ll[t] = l;
}

template <typename T>
cudaError_t launch(const void* x, const void* emb, const int* labels,
                   void* logits_t, float* m_part, float* s_part,
                   float* ll_part, float* lse, float* ll, int n_tok, int H,
                   int V, int n_splits, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (kBV + kBT) * kKC +
                      sizeof(float) * (kBV * kBT + 3 * kBT);
  auto kernel = head_ce_tile_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nv = (V + kBV - 1) / kBV;
  const int tps = (nv + n_splits - 1) / n_splits;
  dim3 grid((n_tok + kBT - 1) / kBT, n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(emb), labels,
      static_cast<T*>(logits_t), m_part, s_part, ll_part, n_tok, H, V, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_ce_merge_kernel<<<(n_tok + 255) / 256, 256, 0, stream>>>(
      m_part, s_part, ll_part, lse, ll, n_tok, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (x, emb, logits_t). labels int32 [T];
// m/s/ll_part f32 [n_splits, T] scratch; lse, ll f32 [T]. Returns a
// cudaError_t code (0 = launched).
extern "C" int head_ce_fwd(const void* x, const void* emb, const void* labels,
                           void* logits_t, void* m_part, void* s_part,
                           void* ll_part, void* lse, void* ll, int n_tok,
                           int H, int V, int n_splits, int dtype,
                           void* stream) {
  if (n_tok <= 0 || H <= 0 || V <= 0 || n_splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* lb = static_cast<const int*>(labels);
  float* mp = static_cast<float*>(m_part);
  float* sp = static_cast<float*>(s_part);
  float* lp = static_cast<float*>(ll_part);
  float* ls = static_cast<float*>(lse);
  float* l = static_cast<float*>(ll);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 1:
      err = launch<__nv_bfloat16>(x, emb, lb, logits_t, mp, sp, lp, ls, l,
                                  n_tok, H, V, n_splits, st);
      break;
    case 2:
      err = launch<__half>(x, emb, lb, logits_t, mp, sp, lp, ls, l, n_tok, H,
                           V, n_splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* head_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
