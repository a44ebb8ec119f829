// Paged flash-decode for Hopper (sm_90a): single-query attention over a
// paged KV pool, split-KV online softmax, in-register int8 dequant, GQA.
//
// Replaces the Pallas TPU kernel tpu_trainer/ops/flash.py::_decode_kernel
// (launched by flash_decode, the pallas_call at ops/flash.py:1733). The
// Python wrapper is tpu_trainer_torch/ops/flash.py::flash_decode.
//
// Bound: memory. Each query token reads its row's whole K/V history once
// and does 4*d flops per (head, position) against 2*d*bytes(pool) read,
// i.e. about one flop per byte for bf16 pools, far below the ~295
// flops/byte at which an H100's bf16 tensor cores, not its memory, would
// limit. The least time is the K/V (+ int8 scales) bytes of the positions
// below each row's length over the memory rate: 3.35 TB/s on an H100 SXM
// (NVIDIA data sheet, 700 W; chip_smoke.py prints the card's limit).
//
// Design:
// - One thread block per (split, kv head, row): the block stages each
//   K/V page of its kv head in shared memory once and serves every query
//   head of the GQA group from it, so a page is read from device memory
//   once per kv head, not once per query head.
// - The TPU grid's sequential block axis becomes a loop inside the block
//   over the split's table entries; the block reads tables[row, j] itself
//   and stops at the first page wholly past lengths[row] (pages are in
//   position order). Positions at or past the length inside the last
//   page are masked to -inf.
// - int8 pages are dequantized while they are staged, with the blockwise
//   absmax scales [nblk, bsz, kvh, d / qb].
// - Online softmax in f32 with p kept in f32 for the PV product (the TPU
//   kernel rounds p to the pool dtype; this one does not), so the kernel
//   agrees with the plain version to f32 rounding on the same pool values.
// - Each block writes its split's partial (m, l, acc); a second small
//   kernel merges the splits as ops/flash.py:1746-1749 does.
//
// Plain C interface (built with nvcc into a shared library and loaded
// with ctypes): flash_decode_launch returns cudaGetLastError() after the
// two launches, on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Accumulator slots per thread: group * d <= kThreads * kMaxPerThread.
constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const float* __restrict__ q,        // [b, h, D], pre-scaled by 1/sqrt(D)
    const T* __restrict__ pool_k,       // [nblk, bsz, kvh, D]
    const T* __restrict__ pool_v,       // [nblk, bsz, kvh, D]
    const float* __restrict__ k_scale,  // [nblk, bsz, kvh, nbq] (int8 only)
    const float* __restrict__ v_scale,  // [nblk, bsz, kvh, nbq] (int8 only)
    const int* __restrict__ tables,     // [b, mb]
    const int* __restrict__ lengths,    // [b]
    float* __restrict__ m_out,          // [b, h, S]
    float* __restrict__ l_out,          // [b, h, S]
    float* __restrict__ acc_out,        // [b, h, S, D]
    int h, int kvh, int nblk, int bsz, int mb, int n_splits, int nbq) {
  const int isp = blockIdx.x;
  const int ikv = blockIdx.y;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = h / kvh;
  const int gd = group * D;
  const int bps = mb / n_splits;
  const int length = lengths[ib];
  const int h0 = ikv * group;  // first query head of this kv head's group

  extern __shared__ float smem[];
  float* q_s = smem;               // [group, D]
  float* k_s = q_s + gd;           // [bsz, D]
  float* v_s = k_s + bsz * D;      // [bsz, D]
  float* p_s = v_s + bsz * D;      // [group, bsz] scores, then probabilities
  float* m_s = p_s + group * bsz;  // [group] running max
  float* l_s = m_s + group;        // [group] running sum
  float* a_s = l_s + group;        // [group] this page's rescale factor

  // The group's query heads h0 .. h0 + group - 1 are contiguous in q.
  for (int e = tid; e < gd; e += kThreads)
    q_s[e] = q[(static_cast<size_t>(ib) * h + h0) * D + e];
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  float acc[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) acc[i] = 0.f;

  const int qb = D / nbq;
  for (int j = 0; j < bps; ++j) {
    const int jb = isp * bps + j;
    const int start = jb * bsz;
    if (start >= length) break;  // block-uniform: later pages are past it too
    const int blk = tables[static_cast<size_t>(ib) * mb + jb];
    if (blk < 0 || blk >= nblk) __trap();
    // Readers of the previous page (and the q/m/l setup) are done.
    __syncthreads();

    const size_t page = static_cast<size_t>(blk) * bsz;
    for (int e = tid; e < bsz * D; e += kThreads) {
      const int t = e / D;
      const int dd = e - t * D;
      const size_t row = (page + t) * kvh + ikv;
      float kx = to_f32(pool_k[row * D + dd]);
      float vx = to_f32(pool_v[row * D + dd]);
      if constexpr (std::is_same<T, int8_t>::value) {
        kx *= k_scale[row * nbq + dd / qb];
        vx *= v_scale[row * nbq + dd / qb];
      }
      k_s[e] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    // Scores: one warp per (query head, position), lanes split head_dim.
    for (int p = warp; p < group * bsz; p += kWarps) {
      const int g = p / bsz;
      const int t = p - g * bsz;
      float s = 0.f;
#pragma unroll
      for (int i = lane; i < D; i += 32) s += q_s[g * D + i] * k_s[t * D + i];
      s = warp_sum(s);
      if (lane == 0) p_s[p] = (start + t < length) ? s : -INFINITY;
    }
    __syncthreads();

    // Online softmax: one warp per query head. Position start < length,
    // so every page has a finite score and m_new is finite.
    for (int g = warp; g < group; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < bsz; t += 32) mx = fmaxf(mx, p_s[g * bsz + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bsz; t += 32) {
        const float pv = expf(p_s[g * bsz + t] - m_new);
        p_s[g * bsz + t] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV in f32: each thread owns output elements tid + i * kThreads.
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) {
        const int g = e / D;
        const int dd = e - g * D;
        float a = acc[i] * a_s[g];
        for (int t = 0; t < bsz; ++t) a += p_s[g * bsz + t] * v_s[t * D + dd];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  // An empty split (its first page past the length) writes m = -inf,
  // l = 0, acc = 0: weight exp(-inf) = 0 in the merge.
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < gd) {
      const int g = e / D;
      const int dd = e - g * D;
      acc_out[((static_cast<size_t>(ib) * h + h0 + g) * n_splits + isp) * D +
              dd] = acc[i];
    }
  }
  for (int g = tid; g < group; g += kThreads) {
    const size_t o = (static_cast<size_t>(ib) * h + h0 + g) * n_splits + isp;
    m_out[o] = m_s[g];
    l_out[o] = l_s[g];
  }
}

// Split merge: renormalize each split's accumulator by the global max and
// combine. One block per (row, head), one thread per head_dim element.
__global__ void merge_splits_kernel(const float* __restrict__ m,
                                    const float* __restrict__ l,
                                    const float* __restrict__ acc,
                                    float* __restrict__ out, int n_splits,
                                    int d) {
  const size_t bh = blockIdx.x;
  const int dd = threadIdx.x;
  const float* mr = m + bh * n_splits;
  const float* lr = l + bh * n_splits;
  float m_star = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m_star = fmaxf(m_star, mr[s]);
  float l_tot = 0.f;
  float o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mr[s] - m_star);
    l_tot += lr[s] * w;
    o += w * acc[(bh * n_splits + s) * d + dd];
  }
  out[bh * d + dd] = o / l_tot;
}

template <typename T, int D>
cudaError_t launch(const float* q, const void* pool_k, const void* pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* lengths, float* m_part,
                   float* l_part, float* acc_part, float* out, int b, int h,
                   int kvh, int nblk, int bsz, int mb, int n_splits, int nbq,
                   cudaStream_t stream) {
  const int group = h / kvh;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(group) * D + 2 * static_cast<size_t>(bsz) * D +
       static_cast<size_t>(group) * bsz + 3 * static_cast<size_t>(group));
  if (group * D > kThreads * kMaxPerThread || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  dim3 grid(n_splits, kvh, b);
  decode_partial_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(pool_k), static_cast<const T*>(pool_v),
      k_scale, v_scale, tables, lengths, m_part, l_part, acc_part, h, kvh,
      nblk, bsz, mb, n_splits, nbq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<b * h, D, 0, stream>>>(m_part, l_part, acc_part, out,
                                               n_splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const float* q, const void* pool_k,
                       const void* pool_v, const float* k_scale,
                       const float* v_scale, const int* tables,
                       const int* lengths, float* m_part, float* l_part,
                       float* acc_part, float* out, int b, int h, int kvh,
                       int nblk, int bsz, int mb, int n_splits, int nbq,
                       cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, pool_k, pool_v, k_scale, v_scale, tables,
                           lengths, m_part, l_part, acc_part, out, b, h, kvh,
                           nblk, bsz, mb, n_splits, nbq, stream);
    case 32:
      return launch<T, 32>(q, pool_k, pool_v, k_scale, v_scale, tables,
                           lengths, m_part, l_part, acc_part, out, b, h, kvh,
                           nblk, bsz, mb, n_splits, nbq, stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, k_scale, v_scale, tables,
                           lengths, m_part, l_part, acc_part, out, b, h, kvh,
                           nblk, bsz, mb, n_splits, nbq, stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, k_scale, v_scale, tables,
                            lengths, m_part, l_part, acc_part, out, b, h, kvh,
                            nblk, bsz, mb, n_splits, nbq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (with k_scale / v_scale).
// m_part / l_part: [b, h, n_splits] f32; acc_part: [b, h, n_splits, d] f32;
// out: [b, h, d] f32. Returns a cudaError_t code (0 = launched).
extern "C" int flash_decode_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths,
    void* m_part, void* l_part, void* acc_part, void* out, int b, int h,
    int kvh, int d, int nblk, int bsz, int mb, int n_splits, int nbq,
    int kv_dtype, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || mb <= 0 ||
      n_splits <= 0 || mb % n_splits != 0 || bsz <= 0 || nbq <= 0 ||
      d % nbq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_dtype) {
    case 0:
      err = dispatch_d<float>(d, qf, pool_k, pool_v, nullptr, nullptr, tb, ln,
                              mp, lp, ap, o, b, h, kvh, nblk, bsz, mb,
                              n_splits, 1, st);
      break;
    case 1:
      err = dispatch_d<__nv_bfloat16>(d, qf, pool_k, pool_v, nullptr, nullptr,
                                      tb, ln, mp, lp, ap, o, b, h, kvh, nblk,
                                      bsz, mb, n_splits, 1, st);
      break;
    case 2:
      if (ks == nullptr || vs == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      err = dispatch_d<int8_t>(d, qf, pool_k, pool_v, ks, vs, tb, ln, mp, lp,
                               ap, o, b, h, kvh, nblk, bsz, mb, n_splits, nbq,
                               st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
