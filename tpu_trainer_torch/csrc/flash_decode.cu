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
// limit (so the products stay on the CUDA cores, in f32). The least time is
// the K/V (+ int8 scales) bytes of the positions below each row's length
// over the memory rate: 3.35 TB/s on an H100 SXM (NVIDIA data sheet, 700 W;
// chip_smoke.py prints the card's limit).
//
// What held the first version back was latency, not bytes: one block per
// (split, kv head, row) walked its split's pages one at a time, each page a
// serial chain of a table read, a page load staged through shared memory
// with 2-byte loads, and three __syncthreads around the scores, the softmax
// and PV, so a 16-page split took 16 page latencies. This design:
// - One block of 8 warps per (split, kv head, row). The warps take the
//   split's pages in turn (page j to warp j % 8), so the pages of a split
//   are in flight at once; no barrier runs per page.
// - A call may read a window of the pool's kv heads: kv heads kv_head_base
//   .. kv_head_base + kvh - 1 of a pool whose rows hold kv_stride heads (a
//   tensor-parallel shard whose query heads fall inside one kv group of a
//   replicated pool reads that one kv head in place, no copy). The grid's
//   kv head ikv reads pool head kv_head_base + ikv.
// - Each warp reads its pages' table entries once, up front (lane i holds
//   the entry of its i-th page), and stops at the first page wholly past
//   lengths[row] (pages are in position order).
// - A page's K and V rows of this kv head load as 16-byte vectors, L =
//   d * bytes / 16 lanes a row and 32 / L rows a pass, up to 4 passes'
//   loads issued before any is used. int8 is dequantized in registers with
//   the blockwise absmax scales [nblk, bsz, kvh, d / qb].
// - Scores: each lane dots its chunk with q (scaled by 1/sqrt(d) in f32 as
//   it is loaded), then a shuffle sum over the row's L lanes. An online
//   softmax per warp in f32 (p stays f32 for the PV product, as the plain
//   version has it); each lane accumulates p * v over its own rows, summed
//   over the rows' lanes once, at the end.
// - GQA: the block serves every query head of its kv head, up to 16 / E
//   heads at a time in registers (E the elements of a 16-byte chunk), so a
//   page is read from device memory once per kv head (again from L2 for
//   groups wider than that).
// - The warps' (m, l, acc) merge in shared memory once, at the end; each
//   block writes its split's partial, and a second small kernel merges the
//   splits as ops/flash.py:1746-1749 does.
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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kAccFloats = 16;  // a lane's accumulators: heads a pass x E
constexpr int kRounds = 4;      // passes of 16-byte K and V loads in flight

// The E = 16 / sizeof(T) elements of one 16-byte chunk, in f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat16* f = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(f[i]);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[16]) {
  const int8_t* f = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(f[i]);
}

// Multiplies chunk c of an int8 row by its blockwise scales (qb elements a
// scale); a no-op for float pools.
template <typename T, int E>
__device__ __forceinline__ void dequant(float (&x)[E], const float* scale,
                                        size_t row, int nbq, int qb, int c) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const float* sr = scale + row * nbq;
    if (qb % E == 0) {
      const float sc = __ldg(sr + c * E / qb);
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] *= sc;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] *= __ldg(sr + (c * E + e) / qb);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const float* __restrict__ q,        // [b, h, D] f32
    const T* __restrict__ pool_k,       // [nblk, bsz, kv_stride, D]
    const T* __restrict__ pool_v,       // [nblk, bsz, kv_stride, D]
    const float* __restrict__ k_scale,  // [nblk, bsz, kv_stride, nbq] (int8)
    const float* __restrict__ v_scale,  // [nblk, bsz, kv_stride, nbq] (int8)
    const int* __restrict__ tables,     // [b, mb]
    const int* __restrict__ lengths,    // [b]
    float* __restrict__ m_out,          // [b, h, S]
    float* __restrict__ l_out,          // [b, h, S]
    float* __restrict__ acc_out,        // [b, h, S, D]
    int h, int kvh, int kv_head_base, int kv_stride, int nblk, int bsz,
    int mb, int n_splits, int nbq, float scale) {
  constexpr int E = 16 / sizeof(T);
  constexpr int L = D * static_cast<int>(sizeof(T)) / 16;  // lanes a row
  constexpr int P = 32 / L;                                // rows a pass
  constexpr int GC = kAccFloats / E;                       // heads a pass
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "row lanes");
  const int isp = blockIdx.x;
  const int ikv = blockIdx.y;
  const int pkv = kv_head_base + ikv;  // this block's kv head in the pool
  const int ib = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % L;   // this lane's 16-byte chunk of a row
  const int pr = lane / L;  // this lane's row within a pass
  const int group = h / kvh;
  const int h0 = ikv * group;  // first query head of this kv head's group
  const int bps = mb / n_splits;
  const int length = lengths[ib];
  const int qb = D / nbq;
  // Pages of this split that hold a position below the length.
  const int npages =
      max(0, min(bps, (length + bsz - 1) / bsz - isp * bps));

  __shared__ float m_s[kWarps][GC];
  __shared__ float l_s[kWarps][GC];
  __shared__ float acc_s[kWarps][GC][D];

  for (int g0 = 0; g0 < group; g0 += GC) {
    float qv[GC][E], m[GC], l[GC], acc[GC][E];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const bool ok = g0 + g < group;
      const float* qr =
          q + (static_cast<size_t>(ib) * h + h0 + g0 + g) * D + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[g][e] = ok ? __ldg(qr + e) * scale : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }

    // This warp's pages warp, warp + 8, ...: their table entries, 32 at a
    // time (lane i holds the i-th), read before any page.
    for (int w0 = warp; w0 < npages; w0 += 32 * kWarps) {
      const int jl = w0 + lane * kWarps;
      const int mine =
          jl < npages
              ? tables[static_cast<size_t>(ib) * mb + isp * bps + jl]
              : 0;
      const int count = min(32, (npages - w0 + kWarps - 1) / kWarps);
      for (int i = 0; i < count; ++i) {
        const int blk = __shfl_sync(0xffffffffu, mine, i);
        if (blk < 0 || blk >= nblk) __trap();
        const int start = (isp * bps + w0 + i * kWarps) * bsz;
        for (int t0 = 0; t0 < bsz; t0 += P * kRounds) {
          uint4 kr[kRounds], vr[kRounds];
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {
            const int t = t0 + r * P + pr;
            kr[r] = vr[r] = make_uint4(0u, 0u, 0u, 0u);
            if (t < bsz) {
              const size_t off =
                  ((static_cast<size_t>(blk) * bsz + t) * kv_stride + pkv) *
                      D +
                  c * E;
              kr[r] = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
              vr[r] = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
            }
          }
          // Scores of the round's rows, summed over each row's L lanes;
          // -inf at or past the length (and past the page).
          float sc[GC][kRounds];
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {
            const int t = t0 + r * P + pr;
            const size_t row =
                (static_cast<size_t>(blk) * bsz + t) * kv_stride + pkv;
            float kx[E];
            unpack(kr[r], kx);
            if (t < bsz) dequant<T, E>(kx, k_scale, row, nbq, qb, c);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
              float s = 0.f;
#pragma unroll
              for (int e = 0; e < E; ++e) s = fmaf(qv[g][e], kx[e], s);
#pragma unroll
              for (int x = 1; x < L; x <<= 1)
                s += __shfl_xor_sync(0xffffffffu, s, x);
              sc[g][r] = (t < bsz && start + t < length) ? s : -INFINITY;
            }
          }
          // Online softmax over the round, per head: the max and the sum
          // over the rows' lanes (lanes of one chunk differ in bits >= L).
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float mx = -INFINITY;
#pragma unroll
            for (int r = 0; r < kRounds; ++r) mx = fmaxf(mx, sc[g][r]);
#pragma unroll
            for (int x = L; x < 32; x <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
            if (mx == -INFINITY) {  // no position of the round is live
#pragma unroll
              for (int r = 0; r < kRounds; ++r) sc[g][r] = 0.f;
              continue;
            }
            const float m_new = fmaxf(m[g], mx);
            const float alpha = expf(m[g] - m_new);
            m[g] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int r = 0; r < kRounds; ++r) {
              sc[g][r] = expf(sc[g][r] - m_new);
              sum += sc[g][r];
            }
#pragma unroll
            for (int x = L; x < 32; x <<= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, x);
            l[g] = l[g] * alpha + sum;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
          }
          // p * v over the lane's rows, in f32.
#pragma unroll
          for (int r = 0; r < kRounds; ++r) {
            const int t = t0 + r * P + pr;
            float vx[E];
            unpack(vr[r], vx);
            if (t < bsz)
              dequant<T, E>(
                  vx, v_scale,
                  (static_cast<size_t>(blk) * bsz + t) * kv_stride + pkv, nbq,
                  qb, c);
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[g][e] = fmaf(sc[g][r], vx[e], acc[g][e]);
          }
        }
      }
    }

    // The warp's accumulators summed over its rows' lanes, then the warps
    // merged in shared memory. An empty split (no page below the length)
    // writes m = -inf, l = 0, acc = 0: weight exp(-inf) = 0 in the merge.
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int x = L; x < 32; x <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], x);
    if (lane < L) {
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc_s[warp][g][c * E + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < GC * D; idx += kThreads) {
      const int g = idx / D;
      const int dd = idx - g * D;
      if (g0 + g >= group) continue;
      float ms = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, m_s[w][g]);
      float lt = 0.f, a = 0.f;
      if (ms != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float wt = expf(m_s[w][g] - ms);
          lt += l_s[w][g] * wt;
          a += acc_s[w][g][dd] * wt;
        }
      }
      const size_t o =
          (static_cast<size_t>(ib) * h + h0 + g0 + g) * n_splits + isp;
      acc_out[o * D + dd] = a;
      if (dd == 0) {
        m_out[o] = ms;
        l_out[o] = lt;
      }
    }
    __syncthreads();  // before the next heads reuse the shared arrays
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

struct Args {
  const float* q;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  float* m_part;
  float* l_part;
  float* acc_part;
  float* out;
  int b, h, kvh, kv_head_base, kv_stride, nblk, bsz, mb, n_splits, nbq;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.n_splits, a.kvh, a.b);
  decode_partial_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      a.q, static_cast<const T*>(a.pool_k), static_cast<const T*>(a.pool_v),
      a.k_scale, a.v_scale, a.tables, a.lengths, a.m_part, a.l_part,
      a.acc_part, a.h, a.kvh, a.kv_head_base, a.kv_stride, a.nblk, a.bsz,
      a.mb, a.n_splits, a.nbq,
      1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<a.b * a.h, D, 0, stream>>>(a.m_part, a.l_part,
                                                   a.acc_part, a.out,
                                                   a.n_splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [b, h, d] f32, unscaled (the kernel multiplies by 1/sqrt(d)).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (with k_scale / v_scale).
// The pools' rows hold kv_stride kv heads; the call reads kvh of them from
// kv_head_base on (kv_head_base = 0, kv_stride = kvh: the whole pool).
// m_part / l_part: [b, h, n_splits] f32; acc_part: [b, h, n_splits, d] f32;
// out: [b, h, d] f32. Returns a cudaError_t code (0 = launched).
extern "C" int flash_decode_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths,
    void* m_part, void* l_part, void* acc_part, void* out, int b, int h,
    int kvh, int kv_head_base, int kv_stride, int d, int nblk, int bsz,
    int mb, int n_splits, int nbq, int kv_dtype, void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || kv_head_base < 0 ||
      kv_head_base + kvh > kv_stride || mb <= 0 ||
      n_splits <= 0 || mb % n_splits != 0 || bsz <= 0 || nbq <= 0 ||
      d % nbq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), pool_k, pool_v,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(lengths),
         static_cast<float*>(m_part), static_cast<float*>(l_part),
         static_cast<float*>(acc_part), static_cast<float*>(out), b, h, kvh,
         kv_head_base, kv_stride, nblk, bsz, mb, n_splits, nbq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      a.k_scale = a.v_scale = nullptr;
      a.nbq = 1;
      return static_cast<int>(dispatch_d<float>(d, a, st));
    case 1:
      a.k_scale = a.v_scale = nullptr;
      a.nbq = 1;
      return static_cast<int>(dispatch_d<__nv_bfloat16>(d, a, st));
    case 2:
      if (a.k_scale == nullptr || a.v_scale == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_d<int8_t>(d, a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
