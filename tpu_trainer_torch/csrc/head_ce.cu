// Fused LM-head + cross-entropy forward for Hopper (sm_90a): logits of the
// tied head, stored vocab-major in the compute type, with the softmax
// statistics folded in while each logits tile is still in registers.
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
// Design (the first one, 16x16 WMMA fragments from shared memory over
// 32-column chunks staged by hand through registers, 24 barrier-bound chunk
// steps a tile and the statistics two threads a token through shared
// memory, reached 67 TFLOP/s):
// - A GEMM with the tokens as the wgmma M and the vocab as N: a tile is 128
//   tokens (two consumer warpgroups of 64) by kBV vocab rows. The hidden dim
//   is streamed in 64-column chunks of x and E through a TMA ring of
//   128-byte-swizzled stages (zero-filled past T, V and H), fed by a
//   producer warp; the products are SS wgmma m64nNk16 into f32 registers.
//   x (12.6 MB at the training shape) is re-read from L2 for every vocab
//   tile.
// - A persistent grid of one block an SM walks (token tile, vocab split)
//   units, the token tile fastest, so the blocks at work at any moment
//   share a few E tiles in L2. A unit walks its split's vocab tiles with
//   each token's running (max, exp-sum, label logit) in registers: a
//   token's row of the accumulator sits in one quad of lanes, so the tile's
//   row max takes two shuffles and the exp-sums stay per lane until the
//   unit ends. The unit writes its split's partials; a second small kernel
//   merges the splits in a fixed order (the recombination flash_decode.cu
//   uses), so lse and ll are bitwise the same from run to run, and so is
//   every logit, which one unit owns. The split count is derived from T, V
//   and the SM count by the wrapper (ops/head_ce.py::work_split).
// - Epilogue of a tile, in registers: columns >= V (zero rows of E) become
//   -1e30, the label's column is caught from the f32 accumulator before
//   rounding (head_ce.py:92-95), the statistics fold in. Then the tile is
//   rounded to T and stored transposed (stmatrix .trans) into a swizzled
//   staging buffer of the warpgroup, and one TMA store writes it to the
//   vocab-major logits [V, ldt] (clipped at T and V). The store is waited
//   on only before the buffer is written again, a whole tile later, so the
//   0.82 GB of logits overlaps the products.
// - TMA needs 16-byte row strides: H % 8 == 0 and ldt % 8 == 0. The wrapper
//   pads H with zero columns and gives the logits a padded row stride
//   where needed.
//
// Plain C interface (nvcc into a shared library, loaded with ctypes);
// head_ce_fwd returns cudaGetLastError() after its launches, on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// N = 256 vocab rows and 3 stages: N = 128 with 4 stages measured 1.17x
// slower, and keeping one chunk's products in flight (wait_group 1) no
// faster (scripts/torch_kernel_variants.py).
constexpr int kBT = 128;              // tokens of a tile: two warpgroups of 64
constexpr int kBV = 256;              // vocab rows of a tile (the wgmma N)
constexpr int kBH = 64;               // hidden columns a ring stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + a producer warpgroup
constexpr float kNeg = -1e30f;        // -inf stand-in (no inf - inf)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory (tiles 1024-byte aligned): the ring of stages (the x chunk
// [128][64], then the E chunk [kBV][64]), each warpgroup's staging buffer of
// a transposed logits tile ([kBV][64 tokens], 128-byte swizzled rows), and
// the mbarriers full[kStages], empty[kStages].
constexpr int kXBytes = kBT * kBH * 2;
constexpr int kEBytes = kBV * kBH * 2;
constexpr int kStageBytes = kXBytes + kEBytes;
constexpr int kOutOffset = kStages * kStageBytes;
constexpr int kOutBytes = kBV * 64 * 2;
constexpr int kBarOffset = kOutOffset + 2 * kOutBytes;
constexpr int kSmemBytes = kBarOffset + 8 * 2 * kStages + 1024;

struct Params {
  CUtensorMap x;     // x [T, H]: boxes {64, 128}
  CUtensorMap e;     // emb [V, H]: boxes {64, kBV}
  CUtensorMap out;   // logits_t [V, T], row stride ldt: boxes {64, kBV}
  const int* labels; // [T]
  float* m_part;     // [n_splits, T]
  float* s_part;     // [n_splits, T]
  float* ll_part;    // [n_splits, T]
  int n_tok, H, V, tiles_per_split, n_units;
};

// 2^x by the SFU (ex2.approx: ~2 ulp; 2^-huge = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Unit u of the persistent walk: token tile u % nt, vocab split u / nt.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    head_ce_tma_kernel(const __grid_constant__ Params p) {
  using namespace hopper;
  const int n_tok = p.n_tok, V = p.V;
  const int nt = (n_tok + kBT - 1) / kBT;
  const int nv = (V + kBV - 1) / kBV;
  const int nkc = (p.H + kBH - 1) / kBH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(base);
  const uint32_t bars = smem_u32(base + kBarOffset);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  auto x_stage = [&](int st) { return ring + st * kStageBytes; };
  auto e_stage = [&](int st) { return x_stage(st) + kXBytes; };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    regs_dealloc<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      // Producer: every (vocab tile, hidden chunk) of every unit in order.
      int n = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int t0 = (u % nt) * kBT;
        const int vt0 = (u / nt) * p.tiles_per_split;
        const int vt1 = min(nv, vt0 + p.tiles_per_split);
        for (int vt = vt0; vt < vt1; ++vt)
          for (int c = 0; c < nkc; ++c, ++n) {
            const int st = n % kStages;
            mbar_wait(empty(st), ((n / kStages) & 1) ^ 1);
            mbar_expect_tx(full(st), kStageBytes);
            tma_load_2d(x_stage(st), &p.x, full(st), c * kBH, t0);
            tma_load_2d(e_stage(st), &p.e, full(st), c * kBH, vt * kBV);
          }
      }
    }
    return;
  }

  regs_alloc<240>();
  // Consumers: warpgroup wg owns tokens [t0 + 64 wg, t0 + 64 wg + 64); this
  // thread holds tile rows r_a and r_a + 8, and of each n8 block j the
  // columns 8 j + 2 t4 + 0..1 (hopper.cuh's accumulator layout).
  const int wg = warp >> 2;
  const int t4 = lane & 3;
  const int r_a = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const uint32_t out_s = smem_u32(base + kOutOffset + wg * kOutBytes);
  const bool leader = (tid & 127) == 0;  // issues the warpgroup's stores
  const Elem<T> et{};
  // stmatrix addresses: lane 8 m + i gives row i of matrix m, i.e. vocab
  // row 8 (m >> 1) + i of a 16-column pair and tokens 8 (m & 1) + 0..7 of
  // the warp's 16, as a 16-byte chunk of the 128-byte swizzled row.
  const int st_row = 8 * ((lane >> 3) >> 1) + (lane & 7);
  const int st_chunk = (2 * (warp & 3) + ((lane >> 3) & 1)) ^ (lane & 7);

  float acc[kBV / 2];
  int n = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int t0 = (u % nt) * kBT;
    const int split = u / nt;
    const int vt0 = split * p.tiles_per_split;
    const int vt1 = min(nv, vt0 + p.tiles_per_split);
    const int tok_a = t0 + r_a, tok_b = tok_a + 8;
    const int lab_a = tok_a < n_tok ? __ldg(p.labels + tok_a) : -1;
    const int lab_b = tok_b < n_tok ? __ldg(p.labels + tok_b) : -1;
    float m_a = kNeg, m_b = kNeg, s_a = 0.f, s_b = 0.f;
    float ll_a = 0.f, ll_b = 0.f;
    for (int vt = vt0; vt < vt1; ++vt) {
      const int v0 = vt * kBV;
      // Mainloop: acc = x_tile E_tile^T over the hidden chunks.
      for (int c = 0; c < nkc; ++c, ++n) {
        const int st = n % kStages;
        mbar_wait(full(st), (n / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBH / 16; ++kk)
          wgmma_ss<0>(Shape<kBV>{}, et, acc,
                      desc_sw128(x_stage(st) + wg * 64 * 128 + kk * 32, 16,
                                 1024),
                      desc_sw128(e_stage(st) + kk * 32, 16, 1024),
                      (c > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }

      // Epilogue: mask the vocab edge, catch the label, fold the tile into
      // the running statistics (max over the quad; per-lane exp-sums).
      const bool ragged = v0 + kBV > V;
      const int la = lab_a - v0, lb = lab_b - v0;
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          float x = acc[4 * j + e];
          if (ragged && v0 + col >= V) x = acc[4 * j + e] = kNeg;
          if (e < 2) {
            if (col == la) ll_a += x;
            mx_a = fmaxf(mx_a, x);
          } else {
            if (col == lb) ll_b += x;
            mx_b = fmaxf(mx_b, x);
          }
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float ms_a = mn_a * kLog2e, ms_b = mn_b * kLog2e;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j) {
        sum_a += fast_exp2(fmaf(acc[4 * j], kLog2e, -ms_a)) +
                 fast_exp2(fmaf(acc[4 * j + 1], kLog2e, -ms_a));
        sum_b += fast_exp2(fmaf(acc[4 * j + 2], kLog2e, -ms_b)) +
                 fast_exp2(fmaf(acc[4 * j + 3], kLog2e, -ms_b));
      }
      s_a = s_a * fast_exp2((m_a - mn_a) * kLog2e) + sum_a;
      s_b = s_b * fast_exp2((m_b - mn_b) * kLog2e) + sum_b;
      m_a = mn_a;
      m_b = mn_b;

      // The tile in T, transposed into the staging buffer once the previous
      // tile's store has read it, then one TMA store.
      if (leader) bulk_wait_read();
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int jp = 0; jp < kBV / 16; ++jp)
        stmatrix_x4_trans(
            out_s + (16 * jp + st_row) * 128 + st_chunk * 16,
            pack2(et, acc[8 * jp], acc[8 * jp + 1]),
            pack2(et, acc[8 * jp + 2], acc[8 * jp + 3]),
            pack2(et, acc[8 * jp + 4], acc[8 * jp + 5]),
            pack2(et, acc[8 * jp + 6], acc[8 * jp + 7]));
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (leader && t0 + 64 * wg < n_tok) {
        tma_store_2d(&p.out, out_s, t0 + 64 * wg, v0);
        bulk_commit();
      }
    }
    // The unit's partials: the quad's exp-sums (and the one label logit
    // caught among them) summed in a fixed order.
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s_a += __shfl_xor_sync(0xffffffffu, s_a, o);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, o);
      ll_a += __shfl_xor_sync(0xffffffffu, ll_a, o);
      ll_b += __shfl_xor_sync(0xffffffffu, ll_b, o);
    }
    if (t4 == 0) {
      const size_t o = static_cast<size_t>(split) * n_tok;
      if (tok_a < n_tok) {
        p.m_part[o + tok_a] = m_a;
        p.s_part[o + tok_a] = s_a;
        p.ll_part[o + tok_a] = ll_a;
      }
      if (tok_b < n_tok) {
        p.m_part[o + tok_b] = m_b;
        p.s_part[o + tok_b] = s_b;
        p.ll_part[o + tok_b] = ll_b;
      }
    }
  }
  if (leader) bulk_wait();  // the staging buffer outlives the last store
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
                   int V, int ldt, int n_splits, cudaStream_t stream) {
  Params p;
  const bool fp16 = std::is_same<T, __half>::value;
  const cuuint64_t dx[2] = {static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(n_tok)};
  const cuuint64_t de[2] = {static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(V)};
  const cuuint64_t dout[2] = {static_cast<cuuint64_t>(n_tok),
                              static_cast<cuuint64_t>(V)};
  const cuuint64_t sh[1] = {static_cast<cuuint64_t>(H) * sizeof(T)};
  const cuuint64_t sout[1] = {static_cast<cuuint64_t>(ldt) * sizeof(T)};
  const cuuint32_t box_x[2] = {kBH, kBT};
  const cuuint32_t box_e[2] = {kBH, kBV};
  const cuuint32_t box_out[2] = {64, kBV};
  cudaError_t err = hopper_host::make_map(&p.x, fp16, 2, x, dx, sh, box_x);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&p.e, fp16, 2, emb, de, sh, box_e);
  if (err == cudaSuccess)
    err = hopper_host::make_map(&p.out, fp16, 2, logits_t, dout, sout,
                                box_out);
  if (err != cudaSuccess) return err;
  const int nt = (n_tok + kBT - 1) / kBT;
  const int nv = (V + kBV - 1) / kBV;
  p.labels = labels;
  p.m_part = m_part;
  p.s_part = s_part;
  p.ll_part = ll_part;
  p.n_tok = n_tok;
  p.H = H;
  p.V = V;
  p.tiles_per_split = (nv + n_splits - 1) / n_splits;
  p.n_units = nt * n_splits;
  auto kernel = head_ce_tma_kernel<T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const int sms = hopper_host::sm_count();
  const int grid = sms < p.n_units ? sms : p.n_units;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_ce_merge_kernel<<<(n_tok + 255) / 256, 256, 0, stream>>>(
      m_part, s_part, ll_part, lse, ll, n_tok, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (x, emb, logits_t). x [T, H] and emb
// [V, H] with H % 8 == 0, 16-byte aligned; labels int32 [T]; logits_t [V,
// ldt] with ldt >= T, ldt % 8 == 0 (columns past T untouched); m/s/ll_part
// f32 [n_splits, T] scratch, every split non-empty; lse, ll f32 [T].
// Returns a cudaError_t code (0 = launched).
extern "C" int head_ce_fwd(const void* x, const void* emb, const void* labels,
                           void* logits_t, void* m_part, void* s_part,
                           void* ll_part, void* lse, void* ll, int n_tok,
                           int H, int V, int ldt, int n_splits, int dtype,
                           void* stream) {
  const int nv = (V + kBV - 1) / kBV;
  if (n_tok <= 0 || H <= 0 || V <= 0 || n_splits <= 0 || n_splits > nv ||
      H % 8 != 0 || ldt < n_tok || ldt % 8 != 0 ||
      (n_splits - 1) * ((nv + n_splits - 1) / n_splits) >= nv)
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
                                  n_tok, H, V, ldt, n_splits, st);
      break;
    case 2:
      err = launch<__half>(x, emb, lb, logits_t, mp, sp, lp, ls, l, n_tok, H,
                           V, ldt, n_splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* head_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
