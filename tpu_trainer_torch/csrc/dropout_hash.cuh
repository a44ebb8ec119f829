// Counter-based attention-dropout keep test, shared by the flash forward
// and backward kernels and the mask-dump kernel (csrc/flash_attn.cu).
//
// The same multiply-xorshift hash as tpu_trainer/ops/flash.py::_keep_mask
// (the interpret-mode branch of _keep, flash.py:94-129) and as the port's
// plain version tpu_trainer_torch/ops/flash.py::_keep_mask: the hash of the
// GLOBAL (row, col) score position, so a mask does not depend on how the
// score matrix is tiled, and the backward regenerates the forward's mask
// bit for bit. All arithmetic is uint32 with wrap-around.

#pragma once

#include <stdint.h>

namespace dropout_hash {

constexpr uint32_t kGolden = 0x9E3779B9u;  // Weyl increment of the salt

// The per-(batch, head) stream key: seed + salt * golden, with the salt
// batch * heads + head (flash.py's _block_salt with one head a program).
__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                                        uint32_t salt) {
  return seed + salt * kGolden;
}

// Keep score (row, col) of a `seq`-long sequence: true with probability
// 1 - threshold / 2^32.
__host__ __device__ __forceinline__ bool keep(uint32_t key, uint32_t row,
                                              uint32_t col, uint32_t seq,
                                              uint32_t threshold) {
  uint32_t x = row * seq + col;
  x ^= key;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return x >= threshold;
}

}  // namespace dropout_hash
