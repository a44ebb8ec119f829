"""Counter-based residual dropout (port of ``tpu_trainer/ops/dropout.py``).

The keep mask is murmur3's fmix32 of each element's flat index XOR a
uint32 seed, compared with ``rate * 2**32``: bitwise the JAX package's mask
for the same seed. Plain PyTorch (the JAX package has no kernel here).

Torch has no full uint32 arithmetic, so the hash runs on int64 tensors
holding uint32 values: every product is formed from 16-bit halves
(``mul32``), so no partial product leaves int64's range, and each step is
masked back to 32 bits.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for an int64 tensor of uint32 values and a
    uint32 constant, without a product above 2**33."""
    c_lo, c_hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    x_lo, x_hi = x & 0xFFFF, x >> 16
    cross = ((x_hi * c_lo + x_lo * c_hi) & 0xFFFF) << 16
    return (x_lo * c_lo + cross) & _U32


def threshold_u32(rate: float) -> int:
    """Keep iff hash >= this: ``min(int(rate * 2**32), 2**32 - 1)``."""
    return min(int(rate * 2**32), 2**32 - 1)


def murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors of uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_keep(shape, rate: float, seed: int, device=None) -> torch.Tensor:
    """Boolean keep mask of ``hash_dropout`` for a tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 2**32:
        raise ValueError("hash_dropout counters are uint32: tensor too large")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = murmur_mix(idx ^ (int(seed) & _U32))
    return (h >= threshold_u32(rate)).reshape(shape)


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout with the counter-based keep mask of ``seed`` (a
    uint32): zero with probability ``rate``, survivors divided by ``1 -
    rate`` rounded to ``x``'s dtype (as JAX divides by a weakly typed
    scalar)."""
    if rate <= 0.0:
        return x
    keep = hash_keep(x.shape, rate, seed, device=x.device)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
