"""Counter-based residual dropout (port of ``tpu_trainer/ops/dropout.py``).

The keep mask is murmur3's fmix32 of each element's flat index XOR a
uint32 seed, compared with ``rate * 2**32``: bitwise the JAX package's mask
for the same seed. Plain PyTorch (the JAX package has no kernel here).

At world > 1 the JAX package traces the hash on the global array, so a
data shard's mask is the global mask's slice: ``offset`` starts the
index at the shard's first element (``total`` is the global size, which
the uint32 counter must cover). A sequence rank's ``[b, sl, ...]`` slice
is strided in that index: ``seq_slice=(start, global_len)`` says that
dim 1 holds columns ``[start, start + sl)`` of ``global_len``.

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


def hash_keep(shape, rate: float, seed: int, device=None, *,
              offset: int = 0, total=None, seq_slice=None) -> torch.Tensor:
    """Boolean keep mask of ``hash_dropout`` for a tensor of ``shape``
    whose elements have the linear indices ``offset ..`` of an array of
    ``total`` elements (default: the tensor itself); with ``seq_slice``
    (module docstring) dim 1 is a slice of a longer one."""
    n = 1
    for d in shape:
        n *= int(d)
    if (n if total is None else total) >= 2**32:
        raise ValueError("hash_dropout counters are uint32: tensor too large")
    if seq_slice is None:
        idx = torch.arange(offset, offset + n, dtype=torch.int64,
                           device=device)
    else:
        start, glen = seq_slice
        rows, cols = int(shape[0]), int(shape[1])
        inner = n // max(rows * cols, 1)
        ar = lambda k: torch.arange(k, dtype=torch.int64,  # noqa: E731
                                    device=device)
        idx = (offset + ((ar(rows)[:, None, None] * glen
                          + (start + ar(cols))[None, :, None]) * inner
                         + ar(inner)[None, None, :])).reshape(-1)
    h = murmur_mix(idx ^ (int(seed) & _U32))
    return (h >= threshold_u32(rate)).reshape(shape)


def hash_dropout(x: torch.Tensor, rate: float, seed: int, *,
                 offset: int = 0, total=None, seq_slice=None) -> torch.Tensor:
    """Inverted dropout with the counter-based keep mask of ``seed`` (a
    uint32): zero with probability ``rate``, survivors divided by ``1 -
    rate`` rounded to ``x``'s dtype (as JAX divides by a weakly typed
    scalar). ``offset`` / ``total`` / ``seq_slice``: ``hash_keep``."""
    if rate <= 0.0:
        return x
    keep = hash_keep(x.shape, rate, seed, device=x.device, offset=offset,
                     total=total, seq_slice=seq_slice)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
