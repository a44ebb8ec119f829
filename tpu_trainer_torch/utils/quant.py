"""Blockwise-absmax int8 quantization (port of ``tpu_trainer/utils/quant.py``).

Two consumers with the same numerics:

- the paged KV cache (``quantize_kv_int8`` / ``dequantize_kv_int8``): signed
  absmax per block of ``quant_block_len(d)`` along head_dim;
- the optimizer state (``quantize_blockwise_int8`` into a ``QuantPack``):
  the on-device narrow Adam moments (``training/optimizer.py``,
  ``optimizer_state_dtype="int8"``) and the host-offloaded moments
  (``training/trainer.py``, ``offload_dtype="int8"``). Signed moments
  quantize directly; Adam's nonnegative second moment quantizes in
  sqrt-space (``nonneg``), clamped at 0 before the sqrt.

``scale = max|y| / 127`` (f32), ``q = round(y / max(scale, 1e-30))``.
``torch.round`` rounds half to even like ``jnp.round``, so the int8 payload
and the scales match the JAX package bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

QUANT_BLOCK = 256  # target block length along the last dim


@dataclasses.dataclass
class QuantPack:
    """A blockwise-int8 tensor: ``q`` int8 ``[..., nb, B]`` and ``scale``
    f32 ``[..., nb]``. A type of its own, so a parameter that happens to be
    named ``q`` or ``scale`` is never taken for a pack."""

    q: torch.Tensor
    scale: torch.Tensor

    def tensors(self):
        return (self.q, self.scale)


def quant_block_len(d: int) -> int:
    """Largest of {256, 128, 64, 32} dividing ``d`` (else ``d`` itself)."""
    for b in (QUANT_BLOCK, 128, 64, 32):
        if d % b == 0:
            return b
    return d


def _sqrt(y: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 sqrt, as XLA and CUDA's ``sqrtf`` give
    it. torch's vectorized f32 sqrt on the CPU is not (about one value in
    200 an ulp off, which moves an int8 code), so the CPU takes it in f64:
    rounding the f64 root to f32 is exact."""
    if y.device.type == "cpu":
        return torch.sqrt(y.double()).float()
    return torch.sqrt(y)


def quantize_blockwise_int8(x: torch.Tensor, *, nonneg: bool) -> QuantPack:
    """Blockwise absmax int8 along the last dim of ``x``; ``nonneg``
    quantizes ``sqrt(max(x, 0))`` instead."""
    d = x.shape[-1]
    blk = quant_block_len(d)
    y = x.float()
    if nonneg:
        y = _sqrt(torch.clamp(y, min=0.0))
    y = y.reshape(x.shape[:-1] + (d // blk, blk))
    scale = y.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(y / safe[..., None]).to(torch.int8)
    return QuantPack(q=q, scale=scale)


def dequantize_blockwise_int8(pack: QuantPack, shape, dtype, *,
                              nonneg: bool) -> torch.Tensor:
    """Inverse of ``quantize_blockwise_int8``: f32 product (squared when
    ``nonneg``), reshaped to ``shape`` and cast to ``dtype``."""
    y = pack.q.float() * pack.scale[..., None]
    if nonneg:
        y = y * y
    return y.reshape(shape).to(dtype)


def quantize_kv_int8(x: torch.Tensor):
    """``x [..., d]`` -> ``(q int8 [..., d], scale f32 [..., d // blk])``."""
    pack = quantize_blockwise_int8(x, nonneg=False)
    return pack.q.reshape(x.shape), pack.scale


def dequantize_kv_int8(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_int8``: f32 product, cast to ``dtype``."""
    d = q.shape[-1]
    nb = scale.shape[-1]
    pack = QuantPack(q=q.reshape(q.shape[:-1] + (nb, d // nb)), scale=scale)
    return dequantize_blockwise_int8(pack, q.shape, dtype, nonneg=False)
