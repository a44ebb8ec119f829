"""Blockwise-absmax int8 KV quantization (port of the KV part of
``tpu_trainer/utils/quant.py``).

Signed absmax per block of ``quant_block_len(d)`` along head_dim:
``scale = max|x| / 127`` (f32), ``q = round(x / max(scale, 1e-30))``.
``torch.round`` rounds half to even like ``jnp.round``, so the int8
payload and the scales match the JAX package bit for bit.
"""

from __future__ import annotations

import torch

QUANT_BLOCK = 256  # target block length along the last dim


def quant_block_len(d: int) -> int:
    """Largest of {256, 128, 64, 32} dividing ``d`` (else ``d`` itself)."""
    for b in (QUANT_BLOCK, 128, 64, 32):
        if d % b == 0:
            return b
    return d


def quantize_kv_int8(x: torch.Tensor):
    """``x [..., d]`` -> ``(q int8 [..., d], scale f32 [..., d // blk])``."""
    d = x.shape[-1]
    blk = quant_block_len(d)
    y = x.float().reshape(x.shape[:-1] + (d // blk, blk))
    scale = y.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(y / safe[..., None]).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_kv_int8(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_int8``: f32 product, cast to ``dtype``."""
    d = q.shape[-1]
    nb = scale.shape[-1]
    y = q.float().reshape(q.shape[:-1] + (nb, d // nb)) * scale[..., None]
    return y.reshape(q.shape).to(dtype)
