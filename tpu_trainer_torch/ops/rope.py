"""Rotary position embeddings (port of ``tpu_trainer/ops/rope.py``).

f32 tables, ``concat(freqs, freqs)`` angle layout and the
``rotate_half`` convention ``[a, b, c, d] -> [-c, -d, a, b]``, exactly
as the JAX package, so the same positions rotate the same way.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_tables(seq_len: int, dim: int, base: float = 10000.0, *,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, f32 ``[seq_len, dim]``."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    inv_freq = 1.0 / torch.pow(
        torch.tensor(base, dtype=torch.float32, device=device), exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``[a, b, c, d] -> [-c, -d, a, b]``."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q/k ``[batch, seq, heads, head_dim]`` by position.

    cos/sin are ``[seq, head_dim]`` or ``[batch, seq, head_dim]`` (per-row
    positions). Applied in f32, cast back to the inputs' dtype.
    """
    if cos.dim() == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    q32, k32 = q.float(), k.float()
    q_rot = q32 * cos + rotate_half(q32) * sin
    k_rot = k32 * cos + rotate_half(k32) * sin
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
