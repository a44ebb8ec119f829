"""Attention helpers (port of ``tpu_trainer/ops/attention.py``; only
``repeat_kv`` so far)."""

from __future__ import annotations

import torch


def repeat_kv(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Expand grouped K/V heads (dim 2) to ``num_heads`` by contiguous-group
    repeat: query head ``i`` reads K/V head ``i // (num_heads // kv_heads)``
    — the mapping the flash-decode kernel uses too."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k, v
    group = num_heads // kvh
    return (torch.repeat_interleave(k, group, dim=2),
            torch.repeat_interleave(v, group, dim=2))
