"""Attention ops (port of ``tpu_trainer/ops/attention.py``).

``reference_attention`` is the manual path: QK^T/sqrt(d) -> causal (and
segment) mask -> f32 softmax -> dropout -> @V. The fused training path
is ``ops.flash.flash_attention``.

``fold_seed`` is the JAX ``attention_shard_coord`` fold: at world > 1 the
attention-dropout seed folds in the coordinate of the shard along the
axes that shard the attention operands (the data shard, then the tensor
rank when the heads shard: ``parallel/mesh.attention_shard_coord``), so
masks decorrelate across those shards and only across them (the kernels
take the folded seed unchanged). The ring (``ops/ring.py``) folds each
chunk's tag on top.

All functions take ``q, k, v`` as ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_trainer_torch.ops.dropout import murmur_mix

_GOLDEN = 0x9E3779B9


def fold_seed(seed: int, coord: int) -> int:
    """A uint32 seed for shard ``coord`` of a sharded attention call:
    ``fmix32(seed ^ fmix32(golden * (coord + 1)))``. Distinct shards get
    unrelated seeds; one process never folds."""
    c = torch.tensor([(_GOLDEN * (int(coord) + 1)) & 0xFFFFFFFF],
                     dtype=torch.int64)
    key = int(murmur_mix(c).item())
    return int(murmur_mix(torch.tensor([(int(seed) ^ key) & 0xFFFFFFFF],
                                       dtype=torch.int64)).item())


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Boolean ``[seq, seq]`` mask, True where attention is allowed."""
    return torch.tril(torch.ones((seq_len, seq_len), dtype=torch.bool,
                                 device=device))


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Boolean ``[batch, 1, seq, seq]``: True where q and k positions share
    a segment id."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def repeat_kv(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Expand grouped K/V heads (dim 2) to ``num_heads`` by contiguous-group
    repeat: query head ``i`` reads K/V head ``i // (num_heads // kv_heads)``
    — the mapping the flash kernels use too."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k, v
    group = num_heads // kvh
    return (torch.repeat_interleave(k, group, dim=2),
            torch.repeat_interleave(v, group, dim=2))


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Manual causal attention: scores in the input dtype masked with its
    ``finfo.min``, f32 softmax cast back, Bernoulli dropout on the weights
    drawn from ``generator`` (a generator on q's device)."""
    _, s, h, d = q.shape
    k, v = repeat_kv(k, v, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    mask = causal_mask(s, device=q.device)[None, None]
    if segment_ids is not None:
        mask = mask & segment_mask(segment_ids)
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        keep = torch.rand(weights.shape, generator=generator,
                          device=weights.device) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros_like(weights))
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)

