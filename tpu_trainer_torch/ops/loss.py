"""Fused LM-head + cross entropy (port of ``tpu_trainer/ops/loss.py``).

``fused_shifted_cross_entropy`` is the mean next-token cross entropy of
the tied head without a ``[batch, seq, vocab]`` logits buffer that
outlives its chunk. Two paths, chosen by a configuration rule
(``_pallas_head_ok``, the JAX rule with "on a CUDA device" in place of
"on a TPU"):

- the fused head kernel (``ops/head_ce.py``) for bf16 compute with 2048 to
  16384 tokens on a CUDA device;
- ``_chunked_ce`` otherwise: the sequence in chunks, each chunk's f32
  logits transient, the forward saving only the per-token logsumexp and
  the backward recomputing each chunk's logits to form ``dx`` and ``dE``.

Products of compute-dtype operands are taken in f32 (the JAX package's
``preferred_element_type=float32``).

Under a ``tensor`` axis (``tensor=`` the tensor group's ``Collectives``)
the loss is the vocab-sharded head of the JAX ``_tp_loss``: one tiled
all-to-all turns the embedding's ``[V, H/ts]`` hidden slice into a
``[ceil(V/ts), H]`` vocab slice, each rank computes its vocab columns'
logits (a plain matmul, as in JAX, where this head is outside any Pallas
kernel), and only the softmax statistics cross ranks (the max and the
sum over ``[b, chunk]``). The fused head kernel is refused there
(``_pallas_head_ok``), as JAX refuses its Pallas head. JAX's
``_scale_grad`` undoes ``shard_map``'s seeding of a replicated output's
cotangent with ``g / axis_size``; eager autograd seeds each rank's copy
of the loss with 1, so the port needs no counterpart: each rank's vocab
slice gradient is whole and the partial ``dx`` is summed once by
``collectives.copy_to_tensor``.

Under a ``sequence`` axis (``seq_shard=(offset, global_len)``) ``x`` is
the rank's ``[b, sl, H]`` slice and ``labels`` its ``[b, sl + 1]`` ids
(the slice and the next column, the next rank's first token): the shift
is global, the last global position is masked, and the loss is the
rank's share of the global mean (its targets' sum over the global
count), which the trainer sums over the sequence group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_trainer_torch.parallel import collectives as coll_lib

_DEFAULT_CHUNK_TOKENS = 8192


def _chunk_len(batch: int, seq: int, chunk_size: int) -> int:
    """Sequence-chunk length: explicit override, else ~8k tokens a chunk,
    rounded down to a divisor of ``seq``; a degenerate divisor (< 128
    positions) gives one chunk."""
    if chunk_size > 0:
        c = min(chunk_size, seq)
    else:
        c = min(seq, max(128, _DEFAULT_CHUNK_TOKENS // max(batch, 1)))
    while seq % c != 0:
        c -= 1
    if c < min(128, seq):
        return seq
    return c


class _ChunkedCE(torch.autograd.Function):
    """Blockwise shifted CE with a recomputing backward (``loss.py:84-169``
    of the JAX package)."""

    @staticmethod
    def forward(ctx, emb, x, labels, mask, chunk):
        b, s, _ = x.shape
        e32 = emb.to(x.dtype).float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].float()
            lg = xc @ e32.T                                   # [b, c, V] f32
            lse = torch.logsumexp(lg, dim=-1)
            ll = lg.gather(-1, labels[:, c0:c0 + chunk, None].long())[..., 0]
            total = total + ((lse - ll) * mask[:, c0:c0 + chunk]).sum()
            lses.append(lse)
        denom = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(emb, x, labels, mask, torch.cat(lses, dim=1),
                              denom)
        ctx.chunk = chunk
        return total / denom

    @staticmethod
    def backward(ctx, g):
        emb, x, labels, mask, lse, denom = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, h = x.shape
        e32 = emb.to(x.dtype).float()
        scale = g / denom
        de = torch.zeros((emb.shape[0], h), dtype=torch.float32,
                         device=x.device)
        dx = torch.empty_like(x)
        for c0 in range(0, s, chunk):
            sl = slice(c0, c0 + chunk)
            xc = x[:, sl].float()
            p = torch.exp(xc @ e32.T - lse[:, sl, None])
            p.scatter_add_(-1, labels[:, sl, None].long(),
                           torch.full_like(p[..., :1], -1.0))
            dlg = (p * (mask[:, sl] * scale)[..., None]).to(x.dtype).float()
            dx[:, sl] = (dlg @ e32).to(x.dtype)
            de += torch.einsum("bcv,bch->vh", dlg, xc)
        return de.to(emb.dtype), dx, None, None, None


def _chunked_ce(emb, x, labels, mask, chunk: int) -> torch.Tensor:
    return _ChunkedCE.apply(emb, x, labels, mask, chunk)


def segment_target_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Float ``[batch, seq]`` mask of valid next-token targets under
    packing: ``seg[t+1] == seg[t] and seg[t] != 0`` (the last position is
    masked too)."""
    b = segment_ids.shape[0]
    nxt = torch.cat([segment_ids[:, 1:],
                     torch.zeros((b, 1), dtype=segment_ids.dtype,
                                 device=segment_ids.device)], dim=1)
    return ((segment_ids == nxt) & (segment_ids != 0)).float()


def _pallas_head_ok(x: torch.Tensor, chunk_size: int,
                    tensor_size: int = 1) -> bool:
    """Route to the fused head kernel? bf16 compute, 2048 <= tokens <=
    16384 (the kernel's saved logits are not chunked), no explicit
    ``loss_chunk_size``, a CUDA device, and no tensor axis (the
    vocab-sharded head, ``_tp_loss``, owns that case, as in JAX). A
    sequence axis keeps the kernel: it runs on the rank's tokens."""
    b, s, _ = x.shape
    if chunk_size > 0 or tensor_size > 1:
        return False
    if x.dtype != torch.bfloat16 or not 2048 <= b * s <= 16384:
        return False
    return x.device.type == "cuda"


def _vshard_cols(vs: int, vocab: int, rank: int, device):
    """A vocab slice's global column offset and its valid columns (the
    last slice may overhang a vocab that does not divide)."""
    off = rank * vs
    return off, (off + torch.arange(vs, device=device)) < vocab


_NEG = -1e30   # -inf without the inf - inf hazard


class _ChunkedCEVShard(torch.autograd.Function):
    """Blockwise shifted CE over a vocab slice (``loss.py:200-323`` of the
    JAX package): the forward assembles each chunk's global logsumexp
    from the slices' max and sum over the tensor group; the backward needs
    no collective (``lse`` spans the vocab) and returns this slice's
    ``d e_slice`` and the partial ``dx`` (summed by the caller's
    ``copy_to_tensor``)."""

    @staticmethod
    def forward(ctx, e_slice, x, labels, mask, chunk, coll, vocab, denom,
                prefix, cdtype):
        b, s, _ = x.shape
        vs = e_slice.shape[0]
        e32 = e_slice.to(cdtype).float()
        off, col_ok = _vshard_cols(vs, vocab, coll.rank, x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk].float()
            lg = torch.where(col_ok, xc @ e32.T, _NEG)        # [b, c, vs]
            m = coll.all_reduce_max(lg.amax(dim=-1), kind=f"{prefix}_max")
            se = torch.exp(lg - m[..., None]).sum(dim=-1)
            lcol = labels[:, c0:c0 + chunk].long() - off
            inside = (lcol >= 0) & (lcol < vs)
            ll = torch.where(inside, lg.gather(
                -1, lcol.clamp(0, vs - 1)[..., None])[..., 0], 0.0)
            se, ll = coll.all_reduce_sum(torch.stack([se, ll]),
                                         kind=f"{prefix}_allreduce")
            lse = m + torch.log(se)
            total = total + ((lse - ll) * mask[:, c0:c0 + chunk]).sum()
            lses.append(lse)
        ctx.save_for_backward(e_slice, x, labels, mask, torch.cat(lses, 1))
        ctx.opts = (chunk, coll.rank, vocab, denom, cdtype)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        e_slice, x, labels, mask, lse = ctx.saved_tensors
        chunk, rank, vocab, denom, cdtype = ctx.opts
        b, s, h = x.shape
        vs = e_slice.shape[0]
        e32 = e_slice.to(cdtype).float()
        off, col_ok = _vshard_cols(vs, vocab, rank, x.device)
        scale = g / denom
        de = torch.zeros((vs, h), dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        for c0 in range(0, s, chunk):
            sl = slice(c0, c0 + chunk)
            xc = x[:, sl].float()
            lg = torch.where(col_ok, xc @ e32.T, _NEG)
            p = torch.exp(lg - lse[:, sl, None])
            lcol = labels[:, sl].long() - off
            inside = (lcol >= 0) & (lcol < vs)
            p.scatter_add_(-1, lcol.clamp(0, vs - 1)[..., None],
                           -inside[..., None].float())
            dlg = (p * (mask[:, sl] * scale)[..., None]).to(cdtype).float()
            dx[:, sl] = (dlg @ e32).to(x.dtype)
            de += torch.einsum("bcv,bch->vh", dlg, xc)
        return (de.to(e_slice.dtype), dx, None, None, None, None, None,
                None, None, None)


def vocab_sharded_shifted_cross_entropy(
        e_slice: torch.Tensor, x: torch.Tensor, labels: torch.Tensor, *,
        vocab: int, coll, chunk_size: int = 0,
        mask: Optional[torch.Tensor] = None,
        denom=None, prefix: str = "tp",
        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``fused_shifted_cross_entropy`` with the head sharded over the
    group ``coll`` (the tensor group, or the stage group of the 1F1B
    head): this rank holds rows ``[r * vs, (r + 1) * vs)`` of the
    embedding (``vs = e_slice.shape[0]``, zero rows past ``vocab``).
    ``labels [b, s]`` unshifted (``mask`` given: already shifted, with
    ``mask`` the targets kept); the loss comes back the same on every rank
    of the group, ``x``'s gradient is this rank's part (``_tp_loss`` sums
    it). ``denom``: the mean's count (default the kept targets, at least
    1). The collectives count as ``<prefix>_max`` and
    ``<prefix>_allreduce`` (``tp``, or ``pp`` over the stage group).
    ``compute_dtype`` (default ``x``'s): the dtype the embedding slice and
    the logits' cotangent round to; an f32 ``x`` holding compute-dtype
    values then gives an f32 partial ``dx``, rounded once after the
    ranks' sum (the 1F1B head)."""
    b, s, _ = x.shape
    if mask is None:
        labels, mask = _shift(labels, s, x.device)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    return _ChunkedCEVShard.apply(e_slice, x, labels, mask.contiguous(),
                                  _chunk_len(b, s, chunk_size), coll, vocab,
                                  denom, prefix, compute_dtype or x.dtype)


def _tp_loss(emb: torch.Tensor, x: torch.Tensor, shifted: torch.Tensor,
             mask: torch.Tensor, coll, chunk_size: int,
             denom=None) -> torch.Tensor:
    """The tensor-parallel loss (the JAX ``_tp_loss``): ``emb`` is this
    rank's ``[V, H/ts]`` hidden slice of the tied embedding, ``x [b, s,
    H]`` the replicated final hidden states. One tiled all-to-all of the
    zero-padded slice (in ``x``'s dtype) gives the ``[ceil(V/ts), H]``
    vocab slice; ``x`` enters through ``copy_to_tensor`` so its partial
    gradients are summed over the group once."""
    ts = coll.world
    V = emb.shape[0]
    vs = -(-V // ts)
    e_pad = F.pad(emb.to(x.dtype), (0, 0, 0, vs * ts - V))
    e_slice = coll_lib.tensor_all_to_all(e_pad, coll)
    x_in = coll_lib.copy_to_tensor(x, coll)
    return vocab_sharded_shifted_cross_entropy(
        e_slice, x_in, shifted, vocab=V, coll=coll, chunk_size=chunk_size,
        mask=mask, denom=denom)


def _shift(labels: torch.Tensor, s: int, device):
    """``(labels shifted left by one, the mask of real targets)`` of
    ``[b, s]`` ids: the last position has no target."""
    b = labels.shape[0]
    shifted = torch.cat([labels[:, 1:],
                         torch.zeros((b, 1), dtype=labels.dtype,
                                     device=labels.device)], dim=1)
    mask = (torch.arange(s, device=device) < s - 1).float()[None].expand(
        b, s)
    return shifted, mask


def shard_shift(labels: torch.Tensor, s: int, seq_shard: Tuple[int, int],
                 device):
    """``(targets, mask, denominator)`` of a sequence slice of ``s``
    positions at ``seq_shard=(offset, global_len)`` with its ``[b, s + 1]``
    ids: the labels are shifted globally (the slice's last target is the
    next slice's first id), the last global position is masked, and the
    denominator is the global mean's ``b * (global_len - 1)``."""
    off, total = seq_shard
    b = labels.shape[0]
    if labels.shape[1] != s + 1:
        raise ValueError(f"a sequence slice of {s} needs {s + 1} label "
                         f"columns; got {labels.shape[1]}")
    pos = off + torch.arange(s, device=device)
    mask = (pos < total - 1).float()[None].expand(b, s)
    return labels[:, 1:], mask, float(b * (total - 1))


def fused_shifted_cross_entropy(
    emb: torch.Tensor,
    x: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: int = 0,
    allow_pallas: bool = True,
    segment_ids: torch.Tensor = None,
    tensor=None,
    seq_shard: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Mean next-token cross entropy of the tied LM head.

    ``emb [vocab, hidden]`` (the head weight), ``x [batch, seq, hidden]``
    final hidden states, ``labels [batch, seq]`` unshifted ids. With
    ``segment_ids`` targets crossing a packed-document boundary are masked
    and the mean runs over the survivors. ``tensor``: the tensor group
    (``emb`` is then this rank's ``[V, H/ts]`` slice; ``_tp_loss``).
    ``seq_shard=(offset, global_len)``: ``x`` is a sequence slice at
    ``offset`` and ``labels`` its ``[batch, seq + 1]`` ids; the result is
    this slice's share of the global mean (module docstring). Returns a
    scalar f32.
    """
    b, s, _ = x.shape
    denom = None
    if seq_shard is None:
        shifted, mask = _shift(labels, s, x.device)
    else:
        shifted, mask, denom = shard_shift(labels, s, seq_shard, x.device)
    if segment_ids is not None:
        if seq_shard is not None:
            raise NotImplementedError(
                "segment_ids are not supported under sequence parallelism")
        mask = mask * segment_target_mask(segment_ids)
    mask = mask.contiguous()
    ts = 1 if tensor is None else tensor.world
    if ts > 1:
        return _tp_loss(emb, x, shifted, mask, tensor, chunk_size,
                        denom=denom)
    if allow_pallas and _pallas_head_ok(x, chunk_size, ts):
        from tpu_trainer_torch.ops.head_ce import pallas_head_ce

        loss = pallas_head_ce(emb, x, shifted, mask)
    else:
        loss = _chunked_ce(emb, x, shifted, mask,
                           _chunk_len(b, s, chunk_size))
    if denom is not None:
        # Both paths mean over max(kept, 1): rescale to the global count.
        loss = loss * (torch.clamp(mask.sum(), min=1.0) / denom)
    return loss
