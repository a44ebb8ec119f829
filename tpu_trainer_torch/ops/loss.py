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
"""

from __future__ import annotations

import torch

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


def _pallas_head_ok(x: torch.Tensor, chunk_size: int) -> bool:
    """Route to the fused head kernel? bf16 compute, 2048 <= tokens <=
    16384 (the kernel's saved logits are not chunked), no explicit
    ``loss_chunk_size``, and a CUDA device."""
    b, s, _ = x.shape
    if chunk_size > 0:
        return False
    if x.dtype != torch.bfloat16 or not 2048 <= b * s <= 16384:
        return False
    return x.device.type == "cuda"


def fused_shifted_cross_entropy(
    emb: torch.Tensor,
    x: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: int = 0,
    allow_pallas: bool = True,
    segment_ids: torch.Tensor = None,
) -> torch.Tensor:
    """Mean next-token cross entropy of the tied LM head.

    ``emb [vocab, hidden]`` (the head weight), ``x [batch, seq, hidden]``
    final hidden states, ``labels [batch, seq]`` unshifted ids. With
    ``segment_ids`` targets crossing a packed-document boundary are masked
    and the mean runs over the survivors. Returns a scalar f32.
    """
    b, s, _ = x.shape
    shifted = torch.cat([labels[:, 1:],
                         torch.zeros((b, 1), dtype=labels.dtype,
                                     device=labels.device)], dim=1)
    mask = (torch.arange(s, device=x.device) < s - 1).float()[None].expand(
        b, s)
    if segment_ids is not None:
        mask = mask * segment_target_mask(segment_ids)
    if allow_pallas and _pallas_head_ok(x, chunk_size):
        from tpu_trainer_torch.ops.head_ce import pallas_head_ce

        return pallas_head_ce(emb, x, shifted, mask.contiguous())
    return _chunked_ce(emb, x, shifted, mask.contiguous(),
                       _chunk_len(b, s, chunk_size))
