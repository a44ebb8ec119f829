"""Ring attention: causal attention over a sequence-sharded mesh axis
(port of ``tpu_trainer/ops/ring.py``).

Each of the ``sp`` ranks of the ``sequence`` axis holds ``[b, s/sp, h,
d]`` of q, k and v. The K/V chunks go round the ring: at step ``t`` rank
``i`` holds the chunk of rank ``(i - t) % sp``, attends it with its
queries through ``ops.flash.flash_attention(..., return_lse=True)`` (the
Hopper kernels on a CUDA tensor), and the chunks' normalised outputs
combine by their logsumexps: ``out = sum_t o_t exp(lse_t - M) / sum_t
exp(lse_t - M)``. Step 0 is the causal diagonal; later steps run
non-causal and a fully-future chunk (source rank above the queries')
is erased by setting its lse to -inf, so every rank runs the same
schedule.

**Zigzag** (on by default for even local lengths, as in the JAX
package): the sequence is cut in ``2 sp`` half-stripes and rank ``i``
takes stripes ``(i, 2sp-1-i)`` (two half-stripe permutes in, two out).
Step 0 is one causal block over the rank's two stripes; at each later
step a rank needs exactly two half-stripe products, late queries x early
keys and either early x early or late x late, so every rank does the same
causal work.

**The permute is injected.** Every body here runs lock-step over a list
of ranks: ``permute(xs, dest)`` takes one tensor for each rank this
process runs (``xs[j]`` belongs to rank ``ranks[j]``) and a destination
``dest[i]`` for every rank ``i`` of the axis, and returns what each of
those ranks receives. ``loopback_permute`` runs all ``sp`` ranks in one
process (``xs`` is every rank's tensor; the result is a list reindexing
inside one autograd graph); ``parallel.collectives.SequencePermute`` runs
one rank a process over a process group (an autograd function whose
backward is the reverse permute). The backward is autograd through the
permutes and the flash kernel's ``dlse``: no ring-specific backward is
written out, as the JAX ring is differentiated through ``ppermute``.

Attention dropout folds the chunk tag (``idx * sp + src``; the zigzag
tags ``idx`` and ``(2t + 1 or 2) * sp + idx``) into the seed, after the
caller has folded the shard coordinate (``ops.attention.fold_seed``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from tpu_trainer_torch.ops import flash as flash_lib
from tpu_trainer_torch.ops.attention import fold_seed

_NEG_INF = float("-inf")

Permute = Callable[[List[torch.Tensor], Sequence[int]], List[torch.Tensor]]


def loopback_permute(xs: List[torch.Tensor], dest: Sequence[int]
                     ) -> List[torch.Tensor]:
    """Every rank's tensor in one process: rank ``dest[i]`` receives
    ``xs[i]``."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for i, d in enumerate(dest):
        out[d] = xs[i]
    return out


def use_zigzag(sl: int, sp: int, zigzag: Optional[bool] = None) -> bool:
    """The JAX rule: zigzag by default when ``sp > 1`` and the local
    length ``sl`` is even; asking for it with an odd length raises."""
    if zigzag is None:
        return sp > 1 and sl % 2 == 0
    if zigzag and sl % 2 != 0:
        raise ValueError(f"zigzag ring needs an even local length, got {sl}")
    return bool(zigzag) and sp > 1


def forward_launches(sp: int, zigzag: bool) -> int:
    """Flash forward calls of one rank's ring (its backward makes as many
    backward calls): ``sp`` chunks, or zigzag's one block and two
    half-stripe products a later step."""
    return 2 * sp - 1 if (zigzag and sp > 1) else sp


def _bshd(x: torch.Tensor) -> torch.Tensor:
    """``[b, h, s]`` -> ``[b, s, h, 1]``."""
    return x.transpose(1, 2)[..., None]


def _combine(carry, o_t, lse_t):
    m, den, acc = carry
    m_new = torch.maximum(m, lse_t)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_t - m_new)
    acc = acc * _bshd(alpha) + o_t.float() * _bshd(w)
    return m_new, den * alpha + w, acc


def _chunk(q, k, v, causal: bool, dropout_rate: float, seed, tag: int):
    """One chunk's ``(o, lse)`` through the flash kernel."""
    s = None
    if dropout_rate > 0.0:
        s = fold_seed(seed, tag)
    return flash_lib.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        dropout_rate=dropout_rate, seed=s, return_lse=True)


def _contiguous(qs, ks, vs, ranks, sp, permute, dropout_rate, seed):
    ring = [(i + 1) % sp for i in range(sp)]
    carries = []
    for q, k, v, idx in zip(qs, ks, vs, ranks):
        o0, lse0 = _chunk(q, k, v, True, dropout_rate, seed, idx * sp + idx)
        carries.append((lse0, torch.ones_like(lse0), o0.float()))
    kv = [torch.stack([k, v]) for k, v in zip(ks, vs)]
    for t in range(1, sp):
        kv = permute(kv, ring)
        for j, idx in enumerate(ranks):
            src = (idx - t) % sp
            o_t, lse_t = _chunk(qs[j], kv[j][0], kv[j][1], False,
                                dropout_rate, seed, idx * sp + src)
            if src > idx:
                # No key of this chunk precedes any query here.
                lse_t = torch.full_like(lse_t, _NEG_INF)
            carries[j] = _combine(carries[j], o_t, lse_t)
    return [(acc / _bshd(den)).to(q.dtype)
            for (_, den, acc), q in zip(carries, qs)]


def _owner(j: int, sp: int) -> int:
    """The zigzag rank of half-stripe ``j``."""
    return j if j < sp else 2 * sp - 1 - j


def _to_zigzag(xs, ranks, sp, permute):
    """Contiguous chunks -> stripe pairs ``(i, 2sp-1-i)``, early first."""
    half = xs[0].shape[1] // 2
    a = permute([x[:, :half] for x in xs],
                [_owner(2 * i, sp) for i in range(sp)])
    c = permute([x[:, half:] for x in xs],
                [_owner(2 * i + 1, sp) for i in range(sp)])
    return [torch.cat([ai, ci] if idx % 2 == 0 else [ci, ai], dim=1)
            for ai, ci, idx in zip(a, c, ranks)]


def _from_zigzag(xs, ranks, sp, permute):
    """The inverse of ``_to_zigzag``."""
    half = xs[0].shape[1] // 2
    even = [x[:, :half] if idx % 2 == 0 else x[:, half:]
            for x, idx in zip(xs, ranks)]
    odd = [x[:, half:] if idx % 2 == 0 else x[:, :half]
           for x, idx in zip(xs, ranks)]
    dest_even, dest_odd = [0] * sp, [0] * sp
    for i in range(sp):
        dest_even[_owner(2 * i, sp)] = i
        dest_odd[_owner(2 * i + 1, sp)] = i
    lo = permute(even, dest_even)
    hi = permute(odd, dest_odd)
    return [torch.cat([a, b], dim=1) for a, b in zip(lo, hi)]


def _zigzag(qs, ks, vs, ranks, sp, permute, dropout_rate, seed):
    half = qs[0].shape[1] // 2
    qz = _to_zigzag(qs, ranks, sp, permute)
    kz = _to_zigzag(ks, ranks, sp, permute)
    vz = _to_zigzag(vs, ranks, sp, permute)
    ring = [(i + 1) % sp for i in range(sp)]
    # Each rank's carry, one (m, den, acc) per stripe (early, late): a
    # half-stripe product adds to its query stripe's rows alone.
    carries = []
    for q, k, v, idx in zip(qz, kz, vz, ranks):
        o0, lse0 = _chunk(q, k, v, True, dropout_rate, seed, idx)
        carries.append([(lse0[..., p], torch.ones_like(lse0[..., p]),
                         o0[:, p].float())
                        for p in (slice(None, half), slice(half, None))])
    kv = [torch.stack([k, v]) for k, v in zip(kz, vz)]
    for t in range(1, sp):
        kv = permute(kv, ring)
        for j, idx in enumerate(ranks):
            src = (idx - t) % sp
            q, k_t, v_t = qz[j], kv[j][0], kv[j][1]
            # Late queries x early keys: needed at every step.
            o1, lse1 = _chunk(q[:, half:], k_t[:, :half], v_t[:, :half],
                              False, dropout_rate, seed,
                              (t * 2 + 1) * sp + idx)
            carries[j][1] = _combine(carries[j][1], o1, lse1)
            # Early x early when the arriving pair is older, else late x
            # late: one product either way.
            low = src < idx
            part = slice(None, half) if low else slice(half, None)
            o2, lse2 = _chunk(q[:, part], k_t[:, part], v_t[:, part], False,
                              dropout_rate, seed, (t * 2 + 2) * sp + idx)
            carries[j][0 if low else 1] = _combine(
                carries[j][0 if low else 1], o2, lse2)
    out = [torch.cat([(acc / _bshd(den)) for _, den, acc in c],
                     dim=1).to(q.dtype)
           for c, q in zip(carries, qs)]
    return _from_zigzag(out, ranks, sp, permute)


def ring_attention_local(qs: List[torch.Tensor], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], ranks: Sequence[int],
                         sp: int, permute: Permute, *,
                         dropout_rate: float = 0.0,
                         seed: Optional[int] = None,
                         zigzag: Optional[bool] = None
                         ) -> List[torch.Tensor]:
    """The ring over the ranks ``ranks`` of a sequence axis of ``sp``,
    lock-step: ``qs[j]`` etc. are rank ``ranks[j]``'s local ``[b, sl, h,
    d]`` q / ``[b, sl, kvh, d]`` k and v (RoPE already applied at global
    positions); returns each rank's ``[b, sl, h, d]`` output. ``seed``
    (dropout) is the caller's, already folded with the shard coordinate;
    the chunk tags are folded here."""
    sl = qs[0].shape[1]
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    body = _zigzag if use_zigzag(sl, sp, zigzag) else _contiguous
    return body(list(qs), list(ks), list(vs), list(ranks), sp, permute,
                dropout_rate, seed)


def ring_attention_loopback(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, sp: int, *,
                            dropout_rate: float = 0.0,
                            seed: Optional[int] = None,
                            zigzag: Optional[bool] = None) -> torch.Tensor:
    """Causal ring attention of global ``[b, s, h, d]`` operands with all
    ``sp`` ranks run in this process (``loopback_permute``): the global
    output, differentiable. ``s % sp`` must be 0."""
    s = q.shape[1]
    if s % sp != 0:
        raise ValueError(f"seq {s} not divisible by sequence axis size {sp}")
    chunks = [t.chunk(sp, dim=1) for t in (q, k, v)]
    out = ring_attention_local(list(chunks[0]), list(chunks[1]),
                               list(chunks[2]), range(sp), sp,
                               loopback_permute, dropout_rate=dropout_rate,
                               seed=seed, zigzag=zigzag)
    return torch.cat(out, dim=1)
