"""Speculative decoding (port of ``tpu_trainer/serving/spec.py``):
draft-propose / batch-verify over the paged KV cache.

A proposer guesses the next K tokens of each request; the target scores
all K+1 positions in ONE forward of the ``[b, W]`` window through the
chunked-prefill branch of the paged model (each row at its cached
offset, the pooled history behind it), and the acceptance rule keeps the
longest draft prefix the target agrees with plus one token the target
supplies itself. A verify step emits between 1 and K+1 tokens for one
dispatch.

Two proposers, both deterministic (a point-mass draft distribution):

- ``NGramProposer`` — prompt-lookup drafting: the continuation of the
  most recent earlier occurrence of the context's suffix. Host-side
  Python, no device work.
- ``DraftModelProposer`` — a small draft model (the target's first
  layers, ``draft_from_target``) decoding greedily over its OWN paged
  cache through the engine's step: one chunked catch-up feed of the
  tokens accepted since its last proposal, then K-1 single-token decode
  steps (the flash-decode kernel on the card). After verification its
  cache rewinds to the accepted prefix.

The rule, with ``p`` the request's filtered distribution
(``sampling.filter_logits``, what the plain sampler draws from):

- greedy rows: accept draft ``d_i`` iff it equals the target's argmax at
  position i, so the emitted tokens ARE the plain greedy stream;
- sampled rows: accept ``d_i`` with probability ``p(d_i)``; on a
  rejection draw from ``p`` with ``d_i`` masked out; if every draft
  survives, draw the bonus token from ``p``. The mixture is exactly
  ``p``. At token index t the accept uniform and the residual draw use
  the salted seeds ``draw_seed(key, t, 1)`` / ``draw_seed(key, t, 2)``
  and the bonus draw the unsalted one, the draw ``sample_tokens`` makes
  at t: a window of one is the plain sampler, token for token. JAX's
  threefry draws are not reproduced, so sampled streams equal the JAX
  package's in distribution only.

``AdaptiveK`` shrinks a request's draft length when its acceptance EWMA
drops and regrows it when drafts land.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpu_trainer_torch.serving.paged_cache import PagedKVCache
from tpu_trainer_torch.serving.sampling import (filter_logits, gumbel_noise,
                                                uniform)

# Salts of the two extra draws made at one token index.
_SALT_ACCEPT = 1
_SALT_RESIDUAL = 2


# --- proposers --------------------------------------------------------------


class NGramProposer:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the current context suffix, trying the
    longest n-gram first."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose_one(self, context: List[int], k: int) -> List[int]:
        """Self-extending lookup: when a match's continuation runs out
        before ``k`` (a short cycle), look up again with the draft so far
        appended, so a period-p loop drafts the full window."""
        out: List[int] = []
        ctx = list(context)
        while len(out) < k:
            nxt = self._lookup(ctx, k - len(out))
            if not nxt:
                break
            out.extend(nxt)
            ctx.extend(nxt)
        return out

    def _lookup(self, context: List[int], k: int) -> List[int]:
        if k <= 0 or len(context) < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, len(context) - 1),
                       self.min_ngram - 1, -1):
            suffix = context[-n:]
            # Most recent occurrence that ends strictly before the suffix
            # itself starts.
            for start in range(len(context) - n - 1, -1, -1):
                if context[start:start + n] == suffix:
                    cont = context[start + n:start + n + k]
                    if cont:
                        return [int(t) for t in cont]
        return []

    def propose(self, reqs, k_of: Dict[int, int]) -> Dict[int, List[int]]:
        return {r.rid: self.propose_one(r.prompt + r.generated,
                                        k_of[r.rid]) for r in reqs}

    def rewind(self, req, accepted: int) -> None:
        pass   # stateless


class DraftModelProposer:
    """Greedy draft-model proposer over its own paged cache.

    The draft pool holds every slot at full context, so its allocation
    never fails. Slot state is keyed by (slot, rid): a slot reused by a
    new request resets lazily, and a preempted request re-feeds its
    stream. ``good[slot]`` counts the leading tokens of the true stream
    whose K/V the draft cache holds; speculative feeds past it are
    rolled back by ``rewind``. ``decode_dispatches`` counts the
    single-token steps (each launches the decode kernel once a layer on
    the card)."""

    name = "draft"

    def __init__(self, draft_params, draft_config, *, slots: int,
                 block_size: int, attention: str = "auto", device=None):
        from tpu_trainer_torch.models.gpt import init_paged_cache
        from tpu_trainer_torch.models.weights import build_model
        from tpu_trainer_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        mbpr = -(-draft_config.max_seq_len // block_size)
        self.config = dataclasses.replace(
            draft_config,
            dropout=0.0, attention_dropout=0.0,
            decode_paged=True, decode_ragged=False,
            paged_block_size=block_size,
            paged_num_blocks=slots * mbpr + 1,
            paged_max_blocks=mbpr,
            paged_kv_int8=False,
            paged_attention=attention,
        )
        self.model = build_model(self.config, draft_params, self.device)
        self.slots = slots
        self.cache_state = PagedKVCache(self.config, slots)
        self.device_cache = init_paged_cache(self.config, slots,
                                             device=self.device)
        self.good = np.zeros((slots,), np.int64)
        self.fed = np.zeros((slots,), np.int64)
        self.base = np.zeros((slots,), np.int64)
        self.slot_rid = -np.ones((slots,), np.int64)
        self.decode_dispatches = 0

    def _ensure_blocks(self, slot: int, n_tokens: int) -> None:
        cs = self.cache_state
        need = cs.blocks_for(n_tokens) - len(cs.slot_blocks(slot))
        if need > 0:
            got = cs.pool.alloc(need)
            if got is None:
                raise RuntimeError("draft pool is sized for full contexts")
            cs.extend(slot, got)

    def _dispatch(self, reqs, ids, lengths, offsets, *, prefill,
                  hist_blocks):
        from tpu_trainer_torch.serving.engine import _engine_step

        slots = self.slots
        tables = np.zeros_like(self.cache_state.tables)
        for r in reqs:
            tables[r.slot] = self.cache_state.tables[r.slot]
        tokens = _engine_step(
            self.model, self.device_cache, tables, lengths, offsets, ids,
            np.zeros((slots,), np.float32), np.zeros((slots,), np.int64),
            np.ones((slots,), np.float32), [0] * slots, [0] * slots,
            k_cap=1, prefill=prefill, hist_blocks=hist_blocks)
        if not prefill:
            self.decode_dispatches += 1
        return tokens.cpu().numpy()

    def propose(self, reqs, k_of: Dict[int, int]) -> Dict[int, List[int]]:
        from tpu_trainer_torch.serving.engine import _bucket_pow2

        cs = self.cache_state
        for r in reqs:
            if self.slot_rid[r.slot] != r.rid:
                if cs.slot_blocks(r.slot):
                    cs.release(r.slot)
                self.slot_rid[r.slot] = r.rid
                self.good[r.slot] = 0
        max_m = max((k_of[r.rid] for r in reqs), default=0)
        if max_m <= 0:
            return {r.rid: [] for r in reqs}

        # Catch-up: feed each request's stream tokens the draft cache is
        # missing as one chunk at the cached offset.
        slots = self.slots
        feeds = {r.rid: r.context_len() - int(self.good[r.slot])
                 for r in reqs}
        width = min(_bucket_pow2(max(feeds.values()), lo=2),
                    cs.capacity_tokens())
        ids = np.zeros((slots, width), np.int64)
        lengths = np.zeros((slots,), np.int32)
        offsets = np.zeros((slots,), np.int32)
        max_hist = 0
        for r in reqs:
            stream = r.prompt + r.generated
            n_total = len(stream)
            cur = int(self.good[r.slot])
            self._ensure_blocks(r.slot, n_total + max_m - 1)
            ids[r.slot, :n_total - cur] = stream[cur:]
            lengths[r.slot] = n_total
            offsets[r.slot] = cur
            max_hist = max(max_hist, cur)
            self.base[r.slot] = n_total
            self.fed[r.slot] = n_total
        hist_blocks = 0
        if max_hist > 0:
            hist_blocks = min(
                _bucket_pow2(cs.blocks_for(max_hist), lo=1), cs.max_blocks)
        tokens = self._dispatch(reqs, ids, lengths, offsets, prefill=True,
                                hist_blocks=hist_blocks)
        proposals = {r.rid: [int(tokens[r.slot])] for r in reqs}

        # Roll forward: greedy single-token decode steps, feeding each row
        # its own previous draft.
        for t in range(1, max_m):
            ids1 = np.zeros((slots, 1), np.int64)
            lengths = np.zeros((slots,), np.int32)
            for r in reqs:
                ids1[r.slot, 0] = proposals[r.rid][-1]
                lengths[r.slot] = int(self.base[r.slot]) + t - 1
            tokens = self._dispatch(
                reqs, ids1, lengths, np.zeros((slots,), np.int32),
                prefill=False, hist_blocks=0)
            for r in reqs:
                proposals[r.rid].append(int(tokens[r.slot]))
                self.fed[r.slot] = int(self.base[r.slot]) + t
        return {r.rid: proposals[r.rid][:k_of[r.rid]] for r in reqs}

    def rewind(self, req, accepted: int) -> None:
        """Roll the draft cache back to the verified prefix: the first
        ``accepted`` drafts joined the true stream; anything fed past
        them is overwritten by the next feed."""
        slot = req.slot
        if slot is None or self.slot_rid[slot] != req.rid:
            return
        self.good[slot] = min(self.base[slot] + accepted, self.fed[slot])


def draft_from_target(params, config, n_layers: int):
    """A draft model made of the target's FIRST ``n_layers`` layers with
    the embedding and final norm shared: the ``layers.*`` leaves of the
    state dict are stacked ``[num_layers, ...]`` and are sliced."""
    if not 1 <= n_layers < config.num_layers:
        raise ValueError(
            f"draft layers {n_layers} outside [1, {config.num_layers - 1}]")
    draft = {name: (value[:n_layers] if name.startswith("layers.")
                    else value) for name, value in params.items()}
    return draft, dataclasses.replace(config, num_layers=n_layers)


# --- adaptive draft length --------------------------------------------------


class AdaptiveK:
    """Per-request draft-length controller on an acceptance-rate EWMA:
    drafts dying (rate below ``low``) shrink K by one per step toward 1;
    drafts landing (rate above ``high``) regrow it toward ``k_max``."""

    def __init__(self, k_max: int, *, low: float = 0.3, high: float = 0.7,
                 alpha: float = 0.5):
        if k_max < 1:
            raise ValueError(f"k_max {k_max} < 1")
        self.k_max = k_max
        self.low = low
        self.high = high
        self.alpha = alpha
        self.k = k_max
        self.ewma = 1.0

    def update(self, drafted: int, accepted: int) -> int:
        if drafted > 0:
            rate = accepted / drafted
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * rate
            if self.ewma < self.low:
                self.k = max(1, self.k - 1)
            elif self.ewma > self.high:
                self.k = min(self.k_max, self.k + 1)
        return self.k


# --- the verifier -----------------------------------------------------------


def accept_emit(
    logits: torch.Tensor,    # [b, W, vocab] f32 per-position target logits
    ids: torch.Tensor,       # [b, W] the fed window: [last token, drafts...]
    draft_lens,              # [b] true draft count per row (<= W-1)
    temps,                   # [b] (host)
    top_ks,                  # [b] (host)
    top_ps,                  # [b] (host)
    keys,                    # [b] request keys (host)
    steps,                   # [b] token index of the FIRST draw this step
    *,
    k_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The acceptance rule on logits, on their device. Returns
    ``(emitted [b, W], n_acc [b])``: the host consumes
    ``emitted[:n_acc + 1]`` per row — accepted drafts followed by the
    target's correction (rejection) or bonus (all accepted) token."""
    b, w, vocab = logits.shape
    dev = logits.device
    temps = np.asarray(temps, np.float32)
    tgt = torch.argmax(logits, dim=-1)                       # [b, W]
    dlens = torch.as_tensor(np.asarray(draft_lens), device=dev)
    sampled = np.flatnonzero(temps > 0)
    emitted = tgt                 # greedy rows: the argmax chain
    if w > 1:
        drafts = ids[:, 1:]                                  # [b, W-1]
        ok = drafts == tgt[:, :-1]
    if sampled.size:
        scaled = filter_logits(
            logits.reshape(b * w, vocab),
            torch.as_tensor(np.repeat(temps, w), device=dev),
            torch.as_tensor(np.repeat(np.asarray(top_ks, np.int64), w),
                            device=dev),
            torch.as_tensor(np.repeat(np.asarray(top_ps, np.float32), w),
                            device=dev),
            k_cap=k_cap).reshape(b, w, vocab)
        emitted = tgt.clone()
        for r in map(int, sampled):
            key, st = keys[r], int(steps[r])
            if w > 1:
                probs = torch.softmax(scaled[r, :-1], dim=-1)
                p_d = torch.gather(probs, 1, drafts[r][:, None])[:, 0]
                u = torch.cat([uniform(key, st + i, dev, salt=_SALT_ACCEPT)
                               for i in range(w - 1)])
                ok[r] = u < p_d
            for i in range(w):
                bonus = torch.argmax(
                    scaled[r, i] + gumbel_noise(key, st + i, vocab, dev))
                if w == 1:
                    emitted[r, i] = bonus
                    continue
                # The residual draw for a rejection AT position i: the
                # rejected draft ids[r, i + 1] masked out.
                d = ids[r, min(i + 1, w - 1)]
                resid = scaled[r, i].clone()
                resid[d] = float("-inf")
                rtok = torch.argmax(resid + gumbel_noise(
                    key, st + i, vocab, dev, salt=_SALT_RESIDUAL))
                emitted[r, i] = torch.where(dlens[r] > i, rtok, bonus)
    if w > 1:
        ok = ok & (torch.arange(w - 1, device=dev)[None, :] < dlens[:, None])
        n_acc = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)
    else:
        n_acc = torch.zeros((b,), dtype=torch.long, device=dev)
    if sampled.size and w > 1:
        # Sampled rows emit their accepted drafts, then the fix token.
        rows = torch.as_tensor(sampled, device=dev)
        iw = torch.arange(w, device=dev)[None, :]
        drafts_at = torch.cat(
            [ids[rows, 1:], torch.zeros_like(ids[rows, :1])], dim=1)
        emitted[rows] = torch.where(iw < n_acc[rows][:, None], drafts_at,
                                    emitted[rows])
    return emitted, n_acc


@torch.inference_mode()
def _verify_step(
    model, cache, tables, lengths, offsets, ids, draft_lens, temps, topks,
    topps, keys, steps, *, k_cap: int, hist_blocks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One verify step: copy the host scheduling state into the device
    cache, forward the ``[b, W]`` window through the chunked-prefill
    branch at each row's cached offset keeping every position's logits,
    and run the acceptance rule on the device — the host reads back
    tokens and counts, never ``[b, W, vocab]`` logits. A tensor-parallel
    target's ``model`` gathers its parameter shards and attends over its
    per-shard pools, as ``engine._engine_step`` does."""
    dev = cache["tables"].device
    cache["tables"].copy_(torch.from_numpy(tables))
    cache["lengths"].copy_(torch.from_numpy(lengths))
    cache["offsets"].copy_(torch.from_numpy(offsets))
    ids_t = torch.from_numpy(ids).to(dev)
    logits = model(ids_t, cache, hist_blocks=hist_blocks)
    return accept_emit(logits, ids_t, draft_lens, temps, topks, topps, keys,
                       steps, k_cap=k_cap)


# --- orchestration state ----------------------------------------------------


class SpecDecoder:
    """Host-side speculative-decode state for one engine: the proposer,
    per-request adaptive-K controllers, and the accepted-per-step
    histogram."""

    def __init__(self, proposer, *, k: int, adaptive: bool = True):
        if k < 1:
            raise ValueError(f"spec_k {k} < 1")
        self.proposer = proposer
        self.k = k
        self.adaptive = adaptive
        self._ctl: Dict[int, AdaptiveK] = {}
        self.accept_hist: List[int] = []

    def k_for(self, req) -> int:
        """Draft budget for this request now: the controller's K, capped
        so an accepted window plus its bonus never overshoots
        ``max_new_tokens``."""
        k = self._ctl[req.rid].k if req.rid in self._ctl else self.k
        remaining = req.max_new_tokens - len(req.generated)
        return max(0, min(k, remaining - 1))

    def propose(self, reqs) -> Dict[int, List[int]]:
        k_of = {r.rid: self.k_for(r) for r in reqs}
        out = self.proposer.propose(reqs, k_of)
        return {rid: props[:k_of[rid]] for rid, props in out.items()}

    def observe(self, req, drafted: int, accepted: int) -> None:
        req.spec_drafted += drafted
        req.spec_accepted += accepted
        req.spec_steps += 1
        while len(self.accept_hist) <= accepted:
            self.accept_hist.append(0)
        self.accept_hist[accepted] += 1
        if self.adaptive and drafted > 0:
            ctl = self._ctl.setdefault(req.rid, AdaptiveK(self.k))
            ctl.update(drafted, accepted)
        self.proposer.rewind(req, accepted)

    def forget(self, req) -> None:
        """Drop per-request state on every terminal transition or
        handoff (the proposer's slot state is keyed (slot, rid) and
        resets on reuse)."""
        self._ctl.pop(req.rid, None)

    def reset_stats(self) -> None:
        self.accept_hist = []
