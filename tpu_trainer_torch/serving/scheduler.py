"""Continuous-batching scheduler (port of ``tpu_trainer/serving/scheduler.py``).

Iteration-level (Orca-style) scheduling, all deterministic host-side
Python over ``PagedKVCache``'s mirrors — decision for decision the JAX
package's:

- **Admission** (FIFO, by block budget): the queue head is admitted when a
  slot is free and the pool (free plus LRU-evictable prefix blocks)
  covers its context's blocks plus ``watermark_blocks``. With prefix
  caching, matched full blocks are shared and the request's
  ``prefill_cursor`` starts past them.
- **Chunked prefill** (``prefill_chunk_tokens``): a prefill iteration
  feeds at most that many tokens, FIFO over the requests mid-prefill;
  with both mid-prefill and decodable requests, prefill and decode
  iterations alternate.
- **Decode growth**: a request crossing a block boundary gets one block
  just in time.
- **Preemption** (recompute): when the pool runs dry the latest-admitted
  request frees everything and goes back to the FRONT of the queue; it
  re-prefills prompt + generated on re-admission. Sampling is keyed by
  (seed, token index), so the resumed stream is token-identical.
- **Retirement / cancellation / deadlines**: blocks return the same
  iteration; the engine sweeps deadlines at the top of each step.
- **Speculative decode**: admission budgets a worst-case draft window
  (``spec_reserve_tokens``); ``ensure_spec_blocks`` grows a request's
  blocks for its verify window before the step and ``shrink_spec_blocks``
  hands back what the rejected drafts used.
- **KV migration**: ``extract`` hands a running request off (prefill
  role); a request arriving with ``_kv_migration`` matches its full prompt
  blocks through the store and gets its raw tail written in place.
- **Fleet export** (``export_requests``): the failover and shrink path of
  the front-end strips queued (and in-flight) requests out, reset to
  fresh-waiting state, for resubmission on another replica.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from tpu_trainer_torch.serving.kv_store import leaves_nbytes
from tpu_trainer_torch.serving.paged_cache import PagedKVCache
from tpu_trainer_torch.serving.sharding import shard_factor

TERMINAL_STATES = frozenset(
    {"finished", "cancelled", "deadline_exceeded", "failed"})


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling knobs (``temperature == 0`` = exact greedy;
    ``top_p == 1`` = no nucleus filter), validated at construction."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature {self.temperature} < 0")
        if self.top_k < 0:
            raise ValueError(f"top_k {self.top_k} < 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p {self.top_p} outside (0, 1]")


@dataclasses.dataclass
class Request:
    """One generation request plus its scheduler/engine runtime state."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: float = 0.0
    eos_id: Optional[int] = None
    # Absolute deadline in the engine's clock domain; None = none.
    deadline: Optional[float] = None

    # Runtime state (engine/scheduler-owned).
    generated: List[int] = dataclasses.field(default_factory=list)
    status: str = "waiting"
    slot: Optional[int] = None
    preemptions: int = 0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    admitted_at: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    # Chunked-prefill cursor: tokens of (prompt + generated-at-admission)
    # already in the cache; the request decodes once it reaches target.
    prefill_cursor: int = 0
    prefill_target: int = 0
    prefill_chunk: int = 0             # tokens to feed THIS iteration
    prefix_hit_tokens: int = 0         # prompt tokens skipped at admission
    # Speculative-decode telemetry: drafts proposed / accepted over this
    # request's verify steps.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_steps: int = 0
    _blocks_registered: int = 0        # prompt blocks published to the index
    _prompt_digests = None             # chained digests, hashed once
    # Migrated raw-tail payload ({"tail_ntok", "leaves"}) attached between
    # ``extract`` on a prefill engine and admission on a decode engine;
    # consumed (and cleared) by the first admission.
    _kv_migration = None
    _key = None                        # lazily built sampling key

    def context_len(self) -> int:
        """Tokens fed to the model so far (prompt + sampled)."""
        return len(self.prompt) + len(self.generated)

    def cached_tokens(self) -> int:
        """Tokens whose K/V sit in the cache (the newest sampled token is
        the next decode step's input, not cached yet)."""
        n = self.context_len()
        return n - 1 if self.generated else n

    def prefilling(self) -> bool:
        return self.prefill_cursor < self.prefill_target

    def key(self) -> int:
        if self._key is None:
            from tpu_trainer_torch.serving.sampling import request_key

            self._key = request_key(self.sampling.seed)
        return self._key


class Scheduler:
    """Iteration-level scheduler over one ``PagedKVCache`` slot batch."""

    def __init__(self, cache: PagedKVCache, *, watermark_blocks: int = 0,
                 max_prefill_rows: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 spec_reserve_tokens: int = 0):
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens={prefill_chunk_tokens}")
        self.cache = cache
        self.watermark = watermark_blocks
        self.max_prefill_rows = max_prefill_rows or cache.slots
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # Admission budgets the context plus a worst-case draft window
        # (K + 1 tokens); growth itself stays just in time.
        self.spec_reserve_tokens = spec_reserve_tokens
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []   # admission order
        self._free_slots = list(range(cache.slots))
        self._last_was_prefill = False
        # False on a prefill-role engine: requests stop after prefill and
        # their first token, until they are extracted for migration.
        self.decode_enabled = True
        self.n_preemptions = 0
        self.n_admissions = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.n_migrated_tail_fills = 0  # migrated raw tails admitted
        self.n_migration_declined = 0   # tails priced out (recompute won)
        self.terminal_counts = {s: 0 for s in sorted(TERMINAL_STATES)}
        # Span hooks wired by the engine: a SpanTracer and its clock.
        self.tracer = None
        self.now_fn = None

    def _emit(self, req: Request, event: str, **attrs) -> None:
        if self.tracer is not None and self.now_fn is not None:
            self.tracer.emit(req.rid, event, self.now_fn(), **attrs)

    # -- queue interface ---------------------------------------------------

    def add(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        need = self.cache.blocks_for(len(req.prompt) + req.max_new_tokens)
        if need > self.cache.max_blocks:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} needs {need} blocks > table width "
                f"{self.cache.max_blocks}")
        req.status = "waiting"
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def pool_shard_stats(self) -> dict:
        """Block budget per shard of the replica's pool: total blocks
        over ``shard_factor`` (each kv-head-sharded shard holds 1/tp of
        every block; a replicated pool holds every block whole)."""
        cfg = self.cache.config
        tp = cfg.paged_tp
        total = cfg.paged_num_blocks
        return {
            "tp": int(tp),
            "total_pool_blocks": int(total),
            "device_pool_blocks": int(total // shard_factor(cfg.kv_heads, tp)),
        }

    # -- load signals ------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def oldest_waiting_arrival(self) -> Optional[float]:
        return min((r.arrival_time for r in self.waiting), default=None)

    @property
    def outstanding_tokens(self) -> int:
        """Token-steps of work still owed (waiting + running)."""
        total = 0
        for r in self.waiting:
            total += r.context_len() + r.max_new_tokens - len(r.generated)
        for r in self.running:
            total += max(0, r.prefill_target - r.prefill_cursor)
            total += r.max_new_tokens - len(r.generated)
        return total

    # -- drain/export (failover and shrink-teardown) -----------------------

    def export_requests(self, *, waiting_only: bool = False) -> List[Request]:
        """Strip every queued (and, unless ``waiting_only``, in-flight)
        request out of this scheduler, reset to fresh-waiting state, for
        resubmission elsewhere. Running requests are preempted first
        (blocks released, cursors reset). Generated tokens, timestamps and
        sampling state survive: re-admission re-prefills prompt +
        generated, and (seed, token index) sampling makes the resumed
        stream token-identical. Returned in (arrival_time, rid) order."""
        if not waiting_only:
            while self.running:
                self.preempt(self.running[-1])
        out = sorted(self.waiting, key=lambda r: (r.arrival_time, r.rid))
        self.waiting.clear()
        for req in out:
            # A handoff, not a terminal: the obligation moves to whoever
            # ingests the request next.
            self._emit(req, "exported", generated=len(req.generated))
        return out

    def extract(self, req: Request) -> None:
        """Migration handoff: strip one running request out (blocks
        released, cursors reset, status waiting) for admission on another
        engine. Its K/V survives in the prefix index / store (the caller
        harvests before calling), and the (seed, token index) sampling
        keeps the resumed stream token-identical wherever it lands."""
        self._vacate(req)
        req.status = "waiting"
        req.prefill_cursor = 0
        req.prefill_target = 0
        req.prefill_chunk = 0
        self._emit(req, "exported", generated=len(req.generated),
                   migrated=True)

    # -- the per-iteration decision ---------------------------------------

    def _admit(self) -> List[Request]:
        """FIFO admission of the queue head while slots and the block
        budget (free + prefix-evictable, minus the watermark) last."""
        admitted: List[Request] = []
        while (self.waiting and self._free_slots
               and len(admitted) < self.max_prefill_rows):
            req = self.waiting[0]
            ctx = req.context_len()
            if req._prompt_digests is None and self.cache.prefix_cache:
                req._prompt_digests = self.cache.block_digests(req.prompt)
            mig = req._kv_migration
            # prefix_lookup hands back blocks already retained for us. A
            # migrating request arrives with generated tokens, so every
            # full prompt block is matchable.
            shared, matched = self.cache.prefix_lookup(
                req.prompt, digests=req._prompt_digests,
                context_len=ctx if mig is not None else None)
            budget_blocks = min(
                self.cache.blocks_for(ctx + self.spec_reserve_tokens),
                self.cache.max_blocks)
            need = budget_blocks - len(shared)
            if need + self.watermark > self.cache.available_blocks:
                if shared:
                    self.cache.pool.free(shared)
                break
            # Only the context's blocks are allocated now.
            need = self.cache.blocks_for(ctx) - len(shared)
            self.waiting.popleft()
            fresh = self.cache.alloc_blocks(need)
            if fresh is None:   # guarded by the budget check above
                raise RuntimeError("admission allocation failed")
            slot = self._free_slots.pop(0)
            self.cache.assign(slot, shared + fresh)
            if mig is not None:
                matched = self._ingest_migrated_tail(req, mig, matched, fresh)
                req._kv_migration = None
            self.cache.lengths[slot] = matched
            req.slot = slot
            req.status = "running"
            req.prefill_cursor = matched
            req.prefill_target = ctx
            req.prefix_hit_tokens = matched
            req._blocks_registered = matched // self.cache.block_size
            self.prefix_hit_tokens += matched
            self.prompt_tokens += len(req.prompt)
            self.n_admissions += 1
            self.running.append(req)
            admitted.append(req)
            if req.admitted_at is None and self.now_fn is not None:
                req.admitted_at = self.now_fn()
                self._emit(req, "admitted", prefix_hit=matched,
                           queue_wait=max(
                               0.0, req.admitted_at - req.arrival_time))
            else:
                self._emit(req, "admitted", prefix_hit=matched,
                           resumed=True)
        return admitted

    def _ingest_migrated_tail(self, req: Request, mig: dict,
                              matched: int, fresh: List[int]) -> int:
        """Admission half of KV migration: the full prompt blocks came
        through the store (``matched`` covers them) and the sub-block tail
        rides raw in ``mig``. When every full block matched, the tail is
        written into the request's first private block, where prefill
        would have put it, and the cursor starts past it. Any shortfall
        (partial match, no hook, the pricer preferring recompute) falls
        back to prefilling the rest, which is always correct."""
        ntok = int(mig.get("tail_ntok") or 0)
        leaves = mig.get("leaves")
        bsz = self.cache.block_size
        full = (len(req.prompt) // bsz) * bsz
        if ntok <= 0 or leaves is None or matched != full or not fresh:
            return matched
        pricer = self.cache.pricer
        if pricer is not None and not pricer.prefers_transfer(
                ntok, leaves_nbytes(leaves)):
            self.n_migration_declined += 1
            return matched
        if not self.cache.fill_raw(fresh[0], leaves):
            return matched
        self.n_migrated_tail_fills += 1
        return matched + ntok

    def schedule(self) -> Tuple[str, List[Request]]:
        """Decide this iteration: ``("prefill", batch)`` (each with
        ``prefill_chunk`` set), ``("decode", running)`` or ``("idle",
        [])``. Unchunked, prefill has priority; chunked, prefill and
        decode alternate whenever both kinds of work exist."""
        self._admit()
        prefilling = [r for r in self.running if r.prefilling()]
        decodable = ([r for r in self.running if not r.prefilling()]
                     if self.decode_enabled else [])
        if prefilling and decodable and self.prefill_chunk_tokens:
            do_prefill = not self._last_was_prefill
        else:
            do_prefill = bool(prefilling)
        if do_prefill:
            budget = self.prefill_chunk_tokens or float("inf")
            batch: List[Request] = []
            for r in prefilling[:self.max_prefill_rows]:
                if budget <= 0:
                    break
                n = int(min(r.prefill_target - r.prefill_cursor, budget))
                r.prefill_chunk = n
                budget -= n
                batch.append(r)
            self._last_was_prefill = True
            return "prefill", batch
        self._last_was_prefill = False
        if decodable:
            return "decode", decodable
        return "idle", []

    def ensure_decode_blocks(self) -> List[Request]:
        """Pre-decode block growth: a decodable request about to write at
        a block boundary gets one block, preempting from the back of the
        admission order when the pool is dry. Returns the requests that
        actually decode this iteration."""
        stepped: List[Request] = []
        for req in list(self.running):
            if req.status != "running":
                continue  # preempted as an earlier request's victim
            if req.prefilling():
                continue
            pos = req.cached_tokens()
            n_blocks = len(self.cache.slot_blocks(req.slot))
            if pos == n_blocks * self.cache.block_size:
                got = self._alloc_with_preemption(1, req)
                if got is None:
                    continue  # req itself was the last-resort victim
                self.cache.extend(req.slot, got)
            stepped.append(req)
        return stepped

    def ensure_spec_blocks(self, reqs: List[Request],
                           window_tokens) -> List[Request]:
        """Speculative-decode growth: each request about to verify a
        window gets blocks for ``cached_tokens() + window_tokens[rid]``
        before the step, so the window's K/V writes land inside its
        table. Same preemption backstop and return contract as
        ``ensure_decode_blocks``."""
        want = {r.rid for r in reqs}
        stepped: List[Request] = []
        for req in list(self.running):
            if req.status != "running" or req.rid not in want:
                continue  # preempted as an earlier request's victim
            if req.prefilling():
                continue
            need_tokens = req.cached_tokens() + window_tokens[req.rid]
            need = (self.cache.blocks_for(need_tokens)
                    - len(self.cache.slot_blocks(req.slot)))
            if need > 0:
                got = self._alloc_with_preemption(need, req)
                if got is None:
                    continue  # req itself was the last-resort victim
                self.cache.extend(req.slot, got)
            stepped.append(req)
        return stepped

    def shrink_spec_blocks(self, req: Request) -> int:
        """Post-verify rewind: keep exactly the blocks the accepted cache
        contents occupy; the next step grows just in time again."""
        keep = self.cache.blocks_for(max(1, req.cached_tokens()))
        return self.cache.shrink(req.slot, keep)

    def _alloc_with_preemption(self, n: int, requester: Request):
        while True:
            got = self.cache.alloc_blocks(n)
            if got is not None:
                return got
            victim = self.running[-1]
            self.preempt(victim)
            if victim is requester:
                return None

    # -- state transitions -------------------------------------------------

    def preempt(self, victim: Request) -> None:
        """Recompute-preemption: free everything, requeue at the FRONT."""
        self._vacate(victim)
        victim.status = "waiting"
        victim.prefill_cursor = 0
        victim.prefill_target = 0
        victim.prefill_chunk = 0
        victim.preemptions += 1
        self.n_preemptions += 1
        self.waiting.appendleft(victim)
        self._emit(victim, "preempted", n=victim.preemptions)

    def retire(self, req: Request, status: str = "finished") -> None:
        if status not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {status}")
        self._vacate(req)
        req.status = status
        self.terminal_counts[status] += 1
        self._emit(req, status, generated=len(req.generated))

    def cancel(self, rid: int, *, status: str = "cancelled"):
        """Retire request ``rid`` NOW with a terminal status, queued or in
        flight. Returns the request, or None if it is neither."""
        if status not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {status}")
        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                req.status = status
                self.terminal_counts[status] += 1
                self._emit(req, status, generated=len(req.generated))
                return req
        for req in self.running:
            if req.rid == rid:
                self.retire(req, status)
                req.prefill_cursor = 0
                req.prefill_target = 0
                req.prefill_chunk = 0
                return req
        return None

    def expire(self, now: float) -> List[Request]:
        """Retire every request strictly past its deadline as
        ``deadline_exceeded``; returns them."""
        expired: List[Request] = []
        for req in [r for r in self.waiting
                    if r.deadline is not None and now > r.deadline]:
            self.waiting.remove(req)
            req.status = "deadline_exceeded"
            self.terminal_counts["deadline_exceeded"] += 1
            self._emit(req, "deadline_exceeded",
                       generated=len(req.generated))
            expired.append(req)
        for req in [r for r in self.running
                    if r.deadline is not None and now > r.deadline]:
            self.retire(req, "deadline_exceeded")
            expired.append(req)
        return expired

    def _vacate(self, req: Request) -> None:
        self.cache.release(req.slot)
        self._free_slots.append(req.slot)
        self._free_slots.sort()
        req.slot = None
        self.running.remove(req)
