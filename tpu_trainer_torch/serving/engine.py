"""Serving engine (port of ``tpu_trainer/serving/engine.py``): eager
prefill/decode steps over the paged model path.

The engine owns a fixed slot batch (``max_batch`` rows). Every iteration
the scheduler picks ONE of:

- **prefill** — requests mid-prefill feed ``seq[cursor:cursor+chunk]``
  (width bucketed to a power of two) at their global offset; chunks past
  offset 0 also attend the pooled history through a ``hist_blocks``-wide
  table gather. Feeding generated tokens too on re-admission makes
  recompute-preemption exact.
- **decode** — every running request that finished prefill advances one
  token in a single ``[slots, 1]`` forward, whose attention is the CUDA
  flash-decode kernel on the card. With ``spec`` set, a decode iteration
  is a speculative one instead (``serving/spec.py``): proposer drafts,
  one verify forward of the ``[slots, W]`` window through the
  chunked-prefill branch, the accepted prefix plus one target token.

Each step copies the scheduler's host tables / lengths / offsets into the
device cache, runs the model under ``torch.inference_mode()``, samples
(``serving/sampling.py``), and reads the tokens back — the one host sync
of the step. Idle and non-stepped rows carry table 0 and length 0: their
writes land in the null block and their sampled tokens are ignored.

``kv_store`` (or ``kv_store_bytes`` / ``kv_store_dir``) puts a
``serving/kv_store.py`` block store behind the prefix index: published
prompt blocks are written through to it, evicted ones spill into it, and
a cold engine sharing it fills device blocks from it instead of
prefilling. ``read_block`` / ``write_block`` are the block I/O, in the
JAX engine's leaf order. ``role="prefill"`` stops requests after their
first token; ``extract_request`` hands one to another engine sharing the
store (full blocks by digest, the tail raw in ``_kv_migration``).

The fleet surface (``serving/frontend.py``, ``serving/worker.py``):
``registry`` mirrors the cumulative stats as counters and gauges
(``set_function``, read at scrape time; the metric names are the JAX
engine's) and observes the step, TTFT and TPOT histograms;
``export_requests`` hands every queued and in-flight request back for
failover; ``device_block_budget`` sizes the pool per shard.

``mesh_tensor`` / ``mesh_devices`` make the replica tensor-parallel
(``serving/sharding.py``): its parameters and KV pools are held as
``tp`` shards, shard ``i`` on ``cuda:<mesh_devices[i]>`` (a repeated
ordinal puts several on one card; on the CPU the ids are labels). Each
step gathers the parameters on shard 0's device (an exact concatenation)
and runs the module over them; decode attention runs one flash-decode
call a shard. Greedy streams are one device's, bit for bit, and
``read_block`` / ``write_block`` assemble and split the kv heads in
shard order, so the store and migration frames are one device's too.

``python -m tpu_trainer_torch.serving.engine`` replays a seeded open-loop
Poisson trace against a synthetic checkpoint and prints the summary. It
runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT, init_paged_cache
from tpu_trainer_torch.models.weights import build_model, meta_model
from tpu_trainer_torch.obs.metrics import NULL_REGISTRY
from tpu_trainer_torch.serving.kv_store import KVBlockStore, MigrationPricer
from tpu_trainer_torch.serving.paged_cache import PagedKVCache
from tpu_trainer_torch.serving.sampling import sample_tokens
from tpu_trainer_torch.serving import sharding as tp_lib
from tpu_trainer_torch.serving.scheduler import Request, SamplingParams, Scheduler
from tpu_trainer_torch.serving.spec import (DraftModelProposer, NGramProposer,
                                            SpecDecoder, _verify_step,
                                            draft_from_target)
from tpu_trainer_torch.serving.tracing import ServingLedger, SpanTracer
from tpu_trainer_torch.utils.device import resolve_device


def _bucket_pow2(n: int, lo: int = 8) -> int:
    w = lo
    while w < n:
        w *= 2
    return w


# The device cache's block payload, in the JAX cache pytree's flatten
# order (int8 pools add the scale planes).
_POOL_LEAF_KEYS = ("pool_k", "pool_v", "scale_k", "scale_v")
# A bf16 pool leaf on the host: its raw 2-byte words (numpy has no bf16).
_BF16_HOST = np.dtype("V2")


class ServingEngine:
    """Continuous-batching engine over one model + parameter set.

    ``params`` is a state dict for ``GPT(config)`` (``models.weights``).
    ``device`` defaults to CUDA and raises without it; ``device="cpu"``
    runs the plain attention path on the CPU. Under ``mesh_tensor`` /
    ``mesh_devices`` the device is the mesh's first (its type taken from
    ``device``).
    """

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        config: GPTConfig,
        *,
        max_batch: int = 8,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_blocks_per_request: Optional[int] = None,
        kv_int8: bool = False,
        attention: str = "auto",
        eos_id: Optional[int] = None,
        watermark_blocks: int = 0,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache: bool = False,
        spec: str = "off",
        spec_k: int = 4,
        spec_adaptive: bool = True,
        spec_ngram_max: int = 3,
        draft_params=None,
        draft_config: Optional[GPTConfig] = None,
        spec_proposer=None,
        clock=time.perf_counter,
        trace: bool = True,
        ts_interval: int = 32,
        registry=None,
        mesh_tensor: Optional[int] = None,
        mesh_devices: Optional[Sequence[int]] = None,
        device_block_budget: Optional[int] = None,
        kv_store: Optional[KVBlockStore] = None,
        kv_store_bytes: Optional[int] = None,
        kv_store_dir: Optional[str] = None,
        kv_link_gbps: float = 16.0,
        role: Optional[str] = None,
        device=None,
    ):
        if spec not in ("off", "ngram", "draft"):
            raise ValueError(f"spec={spec!r} (off | ngram | draft)")
        self.device = resolve_device(device)
        if attention == "reference" and self.device.type == "cuda":
            raise ValueError(
                "attention='reference' is the CPU path; on CUDA decode "
                "attention always runs the flash-decode kernel")
        if max_blocks_per_request is None:
            max_blocks_per_request = -(-config.max_seq_len // block_size)
        # Tensor parallel: one replica = one mesh (serving/sharding.py).
        # ``mesh_tensor`` is the mesh size; ``mesh_devices`` optionally
        # names its CUDA ordinals; ``device_block_budget`` sizes the pool
        # per SHARD: with kv-head-sharded pools each shard holds 1/tp of
        # every block, so the replica affords budget * tp blocks.
        tp = int(mesh_tensor) if mesh_tensor else 1
        if mesh_devices is not None:
            mesh_devices = tuple(int(d) for d in mesh_devices)
            if tp == 1 and len(mesh_devices) > 1:
                tp = len(mesh_devices)
        if device_block_budget is not None and num_blocks is None:
            num_blocks = device_block_budget * tp_lib.shard_factor(
                config.kv_heads, tp)
        if num_blocks is None:
            # Enough for every slot to run at full context, + null block.
            num_blocks = max_batch * max_blocks_per_request + 1
        self.config = dataclasses.replace(
            config,
            dropout=0.0,
            attention_dropout=0.0,
            decode_paged=True,
            decode_ragged=False,
            paged_block_size=block_size,
            paged_num_blocks=num_blocks,
            paged_max_blocks=max_blocks_per_request,
            paged_kv_int8=kv_int8,
            paged_attention=attention,
            paged_tp=tp,
            paged_tp_devices=(mesh_devices if tp > 1 else None),
        )
        self.mesh = None
        if tp > 1:
            self.mesh = tp_lib.tp_mesh(tp, self.config.paged_tp_devices,
                                       self.device.type)
            self.device = self.mesh.compute_device
            self.model = _ShardedModel(self.config, params, self.mesh)
        else:
            self.model = build_model(self.config, params, self.device)
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.clock = clock
        self.prefix_cache = prefix_cache
        # Engines in one process share ONE store object through
        # ``kv_store``; the scalar kwargs build a private one.
        self._owns_store = kv_store is None
        if kv_store is None and (kv_store_bytes or kv_store_dir):
            kv_store = KVBlockStore(
                host_bytes=int(kv_store_bytes) if kv_store_bytes
                else 64 << 20,
                disk_dir=kv_store_dir)
        self.kv_store = kv_store
        self.cache_state = PagedKVCache(
            self.config, max_batch, prefix_cache=prefix_cache,
            kv_store=kv_store)
        if kv_store is not None:
            self.cache_state.spill_fn = self._store_put_block
            self.cache_state.fill_fn = self._store_fill_block
            self.cache_state.raw_fill_fn = self.write_block
            self.cache_state.pricer = self._build_pricer(kv_link_gbps)
        # Speculative decoding: the proposer before the scheduler, so
        # admission budgets the draft window.
        proposer = spec_proposer
        if proposer is None and spec == "ngram":
            proposer = NGramProposer(max_ngram=spec_ngram_max)
        elif proposer is None and spec == "draft":
            if draft_params is None or draft_config is None:
                raise ValueError(
                    "spec='draft' needs draft_params and draft_config "
                    "(see spec.draft_from_target)")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("draft/target vocab mismatch")
            if draft_config.max_seq_len < config.max_seq_len:
                raise ValueError("draft max_seq_len < target max_seq_len")
            proposer = DraftModelProposer(
                draft_params, draft_config, slots=max_batch,
                block_size=block_size, attention=attention,
                device=self.device)
        self.spec_decoder = (
            SpecDecoder(proposer, k=spec_k, adaptive=spec_adaptive)
            if proposer is not None else None)
        self.scheduler = Scheduler(
            self.cache_state, watermark_blocks=watermark_blocks,
            prefill_chunk_tokens=prefill_chunk_tokens,
            spec_reserve_tokens=(
                spec_k + 1 if self.spec_decoder is not None else 0))
        self.role: Optional[str] = None
        if role is not None:
            self.set_role(role)
        # Host-side observability; never touches the device path.
        self.tracer = SpanTracer(enabled=trace)
        self.scheduler.tracer = self.tracer
        self.scheduler.now_fn = self._now
        self.ledger = ServingLedger()
        self.ts_interval = int(ts_interval)
        self.serve_ts: List[dict] = []
        self.device_cache = init_paged_cache(
            self.config, max_batch, device=self.device, mesh=self.mesh)
        self._k_cap = 1
        self._iters = 0
        self._t0 = None
        self.wall_elapsed = 0.0
        self._deadline_margins: List[float] = []
        self.stats: Dict[str, float] = {
            "prefill_iters": 0, "decode_iters": 0, "idle_iters": 0,
            "prefill_tokens": 0, "prefill_chunks": 0,
            "generated_tokens": 0,
            "occupancy_sum": 0.0, "occupancy_samples": 0,
            "occupancy_max": 0.0,
            "spec_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
            "finished": 0, "cancelled": 0, "deadline_exceeded": 0,
            "failed": 0,
        }
        # The live metrics plane (obs/): counters and gauges mirror the
        # stats above through set_function, so a scrape equals summary()
        # and costs the hot path nothing; only the latency histograms
        # observe inline, no-op calls on the null registry.
        self.registry = registry if registry is not None else NULL_REGISTRY
        self._metrics_on = registry is not None
        self._install_metrics()

    def _install_metrics(self) -> None:
        reg = self.registry
        self._m_step_seconds = reg.histogram(
            "serve_step_seconds", "Engine step wall-clock latency")
        self._m_ttft = reg.histogram(
            "serve_ttft_seconds", "Time to first token (engine clock)")
        self._m_tpot = reg.histogram(
            "serve_tpot_seconds", "Inter-token gap (engine clock)")
        req_total = reg.counter(
            "serve_requests_total", "Terminal requests by state",
            labelnames=("state",))
        for state in self.scheduler.terminal_counts:
            req_total.labels(state=state).set_function(
                lambda s=state: self.scheduler.terminal_counts[s])
        reg.counter("serve_admissions_total", "Admission events "
                    "(re-admission after preemption/failover counts)"
                    ).set_function(lambda: self.scheduler.n_admissions)
        reg.counter("serve_preemptions_total", "Recompute preemptions"
                    ).set_function(lambda: self.scheduler.n_preemptions)
        reg.counter("serve_generated_tokens_total", "Tokens emitted"
                    ).set_function(lambda: self.stats["generated_tokens"])
        reg.counter("serve_prefill_tokens_total", "Prompt tokens prefilled"
                    ).set_function(lambda: self.stats["prefill_tokens"])
        reg.counter("serve_prompt_tokens_total", "Prompt tokens admitted"
                    ).set_function(lambda: self.scheduler.prompt_tokens)
        reg.counter("serve_prefix_hit_tokens_total",
                    "Prompt tokens served from the prefix index"
                    ).set_function(lambda: self.scheduler.prefix_hit_tokens)
        reg.counter("serve_prefix_evictions_total", "Prefix-index evictions"
                    ).set_function(
                        lambda: self.cache_state.n_prefix_evictions)
        pool = reg.gauge("serve_pool_blocks",
                         "Paged-pool fragmentation split",
                         labelnames=("kind",))
        pool.labels(kind="free").set_function(
            lambda: self.cache_state.pool.free_blocks)
        pool.labels(kind="evictable").set_function(
            lambda: self.cache_state.evictable_blocks)
        pool.labels(kind="referenced").set_function(
            lambda: self.cache_state.referenced_blocks)
        reg.gauge("serve_pool_occupancy", "Paged-pool occupancy fraction"
                  ).set_function(lambda: self.cache_state.pool.occupancy)
        reg.gauge("serve_prefix_index_entries", "Prefix-index size"
                  ).set_function(
                      lambda: self.cache_state.prefix_index_entries)
        reg.gauge("serve_queue_depth", "Requests waiting for admission"
                  ).set_function(lambda: self.queue_depth)
        reg.gauge("serve_running", "Requests in flight"
                  ).set_function(lambda: len(self.scheduler.running))
        reg.gauge("serve_outstanding_tokens", "Token-steps of work owed"
                  ).set_function(lambda: self.outstanding_tokens)
        if self.kv_store is not None:
            store, cs = self.kv_store, self.cache_state
            kvb = reg.gauge("kv_store_bytes",
                            "Fleet KV store payload bytes by tier",
                            labelnames=("tier",))
            kvb.labels(tier="host").set_function(
                lambda: store.host_bytes_used)
            kvb.labels(tier="disk").set_function(
                lambda: store.disk_bytes_used)
            kvh = reg.counter("kv_store_hits_total",
                              "Store block hits by serving tier",
                              labelnames=("tier",))
            kvh.labels(tier="host").set_function(
                lambda: store.counters["hits_host"])
            kvh.labels(tier="disk").set_function(
                lambda: store.counters["hits_disk"])
            kvt = reg.counter("kv_store_hit_tokens_total",
                              "Prompt tokens admitted from the store",
                              labelnames=("tier",))
            kvt.labels(tier="host").set_function(
                lambda: cs.store_hit_tokens_host)
            kvt.labels(tier="disk").set_function(
                lambda: cs.store_hit_tokens_disk)
            kve = reg.counter("kv_store_evictions_total",
                              "Store entries evicted by tier",
                              labelnames=("tier",))
            kve.labels(tier="host").set_function(
                lambda: store.counters["evictions_host"])
            kve.labels(tier="disk").set_function(
                lambda: store.counters["evictions_disk"])
            reg.counter("kv_store_puts_total",
                        "Blocks published into the store"
                        ).set_function(lambda: store.counters["puts"])
            reg.counter("kv_store_spills_total",
                        "Evicted device blocks demoted into the store"
                        ).set_function(lambda: cs.n_store_spills)
            reg.counter("kv_store_migrated_tails_total",
                        "Migrated raw tail blocks admitted"
                        ).set_function(
                            lambda: self.scheduler.n_migrated_tail_fills)
        if self.spec_decoder is not None:
            reg.counter("serve_spec_drafted_total", "Draft tokens proposed"
                        ).set_function(lambda: self.stats["spec_drafted"])
            reg.counter("serve_spec_accepted_total", "Draft tokens accepted"
                        ).set_function(lambda: self.stats["spec_accepted"])
            reg.gauge("serve_spec_accept_rate",
                      "Accepted / drafted (cumulative)").set_function(
                          lambda: self.stats["spec_accepted"]
                          / max(1, int(self.stats["spec_drafted"])))

    def reset_stats(self) -> None:
        """Zero counters and clock between a warm-up and a timed run. The
        engine must be drained; stale pool contents are masked by length."""
        if self.scheduler.has_work():
            raise RuntimeError("reset_stats on a busy engine")
        self._iters = 0
        self._t0 = None
        sch = self.scheduler
        sch.n_preemptions = sch.n_admissions = 0
        sch.prefix_hit_tokens = sch.prompt_tokens = 0
        for k in sch.terminal_counts:
            sch.terminal_counts[k] = 0
        self.cache_state.n_prefix_evictions = 0
        cs = self.cache_state
        cs.n_store_spills = cs.n_store_declined = 0
        cs.store_hit_tokens_host = cs.store_hit_tokens_disk = 0
        sch.n_migrated_tail_fills = sch.n_migration_declined = 0
        if self.kv_store is not None and self._owns_store:
            # A shared store keeps its counters; a private one resets.
            self.kv_store.reset_stats()
        if self.spec_decoder is not None:
            self.spec_decoder.reset_stats()
        self.wall_elapsed = 0.0
        self._deadline_margins = []
        self.tracer.reset()
        self.ledger.reset()
        self.serve_ts = []
        for k in self.stats:
            self.stats[k] = 0.0 if isinstance(self.stats[k], float) else 0

    # -- one engine iteration ----------------------------------------------

    def step(self) -> List[Request]:
        """Run one scheduler iteration. Returns the requests that reached a
        terminal state this iteration (finished, or retired by the
        deadline sweep)."""
        if not self._metrics_on:
            return self._step_impl()
        t0 = time.perf_counter()
        try:
            return self._step_impl()
        finally:
            self._m_step_seconds.observe(time.perf_counter() - t0)

    def _step_impl(self) -> List[Request]:
        self._iters += 1
        with self.ledger.track("host_sched"):
            terminal = self._expire_deadlines()
            kind, reqs = self.scheduler.schedule()
        if kind == "idle":
            self.stats["idle_iters"] += 1
            return terminal
        if kind == "prefill":
            terminal += self._forward(reqs, prefill=True)
            self.stats["prefill_iters"] += 1
        elif self.spec_decoder is not None:
            terminal += self._spec_decode()
            self.stats["decode_iters"] += 1
        else:
            reqs = self.scheduler.ensure_decode_blocks()
            if not reqs:          # everything preempted itself back out
                return terminal
            terminal += self._forward(reqs, prefill=False)
            self.stats["decode_iters"] += 1
        occ = self.cache_state.pool.occupancy
        self.stats["occupancy_sum"] += occ
        self.stats["occupancy_samples"] += 1
        self.stats["occupancy_max"] = max(self.stats["occupancy_max"], occ)
        return terminal

    def _expire_deadlines(self) -> List[Request]:
        s = self.scheduler
        if (all(r.deadline is None for r in s.waiting)
                and all(r.deadline is None for r in s.running)):
            return []
        now = self._now()
        expired = s.expire(now)
        for r in expired:
            r.finished_at = now
            if self.spec_decoder is not None:
                self.spec_decoder.forget(r)
            self.stats["deadline_exceeded"] += 1
            self._observe_deadline(r, now)
        return expired

    def _observe_deadline(self, r: Request, now: float) -> None:
        if r.deadline is not None:
            self._deadline_margins.append(now - r.deadline)

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request now (slot and blocks back
        in the pool before this returns). False if ``rid`` is unknown."""
        req = self.scheduler.cancel(rid)
        if req is None:
            return False
        req.finished_at = self._now()
        if self.spec_decoder is not None:
            self.spec_decoder.forget(req)
        self.stats["cancelled"] += 1
        return True

    def _forward(self, reqs: List[Request], *, prefill: bool) -> List[Request]:
        slots = self.max_batch
        cs = self.cache_state
        # Only the stepped rows carry real tables; the others are nulled
        # so this pass cannot touch their blocks.
        tables = np.zeros_like(cs.tables)
        lengths = np.zeros((slots,), np.int32)
        offsets = np.zeros((slots,), np.int32)
        hist_blocks = 0
        if prefill:
            width = _bucket_pow2(max(r.prefill_chunk for r in reqs))
            width = min(width, cs.capacity_tokens())
            ids = np.zeros((slots, width), np.int64)
            max_cursor = 0
            for r in reqs:
                seq = r.prompt + r.generated
                cur, n = r.prefill_cursor, r.prefill_chunk
                ids[r.slot, :n] = seq[cur:cur + n]
                tables[r.slot] = cs.tables[r.slot]
                lengths[r.slot] = cur + n
                offsets[r.slot] = cur
                max_cursor = max(max_cursor, cur)
                self.stats["prefill_tokens"] += n
                self.stats["prefill_chunks"] += 1
            if max_cursor > 0:
                hist_blocks = min(
                    _bucket_pow2(cs.blocks_for(max_cursor), lo=1),
                    cs.max_blocks)
        else:
            ids = np.zeros((slots, 1), np.int64)
            for r in reqs:
                ids[r.slot, 0] = (r.prompt + r.generated)[-1]
                tables[r.slot] = cs.tables[r.slot]
                lengths[r.slot] = r.cached_tokens()
        temps = np.zeros((slots,), np.float32)
        topks = np.zeros((slots,), np.int64)
        topps = np.ones((slots,), np.float32)
        keys = [0] * slots
        steps = [0] * slots
        for r in reqs:
            temps[r.slot] = r.sampling.temperature
            topks[r.slot] = r.sampling.top_k
            topps[r.slot] = r.sampling.top_p
            keys[r.slot] = r.key()
            steps[r.slot] = len(r.generated)   # index of the draw made now
            if r.sampling.top_k > self._k_cap:
                self._k_cap = r.sampling.top_k

        with self.ledger.track("dispatch"):
            tokens = _engine_step(
                self.model, self.device_cache, tables, lengths, offsets, ids,
                temps, topks, topps, keys, steps, k_cap=self._k_cap,
                prefill=prefill, hist_blocks=hist_blocks)
            tokens = tokens.cpu().numpy()   # host read = dispatch sync

        now = self._now()
        finished: List[Request] = []
        for r in reqs:
            if prefill:
                r.prefill_cursor += r.prefill_chunk
                cs.lengths[r.slot] = r.prefill_cursor
                self.tracer.emit(r.rid, "prefill_chunk", now,
                                 tokens=r.prefill_chunk,
                                 cursor=r.prefill_cursor)
                if self.prefix_cache:
                    self._register_prefix_blocks(r)
                if r.prefilling():
                    # Mid-prefill chunk: the draw is discarded; the final
                    # chunk redraws at the same (seed, token index).
                    continue
            tok = int(tokens[r.slot])
            if r.token_times:
                self._m_tpot.observe(max(0.0, now - r.token_times[-1]))
            r.generated.append(tok)
            r.token_times.append(now)
            self.stats["generated_tokens"] += 1
            # Cache now holds everything fed this pass (not the new token).
            cs.lengths[r.slot] = r.context_len() - 1
            if r.first_token_at is None:
                r.first_token_at = now
                self._m_ttft.observe(max(0.0, now - r.arrival_time))
                self.tracer.emit(r.rid, "first_token", now)
            if (r.eos_id is not None and tok == r.eos_id) or (
                    len(r.generated) >= r.max_new_tokens):
                r.finished_at = now
                self.scheduler.retire(r)
                self.stats["finished"] += 1
                self._observe_deadline(r, now)
                finished.append(r)
        return finished

    def _spec_decode(self) -> List[Request]:
        """One speculative decode iteration: propose per-request drafts,
        grow blocks for each window, verify all positions in ONE target
        forward (the chunked-prefill branch at each row's cached offset),
        then emit the accepted prefix plus the target's correction or
        bonus token and rewind: host lengths roll back to the accept
        point and trailing blocks return to the pool the same iteration.
        Greedy rows emit the target's argmax chain, so their streams are
        the plain decode's."""
        sd = self.spec_decoder
        cs = self.cache_state
        reqs = [r for r in self.scheduler.running
                if r.status == "running" and not r.prefilling()]
        if not reqs:
            return []
        drafts = sd.propose(reqs)
        window = {r.rid: len(drafts.get(r.rid, [])) + 1 for r in reqs}
        if all(n == 1 for n in window.values()):
            # Nothing drafted anywhere: a plain single-token decode.
            reqs = self.scheduler.ensure_decode_blocks()
            if not reqs:
                return []
            return self._forward(reqs, prefill=False)
        reqs = self.scheduler.ensure_spec_blocks(reqs, window)
        if not reqs:              # everything preempted itself back out
            return []
        max_m = max(window[r.rid] - 1 for r in reqs)
        if max_m == 0:            # the drafted rows were all preempted
            return self._forward(reqs, prefill=False)

        slots = self.max_batch
        width = min(_bucket_pow2(max_m + 1, lo=2), cs.capacity_tokens())
        tables = np.zeros_like(cs.tables)
        lengths = np.zeros((slots,), np.int32)
        offsets = np.zeros((slots,), np.int32)
        ids = np.zeros((slots, width), np.int64)
        dlens = np.zeros((slots,), np.int64)
        temps = np.zeros((slots,), np.float32)
        topks = np.zeros((slots,), np.int64)
        topps = np.ones((slots,), np.float32)
        keys = [0] * slots
        steps = [0] * slots
        max_off = 0
        for r in reqs:
            d = drafts.get(r.rid, [])
            cached = r.cached_tokens()
            ids[r.slot, 0] = (r.prompt + r.generated)[-1]
            ids[r.slot, 1:1 + len(d)] = d
            tables[r.slot] = cs.tables[r.slot]
            offsets[r.slot] = cached
            lengths[r.slot] = cached + len(d) + 1
            dlens[r.slot] = len(d)
            temps[r.slot] = r.sampling.temperature
            topks[r.slot] = r.sampling.top_k
            topps[r.slot] = r.sampling.top_p
            keys[r.slot] = r.key()
            steps[r.slot] = len(r.generated)
            max_off = max(max_off, cached)
            if r.sampling.top_k > self._k_cap:
                self._k_cap = r.sampling.top_k
        # The window rides the chunked-prefill branch: the cached context
        # is the pooled history (cached >= 1 always in decode).
        hist_blocks = min(
            _bucket_pow2(cs.blocks_for(max_off), lo=1), cs.max_blocks)

        with self.ledger.track("dispatch"):
            emitted, n_acc = _verify_step(
                self.model, self.device_cache, tables, lengths, offsets, ids,
                dlens, temps, topks, topps, keys, steps, k_cap=self._k_cap,
                hist_blocks=hist_blocks)
            emitted = emitted.cpu().numpy()   # host read = dispatch sync
            n_acc = n_acc.cpu().numpy()

        now = self._now()
        finished: List[Request] = []
        for r in reqs:
            m = int(dlens[r.slot])
            j = int(n_acc[r.slot])
            sd.observe(r, m, j)
            if m > 0:
                self.tracer.emit(r.rid, "spec_window", now, k=m, accepted=j)
            self.stats["spec_steps"] += 1
            self.stats["spec_drafted"] += m
            self.stats["spec_accepted"] += j
            done = False
            for tok in emitted[r.slot, :j + 1]:
                tok = int(tok)
                r.generated.append(tok)
                if r.token_times:
                    self._m_tpot.observe(max(0.0, now - r.token_times[-1]))
                r.token_times.append(now)
                self.stats["generated_tokens"] += 1
                if r.first_token_at is None:
                    r.first_token_at = now
                    self._m_ttft.observe(max(0.0, now - r.arrival_time))
                    self.tracer.emit(r.rid, "first_token", now)
                if (r.eos_id is not None and tok == r.eos_id) or (
                        len(r.generated) >= r.max_new_tokens):
                    done = True
                    break     # tokens past EOS are never emitted
            # Host rewind: the cache holds everything up to the accept
            # point (writes past it are masked garbage the shrink frees).
            cs.lengths[r.slot] = r.context_len() - 1
            if done:
                r.finished_at = now
                sd.forget(r)
                self.scheduler.retire(r)
                self.stats["finished"] += 1
                self._observe_deadline(r, now)
                finished.append(r)
            else:
                self.scheduler.shrink_spec_blocks(r)
        return finished

    def _register_prefix_blocks(self, r: Request) -> None:
        """Publish the request's newly completed full PROMPT blocks in the
        prefix index (a no-op on an existing digest), and write them
        through to the store."""
        cs = self.cache_state
        done = min(r.prefill_cursor, len(r.prompt)) // cs.block_size
        if done <= r._blocks_registered:
            return
        if r._prompt_digests is None:
            r._prompt_digests = cs.block_digests(r.prompt)
        blocks = cs.slot_blocks(r.slot)
        for i in range(r._blocks_registered, done):
            cs.prefix_register(r._prompt_digests[i], blocks[i])
            if self.kv_store is not None:
                self._store_put_block(r._prompt_digests[i], blocks[i])
        r._blocks_registered = done

    # -- the KV store: device block I/O and migration ----------------------

    def _build_pricer(self, link_gbps: float) -> MigrationPricer:
        from tpu_trainer_torch.utils.logging import (flops_per_token,
                                                     peak_flops_for_name)

        peak = 1e12
        if self.device.type == "cuda":
            try:
                peak = peak_flops_for_name(
                    torch.cuda.get_device_name(self.device))
            except ValueError:
                pass
        # flops_per_token counts fwd + bwd; a recompute is one forward.
        return MigrationPricer(
            flops_per_token=flops_per_token(self.config) / 3.0,
            device_flops=peak, link_bytes_per_s=float(link_gbps) * 1e9)

    def _pool_leaves(self) -> List[torch.Tensor]:
        """Every pool tensor of the device cache: the leaves at tp 1, each
        shard's in shard order at tp > 1."""
        return [t for parts, _ in self._pool_parts() for t in parts]

    def _pool_parts(self) -> List[Tuple[List[torch.Tensor], bool]]:
        """Each pool leaf in the JAX engine's order as ``(parts,
        replicated)``: its tensors in shard order (one at tp 1), and
        whether every part holds the whole leaf (GQA-replicated pools) —
        otherwise the parts cut its kv-heads axis."""
        cache = self.device_cache
        if "shards" not in cache:
            return [([cache[k]], True) for k in _POOL_LEAF_KEYS
                    if k in cache]
        shards = cache["shards"]
        rep = not tp_lib.kv_sharded(self.config.kv_heads,
                                    self.config.paged_tp)
        return [([sh[k] for sh in shards], rep) for k in _POOL_LEAF_KEYS
                if k in shards[0]]

    def read_block(self, block_id: int) -> List[np.ndarray]:
        """One block's K/V payload as host arrays, one per pool leaf in
        the JAX engine's order (``pool_k, pool_v[, scale_k, scale_v]``),
        each ``[L, bsz, kvh, d | nbq]`` — the store and wire entry. A
        bf16 leaf comes back as its raw 2-byte words (void ``V2``). A
        sharded replica's kv heads are assembled in shard order (a
        replicated pool read from shard 0), so its payload is one
        device's."""
        out = []
        for parts, rep in self._pool_parts():
            # A copy on either device: on the CPU ``.cpu()`` would alias
            # the pool, and the block's next tenant would rewrite a store
            # entry or a migration tail still in flight.
            if rep:
                blk = parts[0][:, block_id].to("cpu", copy=True)
            else:
                blk = torch.cat([p[:, block_id].cpu() for p in parts], dim=2)
            if blk.dtype == torch.bfloat16:
                out.append(blk.view(torch.int16).numpy().view(_BF16_HOST))
            else:
                out.append(blk.numpy())
        return out

    def write_block(self, block_id: int, payload: List[np.ndarray]) -> bool:
        """Write a store or migration entry into device block
        ``block_id``. False, the device untouched, on any layout
        mismatch: a store shared by differently configured engines falls
        back to recompute instead of corrupting a pool."""
        leaves = self._pool_parts()
        if len(payload) != len(leaves):
            return False
        for (parts, rep), arr in zip(leaves, payload):
            leaf = parts[0]
            kvh = leaf.shape[3] * (1 if rep else len(parts))
            want = (_BF16_HOST if leaf.dtype == torch.bfloat16 else
                    np.dtype(str(leaf.dtype).replace("torch.", "")))
            if (tuple(arr.shape) != (leaf.shape[0], leaf.shape[2], kvh,
                                     leaf.shape[4])
                    or np.dtype(arr.dtype) != want):
                return False
        for (parts, rep), arr in zip(leaves, payload):
            arr = np.ascontiguousarray(arr)
            if parts[0].dtype == torch.bfloat16:
                src = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                src = torch.from_numpy(arr)
            # A replicated pool takes the whole block on every shard.
            pieces = ([src] * len(parts) if rep
                      else src.chunk(len(parts), dim=2))
            for part, piece in zip(parts, pieces):
                part[:, block_id].copy_(piece)
        return True

    def _store_put_block(self, digest: bytes, block_id: int) -> bool:
        """Publish one device block into the store (idempotent per
        digest). Doubles as the cache's eviction spill hook."""
        if self.kv_store is None or self.kv_store.has(digest):
            return False
        return self.kv_store.put(digest, self.read_block(block_id))

    def _store_fill_block(self, digest: bytes, block_id: int):
        """The cache's store fall-through hook: fetch ``digest`` into
        device block ``block_id``. The serving tier ("host" / "disk"),
        or None on a miss or a layout mismatch."""
        got = self.kv_store.get(digest)
        if got is None:
            return None
        tier, payload = got
        return tier if self.write_block(block_id, payload) else None

    def set_role(self, role: Optional[str]) -> None:
        """``"prefill"`` disables decode scheduling: requests run to the
        end of prefill (sampling their first token) and then wait to be
        extracted. ``"decode"`` or None is a full engine."""
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"role={role!r} (prefill | decode | None)")
        self.role = role
        self.scheduler.decode_enabled = role != "prefill"

    def migratable_rids(self) -> List[int]:
        """Requests carried as far as a prefill engine carries them:
        prefill complete and the first token sampled."""
        return [r.rid for r in self.scheduler.running
                if r.status == "running" and not r.prefilling()
                and r.generated]

    def extract_request(self, rid: int):
        """Migration harvest and handoff: publish the request's full
        prompt blocks to the store (digest-addressed), read its sub-block
        tail raw, then take it out of the scheduler in fresh-waiting
        state. Returns ``(request, payload)`` with payload ``{"tail_ntok",
        "leaves"}``, or None if ``rid`` is not migratable. Set
        ``request._kv_migration = payload`` and add it to an engine that
        shares the store: it matches the full blocks through the store,
        writes the tail raw and resumes sampling at the same (seed, token
        index) — the stream of never moving."""
        req = next((r for r in self.scheduler.running if r.rid == rid), None)
        if req is None or req.prefilling() or not req.generated:
            return None
        cs = self.cache_state
        payload = {"tail_ntok": 0, "leaves": None}
        if self.kv_store is not None:
            if req._prompt_digests is None:
                req._prompt_digests = cs.block_digests(req.prompt)
            blocks = cs.slot_blocks(req.slot)
            full = len(req.prompt) // cs.block_size
            for i in range(min(full, len(blocks))):
                self._store_put_block(req._prompt_digests[i], blocks[i])
            tail = len(req.prompt) - full * cs.block_size
            if tail and full < len(blocks):
                payload = {"tail_ntok": tail,
                           "leaves": self.read_block(blocks[full])}
        if self.spec_decoder is not None:
            self.spec_decoder.forget(req)
        self.scheduler.extract(req)
        return req, payload

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    # -- load signals ------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def outstanding_tokens(self) -> int:
        return self.scheduler.outstanding_tokens

    def oldest_wait_age(self, now: Optional[float] = None) -> float:
        arr = self.scheduler.oldest_waiting_arrival
        if arr is None:
            return 0.0
        return max(0.0, (self._now() if now is None else now) - arr)

    def export_requests(self, *, waiting_only: bool = False
                        ) -> List[Request]:
        """Drain this engine's requeueable requests
        (``Scheduler.export_requests``): the failover and shrink path of
        the front-end."""
        return self.scheduler.export_requests(waiting_only=waiting_only)

    # -- trace replay ------------------------------------------------------

    def run(self, requests: Sequence[Request], *, time_mode: str = "wall",
            max_iters: int = 10_000_000) -> List[Request]:
        """Replay an open-loop trace: each request joins the queue when the
        clock passes its ``arrival_time`` (seconds in ``"wall"`` mode,
        engine iterations in the deterministic ``"steps"`` mode). Returns
        the finished requests in input order. Every ``ts_interval``
        iterations a ``kind: "serve_ts"`` sample goes to ``serve_ts``."""
        if time_mode not in ("wall", "steps"):
            raise ValueError(f"time_mode={time_mode!r}")
        pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        self._t0 = self.clock()
        t_start = self._t0
        done: List[Request] = []
        while pending or self.scheduler.has_work():
            now = float(self._iters) if time_mode == "steps" else self._now()
            while pending and pending[0].arrival_time <= now:
                self.scheduler.add(pending.pop(0))
            if not self.scheduler.has_work():
                with self.ledger.track("idle"):
                    if time_mode == "wall":
                        time.sleep(min(
                            1e-3, max(0.0, pending[0].arrival_time - now)))
                    else:
                        self._iters += 1  # idle tick advances the clock
                continue
            done.extend(self.step())
            if self.ts_interval and self._iters % self.ts_interval == 0:
                self._emit_ts()
            if self._iters >= max_iters:
                raise RuntimeError(f"engine did not drain in {max_iters} iters")
        self.wall_elapsed = self.clock() - t_start
        self._emit_ts(final=True)
        by_rid = {r.rid: r for r in done if r.status == "finished"}
        return [by_rid[r.rid] for r in requests if r.rid in by_rid]

    def _emit_ts(self, final: bool = False) -> dict:
        s = self.stats
        gauges = {
            "t": round(self._now(), 6),
            "iter": int(self._iters),
            "queue_depth": self.queue_depth,
            "running": len(self.scheduler.running),
            "outstanding_tokens": self.outstanding_tokens,
            "occupancy": round(float(self.cache_state.pool.occupancy), 4),
            "generated_tokens": int(s["generated_tokens"]),
            "prefix_hit_rate": round(
                self.scheduler.prefix_hit_tokens
                / max(1, self.scheduler.prompt_tokens), 4),
        }
        if self.spec_decoder is not None:
            gauges["spec_accept_rate"] = round(
                s["spec_accepted"] / max(1, int(s["spec_drafted"])), 4)
        rec = self.ledger.record(gauges, final=final)
        self.serve_ts.append(rec)
        return rec

    def summary(self) -> Dict[str, float]:
        s = dict(self.stats)
        n = max(1, int(s.pop("occupancy_samples")))
        s["occupancy_mean"] = s.pop("occupancy_sum") / n
        s["preemptions"] = self.scheduler.n_preemptions
        s["iters"] = self._iters
        s["prompt_tokens"] = self.scheduler.prompt_tokens
        s["prefix_hit_tokens"] = self.scheduler.prefix_hit_tokens
        s["prefix_hit_rate"] = (self.scheduler.prefix_hit_tokens
                                / max(1, self.scheduler.prompt_tokens))
        s["prefix_evictions"] = self.cache_state.n_prefix_evictions
        if self.kv_store is not None:
            cs = self.cache_state
            s["store_hit_tokens_host"] = cs.store_hit_tokens_host
            s["store_hit_tokens_disk"] = cs.store_hit_tokens_disk
            s["store_hit_tokens"] = (
                cs.store_hit_tokens_host + cs.store_hit_tokens_disk)
            s["store_spills"] = cs.n_store_spills
            s["store_declined"] = cs.n_store_declined
            s["migrated_tail_fills"] = self.scheduler.n_migrated_tail_fills
            s["migration_declined"] = self.scheduler.n_migration_declined
            for k, v in self.kv_store.stats().items():
                s[f"kv_store_{k}"] = v
        s.update(self.cache_state.fragmentation())
        s.update(self.scheduler.pool_shard_stats())
        s["queue_depth"] = self.queue_depth
        s["outstanding_tokens"] = self.outstanding_tokens
        s["oldest_wait_s"] = (
            self.oldest_wait_age() if self.scheduler.waiting else 0.0)
        if self._deadline_margins:
            margins = np.asarray(self._deadline_margins)
            slack = np.maximum(margins, 0.0)
            s["deadline_miss_rate"] = float(np.mean(margins > 0))
            s["deadline_miss_slack_p50"] = float(np.percentile(slack, 50))
            s["deadline_miss_slack_p99"] = float(np.percentile(slack, 99))
        if self.spec_decoder is not None:
            s["spec_accept_mean"] = (
                s["spec_accepted"] / max(1, int(s["spec_steps"])))
            s["spec_accept_rate"] = (
                s["spec_accepted"] / max(1, int(s["spec_drafted"])))
            s["spec_accept_hist"] = list(self.spec_decoder.accept_hist)
        else:
            for k in ("spec_steps", "spec_drafted", "spec_accepted"):
                s.pop(k)
        if self.wall_elapsed:
            s["wall_s"] = self.wall_elapsed
            s["tokens_per_s"] = s["generated_tokens"] / self.wall_elapsed
        return s


class _ShardedModel:
    """The model of a tensor-parallel replica: ``GPT(config)`` on
    ``meta`` (it allocates nothing) and its parameters as ``mesh``'s shards
    (``sharding.shard_params``, no whole copy kept). A call gathers them on
    the compute device (``sharding.gather_params``, an exact
    concatenation, dropped after the call) and runs the module over the
    gathered tensors."""

    def __init__(self, config: GPTConfig, params, mesh):
        self.module, specs = meta_model(config, params)
        self.config = config
        self.params = tp_lib.shard_params(
            {n: torch.as_tensor(v).to(specs[n].dtype)
             for n, v in params.items()}, mesh)

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(
            self.module, tp_lib.gather_params(self.params), args, kwargs)


@torch.inference_mode()
def _engine_step(
    model: GPT, cache, tables, lengths, offsets, ids, temps, topks, topps,
    keys, steps, *, k_cap: int, prefill: bool, hist_blocks: int,
) -> torch.Tensor:
    """One engine step: copy host scheduling state into the device cache,
    forward (the pools update in place), take each row's last real logit
    (position ``lengths - offsets - 1`` of a prefill chunk), sample. A
    tensor-parallel replica's ``model`` (``_ShardedModel``) gathers its
    parameter shards for the step."""
    dev = cache["tables"].device
    cache["tables"].copy_(torch.from_numpy(tables))
    cache["lengths"].copy_(torch.from_numpy(lengths))
    cache["offsets"].copy_(torch.from_numpy(offsets))
    logits_at = None
    if prefill:
        logits_at = torch.from_numpy(
            np.maximum(lengths - offsets - 1, 0)).to(dev)
    logits = model(torch.from_numpy(ids).to(dev), cache,
                   hist_blocks=hist_blocks, logits_at=logits_at)[:, 0]
    return sample_tokens(logits, temps, topks, topps, keys, steps,
                         k_cap=k_cap)


def poisson_trace(
    n_requests: int,
    *,
    vocab_size: int,
    rate: float = 8.0,
    seed: int = 0,
    prompt_len_range: Tuple[int, int] = (8, 64),
    max_new_range: Tuple[int, int] = (8, 32),
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
) -> List[Request]:
    """Synthetic open-loop trace: exponential inter-arrivals at ``rate``
    per time unit, uniform prompt/output lengths, one sampling seed per
    request — all from ``seed``, the same trace the JAX package builds."""
    rs = np.random.RandomState(seed)
    arrivals = np.cumsum(rs.exponential(1.0 / rate, size=n_requests))
    out = []
    for i in range(n_requests):
        plen = int(rs.randint(prompt_len_range[0], prompt_len_range[1] + 1))
        mnew = int(rs.randint(max_new_range[0], max_new_range[1] + 1))
        prompt = rs.randint(1, vocab_size, size=plen).tolist()
        out.append(Request(
            rid=i,
            prompt=[int(t) for t in prompt],
            max_new_tokens=mnew,
            sampling=SamplingParams(
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=int(rs.randint(0, 2**31 - 1)),
            ),
            arrival_time=float(arrivals[i]),
            eos_id=eos_id,
        ))
    return out


def request_metrics(reqs: Sequence[Request]) -> Dict[str, List[float]]:
    """Latency series on the engine's time axis: TTFT (first token minus
    arrival, one per request), TPOT (every inter-token gap), queue_wait
    (first admission minus arrival)."""
    ttft, tpot, queue_wait = [], [], []
    for r in reqs:
        if r.admitted_at is not None:
            queue_wait.append(max(0.0, r.admitted_at - r.arrival_time))
        if r.first_token_at is None:
            continue
        ttft.append(r.first_token_at - r.arrival_time)
        if len(r.token_times) >= 2:
            tpot.extend(b - a for a, b in zip(r.token_times, r.token_times[1:]))
        elif not r.token_times:
            n_rest = len(r.generated) - 1
            if n_rest > 0 and r.finished_at is not None:
                tpot.append((r.finished_at - r.first_token_at) / n_rest)
    return {"ttft": ttft, "tpot": tpot, "queue_wait": queue_wait}


def _main(argv=None) -> int:
    import argparse
    import json

    from tpu_trainer_torch.models.weights import init_params

    p = argparse.ArgumentParser(
        description="Replay a seeded Poisson trace through the serving "
        "engine on a synthetic checkpoint.")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=0,
                   help="KV pool blocks (0 = size for max_batch full contexts)")
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked-prefill token budget per iteration "
                        "(0 = whole-prompt prefill)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="copy-on-write prefix sharing in the block pool")
    p.add_argument("--attention", default="auto",
                   choices=("auto", "reference", "kernel"))
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    p.add_argument("--spec", default="off", choices=("off", "ngram", "draft"),
                   help="speculative decoding proposer")
    p.add_argument("--spec-k", type=int, default=4,
                   help="max draft tokens per verify step")
    p.add_argument("--spec-draft-layers", type=int, default=1,
                   help="target layers sliced into the draft model "
                        "(--spec draft)")
    p.add_argument("--time-mode", default="wall", choices=("wall", "steps"))
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    config = GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads,
        max_seq_len=args.max_seq_len, dropout=0.0, attention_dropout=0.0,
        dtype="float32", param_dtype="float32",
    )
    params = init_params(config, args.seed, device=args.device)
    draft_params = draft_config = None
    if args.spec == "draft":
        draft_params, draft_config = draft_from_target(
            params, config, args.spec_draft_layers)
    engine = ServingEngine(
        params, config, max_batch=args.max_batch,
        block_size=args.block_size, num_blocks=args.num_blocks or None,
        kv_int8=args.kv_int8, attention=args.attention,
        prefill_chunk_tokens=args.prefill_chunk or None,
        prefix_cache=args.prefix_cache, spec=args.spec, spec_k=args.spec_k,
        draft_params=draft_params, draft_config=draft_config,
        device=args.device,
    )
    trace = poisson_trace(
        args.requests, vocab_size=args.vocab, rate=args.rate,
        seed=args.seed, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p)
    finished = engine.run(trace, time_mode=args.time_mode)
    summary = engine.summary()
    summary["device"] = str(engine.device)
    lat = request_metrics(finished)
    for name, series in lat.items():
        if series:
            summary[f"{name}_p50"] = float(np.percentile(series, 50))
            summary[f"{name}_p99"] = float(np.percentile(series, 99))
    print(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                      for k, v in sorted(summary.items())}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
