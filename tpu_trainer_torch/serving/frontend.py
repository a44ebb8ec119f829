"""Multi-replica serving front-end (port of ``tpu_trainer/serving/frontend.py``):
prefix-affinity routing, SLO-aware admission control, replica failover,
and capacity-driven resize.

Everything below ``ServingFrontend`` is the single-engine stack
unchanged: each replica is a full ``ServingEngine`` (its own scheduler,
paged block pool, prefix index and copy of the weights) built from the
SAME params/config, its decode attention the flash-decode kernel on the
card. The front-end owns the request tier above:

- **Prefix-affinity routing** (``routing="affinity"``): the routing key
  is the chained blake2b digest of the prompt's leading full blocks —
  literally the same hash the per-engine prefix index uses
  (``paged_cache.chained_block_digests``) — mapped to a replica by
  rendezvous (highest-random-weight) hashing over the live set, so the
  mapping is stable under grow/shrink/failover: resizing moves only the
  keys that must move. Shared-prefix traffic therefore lands on the one
  replica whose copy-on-write cache already holds the prefix, instead
  of every replica paying the cold prefill (what ``random`` and pure
  ``least_loaded`` routing cost on correlated traffic). Prompts with no
  full block route least-outstanding-tokens (cold fallback), and a
  ``spill_tokens`` gap threshold sheds an over-affine hot shard to the
  least-loaded survivor so affinity can never starve the rest of the
  fleet.
- **SLO-aware admission control**: per-replica queues are bounded
  (``max_queue_depth``) and carry an oldest-wait age watermark
  (``wait_watermark``, in front-end clock units). A submit that lands
  on a replica past either limit first tries to shed to a live replica
  with room; if none exists the request is REJECTED at submit with a
  structured ``SubmitResult`` (reason, observed depth and wait age) —
  backpressure the caller can act on, never a silently unbounded queue.
  Rejects, queue depths, and wait-age percentiles surface in
  ``summary()``.
- **Replica failover**: ``kill_replica`` (driven by the
  ``replica_kill@N`` fault kind, ``utils/faults.py``) marks a replica
  dead, exports its queued AND in-flight requests with runtime state
  reset (``Scheduler.export_requests``), and resubmits them to the
  survivors. Resumed streams are token-identical to an undisturbed run
  by the preemption-resume argument: re-admission re-prefills prompt +
  generated-so-far and sampling is keyed by (seed, token index), so the
  continuation cannot depend on where — or how often — it was
  interrupted.
- **Capacity-driven resize**: the front-end probes the
  ``utils/preemption.py`` capacity file every ``capacity_probe_every``
  iterations and consumes grants to grow toward ``max_replicas`` (the
  same grant/consume protocol the elastic trainer uses for host
  grow-back). ``shrink`` marks the highest-id replicas draining:
  their waiting requests re-route immediately, their running requests
  finish in place, and the replica is torn down only once idle.

Time: the front-end owns one clock domain shared by every replica
(engines are built with ``clock=`` the front-end's ``_now`` and a zero
epoch), so arrival times, wait ages, and token timestamps are all
comparable across replicas — in seconds (``time_mode="wall"``) or
front-end iterations (``"steps"``, fully deterministic for tests).

Replicas are pluggable (``replica_factory``): the default builds
in-process engines wrapped in ``LocalReplica``; passing a
``serving.remote.WorkerSupervisor`` instead puts each replica in its
own OS process behind the ``serving/worker.py`` RPC loop — same
routing/admission/failover logic, and the same clock domain (every step
RPC ships the front-end's ``now``, so ``steps`` mode stays
deterministic fleet-wide). Worker deaths (SIGKILL exit codes or
heartbeat flatlines, the ``worker_kill`` fault) are polled each step
and drive the same ``kill_replica`` failover as ``replica_kill`` —
dead-worker state is reconstructed from the front-end-side request
mirrors, so queued AND in-flight requests resume bit-identically on
the survivors.

Request lifecycle: beyond finishing, an accepted request can be
**cancelled** (``cancel(rid)`` — effective on waiting AND running
requests, freeing its paged KV blocks immediately on in-process and
RPC replicas alike via the ``cancel`` RPC verb) or can miss its
**deadline** (``Request.deadline``, front-end clock domain; expiry is
swept at each engine iteration boundary). Both are terminal states
counted separately from ``finished``; conservation becomes ``accepted
== finished + cancelled + deadline_exceeded`` at drain. Hung — not
dead — workers (the ``worker_hang`` SIGSTOP fault, or a real wedge)
are caught by per-call RPC timeouts: the blocked call raises
``ReplicaDied``, the supervisor FENCES the suspect (SIGKILL, so a
paused process can never wake up and keep serving a replica the
front-end already failed over), and recovery reuses the exact
``kill_replica`` export/resubmit path — so resumed streams stay
bit-identical and the front-end stall is bounded by the configured
RPC timeout. One-shot transport faults (``net_delay`` / ``net_drop``
/ ``net_garble`` / ``net_hang``) arm the same machinery for chaos
drills.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from tpu_trainer_torch.serving.engine import ServingEngine
from tpu_trainer_torch.serving.kv_store import KVBlockStore, leaves_nbytes
from tpu_trainer_torch.serving.paged_cache import chained_block_digests
from tpu_trainer_torch.serving.remote import ReplicaDied
from tpu_trainer_torch.serving.scheduler import Request
from tpu_trainer_torch.serving.tracing import ServingLedger, SpanTracer
from tpu_trainer_torch.utils import faults
from tpu_trainer_torch.utils.flight_recorder import FlightRecorder
from tpu_trainer_torch.utils.preemption import consume_capacity, read_capacity
from tpu_trainer_torch.utils.schema import SCHEMA_VERSION

ROUTINGS = ("affinity", "random", "least_loaded")


@dataclasses.dataclass
class SubmitResult:
    """Structured outcome of one ``submit``: where the request went, or
    why it was shed. ``routed`` records the decision path (affinity /
    cold / spill / random / least_loaded / failover); on a reject it is
    None and ``reason`` says which limit tripped (queue_full |
    wait_watermark), with the depth and wait age observed at the
    decision — the caller's backpressure signal."""

    accepted: bool
    replica: Optional[int] = None
    routed: Optional[str] = None
    reason: Optional[str] = None
    queue_depth: int = 0
    oldest_wait: float = 0.0


class LocalReplica:
    """In-process replica adapter: the narrow engine surface the
    front-end actually consumes, shared verbatim with
    ``serving.remote.RemoteReplica`` so a worker process is a drop-in.
    Anything the front-end wants from a replica goes through here —
    submit, step, load counters, export, release — never through
    engine internals directly."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def submit(self, req: Request, trace: Optional[List[dict]] = None,
               migration: Optional[dict] = None) -> None:
        if trace:
            # Same contract as RemoteReplica: front-door span context
            # merges into the engine's tracer (non-pending — never
            # echoed back to the front-end that already holds it).
            self.engine.tracer.ingest(trace)
        if migration is not None:
            req._kv_migration = migration
        self.engine.scheduler.add(req)

    def step(self) -> List[Request]:
        return self.engine.step()

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def has_work(self) -> bool:
        return self.engine.scheduler.has_work()

    @property
    def queue_depth(self) -> int:
        return self.engine.queue_depth

    @property
    def outstanding_tokens(self) -> int:
        return self.engine.outstanding_tokens

    def oldest_wait_age(self, now: float) -> float:
        return self.engine.oldest_wait_age(now)

    def export_requests(self, *, waiting_only: bool = False) -> List[Request]:
        return self.engine.export_requests(waiting_only=waiting_only)

    def drain_span_events(self) -> List[dict]:
        """Span events the engine emitted since the last drain — the
        same delta surface ``RemoteReplica`` fills from step replies, so
        the front-end merges both transports identically."""
        return self.engine.tracer.drain()

    def metrics_snapshot(self) -> dict:
        """The engine registry's resolved snapshot — same surface as
        ``RemoteReplica.metrics_snapshot`` (which pulls it over the
        ``metrics`` RPC verb), so the front-end merges both transports
        identically."""
        return self.engine.registry.snapshot()

    def release(self) -> None:
        self.engine.device_cache = None   # drop the KV pools

    # -- disaggregation surface (mirrors RemoteReplica's) ------------------

    def set_role(self, role: Optional[str]) -> None:
        self.engine.set_role(role)

    def migratable_rids(self) -> List[int]:
        return self.engine.migratable_rids()

    def extract(self, rid: int):
        return self.engine.extract_request(rid)

    @property
    def block_size(self) -> int:
        return self.engine.cache_state.block_size

    @property
    def generated_tokens(self) -> int:
        return int(self.engine.stats["generated_tokens"])

    @property
    def prefix_hit_tokens(self) -> int:
        return self.engine.scheduler.prefix_hit_tokens

    @property
    def prompt_tokens(self) -> int:
        return self.engine.scheduler.prompt_tokens

    @property
    def n_preemptions(self) -> int:
        return self.engine.scheduler.n_preemptions

    @property
    def store_hit_tokens_host(self) -> int:
        return int(self.engine.cache_state.store_hit_tokens_host)

    @property
    def store_hit_tokens_disk(self) -> int:
        return int(self.engine.cache_state.store_hit_tokens_disk)


@dataclasses.dataclass
class _Replica:
    """One replica adapter (local or remote) plus its front-end
    bookkeeping. The attribute keeps the name ``engine`` — it holds the
    adapter, whose surface is a strict subset of the engine's."""

    rid: int
    engine: object                     # LocalReplica | remote.RemoteReplica
    alive: bool = True
    draining: bool = False
    finished: int = 0
    routed: Dict[str, int] = dataclasses.field(default_factory=dict)


class ServingFrontend:
    """N in-process ``ServingEngine`` replicas behind one
    submit/step/drain surface."""

    def __init__(
        self,
        params,
        config: GPTConfig,
        *,
        replicas: int = 2,
        routing: str = "affinity",
        affinity_blocks: int = 1,
        spill_tokens: Optional[int] = 512,
        max_queue_depth: int = 64,
        wait_watermark: Optional[float] = None,
        capacity_file: Optional[str] = None,
        max_replicas: Optional[int] = None,
        capacity_probe_every: int = 8,
        time_mode: str = "wall",
        clock=time.perf_counter,
        seed: int = 0,
        replica_factory=None,
        replica_device_sets=None,
        replica_roles: Optional[Sequence[str]] = None,
        trace: bool = True,
        ts_interval: int = 32,
        incident_dir: Optional[str] = None,
        ring_capacity: int = 256,
        metric_logger=None,
        registry=None,
        metrics_pull_every: int = 16,
        **engine_kwargs,
    ):
        if replicas < 1:
            raise ValueError(f"replicas={replicas}")
        if routing not in ROUTINGS:
            raise ValueError(f"routing={routing!r} (one of {ROUTINGS})")
        if affinity_blocks < 1:
            raise ValueError(f"affinity_blocks={affinity_blocks}")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth={max_queue_depth}")
        if time_mode not in ("wall", "steps"):
            raise ValueError(f"time_mode={time_mode!r}")
        self.params = params
        self.config = config
        self.routing = routing
        self.affinity_blocks = affinity_blocks
        self.spill_tokens = spill_tokens
        self.max_queue_depth = max_queue_depth
        self.wait_watermark = wait_watermark
        self.capacity_file = capacity_file
        self.max_replicas = max_replicas
        self.capacity_probe_every = max(1, capacity_probe_every)
        self.time_mode = time_mode
        self.clock = clock
        # A replica_factory makes the replica tier pluggable: called as
        # (rid, clock) -> replica adapter. None = in-process engines.
        # A factory that also exposes poll_deaths/sigkill (i.e. a
        # remote.WorkerSupervisor) is additionally used as the process
        # supervisor: deaths it reports drive kill_replica failover.
        self._replica_factory = replica_factory
        self._supervisor = (replica_factory
                            if hasattr(replica_factory, "poll_deaths")
                            else None)
        # Replica engines inherit the tracing switch so local emission
        # and front-end merging toggle together (a bare bool, so the
        # RPC worker spec serializes it too).
        engine_kwargs.setdefault("trace", trace)
        self._engine_kwargs = engine_kwargs
        # Disaggregated prefill/decode: replica ``rid`` takes role
        # ``replica_roles[rid % len]``. Prefill replicas run chunked
        # prefill + the first token only; the front-end then migrates
        # the finished KV (digest-addressed full blocks via the store,
        # raw tail) to a rendezvous-routed decode replica. Roles are a
        # performance shape, never a correctness dependency — any
        # request can fall back to plain re-prefill anywhere.
        self.replica_roles = list(replica_roles) if replica_roles else None
        if self.replica_roles:
            for r in self.replica_roles:
                if r not in ("prefill", "decode"):
                    raise ValueError(
                        f"replica_roles entry {r!r} (prefill | decode)")
            if "decode" not in self.replica_roles:
                raise ValueError("replica_roles needs a decode replica")
        self._role: Dict[int, str] = {}
        # Fleet-wide KV block store. In-process fleets share ONE store
        # object (a prefix prefilled on any replica is a store hit on
        # every other); RPC fleets give each worker a local store
        # (kv_store_bytes in engine kwargs) synchronized over the
        # kv_put/kv_get verbs, with a digest->holder catalog fed by
        # load-snapshot deltas.
        self.kv_store: Optional[KVBlockStore] = None
        if self._replica_factory is None and (
                engine_kwargs.get("kv_store_bytes")
                or engine_kwargs.get("kv_store_dir")):
            self.kv_store = KVBlockStore(
                host_bytes=int(engine_kwargs.get("kv_store_bytes")
                               or (64 << 20)),
                disk_dir=engine_kwargs.get("kv_store_dir"))
        self._kv_catalog: Dict[bytes, int] = {}
        # Mesh-aware replica placement: one replica = one mesh. Each
        # entry is a list of CUDA ordinals; replica ``rid`` takes entry
        # ``rid % len`` as its ``mesh_devices``, so a fleet carves the
        # host's cards into tensor-parallel meshes. None = every replica
        # uses the default devices (engine_kwargs may set mesh_tensor).
        self._replica_device_sets = (
            [tuple(int(d) for d in ds) for ds in replica_device_sets]
            if replica_device_sets else None)
        # Fleet observability: one merged tracer (front-door events plus
        # replica deltas drained after each step), per-replica flight-
        # recorder rings fed off every event, a serve-loop ledger, and
        # periodic serve_ts samples. All host-side — the device path
        # and the sampled tokens cannot see any of it.
        self.tracer = SpanTracer(on_event=self._ring_observe, enabled=trace)
        self.ledger = ServingLedger()
        self.ts_interval = int(ts_interval)
        self.incident_dir = incident_dir
        self.ring_capacity = int(ring_capacity)
        self.metric_logger = metric_logger
        self.serve_ts: List[dict] = []
        self.incidents: List[dict] = []
        self._rings: Dict[int, FlightRecorder] = {}
        self._rs = np.random.RandomState(seed)
        self._replicas: List[_Replica] = []
        self._next_rid = 0
        self._iters = 0
        self._t0: Optional[float] = None
        self.wall_elapsed = 0.0
        self.submit_results: Dict[int, SubmitResult] = {}
        self._wait_samples: List[float] = []
        # Wall-clock seconds the front-end lost to a replica step that
        # ended in ReplicaDied (hung-RPC fence or death mid-call) — the
        # observable stall a caller sees before failover kicks in.
        self._stall_samples: List[float] = []
        # finished_at - deadline per deadline-carrying terminal request
        # (cancels excluded): >0 is a miss, the fleet-level mirror of
        # the per-engine deadline accounting.
        self._deadline_margins: List[float] = []
        self.stats: Dict[str, float] = {
            "submitted": 0, "accepted": 0, "rejected": 0,
            "rejected_queue_full": 0, "rejected_wait_watermark": 0,
            "finished": 0, "cancelled": 0, "deadline_exceeded": 0,
            "failed": 0,
            "failover_events": 0, "failed_over_requests": 0,
            "worker_deaths": 0,
            "grows": 0, "shrinks": 0, "retired_replicas": 0,
            "migrations": 0, "migrated_bytes": 0,
            "migration_pushed_blocks": 0, "store_synced_blocks": 0,
            "imbalance_sum": 0.0, "imbalance_samples": 0,
            "imbalance_max": 0.0,
        }
        # Live metrics plane: front-door counters mirror ``stats`` via
        # set_function (zero hot-path cost, exact agreement with
        # summary()); per-replica engine registries are pulled and
        # merged label-wise (replica=N) every ``metrics_pull_every``
        # iterations — from the MAIN thread only, so the scrape thread
        # never races an RPC socket. Off (registry=None) ⇒ a null
        # registry and no pulls: bit-identical to a run without it.
        self.registry = registry if registry is not None else NULL_REGISTRY
        self._metrics_on = registry is not None
        self.metrics_pull_every = max(1, int(metrics_pull_every))
        self._install_metrics()
        for _ in range(replicas):
            self._spawn_replica()
        self.block_size = self._replicas[0].engine.block_size

    def _install_metrics(self) -> None:
        reg = self.registry
        req = reg.counter("frontend_requests_total",
                          "Front-door request events", labelnames=("event",))
        for ev in ("submitted", "accepted", "rejected", "finished",
                   "cancelled", "deadline_exceeded", "failed"):
            req.labels(event=ev).set_function(
                lambda e=ev: self.stats[e])
        rej = reg.counter("frontend_rejects_total",
                          "Admission rejects by tripped limit",
                          labelnames=("reason",))
        for reason in ("queue_full", "wait_watermark"):
            rej.labels(reason=reason).set_function(
                lambda r=reason: self.stats[f"rejected_{r}"])
        for name, key, help_ in (
                ("frontend_failover_events_total", "failover_events",
                 "Replica failovers"),
                ("frontend_failed_over_requests_total",
                 "failed_over_requests", "Requests moved by failover"),
                ("frontend_worker_deaths_total", "worker_deaths",
                 "Worker process deaths (killed, fenced, or crashed)"),
                ("frontend_grows_total", "grows", "Replicas added"),
                ("frontend_shrinks_total", "shrinks", "Replicas drained"),
                ("frontend_retired_replicas_total", "retired_replicas",
                 "Draining replicas torn down")):
            reg.counter(name, help_).set_function(
                lambda k=key: self.stats[k])
        reg.counter("frontend_fenced_total",
                    "Suspect workers fenced (SIGKILL) after a hung RPC"
                    ).set_function(
                        lambda: getattr(self._supervisor, "n_fenced", 0)
                        if self._supervisor is not None else 0)
        reg.counter("frontend_incidents_total", "Incident records"
                    ).set_function(lambda: len(self.incidents))
        rep = reg.gauge("frontend_replicas", "Replica set by state",
                        labelnames=("state",))
        rep.labels(state="live").set_function(lambda: len(self._live()))
        rep.labels(state="draining").set_function(
            lambda: sum(1 for h in self._replicas
                        if h.alive and h.draining))
        rep.labels(state="dead").set_function(
            lambda: sum(1 for h in self._replicas if not h.alive))
        reg.gauge("frontend_queue_depth", "Fleet queued requests"
                  ).set_function(
                      lambda: sum(h.engine.queue_depth
                                  for h in self._replicas if h.alive))
        reg.gauge("frontend_outstanding_tokens",
                  "Fleet token-steps of work owed").set_function(
                      lambda: sum(h.engine.outstanding_tokens
                                  for h in self._replicas if h.alive))
        reg.gauge("frontend_in_flight", "Accepted, not yet terminal"
                  ).set_function(
                      lambda: self.stats["accepted"]
                      - self.stats["finished"] - self.stats["cancelled"]
                      - self.stats["deadline_exceeded"]
                      - self.stats["failed"])
        # Fleet store + disaggregation mirrors. Named frontend_kv_* (NOT
        # kv_store_* — those are the per-engine families that arrive via
        # pull_metrics with replica labels; re-registering them here
        # label-free would conflict in the merge).
        kvb = reg.gauge("frontend_kv_store_bytes",
                        "Shared fleet KV store bytes by tier",
                        labelnames=("tier",))
        kvb.labels(tier="host").set_function(
            lambda: self.kv_store.host_bytes_used
            if self.kv_store is not None else 0)
        kvb.labels(tier="disk").set_function(
            lambda: self.kv_store.disk_bytes_used
            if self.kv_store is not None else 0)
        kvh = reg.counter("frontend_kv_store_hit_tokens_total",
                          "Fleet prefill tokens skipped via store hits",
                          labelnames=("tier",))
        kvh.labels(tier="host").set_function(
            lambda: sum(getattr(h.engine, "store_hit_tokens_host", 0)
                        for h in self._replicas))
        kvh.labels(tier="disk").set_function(
            lambda: sum(getattr(h.engine, "store_hit_tokens_disk", 0)
                        for h in self._replicas))
        for name, key, help_ in (
                ("frontend_kv_migrations_total", "migrations",
                 "Requests migrated prefill->decode"),
                ("frontend_kv_migrated_bytes_total", "migrated_bytes",
                 "KV bytes moved by migration (blocks + raw tails)"),
                ("frontend_kv_pushed_blocks_total",
                 "migration_pushed_blocks",
                 "Store blocks pushed to decode workers for migration"),
                ("frontend_kv_synced_blocks_total", "store_synced_blocks",
                 "Store blocks pushed at submit to symmetric workers")):
            reg.counter(name, help_).set_function(
                lambda k=key: self.stats[k])

    def ready(self) -> bool:
        """Readiness for /healthz: at least one live replica. Flips
        false once the fleet drains to nothing (every replica released)
        — the state serve_bench asserts after close."""
        return any(h.alive for h in self._replicas)

    def statusz(self) -> dict:
        """The /statusz payload: fleet summary plus per-replica pool
        fragmentation where visible (local replicas read their engine;
        remote ones report through the merged registry instead)."""
        out = {"kind": "serving_frontend", "iter": self._iters}
        out["summary"] = {
            k: v for k, v in self.summary().items() if k != "per_replica"}
        out["replicas"] = [
            {"replica": h.rid, "alive": h.alive, "draining": h.draining,
             "role": self._role.get(h.rid), "finished": h.finished}
            for h in self._replicas]
        for h, rec in zip(self._replicas, out["replicas"]):
            if h.alive and isinstance(h.engine, LocalReplica):
                rec.update(h.engine.engine.cache_state.fragmentation())
        return out

    def pull_metrics(self) -> None:
        """Merge every live replica's registry snapshot into the
        front-end registry (labels gain ``replica=N``). MAIN thread
        only — a pull is an RPC on remote fleets, and RPC frames must
        never interleave with the step loop's. A replica that dies
        mid-pull is settled through the normal failover path."""
        if not self._metrics_on:
            return
        for h in list(self._replicas):
            if not h.alive:
                continue
            snap_fn = getattr(h.engine, "metrics_snapshot", None)
            if snap_fn is None:
                return   # custom replica without the surface: skip all
            try:
                snap = snap_fn()
            except ReplicaDied:
                self.stats["worker_deaths"] += 1
                self.kill_replica(h.rid, reason="rpc_death")
                continue
            self.registry.merge(snap, extra_labels={"replica": h.rid})

    # -- replica set -------------------------------------------------------

    def _spawn_replica(self) -> _Replica:
        # Replicas live in the front-end's clock domain: the factory
        # receives ``self._now`` and every replica's timestamps are
        # front-end times (zero epoch) — in-process via clock injection,
        # cross-process by shipping ``now`` on every step RPC. Wait ages
        # computed against request arrival_time are therefore comparable
        # across the whole fleet, and ``steps`` mode stays deterministic
        # even when the replica is another OS process.
        rid = self._next_rid
        if self._replica_factory is not None:
            rep = self._replica_factory(rid, self._now)
        else:
            kw = dict(self._engine_kwargs)
            if self._replica_device_sets:
                dsets = self._replica_device_sets
                kw["mesh_devices"] = dsets[rid % len(dsets)]
            if self.kv_store is not None:
                # Every in-process engine shares the front-end's one
                # store object (kv_store wins over kv_store_bytes/_dir
                # inside the engine) — "cached anywhere" IS the tier.
                kw["kv_store"] = self.kv_store
            if self._metrics_on:
                # Per-engine registry, merged into ours label-wise on
                # each pull — the same shape as a worker process's.
                kw.setdefault("registry", MetricsRegistry())
            eng = ServingEngine(self.params, self.config, clock=self._now,
                                **kw)
            eng._t0 = 0.0
            rep = LocalReplica(eng)
        h = _Replica(rid=rid, engine=rep)
        self._next_rid += 1
        self._replicas.append(h)
        if self.replica_roles:
            role = self.replica_roles[rid % len(self.replica_roles)]
            self._role[rid] = role
            set_role = getattr(rep, "set_role", None)
            if set_role is not None:
                set_role(role)
            elif role == "prefill":
                raise ValueError(
                    "replica adapter has no set_role surface for a "
                    "prefill-role replica")
        return h

    def _live(self, *, routable: bool = False) -> List[_Replica]:
        return [h for h in self._replicas
                if h.alive and not (routable and h.draining)]

    def has_work(self) -> bool:
        return any(h.engine.has_work() for h in self._live())

    def _now(self) -> float:
        if self.time_mode == "steps":
            return float(self._iters)
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    # -- observability -----------------------------------------------------

    def _emit(self, rid, event: str, **attrs) -> None:
        self.tracer.emit(rid, event, self._now(), **attrs)

    def _ring_observe(self, ev: dict) -> None:
        """Every merged span event lands in its replica's ring (capacity
        ``ring_capacity``, oldest evicted) — the raw material an
        incident dump freezes. Front-door events (submit/route, no
        replica yet) share the fleet ring keyed -1."""
        key = int(ev.get("replica", -1))
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = FlightRecorder(
                capacity=self.ring_capacity)
        ring.observe(ev)

    def _drain_spans(self, h: _Replica) -> None:
        """Merge the replica's span-event delta into the fleet timeline,
        stamped with the replica id. Worker clocks already run in the
        front-end domain (worker.py pins ``_t0 = 0``), so timestamps
        merge without skew correction."""
        if not self.tracer.enabled:
            return
        drain = getattr(h.engine, "drain_span_events", None)
        if drain is None:
            return
        evs = drain()
        for ev in evs:
            ev.setdefault("replica", h.rid)
        self.tracer.ingest(evs)

    def _incident_snapshot(self) -> dict:
        return {
            "iter": self._iters,
            "t": self._now(),
            "replicas_live": len(self._live()),
            "replicas_total": len(self._replicas),
            "queue_depth": sum(
                h.engine.queue_depth for h in self._live()),
            "stats": {k: v for k, v in self.stats.items()
                      if not k.startswith("imbalance_")},
        }

    def _dump_incident(self, reason: str, rid: int) -> Optional[str]:
        """Freeze the span-event ring of the replica an incident hit
        (plus the front-door ring for fleet-level incidents, rid=-1)
        into an atomic ``crash_report.json`` under ``incident_dir``, and
        count a ``kind:"incident"`` record either way. Returns the dump
        directory, or None when ``incident_dir`` is unset."""
        rec = {
            "kind": "incident", "schema_version": SCHEMA_VERSION,
            "reason": reason, "replica": rid,
            "t": round(self._now(), 6), "iter": self._iters,
        }
        self.incidents.append(rec)
        if self.metric_logger is not None:
            self.metric_logger.log_record(rec)
        if not self.incident_dir:
            return None
        ring = self._rings.get(rid)
        if ring is None:
            ring = self._rings[rid] = FlightRecorder(
                capacity=self.ring_capacity)
        # The fleet as of the incident, frozen beside the ring.
        ring.snapshot = self._incident_snapshot()
        out = os.path.join(
            self.incident_dir, f"i{self._iters:06d}_{reason}_r{rid}")
        ring.dump(out, reason=reason, step=self._iters)
        rec["dump_dir"] = out
        return out

    def _emit_ts(self, final: bool = False) -> None:
        """One fleet ``serve_ts`` sample: ledger fractions plus cheap
        as-of-now gauges (queue/load gauges read front-end-side request
        mirrors, so no extra RPC round-trips on remote fleets)."""
        live = self._live()
        gauges = {
            "t": round(self._now(), 6),
            "iter": self._iters,
            "replicas_live": len(live),
            "queue_depth": sum(h.engine.queue_depth for h in live),
            "outstanding_tokens": sum(
                h.engine.outstanding_tokens for h in live),
            "in_flight": int(
                self.stats["accepted"] - self.stats["finished"]
                - self.stats["cancelled"]
                - self.stats["deadline_exceeded"] - self.stats["failed"]),
            "finished": int(self.stats["finished"]),
            "rejected": int(self.stats["rejected"]),
            "worker_deaths": int(self.stats["worker_deaths"]),
        }
        rec = self.ledger.record(gauges, final=final)
        self.serve_ts.append(rec)
        if self.metric_logger is not None:
            self.metric_logger.log_record(rec)

    # -- routing -----------------------------------------------------------

    def _prompt_digests(self, req: Request) -> List[bytes]:
        """The request's chained block digests, hashed ONCE at first use
        and cached on the request — the router key, replica admission
        (``Scheduler._admit``), store addressing, and migration all read
        this one list (cross-process too: it rides the request wire
        codec)."""
        if req._prompt_digests is None:
            req._prompt_digests = chained_block_digests(
                req.prompt, self.block_size)
        return req._prompt_digests

    def _affinity_key(self, req) -> Optional[bytes]:
        """Chained digest of the prompt's leading full blocks (capped at
        ``affinity_blocks`` — coarse on purpose: requests sharing a
        system prefix but diverging later must still share a key), or
        None when the prompt has no full block (cold). Accepts a
        ``Request`` (digests cached on the request, hashed once) or a
        raw token sequence for out-of-band probes."""
        if isinstance(req, Request):
            digs = self._prompt_digests(req)
        else:
            digs = chained_block_digests(req, self.block_size)
        n = min(len(digs), self.affinity_blocks)
        if n == 0:
            return None
        return digs[n - 1]

    @staticmethod
    def _rendezvous(key: bytes, cands: List[_Replica]) -> _Replica:
        """Highest-random-weight hashing: each replica scores
        blake2b(key + rid); the max wins. Adding/removing a replica
        remaps only the keys whose winner changed — affinity survives
        resize and failover with minimal cache churn."""
        best, best_score = cands[0], -1
        for h in cands:
            score = int.from_bytes(
                hashlib.blake2b(
                    key + h.rid.to_bytes(8, "little"), digest_size=8
                ).digest(), "little")
            if score > best_score:
                best, best_score = h, score
        return best

    @staticmethod
    def _load(h: _Replica) -> Tuple[int, int]:
        return (h.engine.outstanding_tokens, h.rid)

    def _route(self, req: Request) -> Tuple[_Replica, str]:
        live = self._live(routable=True)
        if not live:
            raise RuntimeError("no live replicas to route to")
        if self.replica_roles:
            # Disaggregated fleets admit at the prefill tier; when no
            # prefill replica survives, the decode fleet admits directly
            # and simply recomputes (roles never gate correctness).
            pre = [h for h in live
                   if self._role.get(h.rid) == "prefill"]
            if pre:
                live = pre
        if self.routing == "random":
            return live[int(self._rs.randint(len(live)))], "random"
        if self.routing == "least_loaded":
            return min(live, key=self._load), "least_loaded"
        key = self._affinity_key(req)
        if key is None:
            return min(live, key=self._load), "cold"
        target = self._rendezvous(key, live)
        least = min(live, key=self._load)
        if (self.spill_tokens is not None
                and target.engine.outstanding_tokens
                - least.engine.outstanding_tokens > self.spill_tokens):
            return least, "spill"
        return target, "affinity"

    def _route_decode(self, req: Request) -> Optional[_Replica]:
        """Pick the decode replica a migrated request lands on:
        rendezvous over the decode tier on the same affinity key (so
        shared-prefix streams co-locate and re-share store fills), cold
        prompts go least-loaded. None when no decode replica is live."""
        live = [h for h in self._live(routable=True)
                if self._role.get(h.rid) != "prefill"]
        if not live:
            return None
        key = self._affinity_key(req)
        if key is None:
            return min(live, key=self._load)
        return self._rendezvous(key, live)

    # -- admission ---------------------------------------------------------

    def _admission_reason(self, h: _Replica, now: float) -> Optional[str]:
        if h.engine.queue_depth >= self.max_queue_depth:
            return "queue_full"
        if (self.wait_watermark is not None
                and h.engine.oldest_wait_age(now) > self.wait_watermark):
            return "wait_watermark"
        return None

    def submit(self, req: Request) -> SubmitResult:
        """Route + admission-check one request. Accepted requests join
        the target replica's waiting queue; past-limit submits first
        shed to a live replica with room and otherwise come back as a
        structured reject — the queue is never unbounded."""
        self.stats["submitted"] += 1
        now = self._now()
        self._emit(req.rid, "submitted")
        target, routed = self._route(req)
        reason = self._admission_reason(target, now)
        if reason is not None:
            alts = [h for h in self._live(routable=True) if h is not target
                    and self._admission_reason(h, now) is None]
            if alts:
                target, routed, reason = min(alts, key=self._load), "spill", None
        if reason is not None:
            self.stats["rejected"] += 1
            self.stats[f"rejected_{reason}"] += 1
            self._emit(req.rid, "rejected", reason=reason)
            res = SubmitResult(
                accepted=False, reason=reason,
                queue_depth=target.engine.queue_depth,
                oldest_wait=target.engine.oldest_wait_age(now))
            self.submit_results[req.rid] = res
            return res
        self._sync_store_to(target, req)
        self._enqueue(target, req, routed)
        res = SubmitResult(
            accepted=True, replica=target.rid, routed=routed,
            queue_depth=target.engine.queue_depth,
            oldest_wait=target.engine.oldest_wait_age(now))
        self.submit_results[req.rid] = res
        return res

    def _enqueue(self, h: _Replica, req: Request, routed: str,
                 migration: Optional[dict] = None) -> None:
        self._emit(req.rid, "routed", replica=h.rid, policy=routed)
        ctx = self.tracer.events(req.rid) if self.tracer.enabled else None
        if migration is not None:
            h.engine.submit(req, trace=ctx, migration=migration)
        else:
            h.engine.submit(req, trace=ctx)
        h.routed[routed] = h.routed.get(routed, 0) + 1
        key = f"routed_{routed}"
        self.stats[key] = self.stats.get(key, 0) + 1
        # failover moves an accepted request; migrate re-admits one —
        # neither is a NEW acceptance.
        if routed not in ("failover", "migrate"):
            self.stats["accepted"] += 1

    def _sync_store_to(self, target: _Replica, req: Request) -> None:
        """Symmetric RPC fleets only: before a remote replica admits,
        push any leading prompt blocks the fleet has computed (per the
        kv_new catalog) but the target's local store lacks. In-process
        fleets get this for free from the one shared store object;
        disaggregated fleets share through the migration path instead.
        Opportunistic — a push failure just means recompute."""
        if self.replica_roles or not self._kv_catalog:
            return
        if not hasattr(target.engine, "kv_put"):
            return
        digs = [d for d in self._prompt_digests(req)
                if self._kv_catalog.get(d) not in (None, target.rid)]
        if not digs:
            return
        try:
            have = target.engine.kv_has(digs)
            for dig, got in zip(digs, have):
                if got:
                    continue
                holder = next(
                    (hh for hh in self._replicas
                     if hh.alive and hh.rid == self._kv_catalog[dig]
                     and hasattr(hh.engine, "kv_get")), None)
                if holder is None:
                    continue
                hit = holder.engine.kv_get(dig)
                if hit is not None and target.engine.kv_put(dig, hit[1]):
                    self._kv_catalog[dig] = target.rid
                    self.stats["store_synced_blocks"] += 1
        except (ReplicaDied, ValueError):
            # A dead side is settled by the next step/poll cycle; a
            # ValueError means the target can't take the push (torn
            # frame, mixed fleet). Either way the request is unaffected
            # (recompute is always correct).
            pass

    # -- cancellation ------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Cancel an accepted request wherever it currently lives. The
        request may have moved since submit (failover, shrink), so every
        live replica is asked; the one holding it retires it on the spot
        and frees its paged KV blocks — mid-prefill, mid-decode, or
        mid-speculation. Returns False for unknown, rejected, or
        already-terminal rids. A replica that dies during the cancel RPC
        is failed over (its requests move to survivors) and the scan
        restarts so the moved request is still found."""
        res = self.submit_results.get(rid)
        if res is None or not res.accepted:
            return False
        for _attempt in range(2):
            retry = False
            for h in list(self._replicas):
                if not h.alive:
                    continue
                try:
                    ok = h.engine.cancel(rid)
                except ReplicaDied:
                    self.stats["worker_deaths"] += 1
                    self.kill_replica(h.rid, reason="rpc_death")
                    retry = True
                    break
                if ok:
                    self.stats["cancelled"] += 1
                    self._drain_spans(h)
                    return True
            if not retry:
                break
        return False

    # -- failover ----------------------------------------------------------

    def kill_replica(self, rid: Optional[int] = None, *,
                     reason: str = "replica_kill") -> int:
        """Mark a replica dead and fail its queued + in-flight requests
        over to the survivors (admission limits do not apply — these
        requests were already accepted; shedding them now would break
        the submit-time contract). Default victim: the env override
        ``TPU_TRAINER_FAULT_REPLICA``, else the highest-id live replica
        (mirroring ``faults.target_host``'s highest-rank convention).
        ``reason`` tags the incident record/dump (replica_kill |
        worker_death | rpc_death). Returns the number of requests
        failed over."""
        live = self._live()
        if rid is None:
            raw = os.environ.get("TPU_TRAINER_FAULT_REPLICA")
            rid = int(raw) if raw is not None else max(h.rid for h in live)
        victims = [h for h in live if h.rid == rid]
        if not victims:
            raise ValueError(f"replica {rid} is not alive")
        if len(live) == 1:
            raise RuntimeError("cannot kill the last live replica")
        h = victims[0]
        orphans = h.engine.export_requests()
        self._drain_spans(h)   # capture export/terminal events pre-release
        h.alive = False
        h.engine.release()
        self.stats["failover_events"] += 1
        self.stats["failed_over_requests"] += len(orphans)
        self._dump_incident(reason, h.rid)
        for req in orphans:
            self._emit(req.rid, "failed_over", src=h.rid, reason=reason)
            target, _ = self._route(req)
            self._enqueue(target, req, "failover")
        return len(orphans)

    # -- resize ------------------------------------------------------------

    def grow(self, n: int = 1) -> int:
        """Add up to ``n`` replicas (bounded by ``max_replicas``).
        Returns how many were actually added."""
        added = 0
        while added < n and (self.max_replicas is None
                             or len(self._live()) < self.max_replicas):
            self._spawn_replica()
            added += 1
        self.stats["grows"] += added
        return added

    def shrink(self, n: int = 1) -> int:
        """Mark the ``n`` highest-id live replicas draining: excluded
        from routing immediately, waiting requests re-routed now,
        running requests finish in place; teardown happens in ``step``
        once the replica is idle. Never drains the last live replica."""
        done = 0
        while done < n and len(self._live(routable=True)) > 1:
            h = max(self._live(routable=True), key=lambda x: x.rid)
            h.draining = True
            orphans = h.engine.export_requests(waiting_only=True)
            self._drain_spans(h)
            for req in orphans:
                self._emit(req.rid, "failed_over", src=h.rid, reason="shrink")
                target, _ = self._route(req)
                self._enqueue(target, req, "failover")
            done += 1
        self.stats["shrinks"] += done
        return done

    def _probe_capacity(self) -> int:
        """Consume pending capacity grants into new replicas (the
        grant/consume protocol: a single agent grants, we consume)."""
        if not self.capacity_file:
            return 0
        room = ((self.max_replicas - len(self._live()))
                if self.max_replicas is not None else None)
        grant = read_capacity(self.capacity_file)
        take = grant if room is None else min(grant, max(0, room))
        if take <= 0:
            return 0
        consume_capacity(self.capacity_file, take)
        return self.grow(take)

    def _reap_draining(self) -> None:
        for h in self._replicas:
            if h.alive and h.draining and not h.engine.has_work():
                self._drain_spans(h)
                h.alive = False
                h.engine.release()
                self.stats["retired_replicas"] += 1

    # -- the per-iteration surface ----------------------------------------

    def step(self) -> List[Request]:
        """One front-end iteration: fire armed ``replica_kill`` /
        ``worker_kill`` / ``worker_hang`` / ``net_*`` faults, settle
        worker-process deaths into failover, probe the capacity file,
        reap drained replicas, then advance every live replica with
        work by one engine step. Returns the requests finished this
        iteration (all replicas); other terminal outcomes (cancelled,
        deadline_exceeded, failed) are counted into ``stats``."""
        self._iters += 1
        if faults.fire("replica_kill", self._iters):
            self.kill_replica()
        if faults.fire("worker_kill", self._iters):
            # A REAL kill: SIGKILL the worker process; the death is
            # settled and failed over through poll_deaths just below —
            # the exact path an unplanned worker death takes.
            if self._supervisor is None:
                raise RuntimeError(
                    "worker_kill fault armed but replicas are in-process")
            self._supervisor.sigkill()
        if faults.fire("worker_hang", self._iters):
            # A hang, not a death: SIGSTOP freezes the worker mid-
            # service. Nothing exits, so poll_deaths sees no exit code;
            # the next step RPC blocks until the per-call timeout, the
            # supervisor fences (SIGKILLs) the suspect, and the same
            # kill_replica failover resumes its streams — the stall is
            # bounded by the configured RPC timeout.
            if self._supervisor is None:
                raise RuntimeError(
                    "worker_hang fault armed but replicas are in-process")
            self._supervisor.sigstop()
        for kind in ("net_delay", "net_drop", "net_garble", "net_hang"):
            if faults.fire(kind, self._iters):
                self._arm_net_fault(kind)
        with self.ledger.track("host_sched"):
            self._settle_worker_deaths()
            if (self.capacity_file
                    and self._iters % self.capacity_probe_every == 0):
                self._probe_capacity()
            self._reap_draining()
        finished: List[Request] = []
        for h in self._replicas:
            if h.alive and h.engine.has_work():
                # An in-process replica step IS the device dispatch; a
                # remote one is time blocked on the step RPC reply.
                cat = ("dispatch" if isinstance(h.engine, LocalReplica)
                       else "rpc_wait")
                t_step = time.perf_counter()
                try:
                    with self.ledger.track(cat):
                        out = h.engine.step()
                except ReplicaDied:
                    # Died — or was fenced as hung — mid-RPC: any tokens
                    # the worker generated but never reported are simply
                    # re-generated on the survivor — sampling is keyed
                    # (seed, token_index), so the resumed stream is
                    # unchanged. The elapsed time on the failed call is
                    # the front-end's observable stall.
                    self._stall_samples.append(
                        time.perf_counter() - t_step)
                    self.stats["worker_deaths"] += 1
                    self.kill_replica(h.rid, reason="rpc_death")
                    continue
                self._drain_spans(h)
                for r in out:
                    if r.status == "finished":
                        h.finished += 1
                        finished.append(r)
                    else:
                        self.stats[r.status] += 1
                    self._observe_deadline(r)
        self.stats["finished"] += len(finished)
        with self.ledger.track("host_sched"):
            self._migrate_ready()
            self._catalog_update()
            self._sample_load()
            if (self._metrics_on
                    and self._iters % self.metrics_pull_every == 0):
                self.pull_metrics()
        if self.ts_interval and self._iters % self.ts_interval == 0:
            self._emit_ts()
        return finished

    # -- prefill -> decode migration ---------------------------------------

    def _migrate_ready(self) -> None:
        """Sweep prefill-role replicas for prefill-complete requests and
        move each to the decode tier: full prompt blocks travel digest-
        addressed through the store (shared object in-process, kv_put
        pushes cross-process), the sub-block tail rides the submit as a
        raw binary frame, and the decode replica admits with its cursor
        already past everything transferred. Admission prices every
        block against recompute — a declined transfer is recomputed,
        never wrong."""
        if not self.replica_roles:
            return
        for h in list(self._replicas):
            if not h.alive or self._role.get(h.rid) != "prefill":
                continue
            try:
                self._migrate_from(h)
            except ReplicaDied:
                # The prefill worker died mid-harvest (the chaos lane:
                # SIGKILL mid-migration). Whatever it still held —
                # extracted or not — fails over through the normal
                # export path and re-prefills on the survivors.
                self.stats["worker_deaths"] += 1
                self.kill_replica(h.rid, reason="rpc_death")

    def _migrate_from(self, h: _Replica) -> None:
        for rid in list(h.engine.migratable_rids()):
            out = h.engine.extract(rid)
            if out is None:
                continue
            req, payload = out
            payload = payload or {"tail_ntok": 0, "leaves": None}
            target = self._route_decode(req)
            if target is None:
                # No decode replica left: demote this prefill replica
                # and finish the stream in place — roles are a
                # performance shape, never a correctness dependency.
                self._demote(h)
                self._enqueue(h, req, "migrate", migration=payload)
                continue
            digs = self._prompt_digests(req)
            nbytes = (leaves_nbytes(payload["leaves"])
                      if payload.get("leaves") is not None else 0)
            if self.kv_store is not None:
                for dig in digs:
                    nbytes += int(self.kv_store.entry_nbytes(dig) or 0)
            try:
                nbytes += self._push_blocks(h, target, digs)
                self._emit(req.rid, "migrated", src=h.rid,
                           dst=target.rid, nbytes=nbytes)
                self._enqueue(target, req, "migrate", migration=payload)
            except ReplicaDied:
                # The DECODE side died mid-push/submit: settle it, then
                # hand the request to whatever is left via the failover
                # path (plain re-prefill — pushes are never load-bearing
                # for correctness).
                self.stats["worker_deaths"] += 1
                self.kill_replica(target.rid, reason="rpc_death")
                alt, _ = self._route(req)
                self._enqueue(alt, req, "failover")
                continue
            self.stats["migrations"] += 1
            self.stats["migrated_bytes"] += nbytes

    def _push_blocks(self, src: _Replica, dst: _Replica,
                     digs: List[bytes]) -> int:
        """Cross-process block transfer for one migration: pull each
        digest the target's store lacks from the source worker and push
        it. Returns bytes pushed. Raises ``ReplicaDied`` only for the
        DESTINATION; a source-side failure just truncates the pulls
        (the target recomputes what never arrived)."""
        if not digs or not hasattr(dst.engine, "kv_put"):
            return 0
        have = dst.engine.kv_has(digs)
        pulled = []
        try:
            for dig, got in zip(digs, have):
                if got:
                    continue
                hit = (src.engine.kv_get(dig)
                       if hasattr(src.engine, "kv_get") else None)
                if hit is not None:
                    pulled.append((dig, hit[1]))
        except ReplicaDied:
            pass
        nbytes = 0
        for dig, leaves in pulled:
            try:
                stored = dst.engine.kv_put(dig, leaves)
            except ValueError:
                # The target can't take pushes (no local store, torn
                # frame): it recomputes instead — pushes are never
                # load-bearing. Only ReplicaDied may escape this loop.
                break
            if not stored:
                continue
            self._kv_catalog[dig] = dst.rid
            nbytes += leaves_nbytes(leaves)
            self.stats["migration_pushed_blocks"] += 1
        return nbytes

    def _demote(self, h: _Replica) -> None:
        self._role[h.rid] = "decode"
        set_role = getattr(h.engine, "set_role", None)
        if set_role is not None:
            set_role(None)

    def _catalog_update(self) -> None:
        """Fold every replica's newly-stored digests (piggybacked on
        load snapshots) into the digest->holder catalog — the submit-
        time sync's map of who can serve a kv_get. The in-process shared
        store needs no catalog; its delta is drained and dropped so the
        list stays bounded."""
        if self.kv_store is not None:
            self.kv_store.drain_new_digests()
            return
        for h in self._replicas:
            if not h.alive:
                continue
            drain = getattr(h.engine, "drain_new_digests", None)
            if drain is None:
                continue
            for dig in drain():
                self._kv_catalog[dig] = h.rid

    def _arm_net_fault(self, kind: str) -> None:
        """Arm a one-shot transport fault on one replica's next RPC.
        Victim selection mirrors ``kill_replica``: the
        ``TPU_TRAINER_FAULT_REPLICA`` env override, else the highest-id
        live replica. In-process replicas have no transport to fault."""
        live = self._live()
        raw = os.environ.get("TPU_TRAINER_FAULT_REPLICA")
        rid = int(raw) if raw is not None else max(h.rid for h in live)
        victims = [h for h in live if h.rid == rid]
        if not victims:
            raise ValueError(f"replica {rid} is not alive")
        rep = victims[0].engine
        if not hasattr(rep, "inject_net_fault"):
            raise RuntimeError(
                f"{kind} fault armed but replica {rid} is in-process")
        rep.inject_net_fault(kind)

    def _observe_deadline(self, r: Request) -> None:
        if (r.deadline is not None and r.status != "cancelled"
                and r.finished_at is not None):
            self._deadline_margins.append(r.finished_at - r.deadline)

    def _settle_worker_deaths(self) -> None:
        if self._supervisor is None:
            return
        for rid in self._supervisor.poll_deaths():
            if any(h.rid == rid and h.alive for h in self._replicas):
                self.stats["worker_deaths"] += 1
                self.kill_replica(rid, reason="worker_death")

    def _sample_load(self) -> None:
        live = self._live()
        outs = [h.engine.outstanding_tokens for h in live]
        total = sum(outs)
        if outs and total > 0:
            imb = max(outs) / (total / len(outs))
            self.stats["imbalance_sum"] += imb
            self.stats["imbalance_samples"] += 1
            self.stats["imbalance_max"] = max(self.stats["imbalance_max"], imb)
        now = self._now()
        self._wait_samples.append(
            max((h.engine.oldest_wait_age(now) for h in live), default=0.0))

    def drain(self, max_iters: int = 10_000_000) -> List[Request]:
        """Step until every replica is idle; returns everything finished
        along the way."""
        finished: List[Request] = []
        while self.has_work():
            finished.extend(self.step())
            if self._iters >= max_iters:
                raise RuntimeError(
                    f"front-end did not drain in {max_iters} iters")
        self._reap_draining()
        self.pull_metrics()
        return finished

    # -- trace replay ------------------------------------------------------

    def run(self, requests: Sequence[Request], *,
            max_iters: int = 10_000_000) -> List[Request]:
        """Replay an open-loop trace (same contract as ``ServingEngine.
        run``): each request is SUBMITTED — routing + admission — when
        the clock passes its ``arrival_time``; rejected requests simply
        never finish (their ``SubmitResult`` is in ``submit_results``),
        and cancelled / deadline-expired requests are likewise absent
        from the return — their terminal state lives on the request
        object and in ``stats``. Returns the finished requests in
        input order."""
        pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        t_start = self.clock()
        if self.time_mode == "wall" and self._t0 is None:
            self._t0 = t_start
        done: List[Request] = []
        while pending or self.has_work():
            now = self._now()
            with self.ledger.track("host_sched"):
                while pending and pending[0].arrival_time <= now:
                    self.submit(pending.pop(0))
            if not self.has_work():
                if not pending:
                    break
                with self.ledger.track("idle"):
                    if self.time_mode == "wall":
                        time.sleep(min(
                            1e-3, max(0.0, pending[0].arrival_time - now)))
                    else:
                        self._iters += 1   # idle tick: step clock advances
                continue
            done.extend(self.step())
            if self._iters >= max_iters:
                raise RuntimeError(
                    f"front-end did not drain in {max_iters} iters")
        self._reap_draining()
        self.pull_metrics()
        self.wall_elapsed = self.clock() - t_start
        if self.ts_interval:
            self._emit_ts(final=True)
        # Span-conservation sweep: a drained run that still has open
        # timelines dropped a terminal event somewhere — freeze the
        # front-door ring so there is an artifact to debug from.
        if self.tracer.enabled and not self.tracer.conservation()["ok"]:
            self._dump_incident("drain_failure", -1)
        by_rid = {r.rid: r for r in done if r.status == "finished"}
        return [by_rid[r.rid] for r in requests if r.rid in by_rid]

    # -- telemetry ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """Fleet-level accounting. Conservation invariants (tested):
        ``accepted + rejected == submitted`` always, and ``accepted ==
        finished + cancelled + deadline_exceeded`` once drained —
        failover moves a request, it never duplicates or drops one, and
        every accepted request reaches exactly one terminal state."""
        s: Dict[str, object] = {
            k: v for k, v in self.stats.items()
            if not k.startswith("imbalance_")}
        live = self._live()
        s["replicas_live"] = len(live)
        s["replicas_total"] = len(self._replicas)
        s["in_flight"] = int(
            self.stats["accepted"] - self.stats["finished"]
            - self.stats["cancelled"] - self.stats["deadline_exceeded"]
            - self.stats["failed"])
        s["reject_rate"] = (
            self.stats["rejected"] / max(1, self.stats["submitted"]))
        # Load sums count every NON-DEAD replica, draining included — a
        # draining replica still runs its admitted work, so excluding it
        # would under-report fleet load while the all-replica token
        # counters below still count its tokens (pinned by test).
        loaded = [h for h in self._replicas if h.alive]
        s["queue_depth"] = sum(h.engine.queue_depth for h in loaded)
        s["outstanding_tokens"] = sum(
            h.engine.outstanding_tokens for h in loaded)
        n = max(1, int(self.stats["imbalance_samples"]))
        s["load_imbalance_mean"] = self.stats["imbalance_sum"] / n
        s["load_imbalance_max"] = self.stats["imbalance_max"]
        if self._wait_samples:
            s["wait_age_p50"] = float(np.percentile(self._wait_samples, 50))
            s["wait_age_p99"] = float(np.percentile(self._wait_samples, 99))
        hit = sum(h.engine.prefix_hit_tokens for h in self._replicas)
        prompt = sum(h.engine.prompt_tokens for h in self._replicas)
        gen = sum(h.engine.generated_tokens for h in self._replicas)
        s["prompt_tokens"] = prompt
        s["prefix_hit_tokens"] = hit
        s["prefix_hit_rate"] = hit / max(1, prompt)
        # Token-weighted across every replica, store-tier fills counted
        # (admission folds store hits into prefix_hit_tokens) — THE
        # fleet number the store exists to move: per-replica affinity
        # can only reach its local ceiling; "cached anywhere, hit
        # everywhere" pushes past it.
        s["fleet_prefix_hit_rate"] = hit / max(1, prompt)
        sh_host = sum(getattr(h.engine, "store_hit_tokens_host", 0)
                      for h in self._replicas)
        sh_disk = sum(getattr(h.engine, "store_hit_tokens_disk", 0)
                      for h in self._replicas)
        s["store_hit_tokens_host"] = int(sh_host)
        s["store_hit_tokens_disk"] = int(sh_disk)
        s["store_hit_tokens"] = int(sh_host + sh_disk)
        if self.kv_store is not None:
            for k, v in self.kv_store.stats().items():
                s[f"kv_store_{k}"] = v
        s["generated_tokens"] = gen
        s["iters"] = self._iters
        if self.wall_elapsed:
            s["wall_s"] = self.wall_elapsed
            s["tokens_per_s"] = gen / self.wall_elapsed
        s["per_replica"] = [
            {
                "replica": h.rid,
                "alive": h.alive,
                "draining": h.draining,
                "role": self._role.get(h.rid),
                "finished": h.finished,
                "routed": dict(h.routed),
                "generated_tokens": h.engine.generated_tokens,
                "prefix_hit_rate": (
                    h.engine.prefix_hit_tokens
                    / max(1, h.engine.prompt_tokens)),
                "store_hit_tokens": int(
                    getattr(h.engine, "store_hit_tokens_host", 0)
                    + getattr(h.engine, "store_hit_tokens_disk", 0)),
                "preemptions": h.engine.n_preemptions,
            }
            for h in self._replicas
        ]
        s["transport"] = ("rpc" if self._supervisor is not None
                          or any(not isinstance(h.engine, LocalReplica)
                                 for h in self._replicas)
                          else "inproc")
        s["worker_deaths"] = int(self.stats["worker_deaths"])
        if self.tracer.enabled:
            cons = self.tracer.conservation()
            s["span_events"] = len(self.tracer)
            s["span_conservation_ok"] = bool(cons["ok"])
            s["span_open"] = len(cons["open"])
            s["span_multi_terminal"] = len(cons["multi_terminal"])
        s["incidents"] = len(self.incidents)
        if self._stall_samples:
            s["stall_recovery_max_s"] = float(max(self._stall_samples))
        if self._supervisor is not None:
            s["fenced"] = int(getattr(self._supervisor, "n_fenced", 0))
        if self._deadline_margins:
            margins = np.asarray(self._deadline_margins)
            slack = np.maximum(margins, 0.0)
            s["deadline_miss_rate"] = float(np.mean(margins > 0))
            s["deadline_miss_slack_p50"] = float(np.percentile(slack, 50))
            s["deadline_miss_slack_p99"] = float(np.percentile(slack, 99))
        return s
