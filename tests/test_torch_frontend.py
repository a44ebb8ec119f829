"""Port parity: the multi-replica serving front-end
(``tpu_trainer_torch/serving/frontend.py``) against the JAX package's
``ServingFrontend``, both fleets in-process on the CPU, ``time_mode="steps"``.

Each scenario drives the same requests through the two fleets and holds
the port's to the JAX one's, exactly:
- every routing decision (affinity, cold, spill, random, least_loaded,
  failover, migrate) with its replica, and every reject with its reason,
  queue depth and wait age (``submit_results``);
- the ``summary()`` counts (accepted, rejected, finished, cancelled,
  deadline_exceeded, failovers, grows, shrinks, migrations and migrated
  bytes, prefix hits, the load and wait-age figures, per replica);
- every rid's status and span timeline (event names, times and
  attributes: the host-side decisions);
- greedy token streams.

The scenarios: shared-prefix affinity (and its coarse key), cold
prompts, a hot shard spilling, random and least-loaded routing, the
queue bound and the wait watermark (reject and shed), ``replica_kill``
failover mid-run and of queued and in-flight work, grow under a capacity
grant and shrink, cancel and deadlines, rejects with a failover, and
prefill -> decode roles migrating through the shared KV store.

Port-only: a killed replica's sampled streams equal one undisturbed
engine's; the metrics pull merges each replica's registry and the
front-door counters equal the summary; the incident dump; ``statusz``;
tensor-parallel replicas.

Tiny geometry of ``tests/test_frontend.py`` (vocab 128, hidden 32, 2
layers, f32, ``attention="reference"``, block 8), with
``initializer_range=0.2`` for greedy margins both frameworks keep; the
JAX weights cross over through ``save_params_npz`` and the port's loader.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.models.gpt import GPT as JGPT
from tpu_trainer.serving import frontend as jfront
from tpu_trainer.serving import remote as jremote
from tpu_trainer.serving import scheduler as jsched
from tpu_trainer.utils import faults as jfaults
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import from_jax_params, load_params_npz
from tpu_trainer_torch.obs.metrics import MetricsRegistry
from tpu_trainer_torch.serving import frontend as tfront
from tpu_trainer_torch.serving import scheduler as tsched
from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
from tpu_trainer_torch.utils import faults as tfaults
from tpu_trainer_torch.utils.preemption import grant_capacity, read_capacity

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, attention_dropout=0.0,
           dtype="float32", param_dtype="float32", initializer_range=0.2)
TCFG = TConfig(**CFG)
BLOCK = 8
ENGINE_KW = dict(block_size=BLOCK, attention="reference", prefix_cache=True,
                 max_batch=4)
# Wall-clock figures: never equal across two runs.
_WALL = {"wall_s", "tokens_per_s", "stall_recovery_max_s"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    params = JGPT(JConfig(**CFG)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("fe") / "params.npz")
    jremote.save_params_npz(path, jax.tree.map(np.asarray, params))
    return params, from_jax_params(load_params_npz(path), TCFG, device="cpu")


class _Side:
    """One package's front-end surface."""

    def __init__(self, port, params):
        self.port = port
        self.params = params
        self.front = tfront if port else jfront
        self.sched = tsched if port else jsched
        self.faults = tfaults if port else jfaults

    def fe(self, **kw):
        kw.setdefault("replicas", 2)
        kw.setdefault("routing", "affinity")
        kw.setdefault("time_mode", "steps")
        for k, v in ENGINE_KW.items():
            kw.setdefault(k, v)
        if self.port:
            return tfront.ServingFrontend(self.params, TCFG, device="cpu",
                                          **kw)
        return jfront.ServingFrontend(self.params, JConfig(**CFG), **kw)

    def req(self, rid, prompt, max_new=6, temperature=0.0, deadline=None):
        s = self.sched
        return s.Request(
            rid=rid, prompt=list(prompt), max_new_tokens=max_new,
            sampling=s.SamplingParams(temperature=temperature,
                                      seed=100 + rid),
            deadline=deadline)

    def prefix_requests(self, n, prefix_len=2 * BLOCK, tail=(4, 12),
                        max_new=6, groups=1, seed=0, temperature=0.0):
        """``tests/test_frontend.py``'s trace: ``groups`` shared
        full-block prefixes, random tails, a fresh RandomState a call."""
        rs = np.random.RandomState(seed)
        systems = [rs.randint(1, 128, size=prefix_len).tolist()
                   for _ in range(groups)]
        out = []
        for i in range(n):
            t = rs.randint(1, 128,
                           size=rs.randint(tail[0], tail[1] + 1)).tolist()
            out.append(self.req(i, systems[i % groups] + t, max_new=max_new,
                                temperature=temperature))
        return out


def _observe(fe, reqs, finished):
    """Everything two fleets must agree on after a scenario."""
    summ = {k: v for k, v in fe.summary().items() if k not in _WALL}
    subs = {rid: (r.accepted, r.replica, r.routed, r.reason, r.queue_depth,
                  float(r.oldest_wait))
            for rid, r in sorted(fe.submit_results.items())}
    spans = {rid: [{k: v for k, v in ev.items()} for ev in fe.tracer.events(
        rid)] for rid in fe.tracer.rids()}
    return {
        "submit": subs,
        "summary": summ,
        "status": {r.rid: r.status for r in reqs},
        "streams": {r.rid: list(r.generated) for r in finished},
        "spans": spans,
    }


# -- the scenarios: each gets a fresh side and returns _observe's dict ---------


def _affinity(side, tmp):
    fe = side.fe(replicas=3, spill_tokens=None)
    reqs = side.prefix_requests(8)
    for r in reqs:
        fe.submit(r)
    fin = fe.drain()
    assert len({fe.submit_results[r.rid].replica for r in reqs}) == 1
    return fe, reqs, fin


def _affinity_coarse(side, tmp):
    fe = side.fe(replicas=3, affinity_blocks=1)
    reqs = side.prefix_requests(6, prefix_len=BLOCK, tail=(9, 14))
    for r in reqs:
        fe.submit(r)
    return fe, reqs, fe.drain()


def _cold(side, tmp):
    fe = side.fe(replicas=2)
    reqs = [side.req(0, [1, 2, 3], max_new=4),
            side.req(1, [4, 5, 6], max_new=4)]
    for r in reqs:
        fe.submit(r)
    return fe, reqs, fe.drain()


def _spill(side, tmp):
    fe = side.fe(replicas=2, spill_tokens=20)
    reqs = side.prefix_requests(10, max_new=6)
    for r in reqs:
        fe.submit(r)
    fin = fe.drain()
    assert fe.summary()["routed_spill"] >= 1
    return fe, reqs, fin


def _random(side, tmp):
    fe = side.fe(replicas=3, routing="random", seed=7)
    reqs = side.prefix_requests(9, groups=3)
    return fe, reqs, fe.run(reqs)


def _least_loaded(side, tmp):
    fe = side.fe(replicas=3, routing="least_loaded")
    reqs = side.prefix_requests(9, groups=3)
    return fe, reqs, fe.run(reqs)


def _queue_full(side, tmp):
    fe = side.fe(replicas=2, max_queue_depth=2)
    reqs = side.prefix_requests(10)
    for r in reqs:
        fe.submit(r)
    fin = fe.drain()
    assert fe.summary()["rejected_queue_full"] == 6
    return fe, reqs, fin


def _wait_watermark(side, tmp):
    fe = side.fe(replicas=2, routing="least_loaded", wait_watermark=3.0)
    reqs = side.prefix_requests(2)
    for r in reqs:
        fe.submit(r)
    fe._iters = 10     # steps-mode clock: both queues are now 10 old
    late = side.req(99, list(range(1, 20)), max_new=4)
    res = fe.submit(late)
    assert res.reason == "wait_watermark"
    return fe, reqs + [late], fe.drain()


def _shed(side, tmp):
    fe = side.fe(replicas=2, max_queue_depth=2, spill_tokens=None)
    reqs = side.prefix_requests(4)
    for r in reqs:
        fe.submit(r)
    return fe, reqs, fe.drain()


def _replica_kill(side, tmp):
    reqs = side.prefix_requests(8, max_new=6)
    fe = side.fe(replicas=3)
    victim = fe._rendezvous(fe._affinity_key(reqs[0].prompt),
                            fe._live()).rid
    os.environ["TPU_TRAINER_FAULT_REPLICA"] = str(victim)
    try:
        with side.faults.plan("replica_kill@3"):
            fin = fe.run(reqs)
    finally:
        del os.environ["TPU_TRAINER_FAULT_REPLICA"]
    assert fe.summary()["failover_events"] == 1
    return fe, reqs, fin


def _kill_queued_and_running(side, tmp):
    fe = side.fe(replicas=2)
    reqs = side.prefix_requests(10, max_new=8)
    for r in reqs:
        fe.submit(r)
    victim = fe.submit_results[reqs[0].rid].replica
    for _ in range(2):
        fe.step()
    assert fe.kill_replica(victim) >= 1
    return fe, reqs, fe.drain()


def _grow_shrink(side, tmp):
    cap = str(tmp / f"capacity_{int(side.port)}.json")
    fe = side.fe(replicas=1, capacity_file=cap, max_replicas=3,
                 capacity_probe_every=1)
    grant_capacity(cap, 2)
    reqs = side.prefix_requests(6, groups=3)
    for r in reqs:
        fe.submit(r)
    fin = fe.drain()
    assert read_capacity(cap) == 0 and fe.summary()["grows"] == 2
    fe.shrink(2)
    fin += fe.drain()
    assert fe.summary()["retired_replicas"] == 2
    return fe, reqs, fin


def _shrink_reroute(side, tmp):
    fe = side.fe(replicas=2, routing="least_loaded")
    reqs = side.prefix_requests(12, max_new=6)
    for r in reqs:
        fe.submit(r)
    fe.step()
    fe.shrink(1)
    return fe, reqs, fe.drain()


def _cancel_deadline(side, tmp):
    fe = side.fe(prefix_cache=False)
    rs = np.random.RandomState(3)
    reqs = [side.req(100 + i, rs.randint(1, 128, size=20).tolist(),
                     max_new=10, deadline=4.0 if i == 2 else None)
            for i in range(6)]
    for r in reqs:
        fe.submit(r)
    for _ in range(2):
        fe.step()
    assert fe.cancel(101)
    assert not fe.cancel(12345)
    fin = fe.drain()
    s = fe.summary()
    assert s["cancelled"] == 1 and s["deadline_exceeded"] == 1
    assert s["accepted"] == s["finished"] + s["cancelled"] + 1
    return fe, reqs, fin


def _rejects_with_failover(side, tmp):
    fe = side.fe(replicas=3, max_queue_depth=3)
    reqs = side.prefix_requests(12, groups=3, max_new=6)
    with side.faults.plan("replica_kill@3"):
        fin = fe.run(reqs)
    s = fe.summary()
    assert s["rejected"] >= 1 and s["failover_events"] == 1
    assert s["finished"] == s["accepted"] == len(fin)
    return fe, reqs, fin


def _roles(side, tmp):
    fe = side.fe(replicas=3, replica_roles=["prefill", "decode"],
                 kv_store_bytes=8 << 20)
    reqs = side.prefix_requests(8, groups=2, max_new=6)
    fin = fe.run(reqs)
    assert fe.summary()["migrations"] >= 1
    return fe, reqs, fin


SCENARIOS = {f.__name__[1:]: f for f in (
    _affinity, _affinity_coarse, _cold, _spill, _random, _least_loaded,
    _queue_full, _wait_watermark, _shed, _replica_kill,
    _kill_queued_and_running, _grow_shrink, _shrink_reroute,
    _cancel_deadline, _rejects_with_failover, _roles)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_matches_jax(weights, name, tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_TRAINER_FAULT_REPLICA", raising=False)
    jparams, sd = weights
    want = _observe(*SCENARIOS[name](_Side(False, jparams), tmp_path))
    got = _observe(*SCENARIOS[name](_Side(True, sd), tmp_path))
    assert got["submit"] == want["submit"]
    assert got["status"] == want["status"]
    assert got["summary"] == want["summary"]
    assert got["streams"] == want["streams"]
    assert got["spans"] == want["spans"]
    assert got["summary"]["span_conservation_ok"] is True


# -- port-only ------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_killed_replica_streams_equal_one_engine(weights, temperature,
                                                 monkeypatch):
    """Failover re-prefills prompt + generated on a survivor and samples
    at the same (seed, token index): every stream is the undisturbed
    single engine's, greedy and sampled."""
    side = _Side(True, weights[1])
    eng = TEngine(weights[1], TCFG, device="cpu", **ENGINE_KW)
    base = {r.rid: list(r.generated) for r in eng.run(
        side.prefix_requests(8, temperature=temperature),
        time_mode="steps")}
    fe = side.fe(replicas=3)
    reqs = side.prefix_requests(8, temperature=temperature)
    victim = fe._rendezvous(fe._affinity_key(reqs[0]), fe._live()).rid
    monkeypatch.setenv("TPU_TRAINER_FAULT_REPLICA", str(victim))
    with tfaults.plan("replica_kill@3"):
        fin = fe.run(reqs)
    assert fe.summary()["failed_over_requests"] >= 1
    assert {r.rid: list(r.generated) for r in fin} == base


def test_metrics_pull_and_front_door_counters(weights):
    """Front-door counters mirror the summary; each replica's engine
    registry is pulled and merged under ``replica=N`` labels."""
    side = _Side(True, weights[1])
    reg = MetricsRegistry()
    fe = side.fe(registry=reg, metrics_pull_every=2)
    fe.run(side.prefix_requests(6, groups=2))
    s = fe.summary()
    series = {}
    for line in reg.exposition().splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            series[key] = float(val)
    assert series['frontend_requests_total{event="finished"}'] == \
        s["finished"] == 6
    assert series['frontend_replicas{state="live"}'] == 2
    gen = {k: v for k, v in series.items()
           if k.startswith("serve_generated_tokens_total{")}
    assert sorted(gen) == [
        f'serve_generated_tokens_total{{replica="{r}"}}' for r in (0, 1)]
    assert sum(gen.values()) == s["generated_tokens"]


def test_incident_dump_statusz_and_ready(weights, tmp_path, monkeypatch):
    side = _Side(True, weights[1])
    inc = str(tmp_path / "incidents")
    fe = side.fe(incident_dir=inc)
    reqs = side.prefix_requests(6)
    victim = fe._rendezvous(fe._affinity_key(reqs[0]), fe._live()).rid
    monkeypatch.setenv("TPU_TRAINER_FAULT_REPLICA", str(victim))
    with tfaults.plan("replica_kill@3"):
        fe.run(reqs)
    rec = fe.incidents[0]
    assert rec["kind"] == "incident" and rec["replica"] == victim
    with open(os.path.join(rec["dump_dir"], "crash_report.json")) as f:
        report = json.load(f)
    assert report["reason"] == "replica_kill"
    assert report["snapshot"]["replicas_total"] == 2
    assert any(r.get("event") for r in report["records"])
    st = fe.statusz()
    assert st["kind"] == "serving_frontend"
    assert [r["alive"] for r in st["replicas"]] == [
        h.rid != victim for h in fe._replicas]
    assert fe.ready()
    assert fe.summary()["span_conservation_ok"] is True


def test_tensor_parallel_fleet_is_refused(weights):
    """What a fleet refuses (an unknown routing, killing its last live
    replica), and what it no longer refuses: tensor-parallel replicas,
    each on its own mesh (``replica_device_sets``) or all at
    ``mesh_tensor``, serving the unsharded fleet's streams and routes."""
    side = _Side(True, weights[1])
    reqs = side.prefix_requests(6, groups=2)
    fe = side.fe()
    want = _observe(fe, reqs, fe.run(reqs))
    for kw in (dict(replica_device_sets=[[0, 1], [2, 3]]),
               dict(mesh_tensor=2)):
        reqs = side.prefix_requests(6, groups=2)
        fe = side.fe(**kw)
        got = _observe(fe, reqs, fe.run(reqs))
        assert got["streams"] == want["streams"]
        assert got["submit"] == want["submit"]
        assert [h.engine.engine.mesh.ids for h in fe._replicas] == (
            [(0, 1), (2, 3)] if "replica_device_sets" in kw
            else [(0, 1), (0, 1)])
    with pytest.raises(ValueError, match="routing"):
        side.fe(routing="round_robin")
    with pytest.raises(RuntimeError, match="last live"):
        side.fe(replicas=1).kill_replica()


def test_device_block_budget_sizes_the_pool(weights):
    eng = TEngine(weights[1], TCFG, device="cpu", device_block_budget=12,
                  **ENGINE_KW)
    assert eng.config.paged_num_blocks == 12
    assert torch.is_tensor(eng.device_cache["pool_k"])


# -- the fleet surface below the front-end -----------------------------------------


_TRACE_CASES = {
    "open_then_finished": [
        (0, "submitted", 0.0, {}), (0, "admitted", 1.0, {"queue_wait": 1.0}),
        (0, "first_token", 3.0, {}), (0, "finished", 5.0, {})],
    "double_terminal": [
        (1, "admitted", 0.0, {}), (1, "finished", 1.0, {}),
        (1, "cancelled", 2.0, {})],
    "rejected_and_exported": [
        (0, "submitted", 0.0, {}),
        (0, "rejected", 0.0, {"reason": "queue_full"}),
        (1, "admitted", 0.0, {}), (1, "exported", 1.0, {"generated": 2})],
    "open": [(2, "submitted", 0.5, {}),
             (2, "routed", 0.5, {"replica": 2, "policy": "affinity"})],
}


@pytest.mark.parametrize("case", list(_TRACE_CASES))
def test_tracer_matches_jax(case):
    """``SpanTracer`` emit / drain / ingest / conservation / rids / len and
    the ``span`` record (``phase_breakdown``) as the JAX tracer gives
    them; a non-pending ingest is never drained again."""
    from tpu_trainer.serving import tracing as jtr
    from tpu_trainer_torch.serving import tracing as ttr

    out = []
    for mod in (jtr, ttr):
        seen = []
        tr = mod.SpanTracer(on_event=seen.append)
        for rid, ev, t, attrs in _TRACE_CASES[case]:
            tr.emit(rid, ev, t, **attrs)
        delta = tr.drain()
        other = mod.SpanTracer()
        other.ingest(json.loads(json.dumps(delta)))
        out.append({
            "delta": delta, "drained_again": tr.drain(),
            "other": {rid: other.events(rid) for rid in other.rids()},
            "other_drain": other.drain(), "len": len(tr),
            "rids": tr.rids(), "cons": tr.conservation(), "seen": seen,
            "records": [mod.span_record(rid, tr.events(rid), lane="x")
                        for rid in tr.rids()]})
    assert out[1] == out[0]
    off = ttr.SpanTracer(enabled=False)
    off.emit(0, "submitted", 0.0)
    assert len(off) == 0 and off.drain() == [] and off.conservation()["ok"]


@pytest.mark.parametrize("waiting_only", [False, True])
def test_engine_export_requests_matches_jax(weights, waiting_only):
    """``export_requests`` after two steps with 6 requests on 4 slots: the
    same requests, in (arrival, rid) order, reset to waiting with their
    generated tokens, on both packages; the rest stays."""
    from tpu_trainer.serving.engine import ServingEngine as JEngine

    jparams, sd = weights
    got = []
    for side, eng in ((_Side(False, jparams), JEngine(
            jparams, JConfig(**CFG), **ENGINE_KW)),
            (_Side(True, sd), TEngine(sd, TCFG, device="cpu",
                                      **ENGINE_KW))):
        reqs = side.prefix_requests(6, max_new=8)
        for r in reqs:
            eng.scheduler.add(r)
        for _ in range(3):
            eng.step()
        out = eng.export_requests(waiting_only=waiting_only)
        got.append({
            "out": [(r.rid, r.status, r.slot, r.prefill_cursor,
                     list(r.generated)) for r in out],
            "left": sorted((r.rid, r.status) for r in
                           list(eng.scheduler.waiting)
                           + list(eng.scheduler.running)),
            "free": eng.cache_state.pool.free_blocks,
            "events": {r.rid: [e["event"] for e in eng.tracer.events(r.rid)]
                       for r in reqs}})
    assert got[1] == got[0]
    assert got[0]["out"]
