"""The port's cross-process serving fleet on the CPU: the worker RPC runtime
(``tpu_trainer_torch/serving/worker.py``), ``RemoteReplica`` and
``WorkerSupervisor`` (``serving/remote.py``) behind ``ServingFrontend``.

- The request wire codec gives the JAX codec's dicts, and each side
  decodes the other's; the RPC's per-call deadline tightens after the
  first step reply, a silent peer and the lethal ``net_*`` faults raise
  ``ReplicaDied``; exit codes and heartbeat flatlines are each reported
  once.
- Two real worker processes (``python -m tpu_trainer_torch.serving.worker``,
  engines on the CPU through the spec's ``device: "cpu"``) serve the
  streams of the in-process port fleet bitwise, greedy and sampled, with
  the same routing, token times and span timelines (one clock domain).
- The cancel verb and a deadline retire on the worker and the mirror; a
  torn frame closes the connection and the worker serves the next one; a
  real SIGKILL (``worker_kill``) and a SIGSTOP (``worker_hang``, fenced
  within the per-call timeout of 6 s) fail over with every stream the
  undisturbed fleet's; the metrics pull rides the RPC.
- A worker whose engine wants the card, on a host without one, exits
  non-zero before it serves.

One module-scoped supervisor with two prewarmed workers (``reset()``
between tests); the kill and hang drills each cost one new worker.
Workers and the in-process reference run one CPU thread each.
"""

import json
import os
import shutil
import socket
import struct
import tempfile
import time

import numpy as np
import pytest
import torch

from tpu_trainer.serving import remote as jremote
from tpu_trainer.serving import scheduler as jsched
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.weights import init_params
from tpu_trainer_torch.obs.metrics import MetricsRegistry
from tpu_trainer_torch.serving import remote
from tpu_trainer_torch.serving.frontend import ServingFrontend
from tpu_trainer_torch.serving.remote import (MAX_FRAME_BYTES, ReplicaDied,
                                              WorkerHandle, WorkerSupervisor,
                                              request_from_wire,
                                              request_to_wire, send_frame)
from tpu_trainer_torch.serving.scheduler import Request, SamplingParams
from tpu_trainer_torch.utils import faults
from tpu_trainer_torch.utils.flight_recorder import HeartbeatWriter

CFG = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                max_seq_len=64, dropout=0.0, attention_dropout=0.0,
                dtype="float32", param_dtype="float32",
                initializer_range=0.2)
BLOCK = 8
ENGINE_KW = dict(block_size=BLOCK, attention="reference", prefix_cache=True,
                 max_batch=4)
RPC_TIMEOUT_S = 6.0
ONE_THREAD = ["env", "OMP_NUM_THREADS=1", "MKL_NUM_THREADS=1"]


@pytest.fixture(scope="module")
def sd():
    return init_params(CFG, 0, device="cpu")


@pytest.fixture(scope="module")
def sup(sd):
    run_dir = tempfile.mkdtemp(prefix="ttw-")
    s = WorkerSupervisor(sd, CFG, engine_kwargs=dict(ENGINE_KW, device="cpu"),
                         run_dir=run_dir, rpc_timeout_s=RPC_TIMEOUT_S,
                         first_step_timeout_s=120.0,
                         launch_prefix=ONE_THREAD)
    s.prewarm(2)
    yield s
    s.close()
    shutil.rmtree(run_dir, ignore_errors=True)


def _requests(n=8, max_new=6, sampled=False, seed=0):
    """Two shared 2-block prefixes; odd rids sampled (temperature 0.8,
    top-p 0.9) when ``sampled``."""
    rs = np.random.RandomState(seed)
    systems = [rs.randint(1, 128, size=2 * BLOCK).tolist() for _ in range(2)]
    out = []
    for i in range(n):
        tail = rs.randint(1, 128, size=rs.randint(4, 12)).tolist()
        temp = 0.8 if (sampled and i % 2) else 0.0
        out.append(Request(
            rid=i, prompt=systems[i % 2] + tail, max_new_tokens=max_new,
            sampling=SamplingParams(temperature=temp, top_p=0.9,
                                    seed=100 + i)))
    return out


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _inproc(sd, reqs, **kw):
    """The in-process port fleet (the reference), one thread."""
    def run():
        fe = ServingFrontend(sd, CFG, replicas=2, time_mode="steps",
                             device="cpu", **ENGINE_KW, **kw)
        return fe, fe.run(reqs)
    return _one_thread(run)


def _rpc_fe(sd, sup, **kw):
    return ServingFrontend(sd, CFG, replicas=2, time_mode="steps",
                           replica_factory=sup, **kw)


def _streams(fin):
    return {r.rid: list(r.generated) for r in fin}


def _events(fe):
    return {rid: [{k: v for k, v in e.items() if k != "replica"}
                  for e in fe.tracer.events(rid)] for rid in fe.tracer.rids()}


# -- the wire, without processes ----------------------------------------------------


def test_request_wire_equals_jax_codec():
    kw = dict(rid=7, prompt=[5, 6, 7, 8], max_new_tokens=9, eos_id=3,
              arrival_time=1.5, deadline=17.5)
    t = Request(sampling=SamplingParams(temperature=0.7, top_k=5, top_p=0.9,
                                        seed=11), **kw)
    j = jsched.Request(sampling=jsched.SamplingParams(
        temperature=0.7, top_k=5, top_p=0.9, seed=11), **kw)
    for r in (t, j):
        r.generated = [1, 2]
        r.token_times = [2.0, 3.0]
        r.preemptions = 1
        r._blocks_registered = 1
        r._prompt_digests = [b"\x01" * 16]
    assert request_to_wire(t) == jremote.request_to_wire(j)
    back = request_from_wire(jremote.request_to_wire(j))
    assert request_to_wire(back) == request_to_wire(t)
    assert back._prompt_digests == [b"\x01" * 16]
    bare = request_from_wire(request_to_wire(
        Request(rid=4, prompt=[1], max_new_tokens=1)))
    assert bare.deadline is None


class _FakeProc:
    def __init__(self, rc=None):
        self.rc, self.pid = rc, 999999

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def _handle(**kw):
    a, b = socket.socketpair()
    return WorkerHandle(worker_id=0, proc=_FakeProc(), sock=a, **kw), a, b


def test_rpc_timeout_tightens_after_first_step():
    h, a, b = _handle(rpc_timeout_s=3.0, first_call_timeout_s=77.0)
    try:
        send_frame(b, {"id": 1, "ok": True, "result": {}})
        h.rpc("ping")
        assert a.gettimeout() == 77.0 and not h.first_step_done
        send_frame(b, {"id": 2, "ok": True,
                       "result": {"deltas": [], "load": {}}})
        h.rpc("step")
        send_frame(b, {"id": 3, "ok": True, "result": {}})
        h.rpc("ping")
        assert h.first_step_done and a.gettimeout() == 3.0
        send_frame(b, {"id": 4, "ok": False,
                       "error": {"type": "ValueError", "msg": "too long"}})
        with pytest.raises(ValueError, match="too long"):
            h.rpc("submit")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("kind", [None, "net_drop", "net_garble", "net_hang"])
def test_silent_peer_and_lethal_net_faults(kind):
    h, a, b = _handle(rpc_timeout_s=0.2, first_call_timeout_s=0.2)
    try:
        h.net_fault = kind
        t0 = time.perf_counter()
        with pytest.raises(ReplicaDied):
            h.rpc("ping")
        assert time.perf_counter() - t0 < 5.0
        assert h.net_fault is None
    finally:
        a.close()
        b.close()


def test_deaths_reported_once(tmp_path):
    s = WorkerSupervisor(None, None, run_dir=str(tmp_path / "r"),
                         heartbeat_timeout_s=0.5)
    dead = WorkerHandle(worker_id=0, proc=_FakeProc(rc=-9), sock=None, rid=0)
    wedged = WorkerHandle(worker_id=1, proc=_FakeProc(), sock=None, rid=1)
    fresh = WorkerHandle(worker_id=2, proc=_FakeProc(), sock=None, rid=2)
    s._handles = {0: dead, 1: wedged, 2: fresh}
    HeartbeatWriter(s.heartbeat_dir, host=1, min_interval_s=0.0).beat(0)
    time.sleep(0.8)
    HeartbeatWriter(s.heartbeat_dir, host=2, min_interval_s=0.0).beat(0)
    assert sorted(s.poll_deaths()) == [0, 1]
    assert wedged.proc.rc == -9          # the flatlined worker is settled
    assert s.poll_deaths() == []
    # Per-worker meshes ride the spec's top level (engine kwargs are
    # scalars on the wire): worker ``wid`` takes ``device_sets[wid % len]``.
    m = WorkerSupervisor(None, None, run_dir=str(tmp_path / "d"),
                         device_sets=[[0, 1], (2, 3)])
    with open(os.path.join(m.run_dir, "spec.json")) as f:
        assert json.load(f)["device_sets"] == [[0, 1], [2, 3]]


# -- the real fleet -----------------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True])
def test_rpc_fleet_equals_inproc_fleet(sd, sup, sampled):
    """Bitwise streams, the same routing, token times (integral: one
    front-end clock domain) and span timelines."""
    fe_in, fin_in = _inproc(sd, _requests(sampled=sampled))
    fe = _rpc_fe(sd, sup)
    fin = fe.run(_requests(sampled=sampled))
    s = fe.summary()
    assert _streams(fin) == _streams(fin_in)
    assert {r.rid: r.token_times for r in fin} == {
        r.rid: r.token_times for r in fin_in}
    assert all(t == int(t) for r in fin for t in r.token_times)
    assert {k: (v.replica, v.routed) for k, v in fe.submit_results.items()} \
        == {k: (v.replica, v.routed) for k, v in
            fe_in.submit_results.items()}
    assert _events(fe) == _events(fe_in)
    assert s["transport"] == "rpc" and s["worker_deaths"] == 0
    assert s["finished"] == s["accepted"] == len(fin) == 8
    assert s["span_conservation_ok"] is True
    sup.reset()


def test_cancel_verb_and_deadline_over_the_wire(sd, sup):
    fe = _rpc_fe(sd, sup)
    reqs = _requests(6, max_new=8)
    reqs[1].deadline = 2.0          # expires at iteration 3 on the worker
    for r in reqs:
        assert fe.submit(r).accepted
    for _ in range(3):
        fe.step()
    assert fe.cancel(reqs[2].rid)
    assert reqs[2].status == "cancelled"
    assert not fe.cancel(reqs[2].rid)
    fin = fe.drain()
    s = fe.summary()
    assert reqs[1].status == "deadline_exceeded"
    assert reqs[1].finished_at == 3.0
    assert {r.rid for r in fin} == {0, 3, 4, 5}
    assert s["cancelled"] == 1 and s["deadline_exceeded"] == 1
    assert s["accepted"] == s["finished"] + 2 and s["in_flight"] == 0
    assert s["deadline_miss_rate"] == 1.0
    assert s["span_conservation_ok"] is True
    sup.reset()


def test_torn_frame_closes_connection_not_worker(sup):
    h = sup._pool[0]
    path = os.path.join(sup.run_dir, f"w{h.worker_id}.sock")
    h.sock.close()      # free the worker's one serving loop
    h.sock = None
    try:
        for poison in (struct.pack(">I", MAX_FRAME_BYTES + 1) + b"x",
                       struct.pack(">I", 64) + b"torn",
                       struct.pack(">I", 4) + b"notj"):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(30.0)
            s.connect(path)
            s.sendall(poison)
            if poison.endswith(b"torn"):
                s.shutdown(socket.SHUT_WR)      # EOF mid-frame
            try:
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
            s.close()
    finally:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(60.0)
        s.connect(path)
        h.sock = s
    assert remote.rpc(s, 1, "ping", {}) == {}
    assert remote.rpc(s, 2, "hello", {})["pid"] == h.pid


def test_sigkill_failover_equals_undisturbed(sd, sup, tmp_path, monkeypatch):
    _, fin_in = _inproc(sd, _requests(sampled=True))
    fe = _rpc_fe(sd, sup, incident_dir=str(tmp_path / "inc"))
    victim = fe._rendezvous(fe._affinity_key(_requests()[0]), fe._live()).rid
    monkeypatch.setenv("TPU_TRAINER_FAULT_REPLICA", str(victim))
    with faults.plan("worker_kill@3"):
        fin = fe.run(_requests(sampled=True))
    s = fe.summary()
    assert _streams(fin) == _streams(fin_in)
    assert s["worker_deaths"] == 1 and s["failover_events"] == 1
    assert s["failed_over_requests"] >= 1 and s["replicas_live"] == 1
    assert s["finished"] == s["accepted"] == 8
    assert s["span_conservation_ok"] is True
    assert fe.incidents[0]["reason"] == "worker_death"
    assert os.path.exists(os.path.join(fe.incidents[0]["dump_dir"],
                                       "crash_report.json"))
    assert sup.live_worker_count() == 1
    sup.reset()


def test_hung_worker_fenced_within_timeout(sd, sup, monkeypatch):
    _, fin_in = _inproc(sd, _requests(sampled=True))
    fe = _rpc_fe(sd, sup)
    victim = fe._rendezvous(fe._affinity_key(_requests()[0]), fe._live()).rid
    monkeypatch.setenv("TPU_TRAINER_FAULT_REPLICA", str(victim))
    # Every worker past its first step, so the per-call timeout holds.
    for h in fe._replicas:
        h.engine.submit(Request(rid=900 + h.rid, prompt=[1, 2, 3],
                                max_new_tokens=1))
        while h.engine.has_work():
            h.engine.step()
        assert h.engine._handle.first_step_done
    fenced = sup.n_fenced
    with faults.plan("worker_hang@3"):
        fin = fe.run(_requests(sampled=True))
    s = fe.summary()
    assert _streams(fin) == _streams(fin_in)
    assert s["worker_deaths"] == 1 and s["fenced"] == fenced + 1
    assert RPC_TIMEOUT_S <= s["stall_recovery_max_s"] < RPC_TIMEOUT_S + 10.0
    assert s["finished"] == s["accepted"] == 8
    assert sup.live_worker_count() == 1
    sup.reset()


def test_metrics_pull_over_rpc(sd, sup):
    reg = MetricsRegistry()
    fe = _rpc_fe(sd, sup, registry=reg, metrics_pull_every=2)
    fe.run(_requests(6))
    s = fe.summary()
    got = 0.0
    for line in reg.exposition().splitlines():
        if line.startswith("serve_generated_tokens_total{"):
            assert 'replica="' in line
            got += float(line.rsplit(" ", 1)[1])
    assert got == s["generated_tokens"] > 0
    sup.reset()


def test_worker_without_cuda_exits_nonzero(sd, tmp_path):
    """Without ``device: "cpu"`` the engine wants the card: on a host
    without one the worker exits non-zero; it never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    s = WorkerSupervisor(sd, CFG, engine_kwargs=ENGINE_KW,
                         run_dir=tempfile.mkdtemp(prefix="ttc-"),
                         connect_timeout_s=60.0, launch_prefix=ONE_THREAD)
    try:
        with pytest.raises(RuntimeError, match="exited rc=1"):
            s.prewarm(1)
        with open(os.path.join(s.run_dir, "worker0.log")) as f:
            assert "CUDA is not available" in f.read()
    finally:
        s.close()
        shutil.rmtree(s.run_dir, ignore_errors=True)
