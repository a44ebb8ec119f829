"""Elastic training and the CLI's world > 1 hooks on gloo CPU ranks
(``tpu_trainer_torch/training/elastic.py`` and ``training/cli.py``),
mirroring ``tests/test_elastic.py``.

- Unit: the supervisor blames only the earliest heartbeat flatline, the
  child's environment, and ``hold_standby``.
- Subprocess, through the trainer CLI at world 2: one rank's SIGTERM
  makes every rank save ``"preempt"`` and exit 143 (the preemption vote,
  at its default interval), with int8 offload under ZeRO-3 and telemetry
  steps on; the resumed run ends bitwise where an undisturbed one ends;
  ``--nan_scan`` at world 2.
- Subprocess, through the supervisor (``python -m
  tpu_trainer_torch.training.elastic``): ``kill_host`` shrinks 2 -> 1 and
  resumes from the last committed checkpoint; ``hang_host`` is caught by
  the heartbeat timeout; ``return_host`` grows 1 -> 2; a
  ``preempt_notice`` drain reforms with a promoted standby and rolls back
  nothing. ``supervisor.jsonl`` reads in the port's ``tools/analyze.py``.

Every subprocess has its own timeout, far above its run time, and none
copies the JAX serving tests' 1.5 s RPC timeout. The trainers run the
tiny YAML of ``tests/test_elastic.py``; the rendezvous is a localhost TCP
port the supervisor (or the test) picks.
"""

import glob
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tpu_trainer_torch.training import elastic
from tpu_trainer_torch.utils import checkpoint as ckpt
from tpu_trainer_torch.utils import faults
from tpu_trainer_torch.utils import flight_recorder as flight_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_YAML = """
model:
  name: "gpt2-small"
  vocab_size: 128
  hidden_size: 32
  num_layers: 1
  num_heads: 2
  intermediate_size: 64
  max_seq_len: 32
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: false
training:
  batch_size: 2
  learning_rate: 1e-3
  max_steps: 8
  warmup_steps: 2
  log_interval: 1
  eval_interval: 0
  save_interval: 2
  seed: 0
data:
  dataset: "dummy"
"""


@pytest.fixture
def tiny_yaml(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "TPU_TRAINER_FAULT_HOST", "TPU_TRAINER_STANDBY_FILE"):
        env.pop(key, None)
    env.update(extra)
    return env


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def log_losses(path):
    """step -> loss parsed from a trainer log."""
    out = {}
    pat = re.compile(r"step\s+(\d+) \| loss ([0-9.a-z+-]+)")
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def all_log_losses(run_dir):
    losses = {}
    for p in sorted(glob.glob(os.path.join(str(run_dir), "host*_attempt*.log"))
                    + glob.glob(os.path.join(str(run_dir), "standby*.log"))):
        losses.update(log_losses(p))
    return losses


# -- unit ----------------------------------------------------------------------

class _FakeChild:
    def __init__(self, host, rc=None):
        self.host, self.rc = host, rc

    def poll(self):
        return self.rc


def _supervisor(tmp_path, **kw):
    return elastic.Supervisor(["--device", "cpu"], num_processes=3,
                              run_dir=str(tmp_path / "run"), env={}, **kw)


def test_only_the_earliest_flatline_is_blamed(tmp_path):
    """Host 2 stopped beating first; host 1's beats went stale after it
    (it waits in a collective with host 2); host 0 is fresh. One death:
    host 2. An exit code is a death of its own."""
    sup = _supervisor(tmp_path, heartbeat_timeout_s=5.0)
    hb = sup._hb_dir()
    os.makedirs(hb)
    now = time.time()
    for host, age in ((0, 0.5), (1, 20.0), (2, 30.0)):
        with open(os.path.join(hb, f"heartbeat_host{host:05d}.jsonl"),
                  "w") as f:
            f.write(json.dumps({"kind": "heartbeat", "host": host,
                                "step": 7 - host, "start_step": 0,
                                "unix": now - age}) + "\n")
    assert flight_lib.read_heartbeat(hb, 2)["step"] == 5
    deaths = sup._check_deaths([_FakeChild(h) for h in range(3)], now - 60)
    assert deaths == [{"host": 2, "cause": "heartbeat_timeout",
                       "exit_code": None, "step_last_beat": 5}]
    deaths = sup._check_deaths([_FakeChild(0, rc=137), _FakeChild(1),
                                _FakeChild(2)], now - 60)
    assert [(d["host"], d["cause"]) for d in deaths] == [
        (0, "exit:137"), (2, "heartbeat_timeout")]


def test_child_env_is_the_rendezvous_and_the_attempt(tmp_path):
    sup = _supervisor(tmp_path, coordinator_timeout_s=45.0)
    sup.base_env = {"KEEP": "1", "TPU_TRAINER_STANDBY_FILE": "/x"}
    sup.attempt = 3
    env = sup._child_env(1, 29501, "/hb")
    assert env == {
        "KEEP": "1", "COORDINATOR_ADDRESS": "127.0.0.1:29501",
        "NUM_PROCESSES": "3", "PROCESS_ID": "1",
        "COORDINATOR_TIMEOUT_S": "45", "TPU_TRAINER_HEARTBEAT_DIR": "/hb",
        "TPU_TRAINER_ATTEMPT": "3",
        "TPU_TRAINER_CAPACITY_FILE": os.path.join(sup.run_dir,
                                                  "capacity.json")}
    assert sup._module == "tpu_trainer_torch.training.train_ddp"


def test_hold_standby_waits_for_its_activation(tmp_path):
    """A torn activation file is not an activation; the written one's env
    comes back as strings."""
    path = str(tmp_path / "standby0.json")
    with open(path, "w") as f:
        f.write('{"env": {"PROCESS_ID"')

    def activate():
        time.sleep(0.2)
        with open(path + ".tmp", "w") as f:
            json.dump({"env": {"PROCESS_ID": 1, "NUM_PROCESSES": "2"}}, f)
        os.replace(path + ".tmp", path)
    t = threading.Thread(target=activate)
    t.start()
    got = elastic.hold_standby(path, poll_interval_s=0.01)
    t.join()
    assert got == {"PROCESS_ID": "1", "NUM_PROCESSES": "2"}


def test_supervisor_metrics_and_statusz(tmp_path):
    """The ``elastic_*`` gauges and counters (the JAX names) mirror the
    supervisor's state at scrape time; ``statusz`` names it."""
    sup = _supervisor(tmp_path, metrics_port=0, allow_grow=True)
    sup.attempt, sup.world, sup.restarts, sup.grows = 2, 1, 1, 1
    sup.ledger.add("recovery", 3.5)
    text = sup.registry.exposition()
    for line in ("elastic_attempt 2", 'elastic_world{kind="current"} 1',
                 'elastic_world{kind="desired"} 3',
                 "elastic_restarts_total 1", "elastic_grows_total 1",
                 "elastic_recovery_seconds_total 3.5"):
        assert line in text, line
    status = sup.statusz()
    assert status["kind"] == "elastic_supervisor"
    assert (status["attempt"], status["world"], status["desired_world"],
            status["allow_grow"]) == (2, 1, 3, True)


def test_parser_is_the_jax_supervisors():
    """The same flags and defaults as ``tpu_trainer.training.elastic``."""
    pytest.importorskip("jax")
    from tpu_trainer.training import elastic as jel

    def flags(parser):
        return {a.dest: (a.default, a.required) for a in parser._actions
                if a.dest != "help"}
    assert flags(elastic.build_parser()) == flags(jel.build_parser())


@pytest.mark.parametrize("env,cards,want", [
    ({}, 1, ((0, 1), False)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 1, ((1, 2), True)),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 2, ((1, 2), False)),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:5", "PROCESS_ID": "1",
      "NUM_PROCESSES": "2"}, 1, ((1, 2), True)),
    ({"COORDINATOR_ADDRESS": "10.0.0.7:5", "PROCESS_ID": "1",
      "NUM_PROCESSES": "2"}, 1, ((0, 1), False)),
    ({"COORDINATOR_ADDRESS": "localhost:5", "PROCESS_ID": "3",
      "NUM_PROCESSES": "4"}, 4, ((3, 4), False)),
])
def test_ranks_that_share_a_card_take_gloo(monkeypatch, env, cards, want):
    """A rank's local rank and its host's ranks; they share a card (and
    the group is gloo, not NCCL) when they outnumber the cards."""
    from tpu_trainer_torch.parallel import mesh

    for key in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "WORLD_SIZE",
                "COORDINATOR_ADDRESS", "PROCESS_ID", "NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(mesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: cards)
    assert (mesh.local_ranks(), mesh.shares_card()) == want
    assert mesh.local_device("cuda").index == want[0][0] % cards


# -- the CLI at world 2 ----------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, argv_of, mode="fsdp", timeout=240):
    """Both ranks of ``train_<mode>`` over a localhost rendezvous;
    ``argv_of(rank)`` is a rank's flags. Returns ``[(rc, output)]``."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"tpu_trainer_torch.training.train_{mode}",
         *argv_of(r)],
        env=_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                 PROCESS_ID=str(r), COORDINATOR_TIMEOUT_S="120"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _state_arrays(path):
    meta = ckpt.load_meta(path)
    return ckpt._state_arrays(path, meta), meta


def test_one_ranks_sigterm_makes_every_rank_save(tiny_yaml, tmp_path):
    """Rank 1 alone receives a SIGTERM at step 3. At the vote (every 10
    steps by default: after step 9) both ranks save ``"preempt"`` at step
    10 and exit 143; restarted, they finish at step 16 on exactly the
    state an undisturbed world-2 run ends on. ZeRO-3 with int8 host
    offload (straddling packs) and telemetry every 4 steps."""
    common = ["--config", tiny_yaml, "--device", "cpu", "--max_steps",
              "16", "--save_interval", "100", "--sharding", "FULL_SHARD",
              "--cpu_offload", "--offload_dtype", "int8",
              "--telemetry_interval", "4", "--guard_interval", "0"]
    # The undisturbed run and the cut one do not depend on each other: both
    # pairs of ranks run at once.
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_ranks, tmp_path, lambda r: common + [
            "--checkpoint_dir", str(tmp_path / "ref"), "--metrics_jsonl",
            str(tmp_path / "ref.jsonl")])
        cut = pool.submit(_run_ranks, tmp_path, lambda r: common + [
            "--checkpoint_dir", str(tmp_path / "cut")] + (
            ["--inject_fault", "sigterm@3"] if r == 1 else []))
        ref, cut = ref.result(), cut.result()
    assert [rc for rc, _ in ref] == [0, 0], ref
    assert [rc for rc, _ in cut] == [143, 143], cut
    assert "saved checkpoint (preempt)" in cut[0][1]
    saved = [s for s, _ in ckpt.list_checkpoints(str(tmp_path / "cut"))]
    assert saved == [10]
    done = _run_ranks(tmp_path, lambda r: common + [
        "--checkpoint_dir", str(tmp_path / "cut")])
    assert [rc for rc, _ in done] == [0, 0], done
    assert "resumed from" in done[0][1]
    got, meta = _state_arrays(str(tmp_path / "cut" / "step_00000016"))
    want, _ = _state_arrays(str(tmp_path / "ref" / "step_00000016"))
    assert meta["shard_world"] == 2
    assert set(got) == set(want)
    assert any(k.endswith("/q") for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    tel = [r for r in read_jsonl(tmp_path / "ref.jsonl")
           if "telemetry/grad_norm/per_layer/L00" in r]
    assert [r["step"] for r in tel] == [3, 7, 11, 15]


def test_nan_scan_at_world2(tiny_yaml, tmp_path):
    out = _run_ranks(tmp_path, lambda r: [
        "--config", tiny_yaml, "--device", "cpu", "--nan_scan",
        "--checkpoint_dir", str(tmp_path / "c")], mode="ddp")
    assert [rc for rc, _ in out] == [0, 0], out
    assert "nan_scan | no non-finite activations" in out[0][1]
    assert "nan_scan |" not in out[1][1]          # rank 0 prints


# -- the supervisor --------------------------------------------------------------

def run_supervisor(run_dir, tiny_yaml, *, num_processes=2, max_restarts=2,
                   heartbeat_timeout_s=30.0, trainer_args=(), timeout=300,
                   env_extra=None, **sup_kw):
    cmd = [sys.executable, "-m", "tpu_trainer_torch.training.elastic",
           "--num_processes", str(num_processes), "--run_dir", str(run_dir),
           "--max_restarts", str(max_restarts),
           "--heartbeat_timeout_s", str(heartbeat_timeout_s),
           "--startup_grace_s", "120", "--coordinator_timeout_s", "60",
           "--death_settle_s", "0.5"]
    for k, v in sup_kw.items():
        cmd += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    cmd += ["--", "--config", tiny_yaml, "--device", "cpu",
            "--checkpoint_dir", os.path.join(str(run_dir), "ckpt"),
            "--guard_interval", "0", *trainer_args]
    return subprocess.run(cmd, capture_output=True, text=True,
                          env=_env(**(env_extra or {})), timeout=timeout,
                          cwd=str(run_dir.parent))


def _analyze(path, *extra):
    return subprocess.run(
        [sys.executable, "-m", "tpu_trainer_torch.tools.analyze", str(path),
         "--compare", str(path), *extra],
        capture_output=True, text=True, env=_env(), timeout=120)


def test_kill_host_shrinks_and_resumes(tiny_yaml, tmp_path):
    """Rank 1 dies hard at step 5: the supervisor tears the survivor down,
    reforms at world 1, resumes from the committed step-4 checkpoint with
    the cursor remapped, and finishes; the losses cover every step."""
    run_dir = tmp_path / "run"
    r = run_supervisor(run_dir, tiny_yaml,
                       trainer_args=("--inject_fault", "kill_host@5"))
    assert r.returncode == 0, r.stdout + r.stderr
    events = read_jsonl(run_dir / "supervisor.jsonl")
    deaths = [e for e in events if e["kind"] == "host_death"]
    assert [(d["host"], d["cause"]) for d in deaths] == [
        (1, f"exit:{faults.KILL_EXIT_CODE}")]
    rec, = [e for e in events if e["kind"] == "recovery"]
    assert (rec["world_before"], rec["world_after"]) == (2, 1)
    assert rec["recovery_seconds"] >= 0 and rec["rolled_back_steps"] >= 0
    summary = [e for e in events if e["kind"] == "elastic_summary"][-1]
    assert summary["restarts"] == 1 and summary["exit_code"] == 0
    goodput = [e for e in events if e["kind"] == "goodput"]
    assert goodput[-1].get("recovery_seconds", 0) > 0
    log1 = (run_dir / "host0_attempt1.log").read_text()
    assert "resumed from" in log1
    assert ckpt.load_meta(str(run_dir / "ckpt" / "step_00000002"))[
        "shard_world"] == 2
    meta = ckpt.load_meta(str(run_dir / "ckpt" / "step_00000008"))
    assert meta["step"] == 8 and meta["data_state"]["feed_world"] == 1
    losses = log_losses(run_dir / "host0_attempt0.log")
    losses.update(log_losses(run_dir / "host0_attempt1.log"))
    assert set(range(8)) <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    ok = _analyze(run_dir / "supervisor.jsonl")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "PASS recovery_seconds_max" in ok.stdout
    assert "PASS elastic_restarts" in ok.stdout
    bad = _analyze(run_dir / "supervisor.jsonl", "--recovery-tol", "1e-9")
    assert bad.returncode == 1 and "FAIL recovery_seconds_max" in bad.stdout


def test_hang_host_caught_by_heartbeat_timeout(tiny_yaml, tmp_path):
    """A rank that stops beating without exiting: only the heartbeat
    timeout catches it, and only one death is blamed."""
    run_dir = tmp_path / "run"
    r = run_supervisor(run_dir, tiny_yaml, max_restarts=0,
                       heartbeat_timeout_s=3,
                       trainer_args=("--inject_fault", "hang_host@3",
                                     "--max_steps", "100000",
                                     "--save_interval", "100000",
                                     "--log_interval", "1000"))
    assert r.returncode == 1, r.stdout + r.stderr
    events = read_jsonl(run_dir / "supervisor.jsonl")
    deaths = [e for e in events if e["kind"] == "host_death"]
    assert len(deaths) == 1 and deaths[0]["cause"] == "heartbeat_timeout"
    # The hung rank stopped at step 3; the other beats on (its peer keeps
    # stepping with it), so the earliest flatline is rank 1's.
    assert deaths[0]["host"] == 1 and deaths[0]["step_last_beat"] == 3
    summary = [e for e in events if e["kind"] == "elastic_summary"][-1]
    assert summary["exit_code"] == 1 and summary["restarts"] == 0


def test_return_host_grows_back(tiny_yaml, tmp_path):
    """2 -> 1 (kill_host at step 5) -> 2 (return_host at step 6 of the
    shrunk attempt): the grow drains through the SIGTERM checkpoint and
    rolls back nothing; the last checkpoint is written at world 2."""
    run_dir = tmp_path / "run"
    r = run_supervisor(
        run_dir, tiny_yaml,
        trainer_args=("--inject_fault", "kill_host@5,return_host@6",
                      "--max_steps", "40", "--save_interval", "4"),
        allow_grow=True, grow_probe_interval_s=0.1)
    assert r.returncode == 0, r.stdout + r.stderr
    events = read_jsonl(run_dir / "supervisor.jsonl")
    rec, = [e for e in events if e["kind"] == "recovery"]
    assert (rec["world_before"], rec["world_after"]) == (2, 1)
    grow, = [e for e in events if e["kind"] == "world_grow"]
    assert (grow["world_before"], grow["world_after"]) == (1, 2)
    assert grow["grow_seconds"] >= 0 and grow["rolled_back_steps"] == 0
    summary = [e for e in events if e["kind"] == "elastic_summary"][-1]
    assert (summary["grows"], summary["final_world"],
            summary["exit_code"]) == (1, 2, 0)
    meta = ckpt.load_meta(str(run_dir / "ckpt" / "step_00000040"))
    assert meta["shard_world"] == 2
    losses = all_log_losses(run_dir)
    assert set(range(40)) <= set(losses)
    ok = _analyze(run_dir / "supervisor.jsonl")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "PASS grow_seconds_max" in ok.stdout
    assert "PASS elastic_regrow" in ok.stdout


def test_notice_drain_promotes_a_standby(tiny_yaml, tmp_path):
    """A preemption notice at step 4 on rank 1: every rank saves at the
    vote, rank 1 leaves a drain marker before the notice's deadline, and
    the reform promotes the parked spare (``TPU_TRAINER_STANDBY_FILE``)
    as rank 0 of world 1, rolling back no step."""
    run_dir = tmp_path / "run"
    r = run_supervisor(
        run_dir, tiny_yaml, standby_hosts=1,
        trainer_args=("--inject_fault", "preempt_notice@4",
                      "--preempt_vote_interval", "1",
                      "--preemption_grace_s", "60"))
    assert r.returncode == 0, r.stdout + r.stderr
    events = read_jsonl(run_dir / "supervisor.jsonl")
    death, = [e for e in events if e["kind"] == "host_death"]
    assert (death["host"], death["cause"], death["proactive"]) == (
        1, "fault:preempt_notice", True)
    drain, = flight_lib.read_drains(str(run_dir / "heartbeats" / "attempt0"))
    assert drain["host"] == 1 and drain["unix"] < drain["deadline_unix"]
    rec, = [e for e in events if e["kind"] == "recovery"]
    assert (rec["world_before"], rec["world_after"]) == (2, 1)
    assert rec["rolled_back_steps"] == 0 and rec["promoted_standbys"] == 1
    standby_log = (run_dir / "standby0.log").read_text()
    assert "standby: promoted to rank 0 (world 1)" in standby_log
    assert set(range(8)) <= set(all_log_losses(run_dir))
