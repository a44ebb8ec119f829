"""Elastic run supervisor (port of ``tpu_trainer/training/elastic.py``):
host-loss survival and recovery for multi-process training.

``python -m tpu_trainer_torch.training.elastic --num_processes N \\
    --run_dir DIR -- --config tiny.yaml --checkpoint_dir DIR/ckpt ...``

launches N trainer processes (``tpu_trainer_torch.training.train_ddp`` or
``train_fsdp`` by ``--mode``, over ``torch.distributed``: gloo on the CPU,
NCCL on CUDA, and gloo when the ranks outnumber the host's cards and so
share one, ``parallel/mesh.shares_card``), watches them, and keeps the
run alive through host loss:

1. **Launch**: each child gets ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/
   ``PROCESS_ID`` (the env rendezvous ``mesh.initialize_distributed``
   reads), ``COORDINATOR_TIMEOUT_S`` (which bounds the rendezvous and every
   collective, so a rank dead inside a gloo collective becomes an error on
   the survivors, not an endless wait), ``TPU_TRAINER_ATTEMPT`` (the
   two-phase checkpoint commit stamps DONE markers with it,
   ``utils/checkpoint._markers_complete``), ``TPU_TRAINER_CAPACITY_FILE``
   and ``TPU_TRAINER_HEARTBEAT_DIR`` pointing at this attempt's heartbeat
   directory (``training/cli.py`` writes one beat per completed step
   through ``utils/flight_recorder.py``). The children inherit the rest
   of the environment and the trainer flags, the device among them.
2. **Watch**: a host is declared dead on (a) nonzero exit — a crash, OOM
   kill, or preemption that outran its grace — or (b) heartbeat staleness
   past ``--heartbeat_timeout_s`` — a *hung* host that holds every rank's
   collectives hostage without exiting; of several stale hosts only the
   earliest flatline is blamed (``_check_deaths``). A host that received a
   preemption *notice* (``utils/preemption.py``) drains proactively —
   checkpoint at the step boundary, drain marker in the heartbeat dir,
   clean exit — and the supervisor reforms without anyone having crashed,
   rolling back zero steps.
3. **Reform down**: on any death the surviving processes are torn down too
   (they are blocked inside collectives with a dead peer), the world
   shrinks to the survivors, and the run relaunches, within
   ``--max_restarts`` and ``--min_processes``. Auto-resume restores the
   last *committed* checkpoint at the new world (every array is stored
   whole, the int8 moment packs as one process's) and the cursor remap
   (``remap_data_state``) re-bases the data stream onto the resized
   batch granularity.
4. **Reform up** (``--allow_grow``): the supervisor remembers the world it
   *wants* (``--num_processes``) and probes ``<run_dir>/capacity.json``
   (every ``--grow_probe_interval_s``) for re-granted hosts — written by an
   external cluster agent, or by the ``return_host`` chaos fault. On a
   grant it drains the running attempt gracefully (SIGTERM → the trainer's
   preemption path checkpoints at the next step boundary) and relaunches
   at the larger world.
5. **Standby hosts** (``--standby_hosts K``): K warm spares are spawned
   and parked *before* the rendezvous (interpreter and ``import torch``
   paid). A reform promotes parked spares into the new attempt's ranks by
   writing their activation files; the pool is replenished after every
   launch.

Every death/restart/grow writes JSONL records to
``<run_dir>/supervisor.jsonl``: ``kind:"host_death"``, ``kind:"recovery"``
(detection -> first post-restart beat, with ``rolled_back_steps`` and
standby promotion counts), ``kind:"world_grow"`` (grant detection -> first
beat at the larger world, ``grow_seconds``), a final
``kind:"elastic_summary"`` and a ``kind:"goodput"`` record —
``tools/analyze.py`` summarizes them and gates on recovery time,
restart count, grow time, and failure to regrow. ``--metrics_port``
serves the supervisor's ``elastic_*`` gauges and counters and its
``statusz`` (``obs/``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from tpu_trainer_torch.utils import flight_recorder as flight_lib
from tpu_trainer_torch.utils import preemption as preemption_lib
from tpu_trainer_torch.utils import telemetry as telemetry_lib
from tpu_trainer_torch.utils.schema import SCHEMA_VERSION


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def hold_standby(path: str, poll_interval_s: float = 0.05
                 ) -> Optional[Dict[str, str]]:
    """Child side of the standby protocol: park until the supervisor writes
    the activation file, then return its env (the same rendezvous env a
    fresh child would have been launched with). Returns None when the
    parent supervisor is gone — an orphaned spare must retire, not wait
    forever. Called by ``training/cli.py`` before the distributed
    rendezvous, because activation assigns coordinator/world/rank."""
    parent = os.getppid()
    while True:
        try:
            with open(path) as fh:
                data = json.load(fh)
            env = data.get("env") if isinstance(data, dict) else None
            if env:
                return {str(k): str(v) for k, v in env.items()}
        except (OSError, ValueError):
            pass  # not written yet (or mid-replace; atomic rename makes
            # this transient)
        if os.getppid() != parent:
            return None
        time.sleep(poll_interval_s)


class _Child:
    """One trainer process of the current attempt."""

    def __init__(self, host: int, proc: subprocess.Popen, log_path: str,
                 log_file):
        self.host = host
        self.proc = proc
        self.log_path = log_path
        self.log_file = log_file
        self.exited: Optional[int] = None  # exit code once reaped

    def poll(self) -> Optional[int]:
        if self.exited is None:
            rc = self.proc.poll()
            if rc is not None:
                self.exited = rc
                self.log_file.close()
        return self.exited


class _Standby:
    """A warm spare: spawned, imports paid, parked before the rendezvous."""

    def __init__(self, slot: int, proc: subprocess.Popen, file_path: str,
                 log_path: str, log_file):
        self.slot = slot
        self.proc = proc
        self.file_path = file_path  # activation file promotion writes
        self.log_path = log_path
        self.log_file = log_file

    def alive(self) -> bool:
        return self.proc.poll() is None


class Supervisor:
    """Launch/watch/reform loop around N trainer processes.

    ``trainer_argv`` is the child CLI (everything after ``--``); the
    supervisor owns ``--num_processes`` down to ``--min_processes`` and
    gives up after ``--max_restarts`` reforms (a deterministic crash would
    otherwise restart forever). With ``--allow_grow`` it also owns the way
    back up to ``--num_processes``.
    """

    def __init__(
        self,
        trainer_argv: List[str],
        *,
        num_processes: int,
        run_dir: str,
        mode: str = "ddp",
        max_restarts: int = 2,
        min_processes: int = 1,
        heartbeat_timeout_s: float = 30.0,
        startup_grace_s: float = 300.0,
        poll_interval_s: float = 0.2,
        coordinator_timeout_s: float = 60.0,
        term_grace_s: float = 5.0,
        allow_grow: bool = False,
        grow_probe_interval_s: float = 5.0,
        standby_hosts: int = 0,
        drain_grace_s: float = 60.0,
        death_settle_s: float = 1.0,
        env: Optional[Dict[str, str]] = None,
        metrics_port: Optional[int] = None,
    ):
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        self.trainer_argv = list(trainer_argv)
        self.world = int(num_processes)
        # The world this run WANTS. Shrinks are survival; with allow_grow
        # the supervisor keeps probing for the capacity to get back here.
        self.desired_world = int(num_processes)
        self.run_dir = os.path.abspath(run_dir)
        self.mode = mode
        self.max_restarts = int(max_restarts)
        self.min_processes = int(min_processes)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.poll_interval_s = float(poll_interval_s)
        self.coordinator_timeout_s = float(coordinator_timeout_s)
        # Child teardown: SIGTERM, then SIGKILL after this grace. Short by
        # default — by the time the supervisor tears a survivor down it is
        # wedged in a collective with a dead peer and its last committed
        # checkpoint is already durable — but a flag, because slow-FS CI
        # boxes need the log flush to finish before the SIGKILL.
        self.term_grace_s = float(term_grace_s)
        self.allow_grow = bool(allow_grow)
        self.grow_probe_interval_s = float(grow_probe_interval_s)
        self.standby_hosts = int(standby_hosts)
        # Graceful-drain budget: how long a SIGTERMed (grow) or noticed
        # (preempt) attempt gets to checkpoint and exit before SIGKILL.
        self.drain_grace_s = float(drain_grace_s)
        # Co-death coalescing: after the first death of a poll, wait this
        # long and re-check so two hosts dying in the same interval cost
        # one teardown + one restart, not two (and so a drain marker racing
        # its writer's exit status is classified as the drain it is).
        self.death_settle_s = float(death_settle_s)
        self._module = f"tpu_trainer_torch.training.train_{mode}"
        self.base_env = dict(os.environ if env is None else env)
        self.restarts = 0
        self.grows = 0
        self.attempt = 0
        self.promoted_total = 0
        self.ledger = telemetry_lib.GoodputLedger()
        os.makedirs(self.run_dir, exist_ok=True)
        self.events_path = os.path.join(self.run_dir, "supervisor.jsonl")
        self.capacity_path = os.path.join(self.run_dir, "capacity.json")
        self.standby_dir = os.path.join(self.run_dir, "standby")
        self._standbys: List[_Standby] = []
        self._standby_seq = 0
        self._last_promoted = 0
        self._refill_pending = False
        # Live metrics plane (obs/): the supervisor serves its own
        # endpoint — attempt/world/restart/grow/standby state as gauges
        # and counters mirrored off the attributes above (set_function:
        # read at scrape time, zero cost in the poll loop). The server
        # starts in run() and dies with it; metrics_port=None means no
        # registry work at all beyond no-op constructors.
        self.metrics_port = metrics_port
        self._metrics_server = None
        self._install_metrics()

    def _install_metrics(self) -> None:
        from tpu_trainer_torch.obs.metrics import (NULL_REGISTRY,
                                                   MetricsRegistry)

        self.registry = (MetricsRegistry() if self.metrics_port is not None
                         else NULL_REGISTRY)
        reg = self.registry
        reg.gauge("elastic_attempt", "Current attempt number"
                  ).set_function(lambda: self.attempt)
        world = reg.gauge("elastic_world", "Host world size",
                          labelnames=("kind",))
        world.labels(kind="current").set_function(lambda: self.world)
        world.labels(kind="desired").set_function(
            lambda: self.desired_world)
        reg.gauge("elastic_standbys", "Warm spares parked"
                  ).set_function(lambda: len(self._standbys))
        reg.counter("elastic_restarts_total", "Fault restarts"
                    ).set_function(lambda: self.restarts)
        reg.counter("elastic_grows_total", "World grow-backs"
                    ).set_function(lambda: self.grows)
        reg.counter("elastic_promotions_total", "Standby promotions"
                    ).set_function(lambda: self.promoted_total)
        reg.gauge("elastic_recovery_seconds_total",
                  "Wall-clock spent in fault recovery").set_function(
                      lambda: self.ledger.seconds("recovery"))
        reg.gauge("elastic_grow_seconds_total",
                  "Wall-clock spent in grow relaunches").set_function(
                      lambda: self.ledger.seconds("grow"))

    def statusz(self) -> dict:
        return {
            "kind": "elastic_supervisor",
            "attempt": self.attempt,
            "world": self.world,
            "desired_world": self.desired_world,
            "restarts": self.restarts,
            "grows": self.grows,
            "standbys": len(self._standbys),
            "standby_promotions": self.promoted_total,
            "allow_grow": self.allow_grow,
            "max_restarts": self.max_restarts,
            "run_dir": self.run_dir,
        }

    # --- plumbing -------------------------------------------------------

    def _log(self, msg: str) -> None:
        print(f"elastic | {msg}", flush=True)

    def _emit(self, record: dict) -> None:
        record = dict(record, schema_version=SCHEMA_VERSION, unix=time.time())
        with open(self.events_path, "a") as fh:
            fh.write(json.dumps(record) + "\n")
            fh.flush()

    def _hb_dir(self) -> str:
        # Per-attempt heartbeat directories: a stale beat file (or drain
        # marker) from the previous attempt must not trip the staleness
        # check (or satisfy the first-beat recovery probe) of the next one.
        return os.path.join(self.run_dir, "heartbeats",
                            f"attempt{self.attempt}")

    def _child_env(self, host: int, port: int, hb_dir: str) -> Dict[str, str]:
        env = dict(self.base_env)
        env["COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["NUM_PROCESSES"] = str(self.world)
        env["PROCESS_ID"] = str(host)
        # A peer that dies before the rendezvous must become an error
        # the survivors (and this loop) can see, not an infinite wait.
        env["COORDINATOR_TIMEOUT_S"] = str(int(self.coordinator_timeout_s))
        env["TPU_TRAINER_HEARTBEAT_DIR"] = hb_dir
        # DONE-marker stamp: a grown attempt re-saving a step dir must not
        # trust a prior same-world attempt's partial commit.
        env["TPU_TRAINER_ATTEMPT"] = str(self.attempt)
        env["TPU_TRAINER_CAPACITY_FILE"] = self.capacity_path
        env.pop("TPU_TRAINER_STANDBY_FILE", None)
        return env

    # --- standby pool ---------------------------------------------------

    def _spawn_standby(self) -> Optional[_Standby]:
        """One warm spare: same module + trainer argv, but parked by
        TPU_TRAINER_STANDBY_FILE before the rendezvous."""
        os.makedirs(self.standby_dir, exist_ok=True)
        slot = self._standby_seq
        self._standby_seq += 1
        file_path = os.path.join(self.standby_dir, f"standby{slot}.json")
        try:
            os.unlink(file_path)
        except OSError:
            pass
        env = dict(self.base_env)
        for key in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                    "TPU_TRAINER_HEARTBEAT_DIR", "TPU_TRAINER_ATTEMPT"):
            env.pop(key, None)
        env["TPU_TRAINER_STANDBY_FILE"] = file_path
        log_path = os.path.join(self.run_dir, f"standby{slot}.log")
        log_file = open(log_path, "w")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 self._module,
                 *self.trainer_argv],
                stdout=log_file, stderr=subprocess.STDOUT, env=env,
            )
        except OSError as e:
            log_file.close()
            self._log(f"standby spawn failed ({e}); continuing without")
            return None
        self._log(f"standby {slot}: parked warm spare (pid {proc.pid})")
        return _Standby(slot, proc, file_path, log_path, log_file)

    def _ensure_standbys(self) -> None:
        self._standbys = [s for s in self._standbys if s.alive()]
        while len(self._standbys) < self.standby_hosts:
            sb = self._spawn_standby()
            if sb is None:
                break
            self._standbys.append(sb)

    def _promote(self, host: int, port: int, hb_dir: str) -> Optional[_Child]:
        """Activate a parked spare as rank ``host`` of the new attempt: its
        cold-start (interpreter + imports) is already paid, so the attempt
        reaches the rendezvous sooner — the recovery_seconds cut standbys
        exist for."""
        while self._standbys:
            sb = self._standbys.pop(0)
            if not sb.alive():
                sb.log_file.close()
                continue
            activation = {"env": self._child_env(host, port, hb_dir)}
            tmp = sb.file_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(activation, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, sb.file_path)
            self._log(f"standby {sb.slot}: promoted to rank {host} "
                      f"(attempt {self.attempt})")
            return _Child(host, sb.proc, sb.log_path, sb.log_file)
        return None

    def _retire_standbys(self) -> None:
        for sb in self._standbys:
            if sb.alive():
                try:
                    sb.proc.terminate()
                except OSError:
                    pass
        for sb in self._standbys:
            try:
                sb.proc.wait(timeout=self.term_grace_s)
            except subprocess.TimeoutExpired:
                try:
                    sb.proc.kill()
                except OSError:
                    pass
                sb.proc.wait()
            sb.log_file.close()
        self._standbys = []

    # --- launch / teardown ----------------------------------------------

    def _launch(self) -> List[_Child]:
        port = _free_port()
        hb_dir = self._hb_dir()
        os.makedirs(hb_dir, exist_ok=True)
        children = []
        promoted = 0
        for host in range(self.world):
            child = self._promote(host, port, hb_dir)
            if child is not None:
                promoted += 1
                children.append(child)
                continue
            env = self._child_env(host, port, hb_dir)
            log_path = os.path.join(
                self.run_dir, f"host{host}_attempt{self.attempt}.log")
            log_file = open(log_path, "w")
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 self._module,
                 *self.trainer_argv],
                stdout=log_file, stderr=subprocess.STDOUT, env=env,
            )
            children.append(_Child(host, proc, log_path, log_file))
        self._last_promoted = promoted
        self.promoted_total += promoted
        self._log(f"attempt {self.attempt}: launched {self.world} "
                  f"process(es) ({promoted} promoted standby(s)), "
                  f"coordinator 127.0.0.1:{port}, heartbeats {hb_dir}")
        # Replenish the pool AFTER the launch so the next reform also finds
        # warm spares — but on a reform, not before the new attempt's first
        # beat: a fresh spare's interpreter+import startup would contend
        # with the relaunch it is supposed to be cheaper than, inflating
        # the very recovery window the promotion just shortened.
        if self.attempt == 0:
            self._ensure_standbys()
        else:
            self._refill_pending = True
        return children

    def _teardown(self, children: List[_Child],
                  grace_s: Optional[float] = None) -> None:
        grace_s = self.term_grace_s if grace_s is None else grace_s
        for c in children:
            if c.poll() is None:
                try:
                    c.proc.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + grace_s
        for c in children:
            if c.exited is not None:
                continue
            try:
                c.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    c.proc.kill()
                except OSError:
                    pass
                c.proc.wait()
            c.poll()

    def _await_exits(self, children: List[_Child], timeout_s: float) -> None:
        """Wait (bounded) for children that are exiting on their own — the
        coordinated drain path, where every host checkpoints and leaves."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(c.poll() is not None for c in children):
                return
            time.sleep(self.poll_interval_s)

    # --- death detection ------------------------------------------------

    def _check_deaths(self, children: List[_Child],
                      started: float) -> List[dict]:
        """Dead hosts this poll: nonzero exits plus heartbeat flatlines.

        Exit-based deaths are definitive. Staleness needs attribution: a
        single hung host stalls every survivor too (they block inside a
        collective with the silent peer and stop beating shortly after), so
        by detection time *several* beats may be stale. Blaming them all
        would shrink the world to nothing over one wedged host — so among
        stale hosts only the one whose stream flatlined FIRST is declared
        dead; the stalled survivors get a fresh start in the reformed run.
        """
        now = time.time()
        deaths = []
        stale = []
        for c in children:
            rc = c.poll()
            if rc is not None and rc != 0:
                deaths.append({"host": c.host, "cause": f"exit:{rc}",
                               "exit_code": rc})
                continue
            if rc is not None:
                continue  # clean exit: not a death, just done early/waiting
            beat = flight_lib.read_heartbeat(self._hb_dir(), c.host)
            if beat is None:
                if now - started > self.startup_grace_s:
                    deaths.append({"host": c.host, "cause": "startup_timeout",
                                   "exit_code": None})
            elif now - float(beat["unix"]) > self.heartbeat_timeout_s:
                stale.append((float(beat["unix"]),
                              {"host": c.host, "cause": "heartbeat_timeout",
                               "exit_code": None,
                               "step_last_beat": beat.get("step")}))
        if stale:
            deaths.append(min(stale, key=lambda t: t[0])[1])
        return deaths

    def _drain_deaths(self, children: List[_Child],
                      drains: List[dict]) -> List[dict]:
        """Classify a coordinated proactive drain: the noticed host(s) — the
        drain-marker writers — are the 'deaths' the world reforms without;
        peers exiting 143 alongside them are the planned pod-wide drain,
        not crashes. A peer that died some OTHER way in the same window
        (nonzero exit that is neither 143 nor a marker writer) is still a
        real death and is reported as one."""
        drained_hosts = {d["host"] for d in drains}
        deaths = [{"host": d["host"], "cause": d.get("cause",
                                                     "preempt_notice"),
                   "exit_code": None, "proactive": True,
                   "drain_step": d.get("step")}
                  for d in drains]
        for c in children:
            rc = c.poll()
            if (rc is not None and rc not in (0, 143)
                    and c.host not in drained_hosts):
                deaths.append({"host": c.host, "cause": f"exit:{rc}",
                               "exit_code": rc})
        return deaths

    def _first_beat(self) -> Optional[dict]:
        """Earliest beat of the current attempt — the first post-reform
        step, closing any pending recovery/grow windows. The beat record
        carries start_step (the step the attempt resumed at), which is what
        rolled-back accounting needs."""
        best = None
        for host in range(self.world):
            beat = flight_lib.read_heartbeat(self._hb_dir(), host)
            if beat is not None and (best is None
                                     or float(beat["unix"]) < best["unix"]):
                best = {"unix": float(beat["unix"]),
                        "start_step": beat.get("start_step")}
        return best

    def _last_beat_step(self) -> Optional[int]:
        """Newest completed-work watermark of the current attempt (max beat
        step across hosts), read before reforming away from it."""
        best = None
        for host in range(self.world):
            beat = flight_lib.read_heartbeat(self._hb_dir(), host)
            if beat is not None and beat.get("step") is not None:
                step = int(beat["step"])
                best = step if best is None else max(best, step)
        return best

    # --- the loop -------------------------------------------------------

    def run(self) -> int:
        pending: List[dict] = []  # reform windows awaiting the 1st new beat
        if self.metrics_port is not None:
            from tpu_trainer_torch.obs.http import MetricsServer

            self._metrics_server = MetricsServer(
                self.registry, port=self.metrics_port,
                statusz_fn=self.statusz)
            self._log(f"metrics: serving {self._metrics_server.url}/metrics")
        # The pool is first filled by _launch AFTER attempt 0 is up: the
        # first attempt's ranks gain nothing from spares (everyone is
        # equally cold), but every reform after it does.
        try:
            return self._run_loop(pending)
        finally:
            self._retire_standbys()
            if self._metrics_server is not None:
                self._metrics_server.close()
                self._metrics_server = None

    def _run_loop(self, pending: List[dict]) -> int:
        while True:
            started = time.time()
            children = self._launch()
            try:
                result = self._watch(children, started, pending)
                if result["outcome"] == "grow":
                    # Graceful drain: SIGTERM rides the trainer's preemption
                    # path — checkpoint at the step boundary, exit 143 — so
                    # the grown attempt resumes with zero lost steps.
                    self._teardown(children, grace_s=self.drain_grace_s)
            finally:
                self._teardown(children)
            # Windows that never saw a beat (the reformed attempt died
            # first) are superseded by the new reform's window.
            pending = []
            if result["outcome"] == "done":
                self._finish(0)
                return 0
            last_beat = self._last_beat_step()

            if result["outcome"] == "grow":
                target = result["target"]
                granted = target - self.world
                preemption_lib.consume_capacity(self.capacity_path, granted)
                self.grows += 1
                self.attempt += 1
                pending.append({
                    "kind": "world_grow",
                    "grow": self.grows,
                    "world_before": self.world,
                    "world_after": target,
                    "granted_hosts": granted,
                    "detected_unix": result["detected_unix"],
                    "step_last_beat": last_beat,
                })
                self.world = target
                self._log(f"capacity re-granted: growing to {target} "
                          f"host(s) (grow {self.grows})")
                continue

            deaths = result["deaths"]
            detected = result["detected_unix"]
            for d in deaths:
                self._emit(dict(d, kind="host_death", attempt=self.attempt,
                                detected_unix=detected))
                self._log(f"host {d['host']} dead ({d['cause']})")
            new_world = self.world - len(deaths)
            if self.restarts >= self.max_restarts:
                self._log(f"restart budget exhausted "
                          f"({self.restarts}/{self.max_restarts}); giving up")
                self._finish(1)
                return 1
            if new_world < self.min_processes:
                self._log(f"only {new_world} host(s) left "
                          f"(< min_processes={self.min_processes}); giving up")
                self._finish(1)
                return 1
            self.restarts += 1
            self.attempt += 1
            window = {
                "kind": "recovery",
                "restart": self.restarts,
                "world_before": self.world,
                "world_after": new_world,
                "dead_hosts": [d["host"] for d in deaths],
                "cause": deaths[0]["cause"],
                "proactive": bool(deaths[0].get("proactive")),
                "detected_unix": detected,
                "step_last_beat": last_beat,
            }
            # Returned capacity can rejoin at reform time too — a host that
            # came back while this attempt was dying need not wait for the
            # next grow probe.
            if self.allow_grow and new_world < self.desired_world:
                extra = min(self.desired_world - new_world,
                            preemption_lib.read_capacity(self.capacity_path))
                if extra > 0:
                    preemption_lib.consume_capacity(self.capacity_path, extra)
                    new_world += extra
                    window["regrown_at_reform"] = extra
                    self._log(f"reform absorbs {extra} re-granted host(s)")
            window["world_after"] = new_world
            pending.append(window)
            self.world = new_world
            self._log(f"reforming on {self.world} host(s) "
                      f"(restart {self.restarts}/{self.max_restarts})")

    def _close_windows(self, pending: List[dict]) -> None:
        first = self._first_beat()
        if first is None:
            return
        for win in pending:
            win = dict(win)
            detected = win.pop("detected_unix")
            seconds = max(0.0, first["unix"] - detected)
            last = win.pop("step_last_beat", None)
            rolled_back = None
            if last is not None and first.get("start_step") is not None:
                # Beats record step+1 after completing a step; start_step is
                # where the new attempt resumed. Work past the resume point
                # was re-done: a clean proactive drain scores exactly 0.
                rolled_back = max(0, int(last) - int(first["start_step"]))
            if win["kind"] == "world_grow":
                rec = dict(win, detected_unix=detected,
                           first_step_unix=first["unix"],
                           grow_seconds=seconds,
                           rolled_back_steps=rolled_back)
                self.ledger.add("grow", seconds)
                self._emit(rec)
                self._log(f"grew to {win['world_after']} host(s) in "
                          f"{seconds:.1f}s (rolled back "
                          f"{rolled_back if rolled_back is not None else '?'}"
                          f" step(s))")
            else:
                rec = dict(win, detected_unix=detected,
                           first_step_unix=first["unix"],
                           recovery_seconds=seconds,
                           rolled_back_steps=rolled_back,
                           promoted_standbys=self._last_promoted,
                           cold_starts=self.world - self._last_promoted)
                self.ledger.add("recovery", seconds)
                self._emit(rec)
                self._log(f"recovered in {seconds:.1f}s "
                          f"(restart {rec['restart']}, world "
                          f"{rec['world_before']}→{rec['world_after']}, "
                          f"{self._last_promoted} standby promotion(s))")
        pending.clear()

    def _watch(self, children: List[_Child], started: float,
               pending: List[dict]) -> dict:
        """Poll until every child exits cleanly (outcome "done"), a death or
        proactive drain is detected (outcome "death"), or — with
        --allow_grow below the desired world — a capacity grant is found
        (outcome "grow"). Also closes pending recovery/grow windows at the
        attempt's first heartbeat."""
        last_probe = time.monotonic()
        while True:
            if pending:
                self._close_windows(pending)
            if not pending and self._refill_pending:
                # The reformed attempt has beaten (or never had a window):
                # now it is safe to spend cycles warming fresh spares. An
                # attempt that dies before its first beat leaves the flag
                # set; the next reform simply finds fewer warm spares.
                self._ensure_standbys()
                self._refill_pending = False
            drains = flight_lib.read_drains(self._hb_dir())
            if drains:
                # Coordinated proactive drain: every host is checkpointing
                # and leaving on its own — let them, bounded.
                self._await_exits(children, self.drain_grace_s)
                return {"outcome": "death",
                        "deaths": self._drain_deaths(children, drains),
                        "detected_unix": time.time()}
            deaths = self._check_deaths(children, started)
            if deaths:
                # Settle window: collect co-dying hosts (one teardown + one
                # restart for two hosts lost in the same interval) and any
                # drain marker still in flight from an exiting host.
                time.sleep(self.death_settle_s)
                drains = flight_lib.read_drains(self._hb_dir())
                if drains:
                    self._await_exits(children, self.drain_grace_s)
                    return {"outcome": "death",
                            "deaths": self._drain_deaths(children, drains),
                            "detected_unix": time.time()}
                seen = {d["host"] for d in deaths}
                for d in self._check_deaths(children, started):
                    if d["host"] not in seen:
                        deaths.append(d)
                        seen.add(d["host"])
                return {"outcome": "death", "deaths": deaths,
                        "detected_unix": time.time()}
            if all(c.poll() is not None for c in children):
                # All zero (nonzero would have been a death above).
                return {"outcome": "done"}
            if (self.allow_grow and self.world < self.desired_world
                    and time.monotonic() - last_probe
                    >= self.grow_probe_interval_s):
                last_probe = time.monotonic()
                granted = preemption_lib.read_capacity(self.capacity_path)
                if granted > 0:
                    target = min(self.desired_world, self.world + granted)
                    self._log(f"grow probe: {granted} host(s) available, "
                              f"draining to relaunch at {target}")
                    return {"outcome": "grow", "target": target,
                            "detected_unix": time.time()}
            time.sleep(self.poll_interval_s)

    def _finish(self, exit_code: int) -> None:
        self._emit({
            "kind": "elastic_summary",
            "restarts": self.restarts,
            "grows": self.grows,
            "final_world": self.world,
            "desired_world": self.desired_world,
            "allow_grow": self.allow_grow,
            "standby_hosts": self.standby_hosts,
            "standby_promotions": self.promoted_total,
            "exit_code": exit_code,
            "recovery_seconds_total": self.ledger.seconds("recovery"),
            "grow_seconds_total": self.ledger.seconds("grow"),
        })
        self._emit(self.ledger.record(final=True))
        self._log(f"summary: {self.restarts} restart(s), {self.grows} "
                  f"grow(s), final world {self.world}/{self.desired_world}, "
                  f"recovery {self.ledger.seconds('recovery'):.1f}s + grow "
                  f"{self.ledger.seconds('grow'):.1f}s total")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_trainer_torch.training.elastic",
        description="Elastic run supervisor: launch N trainer processes, "
                    "watch heartbeats/exits, restart on the surviving host "
                    "set from the last committed checkpoint — and, with "
                    "--allow_grow, re-expand to the desired world when "
                    "capacity returns. Trainer flags go after '--'.",
    )
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--run_dir", type=str, required=True,
                   help="supervisor state: heartbeats, per-host logs, "
                        "capacity.json, supervisor.jsonl (the trainer's "
                        "--checkpoint_dir is its own flag, after '--')")
    p.add_argument("--mode", choices=["ddp", "fsdp"], default="ddp")
    p.add_argument("--max_restarts", type=int, default=2)
    p.add_argument("--min_processes", type=int, default=1)
    p.add_argument("--heartbeat_timeout_s", type=float, default=30.0)
    p.add_argument("--startup_grace_s", type=float, default=300.0,
                   help="allowance before the first beat of an attempt "
                        "(imports and the first step); only then does beat "
                        "absence count as a hang")
    p.add_argument("--poll_interval_s", type=float, default=0.2)
    p.add_argument("--coordinator_timeout_s", type=float, default=60.0)
    p.add_argument("--term_grace_s", type=float, default=5.0,
                   help="teardown grace between SIGTERM and SIGKILL — raise "
                        "on slow filesystems where children need longer to "
                        "flush logs")
    p.add_argument("--allow_grow", action="store_true",
                   help="re-expand toward --num_processes when "
                        "<run_dir>/capacity.json grants hosts back (written "
                        "by a cluster agent or the return_host fault)")
    p.add_argument("--grow_probe_interval_s", type=float, default=5.0,
                   help="seconds between capacity probes while running "
                        "below the desired world")
    p.add_argument("--standby_hosts", type=int, default=0,
                   help="warm spares parked before the rendezvous; reforms "
                        "promote them instead of paying process cold-start")
    p.add_argument("--drain_grace_s", type=float, default=60.0,
                   help="budget for a graceful drain (grow relaunch or "
                        "preemption notice) to checkpoint and exit before "
                        "SIGKILL")
    p.add_argument("--death_settle_s", type=float, default=1.0,
                   help="coalescing window after the first detected death "
                        "so same-interval co-deaths cost one restart")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve the supervisor's live /metrics + /healthz + "
                        "/statusz (attempt/world/restart/grow/standby "
                        "state) on this port; 0 = ephemeral")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        sup_argv, trainer_argv = argv[:split], argv[split + 1:]
    else:
        sup_argv, trainer_argv = argv, []
    args = build_parser().parse_args(sup_argv)
    sup = Supervisor(
        trainer_argv,
        num_processes=args.num_processes,
        run_dir=args.run_dir,
        mode=args.mode,
        max_restarts=args.max_restarts,
        min_processes=args.min_processes,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        startup_grace_s=args.startup_grace_s,
        poll_interval_s=args.poll_interval_s,
        coordinator_timeout_s=args.coordinator_timeout_s,
        term_grace_s=args.term_grace_s,
        allow_grow=args.allow_grow,
        grow_probe_interval_s=args.grow_probe_interval_s,
        standby_hosts=args.standby_hosts,
        drain_grace_s=args.drain_grace_s,
        death_settle_s=args.death_settle_s,
        metrics_port=args.metrics_port,
    )
    return sup.run()


if __name__ == "__main__":
    raise SystemExit(main())
