"""Crash flight recorder: last-N JSONL records + run snapshot on failure
(port of ``tpu_trainer/utils/flight_recorder.py``).

When a run dies — SIGTERM from the scheduler, a divergence that exhausts
its rollback budget, an unhandled exception — the JSONL on disk shows the
*emitted* history but not the run's identity (configs, device, env, torch
version) in one artifact. The flight recorder keeps a bounded in-memory
ring of every record the MetricLogger emits plus a one-time environment
snapshot, and dumps both as ``crash_report.json`` (atomic write) from the
SIGTERM/preemption/rollback/crash paths in ``run_training``. Postmortem =
one file. ``HeartbeatWriter`` writes one liveness beat a step when
``TPU_TRAINER_HEARTBEAT_DIR`` is set (``training/elastic.py``, the
supervisor, reads them).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Optional

from tpu_trainer_torch.utils.schema import SCHEMA_VERSION

_ENV_PREFIXES = ("CUDA", "NVIDIA", "TORCH", "PYTORCH", "NCCL", "TPU_TRAINER")


def env_snapshot(trainer=None, model_config=None, training_config=None,
                 argv=None) -> dict:
    """One-time run-identity snapshot: versions, devices, configs,
    accelerator-relevant env vars, argv. Everything best-effort — a
    snapshot field that fails to collect is omitted, never fatal."""
    snap: dict = {
        "python": sys.version.split()[0],
        "argv": list(argv) if argv is not None else sys.argv[1:],
        "env": {
            k: v for k, v in sorted(os.environ.items())
            if any(k.startswith(p) for p in _ENV_PREFIXES)
        },
    }
    try:
        import torch

        snap["torch_version"] = torch.__version__
        snap["cuda_version"] = torch.version.cuda
        device = getattr(trainer, "device", None)
        cuda = (device.type == "cuda" if device is not None
                else torch.cuda.is_available())
        snap["platform"] = "gpu" if cuda else "cpu"
        snap["device_kind"] = (torch.cuda.get_device_name(device) if cuda
                               else "cpu")
        snap["device_count"] = torch.cuda.device_count() if cuda else 1
        snap["process_index"] = 0
        snap["process_count"] = 1
    except Exception:
        pass
    if trainer is not None:
        try:
            snap["mesh"] = {}     # one device: no mesh axes
            snap["strategy"] = trainer.parallel_config.sharding_strategy
        except Exception:
            pass
    for name, cfg in (("model_config", model_config),
                      ("training_config", training_config)):
        if cfg is not None:
            try:
                snap[name] = dataclasses.asdict(cfg)
            except Exception:
                pass
    return snap


class FlightRecorder:
    """Bounded ring of emitted JSONL records + snapshot, dumpable on crash.

    Fed by ``MetricLogger(recorder=...)`` — every record that reaches the
    JSONL also lands here, so the ring IS the tail of the metrics stream
    (train/eval/goodput/telemetry/rollback alike).
    """

    def __init__(self, capacity: int = 256, snapshot: Optional[dict] = None):
        self.capacity = int(capacity)
        self.snapshot = snapshot or {}
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)

    def observe(self, record: dict) -> None:
        self._ring.append(record)

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, directory: str, *, reason: str,
             exc: Optional[BaseException] = None,
             step: Optional[int] = None) -> str:
        """Write ``crash_report.json`` under ``directory`` and return its
        path. Atomic (tmp + rename): a crash during the dump never leaves
        a torn report. Non-zero hosts write ``crash_report_host{k}.json``.
        The last dump of a run wins — later events overwrite earlier ones,
        which is the postmortem-relevant ordering."""
        from tpu_trainer_torch.parallel.mesh import process_index

        host = process_index()
        name = ("crash_report.json" if host == 0
                else f"crash_report_host{host}.json")
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, name)
        report: dict = {
            "kind": "crash_report",
            "schema_version": SCHEMA_VERSION,
            "reason": reason,
            "step": step,
            "written_unix": time.time(),
            "exception": _format_exc(exc),
            "snapshot": self.snapshot,
            "records": list(self._ring),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path


def _format_exc(exc: Optional[BaseException]) -> Optional[dict]:
    if exc is None:
        return None
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)),
    }


class HeartbeatWriter:
    """Per-host liveness beats for the elastic run supervisor.

    One JSONL file per host (``heartbeat_host{k}.jsonl`` — per-host files,
    so concurrent writers never interleave), one line per training step,
    plus an entry beat at loop start (``step == start_step``) so a host is
    live before its first multi-second compile::

        {"kind": "heartbeat", "host": k, "pid": ..., "step": n,
         "unix": t, "schema_version": ...}

    The supervisor (``training/elastic.py``) reads only the tail: a host
    whose newest beat is older than the heartbeat timeout is declared hung
    even though its process is still alive — the failure mode exit codes
    cannot catch. ``stop()`` freezes the stream without killing the process
    (what the ``hang_host`` chaos fault drives).

    Beats share the flight-recorder dump directory and record shape (same
    schema_version), so a recovery timeline reads straight out of the run
    dir: heartbeats flatline -> supervisor death record -> restart beats.
    ``min_interval_s`` throttles beat *writes* (a beat arriving inside the
    window is dropped); 0 writes every step.
    """

    def __init__(self, directory: str, *, host: int,
                 min_interval_s: float = 0.0,
                 recorder: Optional[FlightRecorder] = None,
                 start_step: Optional[int] = None):
        self.host = int(host)
        self.min_interval_s = float(min_interval_s)
        # start_step = the step this attempt resumed at: every beat carries
        # it so the supervisor can compute rolled-back work exactly
        # (last beat of the dead attempt minus the next attempt's
        # start_step) without having to catch the first beat in flight.
        self.start_step = None if start_step is None else int(start_step)
        self.path = os.path.join(
            directory, f"heartbeat_host{self.host:05d}.jsonl")
        self._recorder = recorder
        self._stopped = False
        self._last_write = 0.0
        os.makedirs(directory, exist_ok=True)

    def stop(self) -> None:
        """Freeze the beat stream (the hang_host fault): the process keeps
        running but looks dead to the supervisor's staleness check."""
        self._stopped = True

    def beat(self, step: int) -> None:
        if self._stopped:
            return
        now = time.time()
        if self.min_interval_s and now - self._last_write < self.min_interval_s:
            return
        self._last_write = now
        record = {
            "kind": "heartbeat",
            "schema_version": SCHEMA_VERSION,
            "host": self.host,
            "pid": os.getpid(),
            "step": int(step),
            "unix": now,
        }
        if self.start_step is not None:
            record["start_step"] = self.start_step
        if self._recorder is not None:
            self._recorder.observe(record)
        try:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(record) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            # Liveness reporting must never kill the run it reports on; a
            # beat lost to a transient FS error just looks like one slow
            # step to the supervisor.
            pass


def read_heartbeat(directory: str, host: int) -> Optional[dict]:
    """Newest beat of ``host``'s stream, or None before its first beat.
    Tail-read only — beat files grow unboundedly during long runs and the
    supervisor polls this every few hundred ms."""
    path = os.path.join(directory, f"heartbeat_host{host:05d}.jsonl")
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - 4096))
            lines = fh.read().splitlines()
    except OSError:
        return None
    for raw in reversed(lines):
        try:
            rec = json.loads(raw)
        except ValueError:
            continue  # torn tail line mid-write
        if isinstance(rec, dict) and rec.get("kind") == "heartbeat":
            return rec
    return None


def write_drain(directory: str, host: int, *, step: int, cause: str,
                deadline_unix=None) -> str:
    """Deregister ``host`` from the attempt: an atomic drain marker in the
    heartbeat directory, written by a proactively-draining host (preemption
    notice received) *before* it exits. The supervisor reads these to tell
    a planned departure (reform without this host, nobody crashed) from a
    crash (every other exit path). Per-attempt heartbeat dirs make the
    markers self-scoping, like the beats."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"drain_host{int(host):05d}.json")
    record = {
        "kind": "drain",
        "schema_version": SCHEMA_VERSION,
        "host": int(host),
        "pid": os.getpid(),
        "step": int(step),
        "cause": cause,
        "deadline_unix": deadline_unix,
        "unix": time.time(),
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        fh.write(json.dumps(record))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def read_drains(directory: str) -> list:
    """All drain markers of an attempt's heartbeat dir (sorted by host)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in sorted(names):
        if not (name.startswith("drain_host") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue  # torn marker: the atomic replace makes this transient
        if isinstance(rec, dict) and rec.get("kind") == "drain":
            out.append(rec)
    return out
