"""Deterministic fault injection for crash-safety testing (the port's copy
of ``tpu_trainer/utils/faults.py``: the same kinds, spec grammar and
``KILL_EXIT_CODE``; at one process the host-targeted kinds never act).

The fault-tolerance layer (exact data resume, divergence rollback,
checkpoint quarantine — see ``training/cli.py`` and ``utils/checkpoint.py``)
is only trustworthy if the failures it guards against can be produced on
demand. This module injects them at exact step numbers, driven either
programmatically (tests) or from the ``--inject_fault`` debug flag:

- ``nan_loss@N``      — report a NaN loss for step N (exercises the
  divergence-rollback loop without needing real numeric blowup).
- ``loss_spike@N``    — report a large-but-finite loss for step N
  (exercises the telemetry spike detector's early-warning path: rollback
  must engage *before* any NaN is ever logged).
- ``kill@N``          — hard-kill the process (``os._exit``) at the top of
  step N, before the step runs (a preemption that outran SIGTERM).
- ``kill_in_save@N``  — hard-kill *mid-checkpoint-save* at step N: after
  the state shards are written, before meta.json — leaving exactly the
  partial checkpoint a real crash leaves.
- ``truncate_meta@N`` — truncate the meta.json of the step-N checkpoint
  right after it is written (a torn metadata write).
- ``corrupt_shard@N`` — flip bytes in a state shard of the step-N
  checkpoint after the save completes (silent storage corruption).
- ``sigterm@N``       — deliver a real SIGTERM to this process at the top
  of step N (a preemption notice that DID arrive; exercises the
  ``--preemption_grace_s`` drain-and-final-checkpoint path through the
  actual signal handler).
- ``kill_host@N``     — chaos lane: hard-kill one chosen process of a
  multi-process run at step N (default: the highest rank; override with
  ``TPU_TRAINER_FAULT_HOST``). Other ranks keep running — the run
  supervisor must detect the death and reform the mesh.
- ``hang_host@N``     — chaos lane: the chosen process stops heartbeating
  at step N *without exiting* (a wedged host): only the supervisor's
  heartbeat timeout can catch it.
- ``preempt_notice@N`` — chaos lane: the chosen process receives a
  preemption *notice* (``utils/preemption.py``) at step N — the advance
  warning a real scheduler delivers before the kill. The trainer drains
  proactively: checkpoint at the next step boundary, deregister, exit
  clean — and the supervisor reforms before the simulated kill lands.
- ``replica_kill@N``  — chaos lane, serving tier: the multi-replica
  front-end (``serving/frontend.py``) marks one engine replica dead at
  front-end iteration N (default: the highest-id live replica; override
  with ``TPU_TRAINER_FAULT_REPLICA``). Its queued and in-flight requests
  must fail over to the survivors and finish token-identically.
- ``worker_kill@N``   — chaos lane, serving tier: like ``replica_kill``
  but CROSS-PROCESS — at front-end iteration N the worker supervisor
  (``serving/remote.WorkerSupervisor``) sends a real ``SIGKILL`` to one
  worker process (default: the highest-id live worker; override with
  ``TPU_TRAINER_FAULT_REPLICA``, same convention as ``replica_kill``).
  The death must be detected by exit code, and the front-end's mirror
  state must fail the worker's queued and in-flight requests over to
  the surviving processes bit-identically.
- ``worker_hang@N``   — chaos lane, serving tier: at front-end
  iteration N the worker supervisor ``SIGSTOP``\\ s one worker process
  (same victim convention as ``worker_kill``) — a hang, not a death:
  nothing exits and no exit code appears. The front-end's next step
  RPC must hit its per-call timeout, the supervisor must FENCE the
  suspect (SIGKILL, so it can never wake up and keep serving), and the
  standard failover must resume its streams bit-identically — with the
  front-end stall bounded by the configured RPC timeout.
- ``net_delay@N``     — chaos lane, serving tier: one replica's next
  RPC is delayed by ``TPU_TRAINER_NET_DELAY_MS`` milliseconds (default
  50) before being sent — transient network latency; the call must
  still succeed (no failover, just a slower iteration).
- ``net_drop@N``      — chaos lane, serving tier: one replica's next
  RPC tears its connection mid-frame (a length header with no body,
  then close) — the transport must surface ``ReplicaDied`` and the
  front-end must fail the replica over; the worker must survive the
  torn frame (it poisons only the connection).
- ``net_garble@N``    — chaos lane, serving tier: one replica's next
  RPC sends a well-framed but non-JSON payload — the worker must drop
  the poisoned connection (not crash), and the front-end must fail the
  replica over.
- ``net_hang@N``      — chaos lane, serving tier: one replica's next
  RPC sends nothing and waits for a response that never comes — the
  per-call timeout must bound the stall and drive the same fence +
  failover as ``worker_hang``.
- ``return_host@N``   — chaos lane: at step N rank 0 writes a capacity
  grant to the supervisor's capacity file (``TPU_TRAINER_CAPACITY_FILE``),
  simulating a preempted host coming back — the grow probe
  (``--allow_grow``) must re-expand the world.

The host-targeted kinds fire (consume) on every rank at step N but act
only on :func:`target_host`'s rank(s), so all ranks' plans stay in
lockstep. ``return_host`` is the opposite: it models the *cluster*
granting capacity, so it acts on rank 0 (and stays live at world 1, where
the host-targeted kinds go inert).

Each fault is one-shot: it fires at its step and is consumed, so a run that
rolls back or resumes past the step does not re-trip it — which is exactly
the recoverable-transient-failure model the rollback loop targets.

Faults install into process-global state (``install``/``clear``) because
the injection points are deep inside the checkpoint writer and the step
loop; tests must ``clear()`` in teardown (or use ``plan()`` as a context
manager).
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
from typing import List, Optional, Tuple

KINDS = frozenset(
    {"nan_loss", "loss_spike", "kill", "kill_in_save", "truncate_meta",
     "corrupt_shard", "sigterm", "kill_host", "hang_host",
     "preempt_notice", "return_host", "replica_kill", "worker_kill",
     "worker_hang", "net_delay", "net_drop", "net_garble", "net_hang"}
)

# Kinds that act on :func:`target_host`'s rank(s) only.
HOST_TARGETED_KINDS = frozenset({"kill_host", "hang_host", "preempt_notice"})

# Exit code for injected kills: mimics SIGKILL's 128+9, the way a preempted
# or OOM-killed trainer actually dies.
KILL_EXIT_CODE = 137

_SPEC_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<step>\d+)$")


class FaultPlan:
    """An ordered set of one-shot ``(kind, step)`` faults."""

    def __init__(self, faults: List[Tuple[str, int]]):
        for kind, step in faults:
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; choose from "
                    f"{sorted(KINDS)}"
                )
            if step < 0:
                raise ValueError(f"fault step must be >= 0, got {step}")
        self._pending = list(faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``"kind@step[,kind@step...]"`` (the --inject_fault syntax)."""
        faults = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad fault spec {part!r}; expected kind@step, e.g. "
                    f"nan_loss@25 (kinds: {sorted(KINDS)})"
                )
            faults.append((m.group("kind"), int(m.group("step"))))
        if not faults:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls(faults)

    def fire(self, kind: str, step: int) -> bool:
        """True (and consume the fault) if ``kind`` is armed for ``step``."""
        key = (kind, int(step))
        if key in self._pending:
            self._pending.remove(key)
            return True
        return False

    def pending(self) -> List[Tuple[str, int]]:
        return list(self._pending)


_active: Optional[FaultPlan] = None


def install(spec_or_plan, process_count: Optional[int] = None) -> FaultPlan:
    """Arm a fault plan process-wide (spec string or FaultPlan).

    When ``process_count`` is given and the plan contains host-targeted
    kinds, ``TPU_TRAINER_FAULT_HOST`` is validated here, once — a typo'd
    or out-of-range rank would otherwise make the fault silently never
    fire (it targets a rank that does not exist) and the chaos test it
    drives would "pass" by testing nothing."""
    global _active
    plan_obj = (spec_or_plan if isinstance(spec_or_plan, FaultPlan)
                else FaultPlan.parse(spec_or_plan))
    if process_count is not None and any(
            kind in HOST_TARGETED_KINDS for kind, _ in plan_obj.pending()):
        validate_target_host(process_count)
    _active = plan_obj
    return _active


def validate_target_host(process_count: int) -> None:
    """Fail fast on a bad ``TPU_TRAINER_FAULT_HOST`` value (non-integer or
    out-of-range rank). Single-process runs skip the range check — the
    host-targeted kinds are inert there by design (see target_host)."""
    raw = os.environ.get("TPU_TRAINER_FAULT_HOST")
    if raw is None or process_count < 2:
        return
    for part in raw.split(","):
        part = part.strip()
        try:
            rank = int(part)
        except ValueError:
            raise ValueError(
                f"TPU_TRAINER_FAULT_HOST={raw!r}: {part!r} is not an "
                f"integer rank")
        if not 0 <= rank < process_count:
            raise ValueError(
                f"TPU_TRAINER_FAULT_HOST={raw!r}: rank {rank} out of range "
                f"for a {process_count}-process run (valid: 0.."
                f"{process_count - 1})")


def clear() -> None:
    global _active
    _active = None


def active() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def plan(spec_or_plan):
    """``with faults.plan("nan_loss@3"):`` — install, then always clear."""
    install(spec_or_plan)
    try:
        yield _active
    finally:
        clear()


def fire(kind: str, step: int) -> bool:
    """Check-and-consume against the installed plan; no-op without one."""
    return _active is not None and _active.fire(kind, step)


def target_hosts(process_count: int) -> Tuple[int, ...]:
    """The rank(s) the host-targeted chaos faults (``kill_host``,
    ``hang_host``, ``preempt_notice``) act on: ``TPU_TRAINER_FAULT_HOST``
    (a rank or comma-list of ranks — two hosts dying in the same poll
    interval is a distinct supervisor drill from one) or the highest rank —
    deliberately non-zero by default, so the dying host is never the one
    that writes meta.json (killing host 0 is a different, stricter drill
    the env override enables). Returns () (matches no rank) when the run
    has a single process: there is no "non-zero process" to lose, and the
    supervisor's restarted shrunk run re-arms the same ``--inject_fault``
    spec — the fault must not kill the recovery it exists to test."""
    if process_count < 2:
        return ()
    raw = os.environ.get("TPU_TRAINER_FAULT_HOST")
    if raw is None:
        return (process_count - 1,)
    return tuple(int(p.strip()) for p in raw.split(",") if p.strip())


def targets_host(rank: int, process_count: int) -> bool:
    """True when a host-targeted fault firing at this step acts on ``rank``."""
    return rank in target_hosts(process_count)


def target_host(process_count: int) -> int:
    """First targeted rank, or -1 at world 1 (see target_hosts)."""
    hosts = target_hosts(process_count)
    return hosts[0] if hosts else -1


def kill(exit_code: int = KILL_EXIT_CODE) -> None:
    """Die the way a crash dies: no atexit, no finally, no flushing beyond
    what has already reached the OS. (stdio is flushed first so the test
    harness can still see the pre-crash log lines.)"""
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    finally:
        os._exit(exit_code)


def truncate_file(path: str) -> None:
    """Simulate a torn write: the file exists but holds nothing."""
    with open(path, "w"):
        pass


def corrupt_file(path: str, offset_fraction: float = 0.5) -> None:
    """Flip bytes mid-file — silent storage corruption, size unchanged."""
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = int(size * offset_fraction) % size
    with open(path, "r+b") as f:
        f.seek(pos)
        chunk = f.read(min(64, size - pos)) or b"\x00"
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))
