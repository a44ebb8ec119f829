"""Serving observability (port of ``tpu_trainer/serving/tracing.py``):
per-request span tracing and the serve-loop ledger. Host-side only:
enabling them cannot change a sampled token.

1. **SpanTracer** — per-rid lifecycle timelines in the engine clock
   domain::

       submitted -> routed(replica, policy) -> admitted(queue_wait,
       prefix_hit) -> prefill_chunk x N -> first_token -> spec_window
       (k, accepted) x M -> preempted / exported / failed_over / migrated
       -> finished | cancelled | deadline_exceeded | failed

   Events are plain dicts ``{"rid", "event", "t", ...attrs}``, so they
   cross the RPC wire as they are (``serving/remote.py`` ships them in
   submit payloads and on every reply) and the front-end merges each
   replica's delta (``drain`` there, ``ingest`` here) into one fleet
   timeline. Workers run their engine clock in the front-end's domain
   (``worker.py`` pins ``_t0 = 0`` and advances the clock from the
   shipped ``now``), so merged timestamps need no skew correction.

   The conservation check: every opened rid closes with exactly one
   terminal event, unless it was handed to another replica
   (``exported``) whose timeline continues it.

2. **ServingLedger** — wall-clock attribution of a serve loop into
   non-overlapping ``track()`` categories (dispatch, host_sched,
   rpc_wait, idle), stamped as ``kind: "serve_ts"`` records; the
   fractions sum to <= 1.0 and the rest is ``untracked_frac``.

``phase_breakdown`` / ``span_record`` turn one rid's events into the
``kind: "span"`` record the analyzer reads.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

from tpu_trainer_torch.utils.schema import SCHEMA_VERSION

# Terminal span events: one per accepted rid, mirroring the scheduler's
# TERMINAL_STATES — the conservation law checked at drain.
TERMINAL_EVENTS = frozenset(
    {"finished", "cancelled", "deadline_exceeded", "failed"})
# Events that open a timeline (submit at the front door, or admission
# for a bare engine driven without a front-end).
OPENING_EVENTS = frozenset({"submitted", "admitted"})
# The request left THIS tracer's replica for another one (failover /
# drain migration): the local timeline ends without a terminal event;
# the merged front-end timeline still owes exactly one.
HANDOFF_EVENTS = frozenset({"exported"})


class SpanTracer:
    """Per-rid span-event timelines (host-side, engine clock domain).

    ``emit()`` appends locally-produced events; ``ingest()`` merges
    events produced elsewhere (the RPC wire, a local replica's own
    tracer). Both feed ``on_event`` (the front-end hooks per-replica
    flight-recorder rings there) and the ``drain()`` buffer of
    not-yet-shipped events (the worker's step-delta stream).
    ``enabled=False`` turns ``emit`` into a no-op — the bit-identity
    escape hatch and the A/B for the "tracing is free" claim.
    """

    def __init__(self, on_event: Optional[Callable[[dict], None]] = None,
                 enabled: bool = True):
        self.enabled = bool(enabled)
        self.on_event = on_event
        self._events: Dict[object, List[dict]] = {}
        self._pending: List[dict] = []

    def emit(self, rid, event: str, t: float, **attrs) -> Optional[dict]:
        if not self.enabled:
            return None
        ev = {"rid": rid, "event": event, "t": float(t)}
        for k, v in attrs.items():
            if v is not None:
                ev[k] = v
        self._events.setdefault(rid, []).append(ev)
        self._pending.append(ev)
        if self.on_event is not None:
            self.on_event(ev)
        return ev

    def ingest(self, events, pending: bool = False) -> None:
        """Merge foreign events (already dicts) into the timelines in
        their arrival order. ``pending=True`` re-queues them for this
        tracer's own ``drain()`` consumers (relay topologies)."""
        for ev in events:
            ev = dict(ev)
            self._events.setdefault(ev.get("rid"), []).append(ev)
            if pending:
                self._pending.append(ev)
            if self.on_event is not None:
                self.on_event(ev)

    def drain(self) -> List[dict]:
        """Events emitted since the last drain (the wire delta)."""
        out, self._pending = self._pending, []
        return out

    def events(self, rid) -> List[dict]:
        return list(self._events.get(rid, ()))

    def rids(self) -> List[object]:
        return list(self._events)

    def __len__(self) -> int:
        return sum(len(v) for v in self._events.values())

    def reset(self) -> None:
        self._events.clear()
        self._pending.clear()

    # --- the conservation invariant -------------------------------------

    def conservation(self) -> dict:
        """Check every opened rid closed with exactly one terminal event.

        Rejected submissions never opened (backpressure is not a loss);
        an ``exported`` rid's obligation moved to the timeline that
        ingested it. Returns ``{"ok", "open", "multi_terminal",
        "rids"}`` — the categorical gate in analyze FAILs on ok=False.
        """
        open_rids, multi = [], []
        for rid, evs in self._events.items():
            kinds = [e.get("event") for e in evs]
            if "rejected" in kinds:
                continue
            if not any(k in OPENING_EVENTS for k in kinds):
                continue
            n_term = sum(1 for k in kinds if k in TERMINAL_EVENTS)
            if n_term > 1:
                multi.append(rid)
            elif n_term == 0 and not any(k in HANDOFF_EVENTS for k in kinds):
                open_rids.append(rid)
        return {
            "ok": not open_rids and not multi,
            "open": sorted(open_rids, key=str),
            "multi_terminal": sorted(multi, key=str),
            "rids": len(self._events),
        }


def phase_breakdown(events: List[dict]) -> Dict[str, float]:
    """Per-phase durations of one rid's timeline (seconds, engine clock).

    ``queue_wait`` is admission minus *arrival* (carried on the admitted
    event — a request can arrive before the loop first sees it, so
    submit-event time alone under-counts), ``prefill`` is admission to
    first token (chunk scheduling gaps included — that IS the phase),
    ``decode`` first token to the terminal event, ``total`` open to
    terminal.
    """
    t_of: Dict[str, float] = {}
    for ev in events:
        t_of.setdefault(ev.get("event"), float(ev.get("t", 0.0)))
    out: Dict[str, float] = {}
    for ev in events:
        if ev.get("event") == "admitted" and "queue_wait" in ev:
            out["queue_wait"] = float(ev["queue_wait"])
            break
    admitted = t_of.get("admitted")
    first = t_of.get("first_token")
    term = next((float(e["t"]) for e in events
                 if e.get("event") in TERMINAL_EVENTS), None)
    if admitted is not None and first is not None:
        out["prefill"] = max(0.0, first - admitted)
    if first is not None and term is not None:
        out["decode"] = max(0.0, term - first)
    if term is not None:
        start = t_of.get("submitted", admitted)
        if start is not None:
            out["total"] = max(0.0, term - start)
    return out


def span_record(rid, events: List[dict], *, lane: Optional[str] = None,
                replica=None) -> dict:
    """One schema-stamped JSONL record per rid: the raw event list plus
    the derived phase durations (``queue_wait_s``/``prefill_s``/...)
    so analyze can gate phases without re-deriving them."""
    rec = {
        "kind": "span",
        "schema_version": SCHEMA_VERSION,
        "rid": rid,
        "n_events": len(events),
        "events": list(events),
    }
    if lane is not None:
        rec["lane"] = lane
    if replica is not None:
        rec["replica"] = replica
    for name, secs in phase_breakdown(events).items():
        rec[f"{name}_s"] = round(secs, 6)
    return rec


class ServingLedger:
    """Wall-clock attribution for a serve loop (GoodputLedger's shape).

    Categories are tracked via non-overlapping ``with track(cat):``
    blocks, so the per-category fractions of elapsed time sum to
    <= 1.0 and the gap is ``untracked_frac``. ``dispatch_frac`` is the
    serving analogue of goodput's ``productive_frac`` — the share of
    wall clock spent inside the engine dispatch.
    """

    CATEGORIES = (
        # Engine work on the device: prefill/decode/verify dispatch + host sync
        # on the result (the "productive" share).
        "dispatch",
        # Host-side scheduling: admission, deadline sweeps, routing,
        # mirror bookkeeping.
        "host_sched",
        # Blocking on a worker RPC reply (cross-process fleets only).
        "rpc_wait",
        # Loop ticks with no runnable work (waiting on arrivals).
        "idle",
    )

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def track(self, category: str):
        t = self._clock()
        try:
            yield
        finally:
            self.add(category, self._clock() - t)

    def add(self, category: str, seconds: float) -> None:
        self._acc[category] = self._acc.get(category, 0.0) + seconds

    def seconds(self, category: str) -> float:
        return self._acc.get(category, 0.0)

    def total_seconds(self) -> float:
        return max(self._clock() - self._t0, 1e-9)

    def reset(self) -> None:
        self._t0 = self._clock()
        self._acc.clear()

    def record(self, gauges: Optional[dict] = None, *,
               final: bool = False) -> dict:
        """One ``kind:"serve_ts"`` sample: ledger fractions as of now
        plus the caller's as-of-now fleet gauges (merged in verbatim)."""
        total = self.total_seconds()
        tracked = sum(self._acc.values())
        rec = {
            "kind": "serve_ts",
            "schema_version": SCHEMA_VERSION,
            "total_seconds": total,
            "dispatch_frac": self._acc.get("dispatch", 0.0) / total,
            "untracked_frac": max(0.0, 1.0 - tracked / total),
        }
        if final:
            rec["final"] = True
        for cat in self.CATEGORIES:
            if cat in self._acc:
                rec[f"{cat}_seconds"] = self._acc[cat]
                rec[f"{cat}_frac"] = self._acc[cat] / total
        if gauges:
            rec.update(gauges)
        return rec
