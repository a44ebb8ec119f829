"""Serving observability (port of ``SpanTracer`` and ``ServingLedger`` from
``tpu_trainer/serving/tracing.py``). Host-side only: enabling them cannot
change a sampled token.

- ``SpanTracer``: per-rid lifecycle timelines in the engine clock domain
  (admitted -> prefill_chunk x N -> first_token -> spec_window x M ->
  preempted ... -> finished | cancelled | deadline_exceeded | failed, or
  exported to another engine), with the
  conservation check that every opened rid closes exactly once.
- ``ServingLedger``: wall-clock attribution of a serve loop into
  non-overlapping ``track()`` categories (dispatch, host_sched, rpc_wait,
  idle), stamped as ``kind: "serve_ts"`` records.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

# JSONL record schema version (tpu_trainer/utils/logging.py SCHEMA_VERSION),
# so the JAX package's analyzer reads the port's records as they are.
SCHEMA_VERSION = 1

TERMINAL_EVENTS = frozenset(
    {"finished", "cancelled", "deadline_exceeded", "failed"})
# A rid handed to another engine (``Scheduler.extract``): its obligation
# moved to the timeline that admits it next.
HANDOFF_EVENTS = frozenset({"exported"})


class SpanTracer:
    """Per-rid span-event timelines (host-side, engine clock domain).
    ``enabled=False`` turns ``emit`` into a no-op."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._events: Dict[object, List[dict]] = {}

    def emit(self, rid, event: str, t: float, **attrs) -> Optional[dict]:
        if not self.enabled:
            return None
        ev = {"rid": rid, "event": event, "t": float(t)}
        for k, v in attrs.items():
            if v is not None:
                ev[k] = v
        self._events.setdefault(rid, []).append(ev)
        return ev

    def events(self, rid) -> List[dict]:
        return list(self._events.get(rid, ()))

    def reset(self) -> None:
        self._events.clear()

    def conservation(self) -> dict:
        """Every opened rid closed with exactly one terminal event, or
        handed off."""
        open_rids, multi = [], []
        for rid, evs in self._events.items():
            kinds = [e.get("event") for e in evs]
            if "admitted" not in kinds:
                continue
            n_term = sum(1 for k in kinds if k in TERMINAL_EVENTS)
            if n_term > 1:
                multi.append(rid)
            elif n_term == 0 and not any(k in HANDOFF_EVENTS
                                         for k in kinds):
                open_rids.append(rid)
        return {
            "ok": not open_rids and not multi,
            "open": sorted(open_rids, key=str),
            "multi_terminal": sorted(multi, key=str),
            "rids": len(self._events),
        }


class ServingLedger:
    """Wall-clock attribution for a serve loop: per-category fractions of
    elapsed time sum to <= 1.0, the gap is ``untracked_frac``."""

    CATEGORIES = ("dispatch", "host_sched", "rpc_wait", "idle")

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

    def total_seconds(self) -> float:
        return max(self._clock() - self._t0, 1e-9)

    def reset(self) -> None:
        self._t0 = self._clock()
        self._acc.clear()

    def record(self, gauges: Optional[dict] = None, *,
               final: bool = False) -> dict:
        """One ``kind: "serve_ts"`` sample: ledger fractions as of now plus
        the caller's gauges."""
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
