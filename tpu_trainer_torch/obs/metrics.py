"""Dependency-free metrics registry with Prometheus text exposition.

One ``MetricsRegistry`` per process half (serving front-end, training
loop, elastic supervisor, each serving worker). Components create
metric *families* — ``counter`` / ``gauge`` / ``histogram`` — and
either write them directly (``inc`` / ``set`` / ``observe``) or mirror
an existing cumulative stat via ``set_function`` (the value is read at
collection time, so the instrumented hot path pays nothing).

Design constraints, in order:

- **Zero cost when off.** Components take ``registry=None`` and fall
  back to ``NULL_REGISTRY``, whose metrics are shared no-op objects —
  an instrumentation site costs one attribute call and no allocation.
  Nothing here ever touches the device or the token streams.
- **Thread-safe.** One lock per registry guards every family/child
  mutation and the exposition walk; the HTTP scrape thread and the
  serve/train loop never see a torn histogram.
- **Mergeable.** ``snapshot()`` serializes a registry to a JSON-able
  dict (callbacks resolved to plain numbers) that crosses the worker
  RPC; ``merge(snapshot, extra_labels={"replica": "3"})`` folds it
  label-wise into an aggregating registry. Worker snapshots are
  cumulative, so a merge *overwrites* that labeled child — the newest
  snapshot is the truth for that source.

Exposition follows the Prometheus text format v0.0.4: ``# HELP`` /
``# TYPE`` headers, escaped label values, and per-histogram cumulative
``_bucket{le=...}`` series plus ``_sum`` / ``_count``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Fixed log-spaced latency buckets (seconds): 100 us .. 60 s, roughly
# 1-2.5-5 per decade. Fixed so every histogram in the fleet is
# mergeable bucket-for-bucket and dashboards never re-bin.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats render without the
    trailing ``.0`` (matches the reference client), infinities as
    ``+Inf``/``-Inf``."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


class _Child:
    """One (family, label-set) time series. Base for all three types."""

    def __init__(self, family: "_Family",
                 labels: Tuple[Tuple[str, str], ...]):
        self._family = family
        self._lock = family._lock
        self._labels = labels
        self._fn: Optional[Callable[[], float]] = None

    def set_function(self, fn: Callable[[], float]) -> "_Child":
        """Mirror an existing stat: ``fn`` is called at collection time
        and its value reported as this series' value. For counters the
        source must be monotone (mirror cumulative stats only)."""
        self._fn = fn
        return self


class Counter(_Child):
    """Monotonically non-decreasing cumulative count."""

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} < 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def labels(self, **kv) -> "Counter":
        return self._family.labels(**kv)


class Gauge(_Child):
    """A value that can go up and down."""

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def labels(self, **kv) -> "Gauge":
        return self._family.labels(**kv)


class Histogram(_Child):
    """Fixed-bucket histogram (counts kept per-bucket, rendered
    cumulative). Buckets come from the family and never change, so
    fleet-wide series merge bucket-for-bucket."""

    def __init__(self, family, labels):
        super().__init__(family, labels)
        self._counts = [0] * (len(family.buckets) + 1)  # +1: > last edge
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            edges = self._family.buckets
            while i < len(edges) and value > edges[i]:
                i += 1
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def labels(self, **kv) -> "Histogram":
        return self._family.labels(**kv)


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric: type, help text, and its labeled children."""

    def __init__(self, registry: "MetricsRegistry", name: str, typ: str,
                 help_text: str, labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.type = typ
        self.help = help_text
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple((ln, str(kv[ln])) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _CHILD_TYPES[self.type](self, key)
                self._children[key] = child
            return child

    def _default_child(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                f"use .labels(...)")
        return self.labels()


class MetricsRegistry:
    """Thread-safe home for a process's metric families."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # -- family constructors (idempotent per name) -------------------------

    def _family(self, name, typ, help_text, labelnames, buckets=()):
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != typ or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} re-registered as {typ}"
                        f"{labelnames} (was {fam.type}{fam.labelnames})")
                return fam
            fam = _Family(self, name, typ, help_text, labelnames,
                          tuple(buckets))
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()):
        fam = self._family(name, "counter", help_text, labelnames)
        return fam if fam.labelnames else fam._default_child()

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()):
        fam = self._family(name, "gauge", help_text, labelnames)
        return fam if fam.labelnames else fam._default_child()

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError(f"histogram {name}: no buckets")
        fam = self._family(name, "histogram", help_text, labelnames,
                           buckets)
        return fam if fam.labelnames else fam._default_child()

    # -- exposition --------------------------------------------------------

    def exposition(self) -> str:
        """The full registry in Prometheus text format v0.0.4."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if not fam._children:
                    continue
                if fam.help:
                    out.append(f"# HELP {name} {_escape_help(fam.help)}")
                out.append(f"# TYPE {name} {fam.type}")
                for key in sorted(fam._children):
                    child = fam._children[key]
                    if fam.type == "histogram":
                        cum = 0
                        for edge, n in zip(fam.buckets, child._counts):
                            cum += n
                            ls = _label_str(key + (("le", _fmt_value(edge)),))
                            out.append(f"{name}_bucket{ls} {cum}")
                        cum += child._counts[-1]
                        ls = _label_str(key + (("le", "+Inf"),))
                        out.append(f"{name}_bucket{ls} {cum}")
                        out.append(
                            f"{name}_sum{_label_str(key)} "
                            f"{_fmt_value(child._sum)}")
                        out.append(f"{name}_count{_label_str(key)} {cum}")
                    else:
                        out.append(
                            f"{name}{_label_str(key)} "
                            f"{_fmt_value(child.value)}")
        return "\n".join(out) + ("\n" if out else "")

    # -- snapshot / merge (the worker -> front-end path) -------------------

    def snapshot(self) -> dict:
        """JSON-able dump of every family: callbacks resolved, histogram
        state as plain lists. The worker RPC payload."""
        snap: Dict[str, dict] = {}
        with self._lock:
            for name, fam in self._families.items():
                samples = []
                for key, child in fam._children.items():
                    entry: dict = {"labels": dict(key)}
                    if fam.type == "histogram":
                        entry["counts"] = list(child._counts)
                        entry["sum"] = child._sum
                        entry["count"] = child._count
                    else:
                        entry["value"] = float(child.value)
                    samples.append(entry)
                snap[name] = {
                    "type": fam.type,
                    "help": fam.help,
                    "labelnames": list(fam.labelnames),
                    "buckets": list(fam.buckets),
                    "samples": samples,
                }
        return snap

    def merge(self, snap: dict,
              extra_labels: Optional[Dict[str, str]] = None) -> None:
        """Fold a ``snapshot()`` into this registry label-wise. Each
        merged series gains ``extra_labels`` (e.g. ``replica="3"``) and
        is OVERWRITTEN with the snapshot's cumulative state — snapshots
        from one source supersede their predecessors."""
        extra = {str(k): str(v) for k, v in (extra_labels or {}).items()}
        for name, fam_snap in snap.items():
            labelnames = tuple(fam_snap.get("labelnames", ())) + tuple(
                k for k in sorted(extra) if k not in
                fam_snap.get("labelnames", ()))
            fam = self._family(
                name, fam_snap["type"], fam_snap.get("help", ""),
                labelnames, tuple(fam_snap.get("buckets", ())))
            for entry in fam_snap.get("samples", ()):
                labels = dict(entry.get("labels", {}))
                labels.update(extra)
                child = fam.labels(**labels)
                with self._lock:
                    if fam.type == "histogram":
                        counts = list(entry.get("counts", ()))
                        if len(counts) != len(fam.buckets) + 1:
                            raise ValueError(
                                f"{name}: snapshot bucket count "
                                f"{len(counts)} != {len(fam.buckets) + 1}")
                        child._counts = [int(c) for c in counts]
                        child._sum = float(entry.get("sum", 0.0))
                        child._count = int(entry.get("count", 0))
                    else:
                        child._fn = None
                        child._value = float(entry.get("value", 0.0))


class _NullMetric:
    """Shared no-op metric: every write is a pass, ``labels`` returns
    itself. The zero-cost path for ``registry=None`` components."""

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def set_function(self, fn) -> "_NullMetric":
        return self

    def labels(self, **kv) -> "_NullMetric":
        return self

    @property
    def value(self) -> float:
        return 0.0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Registry stand-in when metrics are off: constructors hand back
    the shared no-op metric and exposition is empty."""

    def counter(self, name, help_text="", labelnames=()):
        return _NULL_METRIC

    def gauge(self, name, help_text="", labelnames=()):
        return _NULL_METRIC

    def histogram(self, name, help_text="", labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return _NULL_METRIC

    def exposition(self) -> str:
        return ""

    def snapshot(self) -> dict:
        return {}

    def merge(self, snap, extra_labels=None) -> None:
        pass


NULL_REGISTRY = NullRegistry()
