"""Training telemetry (port of ``tpu_trainer/utils/telemetry.py``): in-step
stats, the goodput ledger, the loss-spike early warning, the deferred
metric fetch and the live-metrics bridge.

1. **In-step stats** — helpers the model and the trainer call on a
   telemetry step to compute per-layer gradient/parameter/update norms,
   activation RMS/absmax and MoE router health (load fractions, routing
   entropy, drop rate) on the device. Eager PyTorch has no second
   executable: a ``capture()`` block is active around the telemetry step's
   forward, model code checks ``capturing()`` and records its stats, and
   steps outside a capture compute none. The stats are taken under
   ``torch.no_grad()`` from detached tensors: they save nothing for the
   backward (so a checkpointed block's recompute sees the same saved
   tensors) and draw nothing from the step's generator. The trainer leaves
   the capture before the backward, so a remat rerun records nothing.

2. **Goodput ledger** — a host-side timer registry that attributes every
   wall-clock second of a run to compile, data-wait, step compute, eval,
   checkpoint save/restore, or rollback-replay. Tracked intervals are
   non-overlapping, so the attributed fractions always sum to <= 1.0 (the
   remainder is ``untracked``). ``productive_frac`` is the step-compute
   share.

3. **Loss-spike early warning** — a rolling median/MAD z-score over the
   logged loss; ``guards.LossSpikeError`` routes a spike into the CLI's
   rollback loop before any NaN appears.

4. **Deferred fetch** — each step's device metrics are copied to pinned
   host memory behind a CUDA event and read ``window`` steps later, so the
   host never waits on the step it just launched.
"""

from __future__ import annotations

import collections
import contextlib
import math
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# --- capture -----------------------------------------------------------------

_STACK: List["_Capture"] = []


class _Capture:
    def __init__(self, deep: bool = False):
        self.deep = deep
        self.stats: Dict[str, object] = {}


@contextlib.contextmanager
def capture(deep: bool = False):
    """Activate telemetry collection for model code run in this block.

    ``deep=True`` additionally enables sites that cost memory (the full
    f32 logits, which the fused head + CE loss never forms). Only the
    nan-scan debug forward asks for those; periodic telemetry steps never
    do.
    """
    c = _Capture(deep=deep)
    _STACK.append(c)
    try:
        yield c
    finally:
        _STACK.pop()


def capturing(deep: bool = False) -> bool:
    """True while a ``capture()`` block is active. ``capturing(deep=True)``
    is True only inside a ``capture(deep=True)``."""
    if not _STACK:
        return False
    return _STACK[-1].deep if deep else True


def record(name: str, value) -> None:
    """Stash a (dict of) tensor(s) under ``name`` in the active capture."""
    if _STACK:
        _STACK[-1].stats[name] = value


def pop(name: str):
    """Remove and return a recorded value (None when absent/inactive)."""
    if _STACK:
        return _STACK[-1].stats.pop(name, None)
    return None


# --- on-device stat helpers --------------------------------------------------


@torch.no_grad()
def rms(x: torch.Tensor) -> torch.Tensor:
    """Root-mean-square of a tensor, accumulated in f32."""
    return torch.sqrt(torch.mean(torch.square(x.detach().float())))


@torch.no_grad()
def absmax(x: torch.Tensor) -> torch.Tensor:
    """Largest absolute entry, in f32."""
    return torch.max(torch.abs(x.detach().float()))


def site_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{"rms", "absmax"}`` of one activation."""
    return {"rms": rms(x), "absmax": absmax(x)}


class GroupNorms:
    """Per-group sums of squares, fed a leaf at a time (``add``): the
    ``layers.*`` leaves (``[num_layers, ...]``) sum over all but their
    leading axis into one ``[num_layers]`` vector, every other top-level
    group into a scalar; ``norms()`` takes the square roots. Sums run in
    f32 in the order the leaves come. The trainer feeds it the update of
    each leaf as its optimizer applies it, so the update norms need no
    copy of the whole parameter tree."""

    def __init__(self, stacked_key: str = "layers"):
        self.stacked_key = stacked_key
        self._acc: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def add(self, name: str, leaf: torch.Tensor) -> None:
        group = name.split(".", 1)[0]
        leaf = leaf.detach().float()
        if group == self.stacked_key:
            group = "per_layer"
            s = torch.sum(torch.square(leaf),
                          dim=tuple(range(1, leaf.dim())))
        else:
            s = torch.sum(torch.square(leaf))
        prev = self._acc.get(group)
        self._acc[group] = s if prev is None else prev + s

    @torch.no_grad()
    def norms(self) -> Dict[str, torch.Tensor]:
        return {k: torch.sqrt(v) for k, v in self._acc.items()}


def group_norms(tree: Dict[str, torch.Tensor],
                stacked_key: str = "layers") -> Dict[str, torch.Tensor]:
    """Per-group L2 norms of a parameter-shaped flat dict (the port's
    dotted Flax names, grouped by their first component).

    The ``stacked_key`` group (the layer stack, leaves ``[num_layers,
    ...]``) reduces to one ``[num_layers]`` vector under ``"per_layer"``;
    every other top-level group reduces to a scalar. ``combine_group_norms``
    of the result equals the global norm of the whole tree (to rounding;
    pinned by ``tests/test_torch_telemetry.py``)."""
    acc = GroupNorms(stacked_key)
    for name, leaf in tree.items():
        acc.add(name, leaf)
    return acc.norms()


@torch.no_grad()
def combine_group_norms(norms: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Recombine ``group_norms`` output into the global L2 norm."""
    return torch.sqrt(sum(torch.sum(torch.square(v))
                          for v in norms.values()))


def assemble(stats: Dict[str, object]) -> Dict[str, dict]:
    """Regroup a capture's raw stats into the nested telemetry dict.

    Input keys (all optional): ``embed_out`` / ``final_norm`` / ``logits``
    ({rms, absmax} scalars), ``layers`` (dict of ``[num_layers, ...]``
    tensors; keys prefixed ``router_`` split out into their own group).
    Output: ``{"act": {...}, "router": {...}}`` — empty groups omitted.
    """
    act: Dict[str, object] = {}
    router: Dict[str, object] = {}
    for site in ("embed_out", "final_norm", "logits"):
        d = stats.get(site)
        if d:
            for k, v in d.items():
                act[f"{site}_{k}"] = v
    layers = stats.get("layers")
    if layers:
        for k, v in layers.items():
            if k.startswith("router_"):
                router[k[len("router_"):]] = v
            else:
                act[k] = v
    out: Dict[str, dict] = {}
    if act:
        out["act"] = act
    if router:
        out["router"] = router
    return out


def stack_layers(per_layer: List[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """A list of per-layer stat dicts -> one dict of ``[num_layers, ...]``
    tensors (what the JAX layer scan's ``ys`` hold)."""
    return {k: torch.stack([d[k] for d in per_layer])
            for k in per_layer[0]}


def reduce_micro(per_micro: List[dict]) -> dict:
    """Collapse the forward stats of the step's micro-batches: mean for
    RMS-like stats, max for absmax (the JAX ``reduce_micro`` over the
    scan-stacked axis)."""

    def walk(ds):
        out = {}
        for k, v in ds[0].items():
            if isinstance(v, dict):
                out[k] = walk([d[k] for d in ds])
                continue
            s = torch.stack([d[k] for d in ds])
            out[k] = (torch.max(s, dim=0).values if k.endswith("absmax")
                      else torch.mean(s, dim=0))
        return out

    return walk(per_micro)


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def flatten_scalars(telem, prefix: str = "telemetry") -> Dict[str, float]:
    """Host-side flattening of the nested telemetry dict into JSONL/TB/wandb
    scalars: scalars pass through, ``[L]`` vectors become ``.../L03`` keys,
    higher-rank arrays (router load ``[L, E]``) emit per-layer min/max."""
    flat: Dict[str, float] = {}

    def walk(pfx, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{pfx}/{k}", v[k])
            return
        arr = _host(v)
        if arr.ndim == 0:
            flat[pfx] = float(arr)
        elif arr.ndim == 1:
            for i, val in enumerate(arr.tolist()):
                flat[f"{pfx}/L{i:02d}"] = float(val)
        else:
            rows = arr.reshape(arr.shape[0], -1)
            for i in range(arr.shape[0]):
                flat[f"{pfx}/L{i:02d}/max"] = float(rows[i].max())
                flat[f"{pfx}/L{i:02d}/min"] = float(rows[i].min())

    walk(prefix, telem)
    return flat


# --- nan scan ----------------------------------------------------------------

# Within-layer evaluation order of the forward: attention sublayer output,
# feed-forward sublayer output, block output (post-residual).
_LAYER_SITES = ("attn", "ffn", "block")


def nan_report(stats: Dict[str, dict]) -> dict:
    """Bisect which site first goes non-finite in a forward-only capture.

    ``stats``: the output of ``Trainer.nan_scan``'s capture — the
    ``assemble`` dict plus a ``loss`` scalar. Sites are checked in forward
    order: embedding → layer 0 attn → layer 0 ffn → layer 0 block → layer 1
    … → final norm → logits → loss. Returns ``{"first_nan": {"layer",
    "site"} | None, "sites": [...]}`` where ``sites`` lists every
    non-finite site.
    """
    act = {k: _host(v) for k, v in stats.get("act", {}).items()}
    bad: List[dict] = []

    def check(site, layer, value):
        if value is not None and not np.all(np.isfinite(value)):
            bad.append({"site": site, "layer": layer})

    check("embed", None, act.get("embed_out_absmax"))
    per_layer = {s: act.get(f"{s}_absmax") for s in _LAYER_SITES}
    n_layers = next(
        (int(v.shape[0]) for v in per_layer.values() if v is not None), 0)
    for i in range(n_layers):
        for s in _LAYER_SITES:
            v = per_layer[s]
            if v is not None:
                check(s, i, v[i])
    check("final_norm", None, act.get("final_norm_absmax"))
    check("logits", None, act.get("logits_absmax"))
    loss = stats.get("loss")
    if loss is not None:
        check("loss", None, _host(loss))
    return {"first_nan": bad[0] if bad else None, "sites": bad}


# --- goodput ledger ----------------------------------------------------------


class GoodputLedger:
    """Wall-clock attribution for a training run.

    Categories (``CATEGORIES``) are tracked via non-overlapping
    ``with ledger.track(cat):`` blocks, so the per-category fractions of
    total elapsed time sum to <= 1.0; the gap is reported as
    ``untracked_frac`` (host-side Python between blocks). ``record()``
    produces a JSONL-able dict (``kind: "goodput"``); ``summary_lines()``
    renders the human-readable end-of-run table.
    """

    CATEGORIES = (
        "compile",
        "data_wait",
        "step",
        "eval",
        "checkpoint_save",
        # Draining an in-flight async commit (utils/checkpoint.py
        # AsyncSaver.wait) before the next save/rollback/exit.
        "checkpoint_commit_wait",
        "checkpoint_restore",
        "rollback_replay",
        # Elastic recovery and grow-back: tracked by the multi-process run
        # supervisor (ROADMAP Queue 1 item 5), never by one trainer.
        "recovery",
        "grow",
    )

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._acc: Dict[str, float] = {}
        self._tokens = 0
        self._nonpad_tokens = 0

    def add_tokens(self, total: int, non_pad: Optional[int] = None) -> None:
        """Count one step's fed tokens; ``non_pad`` defaults to all of them
        (unpacked batches have no padding)."""
        self._tokens += int(total)
        self._nonpad_tokens += int(total if non_pad is None else non_pad)

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

    def record(self, step: Optional[int] = None, final: bool = False) -> dict:
        total = self.total_seconds()
        tracked = sum(self._acc.values())
        rec = {
            "kind": "goodput",
            "total_seconds": total,
            "productive_frac": self._acc.get("step", 0.0) / total,
            "untracked_frac": max(0.0, 1.0 - tracked / total),
        }
        if step is not None:
            rec["step"] = step
        if final:
            rec["final"] = True
        for cat in self.CATEGORIES:
            if cat in self._acc:
                rec[f"{cat}_seconds"] = self._acc[cat]
                rec[f"{cat}_frac"] = self._acc[cat] / total
        if self._tokens:
            rec["tokens"] = self._tokens
            rec["non_pad_tokens"] = self._nonpad_tokens
            # A token ratio, NOT a wall-clock share — deliberately named
            # outside the "*_frac" namespace every goodput consumer sums.
            rec["non_pad_token_ratio"] = self._nonpad_tokens / self._tokens
            step_s = self._acc.get("step", 0.0)
            if step_s > 0:
                rec["effective_tok_per_sec"] = self._nonpad_tokens / step_s
        return rec

    def summary_lines(self) -> List[str]:
        rec = self.record(final=True)
        lines = [
            f"goodput: {rec['productive_frac']:6.1%} of "
            f"{rec['total_seconds']:.1f}s wall-clock was step compute"
        ]
        for cat in self.CATEGORIES:
            if f"{cat}_seconds" in rec:
                lines.append(
                    f"  {cat:<22} {rec[f'{cat}_seconds']:9.2f}s "
                    f"{rec[f'{cat}_frac']:6.1%}")
        lines.append(
            f"  {'untracked':<22} "
            f"{rec['untracked_frac'] * rec['total_seconds']:9.2f}s "
            f"{rec['untracked_frac']:6.1%}")
        if "non_pad_token_ratio" in rec:
            eff = rec.get("effective_tok_per_sec")
            eff_s = f", {eff:,.0f} effective tok/s" if eff else ""
            lines.append(
                f"  non-pad tokens: {rec['non_pad_tokens']:,} / "
                f"{rec['tokens']:,} ({rec['non_pad_token_ratio']:.1%}){eff_s}")
        return lines


# --- loss-spike early warning ------------------------------------------------


class SpikeDetector:
    """Rolling median/MAD z-score over the training loss.

    ``update(loss)`` → ``(is_spike, z)``. A sample only counts as a spike
    once ``min_history`` normal samples are in the window (cold-start and
    the steep early-loss descent produce *negative* z and never fire). A
    spiking sample is not admitted to the window, so a sustained divergence
    keeps firing rather than normalizing itself. Non-finite losses are
    ignored here; ``guards.check_finite`` owns NaN.
    """

    def __init__(self, sigma: float = 6.0, window: int = 128,
                 min_history: int = 20):
        self.sigma = sigma
        self.window = window
        self.min_history = max(2, min_history)
        self._hist: List[float] = []

    def reset(self) -> None:
        """Forget history (call after a rollback — the restored loss level
        predates everything in the window)."""
        self._hist.clear()

    def update(self, loss) -> Tuple[bool, float]:
        if loss is None:
            return False, 0.0
        loss = float(loss)
        if not math.isfinite(loss):
            return False, 0.0
        z = 0.0
        if len(self._hist) >= self.min_history:
            med = statistics.median(self._hist)
            mad = statistics.median(abs(x - med) for x in self._hist)
            # 1.4826*MAD ≈ sigma for gaussian noise; the floor keeps a
            # perfectly flat window (MAD → 0) from flagging epsilon noise.
            scale = max(1.4826 * mad, 1e-3 * abs(med), 1e-8)
            z = (loss - med) / scale
            if self.sigma > 0 and z > self.sigma:
                return True, z
        if len(self._hist) >= self.window:
            self._hist.pop(0)
        self._hist.append(loss)
        return False, z


# --- deferred host fetch -----------------------------------------------------


def _start_fetch(tree):
    """Start copying every tensor of a (nested dict) metrics tree to host
    memory: CUDA tensors into pinned buffers with ``non_blocking`` copies
    on the current stream; everything else as is."""
    if isinstance(tree, dict):
        return {k: _start_fetch(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_cuda:
        host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        host.copy_(tree.detach(), non_blocking=True)
        return host
    return tree


def _finish_fetch(tree):
    """Host copies -> floats (0-d) and numpy arrays."""
    if isinstance(tree, dict):
        return {k: _finish_fetch(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        arr = tree.detach().to("cpu").numpy()
        return float(arr) if arr.ndim == 0 else arr
    return tree


def _has_cuda(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_cuda(v) for v in tree.values())
    return torch.is_tensor(tree) and tree.is_cuda


class DeferredFetcher:
    """Bounded window of in-flight per-step metric fetches.

    PyTorch launches CUDA work asynchronously: ``train_step`` returns device
    tensors still being computed, and reading one on the host waits for the
    whole step. ``push()`` instead starts each step's device-to-pinned-host
    copies behind a CUDA event and returns the entries that are ``window``
    steps old, whose events have long completed, so the host stays ahead of
    the device. ``drain()`` materializes everything (eval/save/rollback/
    exit boundaries, where a synchronize is paid anyway). ``transform`` is
    applied to the host copy at maturity: an injected fault that mutates a
    loss composes with the lagged value. ``window=0`` reads each step at
    once.

    Each entry comes back as ``(step, metrics, end)``: ``end`` is when the
    step finished, on the host's ``time.perf_counter`` clock. On the card
    that is the step's event, placed on the host clock by one calibration
    (the first push waits for its event and reads the clock); so a rate
    over entries that mature together (at a drain) still measures the
    steps, not the moment they were read. CPU tensors are read as they
    are, and ``end`` is the time of the push.
    """

    def __init__(self, window: int = 2):
        self.window = max(0, int(window))
        self._q: collections.deque = collections.deque()
        self._ref = None          # (CUDA event, perf_counter at its end)

    def __len__(self) -> int:
        return len(self._q)

    def push(self, step: int, metrics: dict,
             transform=None) -> List[Tuple[int, dict, float]]:
        if _has_cuda(metrics):
            host = _start_fetch(metrics)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if self._ref is None:
                end.synchronize()
                self._ref = (end, time.perf_counter())
        else:
            host, end = metrics, time.perf_counter()
        self._q.append((step, host, end, transform))
        out = []
        while len(self._q) > self.window:
            out.append(self._fetch(self._q.popleft()))
        return out

    def drain(self) -> List[Tuple[int, dict, float]]:
        out = []
        while self._q:
            out.append(self._fetch(self._q.popleft()))
        return out

    def _fetch(self, entry) -> Tuple[int, dict, float]:
        step, host, end, transform = entry
        if not isinstance(end, float):
            end.synchronize()
            ref, t_ref = self._ref
            end = t_ref + ref.elapsed_time(end) / 1e3
        host = _finish_fetch(host)
        if transform is not None:
            host = transform(host)
        return step, host, end


class MetricsBridge:
    """``MetricLogger`` observer that maps the training record stream
    onto an obs registry (the live /metrics plane).

    Attach via ``MetricLogger(observer=MetricsBridge(registry))`` — it
    shares the flight recorder's ``observe(record)`` contract. Everything
    is sink-side: the records themselves (and therefore the JSONL stream)
    are identical with or without a bridge attached.

    Mapping: ``kind:"train"`` → step/loss/lr/tok-s/mfu gauges plus a
    step-interval latency histogram (from ``elapsed_s`` deltas);
    ``kind:"eval"`` → eval-loss gauge; ``kind:"goodput"`` → one gauge
    per ``*_frac`` category; ``kind:"rollback"`` / ``"recompile"`` →
    monotone counters. Unknown kinds count into
    ``train_records_total{kind=...}`` and are otherwise ignored.
    """

    _GAUGE_FIELDS = (
        ("loss", "train_loss", "Training loss (last logged step)"),
        ("lr", "train_learning_rate", "Learning rate"),
        ("grad_norm", "train_grad_norm", "Global gradient norm"),
        ("tokens_per_sec", "train_tokens_per_sec", "Windowed tokens/s"),
        ("effective_tokens_per_sec", "train_effective_tokens_per_sec",
         "Windowed non-pad tokens/s"),
        ("mfu", "train_mfu", "Model FLOPs utilization"),
        ("peak_mem_gb", "train_peak_mem_gb", "Peak device memory (GB)"),
    )

    def __init__(self, registry):
        self.registry = registry
        self._step = registry.gauge("train_step", "Last logged step")
        self._gauges = {
            field: registry.gauge(name, help_)
            for field, name, help_ in self._GAUGE_FIELDS}
        self._tokens = registry.counter(
            "train_tokens_total", "Tokens seen (cumulative)")
        self._step_seconds = registry.histogram(
            "train_step_seconds", "Wall-clock seconds per step "
            "(log-interval deltas averaged over the interval)")
        self._eval_loss = registry.gauge("train_eval_loss", "Held-out loss")
        self._goodput = registry.gauge(
            "train_goodput_frac", "Wall-clock fraction by category",
            labelnames=("category",))
        self._records = registry.counter(
            "train_records_total", "Records observed by kind",
            labelnames=("kind",))
        self._rollbacks = registry.counter(
            "train_rollbacks_total", "Checkpoint rollback-replay events")
        self._recompiles = registry.counter(
            "train_recompiles_total", "Train-step recompilations")
        self._last_elapsed: Optional[Tuple[int, float]] = None
        self.n_records = 0
        self.last: dict = {}

    def statusz(self) -> dict:
        """/statusz payload: the last observed record of each kind."""
        return {"kind": "training", "records_observed": self.n_records,
                "last": dict(self.last)}

    def observe(self, record: dict) -> None:
        kind = str(record.get("kind", "train"))
        self.n_records += 1
        self.last[kind] = record
        self._records.labels(kind=kind).inc()
        if kind == "train":
            self._observe_train(record)
        elif kind == "eval" and "eval_loss" in record:
            self._eval_loss.set(float(record["eval_loss"]))
        elif kind == "goodput":
            for key, val in record.items():
                if key.endswith("_frac") and isinstance(val, (int, float)):
                    self._goodput.labels(
                        category=key[:-len("_frac")]).set(float(val))
        elif kind == "rollback":
            self._rollbacks.inc()
        elif kind == "recompile":
            self._recompiles.inc()

    def _observe_train(self, record: dict) -> None:
        step = record.get("step")
        if step is not None:
            self._step.set(float(step))
        for field, gauge in self._gauges.items():
            val = record.get(field)
            if isinstance(val, (int, float)):
                gauge.set(float(val))
        seen = record.get("tokens_seen")
        if isinstance(seen, (int, float)):
            self._tokens.set_function(lambda s=float(seen): s)
        elapsed = record.get("elapsed_s")
        if step is not None and isinstance(elapsed, (int, float)):
            if self._last_elapsed is not None:
                d_step = int(step) - self._last_elapsed[0]
                d_t = float(elapsed) - self._last_elapsed[1]
                if d_step > 0 and d_t >= 0:
                    self._step_seconds.observe(d_t / d_step)
            self._last_elapsed = (int(step), float(elapsed))
