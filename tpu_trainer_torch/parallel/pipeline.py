"""Pipeline parallelism over the ``stage`` mesh axis (port of
``tpu_trainer/parallel/pipeline.py``).

The JAX package runs its schedules as one ``lax.scan`` inside a
``shard_map`` over ``stage``, handing activations on by ``ppermute``. The
port runs one process a stage rank: each tick every rank posts the
receives it expects, runs its forward half, the head where the tick has
one, and its backward half, then sends what its neighbours consume at the
next tick (``Collectives.send`` / ``recv`` over the stage group,
``collectives.calls["pp_send"]``). Every rank walks every tick, a bubble
tick included, and a message is posted only where its receiver expects it
(``check_schedule`` proves the pairing for a table), so no rank waits on
a message that is never sent.

**Layers.** Stage ``s`` of ``S`` holds the stacked layer leaves' layers
``stage_layers(L, S, v, s)``: ``[s L/S, (s + 1) L/S)`` for GPipe and
1F1B; under the interleaved schedule (``v`` chunks a rank) chunk ``c`` of
rank ``s`` is global stage ``g = c S + s``, layers ``[g Lc, (g + 1)
Lc)`` with ``Lc = L / (S v)``, and the rank keeps its ``v`` chunks in
chunk order (the JAX ``_permute`` layout, without the permutation: a
rank holds its own layers). Checkpoints, ``from_jax_params`` and the
norms key every layer by its global index.

**Microbatches.** ``M = pipeline_microbatches or S``. The split is
strided: global row ``j M + m`` is in microbatch ``m``, so a data rank's
share of microbatch ``m`` is its rows whose global index is ``m`` modulo
``M`` (``micro_rows``); where a rank's row count is not a multiple of
``M`` its shares are uneven or empty, as in JAX.

**Schedules** (``make_schedule``):

- ``gpipe``: at forward tick ``t`` of ``M + S - 1`` stage ``s`` runs
  microbatch ``t - s``; then the last stage runs the head once on the
  reassembled batch (the fused head + CE kernel where it is admitted) and
  the backward runs the reverse pipeline, microbatch ``M - 1`` first. A
  rank holds ``M`` microbatches' graphs at the bubble.
- ``1f1b`` and ``interleaved``: the JAX canonical work-item sequence.
  Forward item ``k`` is (chunk ``(k mod Sv) div S``, micro ``(k div Sv)
  S + k mod S``), run by rank ``s`` at tick ``s + k``; backward item
  ``j`` the same pairing with the chunk order reversed, at tick ``(vS -
  1) + j + (S - 1 - s)``; ``vM + (v + 1)S - 2`` ticks. At a head tick
  (the last stage just ran a microbatch's last chunk) its output is
  broadcast over the stage group and every rank computes its ``1/S``
  vocabulary slice of the head (``ops/loss.vocab_sharded_shifted_cross_
  entropy`` over the stage group), the partial input gradients summed
  over the group.

**Saved state.** JAX keeps each in-flight microbatch's stage input in a
ring buffer of ``W`` slots and recomputes the stage block inside its
``vjp``. The port keeps each in-flight microbatch's autograd graph
instead (no recompute: the flash forward runs once a layer a microbatch,
and a remat config still recomputes each layer in its own backward), and
never more than ``W`` a chunk: ``W`` comes from the JAX static simulation
(``window``: ``min(M, 2S - 1)`` at ``v = 1``; it once shrank to 2 at
``S = 2, M > 2`` and corrupted the gradients), and the executor raises
when a forward would put more in flight (``in_flight`` counts them).

**Gradients.** A microbatch's backward is ``torch.autograd.grad`` of its
chunk's output (and, for MoE, its router auxiliary, seeded with the loss
weight the caller gives) with respect to the chunk's input and the
rank's leaves; the f32 sums over the microbatches are the rank's
gradients. A layer leaf's gradient is its stage's alone; the replicated
leaves' (the tied embedding, the final norm) are partial per stage, and
the trainer sums them over the stage group once.

The executor returns the bytes the rank sent, the seconds it waited on
receives and the most microbatches it held in flight (``Stats``; the
trainer keeps a step's as ``Trainer.pipeline_stats``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

SCHEDULES = ("gpipe", "1f1b", "interleaved")
_FWD_TAG, _BWD_TAG = 1, 2


def num_microbatches(config, stages: int) -> int:
    """``M``: ``pipeline_microbatches`` or the stage count."""
    return config.pipeline_microbatches or stages


def virtual_stages(config) -> int:
    """Layer chunks a rank: ``pipeline_virtual_stages`` under the
    interleaved schedule, else 1."""
    return (config.pipeline_virtual_stages
            if config.pipeline_schedule == "interleaved" else 1)


def stage_layers(num_layers: int, stages: int, virtual: int, stage: int
                 ) -> List[int]:
    """The global layer indices stage rank ``stage`` holds, in its local
    order (chunk by chunk)."""
    lc = num_layers // (stages * virtual)
    return [(c * stages + stage) * lc + i
            for c in range(virtual) for i in range(lc)]


def bubble_fraction(schedule: str, stages: int, micro: int,
                    virtual: int = 1) -> float:
    """The idle share of a rank: ``(S - 1) / (M + S - 1)`` for GPipe and
    1F1B, ``(S - 1) / (vM + S - 1)`` interleaved."""
    v = virtual if schedule == "interleaved" else 1
    return (stages - 1) / (v * micro + stages - 1)


def micro_rows(rows: int, row0: int, micro: int) -> List[List[int]]:
    """A data rank's local row indices of each microbatch: local row ``i``
    (global ``row0 + i``) is in microbatch ``(row0 + i) mod M``."""
    out: List[List[int]] = [[] for _ in range(micro)]
    for i in range(rows):
        out[(row0 + i) % micro].append(i)
    return out


def _work_items(stages: int, micro: int, virtual: int):
    """The canonical sequence: forward chunk and micro of item ``k``, and
    the reversed chunk order of the backward items."""
    ks = np.arange(virtual * micro)
    g0, rem = np.divmod(ks, stages * virtual)
    fwd_chunk = rem // stages
    fwd_micro = g0 * stages + rem % stages
    return ks, fwd_chunk, fwd_micro, (virtual - 1) - fwd_chunk


def window(stages: int, micro: int, virtual: int = 1) -> int:
    """The JAX static simulation of the saved-input window: the most
    microbatches of one (rank, chunk) whose forward has run and whose
    backward has not, counting the read tick as live (the forward half
    of a tick runs before its backward half), capped at ``M``."""
    S, M, v = stages, micro, virtual
    ks, fwd_chunk, _, bwd_chunk = _work_items(S, M, v)
    off = v * S - 1
    w_max = 1
    for s in range(S):
        for c in range(v):
            tw = s + ks[fwd_chunk == c]
            tr = off + ks[bwd_chunk == c] + (S - 1 - s)
            live = [int(np.sum((tw <= w) & (tr >= w))) for w in tw]
            w_max = max(w_max, max(live))
    return min(w_max, M)


@dataclasses.dataclass(frozen=True)
class Tick:
    """What one rank does at one tick. ``fwd`` / ``bwd``: ``(chunk,
    micro)`` or None; ``recv_*`` / ``send_*``: whether the input of that
    half arrives from a neighbour and whether its output leaves for one;
    ``head``: the microbatch whose head runs this tick (1F1B), or -1 for
    GPipe's whole-batch head (last stage only), else None."""

    fwd: Optional[tuple] = None
    recv_fwd: bool = False
    send_fwd: bool = False
    head: Optional[int] = None
    bwd: Optional[tuple] = None
    recv_bwd: bool = False
    send_bwd: bool = False


@dataclasses.dataclass(frozen=True)
class Schedule:
    kind: str
    stages: int
    micro: int
    virtual: int
    window: int
    ticks: tuple      # ticks[s][t]: rank s's Tick at tick t

    @property
    def bubble(self) -> float:
        return bubble_fraction(self.kind, self.stages, self.micro,
                               self.virtual)


def make_schedule(kind: str, stages: int, micro: int, virtual: int = 1,
                  window_size: Optional[int] = None) -> Schedule:
    """The tick table of ``kind`` for ``S`` stages and ``M`` microbatches
    (``virtual`` chunks a rank under interleaved). ``window_size``
    overrides the simulated window (a table built with a smaller one is
    rejected by ``check_schedule`` and by the executor)."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {kind!r}; choose "
                         f"{', '.join(SCHEDULES)}")
    S, M = stages, micro
    v = virtual if kind == "interleaved" else 1
    if kind == "interleaved" and M % S:
        raise ValueError(f"interleaved schedule needs pipeline_microbatches "
                         f"({M}) divisible by the stage count ({S})")
    ticks: List[List[Tick]] = [[] for _ in range(S)]
    if kind == "gpipe":
        W = M
        for s in range(S):
            for t in range(M + S - 1):
                m = t - s
                ok = 0 <= m < M
                ticks[s].append(Tick(fwd=(0, m) if ok else None,
                                     recv_fwd=ok and s > 0,
                                     send_fwd=ok and s < S - 1))
            ticks[s].append(Tick(head=-1 if s == S - 1 else None))
            for t in range(M + S - 1):
                m = M - 1 - (t - (S - 1 - s))
                ok = 0 <= m < M
                ticks[s].append(Tick(bwd=(0, m) if ok else None,
                                     recv_bwd=ok and s < S - 1,
                                     send_bwd=ok and s > 0))
    else:
        W = window(S, M, v)
        ks, fwd_chunk, fwd_micro, bwd_chunk = _work_items(S, M, v)
        K = v * M
        off = v * S - 1
        T = v * M + (v + 1) * S - 2
        for s in range(S):
            for t in range(T):
                k = t - s
                fwd = None
                if 0 <= k < K:
                    fwd = (int(fwd_chunk[k]), int(fwd_micro[k]))
                k_h = t - (S - 1)
                head = (int(fwd_micro[k_h]) if 0 <= k_h < K
                        and fwd_chunk[k_h] == v - 1 else None)
                j = t - off - (S - 1) + s
                bwd = None
                if 0 <= j < K:
                    bwd = (int(bwd_chunk[j]), int(fwd_micro[j]))
                ticks[s].append(Tick(
                    fwd=fwd,
                    recv_fwd=fwd is not None and not (s == 0 and fwd[0] == 0),
                    send_fwd=fwd is not None
                    and not (s == S - 1 and fwd[0] == v - 1),
                    head=head, bwd=bwd,
                    recv_bwd=bwd is not None
                    and not (s == S - 1 and bwd[0] == v - 1),
                    send_bwd=bwd is not None and not (s == 0 and bwd[0] == 0)))
    return Schedule(kind, S, M, v, W if window_size is None else window_size,
                    tuple(tuple(r) for r in ticks))


def forward_schedule(sched: Schedule, micro: Optional[int] = None
                     ) -> Schedule:
    """The forward-only table for ``sched``'s layer layout (evaluation, the
    nan scan), over ``micro`` microbatches (default ``sched``'s): GPipe's
    at one chunk a rank; under interleaved, the interleaved table's
    forward items at their ticks (every message still consumed at the
    next tick, the chunks in global layer order), its per-microbatch
    heads replaced by GPipe's whole-batch head on the last stage."""
    M = micro or sched.micro
    if sched.virtual == 1:
        return make_schedule("gpipe", sched.stages, M)
    full = make_schedule("interleaved", sched.stages, M, sched.virtual)
    S = sched.stages
    ticks = []
    for s, row in enumerate(full.ticks):
        out = [Tick(fwd=tk.fwd, recv_fwd=tk.recv_fwd, send_fwd=tk.send_fwd)
               for tk in row]
        if s == S - 1:
            out.append(Tick(head=-1))
        ticks.append(tuple(out))
    return Schedule("gpipe", S, M, sched.virtual, full.window, tuple(ticks))


def check_schedule(sched: Schedule) -> Dict[str, int]:
    """Raise ``ValueError`` unless the table is sound: every (chunk,
    micro) item runs its forward once and its backward once after it;
    every message sent at tick ``t`` is expected by its receiver at tick
    ``t + 1`` (and nothing else is expected); at most ``window``
    microbatches of one (rank, chunk) are in flight; the head of a
    microbatch runs between its last chunk's forward and backward on the
    last stage. Returns ``{"in_flight": the most in flight, "ticks": n}``."""
    S, v, M = sched.stages, sched.virtual, sched.micro
    n = len(sched.ticks[0])
    most = 0
    for s in range(S):
        seen_f, seen_b = {}, {}
        live: Dict[int, set] = {c: set() for c in range(v)}
        for t, tk in enumerate(sched.ticks[s]):
            if tk.fwd is not None:
                if tk.fwd in seen_f:
                    raise ValueError(f"stage {s}: forward of {tk.fwd} twice")
                seen_f[tk.fwd] = t
                live[tk.fwd[0]].add(tk.fwd[1])
                most = max(most, len(live[tk.fwd[0]]))
                if len(live[tk.fwd[0]]) > sched.window:
                    raise ValueError(
                        f"stage {s} tick {t}: {len(live[tk.fwd[0]])} "
                        f"microbatches of chunk {tk.fwd[0]} in flight, "
                        f"window {sched.window}")
            if tk.bwd is not None:
                if tk.bwd not in seen_f or tk.bwd in seen_b:
                    raise ValueError(f"stage {s} tick {t}: backward of "
                                     f"{tk.bwd} without one forward first")
                seen_b[tk.bwd] = t
                live[tk.bwd[0]].discard(tk.bwd[1])
        want = {(c, m) for c in range(v) for m in range(M)}
        if set(seen_f) != want or set(seen_b) != want:
            raise ValueError(f"stage {s}: items {sorted(set(seen_f))} / "
                             f"{sorted(set(seen_b))}, want all of {M}x{v}")
    for s in range(S):
        nxt, prv = (s + 1) % S, (s - 1) % S
        for t in range(n):
            tk = sched.ticks[s][t]
            later = sched.ticks[nxt][t + 1] if t + 1 < n else Tick()
            earlier = sched.ticks[prv][t + 1] if t + 1 < n else Tick()
            if tk.send_fwd != later.recv_fwd or (
                    tk.send_fwd and tk.fwd[1] != later.fwd[1]):
                raise ValueError(f"stage {s} tick {t}: forward message "
                                 f"{tk.fwd} not consumed at tick {t + 1}")
            if tk.send_bwd != earlier.recv_bwd or (
                    tk.send_bwd and tk.bwd[1] != earlier.bwd[1]):
                raise ValueError(f"stage {s} tick {t}: backward message "
                                 f"{tk.bwd} not consumed at tick {t + 1}")
        if sched.ticks[s][0].recv_fwd or sched.ticks[s][0].recv_bwd:
            raise ValueError(f"stage {s}: tick 0 expects a message")
    return {"in_flight": most, "ticks": n}


@dataclasses.dataclass
class Stats:
    """One step's point-to-point traffic of this rank: bytes sent and the
    seconds spent waiting on receives (and on the sends of the tick
    before), and the most microbatches it held in flight."""

    sent_bytes: int = 0
    wait_s: float = 0.0
    in_flight: int = 0

    def add(self, other: "Stats") -> None:
        self.sent_bytes += other.sent_bytes
        self.wait_s += other.wait_s
        self.in_flight = max(self.in_flight, other.in_flight)


def execute(sched: Schedule, coll, stage: int, hooks, *,
            backward: bool = True):
    """Run ``sched`` for stage rank ``stage`` over the stage group
    ``coll``. Returns ``(loss, aux, grads, stats)``: the head's loss (GPipe: on
    the last stage, None elsewhere; 1F1B: the sum of the microbatches'
    weighted losses, the same on every rank), the sum of this rank's
    chunks' auxiliaries (None without any) and the f32 gradient sums of
    ``hooks.leaves`` (None entries where a leaf got none); ``grads`` is
    None with ``backward`` False (a GPipe table's forward ticks and head
    only, for a forward under no_grad), and the run's ``Stats``.

    ``hooks`` is the model's side (``models/gpt.py::_StageHooks``):
    ``leaves`` (the rank's parameters, in the order of the gradients
    returned), ``device``, ``loss_scale`` (the loss's seed, fp16
    scaling), ``aux_weight`` (the loss weight of a chunk's auxiliary, or
    None); ``act(m)``: ``(shape, dtype)`` of a chunk's input and output
    for microbatch ``m``; ``forward(c, m, x)``: chunk ``c``'s ``(output,
    aux or None)`` of microbatch ``m`` (``x`` None on global stage 0,
    which embeds the ids); ``head_batch(ys)`` (GPipe, last stage): the
    step's loss from every microbatch's output; ``head_micro(y, m,
    last)`` (1F1B): this rank's vocabulary slice of microbatch ``m``'s
    head on the broadcast output ``y``, ``(loss, the cotangent of y on
    the last stage else None, the leaves' gradients)``."""
    S = sched.stages
    nxt, prv = (stage + 1) % S, (stage - 1) % S
    leaves = list(hooks.leaves)
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
    graphs: Dict[tuple, tuple] = {}
    in_flight = {c: 0 for c in range(sched.virtual)}
    stats = Stats()
    pending: list = []
    outs: Dict[int, torch.Tensor] = {}
    head_dy: Optional[torch.Tensor] = None
    head_dys: Dict[int, torch.Tensor] = {}
    loss = None
    aux_total = None
    device = hooks.device

    def acc(gs):
        for i, g in enumerate(gs):
            if g is None:
                continue
            grads[i] = g.float() if grads[i] is None else grads[i].add_(
                g.float())

    def wait_all(handles):
        t0 = time.perf_counter()
        got = [h() for h in handles]
        stats.wait_s += time.perf_counter() - t0
        return got

    ticks = sched.ticks[stage]
    if not backward:
        ticks = [tk for tk in ticks if tk.bwd is None]
    for tk in ticks:
        recvs = []
        if tk.recv_fwd:
            shape, dtype = hooks.act(tk.fwd[1])
            recvs.append(("f", coll.recv(shape, dtype, device, prv,
                                         _FWD_TAG)))
        if tk.recv_bwd:
            shape, dtype = hooks.act(tk.bwd[1])
            recvs.append(("b", coll.recv(shape, dtype, device, nxt,
                                         _BWD_TAG)))
        wait_all(pending)
        pending = []
        got = dict(zip([k for k, _ in recvs], wait_all([h for _, h in recvs])))
        sends = []
        y = None
        if tk.fwd is not None:
            c, m = tk.fwd
            if tk.recv_fwd:
                x = got["f"]
                x = x.detach().requires_grad_(backward)
            else:
                x = None
            if backward and in_flight[c] + 1 > sched.window:
                raise RuntimeError(
                    f"pipeline stage {stage}: a forward of chunk {c} would "
                    f"hold {in_flight[c] + 1} microbatches in flight, above "
                    f"the window {sched.window} of the "
                    f"{sched.kind} schedule")
            y, aux = hooks.forward(c, m, x)
            if aux is not None:
                a = aux.detach().float()
                aux_total = a if aux_total is None else aux_total + a
            if backward:
                graphs[(c, m)] = (x, y, aux)
                in_flight[c] += 1
                stats.in_flight = max(stats.in_flight, in_flight[c])
            if tk.send_fwd:
                sends.append((y.detach(), nxt, _FWD_TAG))
            elif sched.kind == "gpipe":
                outs[m] = y
        if tk.head == -1:
            ys = [outs[m] for m in range(sched.micro)]
            if backward:
                ys_in = [t_.detach().requires_grad_(True) for t_ in ys]
                loss = hooks.head_batch(ys_in)
                gs = torch.autograd.grad(loss * hooks.loss_scale,
                                         ys_in + leaves, allow_unused=True)
                head_dys = {m: g for m, g in enumerate(gs[:len(ys)])}
                acc(gs[len(ys):])
                loss = loss.detach()
            else:
                loss = hooks.head_batch(ys).detach()
            outs.clear()
        elif tk.head is not None:
            m = tk.head
            shape, dtype = hooks.act(m)
            if y is None or stage != S - 1:
                y_src = torch.empty(shape, dtype=dtype, device=device)
            else:
                y_src = y.detach()
            y_bc = coll.broadcast(y_src, S - 1, kind="pp_bcast")
            part, head_dy, gs = hooks.head_micro(y_bc, m, stage == S - 1)
            acc(gs)
            part = part.float()
            loss = part if loss is None else loss + part
        if tk.bwd is not None:
            c, m = tk.bwd
            if tk.recv_bwd:
                dy = got["b"]
            elif sched.kind == "gpipe":
                dy = head_dys.pop(m)
            else:
                dy = head_dy
            x, y_out, aux = graphs.pop((c, m))
            in_flight[c] -= 1
            outputs, seeds = [y_out], [dy.to(y_out.dtype)]
            if aux is not None and hooks.aux_weight is not None:
                outputs.append(aux)
                seeds.append(torch.full_like(
                    aux, hooks.aux_weight * hooks.loss_scale))
            inputs = ([x] if x is not None else []) + leaves
            gs = torch.autograd.grad(outputs, inputs, seeds,
                                     allow_unused=True)
            if x is not None:
                dx, gs = gs[0], gs[1:]
            acc(gs)
            if tk.send_bwd:
                sends.append((dx if dx is not None else torch.zeros_like(x),
                              prv, _BWD_TAG))
        for tensor, to, tag in sends:
            stats.sent_bytes += tensor.numel() * tensor.element_size()
            pending.append(coll.send(tensor, to, tag))
    wait_all(pending)
    if graphs and backward:
        raise RuntimeError(f"pipeline stage {stage}: {sorted(graphs)} left "
                           f"without a backward")
    return loss, aux_total, (grads if backward else None), stats

