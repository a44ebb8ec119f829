"""Single-device trainer (port of ``tpu_trainer/training/trainer.py``).

``Trainer(model_config, training_config, device=...)`` owns the model
and the optimizer; ``init_state(seed)`` draws the f32 master parameters
and the optimizer state, and ``train_step(state, batch) -> (state,
metrics)`` takes one optimizer step over ``gradient_accumulation_steps``
micro-batches, as the JAX trainer's ``_train_step`` does:

- forward in the compute dtype of ``mixed_precision`` over f32 masters
  (every matmul casts its weight), loss and gradients by autograd;
- gradients summed over the micro-batches in f32, divided by ``accum *
  loss_scale``; ``grad_norm`` is their global norm before clipping;
- clipped AdamW at unit LR (``training/optimizer.py``), the update scaled
  by ``lr_at(step)``;
- fp16: dynamic loss scaling. On a non-finite gradient the update is
  skipped (parameters and Adam's moments and count untouched), the scale
  halves (not below 1) and the step, hence the schedule, still advances;
  after 2000 finite steps the scale doubles (at most 2**16).

Every dropout seed comes from the state's ``torch.Generator``, seeded from
``TrainingConfig.seed``. The state's tensors are updated in place (one
copy of parameters and moments on the device); ``train_step`` returns the
same state object. ``eval_step`` is the forward-only mean loss;
``TrainState.state_dict`` / ``load_state_dict`` are what a checkpoint
holds (``utils/checkpoint.py``).

Optimizer-state host offload (``ParallelConfig.cpu_offload``, the JAX
trainer's ``_offload_store`` / ``_offload_load``): Adam's moments live in
pinned host memory in the storage form of ``offload_dtype`` ("float32";
"bfloat16" casts every float leaf with ``ndim >= 1``; "int8" packs every
float leaf with ``ndim >= 2`` into a ``QuantPack``, ``nu`` in sqrt-space).
Each step streams them to the device after the backward, loads them to
f32, runs the update, stores them narrow again and streams them back:
both copies are asynchronous on the current stream, so the next step's
copies, ``state_dict`` (a device synchronize) and ``load_state_dict``
come after them. With ``offload_budget_gb`` the largest moment leaves
that fit the budget stay on the device in exact f32
(``select_resident_moments``). At one process every ``sharding_strategy``
is this step.

Not ported yet (ROADMAP Queue 1): meshes and sharding across processes,
pipeline schedules, telemetry steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.models.weights import init_params
from tpu_trainer_torch.ops.loss import segment_target_mask
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.optimizer import (
    STATE_DTYPES,
    AdamWState,
    Moment,
    decay_mask,
    global_norm,
    load_moment,
    make_optimizer,
    store_moment,
)
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.quant import QuantPack

_MP_TO_DTYPE = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
_SCALE_GROWTH_INTERVAL = 2000  # finite steps before the scale doubles
_MAX_LOSS_SCALE = 2.0**16
_INIT_LOSS_SCALE = 2.0**15


def moment_key(moment: str, name: str) -> tuple:
    """``("mu" | "nu", *flax path)``: the JAX moment leaf's path keys
    after the optax chain's own prefix."""
    return (moment,) + tuple(name.split("."))


def select_resident_moments(moments: Dict[tuple, torch.Tensor],
                            budget_bytes: int):
    """Partial offload: which moment leaves stay on the device under a
    byte budget (the JAX ``select_resident_moments`` at one process).

    Greedy, largest first over the float leaves with ``ndim >= 1``, ties
    in path order; ``moments`` maps path keys (``moment_key``) to tensors
    of the moments' shapes and dtypes (meta tensors do). Returns
    ``(frozenset of keys, bytes kept)``."""
    cands = sorted(((k, t.numel() * t.element_size())
                    for k, t in moments.items()
                    if t.dim() >= 1 and t.is_floating_point()),
                   key=lambda kv: (-kv[1], kv[0]))
    keep, used = set(), 0
    for key, size in cands:
        if used + size <= budget_bytes:
            keep.add(key)
            used += size
    return frozenset(keep), used


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX ``ParallelConfig``'s single-process fields.

    ``sharding_strategy`` is the fsdp CLI's choice (reference spellings
    allowed); at one process every strategy is the same step.
    ``cpu_offload`` keeps Adam's moments in pinned host memory and streams
    them through each update; ``offload_dtype`` is their host storage
    ("float32" keeps the step bitwise the on-device one, "bfloat16" halves
    the stream, "int8" quarters it); ``offload_budget_gb`` keeps the
    largest moment leaves that fit on the device in exact f32."""

    sharding_strategy: str = "replicated"
    cpu_offload: bool = False
    offload_dtype: str = "float32"
    offload_budget_gb: float = 0.0


def _moment_arrays(key: str, m: Moment) -> Dict[str, np.ndarray]:
    """Host copies of one stored moment under its checkpoint keys: f32 as
    f32, bf16 as its ``uint16`` bits, a pack as ``key/q`` and
    ``key/scale``."""
    if isinstance(m, QuantPack):
        return {f"{key}/q": m.q.detach().to("cpu", copy=True).numpy(),
                f"{key}/scale": m.scale.detach().to("cpu",
                                                    copy=True).numpy()}
    t = m.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return {key: t.view(torch.int16).numpy().view(np.uint16)}
    return {key: t.float().numpy()}


def _moment_targets(key: str, m: Moment) -> Dict[str, torch.Tensor]:
    if isinstance(m, QuantPack):
        return {f"{key}/q": m.q, f"{key}/scale": m.scale}
    return {key: m}


def _array_dtype(t: torch.Tensor):
    """The numpy dtype ``_moment_arrays`` stores ``t``'s storage as."""
    return {torch.bfloat16: np.dtype(np.uint16), torch.int8:
            np.dtype(np.int8)}.get(t.dtype, np.dtype(np.float32))


def _from_array(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _split_packed(batch: torch.Tensor):
    """``[rows, seq]`` -> ``(tokens, None)``; packed ``[rows, seq, 2]`` ->
    ``(tokens, segment_ids)`` (channel 0 tokens, channel 1 segment ids)."""
    if batch.dim() >= 3 and batch.shape[-1] == 2:
        return batch[..., 0], batch[..., 1]
    return batch, None


@dataclasses.dataclass
class TrainState:
    """Everything that evolves across steps."""

    step: int
    params: Dict[str, nn.Parameter]   # f32 masters, bound to the model
    opt_state: AdamWState
    generator: torch.Generator        # draws every dropout seed
    loss_scale: float                 # fp16 dynamic scaling; 1.0 else
    good_steps: int                   # consecutive finite steps (fp16)

    def _trees(self):
        return (("params", self.params), ("opt_state/mu", self.opt_state.mu),
                ("opt_state/nu", self.opt_state.nu))

    def _targets(self) -> Dict[str, torch.Tensor]:
        """Checkpoint key -> the tensor holding it."""
        want = {}
        for prefix, tree in self._trees():
            for name, m in tree.items():
                want.update(_moment_targets(
                    f"{prefix}/{name.replace('.', '/')}", m))
        return want

    def layout(self) -> Dict[str, tuple]:
        """Checkpoint key -> ``(shape, numpy dtype)`` of every array
        ``state_dict`` writes (the moments' storage form included)."""
        return {k: (tuple(t.shape), _array_dtype(t))
                for k, t in self._targets().items()}

    def _sync(self) -> None:
        """Wait for the device, host-link copies included."""
        if any(t.is_cuda for t in self.params.values()):
            torch.cuda.synchronize()

    def state_dict(self) -> dict:
        """A host copy of everything that evolves: f32 arrays
        ``params/<flax path>``, the moments under ``opt_state/mu/<path>``
        and ``opt_state/nu/<path>`` in their storage form (f32; bf16 as
        ``uint16`` bits; an int8 pack as ``<path>/q`` and
        ``<path>/scale``), with paths ``a/b/c`` as the JAX package's
        trees flatten, the generator's state as a ``uint8`` array
        ``generator``, and the scalars ``step``, ``opt_count``,
        ``loss_scale``, ``good_steps``. Every array is a copy taken after a
        device synchronize (host-resident moments too), so later in-place
        steps cannot reach it."""
        self._sync()
        out = {}
        for prefix, tree in self._trees():
            for name, m in tree.items():
                out.update(_moment_arrays(
                    f"{prefix}/{name.replace('.', '/')}", m))
        out["generator"] = self.generator.get_state().numpy().copy()
        out.update(step=int(self.step), opt_count=int(self.opt_state.count),
                   loss_scale=float(self.loss_scale),
                   good_steps=int(self.good_steps))
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``state_dict()``'s values into this state's tensors in
        place (they stay bound to the trainer's model). Raises on a
        missing, extra or misshaped array."""
        want = self._targets()
        have = {k for k in sd if "/" in k}
        if have != set(want):
            raise ValueError(
                f"state arrays do not match: missing "
                f"{sorted(set(want) - have)}, extra "
                f"{sorted(have - set(want))}")
        self._sync()
        with torch.no_grad():
            for key, t in want.items():
                arr = np.asarray(sd[key])
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: shape {arr.shape}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(_from_array(arr, t))
        self.generator.set_state(torch.from_numpy(
            np.asarray(sd["generator"], np.uint8).copy()))
        self.step = int(sd["step"])
        self.opt_state.count = int(sd["opt_count"])
        self.loss_scale = float(sd["loss_scale"])
        self.good_steps = int(sd["good_steps"])


class Trainer:
    """One device: ``init_state``, ``put_batch``, ``train_step``."""

    def __init__(self, model_config: GPTConfig,
                 training_config: TrainingConfig = TrainingConfig(),
                 parallel_config: ParallelConfig = ParallelConfig(), *,
                 device=None):
        dtype = _MP_TO_DTYPE[training_config.mixed_precision]
        self.model_config = dataclasses.replace(model_config, dtype=dtype)
        self.training_config = training_config
        self.parallel_config = parallel_config
        self.device = resolve_device(device)
        self.use_loss_scaling = training_config.mixed_precision == "fp16"
        self.model = GPT(self.model_config, device="meta")
        self.optimizer = make_optimizer(training_config)

        self.cpu_offload = parallel_config.cpu_offload
        if (self.cpu_offload
                and training_config.optimizer_state_dtype != "float32"):
            raise ValueError(
                "cpu_offload streams the optimizer state from host storage "
                "(--offload_dtype controls its width there); combine it "
                "with optimizer_state_dtype=float32 — the on-device "
                "quantized state targets HBM traffic, which offloaded "
                "state does not generate")
        if parallel_config.offload_dtype not in STATE_DTYPES:
            raise ValueError(
                f"offload_dtype {parallel_config.offload_dtype!r} not "
                f"supported; choose float32, bfloat16, or int8")
        self._offload_dtype = parallel_config.offload_dtype
        self._offload_keep = frozenset()
        self.offload_resident_bytes = 0   # the CLI's startup line
        if self.cpu_offload and parallel_config.offload_budget_gb > 0:
            self._offload_keep, self.offload_resident_bytes = (
                select_resident_moments(
                    self._moment_shapes(),
                    int(parallel_config.offload_budget_gb * 2**30)))
        # The last step's host-link copies (CUDA events), and bytes a way.
        self._link_events = None
        self.offload_stream_bytes = 0

    def _moment_shapes(self) -> Dict[tuple, torch.Tensor]:
        """Meta f32 tensors of every moment leaf, under ``moment_key``."""
        return {moment_key(m, n): torch.empty(p.shape, dtype=torch.float32,
                                              device="meta")
                for n, p in self.model.named_parameters()
                for m in ("mu", "nu")}

    # -- optimizer-state offload --------------------------------------------

    def _offload_store_leaf(self, key: tuple, x: torch.Tensor) -> Moment:
        """int8 packs leaves with ndim >= 2, bf16 casts those with ndim
        >= 1 (the JAX rules, not the on-device narrow state's)."""
        dt = self._offload_dtype
        if (key in self._offload_keep or not x.is_floating_point()
                or x.dim() < (2 if dt == "int8" else 1)):
            return x
        return store_moment(x, dt, nonneg=key[0] == "nu")

    def _offload_store(self, opt_state: AdamWState) -> AdamWState:
        """f32 moments -> their host storage form (the JAX
        ``Trainer._offload_store``): no-op for "float32" and for the
        device-resident leaves of a partial offload."""
        return AdamWState(opt_state.count, *(
            {n: self._offload_store_leaf(moment_key(m, n), x)
             for n, x in tree.items()}
            for m, tree in (("mu", opt_state.mu), ("nu", opt_state.nu))))

    def _offload_load(self, opt_state: AdamWState) -> AdamWState:
        """Host storage form -> f32 (the JAX ``Trainer._offload_load``)."""
        return AdamWState(opt_state.count, *(
            {n: load_moment(x, nonneg=m == "nu") for n, x in tree.items()}
            for m, tree in (("mu", opt_state.mu), ("nu", opt_state.nu))))

    def _to(self, m: Moment, device, *, pin: bool = False) -> Moment:
        def move(t):
            t = t.to(device, non_blocking=True)
            return t.pin_memory() if pin else t
        if isinstance(m, QuantPack):
            return QuantPack(q=move(m.q), scale=move(m.scale))
        return move(m)

    def _init_offloaded(self, params: Dict[str, torch.Tensor]
                        ) -> AdamWState:
        """Zero moments in their storage form: the streamed leaves made
        in host memory (pinned for a CUDA device), the kept ones on the
        device."""
        pin = self.device.type == "cuda"
        out = []
        for m in ("mu", "nu"):
            leaves = {}
            for n, p in params.items():
                key = moment_key(m, n)
                if key in self._offload_keep:
                    leaves[n] = torch.zeros(p.shape, dtype=torch.float32,
                                            device=self.device)
                else:
                    leaves[n] = self._to(self._offload_store_leaf(
                        key, torch.zeros(p.shape, dtype=torch.float32)),
                        "cpu", pin=pin)
            out.append(leaves)
        return AdamWState(0, *out)

    def _stream(self, state: TrainState, grads, lr: float) -> None:
        """The offloaded update, a leaf at a time: the leaf's moments host
        -> device, f32 load, the AdamW leaf update (applied to the
        parameter at once), store, device -> host into the same host
        buffers. Both copies are asynchronous on the current stream; only
        one leaf's moments are on the device at a time (kept leaves
        aside). Each copy runs between two CUDA events
        (``last_link_ms``)."""
        host = state.opt_state
        cuda = self.device.type == "cuda"
        ctx = self.optimizer.begin(grads, host.count)
        mask = decay_mask(state.params)
        events = {"h2d": [], "d2h": []}
        moved = 0

        def timed(way, copy):
            if not cuda:
                return copy()
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = copy()
            pair[1].record()
            events[way].append(pair)
            return out

        with torch.no_grad():
            for n, p in state.params.items():
                keys = {m: moment_key(m, n) for m in ("mu", "nu")}
                stored = {m: getattr(host, m)[n] for m in keys}
                work = {}
                for m, key in keys.items():
                    if key in self._offload_keep:
                        work[m] = stored[m]
                        continue
                    dev = timed("h2d", lambda: self._to(stored[m],
                                                        self.device))
                    work[m] = load_moment(dev, nonneg=m == "nu")
                u = self.optimizer.leaf(ctx, grads[n], work["mu"],
                                        work["nu"], p, mask[n])
                p.add_((u * lr).to(p.dtype))
                for m, key in keys.items():
                    if key in self._offload_keep:
                        continue
                    new = self._offload_store_leaf(key, work[m])
                    pairs = (zip(new.tensors(), stored[m].tensors())
                             if isinstance(new, QuantPack)
                             else ((new, stored[m]),))
                    for src, dst in pairs:
                        timed("d2h", lambda: dst.copy_(src,
                                                        non_blocking=True))
                        moved += src.numel() * src.element_size()
        self._link_events = events if cuda else None
        self.offload_stream_bytes = moved
        state.opt_state = AdamWState(ctx["count"], host.mu, host.nu)

    def last_link_ms(self) -> Optional[Dict[str, float]]:
        """The last offloaded step's host -> device and device -> host
        copy times (ms, the sums over its copies' CUDA events; waits for
        them), else None."""
        ev = self._link_events
        if ev is None:
            return None
        torch.cuda.synchronize()
        return {f"{way}_ms": sum(a.elapsed_time(b) for a, b in pairs)
                for way, pairs in ev.items()}

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """A fresh state: parameters from ``init_params(seed)`` (or the
        given state dict, e.g. ``from_jax_params``), zero moments, the
        dropout generator seeded from ``seed`` (default
        ``TrainingConfig.seed``)."""
        seed = self.training_config.seed if seed is None else int(seed)
        if params is None:
            params = init_params(self.model_config, seed, device=self.device)
        masters = {n: nn.Parameter(t.detach().to(self.device).clone())
                   for n, t in params.items()}
        self.model.load_state_dict(masters, strict=True, assign=True)
        masters = dict(self.model.named_parameters())
        opt_state = (self._init_offloaded(masters) if self.cpu_offload
                     else self.optimizer.init(masters))
        return TrainState(
            step=0, params=masters, opt_state=opt_state,
            generator=torch.Generator().manual_seed(seed),
            loss_scale=_INIT_LOSS_SCALE if self.use_loss_scaling else 1.0,
            good_steps=0)

    def put_batch(self, local_batch: np.ndarray, *,
                  non_blocking: bool = False) -> torch.Tensor:
        """Host ``[accum * bs, seq]`` (packed: ``[accum * bs, seq, 2]``) ->
        device int64 ``[accum, bs, seq(, 2)]``. Out-of-vocab ids raise.
        ``non_blocking`` copies to a CUDA device from pinned memory,
        asynchronously on the current stream."""
        accum = self.training_config.gradient_accumulation_steps
        batch = np.asarray(local_batch)
        packed = batch.ndim == 3
        n = batch.shape[0]
        if n % accum != 0:
            raise ValueError(f"batch rows {n} not divisible by accum {accum}")
        tokens = batch[..., 0] if packed else batch
        vocab = self.model_config.vocab_size
        if tokens.size and (int(tokens.max()) >= vocab
                            or int(tokens.min()) < 0):
            raise ValueError(
                f"batch contains token id {int(tokens.max())} outside "
                f"[0, {vocab}) — tokenizer/vocab_size mismatch")
        local = batch.reshape(accum, n // accum, *batch.shape[1:])
        host = torch.from_numpy(local.astype(np.int64))
        if non_blocking and self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _bind(self, state: TrainState) -> None:
        """Make the model compute with ``state``'s parameters."""
        if next(self.model.parameters()) is not next(iter(
                state.params.values())):
            self.model.load_state_dict(state.params, strict=True,
                                       assign=True)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Forward-only mean loss over one ``[rows, seq]`` (packed: ``[rows,
        seq, 2]``) batch, without dropout: a device scalar (no host sync).
        The rows run as the step's ``accum`` micro-batches, each through
        the training forward and fused loss (the flash forward and head +
        CE kernels on the card), and the micro-batch means are weighted by
        their counted targets, so the result is the mean over the whole
        batch, as the JAX ``eval_step`` takes it."""
        if not torch.is_tensor(batch):
            batch = self.put_batch(batch)
        self._bind(state)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        for micro in batch:
            tokens, segs = _split_packed(micro)
            _, loss = self.model(tokens, tokens, train=False,
                                 segment_ids=segs)
            if segs is None:
                n = float(tokens.shape[0] * (tokens.shape[1] - 1))
            else:
                n = segment_target_mask(segs)[:, :-1].sum()
            total += loss.float() * n
            count += n
        return total / torch.clamp(count, min=1.0)

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, dict]:
        """One optimizer step over ``accum`` micro-batches. ``batch`` is
        ``put_batch``'s device tensor or a host array (placed here).
        Metrics: ``loss`` (mean over micro-batches), ``lr``, ``grad_norm``
        (before clipping), ``loss_scale`` (the scale this step used)."""
        if not torch.is_tensor(batch):
            batch = self.put_batch(batch)
        cfg = self.training_config
        accum = cfg.gradient_accumulation_steps
        if batch.shape[0] != accum:
            raise ValueError(f"batch leading dim {batch.shape[0]} != accum "
                             f"{accum}")
        self._bind(state)
        names = list(state.params)
        leaves = [state.params[n] for n in names]
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for micro in batch:
            tokens, segs = _split_packed(micro)
            _, loss = self.model(tokens, tokens, train=True,
                                 segment_ids=segs,
                                 generator=state.generator)
            g = torch.autograd.grad(loss * state.loss_scale, leaves)
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
            loss_sum += loss.detach().float()
        denom = accum * state.loss_scale
        grads = {n: g / denom for n, g in zip(names, grads)}
        grad_norm = global_norm(grads.values())
        lr = cfg.lr_at(state.step)
        metrics = {"loss": float(loss_sum / accum), "lr": lr,
                   "grad_norm": float(grad_norm),
                   "loss_scale": state.loss_scale}

        finite = np.isfinite(metrics["grad_norm"])
        if self.cpu_offload and (finite or not self.use_loss_scaling):
            self._stream(state, grads, lr)
        elif finite or not self.use_loss_scaling:
            state.opt_state = self.optimizer.apply(
                grads, state.opt_state, state.params, lr)
        if self.use_loss_scaling:
            if finite:
                grew = state.good_steps + 1 >= _SCALE_GROWTH_INTERVAL
                if grew:
                    state.loss_scale = min(state.loss_scale * 2.0,
                                           _MAX_LOSS_SCALE)
                state.good_steps = 0 if grew else state.good_steps + 1
            else:
                state.loss_scale = max(state.loss_scale * 0.5, 1.0)
                state.good_steps = 0
        state.step += 1
        return state, metrics
