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

Not ported yet (ROADMAP Queue 1): meshes and sharding, pipeline schedules,
CPU offload, narrow optimizer states, telemetry steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT, check_trainable
from tpu_trainer_torch.models.weights import init_params
from tpu_trainer_torch.ops.loss import segment_target_mask
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.optimizer import (
    AdamWState,
    global_norm,
    make_optimizer,
)
from tpu_trainer_torch.utils.device import resolve_device

_MP_TO_DTYPE = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
_SCALE_GROWTH_INTERVAL = 2000  # finite steps before the scale doubles
_MAX_LOSS_SCALE = 2.0**16
_INIT_LOSS_SCALE = 2.0**15


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

    def state_dict(self) -> dict:
        """A host copy of everything that evolves: f32 arrays
        ``params/<flax path>``, ``opt_state/mu/<path>`` and
        ``opt_state/nu/<path>`` (paths ``a/b/c``, as the JAX package's
        trees flatten), the generator's state as a ``uint8`` array
        ``generator``, and the scalars ``step``, ``opt_count``,
        ``loss_scale``, ``good_steps``. Copies of device tensors are taken
        after a synchronize, so later in-place steps cannot reach them."""
        if any(t.is_cuda for t in self.params.values()):
            torch.cuda.synchronize()
        out = {}
        for prefix, tree in (("params", self.params),
                             ("opt_state/mu", self.opt_state.mu),
                             ("opt_state/nu", self.opt_state.nu)):
            for name, t in tree.items():
                key = f"{prefix}/{name.replace('.', '/')}"
                out[key] = t.detach().to("cpu", torch.float32,
                                         copy=True).numpy()
        out["generator"] = self.generator.get_state().numpy().copy()
        out.update(step=int(self.step), opt_count=int(self.opt_state.count),
                   loss_scale=float(self.loss_scale),
                   good_steps=int(self.good_steps))
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``state_dict()``'s values into this state's tensors in
        place (they stay bound to the trainer's model). Raises on a
        missing, extra or misshaped array."""
        want = {}
        for prefix, tree in (("params", self.params),
                             ("opt_state/mu", self.opt_state.mu),
                             ("opt_state/nu", self.opt_state.nu)):
            for name, t in tree.items():
                want[f"{prefix}/{name.replace('.', '/')}"] = t
        have = {k for k in sd if "/" in k}
        if have != set(want):
            raise ValueError(
                f"state arrays do not match: missing "
                f"{sorted(set(want) - have)}, extra "
                f"{sorted(have - set(want))}")
        with torch.no_grad():
            for key, t in want.items():
                arr = np.asarray(sd[key])
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: shape {arr.shape}, want "
                                     f"{tuple(t.shape)}")
                t.copy_(torch.from_numpy(arr))
        self.generator.set_state(torch.from_numpy(
            np.asarray(sd["generator"], np.uint8).copy()))
        self.step = int(sd["step"])
        self.opt_state.count = int(sd["opt_count"])
        self.loss_scale = float(sd["loss_scale"])
        self.good_steps = int(sd["good_steps"])


class Trainer:
    """One device: ``init_state``, ``put_batch``, ``train_step``."""

    def __init__(self, model_config: GPTConfig,
                 training_config: TrainingConfig = TrainingConfig(), *,
                 device=None):
        dtype = _MP_TO_DTYPE[training_config.mixed_precision]
        self.model_config = dataclasses.replace(model_config, dtype=dtype)
        check_trainable(self.model_config)
        self.training_config = training_config
        self.device = resolve_device(device)
        self.use_loss_scaling = training_config.mixed_precision == "fp16"
        self.model = GPT(self.model_config, device="meta")
        self.optimizer = make_optimizer(training_config)

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
        return TrainState(
            step=0, params=masters, opt_state=self.optimizer.init(masters),
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
        if finite or not self.use_loss_scaling:
            updates, state.opt_state = self.optimizer.update(
                grads, state.opt_state, state.params)
            with torch.no_grad():
                for n, p in state.params.items():
                    p.add_((updates[n] * lr).to(p.dtype))
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
