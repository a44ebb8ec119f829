"""Optimizer (port of ``tpu_trainer/training/optimizer.py``, f32 state).

The JAX package's optax chain, written out: clip by global norm (optax's
formula: ``t`` kept when the norm is below the clip, else
``(t / norm) * clip``), then AdamW (``eps=1e-8``, bias-corrected moments,
decoupled weight decay on the names ``decay_mask`` selects) at unit
learning rate with the descent sign. The trainer scales the updates by
``lr_at(step)`` itself, so the schedule ticks on fp16 overflow-skipped
steps while Adam's count does not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tpu_trainer_torch.training.config import TrainingConfig

_NO_DECAY_MARKERS = ("norm", "bias")


def decay_mask(names) -> Dict[str, bool]:
    """True where weight decay applies: every parameter whose dotted name
    has no part containing "norm" or "bias" (the RMSNorm weights are
    excluded; projections and the tied embedding decay)."""
    return {n: not any(m in part.lower() for part in n.split(".")
                       for m in _NO_DECAY_MARKERS) for n in names}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """``clip_by_global_norm -> adamw(learning_rate=1.0, mask=decay_mask)``
    with f32 moments."""

    def __init__(self, config: TrainingConfig):
        self.clip = config.grad_clip
        self.b1, self.b2 = config.beta1, config.beta2
        self.eps = 1e-8
        self.weight_decay = config.weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return AdamWState(0, {n: zeros(p) for n, p in params.items()},
                          {n: zeros(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]):
        """``(updates, new_state)``; updates are the descent direction at
        unit LR. The moments are updated in place."""
        g_norm = global_norm(grads.values())
        clip = g_norm >= self.clip
        count = state.count + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        mask = decay_mask(params)
        updates = {}
        for n, g in grads.items():
            g = g.float()
            g = torch.where(clip, (g / g_norm) * self.clip, g)
            mu, nu = state.mu[n], state.nu[n]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if mask[n] and self.weight_decay:
                u = u + self.weight_decay * params[n].float()
            updates[n] = -u
        return updates, AdamWState(count, state.mu, state.nu)


def make_optimizer(config: TrainingConfig) -> AdamW:
    """The clipped AdamW at unit learning rate (f32 moments only)."""
    if config.optimizer_state_dtype != "float32":
        raise NotImplementedError(
            f"optimizer_state_dtype {config.optimizer_state_dtype!r} is not "
            f"ported yet (float32 only; ROADMAP Queue 1)")
    return AdamW(config)
