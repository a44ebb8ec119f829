"""Optimizer (port of ``tpu_trainer/training/optimizer.py``).

The JAX package's optax chain, written out: clip by global norm (optax's
formula: ``t`` kept when the norm is below the clip, else
``(t / norm) * clip``), then AdamW (``eps=1e-8``, bias-corrected moments,
decoupled weight decay on the names ``decay_mask`` selects) at unit
learning rate with the descent sign. The trainer scales the updates by
``lr_at(step)`` itself, so the schedule ticks on fp16 overflow-skipped
steps while Adam's count does not.

``optimizer_state_dtype`` (``scale_by_adam_quantized``): with "bfloat16" or
"int8" the moments of the large leaves (``ndim >= 2`` and at least 65,536
elements) are stored narrow, as a bf16 cast or a blockwise-int8
``QuantPack`` (``nu`` in sqrt-space); smaller leaves stay exact f32. The
update is the f32 recipe on the loaded moments: the only difference from
f32 Adam is the store and load rounding.

On a shard (ZeRO-2/3 at world > 1) the update is the same elementwise
recipe on each rank's slice of a leaf: the caller passes the global norm
(``begin(..., g_norm=)``: the all-reduced sum of the shards' squares) and
the full leaf shapes, which decide a leaf's moment storage as they do at
one process (``init(..., full_shapes=)``: the 65,536-element threshold is
the whole leaf's, so no leaf changes storage with the world size). A
slice of a leaf's last dim packs in the whole leaf's blocks
(``init(..., cuts=)``, ``utils/quant.BlockCut``), so a rank's int8 pack
is its slice of the one-process pack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch

from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.utils.quant import (
    BlockCut,
    QuantPack,
    dequantize_blockwise_int8,
    pack_shape,
    quantize_blockwise_int8,
)

_NO_DECAY_MARKERS = ("norm", "bias")
STATE_DTYPES = ("float32", "bfloat16", "int8")
# Leaves below this size keep f32 moments in the narrow modes.
_QUANT_MIN_SIZE = 65536

Moment = Union[torch.Tensor, QuantPack]


def decay_mask(names) -> Dict[str, bool]:
    """True where weight decay applies: every parameter whose dotted name
    has no part containing "norm" or "bias" (the RMSNorm weights are
    excluded; projections and the tied embedding decay)."""
    return {n: not any(m in part.lower() for part in n.split(".")
                       for m in _NO_DECAY_MARKERS) for n in names}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def q_eligible(shape) -> bool:
    """Does a leaf of ``shape`` get narrow moments (the JAX
    ``_q_eligible``)?"""
    return len(shape) >= 2 and math.prod(shape) >= _QUANT_MIN_SIZE


def store_moment(x: torch.Tensor, state_dtype: str, *,
                 nonneg: bool, cut: Optional[BlockCut] = None) -> Moment:
    """f32 ``x`` -> its stored form: f32 as is, a bf16 cast, or a pack
    (``cut``: ``x`` is a rank's slice of the leaf's last dim)."""
    if state_dtype == "int8":
        return quantize_blockwise_int8(x, nonneg=nonneg, cut=cut)
    if state_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def load_moment(m: Moment, *, nonneg: bool) -> torch.Tensor:
    """A stored moment -> f32 (a pack's blocks run along the last dim:
    ``quant.pack_shape``)."""
    if isinstance(m, QuantPack):
        return dequantize_blockwise_int8(m, pack_shape(m), torch.float32,
                                         nonneg=nonneg)
    return m.float()


def assign_moment(dst: Moment, src: Moment) -> None:
    """Copy ``src`` into ``dst``'s storage in place (same form)."""
    if isinstance(dst, QuantPack):
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, Moment]
    nu: Dict[str, Moment]


class AdamW:
    """``clip_by_global_norm -> adamw(learning_rate=1.0, mask=decay_mask)``
    with moments stored in ``state_dtype`` (large leaves only)."""

    def __init__(self, config: TrainingConfig):
        self.clip = config.grad_clip
        self.b1, self.b2 = config.beta1, config.beta2
        self.eps = 1e-8
        self.weight_decay = config.weight_decay
        self.state_dtype = config.optimizer_state_dtype

    def leaf_dtype(self, shape) -> str:
        """The storage of one leaf's moments."""
        return self.state_dtype if q_eligible(shape) else "float32"

    def init(self, params: Dict[str, torch.Tensor],
             full_shapes: Optional[Dict[str, tuple]] = None,
             cuts: Optional[Dict[str, BlockCut]] = None) -> AdamWState:
        """Zero moments shaped as ``params`` (a rank's shards at world >
        1), stored as the leaf's full shape (``full_shapes``, default the
        tensor's) decides; a leaf in ``cuts`` is a slice of its last dim
        and packs in the whole dim's blocks."""
        full_shapes = full_shapes or {}
        cuts = cuts or {}

        def zeros(n, p, nonneg):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return store_moment(z, self.leaf_dtype(full_shapes.get(
                n, tuple(p.shape))), nonneg=nonneg, cut=cuts.get(n))

        return AdamWState(0,
                          {n: zeros(n, p, False) for n, p in params.items()},
                          {n: zeros(n, p, True) for n, p in params.items()})

    def begin(self, grads: Dict[str, torch.Tensor], count: int,
              g_norm: Optional[torch.Tensor] = None) -> dict:
        """What every leaf's update shares: the clip test and factor, the
        new count and the bias corrections (in f32, as optax computes
        them). ``g_norm`` defaults to the global norm of ``grads``."""
        if g_norm is None:
            g_norm = global_norm(grads.values())
        count += 1
        t = torch.tensor(float(count), dtype=torch.float32)
        return {"g_norm": g_norm, "clip": g_norm >= self.clip,
                "count": count,
                "c1": 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t,
                "c2": 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t}

    def leaf(self, ctx: dict, g: torch.Tensor, mu_s: Moment, nu_s: Moment,
             param: torch.Tensor, decay: bool) -> torch.Tensor:
        """One leaf's update (descent direction at unit LR); its moments
        are updated in place, in their storage form."""
        g = g.float()
        g = torch.where(ctx["clip"], (g / ctx["g_norm"]) * self.clip, g)
        if isinstance(mu_s, torch.Tensor) and mu_s.dtype == torch.float32:
            mu, nu = mu_s, nu_s
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
        else:
            mu = self.b1 * load_moment(mu_s, nonneg=False) + (
                1.0 - self.b1) * g
            nu = self.b2 * load_moment(nu_s, nonneg=True) + (
                1.0 - self.b2) * g.square()
            dt, cut = (("int8", mu_s.cut) if isinstance(mu_s, QuantPack)
                       else ("bfloat16", None))
            assign_moment(mu_s, store_moment(mu, dt, nonneg=False, cut=cut))
            assign_moment(nu_s, store_moment(nu, dt, nonneg=True, cut=cut))
        u = (mu / ctx["c1"]) / (torch.sqrt(nu / ctx["c2"]) + self.eps)
        if decay and self.weight_decay:
            u = u + self.weight_decay * param.float()
        return -u

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor], state: AdamWState,
              params: Dict[str, torch.Tensor], lr: float,
              on_update=None,
              g_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One step: each leaf's update (the descent direction at unit LR)
        scaled by ``lr`` and added to its parameter in place, one leaf's
        update alive at a time; the moments are updated in place (their
        storage kept). ``on_update(name, new - old)`` sees each leaf's
        applied change (telemetry steps); ``g_norm``: ``begin``. Returns
        the state with the new count."""
        ctx = self.begin(grads, state.count, g_norm)
        mask = decay_mask(params)
        for n, g in grads.items():
            p = params[n]
            u = self.leaf(ctx, g, state.mu[n], state.nu[n], p, mask[n])
            apply_leaf(p, u * lr, n, on_update)
        return AdamWState(ctx["count"], state.mu, state.nu)


def apply_leaf(p: torch.Tensor, delta: torch.Tensor, name: str,
               on_update=None) -> None:
    """``p += delta`` in place; with ``on_update``, it is called with the
    change the add made (``new - old`` in the parameter's dtype)."""
    old = p.clone() if on_update is not None else None
    p.add_(delta.to(p.dtype))
    if on_update is not None:
        on_update(name, p - old)


def make_optimizer(config: TrainingConfig) -> AdamW:
    """The clipped AdamW at unit learning rate; raises the JAX
    ``ValueError`` on an unknown ``optimizer_state_dtype``."""
    if config.optimizer_state_dtype not in STATE_DTYPES:
        raise ValueError(
            f"optimizer_state_dtype {config.optimizer_state_dtype!r} not "
            f"supported; choose float32, bfloat16, or int8")
    return AdamW(config)
