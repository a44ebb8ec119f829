"""The ZeRO placement rule (port of the data and fsdp part of
``tpu_trainer/parallel/sharding.py``).

The reference's strategies map onto which state a rank holds whole and
which it holds a slice of:

| reference mode  | ZeRO | params     | grads   | optimizer state |
|-----------------|------|------------|---------|-----------------|
| FULL_SHARD      | 3    | sharded    | sharded | sharded         |
| SHARD_GRAD_OP   | 2    | replicated | sharded | sharded         |
| NO_SHARD        | -    | replicated | replicated | replicated   |
| HYBRID_SHARD    | 3    | sharded over fsdp, replicated over data |

The FSDP rule is the JAX package's, shape only: a leaf shards its
**largest** dim that the fsdp size divides (ties go to the later dim) and
replicates when none does. It applies to the leaf as the checkpoint names
it, the stacked ``[num_layers, ...]`` ``layers.*`` leaf, so rank ``r``'s
slice is the JAX device ``r``'s addressable shard. Slices are contiguous
and equal: rank ``r`` holds ``[r * n / W, (r + 1) * n / W)`` of the
sharded dim. The tensor, expert and stage branches of the JAX rule belong
to axes this port does not run yet (``parallel/mesh.check_ported``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from tpu_trainer_torch.parallel.mesh import FSDP_AXIS

# Ours (zero3/zero2/replicated) with the reference's FSDP spellings.
STRATEGY_ALIASES = {
    "FULL_SHARD": "zero3",
    "SHARD_GRAD_OP": "zero2",
    "NO_SHARD": "replicated",
    "HYBRID_SHARD": "zero3",  # hybrid = zero3 rules + data axis > 1
    "zero3": "zero3",
    "zero2": "zero2",
    "replicated": "replicated",
    "ddp": "replicated",
}


def canonical_strategy(name: str) -> str:
    if name not in STRATEGY_ALIASES:
        raise ValueError(
            f"unknown sharding strategy {name!r}; choose from "
            f"{sorted(STRATEGY_ALIASES)}")
    return STRATEGY_ALIASES[name]


def fsdp_dim(shape, fsdp_size: int) -> Optional[int]:
    """The dim the FSDP rule shards, or None (replicated)."""
    if fsdp_size <= 1:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % fsdp_size == 0 and d >= fsdp_size:
            if best is None or d >= shape[best]:
                best = i
    return best


def fsdp_spec(shape, fsdp_size: int) -> Tuple[Optional[str], ...]:
    """The JAX ``fsdp_spec`` as a tuple: ``"fsdp"`` at the sharded dim and
    None elsewhere, ``()`` when the leaf replicates (what ``tuple(P(...))``
    gives for the JAX spec)."""
    d = fsdp_dim(shape, fsdp_size)
    if d is None:
        return ()
    return tuple(FSDP_AXIS if i == d else None for i in range(len(shape)))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Where one leaf is split: ``param_dim`` for the master parameter
    (ZeRO-3), ``state_dim`` for its gradient and Adam moments (ZeRO-2 and
    ZeRO-3); None is whole. ``world`` is the fsdp size."""

    shape: tuple
    param_dim: Optional[int]
    state_dim: Optional[int]
    world: int

    def shard_shape(self, dim: Optional[int]) -> tuple:
        if dim is None:
            return self.shape
        return tuple(n // self.world if i == dim else n
                     for i, n in enumerate(self.shape))


def leaf_specs(shapes: Dict[str, tuple], strategy: str,
               fsdp_size: int) -> Dict[str, LeafSpec]:
    """The per-leaf split of params, grads and moments under ``strategy``
    (reference or canonical spelling) on an fsdp axis of ``fsdp_size``:
    params shard under zero3 only, grads and moments under zero2 and
    zero3, every one by ``fsdp_dim``."""
    strategy = canonical_strategy(strategy)
    out = {}
    for name, shape in shapes.items():
        d = (fsdp_dim(shape, fsdp_size) if strategy in ("zero2", "zero3")
             else None)
        out[name] = LeafSpec(tuple(shape), d if strategy == "zero3" else None,
                             d, fsdp_size)
    return out
