"""The placement rules (port of the data, fsdp, tensor and expert part of
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
sharded dim.

**Tensor parallelism** (Megatron): by parameter-name suffix
(``_TENSOR_RULES``), the q/k/v and gate/up kernels shard their output dim
(column-parallel), o/down their input dim (row-parallel), the tied
embedding its hidden dim; in every strategy, when the tensor size divides
that dim. The fsdp dim is then the largest divisible dim that is not the
tensor dim (the JAX ``_leaf_spec`` order). Rank ``t`` of the tensor axis
holds slice ``t`` of the tensor dim, and its fsdp slice is of that.

**Expert parallelism**: the stacked expert leaves (``experts_gate`` /
``experts_up`` ``[L, E, H, I]``, ``experts_down`` ``[L, E, I, H]``) shard
their expert dim (``ndim - 3``) over the ``expert`` axis when its size
divides ``E`` (``expert_dim``, the JAX ``_expert_dim``), and their FFN dim
over ``tensor`` by the table; the router stays replicated. The order is
the JAX ``_leaf_spec``'s: expert, tensor, then fsdp over the dims left.
Rank ``x`` of the expert axis holds experts ``[x E / ep, (x + 1) E /
ep)``.

**Pipeline parallelism**: a stacked ``layers.*`` leaf ``[L, ...]`` shards
its leading dim over ``stage`` when the stage size divides ``L`` (the JAX
``_leaf_spec``'s first rule); everything outside the stack (the tied
embedding, the final norm) is replicated there, and the router, a layer
leaf, goes with its stage. The order is stage, then expert, tensor and
fsdp over the dims left. Stage rank ``s`` holds the layers
``parallel/pipeline.stage_layers`` names: a contiguous block of ``L / S``,
or under the interleaved schedule its ``v`` chunks (``virtual``), in
chunk order (``stage_slice``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from tpu_trainer_torch.parallel.mesh import (
    EXPERT_AXIS,
    FSDP_AXIS,
    STAGE_AXIS,
    TENSOR_AXIS,
)

# Megatron-style tensor-parallel placement by parameter-name suffix (the
# JAX table): column-parallel shards the output dim (last), row-parallel
# the input dim (second to last); the tied embedding its hidden dim.
_TENSOR_RULES: List[Tuple[Tuple[str, ...], int]] = [
    (("attention", "q_proj", "kernel"), -1),
    (("attention", "k_proj", "kernel"), -1),
    (("attention", "v_proj", "kernel"), -1),
    (("attention", "o_proj", "kernel"), -2),
    (("mlp", "gate_proj", "kernel"), -1),
    (("mlp", "up_proj", "kernel"), -1),
    (("mlp", "down_proj", "kernel"), -2),
    (("embed_tokens", "embedding"), -1),
    (("experts_gate",), -1),
    (("experts_up",), -1),
    (("experts_down",), -2),
]

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


def tensor_dim(name: str, shape, tensor_size: int) -> Optional[int]:
    """The dim of parameter ``name`` (``a.b.c``) that the tensor axis
    shards, or None (the JAX ``_tensor_dim``)."""
    if tensor_size <= 1 or not shape:
        return None
    keys = tuple(name.split("."))
    for suffix, dim in _TENSOR_RULES:
        if keys[-len(suffix):] == suffix:
            d = dim % len(shape)
            return d if shape[d] % tensor_size == 0 else None
    return None


def expert_dim(name: str, shape, expert_size: int) -> Optional[int]:
    """The dim of parameter ``name`` that the expert axis shards, or None
    (the JAX ``_expert_dim``): an ``experts_*`` leaf's ``ndim - 3`` when
    ``expert_size`` divides it."""
    if (expert_size <= 1 or len(shape) < 3
            or not name.split(".")[-1].startswith("experts_")):
        return None
    d = len(shape) - 3
    return d if shape[d] % expert_size == 0 else None


def fsdp_dim(shape, fsdp_size: int, exclude=None) -> Optional[int]:
    """The dim the FSDP rule shards, or None (replicated); ``exclude`` is
    a dim (or a collection of dims) the expert and tensor axes took."""
    if fsdp_size <= 1:
        return None
    taken = (set() if exclude is None else {exclude}
             if isinstance(exclude, int) else set(exclude))
    best = None
    for i, d in enumerate(shape):
        if i not in taken and d % fsdp_size == 0 and d >= fsdp_size:
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
    """Where one leaf is split: ``stage_dim`` over the stage axis (size
    ``stage``, ``virtual`` chunks a rank), ``tensor_dim`` over the tensor
    axis (size ``tensor``) and ``expert_dim`` over the expert axis (size
    ``expert``; params, grads and moments alike, every strategy),
    ``param_dim`` over fsdp for the master parameter (ZeRO-3),
    ``state_dim`` over fsdp for its gradient and Adam moments (ZeRO-2 and
    ZeRO-3); None is whole. ``shape`` is the global shape; ``world`` is
    the fsdp size."""

    shape: tuple
    param_dim: Optional[int]
    state_dim: Optional[int]
    world: int
    tensor_dim: Optional[int] = None
    tensor: int = 1
    expert_dim: Optional[int] = None
    expert: int = 1
    stage_dim: Optional[int] = None
    stage: int = 1
    virtual: int = 1

    @property
    def tp_shape(self) -> tuple:
        """A rank's shape of the leaf before any fsdp split: its stage,
        tensor and expert slices."""
        return tuple(n // self.tensor if i == self.tensor_dim
                     else n // self.expert if i == self.expert_dim
                     else n // self.stage if i == self.stage_dim else n
                     for i, n in enumerate(self.shape))

    def stage_layers(self, rank: int) -> List[int]:
        """The global layers stage rank ``rank`` holds, in local order
        (all of them when the stage axis does not split the leaf)."""
        from tpu_trainer_torch.parallel.pipeline import stage_layers

        if self.stage_dim is None:
            return list(range(self.shape[0]))
        return stage_layers(self.shape[0], self.stage, self.virtual, rank)

    def shard_shape(self, dim: Optional[int]) -> tuple:
        """A rank's shape of the leaf split on fsdp dim ``dim`` (None:
        only the tensor split)."""
        return tuple(n // self.world if i == dim else n
                     for i, n in enumerate(self.tp_shape))

    def partition(self, dim: Optional[int]) -> Tuple[Optional[str], ...]:
        """The JAX ``PartitionSpec`` of the leaf with fsdp dim ``dim``, as
        ``tuple(P(...))`` gives it (``()`` when replicated)."""
        axes = [None] * len(self.shape)
        if self.stage_dim is not None:
            axes[self.stage_dim] = STAGE_AXIS
        if self.expert_dim is not None:
            axes[self.expert_dim] = EXPERT_AXIS
        if self.tensor_dim is not None:
            axes[self.tensor_dim] = TENSOR_AXIS
        if dim is not None:
            axes[dim] = FSDP_AXIS
        return () if all(a is None for a in axes) else tuple(axes)


def stage_dim(name: str, shape, stage_size: int) -> Optional[int]:
    """0 for a stacked ``layers.*`` leaf whose layer count the stage size
    (above 1) divides, else None (the JAX ``_leaf_spec`` stage rule)."""
    if (stage_size <= 1 or not shape or name.split(".")[0] != "layers"
            or shape[0] % stage_size):
        return None
    return 0


def leaf_specs(shapes: Dict[str, tuple], strategy: str,
               fsdp_size: int, tensor_size: int = 1, expert_size: int = 1,
               stage_size: int = 1, virtual: int = 1
               ) -> Dict[str, LeafSpec]:
    """The per-leaf split of params, grads and moments under ``strategy``
    (reference or canonical spelling) on an fsdp axis of ``fsdp_size``, a
    tensor axis of ``tensor_size``, an expert axis of ``expert_size`` and
    a stage axis of ``stage_size`` (``virtual`` chunks a rank): the stage
    dim by ``stage_dim``, the expert dim by ``expert_dim`` and the tensor
    dim by ``tensor_dim`` in every strategy; then params shard over fsdp
    under zero3 only, grads and moments under zero2 and zero3, every one
    by ``fsdp_dim`` over the dims the other axes left."""
    strategy = canonical_strategy(strategy)
    out = {}
    for name, shape in shapes.items():
        g = stage_dim(name, shape, stage_size)
        e = expert_dim(name, shape, expert_size)
        t = tensor_dim(name, shape, tensor_size)
        if t == e:
            t = None
        d = (fsdp_dim(shape, fsdp_size, exclude={g, e, t} - {None})
             if strategy in ("zero2", "zero3") else None)
        out[name] = LeafSpec(tuple(shape), d if strategy == "zero3" else None,
                             d, fsdp_size, t, tensor_size, e, expert_size,
                             g, stage_size, virtual if g is not None else 1)
    return out


def _slice(arr, dim: Optional[int], size: int, rank: int):
    if dim is None:
        return arr
    k = arr.shape[dim] // size
    return arr[(slice(None),) * dim + (slice(rank * k, (rank + 1) * k),)]


def tensor_slice(arr, spec: LeafSpec, rank: int):
    """Tensor rank ``rank``'s slice of a global leaf ``arr`` (numpy or
    torch); the leaf itself when the tensor axis does not shard it."""
    return _slice(arr, spec.tensor_dim, spec.tensor, rank)


def expert_slice(arr, spec: LeafSpec, rank: int):
    """Expert rank ``rank``'s slice of a leaf ``arr`` (its experts); the
    leaf itself when the expert axis does not shard it."""
    return _slice(arr, spec.expert_dim, spec.expert, rank)


def stage_slice(arr, spec: LeafSpec, rank: int):
    """Stage rank ``rank``'s layers of a leaf ``arr`` (numpy or torch), in
    its local order; the leaf itself when the stage axis does not split
    it."""
    if spec.stage_dim is None:
        return arr
    idx = spec.stage_layers(rank)
    lo = idx[0]
    if idx == list(range(lo, lo + len(idx))):
        return arr[lo:lo + len(idx)]
    return arr[idx]


def local_slice(arr, spec: LeafSpec, tensor_rank: int = 0,
                expert_rank: int = 0, stage_rank: int = 0):
    """A rank's slice of a global leaf before any fsdp split: its stage's
    layers, of them its experts, and of those its tensor slice."""
    return tensor_slice(expert_slice(stage_slice(arr, spec, stage_rank),
                                     spec, expert_rank), spec, tensor_rank)
