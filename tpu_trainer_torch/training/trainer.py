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

Telemetry steps (``train_step(..., telemetry=True)``, the JAX
``_step_tel_jit``) compute the same update and add a ``"telemetry"``
subtree: per-layer gradient, parameter and update-to-parameter norms
(``utils/telemetry.group_norms``; the update norms are taken leaf by leaf
as the optimizer applies them, inside the host stream under offload),
activation RMS/absmax at every site the model records and, for MoE, the
router's stats. ``nan_scan`` runs one forward with the deep capture and
names the first non-finite site. Eager PyTorch has no executable cache
and no compiler cost model: ``RecompileWatchdog`` stays disarmed and
``step_cost_analysis`` returns None, as the JAX ones do on a backend that
hides those hooks.

Across processes (``ParallelConfig.mesh`` over ``data x fsdp``, one
process a device, ``torch.distributed`` joined by
``parallel/mesh.initialize_distributed``) each rank runs its own rows of
the global batch and the strategy's collectives run between the
micro-batch loop and the update (``parallel/collectives.py``, every sum
in rank order):

- ``replicated`` (DDP, ``NO_SHARD``): the f32 gradient sums are
  all-reduced over every rank, then each rank clips and updates its whole
  replica. With one micro-batch a rank it is bitwise the world-1 step
  with one micro-batch a rank of this one;
- ``zero2`` (``SHARD_GRAD_OP``): gradients are reduce-scattered onto each
  leaf's fsdp shard (``parallel/sharding.py``), the clip takes the norm
  from the all-reduced sum of the shards' squares, each rank updates its
  slice of the masters and its moments, and the masters are all-gathered;
- ``zero3`` (``FULL_SHARD``): masters and moments stay sharded at rest;
  the model gathers a block's parameters in its forward, frees them after
  it and gathers them again in the backward where the block's backward
  needs them (saved-tensor hooks; the rerun of the block under remat)
  (``models/gpt.py``), whose gradients are reduce-scattered as they
  leave the block;
- ``HYBRID_SHARD``: zero3 within each fsdp group, the shard gradients then
  all-reduced across the data groups (``data > 1 and fsdp > 1``).

The loss metric is the all-reduced mean, the same on every rank, and
``eval_step`` sums over every rank's rows. Rank ``r`` is data shard ``r``
(``data_feed_rank``): its residual-dropout mask is the world-1 mask's rows
of that shard and its attention-dropout seed folds in ``r``. At one
process there is no process group and the step is the single-device step
above, bit for bit. A MoE layer routes the global micro-batch (every
rank's rows in rank order) through the ``dp`` group (``models/moe.py``):
capacity, queue positions and the load fraction are the one-process
ones.

**Tensor and sequence axes** (``mesh.tensor`` / ``mesh.sequence``; rank
layout ``parallel/mesh.mesh_coords``). Under ``tensor`` every rank holds
its Megatron slice of the sharded leaves (``parallel/sharding.py``; the
fsdp split, under ZeRO, is then of that slice) and the model runs the
column/row-parallel forward (``models/gpt.py``): the gradient of a
tensor-sharded leaf stays the rank's, a replicated leaf's (norms) is the
same on every tensor rank and is not summed over ``tensor``; the
data/fsdp reduction runs within the tensor coordinate. Under
``sequence`` every rank holds the parameters whole (or its fsdp slice)
and runs its slice of the sequence (``put_batch`` cuts the columns and
the next one, for the global shift); gradients and the loss are summed
over the sequence ranks with the data shards, in rank order
(``collectives.Topology.rep`` / ``rep_data``). The global norm adds each
sharded leaf's sums of squares over the groups that shard it, once, and
the replicated leaves' once. The mesh is entered as
``parallel/context.use_mesh`` around every forward and backward.
``fused_projections`` is turned off under ``tensor`` (the JAX trainer's
rule); ``num_heads`` and ``kv_heads`` must divide by the tensor size and
``max_seq_len`` by the sequence size. Narrow and offloaded moments, remat
and telemetry steps take a tensor shard as they take a ZeRO shard.

**Expert axis** (``mesh.expert``, innermost). A MoE model's expert leaves
shard their expert dim over it (``parallel/sharding.py``); everything
else is replicated there, and the ranks along it read the same rows.
Each MoE layer routes the global micro-batch over ``Topology.rep`` (the
ranks that hold distinct tokens: data, fsdp and sequence), runs the
rank's local experts and sums the output over the expert and tensor
ranks (``models/moe.py``), so a replicated leaf's gradient is the same
on every expert rank and is summed over ``rep`` alone, as under tensor;
an expert leaf's is the rank's slice. The checks are the JAX trainer's:
an expert axis above 1 needs ``num_experts > 0`` dividing by it.

**Stage axis** (``mesh.stage``, innermost; ``parallel/pipeline.py``).
Each rank holds its stage's layers of the stacked leaves (a block, or
its chunks under the interleaved schedule) and the embedding and final
norm whole; the ranks along it read the same rows. A micro-batch of the
step runs as ``pipeline_microbatches`` strided microbatches through the
schedule the model config names (``GPT.pipeline_step``: GPipe, 1F1B or
interleaved), which returns the loss, the same on every stage rank, and
the rank's gradients; a leaf outside the stack has a partial gradient
on each stage rank, summed over the stage group once in ``_reduce``, and
the global norm adds the layer leaves' sums of squares over the stage
group. The checks are the JAX trainer's (the layers divide by the stage
count, by ``S v`` interleaved, ``M`` by ``S`` interleaved, the global
batch by ``M``), and the table is checked at start-up
(``pipeline.check_schedule``). A telemetry step keeps the norms and
skips the activation capture, as in JAX; ``eval_step`` and ``nan_scan``
run the forward alone in the schedule's ``pipeline_microbatches``
microbatches, as the JAX model's pipeline branch does (a capacity
router's capacity and aux are per microbatch; an interleaved model's
chunks run in their global layer order). A stage
axis beside a tensor axis is not ported yet (``NotImplementedError``).

The moments' narrow forms and the offload hold on a shard too: a rank's
moments are its slice, int8 packs of a slice of a leaf's last dim keep
the whole leaf's blocks (``utils/quant.BlockCut``: a rank's pack is its
slice of the one-process pack, and the checkpoint holds the one-process
pack, so it restores at any world size), ``offload_budget_gb`` is per
device (a kept leaf costs its shard's bytes), and the offloaded update
streams the rank's slices. A telemetry step's numbers are the global
batch's and the global leaves' (``utils/telemetry.combine_ranks``: one
all-gather of the activation and router stats over the ranks that hold
distinct tokens, and one all-reduce of the norms' shard sums over each
of the fsdp, tensor and expert groups that split a leaf), and
``nan_scan`` scans micro-batch 0 of the global batch, every rank
reporting the earliest site that is non-finite on any rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.models.weights import init_params
from tpu_trainer_torch.ops.loss import segment_target_mask
from tpu_trainer_torch.parallel import collectives as coll_lib
from tpu_trainer_torch.parallel import context as ctx_lib
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.parallel import pipeline as pp_lib
from tpu_trainer_torch.parallel.mesh import MeshConfig
from tpu_trainer_torch.parallel.sharding import (
    LeafSpec,
    canonical_strategy,
    fsdp_dim,
    leaf_specs,
    local_slice,
)
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.optimizer import (
    STATE_DTYPES,
    AdamWState,
    Moment,
    apply_leaf,
    decay_mask,
    global_norm,
    load_moment,
    make_optimizer,
    store_moment,
)
from tpu_trainer_torch.utils import telemetry as telemetry_lib
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.quant import (
    BlockCut,
    QuantPack,
    cut_boxes,
    cut_from_global,
    cut_global_shapes,
)

_MP_TO_DTYPE = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}
_SCALE_GROWTH_INTERVAL = 2000  # finite steps before the scale doubles
_MAX_LOSS_SCALE = 2.0**16
_INIT_LOSS_SCALE = 2.0**15


def moment_key(moment: str, name: str) -> tuple:
    """``("mu" | "nu", *flax path)``: the JAX moment leaf's path keys
    after the optax chain's own prefix."""
    return (moment,) + tuple(name.split("."))


def select_resident_moments(moments: Dict[tuple, torch.Tensor],
                            budget_bytes: int, shard_count: int = 1):
    """Partial offload: which moment leaves stay on the device under a
    byte budget (the JAX ``select_resident_moments``).

    Greedy, largest first over the float leaves with ``ndim >= 1``, ties
    in path order; ``moments`` maps path keys (``moment_key``) to tensors
    of the moments' shapes and dtypes (meta tensors do). ``shard_count``
    is the fsdp size under zero2 and zero3: a leaf the FSDP rule shards
    costs its shard's bytes of the device (the budget is per device), a
    leaf with no fsdp-divisible dim its full bytes. Returns
    ``(frozenset of keys, bytes kept)``."""
    def cost(t):
        size = t.numel() * t.element_size()
        if shard_count > 1 and fsdp_dim(tuple(t.shape),
                                         shard_count) is not None:
            size = -(-size // shard_count)
        return size

    cands = sorted(((k, cost(t)) for k, t in moments.items()
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
    """The JAX ``ParallelConfig``: the process mesh and the strategy.

    ``mesh`` carves the processes into ``data x fsdp x sequence x tensor
    x expert x stage`` (``-1`` = the rest).
    ``sharding_strategy`` is the fsdp CLI's choice (reference spellings
    allowed); at one process every strategy is the same step.
    ``cpu_offload`` keeps Adam's moments in pinned host memory and streams
    them through each update; ``offload_dtype`` is their host storage
    ("float32" keeps the step bitwise the on-device one, "bfloat16" halves
    the stream, "int8" quarters it); ``offload_budget_gb`` keeps the
    largest moment leaves that fit on the device in exact f32."""

    mesh: MeshConfig = MeshConfig()
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


def _shard_of(arr: np.ndarray, dim: Optional[int], index: int,
              world: int, layers=None) -> np.ndarray:
    """Slice ``index`` of ``world`` equal slices of ``arr`` along ``dim``
    (``layers``: those indices of ``dim`` instead, in order)."""
    if dim is None:
        return arr
    if layers is not None:
        return np.take(arr, layers, axis=dim)
    k = arr.shape[dim] // world
    return arr[(slice(None),) * dim + (slice(index * k, (index + 1) * k),)]


def _runs(layers) -> list:
    """``[(local start, global start, length)]``: ``layers`` (global
    indices in local order) as runs of consecutive indices."""
    out = []
    for i, g in enumerate(layers):
        if out and out[-1][1] + out[-1][2] == g:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((i, g, 1))
    return out


def _split_box(starts: list, arr: np.ndarray, dim: int, layers) -> list:
    """A box ``(starts, arr)`` whose ``dim`` holds the global indices
    ``layers`` (in order), as boxes of consecutive indices."""
    out = []
    for lo, g, n in _runs(layers):
        st = list(starts)
        st[dim] = g
        out.append((tuple(st), arr[(slice(None),) * dim
                                   + (slice(lo, lo + n),)]))
    return out


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """Which slice of each leaf a rank holds at world > 1: ``specs``
    (``parallel/sharding.leaf_specs``), the rank's fsdp, tensor, expert,
    stage and sequence coordinates, and whether it writes checkpoint
    shards (the ranks of data and sequence coordinate 0 hold every
    element once; of them, for each of the fsdp, tensor, expert and stage
    axes that does not split a leaf, its rank 0 writes; a stage rank's
    interleaved layers are written as one box a chunk)."""

    specs: Dict[str, LeafSpec]
    fsdp_rank: int
    data_coord: int
    world: int                        # the fsdp size
    tensor_rank: int = 0
    tensor: int = 1                   # the tensor size
    seq_coord: int = 0
    expert_rank: int = 0
    expert: int = 1                   # the expert size
    stage_rank: int = 0
    stage: int = 1                    # the stage size

    def _spec(self, key: str) -> Tuple[LeafSpec, bool]:
        prefix, _, path = key.partition("/")
        if prefix == "params":
            return self.specs[path.replace("/", ".")], True
        path = path.partition("/")[2]          # after "mu" / "nu"
        head, _, tail = path.rpartition("/")
        if tail in ("q", "scale") and head.replace("/", ".") in self.specs:
            path = head                        # a pack: the leaf's dim
        return self.specs[path.replace("/", ".")], False

    def dim(self, key: str) -> Optional[int]:
        """The fsdp-sharded dim of checkpoint key ``key``."""
        spec, param = self._spec(key)
        return spec.param_dim if param else spec.state_dim

    def axes(self, key: str) -> list:
        """``(dim, rank, size, layers)`` of the stage, fsdp, tensor and
        expert axes for checkpoint key ``key``: the dim each splits (None:
        it does not), this rank's coordinate and the size along it, and
        for the stage axis under the interleaved schedule the global
        layers the rank holds (None: its block ``rank`` of ``size``)."""
        spec = self._spec(key)[0]
        layers = (spec.stage_layers(self.stage_rank)
                  if spec.stage_dim is not None and spec.virtual > 1
                  else None)
        return [(spec.stage_dim, self.stage_rank, self.stage, layers),
                (self.dim(key), self.fsdp_rank, self.world, None),
                (spec.tensor_dim, self.tensor_rank, self.tensor, None),
                (spec.expert_dim, self.expert_rank, self.expert, None)]


@dataclasses.dataclass
class TrainState:
    """Everything that evolves across steps. At world > 1 ``params`` and
    the moments hold this rank's slices (``sharding``); checkpoint arrays
    stay global (``layout``, ``load_state_dict``, ``shard_records``)."""

    step: int
    params: Dict[str, nn.Parameter]   # f32 masters, bound to the model
    opt_state: AdamWState
    generator: torch.Generator        # draws every dropout seed
    loss_scale: float                 # fp16 dynamic scaling; 1.0 else
    good_steps: int                   # consecutive finite steps (fp16)
    sharding: Optional[StateSharding] = None

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

    def _cut_packs(self) -> Dict[str, QuantPack]:
        """Checkpoint key prefix -> the packs of a slice of a leaf's last
        dim (``BlockCut``): their arrays are not one box of the global
        pack, so they take ``cut_boxes`` / ``cut_from_global``."""
        return {f"{prefix}/{name.replace('.', '/')}": m
                for prefix, tree in self._trees() for name, m in tree.items()
                if isinstance(m, QuantPack) and m.cut is not None}

    def _axes(self, key: str) -> list:
        """``StateSharding.axes`` of ``key`` (none at one process)."""
        return [] if self.sharding is None else self.sharding.axes(key)

    def _lead(self, key: str, ndim: int) -> list:
        """The axes of ``key`` that split one of its first ``ndim`` dims
        (a cut pack's leading dims)."""
        return [ax for ax in self._axes(key)
                if ax[0] is not None and ax[0] < ndim]

    def layout(self) -> Dict[str, tuple]:
        """Checkpoint key -> ``(global shape, numpy dtype)`` of every
        array ``state_dict`` writes (the moments' storage form
        included)."""
        out = {}
        for k, t in self._targets().items():
            shape = list(t.shape)
            for d, _, n, _ in self._axes(k):
                if d is not None:
                    shape[d] *= n
            out[k] = (tuple(shape), _array_dtype(t))
        for k, m in self._cut_packs().items():
            qs, ss = cut_global_shapes(m, out[f"{k}/q"][0][:-2])
            out[f"{k}/q"] = (qs, out[f"{k}/q"][1])
            out[f"{k}/scale"] = (ss, out[f"{k}/scale"][1])
        return out

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
        steps cannot reach it. One process only: at world > 1 a rank
        holds slices (``shard_records``)."""
        if self.sharding is not None:
            raise ValueError("state_dict() holds whole arrays: at world > 1 "
                             "take shard_records()")
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

    def shard_records(self) -> list:
        """This rank's slices of every array, for the multi-process
        checkpoint (the JAX ``host_shard_snapshot``): ``[{key,
        global_shape, dtype, shards: [(starts, ndarray)]}]`` with the keys
        and storage forms of ``state_dict``. Each element is written by one
        rank (``StateSharding``); the scalars ride in ``meta.json``. Host
        copies taken after a device synchronize."""
        self._sync()
        sh = self.sharding
        write_sharded = sh is None or (sh.data_coord == 0
                                       and sh.seq_coord == 0)
        write_whole = sh is None or (write_sharded and sh.fsdp_rank == 0
                                     and sh.tensor_rank == 0
                                     and sh.expert_rank == 0
                                     and sh.stage_rank == 0)
        layout = self.layout()

        def place(key, arr):
            """This rank's ``arr``'s starts in the global array, whether it
            writes them (one rank of its replicas), and the stage split
            (dim and global layers) when the rank's layers are not one
            block."""
            starts, mine, split = [0] * arr.ndim, write_sharded, None
            for d, r, n, layers in self._axes(key):
                if d is None:
                    mine = mine and r == 0
                elif layers is not None:
                    split = (d, layers)
                else:
                    starts[d] = r * arr.shape[d]
            return starts, mine, split

        def boxes(starts, arr, split):
            if split is None:
                return [(tuple(starts), arr)]
            return _split_box(starts, arr, *split)

        out = []
        for prefix, tree in self._trees():
            for name, m in tree.items():
                key = f"{prefix}/{name.replace('.', '/')}"
                if isinstance(m, QuantPack) and m.cut is not None:
                    arrs = _moment_arrays(key, m)
                    starts, mine, split = place(f"{key}/q", arrs[f"{key}/q"])
                    got = {"q": [], "scale": []}
                    parts = zip(boxes(starts, arrs[f"{key}/q"], split),
                                boxes(starts[:-1], arrs[f"{key}/scale"],
                                      split))
                    for (st, q), (_, sc) in parts:
                        qb, sb = cut_boxes(q, sc, m.cut, st[:-2])
                        got["q"] += qb
                        got["scale"] += sb
                    for k, b in got.items():
                        k = f"{key}/{k}"
                        out.append({"key": k, "global_shape": layout[k][0],
                                    "dtype": str(arrs[k].dtype),
                                    "shards": [(s, a.copy()) for s, a in b]
                                    if mine else []})
                    continue
                for k, arr in _moment_arrays(key, m).items():
                    starts, mine, split = place(k, arr)
                    out.append({"key": k, "global_shape": layout[k][0],
                                "dtype": str(arr.dtype),
                                "shards": boxes(starts, arr, split) if mine
                                else []})
        gen = self.generator.get_state().numpy().copy()
        out.append({"key": "generator", "global_shape": gen.shape,
                    "dtype": str(gen.dtype),
                    "shards": [((0,), gen)] if write_whole else []})
        return out

    def scalars(self) -> dict:
        return {"step": int(self.step), "opt_count": int(self.opt_state.count),
                "loss_scale": float(self.loss_scale),
                "good_steps": int(self.good_steps)}

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``state_dict()``'s values into this state's tensors in
        place (they stay bound to the trainer's model). At world > 1 the
        arrays are the global ones (of any world's checkpoint) and this
        rank takes its slices. Raises on a missing, extra or misshaped
        array."""
        want = self._targets()
        have = {k for k in sd if "/" in k}
        if have != set(want):
            raise ValueError(
                f"state arrays do not match: missing "
                f"{sorted(set(want) - have)}, extra "
                f"{sorted(have - set(want))}")
        self._sync()
        cuts = {}
        for k, m in self._cut_packs().items():
            q_all, s_all = (np.asarray(sd[f"{k}/q"]),
                            np.asarray(sd[f"{k}/scale"]))
            for d, r, n, layers in self._lead(f"{k}/q", q_all.ndim - 2):
                q_all = _shard_of(q_all, d, r, n, layers)
                s_all = _shard_of(s_all, d, r, n, layers)
            q, sc = cut_from_global(q_all, s_all, m.cut)
            cuts.update({f"{k}/q": q, f"{k}/scale": sc})
        with torch.no_grad():
            layout = self.layout()
            for key, t in want.items():
                arr = np.asarray(sd[key])
                if tuple(arr.shape) != layout[key][0]:
                    raise ValueError(f"{key}: shape {arr.shape}, want "
                                     f"{layout[key][0]}")
                if key in cuts:
                    arr = cuts[key]
                else:
                    for d, r, n, layers in self._axes(key):
                        arr = _shard_of(arr, d, r, n, layers)
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


def _assign_params(model: nn.Module, params: Dict[str, nn.Parameter]
                   ) -> None:
    """Bind ``params`` (shard-shaped at world > 1) to ``model`` by name,
    in place of its parameters."""
    for name, p in params.items():
        module, attr = name.rsplit(".", 1)
        model.get_submodule(module)._parameters[attr] = p


class Trainer:
    """One device a process: ``init_state``, ``put_batch``,
    ``train_step``."""

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
        self.process_index = mesh_lib.process_index()
        self.process_count = mesh_lib.process_count()
        self.mesh_sizes = parallel_config.mesh.resolve(self.process_count)
        self._check_intra_layer(parallel_config)
        self._check_stage()
        self.model = GPT(self.model_config, device="meta")
        self.optimizer = make_optimizer(training_config)
        self._init_mesh(parallel_config)

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
                    int(parallel_config.offload_budget_gb * 2**30),
                    shard_count=(self.mesh_sizes[1] if self.strategy
                                 in ("zero2", "zero3") else 1)))
        # The last step's host-link copies (CUDA events), and bytes a way.
        self._link_events = None
        self.offload_stream_bytes = 0

    def _check_intra_layer(self, parallel_config: ParallelConfig) -> None:
        """The sequence, expert and tensor axes' rules (the JAX trainer's
        errors; ``fused_projections`` turned off under tensor)."""
        cfg = self.model_config
        tc = self.training_config
        seq, tensor, expert = self.mesh_sizes[2:5]
        if seq > 1 and tc.max_seq_len % seq != 0:
            raise ValueError(f"max_seq_len {tc.max_seq_len} not divisible "
                             f"by sequence axis size {seq}")
        if expert > 1:
            if cfg.num_experts <= 0:
                raise ValueError("expert mesh axis > 1 requires a MoE model "
                                 "(GPTConfig.num_experts > 0)")
            if cfg.num_experts % expert != 0:
                raise ValueError(f"num_experts {cfg.num_experts} not "
                                 f"divisible by expert axis size {expert}")
        if tensor > 1:
            if cfg.num_heads % tensor != 0:
                raise ValueError(f"num_heads {cfg.num_heads} not divisible "
                                 f"by tensor axis size {tensor}")
            if cfg.kv_heads % tensor != 0:
                raise ValueError(
                    f"num_kv_heads {cfg.kv_heads} not divisible by tensor "
                    f"axis size {tensor} (each tensor shard must own whole "
                    f"K/V-head groups)")
            if cfg.fused_projections:
                self.model_config = dataclasses.replace(
                    cfg, fused_projections=False)

    @property
    def stage_size(self) -> int:
        return self.mesh_sizes[5]

    def _check_stage(self) -> None:
        """The pipeline's rules (the JAX trainer's errors): the stage
        size divides the layers (into ``S v`` chunks under interleaved),
        interleaved needs ``M`` divisible by ``S``, and the global batch
        divides into ``M`` microbatches. A stage axis with a tensor axis
        is not ported."""
        S = self.stage_size
        if S <= 1:
            return
        cfg = self.model_config
        if cfg.num_layers % S != 0:
            raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                             f"stage axis size {S}")
        if self.mesh_sizes[3] > 1:
            raise NotImplementedError(
                "not ported yet: --mesh_tensor with --mesh_stage -> ROADMAP "
                "Queue 1: pipeline under the tensor axis")
        M = cfg.pipeline_microbatches or S
        if cfg.pipeline_schedule == "interleaved":
            v = cfg.pipeline_virtual_stages
            if cfg.num_layers % (S * v):
                raise ValueError(f"num_layers {cfg.num_layers} not divisible "
                                 f"by stages*virtual ({S}*{v})")
            if M % S:
                raise ValueError(
                    f"interleaved schedule needs pipeline_microbatches ({M}) "
                    f"divisible by the stage count ({S})")
        dp = mesh_lib.dp_size(self.mesh_sizes)
        rows = self.training_config.batch_size * dp
        if rows % M != 0:
            raise ValueError(
                f"global batch {rows} rows (batch_size "
                f"{self.training_config.batch_size} x {dp} data shards) not "
                f"divisible by pipeline_microbatches {M}")

    def _init_mesh(self, parallel_config: ParallelConfig) -> None:
        """The rank surface and, at world > 1, the groups, the per-leaf
        split, the model's ZeRO-3 gather, data shard and MoE routing
        group, and the mesh context of the sequence, tensor and expert
        axes."""
        self.strategy = canonical_strategy(parallel_config.sharding_strategy)
        data, fsdp, seq, tensor, expert, stage = self.mesh_sizes
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        v = pp_lib.virtual_stages(self.model_config)
        self.specs = leaf_specs(shapes, self.strategy, fsdp, tensor, expert,
                                stage, v)
        self.topology = None
        self.mesh_context = None
        self.schedule = None
        # The last pipelined step's point-to-point traffic and waits.
        self.pipeline_stats = pp_lib.Stats()
        self._cuts: Dict[str, BlockCut] = {}
        if self.process_count == 1:
            return
        self.topology = topo = coll_lib.topology(data, fsdp, seq, tensor,
                                                 expert, stage)
        if stage > 1:
            cfg = self.model_config
            self.schedule = pp_lib.make_schedule(
                cfg.pipeline_schedule, stage,
                pp_lib.num_microbatches(cfg, stage), v)
            # Every rank refuses a table its executor would break on (a
            # window below the simulated one), before any message moves.
            pp_lib.check_schedule(self.schedule)
            self.model.stage_layers = pp_lib.stage_layers(
                cfg.num_layers, stage, v, topo.stage_coord)
        self.mesh_context = ctx_lib.MeshContext(
            sizes=self.mesh_sizes,
            coords=mesh_lib.mesh_coords(self.mesh_sizes, self.process_index),
            tensor=topo.tensor if tensor > 1 else None,
            sequence=topo.sequence if seq > 1 else None,
            permute=(coll_lib.SequencePermute(topo.sequence) if seq > 1
                     else None),
            expert=topo.expert if expert > 1 else None,
            expert_tensor=(topo.expert_tensor if tensor * expert > 1
                           else None),
            stage=topo.stage if stage > 1 else None,
            schedule=self.schedule)
        for n, sp in self.specs.items():
            # A slice of a leaf's last dim (int8 blocks run along it): the
            # fsdp shard's, else the tensor slice's.
            last = len(sp.shape) - 1
            if sp.state_dim is not None and sp.state_dim == last:
                group, size, r = topo.fsdp, fsdp, topo.fsdp.rank
            elif sp.tensor_dim is not None and sp.tensor_dim == last:
                group, size, r = topo.tensor, tensor, topo.tensor_coord
            else:
                continue
            full = sp.shape[last]
            k = full // size
            self._cuts[n] = BlockCut(r * k, (r + 1) * k, full, group=group)
        if self.strategy == "zero3":
            self.model.zero3 = coll_lib.ZeroGather(
                self.topology.fsdp,
                {n: s.param_dim for n, s in self.specs.items()
                 if s.param_dim is not None})
        self.model.data_shard = (self.topology.dp_rank, self.dp_size)
        if self.model_config.num_experts > 0:
            self.model.moe_group = self.topology.rep

    # -- the rank surface (the reference's rank / world_size) ---------------

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def dp_size(self) -> int:
        """Distinct data shards: data x fsdp."""
        return mesh_lib.dp_size(self.mesh_sizes)

    @property
    def _feed_info(self):
        c = self.training_config
        return mesh_lib.host_feed_info(
            self.mesh_sizes, c.batch_size * self.dp_size,
            process_index=self.process_index)

    @property
    def data_feed_rank(self) -> int:
        """The block of the global batch rows this process loads."""
        return self._feed_info[0]

    @property
    def data_feed_world(self) -> int:
        return self._feed_info[1]

    @property
    def global_batch_size(self) -> int:
        """Sequences consumed per optimizer step, across all processes."""
        c = self.training_config
        return c.batch_size * c.gradient_accumulation_steps * self.dp_size

    @property
    def feed_signature(self) -> dict:
        """What a persisted loader cursor's units depend on
        (``utils/checkpoint.remap_data_state``); under a sequence axis
        also ``seq_shards``, its size, which says how a row's columns were
        split (the rows themselves do not depend on it)."""
        sig = {"global_batch_size": self.global_batch_size,
               "feed_world": self.data_feed_world}
        if self.mesh_sizes[2] > 1:
            sig["seq_shards"] = self.mesh_sizes[2]
        return sig

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch_size * self.training_config.max_seq_len

    def _sharded(self) -> bool:
        return self.topology is not None and any(
            self._shard_axes(n) for n in self.specs)

    def _shard_axes(self, name: str, param: bool = False) -> tuple:
        """The axes of which this rank holds a slice of ``name``'s
        gradient, update and moments (``param``: its master), among
        ``fsdp``, ``tensor`` and ``expert`` (empty at one process)."""
        if self.topology is None:
            return ()
        sp = self.specs[name]
        d = sp.param_dim if param else sp.state_dim
        return tuple(ax for ax, on in (("fsdp", d is not None),
                                       ("tensor", sp.tensor_dim is not None),
                                       ("expert", sp.expert_dim is not None),
                                       ("stage", sp.stage_dim is not None))
                     if on)

    def _state_shapes(self) -> Dict[str, tuple]:
        """This rank's shape of every moment leaf (its slice under zero2
        and zero3), in parameter order."""
        return {n: sp.shard_shape(sp.state_dim)
                for n, sp in self.specs.items()}

    def _moment_shapes(self) -> Dict[tuple, torch.Tensor]:
        """Meta f32 tensors of every moment leaf (a tensor rank's slice),
        under ``moment_key``."""
        return {moment_key(m, n): torch.empty(sp.tp_shape,
                                              dtype=torch.float32,
                                              device="meta")
                for n, sp in self.specs.items() for m in ("mu", "nu")}

    # -- optimizer-state offload --------------------------------------------

    def _offload_store_leaf(self, key: tuple, x: torch.Tensor) -> Moment:
        """int8 packs leaves with ndim >= 2, bf16 casts those with ndim
        >= 1 (the JAX rules, not the on-device narrow state's)."""
        dt = self._offload_dtype
        if (key in self._offload_keep or not x.is_floating_point()
                or x.dim() < (2 if dt == "int8" else 1)):
            return x
        return store_moment(x, dt, nonneg=key[0] == "nu",
                            cut=self._cuts.get(".".join(key[1:])))

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
            return QuantPack(q=move(m.q), scale=move(m.scale), cut=m.cut)
        return move(m)

    def _init_offloaded(self) -> AdamWState:
        """Zero moments (this rank's slices) in their storage form: the
        streamed leaves made in host memory (pinned for a CUDA device),
        the kept ones on the device."""
        pin = self.device.type == "cuda"
        out = []
        for m in ("mu", "nu"):
            leaves = {}
            for n, shape in self._state_shapes().items():
                key = moment_key(m, n)
                if key in self._offload_keep:
                    leaves[n] = torch.zeros(shape, dtype=torch.float32,
                                            device=self.device)
                else:
                    leaves[n] = self._to(self._offload_store_leaf(
                        key, torch.zeros(shape, dtype=torch.float32)),
                        "cpu", pin=pin)
            out.append(leaves)
        return AdamWState(0, *out)

    def _stream(self, state: TrainState, grads, lr: float,
                on_update=None, g_norm: Optional[torch.Tensor] = None,
                views: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The offloaded update, a leaf at a time: the leaf's moments host
        -> device, f32 load, the AdamW leaf update (applied to the
        parameter at once), store, device -> host into the same host
        buffers. Both copies are asynchronous on the current stream; only
        one leaf's moments are on the device at a time (kept leaves
        aside). Each copy runs between two CUDA events
        (``last_link_ms``). At world > 1 ``g_norm`` is the global norm and
        ``views`` the slices of the masters this rank updates."""
        host = state.opt_state
        cuda = self.device.type == "cuda"
        ctx = self.optimizer.begin(grads, host.count, g_norm)
        params = state.params if views is None else views
        mask = decay_mask(params)
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
            for n, p in params.items():
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
                apply_leaf(p, u * lr, n, on_update)
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
        if self.topology is None:
            masters = {n: nn.Parameter(t.detach().to(self.device).clone())
                       for n, t in params.items()}
            self.model.load_state_dict(masters, strict=True, assign=True)
            masters = dict(self.model.named_parameters())
            opt_state = (self._init_offloaded() if self.cpu_offload
                         else self.optimizer.init(masters))
            sharding = None
        else:
            # Every rank draws the same full parameters, then keeps its
            # slices: its tensor slice, and of that its fsdp slice of the
            # masters under zero3 and of the moments under zero2 and zero3.
            fr = self.topology.fsdp.rank
            world = self.topology.fsdp.world
            masters = {}
            for n in self.specs:           # the model's parameter order
                t = local_slice(torch.as_tensor(params[n]).detach(),
                                self.specs[n], self.topology.tensor_coord,
                                self.topology.expert_coord,
                                self.topology.stage_coord)
                d = self.specs[n].param_dim
                if d is not None:
                    t = t.narrow(d, fr * (t.shape[d] // world),
                                 t.shape[d] // world)
                masters[n] = nn.Parameter(t.to(self.device).clone())
            _assign_params(self.model, masters)
            opt_state = (self._init_offloaded() if self.cpu_offload
                         else self.optimizer.init(
                             {n: torch.empty(shape, device=self.device)
                              for n, shape in self._state_shapes().items()},
                             full_shapes={n: sp.shape
                                          for n, sp in self.specs.items()},
                             cuts=self._cuts))
            sharding = StateSharding(
                self.specs, fr, self.topology.data_coord, world,
                self.topology.tensor_coord, self.topology.tensor_size,
                self.topology.sequence_coord, self.topology.expert_coord,
                self.topology.expert_size, self.topology.stage_coord,
                self.topology.stage_size)
        return TrainState(
            step=0, params=masters, opt_state=opt_state,
            generator=torch.Generator().manual_seed(seed),
            loss_scale=_INIT_LOSS_SCALE if self.use_loss_scaling else 1.0,
            good_steps=0, sharding=sharding)

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
        sp = self.mesh_sizes[2]
        if sp > 1:
            if packed:
                raise NotImplementedError(
                    "packed batches (segment ids) are not supported under "
                    "sequence parallelism")
            batch = self._sequence_columns(batch)
        local = batch.reshape(accum, n // accum, *batch.shape[1:])
        host = torch.from_numpy(local.astype(np.int64))
        if non_blocking and self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _sequence_columns(self, batch: np.ndarray) -> np.ndarray:
        """This sequence rank's columns of ``[rows, seq]`` rows: its slice
        and the next column (the next rank's first token, the target of
        its last position; zeros past the end, where the target is
        masked)."""
        sp = self.mesh_sizes[2]
        seq = batch.shape[1]
        if seq % sp != 0:
            raise ValueError(f"seq {seq} not divisible by sequence axis "
                             f"size {sp}")
        sl = seq // sp
        j = self.topology.sequence_coord
        pad = np.zeros((batch.shape[0], 1), batch.dtype)
        return np.concatenate([batch, pad], axis=1)[:, j * sl:(j + 1) * sl
                                                     + 1]

    def _inputs(self, micro: torch.Tensor):
        """``(input ids, label ids, segment ids or None)`` of one placed
        micro-batch (under sequence: the slice and its ``sl + 1`` label
        columns)."""
        tokens, segs = _split_packed(micro)
        if self.mesh_sizes[2] > 1:
            return tokens[:, :-1], tokens, segs
        return tokens, tokens, segs

    def place_batch(self, batch, *, non_blocking: bool = False
                    ) -> torch.Tensor:
        """Host ``[accum * bs, seq]`` or ``[accum, bs, seq]`` (packed: a
        trailing 2) -> ``put_batch``'s device tensor; device tensors pass
        through. Each process places its own rows."""
        if torch.is_tensor(batch):
            return batch
        batch = np.asarray(batch)
        flat_ndim = 3 if batch.shape[-1] == 2 else 2
        if batch.ndim == flat_ndim + 1:
            batch = batch.reshape(-1, *batch.shape[2:])
        return self.put_batch(batch, non_blocking=non_blocking)

    def _bind(self, state: TrainState) -> None:
        """Make the model compute with ``state``'s parameters."""
        if next(self.model.parameters()) is not next(iter(
                state.params.values())):
            if self.topology is None:
                self.model.load_state_dict(state.params, strict=True,
                                           assign=True)
            else:
                _assign_params(self.model, state.params)

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
        sp = self.mesh_sizes[2]
        with ctx_lib.use_mesh(self.mesh_context):
            for micro in batch:
                tokens, labels, segs = self._inputs(micro)
                if self.schedule is not None:
                    # The forward in the schedule's
                    # ``pipeline_microbatches`` microbatches, as the JAX
                    # model's pipeline branch evaluates: a capacity
                    # router's capacity and aux are per microbatch (the
                    # loss the same on every stage rank).
                    loss = self.model.pipeline_step(
                        tokens, labels, [], train=False, backward=False,
                        segment_ids=segs)[0]
                else:
                    _, loss = self.model(tokens, labels, train=False,
                                         segment_ids=segs)
                if segs is None:
                    n = float(tokens.shape[0] * (tokens.shape[1] * sp - 1))
                else:
                    n = segment_target_mask(segs)[:, :-1].sum()
                # Under sequence a rank's loss is its share of the mean:
                # its sum is loss * n, and one rank counts the targets.
                total += loss.float() * n
                if self.topology is None or self.topology.sequence_coord == 0:
                    count += n
        if self.topology is not None:
            total, count = self.topology.rep.all_reduce_sum(
                torch.stack([total, count]))
        return total / torch.clamp(count, min=1.0)

    def train_step(self, state: TrainState, batch, telemetry: bool = False,
                   *, sync: bool = True) -> Tuple[TrainState, dict]:
        """One optimizer step over ``accum`` micro-batches. ``batch`` is
        ``put_batch``'s device tensor or a host array (placed here).
        Metrics: ``loss`` (mean over micro-batches), ``lr``, ``grad_norm``
        (before clipping), ``loss_scale`` (the scale this step used).
        ``sync=False`` leaves ``loss`` and ``grad_norm`` as device scalars,
        so the host does not wait for the step (fp16 still reads the norm:
        its skip decision needs it); the CLI reads them later through
        ``utils/telemetry.DeferredFetcher``. ``telemetry=True`` adds the
        ``"telemetry"`` subtree of device tensors (module docstring); the
        update, the loss and the generator are the plain step's."""
        with ctx_lib.use_mesh(self.mesh_context):
            return self._train_step(state, batch, telemetry, sync)

    def _train_step(self, state: TrainState, batch, telemetry: bool,
                    sync: bool) -> Tuple[TrainState, dict]:
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
        fwd_stats = []
        pp_stats = self.pipeline_stats = pp_lib.Stats()
        for micro in batch:
            tokens, labels, segs = self._inputs(micro)
            if self.schedule is not None:
                # The pipeline: this stage's gradients of the microbatches
                # it ran (and, for the replicated leaves, its partial
                # ones). Activation capture is skipped under a stage axis,
                # as in JAX; the norms below are kept.
                loss, g, stats = self.model.pipeline_step(
                    tokens, labels, leaves, train=True,
                    generator=state.generator, loss_scale=state.loss_scale,
                    segment_ids=segs)
                pp_stats.add(stats)
                g = [torch.zeros_like(p, dtype=torch.float32) if x is None
                     else x for p, x in zip(leaves, g)]
                if telemetry:
                    fwd_stats.append({})
            else:
                # The capture covers the forward only: the backward (and a
                # remat block's rerun inside it) records nothing.
                with (telemetry_lib.capture() if telemetry
                      else contextlib.nullcontext()) as cap:
                    _, loss = self.model(tokens, labels, train=True,
                                         segment_ids=segs,
                                         generator=state.generator)
                if telemetry:
                    fwd_stats.append(telemetry_lib.assemble(cap.stats))
                g = torch.autograd.grad(loss * state.loss_scale, leaves)
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
            loss_sum += loss.detach().float()
        grads = dict(zip(names, grads))
        if self.topology is not None:
            grads, loss_sum = self._reduce(grads, loss_sum)
        denom = accum * self.dp_size * state.loss_scale
        grads = {n: g / denom for n, g in grads.items()}
        grad_norm = self._global_norm(grads)
        lr = cfg.lr_at(state.step)
        metrics = {"loss": loss_sum / (accum * self.dp_size), "lr": lr,
                   "grad_norm": grad_norm, "loss_scale": state.loss_scale}

        telem = None
        update_norms = None
        if telemetry:
            if self.topology is not None:
                fwd_stats = telemetry_lib.combine_ranks(fwd_stats,
                                                        self.topology.rep)
            telem = dict(fwd_stats[0] if accum == 1
                         else telemetry_lib.reduce_micro(fwd_stats))
            layers = (self.model.stage_layers,
                      self.model_config.num_layers)
            norms = [telemetry_lib.GroupNorms(sharded=self._shard_axes,
                                              layers=layers),
                     telemetry_lib.GroupNorms(sharded=lambda n: (
                         self._shard_axes(n, param=True)), layers=layers)]
            for n, g in grads.items():
                norms[0].add(n, g)
            for n, p in state.params.items():
                norms[1].add(n, p)
            update_norms = telemetry_lib.GroupNorms(
                sharded=self._shard_axes, layers=layers)
        on_update = update_norms.add if update_norms is not None else None
        finite = (not self.use_loss_scaling
                  or bool(torch.isfinite(grad_norm)))
        if finite and self.topology is not None:
            self._sharded_update(state, grads, lr, grad_norm, on_update)
        elif self.cpu_offload and finite:
            self._stream(state, grads, lr, on_update)
        elif finite:
            state.opt_state = self.optimizer.apply(
                grads, state.opt_state, state.params, lr, on_update)
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
        if telem is not None:
            # The shards' sums of all three over the groups that split
            # them, a collective a group.
            topo = self.topology
            grad_n, param_n, upd = telemetry_lib.combine_norms(
                norms + [update_norms],
                None if topo is None else {"fsdp": topo.fsdp,
                                           "tensor": topo.tensor,
                                           "expert": topo.expert,
                                           "stage": topo.stage})
            telem["grad_norm"], telem["param_norm"] = grad_n, param_n
            # A skipped fp16 step changes nothing: zero update norms.
            if not finite:
                upd = {k: torch.zeros_like(v) for k, v in param_n.items()}
            telem["update_ratio"] = {
                k: upd[k] / (telem["param_norm"][k] + 1e-20) for k in upd}
            metrics["telemetry"] = telem
        state.step += 1
        if sync:
            metrics["loss"] = float(metrics["loss"])
            metrics["grad_norm"] = float(metrics["grad_norm"])
        return state, metrics

    # -- world > 1 ------------------------------------------------------------

    @torch.no_grad()
    def _reduce(self, grads: Dict[str, torch.Tensor],
                loss_sum: torch.Tensor):
        """The strategy's gradient collectives (module docstring): each
        leaf's f32 sum over every rank's rows, whole where its state is
        whole and this rank's slice where it is sharded; and the loss sum
        over every rank. Under a stage axis a leaf outside the layer stack
        has a partial gradient on each stage rank: those are summed over
        the stage group once (the loss is already the same on every stage
        rank)."""
        topo = self.topology
        out = {}
        for n, g in grads.items():
            spec = self.specs[n]
            if spec.state_dim is None:
                g = topo.rep.all_reduce_sum(g)
            else:
                if spec.param_dim is None:      # zero2: a whole gradient
                    g = topo.fsdp.reduce_scatter_leaf(g, spec.state_dim)
                # zero3's gather already summed it over the fsdp group.
                g = topo.rep_data.all_reduce_sum(g)
            if topo.stage_size > 1 and spec.stage_dim is None:
                g = topo.stage.all_reduce_sum(g)
            out[n] = g
        return out, topo.rep.all_reduce_sum(loss_sum)

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm over the whole gradient: with sharded leaves, the
        shards' sums of squares all-reduced over the groups that shard
        them (fsdp, then tensor, then expert), plus the whole leaves'
        once."""
        if not self._sharded():
            return global_norm(grads.values())
        layer_sums: Dict[tuple, torch.Tensor] = {}
        sums: Dict[tuple, torch.Tensor] = {}
        for n, g in grads.items():
            key = self._shard_axes(n)
            acc = sums
            if "stage" in key:
                # A stage's layers: their sums add over the stage group.
                key = tuple(ax for ax in key if ax != "stage")
                acc = layer_sums
            sq = g.float().square().sum()
            acc[key] = acc[key] + sq if key in acc else sq
        total = self._sum_squares(sums)
        if layer_sums:
            total = total + self.topology.stage.all_reduce_sum(
                self._sum_squares(layer_sums))
        return torch.sqrt(total)

    def _sum_squares(self, sums: Dict[tuple, torch.Tensor]) -> torch.Tensor:
        """The whole leaves' sum of squares from the shards' sums keyed by
        the axes that split them: added over the fsdp, then the tensor,
        then the expert group, plus the whole leaves' once."""
        zero = torch.zeros((), device=self.device)

        def sq(*axes):
            return sums.get(axes, zero)
        topo = self.topology
        fte, ft, fe, f = topo.fsdp.all_reduce_sum(torch.stack([
            sq("fsdp", "tensor", "expert"), sq("fsdp", "tensor"),
            sq("fsdp", "expert"), sq("fsdp")]))
        te, t = topo.tensor.all_reduce_sum(torch.stack([
            fte + sq("tensor", "expert"), ft + sq("tensor")]))
        e = topo.expert.all_reduce_sum(te + fe + sq("expert"))
        return e + t + f + sq()

    @torch.no_grad()
    def _sharded_update(self, state: TrainState, grads, lr: float,
                        grad_norm: torch.Tensor, on_update=None) -> None:
        """AdamW on this rank's slice of every leaf (streamed through the
        host under offload); zero2 then all-gathers the updated master
        slices into the whole masters."""
        fsdp = self.topology.fsdp
        views = {}
        for n, p in state.params.items():
            spec = self.specs[n]
            d = spec.state_dim
            if d is not None and spec.param_dim is None:
                k = p.shape[d] // fsdp.world
                views[n] = p.narrow(d, fsdp.rank * k, k)
            else:
                views[n] = p
        if self.cpu_offload:
            self._stream(state, grads, lr, on_update, grad_norm, views)
        else:
            state.opt_state = self.optimizer.apply(
                grads, state.opt_state, views, lr, on_update,
                g_norm=grad_norm)
        for n, p in state.params.items():
            spec = self.specs[n]
            if spec.state_dim is not None and spec.param_dim is None:
                p.copy_(fsdp.all_gather_leaf(views[n], spec.state_dim))

    @torch.no_grad()
    def nan_scan(self, state: TrainState, batch) -> dict:
        """Forward-only activation scan: where does the first NaN/Inf
        appear?

        Runs one deterministic forward of micro-batch 0 under the deep
        capture (every layer's attention/FFN/block stats, the embedding,
        the final norm and the full f32 logits) and bisects them on the
        host. Returns ``{"first_nan": {"layer", "site"} | None, "sites":
        [...], "stats": {flattened scalars}}`` — see
        ``utils/telemetry.nan_report``. At world > 1 micro-batch 0 is the
        global one: each rank scans its rows and the stats are combined
        across ranks (``telemetry.combine_ranks``) before the bisection,
        so the first site is the earliest one, in forward order, that is
        non-finite on any rank, and every rank returns the same report."""
        if not torch.is_tensor(batch):
            batch = self.put_batch(batch)
        self._bind(state)
        tokens, labels, segs = self._inputs(batch[0])
        with telemetry_lib.capture(deep=True) as cap, \
                ctx_lib.use_mesh(self.mesh_context):
            if self.schedule is not None:
                # The forward in the schedule's microbatches, as
                # ``eval_step`` runs it.
                loss = self.model.pipeline_step(
                    tokens, labels, [], train=False, backward=False,
                    segment_ids=segs)[0]
            else:
                _, loss = self.model(tokens, labels, train=False,
                                     segment_ids=segs)
        raw = cap.stats
        if self.schedule is not None:
            raw = self._stage_stats(raw)
        stats = telemetry_lib.assemble(raw)
        # A sequence rank's loss is its share: the ranks' mean of sp
        # shares is the mean over the data shards.
        stats["loss"] = loss.float() * self.mesh_sizes[2]
        if self.topology is not None:
            stats, = telemetry_lib.combine_ranks([stats], self.topology.rep)
        report = telemetry_lib.nan_report(stats)
        report["stats"] = telemetry_lib.flatten_scalars(
            {k: v for k, v in stats.items() if isinstance(v, dict)},
            prefix="nan_scan")
        report["stats"]["nan_scan/loss"] = float(stats["loss"])
        return report

    @torch.no_grad()
    def _stage_stats(self, raw: dict) -> dict:
        """A pipelined deep capture's stats as one process records them:
        each site is recorded by the stage rank that runs it (the
        embedding on stage 0, layer ``g`` as ``layer_g`` by its stage, the
        final norm and the logits on the last stage); every rank's values
        land in zeros elsewhere and one sum over the stage group puts them
        together (a non-finite value stays non-finite)."""
        L = self.model_config.num_layers
        mine = [k for k in raw if k.startswith("layer_")]
        like = raw[mine[0]]
        sites = {"embed_out": ("rms", "absmax"),
                 "final_norm": ("rms", "absmax"),
                 "logits": ("rms", "absmax")}
        parts, layout = [], []
        zero = torch.zeros((), device=self.device)
        for site, keys in sites.items():
            for k in keys:
                v = raw.get(site, {}).get(k)
                parts.append((v if v is not None else zero).float()
                             .reshape(-1))
                layout.append((site, k, ()))
        for k, v in like.items():
            full = torch.zeros((L,) + tuple(v.shape), device=self.device)
            for name in mine:
                full[int(name[len("layer_"):])] = raw[name][k].float()
            parts.append(full.reshape(-1))
            layout.append(("layers", k, tuple(full.shape)))
        flat = self.topology.stage.all_reduce_sum(torch.cat(parts),
                                                  kind="pp_allreduce")
        out: dict = {}
        at = 0
        for (site, k, shape), p in zip(layout, parts):
            v = flat[at:at + p.numel()]
            at += p.numel()
            out.setdefault(site, {})[k] = v.reshape(shape)
        return out

    def step_cost_analysis(self, state: TrainState, batch) -> Optional[dict]:
        """The compiler's cost model of one step: eager PyTorch has none,
        so None (the JAX method's answer on a backend that hides it)."""
        return None

    def executable_cache_size(self) -> Optional[int]:
        """Compiled step executables: eager PyTorch compiles none, so None
        (``RecompileWatchdog`` then stays disarmed)."""
        return None


class RecompileWatchdog:
    """The JAX watchdog of steady-state recompiles of the jitted step.
    Eager PyTorch never recompiles the step (``executable_cache_size`` is
    None), so the watchdog is disarmed: ``observe`` returns None and no
    ``recompile`` record is written."""

    def __init__(self, trainer: Trainer, warn_after: int = 3):
        self.trainer = trainer
        self.warn_after = warn_after
        self.events: list = []
        self._armed = trainer.executable_cache_size() is not None

    def observe(self, step: int, batch=None,
                expected: bool = False) -> Optional[dict]:
        return None
