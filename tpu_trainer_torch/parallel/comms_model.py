"""Static per-step collective-traffic model for a Trainer's mesh and
sharding (port of ``tpu_trainer/parallel/comms_model.py``).

From the mesh shape, the sharding strategy and the parameter shapes
alone, it predicts the bytes each device moves per optimizer step on
every mesh axis (the data axis's gradient all-reduce, FSDP's parameter
all-gather and gradient reduce-scatter, tensor parallelism's activation
all-reduces, the sequence ring's K/V rotation, the MoE all-to-alls and
the pipeline's stage-boundary transfers) and puts them beside the
analytic FLOPs as a comms-vs-compute roofline: the one-time
``kind:"comms_model"`` JSONL record of a training run, and the scorer of
the mesh planner (``parallel/planner.py``).

The arithmetic is the JAX module's, line for line: every formula assumes
ring collectives and no compute/comms overlap, so the times classify a
configuration as comms- or compute-bound; they do not predict a step.
The port's collectives are rank-order sums (``parallel/collectives.py``),
not rings, so the bytes it counts need not equal the modelled bytes.

The parameter shapes are the port's own (``abstract_params``: a
``meta``-device ``GPT``, nothing allocated), under the Flax names the
port keeps, with ``parallel/sharding.leaf_specs`` in place of the JAX
``PartitionSpec`` trees. There is no HLO in the port: ``crosscheck``
reads ``parallel/collectives.group_calls`` over the first step instead
(each call booked to the mesh axes of the group it ran on, each axis's
counter kinds in ``_AXIS_KINDS``) and notes every axis that the model
charges bytes but on which none of its kinds ran, and every axis on
which calls ran that the model does not charge there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.parallel import sharding as shard_lib
from tpu_trainer_torch.utils.logging import (
    flops_per_token,
    peak_flops_for_name,
)

# Gradients accumulate and reduce in float32 regardless of compute dtype.
GRAD_BYTES = 4

# Assumed per-device interconnect bandwidth (bytes/s) by device kind
# substring, for the roofline estimate only, matched longest-substring-
# first on the lower-cased kind. The TPU rows are the JAX module's
# aggregate ICI figures (planning for a TPU kind, ``tools/plan
# --device-kind``). The NVIDIA rows are NVIDIA's H100 datasheet figures,
# taken one way: a ring moves the per-device bytes the formulas below
# count out of each device while as many come in, so a device's time is
# those bytes over its one-direction rate. H100 SXM (CUDA name "NVIDIA
# H100 80GB HBM3"): NVLink 4, 900 GB/s bidirectional, 450e9 one way;
# H100 PCIe: PCIe Gen5 x16, 128 GB/s bidirectional, 64e9 one way.
_LINK_BYTES_PER_SEC = {
    "v6": 1.8e11,
    "v5p": 1.2e11,
    "v5lite": 4.5e10,
    "v5e": 4.5e10,
    "v4": 1.2e11,
    "v3": 7.0e10,
    "v2": 5.0e10,
    "h100": 4.5e11,
    "h100 pcie": 6.4e10,
}
_DEFAULT_LINK = 4.5e10

# Peak FLOP/s of a TPU kind (the JAX ``utils/logging._PEAK_FLOPS``), for
# planning for a TPU kind only; a CUDA name takes
# ``utils/logging.peak_flops_for_name``. An unknown kind is taken as the
# JAX fallback's v4, as the JAX planner takes it.
_TPU_PEAK_FLOPS = {
    "v6": 918e12,
    "v5p": 459e12,
    "v5e": 197e12,
    "v5lite": 197e12,
    "v4": 275e12,
    "v3": 123e12,
    "v2": 45e12,
}
_DEFAULT_PEAK = 275e12

# The counter kinds of ``parallel/collectives`` that the model charges on
# each mesh axis (the ``_AXIS_EXPECTED_OPS`` of the JAX module, for
# counters): the data and fsdp axes the trainer's gradient sums and
# ZeRO's gathers and scatters (the generic kinds), the tensor axis
# Megatron's pair, the gathers, the head's all-to-all and maxima, the
# sequence axis the ring's permute, the expert axis a MoE layer's sum
# over the expert ranks and its routing counts, the stage axis the
# pipeline's sends and its head's broadcast and sums.
_AXIS_KINDS = {
    "data": ("reduce_scatter", "all_gather"),
    "fsdp": ("reduce_scatter", "all_gather"),
    "tensor": ("tp_allreduce", "tp_gather", "tp_alltoall", "tp_max"),
    "sequence": ("ring_permute",),
    "expert": ("moe_allreduce", "moe_counts"),
    "stage": ("pp_send", "pp_bcast", "pp_allreduce", "pp_max"),
}


# --- ring-collective per-device byte costs ---------------------------------

def ring_all_reduce_bytes(payload: float, n: int) -> float:
    """Ring all-reduce of ``payload`` bytes over ``n`` devices: a
    reduce-scatter then an all-gather, each moving (n-1)/n of the payload
    through every device."""
    return 2.0 * (n - 1) / n * payload if n > 1 else 0.0


def ring_all_gather_bytes(payload: float, n: int) -> float:
    """All-gather whose *result* is ``payload`` bytes: each device
    receives the (n-1)/n of it that it doesn't already hold."""
    return (n - 1) / n * payload if n > 1 else 0.0


def ring_reduce_scatter_bytes(payload: float, n: int) -> float:
    """Reduce-scatter of a ``payload``-byte addend per device: (n-1)/n of
    it leaves each device."""
    return (n - 1) / n * payload if n > 1 else 0.0


def all_to_all_bytes(payload: float, n: int) -> float:
    """All-to-all of a ``payload``-byte per-device buffer: (n-1)/n of it is
    destined for other devices."""
    return (n - 1) / n * payload if n > 1 else 0.0


def ring_sendrecv_bytes(shard_bytes: float, n: int) -> float:
    """Full ring rotation (ring attention): every device forwards its
    ``shard_bytes`` neighbour block ``n-1`` times."""
    return (n - 1) * shard_bytes if n > 1 else 0.0


# --- the model -------------------------------------------------------------

def _spec_axes(spec) -> tuple:
    axes: List[str] = []
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return tuple(axes)


def _shard_factor(spec, axis_sizes, exclude=()) -> int:
    f = 1
    for ax in _spec_axes(spec):
        if ax not in exclude:
            f *= axis_sizes[ax]
    return f


def _link_bytes_per_sec(device_kind: str) -> float:
    kind = (device_kind or "").lower()
    for key in sorted(_LINK_BYTES_PER_SEC, key=len, reverse=True):
        if key in kind:
            return _LINK_BYTES_PER_SEC[key]
    return _DEFAULT_LINK


def peak_flops_for_kind(device_kind: str) -> float:
    """Peak dense bf16 FLOP/s of a device kind: a CUDA name's from
    ``utils/logging.peak_flops_for_name``, else a TPU kind's (the JAX
    table's substring match), else the JAX fallback."""
    try:
        return peak_flops_for_name(device_kind)
    except ValueError:
        pass
    kind = (device_kind or "").lower().replace(" ", "")
    for key, flops in _TPU_PEAK_FLOPS.items():
        if key in kind:
            return flops
    return _DEFAULT_PEAK


def local_device_kind(device=None) -> str:
    """This process's device kind: the CUDA device's name, else
    ``"cpu"`` (the JAX CPU device's ``device_kind``)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _specs(param_shapes, sizes, strategy):
    """``(params spec, grads spec)`` of every leaf, as the JAX
    ``PartitionSpec`` tuples (``parallel/sharding.LeafSpec.partition``)."""
    specs = shard_lib.leaf_specs(
        param_shapes, strategy, sizes[mesh_lib.FSDP_AXIS],
        sizes[mesh_lib.TENSOR_AXIS], sizes[mesh_lib.EXPERT_AXIS],
        sizes[mesh_lib.STAGE_AXIS])
    return {n: (sp.partition(sp.param_dim), sp.partition(sp.state_dim))
            for n, sp in specs.items()}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def build_core(
    param_shapes,
    axis_sizes,
    strategy: str,
    *,
    model_config,
    batch_size: int,
    max_seq_len: int,
    grad_accum: int,
    device_kind: str = "",
    peak_flops: Optional[float] = None,
) -> dict:
    """Trainer-independent core of the comms model (the JAX
    ``build_core``): shape arithmetic over ``param_shapes``
    (``abstract_params``: parameter name -> shape) and the run's
    dimensions. ``axis_sizes``: ``{axis: size}`` for the six mesh axes
    (missing ones are 1); ``strategy``: the sharding strategy (aliases
    accepted); ``batch_size``: rows a data shard a micro-batch;
    ``device_kind`` / ``peak_flops``: the roofline's hardware
    (``peak_flops=None``: the local device's, as the live comms model
    reads it)."""
    strategy = shard_lib.canonical_strategy(strategy)
    mc = model_config
    d = axis_sizes.get(mesh_lib.DATA_AXIS, 1)
    f = axis_sizes.get(mesh_lib.FSDP_AXIS, 1)
    sp = axis_sizes.get(mesh_lib.SEQUENCE_AXIS, 1)
    tp = axis_sizes.get(mesh_lib.TENSOR_AXIS, 1)
    ep = axis_sizes.get(mesh_lib.EXPERT_AXIS, 1)
    st = axis_sizes.get(mesh_lib.STAGE_AXIS, 1)
    sizes = {ax: axis_sizes.get(ax, 1) for ax in mesh_lib.MESH_AXES}
    n_devices = d * f * sp * tp * ep * st
    accum = grad_accum
    rows = batch_size                         # per-data-shard rows per micro
    seq_local = max_seq_len // sp
    act_bytes = _itemsize(mc.compute_dtype)
    hidden = mc.hidden_size
    layers = mc.num_layers

    specs = _specs(param_shapes, sizes, strategy)
    params_total = int(sum(math.prod(s) for s in param_shapes.values()))

    # Param-tree traffic: DP grad all-reduce + FSDP gathers/scatters.
    acc = {"data": 0.0, "fsdp_gather": 0.0, "fsdp_scatter": 0.0}
    zero2_regather = strategy == "zero2"

    for name, shape in param_shapes.items():
        pspec, gspec = specs[name]
        size = math.prod(shape)
        # data axis: all-reduce of the per-device f32 grad shard (for
        # ZeRO meshes this runs on the post-reduce-scatter shard).
        gshard = size * GRAD_BYTES / _shard_factor(gspec, sizes)
        acc["data"] += ring_all_reduce_bytes(gshard, d)
        if f > 1 and mesh_lib.FSDP_AXIS in _spec_axes(gspec):
            # fsdp grad reduce-scatter, on the pre-scatter f32 payload.
            pre = size * GRAD_BYTES / _shard_factor(
                gspec, sizes, exclude=(mesh_lib.FSDP_AXIS,))
            acc["fsdp_scatter"] += ring_reduce_scatter_bytes(pre, f)
            if zero2_regather and mesh_lib.FSDP_AXIS not in _spec_axes(pspec):
                # zero2: params stay replicated, so the fsdp-sharded
                # update is all-gathered back once per step (f32).
                acc["fsdp_gather"] += ring_all_gather_bytes(pre, f)
        if f > 1 and mesh_lib.FSDP_AXIS in _spec_axes(pspec):
            # zero3 param all-gather in compute dtype (>=2-D leaves are
            # cast; scalars/vectors stay f32), once for the forward and
            # once for the backward re-gather.
            itemsize = act_bytes if len(shape) >= 2 else 4
            pre = size * itemsize / _shard_factor(
                pspec, sizes, exclude=(mesh_lib.FSDP_AXIS,))
            acc["fsdp_gather"] += 2.0 * ring_all_gather_bytes(pre, f)

    # tensor axis: 2 forward + 2 backward activation all-reduces per layer
    # per micro-batch (row-parallel o_proj and down_proj outputs, and their
    # grads w.r.t. the column-parallel inputs). The vocab-sharded fused
    # head reduces scalars only — excluded.
    act_payload = rows * seq_local * hidden * act_bytes
    tensor_bytes = (
        accum * layers * 4 * ring_all_reduce_bytes(act_payload, tp))

    # sequence axis: ring attention rotates each device's K/V shard around
    # the ring once per layer forward and twice backward (K/V again plus
    # the dK/dV accumulators riding the reverse ring).
    kv_shard = (2 * rows * seq_local * mc.kv_heads * mc.head_dim * act_bytes)
    seq_bytes = accum * layers * 3 * ring_sendrecv_bytes(kv_shard, sp)

    # expert axis: dispatch + combine all-to-alls, forward and backward
    # (4 total per layer per micro).  Capacity routing moves the padded
    # E*C slot buffer (top_k * capacity_factor rows per token); dropless
    # routing moves exactly the k*T routed rows — no padding factor.
    expert_bytes = 0.0
    if mc.num_experts > 0 and ep > 1:
        routed_scale = (mc.moe_top_k if mc.moe_impl == "dropless"
                        else mc.moe_top_k * mc.expert_capacity_factor)
        tok_payload = (rows * seq_local * routed_scale
                       * hidden * act_bytes)
        expert_bytes = (
            accum * layers * 4 * all_to_all_bytes(tok_payload, ep))

    # stage axis: every microbatch's activations cross each stage boundary
    # forward and backward; per device that is (st-1)/st of the per-micro
    # activation rows (the microbatch split cancels out of the total).
    stage_bytes = 0.0
    if st > 1:
        stage_bytes = (accum * 2.0 * (st - 1) / st
                       * rows * seq_local * hidden * act_bytes)

    per_axis = {
        "data": {
            "size": d,
            "collective": "grad all-reduce (ring)",
            "bytes": acc["data"],
        },
        "fsdp": {
            "size": f,
            "collective": "param all-gather + grad reduce-scatter (ring)",
            "bytes": acc["fsdp_gather"] + acc["fsdp_scatter"],
            "gather_bytes": acc["fsdp_gather"],
            "scatter_bytes": acc["fsdp_scatter"],
        },
        "tensor": {
            "size": tp,
            "collective": "activation all-reduce (ring)",
            "bytes": tensor_bytes,
        },
        "sequence": {
            "size": sp,
            "collective": "ring-attention K/V sendrecv",
            "bytes": seq_bytes,
        },
        "expert": {
            "size": ep,
            "collective": "MoE dispatch/combine all-to-all",
            "bytes": expert_bytes,
        },
        "stage": {
            "size": st,
            "collective": "pipeline boundary transfer",
            "bytes": stage_bytes,
        },
    }
    total = sum(v["bytes"] for v in per_axis.values())

    # Roofline: serial (no-overlap) comms time vs analytic compute time.
    peak = (peak_flops if peak_flops is not None
            else peak_flops_for_kind(local_device_kind()))
    link = _link_bytes_per_sec(device_kind)
    tokens_per_step = rows * accum * d * f * max_seq_len
    flops_step = flops_per_token(mc, seq_len=max_seq_len) * tokens_per_step
    per_device_flops = flops_step / n_devices
    compute_s = per_device_flops / peak
    comms_s = total / link
    ratio = comms_s / compute_s if compute_s > 0 else float("inf")

    return {
        "kind": "comms_model",
        "mesh": sizes,
        "strategy": strategy,
        "params": params_total,
        "per_axis": per_axis,
        "total_bytes_per_device_per_step": total,
        "compute_seconds_est": compute_s,
        "comms_seconds_est": comms_s,
        "comms_compute_ratio": ratio,
        "bound": "comms" if comms_s > compute_s else "compute",
        "assumptions": {
            "collectives": "bidirectional ring, no compute/comms overlap",
            "grad_bytes": GRAD_BYTES,
            "activation_bytes": act_bytes,
            "fsdp_param_gathers_per_step": 2,
            "tp_head_excluded": "vocab-sharded fused head reduces scalars",
            "peak_flops_per_device": peak,
            "ici_bytes_per_sec": link,
            "device_kind": device_kind or "unknown",
        },
    }


def abstract_params(model_config) -> Dict[str, tuple]:
    """Parameter name (the Flax path, ``a.b.c``) -> shape of a model
    config, from a ``meta``-device ``GPT`` (no weights allocated): the
    leaves and shapes of the JAX ``abstract_params``. Nothing a mesh
    changes moves a shape (the fused projections the trainer turns off
    under tensor keep the tree)."""
    from tpu_trainer_torch.models.gpt import GPT

    model = GPT(model_config, device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def build(trainer) -> dict:
    """The ``kind:"comms_model"`` record of ``trainer``'s mesh, strategy
    and run dimensions (``build_core``; the caller stamps ``step``)."""
    tc = trainer.training_config
    return build_core(
        abstract_params(trainer.model_config),
        dict(zip(mesh_lib.MESH_AXES, trainer.mesh_sizes)),
        trainer.strategy,
        model_config=trainer.model_config,
        batch_size=tc.batch_size,
        max_seq_len=tc.max_seq_len,
        grad_accum=tc.gradient_accumulation_steps,
        device_kind=local_device_kind(trainer.device),
    )


def summary_lines(record: dict) -> List[str]:
    """Human-readable stdout lines for a comms_model record."""
    active = {k: v for k, v in record["per_axis"].items() if v["bytes"] > 0}
    parts = ", ".join(
        f"{k}[{v['size']}] {v['bytes'] / 1e6:.1f} MB" for k, v in active.items()
    ) or "none (single-device or fully replicated compute)"
    lines = [
        f"comms_model | per-device traffic/step: {parts}",
        (f"comms_model | roofline: comms {record['comms_seconds_est'] * 1e3:.2f} ms"
         f" vs compute {record['compute_seconds_est'] * 1e3:.2f} ms"
         f" -> {record['bound']}-bound"
         f" (ratio {record['comms_compute_ratio']:.2f})"),
    ]
    counted = {ax: c for ax, c in
               (record.get("collective_counts") or {}).items()
               if c["size"] > 1}
    if counted:
        lines.append("comms_model | counted/modelled bytes a step: " + ", ".join(
            f"{ax}[{c['size']}] {c['bytes'] / 1e6:.1f}/"
            f"{record['per_axis'][ax]['bytes'] / 1e6:.1f} MB ({c['calls']} calls)"
            for ax, c in counted.items()))
    for m in record.get("collective_mismatches") or []:
        lines.append(f"comms_model | collective cross-check: {m}")
    return lines


# --- cross-check against the counted collectives ----------------------------

def collective_counts(record: dict, calls: Dict[tuple, int]) -> dict:
    """``{axis: {"size", "calls", "bytes", "kinds", "kind_bytes"}}`` of
    one step's ``calls`` (the difference of
    ``parallel/collectives.group_calls`` around it, keyed ``(axes,
    kind)``): every call that ran on a group spanning the axis, by kind
    (a group that spans several axes counts on each of them)."""
    out = {axis: {"size": info["size"], "calls": 0, "bytes": 0.0,
                  "kinds": {}, "kind_bytes": {}}
           for axis, info in record["per_axis"].items()}
    for (axes, kind), n in sorted(calls.items()):
        if kind.endswith("_bytes"):
            continue
        b = float(calls.get((axes, f"{kind}_bytes"), 0))
        for axis in axes:
            got = out[axis]
            got["calls"] += int(n)
            got["bytes"] += b
            got["kinds"][kind] = got["kinds"].get(kind, 0) + int(n)
            got["kind_bytes"][kind] = got["kind_bytes"].get(kind, 0.0) + b
    return out


def crosscheck(record: dict, calls: Dict[tuple, int]) -> dict:
    """Compare the model with the collectives a step ran (soft notes, as
    the JAX HLO cross-check): an axis that the model charges bytes but on
    which none of its kinds (``_AXIS_KINDS``) ran, and an axis on which
    calls ran that the model does not charge there: kinds outside the
    axis's, or any kind where the model charges the axis nothing. Sums of
    a few scalars (``scalars``) are charged nowhere and noted nowhere.
    Returns ``{"collective_counts", "collective_mismatches"}`` for the
    caller to merge into the record."""
    counts = collective_counts(record, calls)
    mismatches = []
    for axis, info in record["per_axis"].items():
        got = counts[axis]
        kinds = [k for k in got["kinds"] if k != "scalars"]
        charged = _AXIS_KINDS[axis] if info["bytes"] > 0 else ()
        if info["bytes"] > 0 and not any(k in charged for k in kinds):
            mismatches.append(
                f"modeled {info['bytes']:.3g} B/step on axis '{axis}' but "
                f"none of {_AXIS_KINDS[axis]} ran")
        extra = sorted(k for k in kinds if k not in charged)
        if extra:
            n = sum(got["kinds"][k] for k in extra)
            b = sum(got["kind_bytes"][k] for k in extra)
            mismatches.append(
                f"counted {n} calls ({b:.3g} B) of {extra} on axis "
                f"'{axis}' but the model charges it "
                + (f"for {list(charged)} only" if charged else "nothing"))
    return {"collective_counts": counts, "collective_mismatches": mismatches}
