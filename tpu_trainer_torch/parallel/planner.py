"""Mesh auto-planner: enumerate, score and pick the parallelism split (port
of ``tpu_trainer/parallel/planner.py``).

1. **enumerate**: every ordered factorization of the device count over
   the six mesh axes (the divisor lattice);
2. **prune**: divisibility (``feasibility_error``, the predicate the CLI
   checks an explicit split with, so the CLI's errors and the pruning
   never disagree) and a per-device memory budget against an analytic
   params + optimizer + gradient + activation estimate
   (``estimate_memory``);
3. **score**: ``comms_model.build_core``'s bytes over the link rate plus
   the 6N-FLOPs compute estimate, summed serially (the comms model's
   no-overlap assumption) into a predicted step time;
4. **rank**: the least predicted step time, ties broken on the axis
   tuple; the ``kind:"mesh_plan"`` record with the top-k alternatives for
   ``--mesh auto`` and ``tools/plan``.

The search holds the global batch fixed (``global_rows`` rows a
micro-step): a candidate's rows a data shard are ``global_rows //
(data * fsdp)``. Everything is shape arithmetic on the port's parameter
shapes (``comms_model.abstract_params``): nothing is allocated, and a
plan for another device kind (``hbm_gb`` and ``device_kind``) costs what
a plan for this host does. The arithmetic and the record (its keys and
``schema_version``) are the JAX module's. The port runs every axis on
every device, the stage axis included, so it plans over every axis (the
JAX CLI excludes ``stage`` on the CPU, where XLA cannot lower it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from tpu_trainer_torch.parallel import comms_model as comms_lib
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.parallel import sharding as shard_lib
from tpu_trainer_torch.utils.schema import SCHEMA_VERSION

GiB = float(2**30)


# --- feasibility (shared with the CLI's mesh validation) --------------------

def feasibility_error(
    axis_sizes,
    model_config,
    *,
    n_devices: int,
    global_rows: int,
    max_seq_len: int,
) -> Optional[str]:
    """Why this mesh can't run this model, or ``None`` if it can: every
    divisibility check ``Trainer.__init__`` makes (the JAX trainer's), and
    the planner's fixed-global-batch row split."""
    d = axis_sizes.get(mesh_lib.DATA_AXIS, 1)
    f = axis_sizes.get(mesh_lib.FSDP_AXIS, 1)
    sp = axis_sizes.get(mesh_lib.SEQUENCE_AXIS, 1)
    tp = axis_sizes.get(mesh_lib.TENSOR_AXIS, 1)
    ep = axis_sizes.get(mesh_lib.EXPERT_AXIS, 1)
    st = axis_sizes.get(mesh_lib.STAGE_AXIS, 1)
    sizes = (d, f, sp, tp, ep, st)
    if any(s < 1 for s in sizes):
        return f"mesh axes must be >= 1, got {sizes}"
    product = math.prod(sizes)
    if product != n_devices:
        return (f"mesh {sizes} uses {product} devices but {n_devices} "
                f"are available")
    if sp > 1 and max_seq_len % sp != 0:
        return (f"max_seq_len {max_seq_len} not divisible by sequence "
                f"axis size {sp}")
    if ep > 1:
        if model_config.num_experts <= 0:
            return ("expert mesh axis > 1 requires a MoE model "
                    "(GPTConfig.num_experts > 0)")
        if model_config.num_experts % ep != 0:
            return (f"num_experts {model_config.num_experts} not divisible "
                    f"by expert axis size {ep}")
    if tp > 1:
        if model_config.num_heads % tp != 0:
            return (f"num_heads {model_config.num_heads} not divisible by "
                    f"tensor axis size {tp}")
        if model_config.kv_heads % tp != 0:
            return (f"num_kv_heads {model_config.kv_heads} not divisible by "
                    f"tensor axis size {tp} (each tensor shard must own "
                    f"whole K/V-head groups)")
    dp = d * f
    if global_rows % dp != 0:
        return (f"global batch of {global_rows} rows not divisible by "
                f"{dp} data shards (data {d} x fsdp {f})")
    if st > 1:
        if model_config.num_layers % st != 0:
            return (f"num_layers {model_config.num_layers} not divisible by "
                    f"stage axis size {st}")
        microbatches = model_config.pipeline_microbatches or st
        if model_config.pipeline_schedule == "interleaved":
            vst = model_config.pipeline_virtual_stages
            if model_config.num_layers % (st * vst):
                return (f"num_layers {model_config.num_layers} not divisible "
                        f"by stages*virtual ({st}*{vst})")
            if microbatches % st:
                return (f"interleaved schedule needs pipeline_microbatches "
                        f"({microbatches}) divisible by the stage count "
                        f"({st})")
        if global_rows % microbatches != 0:
            return (f"global batch {global_rows} rows not divisible by "
                    f"pipeline_microbatches {microbatches}")
    return None


def validate_mesh_config(
    mesh_config: mesh_lib.MeshConfig,
    model_config,
    *,
    n_devices: int,
    global_rows: int,
    max_seq_len: int,
) -> Dict[str, int]:
    """Resolve and feasibility-check an explicit ``MeshConfig``; raises
    ``ValueError`` naming the split and pointing at ``--mesh auto`` on
    any split the Trainer would reject. Returns ``{axis: size}``."""
    resolved = mesh_config.resolve(n_devices)  # raises on bad product
    sizes = dict(zip(mesh_lib.MESH_AXES, resolved))
    err = feasibility_error(
        sizes, model_config, n_devices=n_devices,
        global_rows=global_rows, max_seq_len=max_seq_len)
    if err:
        raise ValueError(
            f"infeasible mesh {tuple(resolved)} "
            f"({'x'.join(mesh_lib.MESH_AXES)}): {err} — pick a split whose "
            f"axes divide the model, or let `--mesh auto` choose one")
    return sizes


# --- enumeration ------------------------------------------------------------

def enumerate_meshes(n_devices: int) -> Iterator[Dict[str, int]]:
    """Every ordered factorization of ``n_devices`` over the six mesh axes,
    each axis walking its divisors ascending, the data axis outermost
    (C(k+5, 5) candidates for n = 2^k: 56 at n 8)."""
    def factorize(remaining: int, n_axes: int) -> Iterator[Tuple[int, ...]]:
        if n_axes == 1:
            yield (remaining,)
            return
        for div in range(1, remaining + 1):
            if remaining % div == 0:
                for rest in factorize(remaining // div, n_axes - 1):
                    yield (div,) + rest

    for sizes in factorize(n_devices, len(mesh_lib.MESH_AXES)):
        yield dict(zip(mesh_lib.MESH_AXES, sizes))


# --- per-device memory estimate ---------------------------------------------

def estimate_memory(
    param_shapes,
    axis_sizes,
    strategy: str,
    *,
    model_config,
    batch_size: int,
    max_seq_len: int,
    opt_state_bytes: int = 4,
    carry_cast: bool = True,
) -> Dict[str, float]:
    """Analytic per-device peak-memory estimate (bytes) of one candidate
    mesh: exact for the persistent state (each leaf over its split's
    shard factor) and approximate for the activations (flash attention
    keeps ``S^2`` out of memory; the per-layer residual and MLP streams):

    - f32 masters over the params split; a compute-dtype copy of them
      with ``carry_cast`` when the compute dtype is narrower than f32;
    - Adam's two moments at ``opt_state_bytes`` each and the f32
      gradients over the grads split;
    - a micro-batch's activations, ``rows * seq_local * layers_local *
      (4 hidden + 2 inter_local)`` in the compute dtype plus a 4-hidden
      embedding and head working set, the MoE FFN term scaled by ``top_k
      * capacity_factor`` (capacity) or ``top_k`` (dropless).

    For pruning infeasible plans, not for sizing to the last megabyte."""
    strategy = shard_lib.canonical_strategy(strategy)
    mc = model_config
    sizes = {ax: axis_sizes.get(ax, 1) for ax in mesh_lib.MESH_AXES}
    sp = sizes[mesh_lib.SEQUENCE_AXIS]
    tp = sizes[mesh_lib.TENSOR_AXIS]
    st = sizes[mesh_lib.STAGE_AXIS]
    act_bytes = comms_lib._itemsize(mc.compute_dtype)

    specs = comms_lib._specs(param_shapes, sizes, strategy)
    mem = {"params": 0.0, "opt": 0.0, "grads": 0.0}
    for name, shape in param_shapes.items():
        pspec, gspec = specs[name]
        size = math.prod(shape)
        p_shard = size / comms_lib._shard_factor(pspec, sizes)
        g_shard = size / comms_lib._shard_factor(gspec, sizes)
        mem["params"] += p_shard * 4
        if carry_cast and act_bytes < 4:
            mem["params"] += p_shard * act_bytes
        mem["opt"] += 2.0 * g_shard * opt_state_bytes
        mem["grads"] += g_shard * 4

    seq_local = max_seq_len // sp
    layers_local = mc.num_layers // st if st > 1 else mc.num_layers
    inter_local = (mc.intermediate_size // tp
                   if mc.intermediate_size % tp == 0 else mc.intermediate_size)
    if mc.num_experts > 0:
        # Capacity routing materialises the padded E*C slot buffer;
        # dropless holds exactly the k*T routed rows.
        mlp_scale = (mc.moe_top_k if mc.moe_impl == "dropless"
                     else mc.moe_top_k * mc.expert_capacity_factor)
    else:
        mlp_scale = 1.0
    per_token = 4 * mc.hidden_size + 2 * inter_local * mlp_scale
    activations = act_bytes * batch_size * seq_local * (
        layers_local * per_token + 4 * mc.hidden_size)
    mem["activations"] = activations
    mem["total"] = sum(mem.values())
    return mem


def hbm_budget_bytes(hbm_gb: Optional[float] = None,
                     device=None) -> Optional[float]:
    """Per-device memory budget in bytes: ``hbm_gb`` GiB when given, else
    the total memory of the CUDA card ``device`` runs on (default: the
    current card; ``torch.cuda.mem_get_info``) divided by the ranks of the
    process group on that card (``mesh.ranks_on_card``: ranks that share
    one card each get their share of it), else None (a CPU plans without a
    budget, as the JAX planner on a host without memory stats). Inside a
    process group every rank calls it alike."""
    if hbm_gb is not None:
        return float(hbm_gb) * GiB
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    dev = mesh_lib.local_device(device)
    if dev.type != "cuda":
        return None
    return (float(torch.cuda.mem_get_info(dev)[1])
            / mesh_lib.ranks_on_card(dev))


# --- scoring ----------------------------------------------------------------

def score_mesh(
    param_shapes,
    axis_sizes,
    strategy: str,
    *,
    model_config,
    global_rows: int,
    max_seq_len: int,
    grad_accum: int,
    device_kind: str = "",
    peak_flops: Optional[float] = None,
    opt_state_bytes: int = 4,
    carry_cast: bool = True,
) -> Dict[str, Any]:
    """One ranked-table entry of one feasible mesh: the comms model's
    serial roofline (compute seconds at the device's peak plus the bytes
    over the link rate, no overlap), compute stretched by the pipeline
    bubble ``1 + (st - 1) / M`` (the comms model counts bytes, not idle
    time), and the memory estimate."""
    sizes = {ax: axis_sizes.get(ax, 1) for ax in mesh_lib.MESH_AXES}
    dp = sizes[mesh_lib.DATA_AXIS] * sizes[mesh_lib.FSDP_AXIS]
    batch_per_shard = global_rows // dp
    rec = comms_lib.build_core(
        param_shapes, sizes, strategy,
        model_config=model_config, batch_size=batch_per_shard,
        max_seq_len=max_seq_len, grad_accum=grad_accum,
        device_kind=device_kind, peak_flops=peak_flops)
    mem = estimate_memory(
        param_shapes, sizes, strategy,
        model_config=model_config, batch_size=batch_per_shard,
        max_seq_len=max_seq_len,
        opt_state_bytes=opt_state_bytes, carry_cast=carry_cast)
    compute_ms = rec["compute_seconds_est"] * 1e3
    comms_ms = rec["comms_seconds_est"] * 1e3
    st = sizes[mesh_lib.STAGE_AXIS]
    bubble = 1.0
    if st > 1:
        micro = model_config.pipeline_microbatches or st
        bubble = 1.0 + (st - 1) / micro
    return {
        "mesh": sizes,
        "batch_per_shard": batch_per_shard,
        "predicted_step_ms": compute_ms * bubble + comms_ms,
        "compute_ms": compute_ms,
        "comms_ms": comms_ms,
        "bubble_factor": bubble,
        "bytes_per_device": rec["total_bytes_per_device_per_step"],
        "peak_hbm_gb": mem["total"] / GiB,
        "bound": rec["bound"],
    }


# --- the planner ------------------------------------------------------------

class NoFeasiblePlanError(ValueError):
    """No mesh factorization of the device count can run this model."""


_ASSUMPTIONS = {
    "score": "serial roofline: 6N-FLOPs compute + ring-collective "
             "bytes / ICI, no overlap (comms_model assumptions)",
    "global_batch_held_fixed": True,
    "memory": "analytic params+opt+grads via PartitionSpec shard "
              "factors; activations approximate (flash attention, "
              "per-layer residual+MLP streams)",
}


def _record(entries, *, n_devices, strategy, global_rows, max_seq_len,
            grad_accum, device_kind, budget, n_enumerated, n_feasible,
            pruned) -> Dict[str, Any]:
    chosen = entries[0]
    return {
        "kind": "mesh_plan",
        "schema_version": SCHEMA_VERSION,
        "devices": n_devices,
        "strategy": strategy,
        "global_rows": global_rows,
        "seq_len": max_seq_len,
        "grad_accum": grad_accum,
        "device_kind": device_kind or "unknown",
        "hbm_budget_gb": (budget / GiB) if budget is not None else None,
        "n_enumerated": n_enumerated,
        "n_feasible": n_feasible,
        "pruned": pruned,
        "chosen": chosen,
        "ranked": entries,
        "predicted_step_ms": chosen["predicted_step_ms"],
        "assumptions": dict(_ASSUMPTIONS),
    }


def plan(
    model_config,
    n_devices: int,
    *,
    global_rows: int,
    max_seq_len: int,
    grad_accum: int,
    strategy: str = "zero3",
    device_kind: str = "",
    hbm_gb: Optional[float] = None,
    peak_flops: Optional[float] = None,
    opt_state_bytes: int = 4,
    carry_cast: bool = True,
    top_k: int = 5,
    device=None,
) -> Dict[str, Any]:
    """Enumerate, prune, score, rank; the ``mesh_plan`` record.
    ``device_kind`` picks the link-rate row and (without ``peak_flops``)
    the peak FLOP/s (``comms_model.peak_flops_for_kind``); with neither,
    the roofline is the local device's. Without ``hbm_gb`` the budget is
    ``device``'s (``hbm_budget_bytes``). Every axis is a candidate (the
    port runs each on any device). Raises ``NoFeasiblePlanError`` when every factorization is
    pruned, with the reasons (capped)."""
    strategy = shard_lib.canonical_strategy(strategy)
    if peak_flops is None and device_kind:
        peak_flops = comms_lib.peak_flops_for_kind(device_kind)
    param_shapes = comms_lib.abstract_params(model_config)
    budget = hbm_budget_bytes(hbm_gb, device)

    scored: List[Dict[str, Any]] = []
    reasons: List[str] = []
    hbm_reasons: List[str] = []
    n_enumerated = 0
    pruned = {"divisibility": 0, "hbm": 0}
    for sizes in enumerate_meshes(n_devices):
        n_enumerated += 1
        err = feasibility_error(
            sizes, model_config, n_devices=n_devices,
            global_rows=global_rows, max_seq_len=max_seq_len)
        if err:
            pruned["divisibility"] += 1
            if len(reasons) < 8:
                reasons.append(err)
            continue
        entry = score_mesh(
            param_shapes, sizes, strategy,
            model_config=model_config, global_rows=global_rows,
            max_seq_len=max_seq_len, grad_accum=grad_accum,
            device_kind=device_kind, peak_flops=peak_flops,
            opt_state_bytes=opt_state_bytes, carry_cast=carry_cast)
        if budget is not None and entry["peak_hbm_gb"] * GiB > budget:
            pruned["hbm"] += 1
            if len(hbm_reasons) < 4:
                hbm_reasons.append(
                    f"mesh {tuple(sizes.values())} needs "
                    f"{entry['peak_hbm_gb']:.2f} GiB/device "
                    f"> budget {budget / GiB:.2f} GiB")
            continue
        scored.append(entry)

    if not scored:
        # The memory reasons first: "everything divisible was pruned on
        # memory" is the actionable story.
        raise NoFeasiblePlanError(
            f"no feasible mesh for {n_devices} devices "
            f"(global batch {global_rows}, seq {max_seq_len}): "
            + "; ".join((hbm_reasons + reasons)[:8]))

    # Deterministic rank: the predicted step time, then the axis tuple.
    scored.sort(key=lambda e: (e["predicted_step_ms"],
                               tuple(e["mesh"][ax] for ax in
                                     mesh_lib.MESH_AXES)))
    return _record(scored[:max(1, top_k)], n_devices=n_devices,
                   strategy=strategy, global_rows=global_rows,
                   max_seq_len=max_seq_len, grad_accum=grad_accum,
                   device_kind=device_kind, budget=budget,
                   n_enumerated=n_enumerated, n_feasible=len(scored),
                   pruned=pruned)


def plan_single(
    model_config,
    axis_sizes,
    strategy: str,
    *,
    global_rows: int,
    max_seq_len: int,
    grad_accum: int,
    device_kind: str = "",
    peak_flops: Optional[float] = None,
    hbm_gb: Optional[float] = None,
    opt_state_bytes: int = 4,
    carry_cast: bool = True,
) -> Dict[str, Any]:
    """The ``mesh_plan`` record of one pinned mesh, no search (the
    predicted-against-measured path): ``plan``'s record with a one-entry
    ranking."""
    strategy = shard_lib.canonical_strategy(strategy)
    if peak_flops is None and device_kind:
        peak_flops = comms_lib.peak_flops_for_kind(device_kind)
    sizes = {ax: axis_sizes.get(ax, 1) for ax in mesh_lib.MESH_AXES}
    n_devices = math.prod(sizes.values())
    param_shapes = comms_lib.abstract_params(model_config)
    entry = score_mesh(
        param_shapes, sizes, strategy,
        model_config=model_config, global_rows=global_rows,
        max_seq_len=max_seq_len, grad_accum=grad_accum,
        device_kind=device_kind, peak_flops=peak_flops,
        opt_state_bytes=opt_state_bytes, carry_cast=carry_cast)
    return _record([entry], n_devices=n_devices, strategy=strategy,
                   global_rows=global_rows, max_seq_len=max_seq_len,
                   grad_accum=grad_accum, device_kind=device_kind,
                   budget=hbm_budget_bytes(hbm_gb), n_enumerated=1,
                   n_feasible=1, pruned={"divisibility": 0, "hbm": 0})


def mesh_config_for(entry: Dict[str, Any]) -> mesh_lib.MeshConfig:
    """A plan entry's mesh as a ``MeshConfig``."""
    m = entry["mesh"]
    return mesh_lib.MeshConfig(**{
        field.name: int(m.get(field.name, 1))
        for field in dataclasses.fields(mesh_lib.MeshConfig)
    })


def render_table(record: Dict[str, Any]) -> List[str]:
    """The ranked plan table of a ``mesh_plan`` record."""
    hdr = "x".join(mesh_lib.MESH_AXES)
    lines = [
        (f"mesh_plan | {record['devices']} devices, strategy "
         f"{record['strategy']}, global batch {record['global_rows']} rows, "
         f"seq {record['seq_len']}, accum {record['grad_accum']}"),
        (f"mesh_plan | {record['n_enumerated']} factorizations -> "
         f"{record['n_feasible']} feasible "
         f"(pruned: {record['pruned']['divisibility']} divisibility, "
         f"{record['pruned']['hbm']} HBM"
         + (f" @ {record['hbm_budget_gb']:.1f} GiB/device"
            if record.get("hbm_budget_gb") else "") + ")"),
        (f"| rank | {hdr} | batch/shard | pred ms | compute ms | comms ms "
         f"| HBM GiB | bound |"),
        "|---|---|---|---|---|---|---|---|",
    ]
    for i, e in enumerate(record["ranked"]):
        m = "x".join(str(e["mesh"][ax]) for ax in mesh_lib.MESH_AXES)
        marker = " *" if i == 0 else ""
        lines.append(
            f"| {i + 1}{marker} | {m} | {e['batch_per_shard']} "
            f"| {e['predicted_step_ms']:.2f} | {e['compute_ms']:.2f} "
            f"| {e['comms_ms']:.2f} | {e['peak_hbm_gb']:.2f} "
            f"| {e['bound']} |")
    return lines
