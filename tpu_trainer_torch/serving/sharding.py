"""Tensor-parallel (head-sharded) layout of a serving replica (port of
``tpu_trainer/serving/sharding.py``).

One replica is one engine process over a ``tp``-way mesh: its parameters
and its paged KV pools are held as ``tp`` shards, separate contiguous
tensors, shard ``i`` on the mesh's device ``i``. Block tables, lengths and
offsets stay one copy on the compute device (shard 0's), the host
scheduler's mirror, copied to each shard's device where a shard reads
them. Every parameter leaf is cut on its largest tp-divisible axis (a
shard holds ~P/tp bytes) and gathered back by ``torch.cat`` on the compute
device for each step: an exact concatenation, so every matmul after it
sees the single-device operands and a sharded replica's greedy streams
are one device's by construction.

The pools shard on their kv-heads axis when ``kv_heads % tp == 0`` (each
block costs 1/tp of its bytes per shard). GQA with ``kv_heads < tp``
(``tp % kv_heads == 0``) replicates them: every shard holds all kv heads,
its contiguous query-head slice falls inside one kv group, and the decode
kernel reads that one kv head in place (``ops/flash.py::
paged_attention_sharded``).

Mesh entries are CUDA ordinals (``cuda:<id>``); on a machine with several
cards the gather is a peer copy. A repeated ordinal puts several shards
on one card (``shares_card``). On the CPU the ids are labels and every
shard is a CPU tensor. ``mesh_tensor=n`` without ids means ordinals
``0..n-1``, and raises when one is absent: a mesh never wraps onto card 0
silently.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

def validate_tp(num_heads: int, kv_heads: int, tp: int) -> None:
    """The head-sharding feasibility rule: Q heads split evenly over the
    mesh, and KV heads either split evenly too or are replicated with
    whole Q-head groups per device (``tp % kv_heads == 0``)."""
    if tp < 1:
        raise ValueError(f"paged_tp={tp} < 1")
    if tp == 1:
        return
    if num_heads % tp:
        raise ValueError(
            f"paged_tp={tp} does not divide num_heads={num_heads}")
    if kv_heads % tp and tp % kv_heads:
        raise ValueError(
            f"paged_tp={tp} vs kv_heads={kv_heads}: need kv_heads % tp "
            f"== 0 (sharded KV) or tp % kv_heads == 0 (replicated KV, "
            f"GQA)")


def kv_sharded(kv_heads: int, tp: int) -> bool:
    """True when the KV pools shard over heads (the capacity win); False
    in GQA-replicate mode (``tp % kv_heads == 0``), where every shard
    holds the full pools."""
    return tp > 1 and kv_heads % tp == 0


def shard_factor(kv_heads: int, tp: int) -> int:
    """Pool capacity multiplier: with kv-head-sharded pools each block
    costs 1/tp of its single-device bytes per shard, so a per-shard block
    budget B affords B*tp pool blocks. Replicated (GQA) pools gain
    nothing."""
    return tp if kv_sharded(kv_heads, tp) else 1


def resolve_devices(tp: int, device_ids: Optional[Sequence[int]] = None,
                    kind: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices of a tp-way mesh: the first ``tp`` of ``device_ids``
    when given (one fleet of meshes on one host), else ordinals
    ``0..tp-1``. On CUDA an ordinal past the visible cards raises; a
    repeated one puts two shards on one card. On the CPU the ids are
    labels."""
    ids = (tuple(int(i) for i in device_ids) if device_ids
           else tuple(range(tp)))
    if len(ids) < tp:
        raise ValueError(f"paged_tp={tp} > {len(ids)} mesh device ids")
    ids = ids[:tp]
    if kind == "cpu":
        return tuple(torch.device("cpu") for _ in ids)
    if kind != "cuda":
        raise ValueError(f"unsupported device type {kind!r} (cuda | cpu)")
    n = torch.cuda.device_count()
    missing = sorted({i for i in ids if not 0 <= i < n})
    if missing:
        raise ValueError(
            f"CUDA ordinals {missing} not visible (have {n}); name the "
            f"cards with mesh_devices, repeating an ordinal to put several "
            f"shards on one card, e.g. {(0,) * tp}")
    return tuple(torch.device("cuda", i) for i in ids)


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """A replica's single-axis decode mesh: ``tp`` shards, shard ``i`` on
    ``devices[i]``; ``ids`` the ordinals (labels on the CPU)."""

    tp: int
    ids: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def compute_device(self) -> torch.device:
        """Where the gathered parameters and the dense compute live."""
        return self.devices[0]

    @property
    def shares_card(self) -> bool:
        """Several shards on one device (a repeated ordinal, or the CPU)."""
        return len(set(self.devices)) < len(self.devices)


@functools.lru_cache(maxsize=None)
def tp_mesh(tp: int, device_ids: Optional[Tuple[int, ...]] = None,
            kind: str = "cuda") -> TPMesh:
    """The (cached) mesh of ``(tp, device_ids)`` on ``kind`` devices."""
    devices = resolve_devices(tp, device_ids, kind)
    ids = (tuple(int(i) for i in device_ids)[:tp] if device_ids
           else tuple(range(tp)))
    return TPMesh(tp, ids, devices)


def pick_shard_axis(shape: Sequence[int], tp: int) -> Optional[int]:
    """Placement rule for a parameter leaf: the largest axis ``tp``
    divides evenly (ties -> the lowest axis), or None to replicate.
    Deterministic, so every engine in a fleet holds the same layout."""
    best = None
    for ax, n in enumerate(shape):
        if n % tp == 0 and (best is None or n > shape[best]):
            best = ax
    return best


@dataclasses.dataclass
class ShardedParams:
    """Parameters held as shards: ``shards[i]`` maps each name to shard
    ``i``'s piece on ``mesh.devices[i]``; ``axes`` the cut axis of each
    name (None: the leaf whole on every shard)."""

    mesh: TPMesh
    axes: Dict[str, Optional[int]]
    shards: List[Dict[str, torch.Tensor]]

    def nbytes(self) -> List[int]:
        """Persistent parameter bytes of each shard."""
        return [sum(t.numel() * t.element_size() for t in s.values())
                for s in self.shards]


def shard_params(params: Dict[str, torch.Tensor], mesh: TPMesh
                 ) -> ShardedParams:
    """Cut every leaf on its ``pick_shard_axis`` into contiguous pieces,
    piece ``i`` on shard ``i``'s device; no whole copy of a cut leaf is
    kept."""
    tp = mesh.tp
    axes = {n: pick_shard_axis(tuple(t.shape), tp)
            for n, t in params.items()}
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(tp)]
    for name, t in params.items():
        ax = axes[name]
        for i, dev in enumerate(mesh.devices):
            piece = t if ax is None else t.chunk(tp, dim=ax)[i]
            shards[i][name] = piece.to(dev, copy=True).contiguous()
    return ShardedParams(mesh, axes, shards)


def gather_params(params: ShardedParams) -> Dict[str, torch.Tensor]:
    """Every leaf whole on the compute device: ``torch.cat`` of the
    shards' pieces in shard order (a peer copy across cards), an exact
    concatenation; a replicated leaf is shard 0's."""
    dev = params.mesh.compute_device
    out = {}
    for name, ax in params.axes.items():
        if ax is None:
            out[name] = params.shards[0][name]
        else:
            out[name] = torch.cat(
                [s[name].to(dev) for s in params.shards], dim=ax)
    return out


def shard_cache(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                mesh: TPMesh, kv_heads: int
                ) -> List[Dict[str, torch.Tensor]]:
    """Zero per-shard pools for the whole-pool ``shapes`` (``{leaf:
    (shape, dtype)}``, kv heads on axis 3): each shard holds ``kvh/tp``
    of the kv heads when ``kv_heads % tp == 0``, else (GQA, replicated)
    all of them."""
    tp = mesh.tp
    out = []
    for dev in mesh.devices:
        shard = {}
        for key, (shape, dtype) in shapes.items():
            shape = list(shape)
            if kv_sharded(kv_heads, tp):
                shape[3] //= tp
            shard[key] = torch.zeros(shape, dtype=dtype, device=dev)
        out.append(shard)
    return out
