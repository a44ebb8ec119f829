"""The collectives the trainer calls (no JAX counterpart: there XLA's SPMD
partitioner inserts them from the shardings).

``Collectives`` wraps one process group:

- ``reduce_scatter_leaf(t, dim)``: every rank's ``t`` summed, rank ``r``
  keeping slice ``r`` of ``dim``;
- ``all_gather_leaf(shard, dim)``: the rank-ordered concatenation of the
  shards along ``dim``;
- ``all_reduce_sum(t)``: every rank's ``t`` summed (a reduce-scatter of
  the flattened tensor, then an all-gather).

Each works on a contiguous copy with the split dim moved to the front,
so every rank's slice is one contiguous block.

**One fixed order of every sum.** A reduce-scatter sends slice ``r`` of
every rank's tensor to rank ``r`` (``all_to_all_single``), and rank ``r``
adds the parts in rank order: ``((t0 + t1) + t2) + t3``. The order is
the same on every rank and in every run, whatever the backend's own
reduction would do, and every rank receives the same bytes of the
result. Two operands are exact in either order, so at world 2 the sum
is the backend's too; at world 4 it is ``((t0 + t1) + t2) + t3``, the
order in which a world-1 step accumulates four micro-batches (a
replicated step at world W with one micro-batch a rank is bitwise the
world-1 step with W micro-batches). HYBRID_SHARD sums in two levels:
over the fsdp group (ranks ``d * F .. d * F + F - 1``), then over the
data group (ranks ``f, F + f, ...``):
``(t[0,0] + t[0,1]) + (t[1,0] + t[1,1])`` at data 2 x fsdp 2.

**gloo and CUDA tensors.** On a ``gloo`` group a CUDA tensor is always
staged through a pinned host buffer (chosen by the backend's name, never
by catching an error): two ranks sharing one card must use gloo, since
NCCL refuses two ranks on one GPU. A group keeps one send and one receive
buffer, grown to the largest call and reused by every call (each call's
copies and collective finish before it returns). Every collective is bounded by the
group's timeout (``parallel/mesh.collective_timeout``).

``ZeroGather`` is ZeRO-3's parameter gather: an autograd function whose
forward all-gathers a shard over the fsdp group and whose backward
reduce-scatters the full gradient back onto the shard
(``models/gpt.py`` calls it per block). Inside ``regather_saved`` (the
model's training forward) autograd saves no gathered parameter: it keeps
the recipe, and the backward gathers the parameter again when it needs
it (``_Regather``), so no block runs its forward twice unless the config
asks for remat.

``calls`` counts each kind of collective this process ran and the bytes
it put on the wire (the card's ``dist`` phase reports them a step; the
MoE layers' all-gathers of their routing counts, ``models/moe.py``,
count as ``moe_counts``), and ``regather_saved``, the saved tensors that
autograd kept as a recipe.
"""

from __future__ import annotations

import collections
import contextlib
import math
import weakref
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_trainer_torch.parallel import mesh as mesh_lib

calls: Dict[str, int] = collections.Counter()


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``((p[0] + p[1]) + p[2]) + ...`` over the leading dim."""
    acc = parts[0].clone()
    for i in range(1, parts.shape[0]):
        acc += parts[i]
    return acc


class Collectives:
    """Sums and gathers over one process group of ``ranks`` (global rank
    numbers, in group order). A group of one rank is the identity and
    needs no process group."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.world = len(self.ranks)
        self.rank = self.ranks.index(mesh_lib.process_index())
        self.backend = (dist.get_backend(group) if self.world > 1
                        else None)
        self._pinned: Dict[str, torch.Tensor] = {}

    # -- wire ----------------------------------------------------------------

    def _stage(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, which: str, shape, dtype) -> torch.Tensor:
        """A view of the group's pinned ``which`` buffer ("send" or
        "recv"), grown when a call needs more."""
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = self._pinned.get(which)
        if buf is None or buf.numel() < n:
            buf = self._pinned[which] = torch.empty(n, dtype=torch.uint8,
                                                    pin_memory=True)
        return buf[:n].view(dtype).view(shape)

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self._stage(t):
            host = self._host("send", t.shape, t.dtype)
            host.copy_(t)
            return host
        return t

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self._stage(like):
            return self._host("recv", shape, like.dtype)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    @staticmethod
    def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return w.to(like.device) if w.device != like.device else w

    def _count(self, kind: str, t: torch.Tensor) -> None:
        calls[kind] += 1
        calls[f"{kind}_bytes"] += t.numel() * t.element_size()

    # -- collectives -----------------------------------------------------------

    def reduce_scatter_leaf(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` summed in rank order; this rank's slice of
        ``dim`` (which the world divides)."""
        if self.world == 1:
            return t
        x = t.movedim(dim, 0)
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible "
                             f"by {self.world} ranks")
        wire = self._to_wire(x)
        out = self._empty(wire.shape, t)
        self._count("reduce_scatter", wire)
        dist.all_to_all_single(out, wire, group=self.group)
        parts = self._from_wire(out, t).reshape(
            self.world, n // self.world, *x.shape[1:])
        return _ordered_sum(parts).movedim(0, dim).contiguous()

    def all_gather_leaf(self, shard: torch.Tensor, dim: int,
                        kind: str = "all_gather") -> torch.Tensor:
        """The shards of every rank concatenated along ``dim`` in rank
        order; counted in ``calls`` under ``kind``."""
        if self.world == 1:
            return shard
        x = shard.movedim(dim, 0)
        wire = self._to_wire(x)
        out = self._empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          shard)
        self._count(kind, wire)
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return self._from_wire(out, shard).movedim(0, dim).contiguous()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` summed in rank order, on every rank (bitwise
        the same result everywhere)."""
        if self.world == 1:
            return t
        flat = t.reshape(-1)
        pad = (-flat.numel()) % self.world
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = self.reduce_scatter_leaf(flat, 0)
        full = self.all_gather_leaf(part, 0)
        return full[:t.numel()].reshape(t.shape)


class Topology:
    """Rank ``r``'s place on a ``(data, fsdp)`` mesh and its groups:
    ``fsdp`` (the ranks sharing its data coordinate, which ZeRO shards
    over), ``data`` (the ranks sharing its fsdp coordinate, the replicas
    HYBRID_SHARD all-reduces over) and ``dp`` (every rank: the batch's
    data shards). Every rank creates every group, in one order."""

    def __init__(self, data: int, fsdp: int):
        world = data * fsdp
        rank = mesh_lib.process_index()
        self.data_size, self.fsdp_size = data, fsdp
        self.data_coord, self.fsdp_coord = divmod(rank, fsdp)
        timeout = mesh_lib.collective_timeout()

        def group(ranks: List[int]):
            if len(ranks) == 1:
                return None
            if len(ranks) == world:
                return dist.group.WORLD
            return dist.new_group(ranks, timeout=timeout)

        fsdp_groups = [list(range(d * fsdp, (d + 1) * fsdp))
                       for d in range(data)]
        data_groups = [list(range(f, world, fsdp)) for f in range(fsdp)]
        made_f = [group(r) for r in fsdp_groups]
        made_d = [group(r) for r in data_groups]
        self.fsdp = Collectives(made_f[self.data_coord],
                                fsdp_groups[self.data_coord])
        self.data = Collectives(made_d[self.fsdp_coord],
                                data_groups[self.fsdp_coord])
        self.dp = Collectives(group(list(range(world))), list(range(world)))

    @property
    def dp_rank(self) -> int:
        """This rank's data shard (its block of the global batch rows)."""
        return self.data_coord * self.fsdp_size + self.fsdp_coord


_TOPOLOGIES: Dict[tuple, Topology] = {}


def topology(data: int, fsdp: int) -> Topology:
    """The ``Topology`` of this process group for ``(data, fsdp)``, made
    once (a trainer rebuilt after a rollback reuses its groups; every rank
    rebuilds in step)."""
    key = (data, fsdp, mesh_lib.process_count())
    if key not in _TOPOLOGIES:
        _TOPOLOGIES[key] = Topology(data, fsdp)
    return _TOPOLOGIES[key]


def _storage_key(t: torch.Tensor):
    return t.device, t.untyped_storage().data_ptr()


class _Regather:
    """ZeRO-3's regather in the backward without a second forward: the
    ``saved_tensors_hooks`` of one training forward. A tensor that
    autograd saves and that is a gathered parameter, a view of one, or a
    cast or concatenation of gathered parameters made through ``derive``
    is stored as the recipe that rebuilds it (its shards, the group, the
    dim and the cast), not as the full tensor; the backward runs the
    recipe (an all-gather) when the node that saved it runs, and frees the
    result after. Every other saved tensor is kept as autograd keeps it.

    Tensors are recognised by their storage, so an entry must not outlive
    its storage (the allocator hands the address to the next tensor): it
    is dropped when its tensor dies, which is before its storage is
    freed."""

    def __init__(self):
        self._recipes: Dict[tuple, object] = {}

    def register(self, t: torch.Tensor, recipe) -> None:
        """``recipe()`` rebuilds ``t``, a tensor that owns all of its
        storage (anything else is left to autograd)."""
        if (t.storage_offset() or not t.is_contiguous()
                or t.untyped_storage().nbytes()
                != t.numel() * t.element_size()):
            return
        key = _storage_key(t)
        self._recipes[key] = recipe
        weakref.finalize(t, self._recipes.pop, key, None)

    def rebuild(self, t: torch.Tensor):
        """A function that returns ``t`` afresh (``t`` a registered
        tensor or a view of one), else None."""
        recipe = self._recipes.get(_storage_key(t))
        if recipe is None:
            return None
        size, stride, offset = t.size(), t.stride(), t.storage_offset()
        return lambda: recipe().as_strided(size, stride, offset)

    def pack(self, t: torch.Tensor):
        rebuild = self.rebuild(t)
        if rebuild is None:
            return t
        calls["regather_saved"] += 1
        return rebuild

    @staticmethod
    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        with torch.no_grad():
            return packed()


_regather: Optional[_Regather] = None


@contextlib.contextmanager
def regather_saved():
    """The scope of one ZeRO-3 training forward (``models/gpt.py``):
    gathered parameters that autograd saves are regathered in the
    backward instead of kept (``_Regather``)."""
    global _regather
    prev, _regather = _regather, _Regather()
    try:
        with torch.autograd.graph.saved_tensors_hooks(_regather.pack,
                                                      _regather.unpack):
            yield
    finally:
        _regather = prev


def derive(fn, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``fn(*inputs)``; inside ``regather_saved`` with every input a
    gathered parameter (or a view of one), the result is registered too,
    so that autograd saves the recipe ``fn(*regathered inputs)`` instead
    of it (a cast or a concatenation of gathered weights)."""
    out = fn(*inputs)
    scope = _regather
    if scope is None or scope.rebuild(out) is not None:
        return out
    parts = [scope.rebuild(t) for t in inputs]
    if all(r is not None for r in parts):
        scope.register(out, lambda: fn(*[r() for r in parts]))
    return out


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, coll: Collectives, dim: int):
        ctx.coll, ctx.dim = coll, dim
        full = coll.all_gather_leaf(shard.detach(), dim)
        if _regather is not None:
            held = shard.detach()
            _regather.register(full, lambda: coll.all_gather_leaf(held, dim))
        return full

    @staticmethod
    def backward(ctx, grad):
        return ctx.coll.reduce_scatter_leaf(grad.float(), ctx.dim), None, None


class ZeroGather:
    """ZeRO-3's parameter gather over the fsdp group ``coll``. ``dims``
    maps each sharded parameter's name to its sharded dim (of the full,
    stacked leaf). ``leaf(name, t)`` gathers a whole leaf; ``layer(name,
    t)`` gathers one layer's slice ``t`` of a stacked ``layers.*`` leaf,
    whose dim is then one lower. Both are differentiable: the backward
    reduce-scatters the gradient, in f32, onto the shard (the sum over
    the fsdp group's ranks). Gathers run in the parameter's dtype, so the
    model's casts see the world-1 values."""

    def __init__(self, coll: Collectives, dims: Dict[str, int]):
        self.coll = coll
        self.dims = dims

    def leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        if dim is None:
            return t
        return _GatherLeaf.apply(t, self.coll, dim)

    def per_layer(self, name: str) -> bool:
        """Is the stacked leaf ``name`` gathered a layer at a time (its
        sharded dim is not the layer dim)?"""
        return self.dims.get(name, 1) != 0

    def layer(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        if dim is None or dim == 0:
            return t
        return _GatherLeaf.apply(t, self.coll, dim - 1)


def gather_scalars(values: Sequence[float]) -> torch.Tensor:
    """Every rank's float64 ``values`` as a ``[world, n]`` CPU tensor, over
    the default group."""
    mine = torch.tensor([float(v) for v in values], dtype=torch.float64)
    world = mesh_lib.process_count()
    if world == 1:
        return mine[None]
    if dist.get_backend() == "nccl":
        mine = mine.cuda()
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu()
