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

**Tensor, sequence and expert parallelism.** ``Topology`` also holds the
``tensor`` group (the ranks that differ only in their tensor coordinate),
the ``sequence`` group and the ``expert`` groups, and the Megatron pair
as autograd functions over any of them: ``copy_to_tensor`` (identity
forward, gradient summed over the group: before a column-parallel matmul,
and before a MoE layer's local experts) and ``reduce_from_tensor``
(summed forward, identity backward: after a row-parallel matmul, and
after a MoE layer's combine); ``gather_from_tensor`` / ``slice_to_tensor`` (a
hidden-sharded activation gathered, its gradient sliced; and the
reverse); ``tensor_all_to_all`` (the tiled all-to-all that turns the
embedding's ``[V, H/ts]`` hidden slice into a ``[V/ts, H]`` vocab slice,
``ops/loss.py``); and ``SequencePermute``, the ring's neighbour permute
over the sequence group (its backward the reverse permute,
``ops/ring.py``). Sums keep the fixed rank order above.

``calls`` counts each kind of collective this process ran and the bytes
it put on the wire (the card's ``dist`` phase reports them a step; the
MoE layers' all-gathers of their routing counts, ``models/moe.py``,
count as ``moe_counts``, their sums over the expert and tensor ranks as
``moe_allreduce``; the tensor-parallel ones as ``tp_allreduce``,
``tp_gather``, ``tp_alltoall`` and ``tp_max``, the ring's as
``ring_permute``, the pipeline's point-to-point sends as ``pp_send``, its
head's broadcast and sums over the stage group as ``pp_bcast``,
``pp_allreduce`` and ``pp_max``), and ``regather_saved``, the saved
tensors that autograd kept as a recipe.
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

    def reduce_scatter_leaf(self, t: torch.Tensor, dim: int,
                            kind: Optional[str] = "reduce_scatter"
                            ) -> torch.Tensor:
        """Every rank's ``t`` summed in rank order; this rank's slice of
        ``dim`` (which the world divides). Counted under ``kind`` (None:
        not counted)."""
        if self.world == 1:
            return t
        x = t.movedim(dim, 0)
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible "
                             f"by {self.world} ranks")
        wire = self._to_wire(x)
        out = self._empty(wire.shape, t)
        if kind is not None:
            self._count(kind, wire)
        dist.all_to_all_single(out, wire, group=self.group)
        parts = self._from_wire(out, t).reshape(
            self.world, n // self.world, *x.shape[1:])
        return _ordered_sum(parts).movedim(0, dim).contiguous()

    def all_gather_leaf(self, shard: torch.Tensor, dim: int,
                        kind: Optional[str] = "all_gather") -> torch.Tensor:
        """The shards of every rank concatenated along ``dim`` in rank
        order; counted in ``calls`` under ``kind`` (None: not counted)."""
        if self.world == 1:
            return shard
        x = shard.movedim(dim, 0)
        wire = self._to_wire(x)
        out = self._empty((self.world * x.shape[0],) + tuple(x.shape[1:]),
                          shard)
        if kind is not None:
            self._count(kind, wire)
        dist.all_gather_into_tensor(out, wire, group=self.group)
        return self._from_wire(out, shard).movedim(0, dim).contiguous()

    def all_reduce_sum(self, t: torch.Tensor,
                       kind: Optional[str] = None) -> torch.Tensor:
        """Every rank's ``t`` summed in rank order, on every rank (bitwise
        the same result everywhere). With ``kind`` it counts once under
        that name; else as its reduce-scatter and all-gather."""
        if self.world == 1:
            return t
        flat = t.reshape(-1)
        pad = (-flat.numel()) % self.world
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if kind is not None:
            self._count(kind, flat)
            part = self.reduce_scatter_leaf(flat, 0, kind=None)
            full = self.all_gather_leaf(part, 0, kind=None)
        else:
            part = self.reduce_scatter_leaf(flat, 0)
            full = self.all_gather_leaf(part, 0)
        return full[:t.numel()].reshape(t.shape)

    def all_reduce_max(self, t: torch.Tensor,
                       kind: str = "tp_max") -> torch.Tensor:
        """The elementwise maximum of every rank's ``t``, on every rank."""
        if self.world == 1:
            return t
        return self.all_gather_leaf(t[None], 0, kind=kind).amax(dim=0)

    def all_to_all_tiled(self, x: torch.Tensor,
                         kind: str = "tp_alltoall") -> torch.Tensor:
        """``[world * n, c]`` -> ``[n, world * c]``: row block ``j`` of
        every rank goes to rank ``j``, which concatenates what it receives
        along the columns in rank order (the JAX ``all_to_all(split_axis=0,
        concat_axis=1, tiled=True)``)."""
        if self.world == 1:
            return x
        n = x.shape[0] // self.world
        wire = self._to_wire(x)
        out = self._empty(wire.shape, x)
        self._count(kind, wire)
        dist.all_to_all_single(out, wire, group=self.group)
        got = self._from_wire(out, x).reshape(self.world, n, *x.shape[1:])
        return got.transpose(0, 1).reshape(n, -1).contiguous()

    def all_to_all_untiled(self, y: torch.Tensor,
                           kind: str = "tp_alltoall") -> torch.Tensor:
        """The inverse of ``all_to_all_tiled``: ``[n, world * c]`` ->
        ``[world * n, c]``."""
        if self.world == 1:
            return y
        n = y.shape[0]
        x = y.reshape(n, self.world, -1).transpose(0, 1).contiguous()
        wire = self._to_wire(x)
        out = self._empty(wire.shape, y)
        self._count(kind, wire)
        dist.all_to_all_single(out, wire, group=self.group)
        return self._from_wire(out, y).reshape(self.world * n, -1).clone()

    def permute(self, t: torch.Tensor, send_to: int, recv_from: int,
                kind: str = "ring_permute") -> torch.Tensor:
        """Send ``t`` to group rank ``send_to`` and return what group rank
        ``recv_from`` sends here (same shape and dtype on every rank)."""
        if send_to == self.rank:
            if recv_from != self.rank:
                raise ValueError("a rank that keeps its tensor receives none")
            return t.clone()
        wire = self._to_wire(t)
        out = self._empty(wire.shape, t)
        self._count(kind, wire)
        reqs = [dist.isend(wire, self.ranks[send_to], group=self.group),
                dist.irecv(out, self.ranks[recv_from], group=self.group)]
        for r in reqs:
            r.wait()
        return self._from_wire(out, t).clone()

    # -- point to point (the pipeline) ----------------------------------------

    def send(self, t: torch.Tensor, to: int, tag: int = 0,
             kind: str = "pp_send"):
        """Post ``t`` to group rank ``to``; returns a function that waits
        for the send. On gloo a CUDA tensor is copied to a host buffer of
        its own (several sends may be in flight)."""
        wire = t.detach().contiguous()
        if self._stage(wire):
            wire = wire.to("cpu")
        self._count(kind, wire)
        if wire.numel() == 0:
            return lambda: None
        req = dist.isend(wire, self.ranks[to], group=self.group, tag=tag)

        def wait():
            req.wait()
            wire.numel()        # the buffer lives until the send is done
        return wait

    def recv(self, shape, dtype, device, frm: int, tag: int = 0):
        """Post a receive of a ``shape`` / ``dtype`` tensor from group rank
        ``frm``; returns a function that waits and gives it on
        ``device``."""
        dev = torch.device(device)
        host = self.backend == "gloo" and dev.type == "cuda"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else dev)
        if buf.numel() == 0:
            return lambda: buf.to(dev)
        req = dist.irecv(buf, self.ranks[frm], group=self.group, tag=tag)

        def wait():
            req.wait()
            return buf.to(dev)
        return wait

    def broadcast(self, t: torch.Tensor, src: int,
                  kind: str = "pp_bcast") -> torch.Tensor:
        """Group rank ``src``'s ``t`` on every rank (``t`` elsewhere only
        gives the shape and dtype)."""
        if self.world == 1:
            return t
        wire = t.detach().contiguous()
        if self._stage(wire):
            wire = wire.to("cpu")
        elif self.rank == src:
            wire = wire.clone()
        if self.rank == src:
            self._count(kind, wire)
        if wire.numel():
            dist.broadcast(wire, self.ranks[src], group=self.group)
        return wire.to(t.device)


class Topology:
    """Rank ``r``'s place on a ``(data, fsdp, sequence, tensor, expert,
    stage)`` mesh (row-major over ``mesh.MESH_AXES``, stage innermost) and
    its groups, each the ranks that share every coordinate but the named
    ones:

    - ``fsdp`` (varying fsdp: ZeRO shards over it), ``data`` (varying
      data: the replicas HYBRID_SHARD all-reduces over), ``dp`` (varying
      data and fsdp: the batch's data shards);
    - ``tensor`` (Megatron's group), ``sequence`` (the ring) and
      ``expert`` (the ranks that split a MoE layer's experts);
      ``expert_tensor`` (varying tensor and expert: the ranks that share a
      MoE layer's tokens and sum its output);
    - ``rep`` (varying data, fsdp and sequence: the ranks whose gradient
      of a parameter they replicate is summed; also the MoE routing group,
      the ranks that hold distinct tokens) and ``rep_data`` (varying data
      and sequence: the same after the fsdp reduce-scatter). Neither
      varies tensor or expert: a leaf replicated there has the same
      gradient on every such rank;
    - ``stage`` (varying stage: the pipeline's ranks, which hold a data
      shard's layers between them; ``rep`` and ``rep_data`` never vary
      it, and a leaf outside the layer stack sums its partial gradients
      over it once).

    At sequence = tensor = expert = 1, ``rep`` is ``dp`` and ``rep_data``
    is ``data``. Every rank creates every group, in one order."""

    def __init__(self, data: int, fsdp: int, sequence: int = 1,
                 tensor: int = 1, expert: int = 1, stage: int = 1):
        sizes = (data, fsdp, sequence, tensor, expert, stage)
        world = math.prod(sizes)
        rank = mesh_lib.process_index()
        self.sizes = sizes
        self.data_size, self.fsdp_size = data, fsdp
        self.sequence_size, self.tensor_size = sequence, tensor
        self.expert_size, self.stage_size = expert, stage
        (self.data_coord, self.fsdp_coord, self.sequence_coord,
         self.tensor_coord, self.expert_coord,
         self.stage_coord) = mesh_lib.mesh_coords(sizes, rank)
        timeout = mesh_lib.collective_timeout()
        made: Dict[tuple, object] = {}

        def group(ranks: List[int]):
            key = tuple(ranks)
            if key not in made:
                if len(ranks) == 1:
                    made[key] = None
                elif len(ranks) == world:
                    made[key] = dist.group.WORLD
                else:
                    made[key] = dist.new_group(ranks, timeout=timeout)
            return made[key]

        def coll(varying: Sequence[int]) -> Collectives:
            """The group of this rank along the axes ``varying`` (indices
            into ``sizes``); every group of that kind is made."""
            mine = None
            for r in range(world):
                c = mesh_lib.mesh_coords(sizes, r)
                if any(c[i] for i in varying):
                    continue        # not the first rank of its group
                members = [q for q in range(world)
                           if all(mesh_lib.mesh_coords(sizes, q)[i] == c[i]
                                  for i in range(len(sizes))
                                  if i not in varying)]
                g = group(members)
                if rank in members:
                    mine = Collectives(g, members)
            return mine

        self.fsdp = coll((1,))
        self.data = coll((0,))
        self.dp = coll((0, 1))
        self.tensor = coll((3,))
        self.sequence = coll((2,))
        self.expert = coll((4,))
        self.expert_tensor = coll((3, 4))
        self.rep = coll((0, 1, 2))
        self.rep_data = coll((0, 2))
        self.stage = coll((5,))

    @property
    def dp_rank(self) -> int:
        """This rank's data shard (its block of the global batch rows)."""
        return self.data_coord * self.fsdp_size + self.fsdp_coord


_TOPOLOGIES: Dict[tuple, Topology] = {}


def topology(data: int, fsdp: int, sequence: int = 1, tensor: int = 1,
             expert: int = 1, stage: int = 1) -> Topology:
    """The ``Topology`` of this process group for the mesh, made once (a
    trainer rebuilt after a rollback reuses its groups; every rank
    rebuilds in step)."""
    key = (data, fsdp, sequence, tensor, expert, stage,
           mesh_lib.process_count())
    if key not in _TOPOLOGIES:
        _TOPOLOGIES[key] = Topology(data, fsdp, sequence, tensor, expert,
                                    stage)
    return _TOPOLOGIES[key]


# -- tensor and sequence parallelism ------------------------------------------

class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives, kind: str):
        ctx.coll, ctx.kind = coll, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_reduce_sum(g.contiguous(),
                                       kind=ctx.kind), None, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives, kind: str):
        return coll.all_reduce_sum(x.contiguous(), kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _own_slice(t: torch.Tensor, coll: Collectives, dim: int) -> torch.Tensor:
    n = t.shape[dim] // coll.world
    return t.narrow(dim, coll.rank * n, n).contiguous()


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives, dim: int):
        ctx.coll, ctx.dim = coll, dim
        return coll.all_gather_leaf(x.contiguous(), dim, kind="tp_gather")

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.coll, ctx.dim), None, None


class _SliceToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives, dim: int):
        ctx.coll, ctx.dim = coll, dim
        return _own_slice(x, coll, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_gather_leaf(g.contiguous(), ctx.dim,
                                        kind="tp_gather"), None, None


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives):
        ctx.coll = coll
        return coll.all_to_all_tiled(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.all_to_all_untiled(g.contiguous()), None


def copy_to_tensor(x: torch.Tensor, coll: Optional[Collectives],
                   kind: str = "tp_allreduce") -> torch.Tensor:
    """Megatron's ``f``: ``x`` unchanged; its gradient summed over the
    group ``coll`` (the input of a column-parallel matmul; of a MoE
    layer's local experts over the expert and tensor ranks)."""
    if coll is None or coll.world == 1:
        return x
    return _CopyToTensor.apply(x, coll, kind)


def reduce_from_tensor(x: torch.Tensor, coll: Optional[Collectives],
                       kind: str = "tp_allreduce") -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over the group ``coll`` in rank
    order; the gradient unchanged (the output of a row-parallel matmul; a
    MoE layer's combine over the expert and tensor ranks)."""
    if coll is None or coll.world == 1:
        return x
    return _ReduceFromTensor.apply(x, coll, kind)


def gather_from_tensor(x: torch.Tensor, coll: Optional[Collectives],
                       dim: int = -1) -> torch.Tensor:
    """The ranks' slices of ``dim`` concatenated; the gradient sliced back
    (the gradient is the same on every rank)."""
    if coll is None or coll.world == 1:
        return x
    return _GatherFromTensor.apply(x, coll, dim % x.dim())


def slice_to_tensor(x: torch.Tensor, coll: Optional[Collectives],
                    dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``dim`` of a replicated ``x``; the gradient
    gathered (each rank computed its slice's)."""
    if coll is None or coll.world == 1:
        return x
    return _SliceToTensor.apply(x, coll, dim % x.dim())


def tensor_all_to_all(x: torch.Tensor, coll: Optional[Collectives]
                      ) -> torch.Tensor:
    """``Collectives.all_to_all_tiled``, differentiable (the backward is
    the inverse all-to-all)."""
    if coll is None or coll.world == 1:
        return x
    return _AllToAllTiled.apply(x, coll)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll: Collectives, send_to: int, recv_from: int):
        ctx.coll, ctx.route = coll, (send_to, recv_from)
        return coll.permute(x.contiguous(), send_to, recv_from)

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from = ctx.route
        return (ctx.coll.permute(g.contiguous(), recv_from, send_to),
                None, None, None)


class SequencePermute:
    """The ring's permute (``ops/ring.py``) over the sequence group
    ``coll``, one rank a process: ``self([x], dest)`` sends ``x`` to group
    rank ``dest[me]`` and returns ``[what group rank dest^-1(me) sent]``;
    differentiable (the backward sends the gradient back along the reverse
    route)."""

    def __init__(self, coll: Collectives):
        self.coll = coll

    def __call__(self, xs: List[torch.Tensor], dest: Sequence[int]
                 ) -> List[torch.Tensor]:
        me = self.coll.rank
        return [_Permute.apply(xs[0], self.coll, dest[me],
                               list(dest).index(me))]


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
