"""Process mesh and rendezvous (port of ``tpu_trainer/parallel/mesh.py``).

The JAX package carves its devices into named axes and lets XLA insert
the collectives; the port runs one process a device and does the
collectives itself (``parallel/collectives.py``). What carries over:

- ``MeshConfig`` and ``resolve``: the six axes, ``-1`` = the rest, the
  same errors. All six run here, each beside any other.
- Rank ``r`` sits at the row-major coordinate of ``MESH_AXES``
  (``mesh_coords``: stage innermost, then expert, tensor, sequence, fsdp,
  data, as ``make_mesh`` lays out one device a process). The batch rows
  shard over ``data x fsdp`` jointly, so the ranks of data shard ``d *
  fsdp + f`` load row block ``d * fsdp + f``; the ranks along
  ``sequence``, ``tensor``, ``expert`` and ``stage`` load the same rows
  (``host_feed_info``) and a sequence rank keeps its slice of the
  columns (``training/trainer.py``). The expert and stage axes shard no
  attention operand, so they add nothing to ``attention_shard_coord``.
- ``attention_shard_spec`` / ``attention_shard_coord``: which of the
  attention operands' dims shard (batch over ``data x fsdp`` when it
  divides, heads over ``tensor`` when both head counts divide) and the
  shard's linear coordinate, which an attention-dropout seed folds in
  (``ops/attention.fold_seed``).
- ``initialize_distributed``: ``torch.distributed.init_process_group``
  from torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` or the JAX names ``COORDINATOR_ADDRESS`` /
  ``NUM_PROCESSES`` / ``PROCESS_ID``; ``COORDINATOR_TIMEOUT_S`` bounds the
  rendezvous and every collective. The backend is ``nccl`` for a CUDA
  device and ``gloo`` on the CPU unless ``backend=`` names one. Ranks of
  one host that outnumber its cards share them (``local_device``: card
  ``local rank % cards``), and NCCL refuses two ranks on one GPU, so
  then the backend is ``gloo`` (``shares_card``): the elastic
  supervisor's children on a one-card machine run so, with no flag.
- ``barrier``, ``global_any``, ``broadcast_from_host0`` and
  ``shutdown_distributed`` over the default process group; each is the
  identity at one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SEQUENCE_AXIS = "sequence"
TENSOR_AXIS = "tensor"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
MESH_AXES = (
    DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS, TENSOR_AXIS, EXPERT_AXIS, STAGE_AXIS,
)

_DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How to carve the processes into parallelism axes.

    ``-1`` means "all remaining processes" (at most one axis may be -1).
    """

    data: int = -1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1
    expert: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> tuple:
        sizes = [self.data, self.fsdp, self.sequence, self.tensor,
                 self.expert, self.stage]
        n_auto = sum(1 for s in sizes if s == -1)
        if n_auto > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if n_auto == 1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes = [n_devices // fixed if s == -1 else s for s in sizes]
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} are "
                f"available")
        return tuple(sizes)


def dp_size(sizes: tuple) -> int:
    """Number of distinct data shards (data x fsdp axes)."""
    return sizes[0] * sizes[1]


def mesh_coords(sizes: tuple, rank: int) -> tuple:
    """Rank ``rank``'s coordinate on each of ``MESH_AXES`` (row-major,
    the last axis innermost)."""
    out = []
    for n in reversed(sizes):
        rank, c = divmod(rank, n)
        out.append(c)
    return tuple(reversed(out))


def attention_shard_spec(sizes: tuple, batch: int, heads: int,
                         kv_heads: Optional[int] = None):
    """The JAX ``attention_shard_spec`` for ``[b, s, h, d]`` attention
    operands of global batch ``batch``: ``(b_spec, h_spec)``, batch over
    ``(data, fsdp)`` when their product exceeds 1 and divides it, heads
    over ``tensor`` when its size exceeds 1 and divides both ``heads``
    and ``kv_heads``; None where the dim is replicated."""
    dp = dp_size(sizes)
    b_spec = (DATA_AXIS, FSDP_AXIS) if dp > 1 and batch % dp == 0 else None
    tp = sizes[MESH_AXES.index(TENSOR_AXIS)]
    kv_heads = heads if kv_heads is None else kv_heads
    h_spec = (TENSOR_AXIS if tp > 1 and heads % tp == 0
              and kv_heads % tp == 0 else None)
    return b_spec, h_spec


def attention_shard_coord(sizes: tuple, coords: tuple, b_spec,
                          h_spec) -> int:
    """The JAX ``attention_shard_coord``: the linear coordinate of this
    shard along the axes that shard the attention operands (0 when none
    does): ``(data, fsdp)`` when the batch shards, then ``tensor`` when
    the heads do. Folding it into a dropout seed decorrelates masks across
    shards, and only across sharded axes."""
    coord = 0
    if b_spec is not None:
        for ax in (DATA_AXIS, FSDP_AXIS):
            i = MESH_AXES.index(ax)
            coord = coord * sizes[i] + coords[i]
    if h_spec is not None:
        i = MESH_AXES.index(TENSOR_AXIS)
        coord = coord * sizes[i] + coords[i]
    return coord


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def collective_timeout() -> datetime.timedelta:
    """The bound on the rendezvous and on every collective:
    ``COORDINATOR_TIMEOUT_S`` seconds (default 600). A rank that died or
    hung surfaces as an error on the others instead of a stall."""
    return datetime.timedelta(
        seconds=_int_env("COORDINATOR_TIMEOUT_S") or _DEFAULT_TIMEOUT_S)


def _local_rendezvous(address: Optional[str]) -> bool:
    """Is a rendezvous address (``host:port``, ``tcp://...``,
    ``file://...``) on this host?"""
    if not address:
        return False
    if address.startswith("file://"):
        return True
    host = address.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def local_ranks() -> tuple:
    """``(local rank, ranks on this host)``: torchrun's ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``; else, when ``COORDINATOR_ADDRESS`` is on this
    host (the elastic supervisor's children), ``PROCESS_ID`` of
    ``NUM_PROCESSES``; else ``(0, 1)``."""
    if _int_env("LOCAL_RANK") is not None:
        return (_int_env("LOCAL_RANK"),
                _int_env("LOCAL_WORLD_SIZE") or _int_env("WORLD_SIZE") or 1)
    if (_local_rendezvous(os.environ.get("COORDINATOR_ADDRESS"))
            and _int_env("PROCESS_ID") is not None):
        return _int_env("PROCESS_ID"), _int_env("NUM_PROCESSES") or 1
    return 0, 1


def shares_card() -> bool:
    """Do this host's ranks outnumber its cards (so two share one)?"""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return cards > 0 and local_ranks()[1] > cards


def ranks_on_card(device) -> int:
    """How many ranks of the process group run on the CUDA card
    ``device`` (1 outside a group): every rank's host and card, gathered
    over the group, so the count holds however the ranks were started
    (torchrun's ``LOCAL_WORLD_SIZE``, or spawned ranks that each name
    card 0). Collective: every rank of the group calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    dev = torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    mine = (socket.gethostname(), str(getattr(props, "uuid", dev.index)))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every.count(mine)


def local_device(device) -> torch.device:
    """``device`` with a CUDA index filled in: ``cuda`` alone is card
    ``local rank % cards`` (``local_ranks``; torchrun's ``LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = max(1, torch.cuda.device_count())
        dev = torch.device("cuda", local_ranks()[0] % cards)
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: Optional[bool] = None, *,
                           backend: Optional[str] = None,
                           device=None,
                           init_method: Optional[str] = None) -> bool:
    """Join the process group (the reference's ``dist.init_process_group``);
    returns True when this process is one rank of several.

    Rank and world come from the arguments, else the JAX names
    (``COORDINATOR_ADDRESS`` ``host:port``, ``NUM_PROCESSES``,
    ``PROCESS_ID``), else torchrun's (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). ``init_method``
    (e.g. ``file://<path>``, a rendezvous without a TCP port, which the
    tests use) overrides the address. Without any of them the run is one
    process and nothing is joined, unless ``auto`` (the CLI's
    ``--multihost``) asks for a rendezvous, which then raises naming what
    is missing. An existing process group is kept, so a harness may join
    its own group (another ``backend``, a file rendezvous) before it calls
    the CLI. ``backend``: else ``nccl`` when ``device`` is CUDA and
    ``gloo`` otherwise, and ``gloo`` when ranks share a card
    (``shares_card``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = (process_id if process_id is not None
                  else _int_env("PROCESS_ID"))
    if num_processes is None and _int_env("WORLD_SIZE") is not None:
        num_processes = _int_env("WORLD_SIZE")
        process_id = _int_env("RANK") if process_id is None else process_id
        init_method = init_method or "env://"
    if coordinator_address and not init_method:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or init_method is None or process_id is None:
        if auto:
            raise RuntimeError(
                "--multihost needs a rendezvous: launch under torchrun "
                "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or set "
                "COORDINATOR_ADDRESS=host:port, NUM_PROCESSES and "
                "PROCESS_ID on every process")
        return False
    dev = local_device(device) if device is not None else None
    if backend is None:
        backend = ("nccl" if dev is not None and dev.type == "cuda"
                   and not shares_card() else "gloo")
    kwargs = {}
    if backend == "nccl" and dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(process_id),
                            world_size=int(num_processes),
                            timeout=collective_timeout(), **kwargs)
    return dist.get_world_size() > 1


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


_this_process = process_index


def host_feed_info(sizes: tuple, rows: int, *, process_of_device=None,
                   process_index: Optional[int] = None):
    """Which batch-row slice this process must load: ``(feed_rank,
    feed_world)`` (the JAX ``host_feed_info`` for the batch spec
    ``(data x fsdp, sequence)``).

    The mesh's devices ``0 .. prod(sizes) - 1`` lie row-major over
    ``MESH_AXES``; a device's rows are block ``data_coord * fsdp +
    fsdp_coord`` of ``rows`` (every other axis replicates them: the ranks
    along ``sequence``, ``tensor``, ``expert`` and ``stage`` load
    identical rows).
    Processes whose devices cover the same rows form one feed group and
    load the same rows; groups are ranked by their first row.
    ``process_of_device`` maps a device id to its process (default: one
    device a process) and ``process_index`` names the asking process
    (default: this one); both are injectable for tests. Raises when the
    processes' row coverages do not form an ordered equal-size partition
    of the rows."""
    n_dev = math.prod(sizes)
    pod = process_of_device or (lambda d: d)
    pidx = _this_process() if process_index is None else process_index
    dp = dp_size(sizes)
    per = rows // dp
    inner = n_dev // dp   # devices a data shard: the axes after fsdp
    cover = {}
    for dev in range(n_dev):
        block = dev // inner
        cover.setdefault(pod(dev), set()).add((block * per,
                                               (block + 1) * per))

    def span(ranges):
        rs = sorted(ranges)
        lo, hi = rs[0]
        for a, b in rs[1:]:
            if a > hi:
                raise ValueError(
                    f"host row coverage {rs} is not contiguous — this mesh "
                    f"device layout interleaves data shards within a host; "
                    f"no consistent data feeding order exists")
            hi = max(hi, b)
        return lo, hi

    spans = {p: span(r) for p, r in cover.items()}
    groups = sorted(set(spans.values()))
    size = groups[0][1] - groups[0][0]
    for g, (lo, hi) in enumerate(groups):
        if lo != g * size or hi - lo != size:
            raise ValueError(
                f"host row spans {groups} do not partition {rows} rows "
                f"into equal ordered slices; no consistent data feeding "
                f"order exists for this mesh layout")
    if pidx not in spans:
        raise ValueError(f"process {pidx} holds no addressable batch rows")
    return groups.index(spans[pidx]), len(groups)


def barrier(name: str = "barrier") -> None:
    """Cross-process barrier (the reference's ``dist.barrier()``)."""
    if process_count() > 1:
        dist.barrier()


def global_any(flag: bool) -> bool:
    """True on every process iff ``flag`` is True on any process."""
    if process_count() <= 1:
        return flag
    votes = [None] * process_count()
    dist.all_gather_object(votes, bool(flag))
    return any(votes)


def broadcast_from_host0(obj):
    """Process 0's (picklable) value on every process (the reference's
    ``dist.broadcast_object_list``)."""
    if process_count() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown_distributed() -> None:
    """Best-effort exit from the process group; failures are swallowed
    (the process is exiting either way)."""
    try:
        if _live():
            dist.destroy_process_group()
    except Exception:
        pass
