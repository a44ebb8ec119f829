"""Cross-process serving replicas (port of ``tpu_trainer/serving/remote.py``):
the wire protocol, the ``KVB1`` KV-block codec, the remote replica
adapter and the worker-process supervisor. ``serving/worker.py`` is the
other half: one ``ServingEngine`` per OS process behind the RPC loop.

**Frames** — length-prefixed JSON over a socket::

    +----------------+---------------------------+
    | 4 bytes        | <len> bytes               |
    | big-endian len | UTF-8 JSON payload        |
    +----------------+---------------------------+

The length's high bit marks a BINARY frame (raw bytes, no JSON): the
KV-block transport. A binary frame only ever follows a JSON frame that
announced it, so the two kinds never have to be told apart blind. A torn
or oversized frame is a ``FrameError``: the connection is poisoned and
closed, never the process.

**KV blocks** — one block entry (``ServingEngine.read_block``) as a
self-describing payload::

    +-------+---------+--- per leaf, n_leaves times ------------------+
    | magic | n_leaves| dtype_len | dtype | ndim | dims... | raw_len  |
    | KVB1  | u16     | u8        | ascii | u8   | u32 each| u32 + raw|
    +-------+---------+-----------------------------------------------+

The bytes are the JAX package's for the same leaves. A bf16 leaf is a
numpy void array of its raw 2-byte words (numpy has no bfloat16); its
tag is ``<V2``, the tag that ``ml_dtypes.bfloat16`` writes, and it
decodes to void ``V2`` on either side. The raw bytes ARE the device
values, so a round trip is bitwise for f32, bf16 and int8 alike.

**RPC** — requests are ``{"id", "method", ...params}``; responses are
``{"id", "ok": true, "result"}`` or ``{"id", "ok": false, "error":
{"type", "msg"}}``. A JSON frame may announce ``nframes`` binary frames
that follow it (KV blocks for ``kv_put`` / ``kv_get`` and migration
tails). A torn frame makes the worker close that connection and keep
accepting; the client marks the replica dead (``ReplicaDied``).

**Why the front-end's cached load snapshot is exact**: the worker is a
pure RPC reactor, its engine moves only inside a handler, so the
``load`` dict on every response (queue depth, outstanding tokens, the
oldest waiting ARRIVAL time; the wait age is computed against the
front-end clock) holds until the front-end's own next RPC. Routing and
admission read it without extra round trips.

**Failover state lives on the front-end side**: ``RemoteReplica`` keeps
the caller's ``Request`` objects as mirrors and applies the worker's
per-step token deltas to them, so the objects submitted are the objects
that come back finished; when a worker dies the mirrors ARE the export,
reset as ``Scheduler.export_requests`` resets them, and sampling keyed
by (seed, token index) makes the stream resumed on a survivor the
undisturbed one. Tokens a worker made but never reported are made again.

``WorkerSupervisor`` launches ``python -m tpu_trainer_torch.serving.worker``
processes and watches them as the elastic trainer watches hosts: an exit
code (``proc.poll()``) or a heartbeat that flatlined
(``utils/flight_recorder``). A timed-out or poisoned call FENCES the
worker (SIGKILL) before its requests move, so a paused process can never
wake up and serve them twice. Engine kwargs cross the wire as JSON
scalars: ``{"device": "cpu"}`` puts a worker's engine on the CPU, and
without it the engine runs on the card or the worker exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from tpu_trainer_torch.serving.scheduler import Request, SamplingParams
from tpu_trainer_torch.utils.flight_recorder import read_heartbeat

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_HEADER = struct.Struct(">I")
MAX_FRAME_BYTES = 1 << 26   # 64 MiB: a garbage length prefix must not OOM us
_BINARY_BIT = 0x8000_0000
# A JSON frame may announce at most this many attached binary frames: a
# garbage ``nframes`` must not make the reactor read forever.
MAX_ATTACHED_FRAMES = 64


class FrameError(Exception):
    """Torn, oversized, or non-JSON frame — the connection is poisoned
    and must be closed (the stream has no way to resynchronise)."""


class ReplicaDied(RuntimeError):
    """The worker behind a ``RemoteReplica`` is unreachable (killed,
    exited, hung past its deadline, or sent a poisoned frame)."""


# -- framing ---------------------------------------------------------------


def encode_frame(obj) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame of {len(body)} bytes exceeds max")
    return _HEADER.pack(len(body)) + body


def _recv_exact(sock: socket.socket, n: int, *, start: bytes = b"") -> bytes:
    buf = start
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise FrameError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket):
    """Read one frame. Returns the decoded object, or None on a CLEAN
    EOF (peer closed between frames). Raises ``FrameError`` on a torn
    header/body, a length outside (0, MAX], or a non-JSON payload."""
    first = sock.recv(_HEADER.size)
    if not first:
        return None                     # clean close between frames
    hdr = _recv_exact(sock, _HEADER.size, start=first)
    (length,) = _HEADER.unpack(hdr)
    if length == 0 or length > MAX_FRAME_BYTES:
        raise FrameError(f"bad frame length {length}")
    body = _recv_exact(sock, length)
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable frame body: {e}") from e


def send_frame(sock: socket.socket, obj) -> None:
    sock.sendall(encode_frame(obj))


def send_binary_frame(sock: socket.socket, payload: bytes) -> None:
    if not payload or len(payload) > MAX_FRAME_BYTES:
        raise FrameError(f"binary frame of {len(payload)} bytes out of range")
    sock.sendall(_HEADER.pack(len(payload) | _BINARY_BIT) + payload)


def recv_binary_frame(sock: socket.socket) -> bytes:
    """Read one binary frame (announced by the preceding JSON frame).
    Raises ``FrameError`` on a torn header/body, a JSON frame where
    binary was promised, or a length outside (0, MAX]."""
    hdr = _recv_exact(sock, _HEADER.size)
    (length,) = _HEADER.unpack(hdr)
    if not (length & _BINARY_BIT):
        raise FrameError("expected a binary frame, got a JSON length")
    n = length & ~_BINARY_BIT
    if n == 0 or n > MAX_FRAME_BYTES:
        raise FrameError(f"bad binary frame length {n}")
    return _recv_exact(sock, n)


# -- KV block wire codec ---------------------------------------------------

KV_MAGIC = b"KVB1"
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")


def _dtype_tag(dtype: np.dtype) -> bytes:
    """The leaf's dtype as the JAX package writes it (``dtype.str``),
    except that a plain void leaf — a bf16 leaf's raw words — is tagged
    ``<V{n}`` as ``ml_dtypes`` tags its types, not numpy's ``|V{n}``."""
    if dtype.kind == "V" and dtype.fields is None:
        return f"<V{dtype.itemsize}".encode("ascii")
    return dtype.str.encode("ascii")


def encode_kv_block(leaves) -> bytes:
    parts = [KV_MAGIC, _U16.pack(len(leaves))]
    for a in leaves:
        a = np.ascontiguousarray(a)
        dt = _dtype_tag(a.dtype)
        raw = a.tobytes()
        parts.append(_U8.pack(len(dt)))
        parts.append(dt)
        parts.append(_U8.pack(a.ndim))
        parts.append(struct.pack(f">{a.ndim}I", *a.shape))
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    body = b"".join(parts)
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"kv block of {len(body)} bytes exceeds max frame")
    return body


def decode_kv_block(buf: bytes):
    """Inverse of ``encode_kv_block``. Raises ``FrameError`` on any
    inconsistency (bad magic, torn header, length/shape mismatch,
    trailing garbage)."""
    view = memoryview(buf)
    pos = 0

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(view):
            raise FrameError(
                f"kv block truncated at byte {pos} (+{n}/{len(view)})")
        out = view[pos:pos + n]
        pos += n
        return out

    if bytes(take(len(KV_MAGIC))) != KV_MAGIC:
        raise FrameError("kv block: bad magic")
    (n_leaves,) = _U16.unpack(take(_U16.size))
    leaves = []
    for _ in range(n_leaves):
        (dt_len,) = _U8.unpack(take(_U8.size))
        try:
            dtype = np.dtype(bytes(take(dt_len)).decode("ascii"))
        except (UnicodeDecodeError, TypeError) as e:
            raise FrameError(f"kv block: bad dtype: {e}") from e
        (ndim,) = _U8.unpack(take(_U8.size))
        shape = struct.unpack(f">{ndim}I", take(4 * ndim))
        (raw_len,) = _U32.unpack(take(_U32.size))
        want = int(dtype.itemsize) * int(np.prod(shape, dtype=np.int64))
        if raw_len != want:
            raise FrameError(
                f"kv block: leaf {dtype}{shape} wants {want} bytes, "
                f"frame carries {raw_len}")
        leaves.append(
            np.frombuffer(take(raw_len), dtype=dtype).reshape(shape).copy())
    if pos != len(view):
        raise FrameError(f"kv block: {len(view) - pos} trailing bytes")
    return leaves


# -- RPC -------------------------------------------------------------------


def rpc(sock: socket.socket, req_id: int, method: str, params: dict,
        frames=None):
    """One blocking request/response exchange. Raises ``ReplicaDied``
    when the peer is gone or the stream is poisoned, and re-raises
    worker-side ``ValueError`` as ``ValueError`` (so e.g. a
    too-long-prompt reject behaves exactly like the in-process
    ``Scheduler.add``)."""
    msg = dict(params)
    msg["id"] = req_id
    msg["method"] = method
    if frames:
        msg["nframes"] = len(frames)
    try:
        send_frame(sock, msg)
        for fr in frames or ():
            send_binary_frame(sock, fr)
        resp = recv_frame(sock)
        nresp = int(resp.get("nframes", 0)) if resp else 0
        if nresp < 0 or nresp > MAX_ATTACHED_FRAMES:
            raise FrameError(f"response announces {nresp} binary frames")
        attached = [recv_binary_frame(sock) for _ in range(nresp)]
    except (OSError, FrameError) as e:
        raise ReplicaDied(f"rpc {method!r} failed: {e}") from e
    if resp is None:
        raise ReplicaDied(f"connection closed during rpc {method!r}")
    if resp.get("id") != req_id:
        raise ReplicaDied(
            f"rpc {method!r}: response id {resp.get('id')} != {req_id}")
    if not resp.get("ok"):
        err = resp.get("error") or {}
        if err.get("type") == "ValueError":
            raise ValueError(err.get("msg", "worker ValueError"))
        raise ReplicaDied(f"rpc {method!r}: worker error {err}")
    result = resp.get("result") or {}
    if attached:
        result["_frames"] = attached
    return result


# -- Request wire codec ----------------------------------------------------

# Runtime fields synced by ``request_apply_wire`` (everything that can
# change after construction; identity fields rid/prompt/... stay put).
_RUNTIME_FIELDS = (
    "status", "slot", "preemptions", "first_token_at", "finished_at",
    "admitted_at",
    "prefill_cursor", "prefill_target", "prefill_chunk",
    "prefix_hit_tokens", "spec_drafted", "spec_accepted", "spec_steps",
)


def request_to_wire(req: Request) -> dict:
    """Lossless JSON form of a ``Request`` — sampling state (incl.
    ``top_p``), generated tokens, timestamps, cursors, and the
    prefix-index registration watermark all cross the wire, so a
    failover re-submit on the far side resumes exactly where the
    original stood (the preemption-resume contract, now cross-process)."""
    d = {
        "rid": int(req.rid),
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "sampling": dataclasses.asdict(req.sampling),
        "arrival_time": float(req.arrival_time),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "deadline": None if req.deadline is None else float(req.deadline),
        "generated": [int(t) for t in req.generated],
        "token_times": [float(t) for t in req.token_times],
        "blocks_registered": int(req._blocks_registered),
    }
    if req._prompt_digests is not None:
        # Hash-once, fleet-wide: the chained block digests computed at
        # submit cross the wire so the worker's admission (and a later
        # migration) never re-hashes the prompt.
        d["prompt_digests"] = [dg.hex() for dg in req._prompt_digests]
    for f in _RUNTIME_FIELDS:
        d[f] = getattr(req, f)
    return d


def request_from_wire(d: dict) -> Request:
    req = Request(
        rid=int(d["rid"]),
        prompt=list(d["prompt"]),
        max_new_tokens=int(d["max_new_tokens"]),
        sampling=SamplingParams(**d["sampling"]),
        arrival_time=float(d["arrival_time"]),
        eos_id=d.get("eos_id"),
        deadline=d.get("deadline"),
    )
    req.generated = list(d.get("generated", ()))
    req.token_times = list(d.get("token_times", ()))
    req._blocks_registered = int(d.get("blocks_registered", 0))
    request_apply_wire(req, d)
    return req


def request_apply_wire(req: Request, d: dict) -> None:
    """Sync a local mirror's runtime state from a wire dict (used when a
    live worker exports: the worker's view is authoritative)."""
    req.generated = list(d.get("generated", req.generated))
    req.token_times = list(d.get("token_times", req.token_times))
    if d.get("prompt_digests") is not None:
        req._prompt_digests = [
            bytes.fromhex(h) for h in d["prompt_digests"]]
    for f in _RUNTIME_FIELDS:
        if f in d:
            setattr(req, f, d[f])


# -- params transport ------------------------------------------------------


def save_params_npz(path: str, params) -> None:
    """Flatten a (possibly nested-Mapping) param tree to ``a/b/c`` keys
    and save as one npz (atomic via tmp + replace): the file the JAX
    package's ``load_params_npz`` and ``models.weights.load_params_npz``
    read."""
    flat: Dict[str, "np.ndarray"] = {}

    def walk(node, prefix):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _param_nbytes(params) -> int:
    """Logical byte size of a (possibly nested-Mapping) param tree — the
    per-worker wire cost a full-copy (non-sharded) launch pays."""
    total = 0

    def walk(node):
        nonlocal total
        if hasattr(node, "items"):
            for v in node.values():
                walk(v)
        else:
            total += int(np.asarray(node).nbytes)

    walk(params)
    return total


# -- transport fault shim (the net_* chaos kinds, utils/faults.py) ---------

NET_DELAY_MS_ENV = "TPU_TRAINER_NET_DELAY_MS"


def _inject_net_fault(kind: str, sock: socket.socket) -> None:
    """Apply one armed fault to the framed transport, in place of (or
    before) the next exchange. ``net_delay`` just adds latency and lets
    the call proceed; the other kinds sabotage the stream the way a real
    network does and raise ``ReplicaDied`` so the caller takes the exact
    failover path an organic transport failure takes."""
    if kind == "net_delay":
        time.sleep(float(os.environ.get(NET_DELAY_MS_ENV, "50")) / 1e3)
        return
    if kind == "net_garble":
        # A correctly-framed body that is not UTF-8: the worker's
        # recv_frame raises FrameError, drops ONLY that connection, and
        # goes back to accept; our read then sees the close.
        try:
            sock.sendall(_HEADER.pack(16) + b"\xff" * 16)
            sock.recv(1)
        except OSError:
            pass
        raise ReplicaDied("injected net_garble: stream poisoned")
    if kind == "net_drop":
        # Torn frame: promise a body, deliver nothing, close. The peer
        # sees EOF mid-frame (FrameError) and drops the connection.
        try:
            sock.sendall(_HEADER.pack(64))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        raise ReplicaDied("injected net_drop: frame torn mid-send")
    if kind == "net_hang":
        # Dead air: nothing sent, nothing will arrive — the per-call
        # timeout is the only way out (the hung-RPC fence drill without
        # needing to SIGSTOP anything).
        try:
            sock.recv(1)
        except OSError as e:            # socket.timeout is an OSError
            raise ReplicaDied(f"injected net_hang: {e}") from e
        raise ReplicaDied("injected net_hang: unexpected data")
    raise ValueError(f"unknown net fault kind {kind!r}")


# -- the remote replica adapter --------------------------------------------


@dataclasses.dataclass
class WorkerHandle:
    """One spawned worker process plus its control connection."""

    worker_id: int
    proc: object                        # subprocess.Popen (duck-typed in tests)
    sock: Optional[socket.socket]
    log_path: str = ""
    block_size: int = 0
    pid: int = 0
    rid: Optional[int] = None           # front-end replica id, once assigned
    retired: bool = False               # deliberately shut down, not a death
    next_id: int = 0
    # Per-call socket deadlines: every call before the first completed
    # ``step`` may sit behind the worker's engine build (weights to the
    # card, the kernel library loaded) or its first step, so it gets the
    # start-up budget; once a step response
    # has arrived the worker is warm and every later call gets the small
    # per-call timeout — a hung worker then stalls the caller for at most
    # ``rpc_timeout_s``, not 600 s.
    rpc_timeout_s: float = 30.0
    first_call_timeout_s: float = 600.0
    first_step_done: bool = False
    # One-shot armed transport fault (a net_* kind) for the next rpc().
    net_fault: Optional[str] = None

    def rpc(self, method: str, params: Optional[dict] = None, frames=None):
        if self.sock is None:
            raise ReplicaDied(f"worker {self.worker_id}: no connection")
        self.next_id += 1
        timeout = (self.rpc_timeout_s if self.first_step_done
                   else self.first_call_timeout_s)
        try:
            self.sock.settimeout(timeout)
        except OSError as e:
            raise ReplicaDied(
                f"worker {self.worker_id}: socket unusable: {e}") from e
        fault, self.net_fault = self.net_fault, None
        if fault is not None:
            _inject_net_fault(fault, self.sock)
        result = rpc(self.sock, self.next_id, method, params or {},
                     frames=frames)
        if method == "step":
            self.first_step_done = True
        return result

    def close(self, *, grace_s: float = 5.0) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            self.proc.wait(timeout=grace_s)
        except Exception:
            self.proc.kill()
            try:
                self.proc.wait(timeout=grace_s)
            except Exception:
                pass


class RemoteReplica:
    """Drop-in for an in-process replica (``frontend.LocalReplica``):
    same surface, state mutated only by our own RPCs — see the module
    docstring for why the cached ``load`` snapshot is exact."""

    def __init__(self, handle: WorkerHandle, clock: Callable[[], float], *,
                 supervisor: Optional["WorkerSupervisor"] = None):
        self._handle = handle
        self.clock = clock
        self._supervisor = supervisor
        self.dead = False
        self.block_size = handle.block_size
        self._reqs: Dict[int, Request] = {}     # unfinished mirrors
        # Worker-side span events carried home on RPC replies, buffered
        # until the front-end's next drain_span_events() merge.
        self._span_pending: List[dict] = []
        self._load: Dict[str, object] = {
            "queue_depth": 0, "outstanding_tokens": 0, "has_work": False,
            "oldest_arrival": None, "generated_tokens": 0,
            "prefix_hit_tokens": 0, "prompt_tokens": 0, "n_preemptions": 0,
        }
        # Store digests the worker reported as newly put (piggybacked on
        # load snapshots), buffered for the front-end's catalog drain.
        self._kv_new: List[bytes] = []

    @property
    def worker_id(self) -> int:
        return self._handle.worker_id

    @property
    def worker_pid(self) -> int:
        return self._handle.pid

    def _rpc(self, method: str, params: Optional[dict] = None, frames=None):
        if self.dead:
            raise ReplicaDied(
                f"worker {self._handle.worker_id} is already dead")
        try:
            result = self._handle.rpc(method, params, frames=frames)
        except ReplicaDied:
            # The hung-RPC fence: a timed-out or poisoned exchange makes
            # this replica SUSPECT — maybe dead, maybe wedged, maybe
            # about to answer late. The supervisor kills the process so
            # the state is unambiguous BEFORE the caller re-runs the
            # mirrors elsewhere (a wedged worker waking up later and
            # double-generating is the failure this prevents); the
            # raise then rides the exact replica_kill failover path.
            self.dead = True
            if self._supervisor is not None:
                self._supervisor.fence(self._handle)
            raise
        load = result.get("load")
        if load is not None:
            self._load = load
            for h in load.get("kv_new") or ():
                self._kv_new.append(bytes.fromhex(h))
        # Every reply may piggyback the worker tracer's event delta —
        # one wire, no extra round-trips (worker.py drains per handler).
        trace = result.get("trace")
        if trace:
            self._span_pending.extend(trace)
        return result

    def drain_span_events(self) -> List[dict]:
        """Worker span events accumulated off RPC replies since the last
        drain — the delta surface ``frontend.LocalReplica`` exposes from
        its engine tracer, so the front-end merges both transports
        identically. Timestamps are already front-end times (the worker
        clock is the shipped ``now`` with a zero epoch)."""
        out, self._span_pending = self._span_pending, []
        return out

    # -- the replica surface the front-end consumes ------------------------

    def submit(self, req: Request, trace: Optional[List[dict]] = None,
               migration: Optional[dict] = None) -> None:
        params = {"req": request_to_wire(req), "now": self.clock()}
        if trace:
            # Front-door span context (submitted/routed) travels with the
            # request so the worker tracer holds the rid's full timeline.
            params["trace"] = trace
        frames = None
        if migration is not None:
            # Migrated admission: the raw prompt tail (the last partial
            # block, exact K/V bytes) rides a binary frame; full blocks
            # travel separately as digest-addressed kv_put frames.
            params["mig"] = {"tail_ntok": int(migration.get("tail_ntok", 0))}
            if migration.get("leaves") is not None:
                frames = [encode_kv_block(migration["leaves"])]
        self._rpc("submit", params, frames=frames)
        self._reqs[req.rid] = req

    def step(self) -> List[Request]:
        """One frontend-driven engine step on the worker. Ships the
        front-end clock (``now``) — the worker NEVER free-runs a wall
        clock, so one clock domain spans the fleet and ``steps`` mode is
        deterministic cross-process. Token deltas are applied to the
        caller's own ``Request`` objects."""
        result = self._rpc("step", {"now": self.clock()})
        finished: List[Request] = []
        for d in result.get("deltas", ()):
            req = self._reqs.get(d["rid"])
            if req is None:
                continue
            self._apply_delta(req, d)
            if d["done"]:
                finished.append(self._reqs.pop(d["rid"]))
        return finished

    def _apply_delta(self, req: Request, d: dict) -> None:
        req.generated.extend(d["gen"])
        req.token_times.extend(d["times"])
        req.first_token_at = d["first"]
        req.preemptions = d["preempt"]
        req.prefix_hit_tokens = d["hit"]
        req.spec_drafted, req.spec_accepted, req.spec_steps = d["spec"]
        req.status = d["status"]
        if d["done"]:
            req.finished_at = d["finished_at"]

    def cancel(self, rid: int) -> bool:
        """Cancel on the worker: its engine frees the request's slot and
        blocks before the response is framed, the terminal delta lands
        on the mirror HERE, and the rid never appears in a later step
        delta — so in-process and RPC replicas retire identically."""
        if rid not in self._reqs:
            return False
        result = self._rpc("cancel", {"rid": rid, "now": self.clock()})
        if not result.get("cancelled"):
            return False
        req = self._reqs.pop(rid)
        d = result.get("delta")
        if d:
            self._apply_delta(req, d)
        else:
            req.status = "cancelled"
        return True

    def inject_net_fault(self, kind: str) -> None:
        """Arm a one-shot transport fault (a ``net_*`` chaos kind) on
        this replica's next RPC."""
        self._handle.net_fault = kind

    # -- KV store / disaggregation verbs -----------------------------------

    def kv_put(self, digest: bytes, leaves) -> bool:
        """Push one block entry into the worker's local store (binary
        frame attached to the JSON verb). Idempotent like the store."""
        result = self._rpc("kv_put", {"digest": digest.hex()},
                           frames=[encode_kv_block(leaves)])
        return bool(result.get("stored"))

    def kv_get(self, digest: bytes):
        """``(tier, leaves)`` from the worker's store, or None."""
        result = self._rpc("kv_get", {"digest": digest.hex()})
        if not result.get("found"):
            return None
        return result["tier"], decode_kv_block(result["_frames"][0])

    def kv_has(self, digests) -> List[bool]:
        result = self._rpc("kv_has",
                           {"digests": [d.hex() for d in digests]})
        return [bool(b) for b in result.get("has", ())]

    def set_role(self, role: Optional[str]) -> None:
        self._rpc("set_role", {"role": role})

    def migratable_rids(self) -> List[int]:
        """Prefill-complete rids from the worker's last load snapshot —
        exact between our own RPCs, like every other load field."""
        return [int(r) for r in self._load.get("migratable") or ()]

    def drain_new_digests(self) -> List[bytes]:
        out, self._kv_new = self._kv_new, []
        return out

    def extract(self, rid: int):
        """Pull one prefill-complete request off the worker for
        migration: the worker vacates it (slot + blocks freed, full
        blocks already in its store via write-through) and ships the
        authoritative request state plus the raw prompt-tail block.
        Returns ``(req, payload)`` or None; the mirror is popped — the
        request now belongs to whichever replica it is resubmitted to."""
        result = self._rpc("extract", {"rid": rid, "now": self.clock()})
        if not result.get("found"):
            return None
        d = result["req"]
        req = self._reqs.pop(rid, None)
        if req is None:
            req = request_from_wire(d)
        else:
            request_apply_wire(req, d)
        payload = {"tail_ntok": int(result.get("tail_ntok", 0)),
                   "leaves": None}
        if payload["tail_ntok"] and result.get("_frames"):
            payload["leaves"] = decode_kv_block(result["_frames"][0])
        return req, payload

    def has_work(self) -> bool:
        return bool(self._load["has_work"])

    @property
    def queue_depth(self) -> int:
        return int(self._load["queue_depth"])

    @property
    def outstanding_tokens(self) -> int:
        return int(self._load["outstanding_tokens"])

    def oldest_wait_age(self, now: float) -> float:
        arr = self._load.get("oldest_arrival")
        if arr is None:
            return 0.0
        return max(0.0, now - float(arr))

    def export_requests(self, *, waiting_only: bool = False) -> List[Request]:
        """Drain requeueable requests. Live worker: the worker's export
        is authoritative (preemption counts etc. sync onto the
        mirrors). Dead worker: the mirrors are the export, reset to the
        exact ``Scheduler.export_requests`` contract — this is the
        SIGKILL failover path."""
        if not self.dead:
            try:
                result = self._rpc("export", {"waiting_only": waiting_only})
                out: List[Request] = []
                for d in result.get("requests", ()):
                    req = self._reqs.pop(d["rid"], None)
                    if req is None:        # shouldn't happen; keep honest
                        req = request_from_wire(d)
                    else:
                        request_apply_wire(req, d)
                    out.append(req)
                return out
            except ReplicaDied:
                pass
        out = []
        for req in self._reqs.values():
            req.status = "waiting"
            req.slot = None
            req.prefill_cursor = 0
            req.prefill_target = 0
            req.prefill_chunk = 0
            out.append(req)
        self._reqs.clear()
        return sorted(out, key=lambda r: (r.arrival_time, r.rid))

    def metrics_snapshot(self) -> dict:
        """Pull the worker engine's registry snapshot over the
        ``metrics`` verb — plain JSON scalars, callbacks already
        resolved worker-side. The front-end merges it label-wise
        (``replica=N``) into its own registry. MAIN-thread only, like
        every RPC here: the scrape thread must never touch the
        socket."""
        return self._rpc("metrics").get("metrics", {})

    def release(self) -> None:
        """Tear the worker down (graceful shutdown RPC when reachable,
        then reap the process). A deliberate release is marked retired
        so the supervisor does not report it as a death."""
        self._handle.retired = True
        if not self.dead:
            try:
                self._rpc("shutdown")
            except (ReplicaDied, ValueError):
                pass
            self.dead = True
        self._handle.close()

    # -- counters mirrored for fleet telemetry -----------------------------

    @property
    def generated_tokens(self) -> int:
        return int(self._load["generated_tokens"])

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._load["prefix_hit_tokens"])

    @property
    def prompt_tokens(self) -> int:
        return int(self._load["prompt_tokens"])

    @property
    def n_preemptions(self) -> int:
        return int(self._load["n_preemptions"])

    @property
    def store_hit_tokens_host(self) -> int:
        return int(self._load.get("store_hit_tokens_host", 0))

    @property
    def store_hit_tokens_disk(self) -> int:
        return int(self._load.get("store_hit_tokens_disk", 0))


# -- supervision -----------------------------------------------------------

# The worker beats its heartbeat on every RPC-loop wakeup (0.5 s select
# timeout; writes throttled to 0.2 s), so a healthy worker's beat stream
# never gaps past ~1 s while it is idle or reachable. A worker is only
# ever busy inside an RPC handler the front-end is itself blocked on —
# the supervisor cannot be polling a worker mid-build — so 20x the
# wakeup cadence is far past any legitimate gap while still fencing a
# wedged-but-alive worker out of the box (the SIGSTOP failure mode exit
# codes can never catch).
_WORKER_LOOP_WAKEUP_S = 0.5
DEFAULT_HEARTBEAT_TIMEOUT_S = 20 * _WORKER_LOOP_WAKEUP_S
# Sentinel: "derive the default" (None must stay a meaningful value —
# the explicit detection opt-out).
_AUTO = "auto"


class WorkerSupervisor:
    """Launches and watches worker processes; IS the front-end's
    ``replica_factory`` (callable ``(rid, clock) -> RemoteReplica``).

    Death detection mirrors ``training/elastic.py``: a worker is dead
    when its process exited (``proc.poll()`` — a SIGKILL shows up here
    by exit code) or when its heartbeat file has flatlined for longer
    than ``heartbeat_timeout_s`` (a wedged-but-alive process; the
    supervisor SIGKILLs it on detection so the state is unambiguous).
    ``poll_deaths`` reports each death exactly once; the front-end turns
    each report into its existing ``kill_replica`` failover.

    ``reset()`` implements warm A/B benching: every live worker rebuilds
    a fresh engine in place (the process, its imports and its loaded
    kernels are kept) and returns to the spawn pool — the next front-end
    built over this supervisor adopts warm processes with clean serving
    state.

    ``params`` is the port's state dict; it crosses to the workers as
    the ``a/b/c``-key npz (or, with ``param_shard_world``, as that many
    host shards). ``device_sets`` gives each worker a tensor-parallel
    mesh: worker ``wid`` takes ``device_sets[wid % len]`` (CUDA ordinals,
    repeatable) as its engine's ``mesh_devices``.
    """

    def __init__(self, params, config, *, engine_kwargs=None,
                 run_dir: Optional[str] = None,
                 heartbeat_timeout_s=_AUTO,
                 connect_timeout_s: float = 240.0,
                 rpc_timeout_s: float = 30.0,
                 first_step_timeout_s: float = 600.0,
                 tcp: bool = False,
                 param_shard_world: Optional[int] = None,
                 device_sets=None,
                 launch_prefix=None):
        if heartbeat_timeout_s == _AUTO:
            heartbeat_timeout_s = DEFAULT_HEARTBEAT_TIMEOUT_S
        # None = explicit opt-out of flatline detection (exit codes only).
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.first_step_timeout_s = float(first_step_timeout_s)
        self.n_fenced = 0
        self.tcp = tcp
        if run_dir is None or len(run_dir) > 70:
            # unix socket paths are capped near 108 bytes — keep ours short
            run_dir = tempfile.mkdtemp(prefix="tt-workers-")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.heartbeat_dir = os.path.join(run_dir, "hb")
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        self._params_path = os.path.join(run_dir, "params.npz")
        self._shards_path = os.path.join(run_dir, "param_shards")
        self._spec_path = os.path.join(run_dir, "spec.json")
        # Shard-streaming launch (``param_shard_world``): instead of one
        # full npz every worker re-reads, the tree is written ONCE as a
        # ``world``-way host_shards export (utils/checkpoint.py) — the
        # per-worker shard file is ~P/world bytes, which is what crosses
        # the wire to a remote host (via the existing TCP transport +
        # ``launch_prefix``); on a shared filesystem the worker stitches
        # all shard files back locally. ``param_bytes_full`` /
        # ``param_shard_bytes`` expose the two wire costs for bench
        # records.
        self.launch_prefix = list(launch_prefix or [])
        self.param_shard_world = (
            int(param_shard_world) if param_shard_world else None)
        self.param_bytes_full = 0
        self.param_shard_bytes: Optional[List[int]] = None
        params_shards = None
        if params is not None:
            # The port's state dict as the nested Flax tree the npz keys.
            from tpu_trainer_torch.models.weights import to_jax_params

            params = to_jax_params(params)
        if params is not None and self.param_shard_world:
            from tpu_trainer_torch.utils.checkpoint import export_param_shards

            export_param_shards(
                params, self._shards_path, world=self.param_shard_world)
            params_shards = self._shards_path
            sdir = os.path.join(self._shards_path, "shards")
            self.param_shard_bytes = [
                os.path.getsize(os.path.join(sdir, f"host{h:05d}.npz"))
                for h in range(self.param_shard_world)]
            self.param_bytes_full = _param_nbytes(params)
        elif params is not None:
            save_params_npz(self._params_path, params)
            self.param_bytes_full = os.path.getsize(self._params_path)
        # Sampling is keyed by (seed, token index) alone
        # (``serving/sampling.py``), so a worker needs no PRNG setting
        # from this process for its sampled streams to be ours.
        spec = {
            "config": dataclasses.asdict(config) if config is not None else {},
            "engine": dict(engine_kwargs or {}),
            "params_npz": self._params_path,
        }
        if params_shards is not None:
            spec["params_shards"] = params_shards
        if device_sets is not None:
            # Per-worker device sets (one mesh a worker): worker ``wid``
            # takes ``device_sets[wid % len]`` as its ``mesh_devices``.
            # Top-level in the spec: engine kwargs are scalars on the wire.
            spec["device_sets"] = [
                [int(d) for d in ds] for ds in device_sets]
        for k, v in spec["engine"].items():
            if not isinstance(v, (int, float, str, bool, type(None))):
                raise ValueError(
                    f"engine kwarg {k!r} is not wire-able: {type(v)}")
        with open(self._spec_path, "w") as f:
            json.dump(spec, f)
        self._handles: Dict[int, WorkerHandle] = {}   # by front-end rid
        self._pool: List[WorkerHandle] = []           # warm, unassigned
        self._spawned = 0
        self._reported_dead: set = set()

    # -- factory surface ---------------------------------------------------

    def __call__(self, rid: int, clock: Callable[[], float]) -> RemoteReplica:
        handle = self._pool.pop(0) if self._pool else self._spawn()
        handle.rid = rid
        self._handles[rid] = handle
        return RemoteReplica(handle, clock, supervisor=self)

    # kept as an explicit alias so call sites can say what they mean
    def replica_factory(self, rid: int, clock) -> RemoteReplica:
        return self(rid, clock)

    def prewarm(self, n: int) -> None:
        """Spawn ``n`` workers CONCURRENTLY into the pool: all processes
        launch first (their torch imports and engine builds overlap), then
        each is connected and handshaken. The front-end's sequential
        ``replica_factory`` calls then adopt warm workers, so fleet
        startup costs ~one worker build instead of N."""
        launched = [self._launch() for _ in range(n)]
        for wid, proc, log_path in launched:
            self._pool.append(self._handshake(wid, proc, log_path))

    def _spawn(self) -> WorkerHandle:
        return self._handshake(*self._launch())

    def _launch(self):
        wid = self._spawned
        self._spawned += 1
        log_path = os.path.join(self.run_dir, f"worker{wid}.log")
        cmd = [sys.executable, "-m", "tpu_trainer_torch.serving.worker",
               "--spec", self._spec_path,
               "--heartbeat-dir", self.heartbeat_dir,
               "--worker-id", str(wid)]
        if self.tcp:
            cmd += ["--tcp", "127.0.0.1:0", "--addr-file",
                    os.path.join(self.run_dir, f"worker{wid}.addr")]
        else:
            cmd += ["--socket", os.path.join(self.run_dir, f"w{wid}.sock")]
        if self.launch_prefix:
            # e.g. ["ssh", "host"] (remote launch over the TCP transport
            # + a shared run_dir) or an env wrapper for the fake-device
            # CPU mesh; the worker command itself is unchanged.
            cmd = self.launch_prefix + cmd
        # The package resolves from this checkout wherever the caller's
        # working directory is.
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env)
        return wid, proc, log_path

    def _handshake(self, wid: int, proc, log_path: str) -> WorkerHandle:
        # Bounded retry with backoff — for the IDEMPOTENT handshake only.
        # A torn accept or ECONNRESET between connect and hello is a
        # transient (the worker is still coming up and still listening);
        # reconnecting and re-saying hello is always safe. Non-idempotent
        # in-flight calls (step/submit) are NEVER retried anywhere: their
        # response may have been lost AFTER the worker advanced, and a
        # replay would double-generate — those errors fence and fail
        # over instead (RemoteReplica._rpc).
        last: Optional[Exception] = None
        for attempt in range(3):
            try:
                sock = self._connect(wid, proc)
            except Exception:
                proc.kill()
                raise
            handle = WorkerHandle(
                worker_id=wid, proc=proc, sock=sock, log_path=log_path,
                rpc_timeout_s=self.rpc_timeout_s,
                first_call_timeout_s=self.first_step_timeout_s)
            try:
                hello = handle.rpc("hello")
            except ReplicaDied as e:
                last = e
                try:
                    sock.close()
                except OSError:
                    pass
                time.sleep(0.05 * (2 ** attempt))
                continue
            handle.block_size = int(hello["block_size"])
            handle.pid = int(hello["pid"])
            return handle
        proc.kill()
        raise RuntimeError(
            f"worker {wid}: handshake failed after 3 attempts "
            f"(see {log_path}): {last}")

    def _connect(self, wid: int, proc) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout_s
        addr_file = os.path.join(self.run_dir, f"worker{wid}.addr")
        sock_path = os.path.join(self.run_dir, f"w{wid}.sock")
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker {wid} exited rc={proc.returncode} before "
                    f"accepting (see {self.run_dir}/worker{wid}.log)")
            try:
                if self.tcp:
                    with open(addr_file) as f:
                        host, port = f.read().strip().rsplit(":", 1)
                    s = socket.create_connection((host, int(port)), timeout=5)
                else:
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(sock_path)
                # Initial budget only: WorkerHandle.rpc re-arms the
                # timeout per call (start-up budget until the first step
                # response, small per-call after — see WorkerHandle).
                s.settimeout(self.first_step_timeout_s)
                return s
            except (OSError, FileNotFoundError, ValueError):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"worker {wid}: no socket within "
                        f"{self.connect_timeout_s}s")
                time.sleep(0.05)

    # -- death detection ---------------------------------------------------

    def sigkill(self, rid: Optional[int] = None) -> int:
        """Hard-kill one worker process (the ``worker_kill`` fault).
        Target: ``TPU_TRAINER_FAULT_REPLICA`` env override, else the
        highest assigned live rid — the same convention as
        ``replica_kill``. Waits for the exit to settle so the very next
        ``poll_deaths`` reports it deterministically."""
        cands = {r: h for r, h in self._handles.items()
                 if not h.retired and h.proc.poll() is None}
        if not cands:
            raise RuntimeError("no live workers to kill")
        if rid is None:
            raw = os.environ.get("TPU_TRAINER_FAULT_REPLICA")
            rid = int(raw) if raw is not None else max(cands)
        if rid not in cands:
            raise ValueError(f"worker for replica {rid} is not alive")
        h = cands[rid]
        os.kill(h.proc.pid, signal.SIGKILL)
        try:
            h.proc.wait(timeout=10)
        except Exception:
            pass
        return rid

    def sigstop(self, rid: Optional[int] = None) -> int:
        """Freeze one worker process (the ``worker_hang`` fault):
        SIGSTOP leaves it alive — exit-code detection can never see it —
        but wedged, so its heartbeat flatlines and any RPC to it hangs
        until the per-call timeout fences it. Same targeting convention
        as ``sigkill``."""
        cands = {r: h for r, h in self._handles.items()
                 if not h.retired and h.proc.poll() is None}
        if not cands:
            raise RuntimeError("no live workers to hang")
        if rid is None:
            raw = os.environ.get("TPU_TRAINER_FAULT_REPLICA")
            rid = int(raw) if raw is not None else max(cands)
        if rid not in cands:
            raise ValueError(f"worker for replica {rid} is not alive")
        os.kill(cands[rid].proc.pid, signal.SIGSTOP)
        return rid

    def fence(self, handle: WorkerHandle) -> None:
        """Make a SUSPECT worker unambiguously dead. Called by
        ``RemoteReplica._rpc`` when an exchange times out or the stream
        poisons: the process may be wedged, half-connected, or about to
        answer late — SIGKILL (which lands on a SIGSTOPped process too)
        guarantees it can never wake up and double-generate after its
        requests have been re-run on a survivor. The death report is
        swallowed (``_reported_dead``): the caller that hit the error IS
        the failover path, so ``poll_deaths`` must not re-report it."""
        self.n_fenced += 1
        if handle.rid is not None:
            self._reported_dead.add(handle.rid)
        if handle.retired or handle.proc.poll() is not None:
            return
        try:
            handle.proc.kill()
            handle.proc.wait(timeout=10)
        except Exception:
            pass

    def poll_deaths(self) -> List[int]:
        """Replica ids whose worker died since the last poll (exit code
        OR heartbeat flatline), each reported exactly once."""
        dead: List[int] = []
        now = time.time()
        for rid, h in self._handles.items():
            if h.retired or rid in self._reported_dead:
                continue
            if h.proc.poll() is not None:
                dead.append(rid)
                continue
            if self.heartbeat_timeout_s is not None:
                beat = read_heartbeat(self.heartbeat_dir, h.worker_id)
                if beat is not None and (
                        now - float(beat.get("unix", now))
                        > self.heartbeat_timeout_s):
                    h.proc.kill()       # settle the wedged process
                    dead.append(rid)
        self._reported_dead.update(dead)
        return dead

    def live_worker_count(self) -> int:
        return sum(1 for h in list(self._handles.values()) + self._pool
                   if not h.retired and h.proc.poll() is None)

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Return every live assigned worker to the pool with a fresh
        engine (process and loaded kernels kept). Dead/retired handles are
        dropped."""
        for rid, h in list(self._handles.items()):
            if h.retired or h.proc.poll() is not None:
                continue
            try:
                h.rpc("reset")
            except (ReplicaDied, ValueError):
                h.close(grace_s=1.0)
                continue
            h.rid = None
            self._pool.append(h)
        self._handles.clear()
        self._reported_dead.clear()

    def close(self) -> None:
        for h in list(self._handles.values()) + self._pool:
            if not h.retired and h.sock is not None:
                try:
                    h.rpc("shutdown")
                except (ReplicaDied, ValueError):
                    pass
            h.retired = True
            h.close(grace_s=2.0)
        self._handles.clear()
        self._pool.clear()

    def __enter__(self) -> "WorkerSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
