"""Wire frames and the ``KVB1`` KV-block codec (port of the framing and
codec part of ``tpu_trainer/serving/remote.py``).

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

The RPC, the remote replica and the worker supervisor are not ported
(ROADMAP Queue 1: "Serving across devices: TP decode and the fleet").
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

_HEADER = struct.Struct(">I")
MAX_FRAME_BYTES = 1 << 26   # 64 MiB: a garbage length prefix must not OOM us
_BINARY_BIT = 0x8000_0000


class FrameError(Exception):
    """Torn, oversized, or non-JSON frame — the connection is poisoned
    and must be closed (the stream has no way to resynchronise)."""


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
