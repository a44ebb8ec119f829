"""One serving replica as its own OS process (port of
``tpu_trainer/serving/worker.py``): ``python -m
tpu_trainer_torch.serving.worker`` runs a single ``ServingEngine`` behind
the length-prefixed JSON RPC loop defined in ``serving/remote.py``.

The worker is a pure **RPC reactor** — the engine advances ONLY inside
a handler, never on its own schedule. That one design choice buys the
two properties the cross-process front-end needs:

- **Determinism**: the front-end drives every engine step and ships its
  own clock value (``now``) with each step RPC; the worker's engine is
  built with a captured clock (``clock=lambda: last now received``,
  zero epoch), so in ``steps`` mode every timestamp in the fleet is a
  front-end iteration number — one clock domain, bit-reproducible.
- **Exact load snapshots**: worker state between RPCs is frozen, so the
  ``load`` dict attached to every response (queue depth, outstanding
  tokens, oldest waiting ARRIVAL — age is computed front-end-side) is
  correct until the front-end's next call, with zero polling.

Token streams cross the wire as **deltas**: the worker tracks how many
generated tokens each request has already reported and sends only the
new suffix (plus timestamps and terminal state) per step — the
front-end applies them to its own mirror ``Request`` objects.

Liveness: a ``utils/flight_recorder`` heartbeat is beaten on every loop
wakeup (idle ``select`` timeouts included, throttled), so a healthy but
idle worker stays visibly alive while a wedged handler flatlines within
a second — the same signal the elastic trainer uses for hung hosts.

A torn or non-JSON frame poisons only the CONNECTION, not the process:
the worker closes that socket and goes back to ``accept``, so a
reconnecting front-end finds clean state and live requests survive.

Device: the engine runs on the card unless the spec's engine kwargs say
``"device": "cpu"``. On the card the worker loads the flash-decode
kernel library while it builds its engine, so a worker with no CUDA
device or a kernel that does not build exits non-zero before it serves;
it never falls back to the CPU. At each ``reset`` and at a clean
shutdown it prints one JSON line to its log, ``{"worker": N,
"flash_decode_launches": K}``: the kernel's launches in this process so
far.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import socket
import sys
from typing import Dict, List, Optional

from tpu_trainer_torch.serving.remote import (
    MAX_ATTACHED_FRAMES,
    FrameError,
    decode_kv_block,
    encode_kv_block,
    recv_binary_frame,
    recv_frame,
    request_from_wire,
    request_to_wire,
    send_binary_frame,
    send_frame,
)
from tpu_trainer_torch.serving.scheduler import Request, TERMINAL_STATES
from tpu_trainer_torch.utils.flight_recorder import HeartbeatWriter


def _jsonable(x):
    """Engine summaries carry numpy scalars; JSON does not."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        return x.item()
    return x


class WorkerServer:
    """The RPC reactor around one ``ServingEngine``."""

    def __init__(self, spec: dict, *, worker_id: int = 0,
                 heartbeat_dir: Optional[str] = None):
        self.spec = spec
        self.worker_id = worker_id
        self._now_value = 0.0
        self._steps = 0
        self._shutdown = False
        self._hb = (HeartbeatWriter(heartbeat_dir, host=worker_id,
                                    min_interval_s=0.2)
                    if heartbeat_dir else None)
        self._reqs: Dict[int, Request] = {}
        self._sent: Dict[int, int] = {}    # generated tokens already reported
        self._params = None    # the host weights, loaded once a process
        self.engine = self._build_engine()

    def _build_engine(self):
        # Imported here, not at module top: torch and the model load in
        # the worker process only, once argument parsing and socket
        # binding have already succeeded.
        from tpu_trainer_torch.models.config import GPTConfig
        from tpu_trainer_torch.models.weights import (from_jax_params,
                                                      load_params_npz)
        from tpu_trainer_torch.obs.metrics import MetricsRegistry
        from tpu_trainer_torch.serving.engine import ServingEngine
        from tpu_trainer_torch.utils.device import resolve_device

        config = GPTConfig(**self.spec["config"])
        kw = dict(self.spec.get("engine", {}))
        dsets = self.spec.get("device_sets")
        if dsets:
            # This worker's mesh: its entry of the fleet's device sets,
            # assigned round-robin by worker id.
            kw["mesh_devices"] = tuple(
                int(d) for d in dsets[self.worker_id % len(dsets)])
        device = resolve_device(kw.get("device"))
        if device.type == "cuda":
            # The decode kernel is built and loaded now: a worker whose
            # kernel does not build exits before it serves anything.
            from tpu_trainer_torch.ops import flash

            flash._library()
        if self._params is None:
            if self.spec.get("params_shards"):
                # Shard-streaming launch: the params arrive as a
                # host_shards export (one ~P/world file a worker on the
                # wire); a worker on a shared filesystem stitches the tree
                # from all of them.
                from tpu_trainer_torch.utils.checkpoint import (
                    load_param_shards)

                tree = load_param_shards(self.spec["params_shards"])
            else:
                tree = load_params_npz(self.spec["params_npz"])
            # The host copy of the weights, kept for ``reset``; the
            # engine moves them to its device.
            self._params = from_jax_params(tree, config, device="cpu")
        params = self._params
        # Every worker engine gets a live registry: the front-end pulls
        # snapshots over the ``metrics`` verb and merges them label-wise
        # (replica=N) into its own registry. Single-threaded here — the
        # reactor owns both the engine and the scrape.
        eng = ServingEngine(params, config, clock=lambda: self._now_value,
                            registry=MetricsRegistry(), **kw)
        eng._t0 = 0.0   # front-end clock domain: timestamps ARE its times
        return eng

    def _beat(self) -> None:
        if self._hb is not None:
            self._hb.beat(self._steps)

    # -- load snapshot (see module docstring: exact between our RPCs) ------

    def _load(self) -> dict:
        eng = self.engine
        arr = eng.scheduler.oldest_waiting_arrival
        d = {
            "queue_depth": int(eng.queue_depth),
            "outstanding_tokens": int(eng.outstanding_tokens),
            "has_work": bool(eng.scheduler.has_work()),
            "oldest_arrival": None if arr is None else float(arr),
            "generated_tokens": int(eng.stats["generated_tokens"]),
            "prefix_hit_tokens": int(eng.scheduler.prefix_hit_tokens),
            "prompt_tokens": int(eng.scheduler.prompt_tokens),
            "n_preemptions": int(eng.scheduler.n_preemptions),
            "store_hit_tokens_host": int(
                eng.cache_state.store_hit_tokens_host),
            "store_hit_tokens_disk": int(
                eng.cache_state.store_hit_tokens_disk),
        }
        if eng.kv_store is not None:
            # Newly stored digests since the last reply — the front-end
            # catalogs them (digest -> holder) with zero extra RPCs.
            new = eng.kv_store.drain_new_digests()
            if new:
                d["kv_new"] = [dg.hex() for dg in new]
        if eng.role == "prefill":
            d["migratable"] = eng.migratable_rids()
        return d

    # -- handlers ----------------------------------------------------------

    def _delta(self, req: Request) -> dict:
        sent = self._sent[req.rid]
        return {
            "rid": req.rid,
            "gen": req.generated[sent:],
            "times": [float(t) for t in req.token_times[sent:]],
            "first": req.first_token_at,
            "status": req.status,
            "done": req.status in TERMINAL_STATES,
            "finished_at": req.finished_at,
            "preempt": req.preemptions,
            "hit": req.prefix_hit_tokens,
            "spec": [req.spec_drafted, req.spec_accepted, req.spec_steps],
        }

    def handle(self, msg: dict) -> dict:
        method = msg.get("method")
        if method == "hello":
            return {"block_size": int(self.engine.cache_state.block_size),
                    "pid": os.getpid(), "worker_id": self.worker_id,
                    "load": self._load()}
        if method == "ping":
            return {}
        if method == "submit":
            req = request_from_wire(msg["req"])
            # Front-door trace context (submitted/routed events) rides
            # the submit payload so this engine's tracer holds the rid's
            # FULL timeline — ingested non-pending, so the events are
            # never echoed back to the side that already has them.
            ctx = msg.get("trace")
            if ctx:
                self.engine.tracer.ingest(ctx)
            mig = msg.get("mig")
            if mig is not None:
                # Migrated admission: full blocks are already in our
                # store (kv_put'd by the front-end); the raw tail rides
                # the attached binary frame. Admission prices the tail
                # and every store fill against recompute per block.
                leaves = None
                frames = msg.get("_frames") or ()
                if frames:
                    leaves = decode_kv_block(frames[0])
                req._kv_migration = {
                    "tail_ntok": int(mig.get("tail_ntok", 0)),
                    "leaves": leaves}
            self.engine.scheduler.add(req)
            self._reqs[req.rid] = req
            self._sent[req.rid] = len(req.generated)
            return {"load": self._load()}
        if method == "step":
            self._now_value = float(msg.get("now", self._now_value))
            self.engine.step()
            self._steps += 1
            deltas: List[dict] = []
            for rid, req in list(self._reqs.items()):
                if len(req.generated) > self._sent[rid] or (
                        req.status in TERMINAL_STATES):
                    deltas.append(self._delta(req))
                    self._sent[rid] = len(req.generated)
                    if req.status in TERMINAL_STATES:
                        del self._reqs[rid]
                        del self._sent[rid]
            return {"deltas": deltas, "load": self._load()}
        if method == "cancel":
            # Terminal on the spot: the engine frees the request's slot
            # and blocks before this response is framed, and the request
            # never appears in a later step delta — the front-end mirror
            # applies the delta returned HERE instead.
            self._now_value = float(msg.get("now", self._now_value))
            rid = int(msg["rid"])
            ok = self.engine.cancel(rid)
            delta = None
            if ok and rid in self._reqs:
                req = self._reqs.pop(rid)
                delta = self._delta(req)
                del self._sent[rid]
            return {"cancelled": bool(ok), "delta": delta,
                    "load": self._load()}
        if method == "export":
            reqs = self.engine.export_requests(
                waiting_only=bool(msg.get("waiting_only", False)))
            for r in reqs:
                self._reqs.pop(r.rid, None)
                self._sent.pop(r.rid, None)
            return {"requests": [request_to_wire(r) for r in reqs],
                    "load": self._load()}
        if method == "kv_put":
            store = self.engine.kv_store
            frames = msg.get("_frames") or ()
            if not frames:
                raise ValueError("kv_put without a payload frame")
            if store is None:
                # Fleet-config state, not a protocol error: a worker
                # without a local store just recomputes what the push
                # would have saved.
                return {"stored": False, "load": self._load()}
            # A pushed block is not "new" to the fleet — the front-end
            # already knows it; announce=False keeps it out of the
            # catalog feed without dropping the engine's OWN pending
            # announcements.
            stored = store.put(bytes.fromhex(msg["digest"]),
                               decode_kv_block(frames[0]),
                               announce=False)
            return {"stored": bool(stored), "load": self._load()}
        if method == "kv_get":
            store = self.engine.kv_store
            hit = (None if store is None
                   else store.get(bytes.fromhex(msg["digest"])))
            if hit is None:
                return {"found": False, "load": self._load()}
            tier, leaves = hit
            return {"found": True, "tier": tier,
                    "_frames": [encode_kv_block(leaves)],
                    "load": self._load()}
        if method == "kv_has":
            store = self.engine.kv_store
            digs = [bytes.fromhex(h) for h in msg.get("digests", ())]
            return {"has": [bool(store is not None and store.has(d))
                            for d in digs],
                    "load": self._load()}
        if method == "set_role":
            self.engine.set_role(msg.get("role"))
            return {"load": self._load()}
        if method == "extract":
            self._now_value = float(msg.get("now", self._now_value))
            rid = int(msg["rid"])
            out = self.engine.extract_request(rid)
            if out is None:
                return {"found": False, "load": self._load()}
            req, payload = out
            self._reqs.pop(rid, None)
            self._sent.pop(rid, None)
            result = {"found": True, "req": request_to_wire(req),
                      "tail_ntok": 0, "load": self._load()}
            if payload is not None:
                result["tail_ntok"] = int(payload["tail_ntok"])
                # Block-aligned contexts have no raw tail to ship.
                if payload.get("leaves") is not None:
                    result["_frames"] = [encode_kv_block(payload["leaves"])]
            return result
        if method == "summary":
            return {"summary": _jsonable(self.engine.summary()),
                    "load": self._load()}
        if method == "metrics":
            # Registry snapshot for the front-end merge: callbacks are
            # resolved to plain values here, so the wire carries only
            # JSON scalars (see obs.metrics.MetricsRegistry.snapshot).
            return {"metrics": self.engine.registry.snapshot(),
                    "load": self._load()}
        if method == "reset":
            # Fresh engine, warm process: imports and the loaded kernel
            # library are kept.
            self._report_launches()
            self._reqs.clear()
            self._sent.clear()
            self.engine = self._build_engine()
            self._steps = 0
            return {"load": self._load()}
        if method == "shutdown":
            self._shutdown = True
            return {}
        raise ValueError(f"unknown method {method!r}")

    # -- the socket loop ---------------------------------------------------

    def serve(self, srv: socket.socket) -> None:
        srv.setblocking(False)
        self._beat()
        while not self._shutdown:
            r, _, _ = select.select([srv], [], [], 0.5)
            self._beat()
            if not r:
                continue
            try:
                conn, _ = srv.accept()
            except OSError:
                continue
            self._serve_conn(conn)
        if self._hb is not None:
            self._hb.stop()
        self._report_launches()

    def _report_launches(self) -> None:
        """One JSON line on stdout (the worker's log): this process's
        flash-decode kernel launches so far."""
        from tpu_trainer_torch.ops import flash

        print(json.dumps({"worker": self.worker_id,
                          "flash_decode_launches":
                          int(flash.flash_decode.launches)}), flush=True)

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setblocking(True)
        try:
            while not self._shutdown:
                r, _, _ = select.select([conn], [], [], 0.5)
                self._beat()
                if not r:
                    continue
                try:
                    msg = recv_frame(conn)
                except FrameError:
                    return              # poisoned stream: drop this client
                if msg is None:
                    return              # clean disconnect
                nf = int(msg.get("nframes", 0) or 0)
                if nf:
                    # Attached binary frames (kv_put payloads, migration
                    # tails) follow the JSON frame immediately. A torn
                    # or over-announced batch poisons this connection
                    # only, exactly like a torn JSON frame.
                    if nf < 0 or nf > MAX_ATTACHED_FRAMES:
                        return
                    try:
                        msg["_frames"] = [
                            recv_binary_frame(conn) for _ in range(nf)]
                    except FrameError:
                        return
                out_frames: List[bytes] = []
                try:
                    result = self.handle(msg)
                    # Binary payloads leave the JSON result and trail the
                    # response as announced attached frames.
                    out_frames = result.pop("_frames", None) or []
                    # Piggyback the engine tracer's span-event delta on
                    # every reply: worker-side events (admitted, prefill
                    # chunks, first_token, spec windows, terminals)
                    # reach the front-end timeline with zero extra
                    # round-trips. Empty when tracing is off.
                    trace = self.engine.tracer.drain()
                    if trace:
                        result["trace"] = trace
                    resp = {"id": msg.get("id"), "ok": True, "result": result}
                except ValueError as e:
                    resp = {"id": msg.get("id"), "ok": False,
                            "error": {"type": "ValueError", "msg": str(e)}}
                except Exception as e:  # keep serving other requests
                    resp = {"id": msg.get("id"), "ok": False,
                            "error": {"type": type(e).__name__,
                                      "msg": str(e)}}
                if out_frames:
                    resp["nframes"] = len(out_frames)
                try:
                    send_frame(conn, _jsonable(resp))
                    for fr in out_frames:
                        send_binary_frame(conn, fr)
                except (OSError, FrameError):
                    return
                self._beat()
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="one ServingEngine replica behind a JSON-RPC socket")
    p.add_argument("--spec", required=True,
                   help="JSON file: {config, engine kwargs, params_npz}")
    p.add_argument("--socket", default=None,
                   help="unix socket path to listen on (the default "
                        "transport)")
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="listen on TCP instead (port 0 = ephemeral)")
    p.add_argument("--addr-file", default=None,
                   help="with --tcp: write the bound host:port here")
    p.add_argument("--heartbeat-dir", default=None)
    p.add_argument("--worker-id", type=int, default=0)
    args = p.parse_args(argv)
    if not args.socket and not args.tcp:
        p.error("one of --socket or --tcp is required")

    with open(args.spec) as f:
        spec = json.load(f)

    # Bind BEFORE the (slow) engine build so the supervisor's connect
    # succeeds immediately; its first RPC simply waits for accept.
    if args.tcp:
        host, port = args.tcp.rsplit(":", 1)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, int(port)))
        if args.addr_file:
            bound = srv.getsockname()
            tmp = f"{args.addr_file}.tmp"
            with open(tmp, "w") as f:
                f.write(f"{bound[0]}:{bound[1]}")
            os.replace(tmp, args.addr_file)
    else:
        if os.path.exists(args.socket):
            os.unlink(args.socket)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(args.socket)
    srv.listen(4)

    server = WorkerServer(spec, worker_id=args.worker_id,
                          heartbeat_dir=args.heartbeat_dir)
    try:
        server.serve(srv)
    finally:
        srv.close()
        if args.socket and os.path.exists(args.socket):
            try:
                os.unlink(args.socket)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
