"""Crash-safe checkpoints of one process (port of the single-process layout
of ``tpu_trainer/utils/checkpoint.py``), without orbax and without pickle.

Layout::

    <dir>/step_00000100/state.npz   # f32 params + Adam moments, generator
    <dir>/step_00000100/meta.json   # step, tokens_seen, configs, data_state

``state.npz`` holds ``TrainState.state_dict()``'s arrays under the Flax
``a/b/c`` paths (``params/...``, ``opt_state/mu/...``,
``opt_state/nu/...``; narrow moments in their storage form: bf16 as
``uint16`` bits, an int8 pack as ``.../q`` and ``.../scale``) and the
dropout generator's state as a ``uint8`` array ``generator``.
``meta.json`` holds the JAX package's ``_meta_dict`` keys plus the state's
scalars (``opt_count``, ``loss_scale``, ``good_steps``). A checkpoint
restores only into the moment storage it was saved with: another
``optimizer_state_dtype`` raises ``CheckpointIncompatibleError`` naming
it, as the JAX package does, and so does another host-offload storage
(``offload_dtype``, ``offload_budget_gb``); an offload in "float32" stores
exactly what the on-device state does, so those two restore into each
other.

Crash-safety contract (the training CLI's resume and rollback build on
it):

- Both files are written to a temporary name and renamed into place, the
  state first and ``meta.json`` last: a checkpoint is *complete* iff its
  ``meta.json`` parses, so a crash mid-save leaves a directory that
  ``list_checkpoints`` / ``latest_checkpoint`` never report.
- ``restore_latest(verify=True)`` quarantines a checkpoint that fails to
  load (a torn or corrupt ``state.npz`` fails the zip CRC) by renaming it
  aside, and falls back to the previous complete step.
  ``CheckpointIncompatibleError`` (a different model shape or optimizer
  storage) always propagates.
- ``keep_last_n`` deletes completed checkpoints oldest first; in-flight
  (meta-less) and quarantined directories are never touched.

``export_consolidated`` writes the params alone as the ``a/b/c`` npz that
the JAX package's ``serving.remote.load_params_npz`` reads.

Several processes (world > 1) use the JAX package's *two-phase commit*
instead of ``state.npz`` (``meta.json`` carries ``format: "host_shards"``
and ``shard_world``)::

    <dir>/step_00000100/shards/host00000.npz   # this rank's slices
    <dir>/step_00000100/shards/host00000.json  # their manifest
    <dir>/step_00000100/commit/host00000.done  # phase-1 DONE marker
    <dir>/step_00000100/meta.json              # rank 0, after ALL markers

Phase 1: every rank writes its slices (``TrainState.shard_records``: the
ranks of data coordinate 0 write each element once) and then an atomic
DONE marker stamped with the world and ``TPU_TRAINER_ATTEMPT``. Phase 2:
rank 0 polls ``commit/`` (a bounded filesystem barrier, never a
collective, so it is safe on the async writer's thread while the main
thread runs the step's collectives: ``TPU_TRAINER_CKPT_BARRIER_TIMEOUT_S``,
default 120 s) and writes ``meta.json`` last; the others wait for it. The
faults ``kill_in_save`` (between marker and meta), ``truncate_meta`` and
``corrupt_shard`` fire at the JAX points. Restore stitches the global
arrays from every host file and gives each rank of the restoring trainer
its slices, at any world size, and reads a ``state.npz`` at world > 1
the same way. ``export_param_shards`` / ``load_param_shards`` are the JAX
shard-streaming export, byte for byte (``np.savez`` of ``uint8`` views, the
same manifest and meta), and ``remap_data_state`` the JAX cursor remap.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.weights import load_params_npz, param_specs
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.parallel.sharding import fsdp_dim
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.utils import faults

_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")
STATE_FILE = "state.npz"
CONSOLIDATED_FILE = "params.npz"
# Suffix of a quarantined (failed-to-load) checkpoint directory; it no
# longer matches _STEP_DIR_RE, so every scan ignores it.
QUARANTINE_SUFFIX = ".corrupt"
_STATE_SCALARS = ("step", "opt_count", "loss_scale", "good_steps")
# meta.json "format" of the multi-process two-phase layout.
HOST_SHARDS_FORMAT = "host_shards"
_SHARDS_SUBDIR = "shards"
_COMMIT_SUBDIR = "commit"


def _barrier_timeout_s() -> float:
    """Bound on the commit barrier: past it, a missing peer marker means a
    rank died mid-save, and the others raise instead of waiting."""
    return float(os.environ.get("TPU_TRAINER_CKPT_BARRIER_TIMEOUT_S", "120"))


class CheckpointIncompatibleError(ValueError):
    """The checkpoint loads but belongs to another configuration (model
    shapes, optimizer storage): a user error, never quarantined."""


def retry_io(fn: Callable[[], Any], *, what: str, attempts: int = 4,
             base_delay_s: float = 0.05,
             retry_on: Tuple[type, ...] = (OSError,),
             sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run ``fn`` with bounded retry and exponential backoff on transient
    filesystem errors; the last failure re-raises."""
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = base_delay_s * (2 ** attempt)
            print(f"checkpoint io retry {attempt + 1}/{attempts - 1} for "
                  f"{what}: {type(e).__name__}: {e}; backing off "
                  f"{delay:.2f}s", file=sys.stderr, flush=True)
            sleep(delay)


def step_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"step_{step:08d}")


def _read_meta(path: str) -> Optional[dict]:
    """``meta.json`` of a step dir, or None if missing, empty or torn."""
    meta_path = os.path.join(path, "meta.json")

    def _read() -> Optional[str]:
        try:
            with open(meta_path) as f:
                return f.read()
        except FileNotFoundError:
            return None

    try:
        raw = retry_io(_read, what=f"read {meta_path}")
    except OSError:
        return None
    if raw is None:
        return None
    try:
        meta = json.loads(raw)
    except ValueError:
        return None
    return meta if isinstance(meta, dict) else None


def list_checkpoints(checkpoint_dir: str) -> List[Tuple[int, str]]:
    """Completed checkpoints as ascending ``(step, path)`` pairs: the name
    matches ``step_XXXXXXXX`` and ``meta.json`` parses."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in sorted(os.listdir(checkpoint_dir)):
        m = _STEP_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(checkpoint_dir, name)
        if _read_meta(path) is not None:
            out.append((int(m.group(1)), path))
    return out


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Newest complete step dir, or None."""
    ckpts = list_checkpoints(checkpoint_dir)
    return ckpts[-1][1] if ckpts else None


def quarantine_checkpoint(path: str) -> str:
    """Rename a bad checkpoint aside (``*.corrupt``, collision-suffixed);
    returns the new path. Every rank calls it at world > 1: rank 0 alone
    renames, and the others wait for the rename (the broadcast of its
    destination) before they scan the directory again."""
    path = os.path.abspath(path)
    dest = None
    if mesh_lib.process_index() == 0:
        dest = path + QUARANTINE_SUFFIX
        n = 1
        while os.path.exists(dest):
            dest = f"{path}{QUARANTINE_SUFFIX}.{n}"
            n += 1
        retry_io(lambda: os.rename(path, dest), what=f"quarantine {path}")
    return mesh_lib.broadcast_from_host0(dest)


def gc_checkpoints(checkpoint_dir: str, keep_last_n: int) -> List[str]:
    """Delete completed checkpoints beyond the newest ``keep_last_n``
    (best effort, rank 0 alone); returns the deleted paths."""
    if keep_last_n <= 0 or mesh_lib.process_index() != 0:
        return []
    removed = []
    for _, path in list_checkpoints(checkpoint_dir)[:-keep_last_n]:
        try:
            retry_io(lambda p=path: shutil.rmtree(p), what=f"gc {path}")
        except OSError:
            continue
        removed.append(path)
    return removed


def _atomic_write(path: str, write: Callable[[Any], None], mode: str) -> None:
    """Write through a temporary file, fsync, rename into place."""
    def _do() -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry_io(_do, what=f"write {path}")


def _write_meta(path: str, meta: dict) -> None:
    _atomic_write(os.path.join(path, "meta.json"),
                  lambda f: json.dump(meta, f, indent=2), "w")


def _meta_dict(*, step: int, model_config: GPTConfig,
               training_config: TrainingConfig, tokens_seen: int,
               data_state: Optional[dict]) -> dict:
    meta = {
        "step": step,
        "tokens_seen": int(tokens_seen),
        "model_config": dataclasses.asdict(model_config),
        "training_config": dataclasses.asdict(training_config),
    }
    if data_state is not None:
        meta["data_state"] = data_state
    return meta


def _commit(checkpoint_dir: str, snapshot, *,
            model_config: GPTConfig, training_config: TrainingConfig,
            tokens_seen: int, data_state: Optional[dict],
            keep_last_n: int) -> str:
    """The durable half of a save, from a host snapshot
    (``TrainState.state_dict()``, or a ``_HostShardSnapshot`` at world >
    1, which takes the two-phase commit): ``state.npz``, then
    ``meta.json``, then GC; the fault plan's ``kill_in_save``,
    ``truncate_meta`` and ``corrupt_shard`` fire here
    (``utils/faults.py``)."""
    if isinstance(snapshot, _HostShardSnapshot):
        return _commit_two_phase(
            checkpoint_dir, snapshot, model_config=model_config,
            training_config=training_config, tokens_seen=tokens_seen,
            data_state=data_state, keep_last_n=keep_last_n)
    step = int(snapshot["step"])
    path = step_dir(checkpoint_dir, step)
    os.makedirs(path, exist_ok=True)
    arrays = {k: v for k, v in snapshot.items() if k not in _STATE_SCALARS}
    _atomic_write(os.path.join(path, STATE_FILE),
                  lambda f: np.savez(f, **arrays), "wb")
    if faults.fire("kill_in_save", step):
        # Injected crash between the state write and the meta write: the
        # partial checkpoint a mid-save preemption leaves. ``os._exit``
        # ends the whole process from the writer thread too.
        faults.kill()
    meta = _meta_dict(step=step, model_config=model_config,
                      training_config=training_config,
                      tokens_seen=tokens_seen, data_state=data_state)
    meta.update({k: snapshot[k] for k in _STATE_SCALARS if k != "step"})
    _write_meta(path, meta)
    if faults.fire("truncate_meta", step):
        faults.truncate_file(os.path.join(path, "meta.json"))
    if faults.fire("corrupt_shard", step):
        _corrupt_some_shard(path)
    if keep_last_n > 0:
        gc_checkpoints(checkpoint_dir, keep_last_n)
    return path


def save_checkpoint(checkpoint_dir: str, state, *, model_config: GPTConfig,
                    training_config: TrainingConfig, tokens_seen: int = 0,
                    data_state: Optional[dict] = None,
                    keep_last_n: int = 0,
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> str:
    """Write ``state`` (a ``TrainState``) as ``step_<state.step>``; returns
    its path. ``data_state`` (a loader cursor) rides in ``meta.json`` so a
    resumed run continues the data stream exactly; ``keep_last_n > 0``
    garbage-collects older complete checkpoints afterwards. Every rank
    calls it at world > 1 (the two-phase commit).

    ``process_index`` / ``process_count`` are the JAX test seam: one
    process writes a simulated ``process_count``-rank two-phase
    checkpoint of a one-process ``state``, one call a simulated rank, rank
    0 last (its call runs the commit barrier and writes meta)."""
    if process_count is not None or state.sharding is not None:
        snap = host_shard_snapshot(state, host=process_index,
                                   world=process_count)
        return _commit_two_phase(
            checkpoint_dir, snap, model_config=model_config,
            training_config=training_config, tokens_seen=tokens_seen,
            data_state=data_state, keep_last_n=keep_last_n,
            host=process_index, world=process_count,
            simulated=process_count is not None)
    return _commit(checkpoint_dir, state.state_dict(),
                   model_config=model_config,
                   training_config=training_config, tokens_seen=tokens_seen,
                   data_state=data_state, keep_last_n=keep_last_n)


class _HostShardSnapshot(list):
    """One rank's slices of every array (``TrainState.shard_records``),
    with the state's scalars in ``scalars``: a distinct type so ``_commit``
    tells it from a ``state_dict``."""

    scalars: dict


def host_shard_snapshot(state, *, host: Optional[int] = None,
                        world: Optional[int] = None) -> _HostShardSnapshot:
    """This rank's slices of ``state``, copied to host memory (the JAX
    ``host_shard_snapshot``). ``host`` / ``world`` simulate rank ``host``
    of ``world`` from a one-process state (the test seam): each array is
    split by the FSDP rule for ``world``, and a replicated one and the
    generator go to rank 0."""
    records = state.shard_records()
    if world is not None:
        out = []
        for rec in records:
            (_, arr), = rec["shards"]
            d = (None if rec["key"] == "generator"
                 else fsdp_dim(arr.shape, world))
            if d is None:
                shards = [rec["shards"][0]] if host == 0 else []
            else:
                k = arr.shape[d] // world
                starts = [0] * arr.ndim
                starts[d] = host * k
                sl = (slice(None),) * d + (slice(host * k, (host + 1) * k),)
                shards = [(tuple(starts), np.ascontiguousarray(arr[sl]))]
            out.append(dict(rec, shards=shards))
        records = out
    snap = _HostShardSnapshot(records)
    snap.scalars = state.scalars()
    return snap


def _write_host_shards(path: str, snapshot, *, host: int,
                       world: int) -> None:
    """Phase 1a: durably write this rank's slices and their manifest. The
    bytes go into one npz (each array as raw ``uint8``); the manifest
    records key, global shape, dtype and each slice's start."""
    sdir = os.path.join(path, _SHARDS_SUBDIR)
    os.makedirs(sdir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"host": host, "world": world, "leaves": []}
    for li, leaf in enumerate(snapshot):
        entry = {"key": leaf["key"],
                 "global_shape": list(leaf["global_shape"]),
                 "dtype": leaf["dtype"], "shards": []}
        for si, (starts, arr) in enumerate(leaf["shards"]):
            name = f"l{li}_s{si}"
            arrays[name] = np.frombuffer(
                np.ascontiguousarray(arr).tobytes(), dtype=np.uint8)
            entry["shards"].append({"name": name,
                                    "start": [int(x) for x in starts],
                                    "shape": [int(x) for x in arr.shape]})
        manifest["leaves"].append(entry)
    npz = os.path.join(sdir, f"host{host:05d}.npz")
    man = os.path.join(sdir, f"host{host:05d}.json")

    def _write() -> None:
        with open(npz + ".tmp", "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(npz + ".tmp", npz)
        with open(man + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(man + ".tmp", man)

    retry_io(_write, what=f"write {npz}")


def _attempt_token() -> Optional[str]:
    """The elastic supervisor's attempt id (``TPU_TRAINER_ATTEMPT``), or
    None: markers are trusted only from this attempt."""
    return os.environ.get("TPU_TRAINER_ATTEMPT")


def _mark_host_done(path: str, *, host: int, world: int) -> None:
    """Phase 1b: the atomic per-rank DONE marker, after its slices are
    durable."""
    cdir = os.path.join(path, _COMMIT_SUBDIR)
    os.makedirs(cdir, exist_ok=True)
    _atomic_write(os.path.join(cdir, f"host{host:05d}.done"),
                  lambda f: json.dump({"host": host, "world": world,
                                       "attempt": _attempt_token()}, f), "w")


def _await_commit(path: str, ready: Callable[[], bool], *, what: str,
                  timeout_s: Optional[float] = None) -> None:
    """Poll ``ready`` with backoff until true; past the timeout raise
    ``TimeoutError`` (a peer that died mid-save)."""
    timeout_s = _barrier_timeout_s() if timeout_s is None else timeout_s
    deadline = time.monotonic() + timeout_s
    delay = 0.005
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint commit barrier timed out after {timeout_s:.0f}s "
                f"waiting for {what} in {path}")
        time.sleep(delay)
        delay = min(delay * 2, 0.25)


def _markers_complete(path: str, world: int) -> bool:
    """All ``world`` DONE markers present, written for this world and by
    this attempt (a dead attempt's markers in a re-saved step dir do not
    count)."""
    cdir = os.path.join(path, _COMMIT_SUBDIR)
    attempt = _attempt_token()
    for host in range(world):
        try:
            with open(os.path.join(cdir, f"host{host:05d}.done")) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return False
        if (not isinstance(rec, dict) or rec.get("world") != world
                or rec.get("attempt") != attempt):
            return False
    return True


def _corrupt_some_shard(path: str) -> None:
    """Byte-flip every file of a step dir's state (``state.npz`` or
    ``shards/``): the npz CRC then fails the restore."""
    state = os.path.join(path, STATE_FILE)
    if os.path.exists(state):
        faults.corrupt_file(state)
    for root, _, names in os.walk(os.path.join(path, _SHARDS_SUBDIR)):
        for name in names:
            faults.corrupt_file(os.path.join(root, name))


def _commit_two_phase(checkpoint_dir: str, snapshot: _HostShardSnapshot, *,
                      model_config: GPTConfig,
                      training_config: TrainingConfig, tokens_seen: int,
                      data_state: Optional[dict], keep_last_n: int,
                      host: Optional[int] = None,
                      world: Optional[int] = None,
                      simulated: bool = False) -> str:
    """The multi-process commit, one call a rank: slices, DONE marker,
    the ``kill_in_save`` window, then rank 0 waits for every marker and
    writes ``meta.json`` last (and runs the faults and GC); the others wait
    for meta, so a save that returned is durable everywhere. ``simulated``
    (one process playing every rank, rank 0 last) skips the waits but rank
    0's marker check."""
    host = mesh_lib.process_index() if host is None else host
    world = mesh_lib.process_count() if world is None else world
    step = int(snapshot.scalars["step"])
    path = step_dir(checkpoint_dir, step)
    os.makedirs(path, exist_ok=True)
    _write_host_shards(path, snapshot, host=host, world=world)
    _mark_host_done(path, host=host, world=world)
    if faults.fire("kill_in_save", step):
        # Shards and marker durable, meta not: a scan never reports it.
        faults.kill()
    if host == 0:
        _await_commit(path, lambda: _markers_complete(path, world),
                      what=f"{world} host DONE markers",
                      timeout_s=1.0 if simulated else None)
        meta = _meta_dict(step=step, model_config=model_config,
                          training_config=training_config,
                          tokens_seen=tokens_seen, data_state=data_state)
        meta.update({k: v for k, v in snapshot.scalars.items()
                     if k != "step"})
        meta.update(format=HOST_SHARDS_FORMAT, shard_world=world)
        _write_meta(path, meta)
        if faults.fire("truncate_meta", step):
            faults.truncate_file(os.path.join(path, "meta.json"))
        if faults.fire("corrupt_shard", step):
            _corrupt_some_shard(path)
        if keep_last_n > 0:
            gc_checkpoints(checkpoint_dir, keep_last_n)
    elif not simulated:
        _await_commit(path, lambda: os.path.exists(
            os.path.join(path, "meta.json")), what="meta.json from rank 0")
    return path


def _stitch(sdir: str, expected_world: Optional[int], what: str
            ) -> Dict[str, np.ndarray]:
    """Every rank file of ``sdir`` stitched into global arrays by key."""
    try:
        manifests = sorted(n for n in os.listdir(sdir)
                           if n.startswith("host") and n.endswith(".json"))
    except OSError as e:
        raise ValueError(f"unreadable shards dir {sdir}: {e}")
    if expected_world is not None and len(manifests) < expected_world:
        raise ValueError(f"{what} incomplete: {len(manifests)}/"
                         f"{expected_world} host manifests")
    out: Dict[str, np.ndarray] = {}
    for man_name in manifests:
        with open(os.path.join(sdir, man_name)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(sdir, man_name[:-len(".json")]
                                  + ".npz")) as data:
            for leaf in manifest["leaves"]:
                dtype = np.dtype(leaf["dtype"])
                buf = out.get(leaf["key"])
                if buf is None:
                    buf = np.zeros(tuple(leaf["global_shape"]), dtype=dtype)
                    out[leaf["key"]] = buf
                for sh in leaf["shards"]:
                    arr = np.frombuffer(data[sh["name"]].tobytes(),
                                        dtype=dtype).reshape(sh["shape"])
                    buf[tuple(slice(st, st + ln) for st, ln in
                              zip(sh["start"], sh["shape"]))] = arr
    return out


def _assemble_host_shards(path: str, meta: dict) -> Dict[str, np.ndarray]:
    """The global arrays of a ``host_shards`` checkpoint, from every rank's
    files (restorable at any world size). Raises ``ValueError`` on a
    missing rank file; a flipped byte fails the npz CRC."""
    return _stitch(os.path.join(path, _SHARDS_SUBDIR),
                   meta.get("shard_world"), f"host_shards checkpoint {path}")


def _pick_export_axis(shape, world: int) -> Optional[int]:
    """``export_param_shards``'s wire rule: the largest axis with at least
    ``world`` elements (ties -> the lowest), else None (whole, in rank 0's
    file)."""
    best = None
    for ax, n in enumerate(shape):
        if n >= world and (best is None or n > shape[best]):
            best = ax
    return best


def export_param_shards(params, path: str, *, world: int) -> str:
    """Write an inference params tree as a ``world``-way ``host_shards``
    directory (the JAX shard-streaming launch format): each leaf splits
    into near-equal contiguous chunks on its largest axis, leaves too
    small to split ride whole in rank 0's file; byte-lossless. ``params``
    is a nested dict of arrays (``models.weights.to_jax_params`` gives
    one); keys are joined with ``/``."""
    if world < 1:
        raise ValueError(f"world={world} < 1")
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    for host in range(world):
        snap = []
        for key, arr in flat.items():
            ax = _pick_export_axis(arr.shape, world) if world > 1 else None
            if ax is None:
                shards = ([(tuple(0 for _ in arr.shape), arr)] if host == 0
                          else [])
            else:
                base, extra = divmod(arr.shape[ax], world)
                start = host * base + min(host, extra)
                size = base + (1 if host < extra else 0)
                sl = [slice(None)] * arr.ndim
                sl[ax] = slice(start, start + size)
                starts = tuple(start if a == ax else 0
                               for a in range(arr.ndim))
                shards = [(starts, np.ascontiguousarray(arr[tuple(sl)]))]
            snap.append({"key": key, "global_shape": tuple(arr.shape),
                         "dtype": str(arr.dtype), "shards": shards})
        _write_host_shards(path, snap, host=host, world=world)
        _mark_host_done(path, host=host, world=world)
    _write_meta(path, {"format": HOST_SHARDS_FORMAT, "shard_world": world,
                       "kind": "param_shards"})
    return path


def load_param_shards(path: str) -> dict:
    """Stitch an ``export_param_shards`` directory back into the nested
    numpy params dict (byte-identical to the exported tree); a missing
    rank file or torn meta raises ``ValueError``."""
    meta = load_meta(path)
    if meta.get("format") != HOST_SHARDS_FORMAT:
        raise ValueError(f"{path} is not a host_shards export")
    flat = _stitch(os.path.join(path, _SHARDS_SUBDIR),
                   meta.get("shard_world"), f"param_shards export {path}")
    out: dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def remap_data_state(data_state: Optional[dict], *,
                     new_global_batch_size: int,
                     new_feed_world: Optional[int] = None,
                     new_seq_shards: Optional[int] = None
                     ) -> Tuple[Optional[dict], int]:
    """A persisted loader cursor on a resized run: ``(new_state,
    replayed_sequences)``. The stream position is ``batch_index *
    global_batch_size`` sequences; a changed global batch floor-divides it
    onto the new granularity, so up to one new-sized batch replays (at
    least once, never skipped). Exact for the dummy and map-style text
    loaders, best effort for streaming (its line shards change with the
    feed world). ``new_seq_shards``: the run's sequence size (every
    sequence rank reads the same rows, so the cursor's units do not
    change; the key is dropped at size 1)."""
    if data_state is None:
        return None, 0
    st = dict(data_state)
    if new_feed_world is not None:
        st["feed_world"] = int(new_feed_world)
    if new_seq_shards is not None:
        st.pop("seq_shards", None)
        if new_seq_shards > 1:
            st["seq_shards"] = int(new_seq_shards)
    old_gbs = st.get("global_batch_size")
    st["global_batch_size"] = int(new_global_batch_size)
    if not old_gbs or int(old_gbs) == int(new_global_batch_size):
        return st, 0
    consumed = int(st.get("batch_index", 0)) * int(old_gbs)
    new_index = consumed // int(new_global_batch_size)
    st["batch_index"] = new_index
    return st, consumed - new_index * int(new_global_batch_size)


class AsyncSaver:
    """Background checkpoint writer: snapshot now, write later.

    ``save()`` blocks only for the host copy of the state
    (``TrainState.state_dict()``: a device synchronize, then copies), made
    on the caller's thread before the writer thread starts, so the thread
    never reads a tensor that the next step updates in place (device
    tensors and host-resident moments alike: both are copied). The
    writer runs ``save_checkpoint``'s sequence (state, meta, GC). At most
    one write is in flight: ``save()`` and ``wait()`` drain it, and
    ``wait()`` re-raises a writer failure on the caller's thread. The
    writer is a daemon thread, so a process that dies mid-write leaves the
    usual meta-less directory.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._path: Optional[str] = None

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Drain the in-flight write; returns its path (None when
        ``timeout`` expired first)."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return None
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._path

    def save(self, checkpoint_dir: str, state, *, model_config: GPTConfig,
             training_config: TrainingConfig, tokens_seen: int = 0,
             data_state: Optional[dict] = None,
             keep_last_n: int = 0) -> str:
        """Snapshot ``state`` to host memory and schedule the write;
        returns the checkpoint's path (complete once ``wait()`` returns)."""
        self.wait()
        snapshot = (state.state_dict() if state.sharding is None
                    else host_shard_snapshot(state))
        step = (snapshot.scalars["step"]
                if isinstance(snapshot, _HostShardSnapshot)
                else int(snapshot["step"]))
        path = step_dir(checkpoint_dir, step)

        def _run() -> None:
            try:
                _commit(checkpoint_dir, snapshot, model_config=model_config,
                        training_config=training_config,
                        tokens_seen=tokens_seen, data_state=data_state,
                        keep_last_n=keep_last_n)
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._path = path
        self._thread = threading.Thread(
            target=_run, name=f"ckpt-write-{step}", daemon=True)
        self._thread.start()
        return path


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _config_from_meta(saved: dict) -> GPTConfig:
    known = {f.name for f in dataclasses.fields(GPTConfig)}
    unknown = sorted(set(saved) - known)
    if unknown:
        raise CheckpointIncompatibleError(
            f"saved model config has fields this build does not know: "
            f"{unknown}")
    return GPTConfig(**saved)


def _check_compatible(path: str, meta: dict, model_config: GPTConfig,
                     training_config: TrainingConfig) -> None:
    """Raise ``CheckpointIncompatibleError``, naming the differing config
    fields, when the saved model's parameter shapes or the optimizer's
    storage differ from this run's. Other differences (dtype, dropout)
    restore."""
    saved = meta.get("model_config")
    now = dataclasses.asdict(model_config)
    if saved is not None and saved != now:
        try:
            there = {n: s for n, (s, _) in
                     param_specs(_config_from_meta(saved)).items()}
            mismatch = there != {n: s for n, (s, _) in
                                 param_specs(model_config).items()}
        except Exception:
            mismatch = True
        if mismatch:
            diff = sorted(k for k in set(saved) | set(now)
                          if saved.get(k) != now.get(k))
            raise CheckpointIncompatibleError(
                f"checkpoint {path} holds an incompatible model (differing "
                f"config fields: {', '.join(diff) or 'shapes'}); point "
                f"--checkpoint_dir at a fresh directory, pass "
                f"--no_auto_resume to start over, or match the saved config")
    saved_osd = (meta.get("training_config") or {}).get(
        "optimizer_state_dtype", "float32")
    if saved_osd != training_config.optimizer_state_dtype:
        raise CheckpointIncompatibleError(
            f"checkpoint {path} was saved with optimizer_state_dtype="
            f"{saved_osd!r} but this run uses "
            f"{training_config.optimizer_state_dtype!r}")


def _state_arrays(path: str, meta: dict) -> Dict[str, np.ndarray]:
    """A step dir's global arrays: ``state.npz``, or every rank's slices
    stitched (``format: "host_shards"``)."""
    if meta.get("format") == HOST_SHARDS_FORMAT:
        return _assemble_host_shards(path, meta)
    with np.load(os.path.join(path, STATE_FILE)) as z:
        return {k: z[k] for k in z.files}


def restore_checkpoint(path: str, trainer) -> Tuple[Any, dict]:
    """``(TrainState, meta)`` of a step dir, on ``trainer``'s device and
    bound to its model. Raises ``CheckpointIncompatibleError`` for another
    model shape or optimizer storage; a torn or corrupt state raises
    another error (``restore_latest`` quarantines those)."""
    path = os.path.abspath(path)
    meta = load_meta(path)
    _check_compatible(path, meta, trainer.model_config,
                     trainer.training_config)
    sd = _state_arrays(path, meta)
    sd.update({k: meta[k] for k in _STATE_SCALARS})
    params = {k[len("params/"):].replace("/", "."): torch.from_numpy(v)
              for k, v in sd.items() if k.startswith("params/")}
    state = trainer.init_state(params=params)
    want = {k: v for k, v in state.layout().items()
            if k.startswith("opt_state/")}
    have = {k: (tuple(v.shape), v.dtype) for k, v in sd.items()
            if k.startswith("opt_state/")}
    if have != want:
        differ = sorted(k for k in set(want) | set(have)
                        if want.get(k) != have.get(k))
        raise CheckpointIncompatibleError(
            f"checkpoint {path} stores the Adam moments in another form "
            f"than this run (offload_dtype / offload_budget_gb differ; "
            f"e.g. {differ[:3]}); resume it with the options it was "
            f"saved with")
    state.load_state_dict(sd)
    return state, meta


def restore_latest(checkpoint_dir: str, trainer, *, verify: bool = True
                   ) -> Optional[Tuple[Any, dict, str]]:
    """Restore the newest loadable checkpoint: ``(state, meta, path)``, or
    None when ``checkpoint_dir`` holds no complete checkpoint. With
    ``verify``, a checkpoint that fails to load is quarantined and the
    previous step is tried. At world > 1 every rank calls it: the ranks
    vote, so a checkpoint that fails on any rank is quarantined once and
    every rank falls back to the same step."""
    for _, path in reversed(list_checkpoints(checkpoint_dir)):
        error = None
        try:
            state, meta = restore_checkpoint(path, trainer)
        except CheckpointIncompatibleError:
            raise
        except Exception as e:
            if not verify:
                raise
            error = e
        if not mesh_lib.global_any(error is not None):
            return state, meta, path
        dest = quarantine_checkpoint(path)
        why = (f"{type(error).__name__}: {error}" if error is not None
               else "failed on another rank")
        print(f"checkpoint {path} failed to load ({why}); quarantined to "
              f"{dest}, falling back to the previous step", file=sys.stderr,
              flush=True)
    return None


def restore_params(path: str) -> Tuple[Dict[str, np.ndarray],
                                       Optional[GPTConfig]]:
    """The params alone, for inference: ``(flat {dotted name: f32 array},
    config)``. ``path`` is a step dir (config from its ``meta.json``; the
    moments are not read) or a consolidated npz (config from a
    ``meta.json`` beside it, else None)."""
    path = os.path.abspath(path)
    if os.path.isfile(path):
        tree = load_params_npz(path)
        flat: Dict[str, np.ndarray] = {}

        def walk(node, prefix):
            for k, v in node.items():
                name = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, name)
                else:
                    flat[name] = v

        walk(tree, "")
        side = _read_meta(os.path.dirname(path))
        config = (_config_from_meta(side["model_config"])
                  if side and side.get("model_config") else None)
        return flat, config
    meta = load_meta(path)
    if meta.get("format") == HOST_SHARDS_FORMAT:
        arrays = _assemble_host_shards(path, meta)
    else:
        with np.load(os.path.join(path, STATE_FILE)) as z:
            arrays = {k: z[k] for k in z.files if k.startswith("params/")}
    flat = {k[len("params/"):].replace("/", "."): v
            for k, v in arrays.items() if k.startswith("params/")}
    return flat, _config_from_meta(meta["model_config"])


def export_consolidated(path: str, params, out_path: Optional[str] = None
                        ) -> str:
    """Write the params as one ``a/b/c``-key f32 npz (default
    ``<path>/params.npz``; atomic). ``params`` is a dotted-name dict of
    tensors or arrays (``TrainState.params``, ``restore_params``)."""
    out_path = out_path or os.path.join(path, CONSOLIDATED_FILE)
    flat = {}
    for name, v in params.items():
        if torch.is_tensor(v):
            v = v.detach().to("cpu", torch.float32).numpy()
        flat[name.replace(".", "/")] = np.asarray(v, np.float32)
    _atomic_write(out_path, lambda f: np.savez(f, **flat), "wb")
    return out_path
