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

Not ported (ROADMAP Queue 1 item 5): the two-phase multi-host layout,
``export_param_shards`` and ``remap_data_state``.
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
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.utils import faults

_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")
STATE_FILE = "state.npz"
CONSOLIDATED_FILE = "params.npz"
# Suffix of a quarantined (failed-to-load) checkpoint directory; it no
# longer matches _STEP_DIR_RE, so every scan ignores it.
QUARANTINE_SUFFIX = ".corrupt"
_STATE_SCALARS = ("step", "opt_count", "loss_scale", "good_steps")


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
    returns the new path."""
    path = os.path.abspath(path)
    dest = path + QUARANTINE_SUFFIX
    n = 1
    while os.path.exists(dest):
        dest = f"{path}{QUARANTINE_SUFFIX}.{n}"
        n += 1
    retry_io(lambda: os.rename(path, dest), what=f"quarantine {path}")
    return dest


def gc_checkpoints(checkpoint_dir: str, keep_last_n: int) -> List[str]:
    """Delete completed checkpoints beyond the newest ``keep_last_n``
    (best effort); returns the deleted paths."""
    if keep_last_n <= 0:
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


def _commit(checkpoint_dir: str, snapshot: dict, *,
            model_config: GPTConfig, training_config: TrainingConfig,
            tokens_seen: int, data_state: Optional[dict],
            keep_last_n: int) -> str:
    """The durable half of a save, from a host snapshot
    (``TrainState.state_dict()``): ``state.npz``, then ``meta.json``, then
    GC; the fault plan's ``kill_in_save``, ``truncate_meta`` and
    ``corrupt_shard`` fire here (``utils/faults.py``)."""
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
        faults.corrupt_file(os.path.join(path, STATE_FILE))
    if keep_last_n > 0:
        gc_checkpoints(checkpoint_dir, keep_last_n)
    return path


def save_checkpoint(checkpoint_dir: str, state, *, model_config: GPTConfig,
                    training_config: TrainingConfig, tokens_seen: int = 0,
                    data_state: Optional[dict] = None,
                    keep_last_n: int = 0) -> str:
    """Write ``state`` (a ``TrainState``) as ``step_<state.step>``; returns
    its path. ``data_state`` (a loader cursor) rides in ``meta.json`` so a
    resumed run continues the data stream exactly; ``keep_last_n > 0``
    garbage-collects older complete checkpoints afterwards."""
    return _commit(checkpoint_dir, state.state_dict(),
                   model_config=model_config,
                   training_config=training_config, tokens_seen=tokens_seen,
                   data_state=data_state, keep_last_n=keep_last_n)


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
        snapshot = state.state_dict()
        path = step_dir(checkpoint_dir, int(snapshot["step"]))

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
            target=_run, name=f"ckpt-write-{snapshot['step']}", daemon=True)
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


def restore_checkpoint(path: str, trainer) -> Tuple[Any, dict]:
    """``(TrainState, meta)`` of a step dir, on ``trainer``'s device and
    bound to its model. Raises ``CheckpointIncompatibleError`` for another
    model shape or optimizer storage; a torn or corrupt state raises
    another error (``restore_latest`` quarantines those)."""
    path = os.path.abspath(path)
    meta = load_meta(path)
    _check_compatible(path, meta, trainer.model_config,
                     trainer.training_config)
    with np.load(os.path.join(path, STATE_FILE)) as z:
        sd = {k: z[k] for k in z.files}
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
    previous step is tried."""
    for _, path in reversed(list_checkpoints(checkpoint_dir)):
        try:
            state, meta = restore_checkpoint(path, trainer)
            return state, meta, path
        except CheckpointIncompatibleError:
            raise
        except Exception as e:
            if not verify:
                raise
            dest = quarantine_checkpoint(path)
            print(f"checkpoint {path} failed to load ({type(e).__name__}: "
                  f"{e}); quarantined to {dest}, falling back to the "
                  f"previous step", file=sys.stderr, flush=True)
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
    with np.load(os.path.join(path, STATE_FILE)) as z:
        flat = {k[len("params/"):].replace("/", "."): z[k]
                for k in z.files if k.startswith("params/")}
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
