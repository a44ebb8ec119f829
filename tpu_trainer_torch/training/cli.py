"""Training CLI (port of ``tpu_trainer/training/cli.py``): the loop
behind ``python -m tpu_trainer_torch.training.train_ddp`` and
``python -m tpu_trainer_torch.training.train_fsdp``, one process a device.

The same flag names and YAML schema as the JAX CLI (``configs/*.yaml``
load unchanged; CLI flags over YAML over the dataclass defaults).
``mode="fsdp"`` adds the JAX fsdp flags (``--sharding`` in the reference
spellings, ``--cpu_offload``, ``--offload_dtype``, ``--offload_budget_gb``,
``--no_activation_checkpointing``; activation checkpointing on by default)
and the YAML ``fsdp:`` section.

Several processes: launch under ``torchrun --nproc_per_node N`` (or set
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``; ``--multihost``
requires one of them); ``parallel/mesh.initialize_distributed`` joins the
group (NCCL on CUDA, gloo on the CPU; a process group that already
exists is kept; a group this process joined is left when the run returns).
The mesh is ``--mesh_data`` x ``--mesh_fsdp`` (ddp: every process on data;
fsdp: every process on fsdp; ``HYBRID_SHARD`` needs both flags) x
``--mesh_sequence`` (the ring: each rank runs a slice of every sequence) x
``--mesh_tensor`` (Megatron tensor parallelism) x ``--mesh_expert`` (a MoE
model's experts split over the ranks, as ``configs/moe_small.yaml``'s
``--mesh_data 2 --mesh_expert 4``); each process loads its own rows
(``Trainer.data_feed_rank``; the ranks along sequence, tensor and expert
load the same rows),
rank 0 alone prints and writes the logs, checkpoints take the two-phase
commit, and ``check_hosts_in_sync`` runs with the finite-loss guard.

- data: dummy, packed dummy, or a local text corpus (``.txt`` / ``.gz``,
  map-style or streaming, optionally packed) through the host prefetch
  thread and the device prefetcher (``data/prefetch.py``,
  ``data/device_prefetch.py``);
- held-out eval every ``eval_interval`` steps and at the end;
- crash-safe checkpoints every ``save_interval`` steps (written on a
  background thread unless ``--no_async_checkpointing``), a final one, and
  one after a crash that followed progress;
- resume: ``--resume_from``, else the latest loadable checkpoint under
  ``--checkpoint_dir`` (a corrupt one is quarantined), with the data
  cursor, so a resumed run continues bitwise;
- SIGTERM, or a polled preemption notice (``--preempt_notice``): checkpoint
  at the next step boundary and exit 143, within ``--preemption_grace_s``
  (or the notice's deadline) when one is set. At world > 1 the ranks vote
  (``mesh.global_any``) every ``--preempt_vote_interval`` steps, so one
  rank's SIGTERM makes every rank save; a noticed rank leaves a drain
  marker for the elastic supervisor (``training/elastic.py``);
- the elastic supervisor's hooks: standby parking before the rendezvous
  (``TPU_TRAINER_STANDBY_FILE``), heartbeats, and the chaos faults
  ``kill_host``, ``hang_host``, ``preempt_notice`` (on the targeted
  ranks) and ``return_host`` (rank 0 grants capacity);
- divergence rollback: a non-finite loss (checked every
  ``guard_interval`` steps) or a loss spike (``--spike_sigma``) rewinds to
  the last checkpoint, skips past the diverging batch and backs the LR off
  (a new ``Trainer``), at most ``max_rollbacks`` times;
- the run's telemetry, under the JAX CLI's JSONL schema: per-layer
  telemetry steps (``--telemetry_interval``), the goodput ledger (a
  ``goodput`` record at every log interval, telemetry step and the end),
  the crash flight recorder (``crash_report.json`` on preemption,
  rollback, divergence and crash), heartbeats when
  ``TPU_TRAINER_HEARTBEAT_DIR`` is set, a profiling window
  (``--profile_dir``), live metrics (``--metrics_port``) and the
  ``--nan_scan`` debug mode;
- weighted data mixtures (``--data_mixture``), fault injection
  (``--inject_fault``).

Each step's loss and grad norm stay on the device and are read two steps
later (``utils/telemetry.DeferredFetcher``). Every option of a later
ROADMAP entry raises ``NotImplementedError`` naming the entry by its title
(``check_supported``); none is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import signal
import time
from typing import Optional

import numpy as np
import torch

from tpu_trainer_torch.data.device_prefetch import DevicePrefetcher
from tpu_trainer_torch.models import moe as moe_lib
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.optimizer import STATE_DTYPES
from tpu_trainer_torch.training.trainer import ParallelConfig, Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt_lib
from tpu_trainer_torch.utils import faults, guards, profiling
from tpu_trainer_torch.utils import flight_recorder as flight_lib
from tpu_trainer_torch.utils import preemption as preemption_lib
from tpu_trainer_torch.utils import telemetry as telemetry_lib
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.logging import MetricLogger

_OPT_STATE_DTYPES = list(STATE_DTYPES)
_SHARDING_CHOICES = [
    "FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD",
    "zero3", "zero2", "replicated", "ddp",
]


def _require_choice(value, choices, name):
    if value not in choices:
        raise SystemExit(
            f"{name} {value!r} not supported; choose one of {choices}")
    return value


def build_parser(mode: str = "ddp") -> argparse.ArgumentParser:
    """The JAX CLI's flags of ``mode`` ("ddp" or "fsdp"; ``None``
    defaults, so CLI > YAML > defaults), with ``--device {cuda,cpu}``."""
    p = argparse.ArgumentParser(description="GPT training on one CUDA device")
    a = p.add_argument
    a("--config", type=str, default=None,
      help="YAML config (configs/*.yaml schema)")
    a("--model_size", type=str, default=None,
      choices=["small", "medium", "large", "xl"])
    a("--seq_len", type=int, default=None)
    a("--gradient_checkpointing", action="store_true", default=None)
    a("--no_flash_attention", action="store_true", default=None)
    a("--batch_size", type=int, default=None, help="micro-batch size")
    a("--max_steps", type=int, default=None)
    a("--learning_rate", type=float, default=None)
    a("--warmup_steps", type=int, default=None)
    a("--grad_accum", "--gradient_accumulation_steps", dest="grad_accum",
      type=int, default=None)
    a("--mixed_precision", type=str, default=None,
      choices=["fp32", "bf16", "fp16"])
    a("--dataset", type=str, default=None,
      choices=["dummy", "tinystories", "openwebtext"])
    a("--data_path", type=str, default=None)
    a("--max_tokens", type=int, default=None)
    a("--streaming", action="store_true", default=None)
    a("--pack_sequences", action="store_true", default=None,
      help="pack ragged documents into full rows with a segment-id "
           "channel (data/packing.py); batches are [rows, seq, 2]")
    a("--max_open_bins", type=int, default=None)
    a("--pack_strategy", type=str, default=None,
      choices=("first_fit", "best_fit"))
    a("--mask_doc_boundaries", action="store_true", default=None,
      help="streaming text: segment ids from EOS positions")
    a("--data_mixture", type=str, default=None)
    a("--cache_max_tokens", type=int, default=None)
    a("--num_workers", type=int, default=None,
      help="tokenizer thread-pool size (0 = inline)")
    a("--prefetch", "--prefetch_depth", dest="prefetch", type=int,
      default=None, help="host batches assembled ahead on a thread")
    a("--device_prefetch_depth", type=int, default=None,
      help="batches copied to the device ahead on a side stream")
    a("--no_async_checkpointing", action="store_true", default=None)
    a("--num_batches", type=int, default=None,
      help="dummy-dataset corpus size in batches")
    a("--tokenizer", type=str, default=None)
    a("--log_interval", type=int, default=None)
    a("--eval_interval", type=int, default=None)
    a("--eval_batches", type=int, default=None)
    a("--eval_split", type=float, default=None,
      help="held-out tail fraction of map-style text chunks (default 0.02)")
    a("--eval_holdout_every", type=int, default=None,
      help="streaming: every N-th line is held out for eval")
    a("--save_interval", type=int, default=None)
    a("--checkpoint_dir", type=str, default=None)
    a("--resume_from", type=str, default=None)
    a("--no_auto_resume", action="store_true", default=None)
    a("--keep_last_n", type=int, default=None)
    a("--max_rollbacks", type=int, default=None)
    a("--skip_batches_on_rollback", type=int, default=None)
    a("--rollback_lr_backoff", type=float, default=None)
    a("--inject_fault", type=str, default=None)
    a("--preemption_grace_s", type=float, default=None)
    a("--preempt_notice", type=str, default=None)
    a("--preempt_notice_poll_s", type=float, default=None)
    a("--preempt_vote_interval", type=int, default=None)
    a("--metrics_jsonl", type=str, default=None)
    a("--metrics_port", type=int, default=None)
    a("--wandb_project", type=str, default=None)
    a("--tensorboard_dir", type=str, default=None)
    a("--seed", type=int, default=None)
    a("--profile_dir", type=str, default=None)
    a("--profile_start", type=int, default=None)
    a("--profile_steps", type=int, default=None)
    a("--guard_interval", type=int, default=None,
      help="steps between finite-loss checks (default 100; 0 disables)")
    a("--telemetry_interval", type=int, default=None)
    a("--spike_sigma", type=float, default=None)
    a("--no_comms_model", action="store_true", default=None)
    a("--flight_recorder_steps", type=int, default=None)
    a("--nan_scan", action="store_true", default=None)
    a("--mesh", type=str, default=None, choices=["auto"])
    a("--hbm_gb", type=float, default=None)
    a("--mesh_data", type=int, default=None)
    a("--mesh_fsdp", type=int, default=None)
    a("--mesh_sequence", type=int, default=None)
    a("--mesh_tensor", type=int, default=None)
    a("--mesh_expert", type=int, default=None)
    a("--mesh_stage", type=int, default=None)
    a("--pipeline_microbatches", type=int, default=None)
    a("--num_experts", type=int, default=None)
    a("--moe_impl", type=str, default=None,
      choices=["capacity", "dropless"])
    a("--num_kv_heads", type=int, default=None)
    a("--optimizer_state_dtype", default=None, choices=_OPT_STATE_DTYPES)
    a("--multihost", action="store_true", default=None)
    a("--device", type=str, default=None, choices=["cuda", "cpu"],
      help="cuda (default) or cpu; without a GPU, cuda raises")
    if mode == "fsdp":
        a("--sharding", type=str, default=None, choices=_SHARDING_CHOICES)
        a("--cpu_offload", action="store_true", default=None,
          help="Adam moments in pinned host memory, streamed through "
               "each update")
        a("--offload_dtype", default=None, choices=_OPT_STATE_DTYPES,
          help="host storage of offloaded moments; bfloat16 halves the "
               "stream, int8 (blockwise absmax) quarters it")
        a("--offload_budget_gb", type=float, default=None,
          help="partial offload: GB of the largest moment leaves kept on "
               "the device (exact f32)")
        a("--no_activation_checkpointing", action="store_true",
          default=None)
    return p


# -- YAML ------------------------------------------------------------------

# The scalars of YAML 1.1 that configs use, resolved as PyYAML's
# safe_load resolves them (a bare "6e-4" has no dot and stays a string).
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
# Other YAML 1.1 int / float spellings (binary, octal, hex, sexagesimal,
# inf, nan): outside the subset, so they raise rather than parse wrong.
_YAML_OTHER_NUMBER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _yaml_error(path, lineno, msg):
    return ValueError(f"{path}:{lineno}: {msg} (the YAML reader takes "
                      f"nested mappings of scalars only)")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start, or after
    whitespace, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _yaml_scalar(text: str, path, lineno):
    if text[:1] in ("'", '"'):
        q = text[0]
        if len(text) < 2 or text[-1] != q or q in text[1:-1]:
            raise _yaml_error(path, lineno, f"unsupported quoting {text!r}")
        return text[1:-1]
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    if _YAML_OTHER_NUMBER.match(text) or text[0] in "-[]{}&*!|>%@`,?:":
        raise _yaml_error(path, lineno, f"unsupported scalar {text!r}")
    return text


def parse_yaml(text: str, path: str = "<yaml>") -> dict:
    """Parse the YAML subset of ``configs/*.yaml``: nested block mappings
    of scalars (strings, quoted strings, ints, floats, booleans, null),
    ``#`` comments and blank lines. Anything else (sequences, flow
    collections, anchors, tags, block scalars, tabs) raises ``ValueError``.
    Values equal ``yaml.safe_load``'s for that subset."""
    root: dict = {}
    stack = [(-1, root)]            # (indent, mapping)
    pending = None                  # (indent, parent, key) awaiting a block
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise _yaml_error(path, lineno, "tab character")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise _yaml_error(path, lineno, "document markers")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent and stack[-1][1] is not root:
            raise _yaml_error(path, lineno, "inconsistent indentation")
        if stack[-1][1] is root and indent != 0 and stack[-1][0] == -1:
            raise _yaml_error(path, lineno, "indented top-level key")
        mapping = stack[-1][1]
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_.\-]*):(?:\s+(.*))?$", body)
        if m is None:
            raise _yaml_error(path, lineno, f"unsupported line {body!r}")
        key, value = m.group(1), m.group(2)
        if key in mapping:
            raise _yaml_error(path, lineno, f"duplicate key {key!r}")
        if value is None or value == "":
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _yaml_scalar(value.strip(), path, lineno)
    return root


def load_yaml(path: Optional[str]) -> dict:
    if not path:
        return {}
    with open(path) as f:
        return parse_yaml(f.read(), path)


# -- configs -----------------------------------------------------------------

def _pick(*values):
    """First non-None value (CLI > YAML > default)."""
    for v in values:
        if v is not None:
            return v
    return None


def _pickf(*values) -> Optional[float]:
    """``_pick`` + float: YAML 1.1 reads a bare ``6e-4`` as a string."""
    v = _pick(*values)
    return None if v is None else float(v)


def _picki(*values) -> Optional[int]:
    v = _pick(*values)
    return None if v is None else int(v)


def _preset_from_name(name: Optional[str]) -> Optional[str]:
    """A YAML model name like ``gpt2-small`` -> its preset key."""
    if not name:
        return None
    for key in ("small", "medium", "large", "xl"):
        if key in name:
            return key
    return None


def resolve_configs(args, mode: str = "ddp"):
    """CLI flags over YAML over defaults -> ``(model_config,
    training_config, parallel_config, data_opts)``, with the JAX CLI's
    values."""
    y = load_yaml(args.config)
    y_fsdp = y.get("fsdp", {}) or {}
    y_model = y.get("model", {}) or {}
    y_train = y.get("training", {}) or {}
    y_dist = y.get("distributed", {}) or {}
    y_data = y.get("data", {}) or {}
    y_ckpt = y.get("checkpoint", {}) or {}
    y_ft = y.get("fault_tolerance", {}) or {}

    preset = _pick(args.model_size, _preset_from_name(y_model.get("name")),
                   "small")
    model_config = GPTConfig.preset(preset)
    overrides = {}
    fields = {f.name for f in dataclasses.fields(GPTConfig)}
    for key, val in y_model.items():
        if key == "name":
            continue
        if key not in fields:
            raise SystemExit(
                f"unknown model config key {key!r} in {args.config}; "
                f"valid keys: name, {', '.join(sorted(fields))}")
        overrides[key] = val
    if "hidden_size" in overrides and "intermediate_size" not in overrides:
        overrides["intermediate_size"] = None
    if args.seq_len is not None:
        overrides["max_seq_len"] = args.seq_len
    if args.num_experts is not None:
        overrides["num_experts"] = args.num_experts
    if args.moe_impl is not None:
        overrides["moe_impl"] = args.moe_impl
    if args.num_kv_heads is not None:
        overrides["num_kv_heads"] = args.num_kv_heads
    if args.gradient_checkpointing:
        overrides["gradient_checkpointing"] = True
    if mode == "fsdp":
        # Activation checkpointing on unless disabled (the reference
        # fsdp trainer's default).
        if getattr(args, "no_activation_checkpointing", None):
            overrides["gradient_checkpointing"] = False
        elif "gradient_checkpointing" not in overrides:
            overrides["gradient_checkpointing"] = True
    if args.no_flash_attention:
        overrides["use_flash_attention"] = False
    elif "use_flash_attention" not in overrides:
        overrides["use_flash_attention"] = True
    if args.pipeline_microbatches is not None:
        overrides["pipeline_microbatches"] = args.pipeline_microbatches
    model_config = dataclasses.replace(model_config, **overrides)

    d = TrainingConfig()
    training_config = TrainingConfig(
        batch_size=_picki(args.batch_size, y_train.get("batch_size"),
                          d.batch_size),
        max_seq_len=model_config.max_seq_len,
        learning_rate=_pickf(args.learning_rate,
                             y_train.get("learning_rate"), d.learning_rate),
        weight_decay=_pickf(y_train.get("weight_decay"), d.weight_decay),
        beta1=_pickf(y_train.get("beta1"), d.beta1),
        beta2=_pickf(y_train.get("beta2"), d.beta2),
        grad_clip=_pickf(y_train.get("grad_clip"), d.grad_clip),
        max_steps=_picki(args.max_steps, y_train.get("max_steps"),
                         d.max_steps),
        warmup_steps=_picki(args.warmup_steps, y_train.get("warmup_steps"),
                            d.warmup_steps),
        log_interval=_picki(args.log_interval, y_train.get("log_interval"),
                            d.log_interval),
        eval_interval=_picki(args.eval_interval,
                             y_train.get("eval_interval"), d.eval_interval),
        save_interval=_picki(args.save_interval,
                             y_train.get("save_interval"), d.save_interval),
        mixed_precision=_pick(args.mixed_precision,
                              y_dist.get("mixed_precision"),
                              y_train.get("mixed_precision"),
                              d.mixed_precision),
        optimizer_state_dtype=_require_choice(
            _pick(args.optimizer_state_dtype,
                  y_train.get("optimizer_state_dtype"),
                  d.optimizer_state_dtype),
            _OPT_STATE_DTYPES, "optimizer_state_dtype"),
        gradient_accumulation_steps=_picki(
            args.grad_accum, y_train.get("gradient_accumulation_steps"),
            d.gradient_accumulation_steps),
        checkpoint_dir=_pick(args.checkpoint_dir, y_ckpt.get("dir"),
                             d.checkpoint_dir),
        resume_from=_pick(args.resume_from, y_ckpt.get("resume_from")),
        seed=_picki(args.seed, y_train.get("seed"), d.seed),
        prefetch_depth=_picki(args.prefetch, y_data.get("prefetch"),
                              d.prefetch_depth),
        device_prefetch_depth=_picki(args.device_prefetch_depth,
                                     y_data.get("device_prefetch"),
                                     d.device_prefetch_depth),
        async_checkpointing=bool(_pick(
            False if args.no_async_checkpointing else None,
            y_ckpt.get("async"), d.async_checkpointing)),
    )

    strategy = "replicated"
    default_mesh = mesh_lib.MeshConfig(data=-1, fsdp=1)
    if mode == "fsdp":
        strategy = _require_choice(
            _pick(getattr(args, "sharding", None),
                  y_fsdp.get("sharding_strategy"), "FULL_SHARD"),
            _SHARDING_CHOICES, "sharding_strategy")
        default_mesh = mesh_lib.MeshConfig(data=1, fsdp=-1)
        if (strategy == "HYBRID_SHARD" and args.mesh_data is None
                and args.mesh_fsdp is None):
            raise SystemExit(
                "HYBRID_SHARD needs an explicit mesh split: pass --mesh_data "
                "and --mesh_fsdp (data replicas x fsdp shards). (In the "
                "reference this mode is documented but unselectable.)")
    mesh_config = mesh_lib.MeshConfig(
        data=_pick(args.mesh_data, default_mesh.data),
        fsdp=_pick(args.mesh_fsdp, default_mesh.fsdp),
        sequence=_pick(args.mesh_sequence, 1),
        tensor=_pick(args.mesh_tensor, 1),
        expert=_pick(args.mesh_expert, 1),
        stage=_pick(args.mesh_stage, 1))
    parallel_config = ParallelConfig(mesh=mesh_config)
    if mode == "fsdp":
        parallel_config = ParallelConfig(
            mesh=mesh_config, sharding_strategy=strategy,
            cpu_offload=bool(_pick(getattr(args, "cpu_offload", None),
                                   y_fsdp.get("cpu_offload"), False)),
            offload_dtype=_require_choice(
                _pick(getattr(args, "offload_dtype", None),
                      y_fsdp.get("offload_dtype"), "float32"),
                _OPT_STATE_DTYPES, "offload_dtype"),
            offload_budget_gb=_pickf(getattr(args, "offload_budget_gb",
                                             None),
                                     y_fsdp.get("offload_budget_gb"), 0.0))

    data_opts = {
        "dataset": _pick(args.dataset, y_data.get("dataset"), "dummy"),
        "data_path": _pick(args.data_path, y_data.get("path")),
        "max_tokens": _pick(args.max_tokens, y_data.get("max_tokens")),
        "streaming": bool(_pick(args.streaming, y_data.get("streaming"),
                                False)),
        "pack_sequences": bool(_pick(args.pack_sequences,
                                     y_data.get("pack_sequences"), False)),
        "max_open_bins": _picki(args.max_open_bins,
                                y_data.get("max_open_bins"), 8),
        "pack_strategy": _pick(args.pack_strategy,
                               y_data.get("pack_strategy")) or "first_fit",
        "mask_doc_boundaries": bool(_pick(args.mask_doc_boundaries,
                                          y_data.get("mask_doc_boundaries"),
                                          False)),
        "data_mixture": _pick(args.data_mixture, y_data.get("mixture")),
        "cache_max_tokens": _pick(args.cache_max_tokens,
                                  y_data.get("cache_max_tokens")),
        "num_workers": _pick(args.num_workers, y_data.get("num_workers"), 0),
        "prefetch": training_config.prefetch_depth,
        "device_prefetch": training_config.device_prefetch_depth,
        "num_batches": _pick(args.num_batches, 100),
        "tokenizer": _pick(args.tokenizer, y_data.get("tokenizer"), "gpt2"),
        "metrics_jsonl": args.metrics_jsonl,
        "metrics_port": args.metrics_port,
        "wandb_project": args.wandb_project,
        "tensorboard_dir": args.tensorboard_dir,
        "eval_batches": _pick(args.eval_batches, 8),
        "eval_split": _pick(args.eval_split, y_data.get("eval_split"), 0.02),
        "eval_holdout_every": _pick(args.eval_holdout_every,
                                    y_data.get("eval_holdout_every"), 0),
        "auto_resume": not args.no_auto_resume,
        "profile_dir": args.profile_dir,
        "profile_start": _pick(args.profile_start, 5),
        "profile_steps": _pick(args.profile_steps, 5),
        "guard_interval": _pick(args.guard_interval, 100),
        "keep_last_n": _picki(args.keep_last_n, y_ckpt.get("keep_last_n"), 0),
        "max_rollbacks": _picki(args.max_rollbacks,
                                y_ft.get("max_rollbacks"), 2),
        "skip_batches_on_rollback": _picki(
            args.skip_batches_on_rollback,
            y_ft.get("skip_batches_on_rollback"), 1),
        "rollback_lr_backoff": _pickf(args.rollback_lr_backoff,
                                      y_ft.get("rollback_lr_backoff"), 0.5),
        "inject_fault": args.inject_fault,
        "preemption_grace_s": _pickf(args.preemption_grace_s,
                                     y_ft.get("preemption_grace_s"), 0.0),
        "preempt_notice": _pick(args.preempt_notice,
                                y_ft.get("preempt_notice")),
        "preempt_notice_poll_s": _pickf(args.preempt_notice_poll_s,
                                        y_ft.get("preempt_notice_poll_s"),
                                        1.0),
        "preempt_vote_interval": _picki(args.preempt_vote_interval,
                                        y_ft.get("preempt_vote_interval"),
                                        10),
        "telemetry_interval": _picki(args.telemetry_interval, None, 0),
        "spike_sigma": _pickf(args.spike_sigma, None, 6.0),
        "nan_scan": bool(_pick(args.nan_scan, False)),
        "comms_model": not bool(_pick(args.no_comms_model, False)),
        "flight_recorder_steps": _picki(args.flight_recorder_steps,
                                        None, 256),
        "mesh_auto": args.mesh == "auto",
        "hbm_gb": args.hbm_gb,
    }
    return model_config, training_config, parallel_config, data_opts


# The ROADMAP Queue 1 entries (by title: re-anchors renumber the queue)
# that own the options this port does not run yet.
_ITEM_PLANNER = "ROADMAP Queue 1: the planner"


def check_supported(args, model_config: GPTConfig,
                    parallel_config: ParallelConfig, data_opts: dict
                    ) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP entry for every
    requested option that a later port slice brings."""
    later = [(f"--mesh_{ax} {getattr(args, f'mesh_{ax}')}", item)
             for ax, item in mesh_lib.UNPORTED_AXES.items()
             if getattr(args, f"mesh_{ax}") not in (None, 1)]
    for flag, on, item in (
            ("--mesh auto", args.mesh is not None, _ITEM_PLANNER),
            ("--hbm_gb", args.hbm_gb is not None, _ITEM_PLANNER),
            ("--no_comms_model", bool(args.no_comms_model), _ITEM_PLANNER)):
        if on:
            later.append((flag, item))
    if later:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{what} -> {item}"
                                           for what, item in later))


# -- data --------------------------------------------------------------------

def parse_mixture_spec(spec: str) -> dict:
    """``'name:weight[:path],...'`` -> ``{name: (weight, path)}``. Names must
    be distinct dataset kinds from {dummy, tinystories, openwebtext} (the
    mixture cursor keys per-source state by name)."""
    out = {}
    for part in spec.split(","):
        fields = part.strip().split(":", 2)
        if len(fields) < 2:
            raise SystemExit(f"bad --data_mixture entry {part.strip()!r}: "
                             f"expected name:weight[:path]")
        name = fields[0].strip()
        if name not in ("dummy", "tinystories", "openwebtext"):
            raise SystemExit(f"unknown mixture source {name!r}")
        if name in out:
            raise SystemExit(f"duplicate mixture source {name!r}")
        try:
            weight = float(fields[1])
        except ValueError:
            raise SystemExit(f"bad mixture weight {fields[1]!r} for source "
                             f"{name!r}") from None
        path = fields[2].strip() if len(fields) > 2 else None
        out[name] = (weight, path)
    return out


def _build_mixture(data_opts, model_config: GPTConfig, rows: int,
                   c: TrainingConfig, feed_rank: int = 0,
                   feed_world: int = 1):
    """Weighted multi-source mixture (``--data_mixture``, the JAX
    ``_build_mixture``). Every source yields the same batch shape: plain
    ``[rows, seq]``, or ``[rows, seq, 2]`` when ``--pack_sequences`` puts
    all sources (dummy included, through the synthetic ragged corpus) on
    the packed format; each source reads this process's feed shard. No
    held-out eval across a mixture."""
    from tpu_trainer_torch.data.mixture import MixtureDataLoader

    spec = parse_mixture_spec(data_opts["data_mixture"])
    pack = data_opts.get("pack_sequences")
    mask = data_opts.get("mask_doc_boundaries")
    if mask and not pack and "dummy" in spec:
        raise SystemExit(
            "--data_mixture with --mask_doc_boundaries cannot include the "
            "'dummy' source (its batches carry no segment channel, so the "
            "shapes would disagree); add --pack_sequences or drop dummy")
    strategy = data_opts.get("pack_strategy", "first_fit")
    sources, weights = {}, {}
    for idx, nm in enumerate(sorted(spec)):
        weight, path = spec[nm]
        weights[nm] = weight
        sub_seed = c.seed + 1000 * (idx + 1)   # disjoint per-source streams
        if nm == "dummy":
            if pack:
                from tpu_trainer_torch.data.packing import (
                    packed_synthetic_loader)

                sources[nm] = packed_synthetic_loader(
                    rows, c.max_seq_len, model_config.vocab_size,
                    data_opts["num_batches"], sub_seed, feed_rank,
                    feed_world, max_open_bins=data_opts["max_open_bins"],
                    strategy=strategy)
            else:
                from tpu_trainer_torch.data.dummy import (
                    create_dummy_dataloader)

                sources[nm] = create_dummy_dataloader(
                    batch_size=rows * feed_world, seq_len=c.max_seq_len,
                    vocab_size=model_config.vocab_size,
                    num_batches=data_opts["num_batches"], seed=sub_seed,
                    process_index=feed_rank, process_count=feed_world)
            continue
        if not path:
            raise SystemExit(f"mixture source {nm!r} needs a path "
                             f"('{nm}:<weight>:<path>')")
        if pack:
            opts = dict(data_opts, data_path=path, streaming=True,
                        eval_holdout_every=0)
            sources[nm], _ = _packed_text_loader(opts, rows, c.max_seq_len,
                                                 sub_seed, feed_rank,
                                                 feed_world)
        else:
            from tpu_trainer_torch.data.text import create_text_dataloader

            # Sub-loaders draw on demand (no prefetch thread racing the
            # mixture's draw order); the mixture sits behind the feed.
            sources[nm] = create_text_dataloader(
                path, batch_size=rows, seq_len=c.max_seq_len,
                tokenizer_name=data_opts["tokenizer"],
                max_tokens=data_opts["max_tokens"], streaming=True,
                cache_max_tokens=data_opts["cache_max_tokens"],
                seed=sub_seed, num_workers=data_opts["num_workers"],
                prefetch=0, tokenizer_on_fallback="error",
                mask_doc_boundaries=bool(mask), process_index=feed_rank,
                process_count=feed_world)
    return MixtureDataLoader(sources, weights, seed=c.seed), None


def _packed_text_loader(data_opts, rows, seq_len, seed, feed_rank=0,
                        feed_world=1):
    """Packed loader binning a text file's documents (this process's line
    shard) into full rows; held-out eval (streaming holdout) stays on the
    plain stream."""
    from tpu_trainer_torch.data.packing import PackedDataLoader
    from tpu_trainer_torch.data.text import (StreamingTextDataset,
                                             TextDataLoader)

    holdout_every = (data_opts["eval_holdout_every"]
                     if data_opts["streaming"] else 0)
    common = dict(tokenizer_name=data_opts["tokenizer"],
                  max_tokens=data_opts["max_tokens"],
                  cache_max_tokens=data_opts["cache_max_tokens"],
                  shard_id=feed_rank, num_shards=feed_world,
                  tokenizer_on_fallback="error")
    ds = StreamingTextDataset(
        data_opts["data_path"], seq_len,
        num_workers=data_opts["num_workers"],
        holdout=("train", holdout_every) if holdout_every else None,
        **common)
    train = PackedDataLoader(
        ds.iter_documents, rows, seq_len,
        max_open_bins=data_opts["max_open_bins"],
        strategy=data_opts.get("pack_strategy", "first_fit"), seed=seed)
    eval_loader = None
    if holdout_every:
        eval_ds = StreamingTextDataset(data_opts["data_path"], seq_len,
                                       holdout=("eval", holdout_every),
                                       **common)
        eval_loader = TextDataLoader(eval_ds, rows, seed=seed, prefetch=0,
                                     process_index=feed_rank,
                                     process_count=feed_world)
    return train, eval_loader


def build_dataloaders(data_opts, trainer: Trainer, model_config: GPTConfig):
    """Train and (optional) eval loaders of this process's ``[rows, seq]``
    (``[rows, seq, 2]`` when packing or masking document boundaries), rows
    = accum x micro-batch x its data shards; every source reads the
    trainer's feed shard (``data_feed_rank`` of ``data_feed_world``)."""
    c = trainer.training_config
    feed_rank, feed_world = trainer.data_feed_rank, trainer.data_feed_world
    rows = (c.gradient_accumulation_steps * c.batch_size * trainer.dp_size
            ) // feed_world
    if data_opts.get("data_mixture"):
        return _build_mixture(data_opts, model_config, rows, c, feed_rank,
                              feed_world)
    name = data_opts["dataset"]
    pack = data_opts.get("pack_sequences")
    if pack and name != "dummy":
        if not data_opts["data_path"]:
            raise SystemExit(f"--data_path is required for dataset {name!r}")
        return _packed_text_loader(data_opts, rows, c.max_seq_len, c.seed,
                                   feed_rank, feed_world)
    if name == "dummy":
        if pack:
            from tpu_trainer_torch.data.packing import packed_synthetic_loader

            strategy = data_opts.get("pack_strategy", "first_fit")
            return tuple(packed_synthetic_loader(
                rows, c.max_seq_len, model_config.vocab_size, n, seed,
                feed_rank, feed_world,
                max_open_bins=data_opts["max_open_bins"], strategy=strategy)
                for n, seed in ((data_opts["num_batches"], c.seed + 1234),
                                (data_opts["eval_batches"], c.seed + 4321)))
        from tpu_trainer_torch.data.dummy import create_dummy_dataloader

        return tuple(create_dummy_dataloader(
            batch_size=rows * feed_world, seq_len=c.max_seq_len,
            vocab_size=model_config.vocab_size, num_batches=n, seed=seed,
            process_index=feed_rank, process_count=feed_world)
            for n, seed in ((data_opts["num_batches"], c.seed + 1234),
                            (data_opts["eval_batches"], c.seed + 4321)))
    if name not in ("tinystories", "openwebtext"):
        raise ValueError(f"unknown dataset {name!r}")
    if not data_opts["data_path"]:
        raise SystemExit(f"--data_path is required for dataset {name!r}")
    streaming = data_opts["streaming"]
    from tpu_trainer_torch.data.text import create_text_dataloader

    train = create_text_dataloader(
        data_opts["data_path"], batch_size=rows, seq_len=c.max_seq_len,
        tokenizer_name=data_opts["tokenizer"],
        max_tokens=data_opts["max_tokens"], streaming=streaming,
        cache_max_tokens=data_opts["cache_max_tokens"], seed=c.seed,
        num_workers=data_opts["num_workers"], prefetch=data_opts["prefetch"],
        # Training never falls back to byte ids silently.
        tokenizer_on_fallback="error",
        eval_split=0.0 if streaming else data_opts["eval_split"],
        eval_holdout_every=(data_opts["eval_holdout_every"] if streaming
                            else 0),
        mask_doc_boundaries=(data_opts["mask_doc_boundaries"] if streaming
                             else False),
        process_index=feed_rank, process_count=feed_world)
    return train, train.eval_loader


# -- the run -----------------------------------------------------------------

# Steps a step's metrics stay in flight before the host reads them
# (``utils/telemetry.DeferredFetcher``): by then the device has long
# finished that step. The spike detector and the NaN guard see values this
# many steps late, which recovery (bounded by the checkpoint cadence)
# absorbs.
_DEFERRED_SYNC_WINDOW = 2


def _due(step: int, interval: int) -> bool:
    """Does a cadence of ``interval`` steps fire after ``step``?"""
    return interval > 0 and (step + 1) % interval == 0


def _nan_loss_transform(metrics: dict) -> dict:
    """Injected ``nan_loss``: applied to the fetched host copy at
    maturity."""
    return dict(metrics, loss=float("nan"))


def _loss_spike_transform(metrics: dict) -> dict:
    # Large but finite: the early-warning path must engage before anything
    # trips the NaN guard.
    return dict(metrics, loss=float(metrics["loss"]) * 8.0 + 5.0)


def _print_nan_scan(report: dict) -> None:
    first = report["first_nan"]
    print("nan_scan | " + (
        "no non-finite activations in the forward" if first is None
        else f"first non-finite value at layer {first['layer']}, site "
             f"'{first['site']}'"), flush=True)
    stats = report["stats"]
    layers = sorted({k.rsplit("/L", 1)[1] for k in stats if "/L" in k})
    for li in layers:
        row = " ".join(
            f"{site}={stats.get(f'nan_scan/act/{site}_absmax/L{li}', float('nan')):.3e}"
            for site in ("attn", "ffn", "block"))
        print(f"nan_scan | layer {li} absmax: {row}", flush=True)
    head = " ".join(
        f"{site}={stats[f'nan_scan/act/{site}_absmax']:.3e}"
        for site in ("embed_out", "final_norm", "logits")
        if f"nan_scan/act/{site}_absmax" in stats)
    print(f"nan_scan | head absmax: {head}", flush=True)
    print(f"nan_scan | loss: {stats['nan_scan/loss']:.6g}", flush=True)


def run_training(argv=None, mode: str = "ddp") -> int:
    """Train as the flags and YAML say (``mode`` "ddp" or "fsdp");
    returns the exit code (0, or 143 after a SIGTERM or preemption-notice
    save). A process that joined the process group here leaves it when
    it returns (``mesh.shutdown_distributed``, the JAX drain path's
    ``jax.distributed.shutdown``); a group its caller made is kept."""
    owned = {"group": False}
    try:
        return _run_training(argv, mode, owned)
    finally:
        if owned["group"]:
            mesh_lib.shutdown_distributed()


def _run_training(argv, mode: str, owned: dict) -> int:
    if mode not in ("ddp", "fsdp"):
        raise ValueError(f"mode {mode!r}; choose ddp or fsdp")
    args = build_parser(mode).parse_args(argv)
    model_config, training_config, parallel_config, data_opts = (
        resolve_configs(args, mode))
    check_supported(args, model_config, parallel_config, data_opts)
    # A warm spare of the elastic supervisor has paid the interpreter,
    # the imports and the parse, and parks here, before the rendezvous
    # binds its rank; promotion hands it the env a fresh child gets.
    standby_file = os.environ.get("TPU_TRAINER_STANDBY_FILE")
    if standby_file:
        from tpu_trainer_torch.training import elastic as elastic_lib

        print(f"standby: parked before rendezvous ({standby_file})",
              flush=True)
        activation = elastic_lib.hold_standby(standby_file)
        if activation is None:
            print("standby: supervisor gone; retiring unpromoted",
                  flush=True)
            return 0
        os.environ.update(activation)
        os.environ.pop("TPU_TRAINER_STANDBY_FILE", None)
        print(f"standby: promoted to rank {activation.get('PROCESS_ID')} "
              f"(world {activation.get('NUM_PROCESSES')})", flush=True)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = mesh_lib.local_device(device)
    joined = mesh_lib.process_count() > 1
    mesh_lib.initialize_distributed(auto=args.multihost, device=device)
    owned["group"] = not joined and mesh_lib.process_count() > 1
    try:
        parallel_config.mesh.resolve(mesh_lib.process_count())
    except ValueError as mesh_err:
        raise SystemExit(f"mesh: {mesh_err}") from mesh_err
    cuda = device.type == "cuda"
    trainer = Trainer(model_config, training_config, parallel_config,
                      device=device)
    main = trainer.is_main_process
    world = trainer.process_count
    tokens_per_step = trainer.tokens_per_step
    remat = (f"remat {model_config.remat_policy}"
             if model_config.gradient_checkpointing else "no remat")
    if main:
        print(f"mode={mode} strategy={parallel_config.sharding_strategy} "
              f"device={device} processes={world} mesh data x fsdp = "
              f"{trainer.mesh_sizes[0]} x {trainer.mesh_sizes[1]}"
              + (f", sequence x tensor = {trainer.mesh_sizes[2]} x "
                 f"{trainer.mesh_sizes[3]}"
                 if trainer.mesh_sizes[2] * trainer.mesh_sizes[3] > 1
                 else "")
              + (f", expert = {trainer.mesh_sizes[4]}"
                 if trainer.mesh_sizes[4] > 1 else "")
              + (f", stage = {trainer.mesh_sizes[5]}"
                 if trainer.mesh_sizes[5] > 1 else "") + " | model: "
              f"{model_config.num_parameters():,} params | batch "
              f"{training_config.gradient_accumulation_steps} x "
              f"{training_config.batch_size} seqs x "
              f"{training_config.max_seq_len} tokens a data shard | "
              f"{remat}, adam moments "
              f"{training_config.optimizer_state_dtype}"
              + (f", offloaded as {parallel_config.offload_dtype}"
                 if trainer.cpu_offload else "")
              + (f" | MoE: {moe_lib.describe(model_config,
                                             trainer.mesh_sizes[4])}"
                 if model_config.num_experts > 0 else ""), flush=True)
    sched = trainer.schedule
    if main and sched is not None:
        print(f"pipeline: {sched.kind} schedule, {sched.stages} stages, "
              f"M={sched.micro} microbatches, v={sched.virtual}, window "
              f"W={sched.window}, bubble fraction {sched.bubble:.3f}",
              flush=True)
    if main and trainer.cpu_offload and trainer.offload_resident_bytes:
        print(f"partial offload: "
              f"{trainer.offload_resident_bytes / 2**30:.2f} GB of "
              f"optimizer moments device-resident (exact f32), overflow "
              f"streams to host", flush=True)

    installed_plan = (faults.install(data_opts["inject_fault"],
                                     process_count=world)
                      if data_opts["inject_fault"] else None)
    # Goodput: every second of the run attributed to a category.
    ledger = telemetry_lib.GoodputLedger()

    state = None
    tokens_seen = 0
    data_state = None
    ckpt_dir = training_config.checkpoint_dir
    if training_config.resume_from:
        with ledger.track("checkpoint_restore"):
            state, meta = ckpt_lib.restore_checkpoint(
                training_config.resume_from, trainer)
        tokens_seen = meta.get("tokens_seen", 0)
        data_state = meta.get("data_state")
        if main:
            print(f"resumed from {training_config.resume_from} at step "
                  f"{state.step}", flush=True)
    elif data_opts["auto_resume"]:
        with ledger.track("checkpoint_restore"):
            restored = ckpt_lib.restore_latest(ckpt_dir, trainer, verify=True)
        if restored is not None:
            state, meta, path = restored
            tokens_seen = meta.get("tokens_seen", 0)
            data_state = meta.get("data_state")
            if main:
                print(f"resumed from {path} at step {state.step}",
                      flush=True)
    if state is None:
        state = trainer.init_state()

    train_loader, eval_loader = build_dataloaders(data_opts, trainer,
                                                  model_config)
    if data_state is not None and hasattr(train_loader, "load_state_dict"):
        # A checkpoint of another global batch or feed world: the cursor
        # moves onto this run's batch granularity (at least once).
        data_state, replayed = ckpt_lib.remap_data_state(
            data_state, new_global_batch_size=trainer.global_batch_size,
            new_feed_world=trainer.data_feed_world,
            new_seq_shards=trainer.mesh_sizes[2])
        if replayed and main:
            print(f"data cursor remapped for the resized mesh: replaying "
                  f"{replayed} already-seen sequences", flush=True)
        try:
            train_loader.load_state_dict(data_state)
        except ValueError as e:
            if main:
                print(f"data state not restored ({e}); reading the dataset "
                      f"from the start", flush=True)

    # Crash flight recorder: a ring of the emitted records.
    recorder = None
    if data_opts["flight_recorder_steps"] > 0:
        recorder = flight_lib.FlightRecorder(
            capacity=data_opts["flight_recorder_steps"],
            snapshot=flight_lib.env_snapshot(
                trainer=trainer, model_config=model_config,
                training_config=training_config, argv=argv))

    # Liveness beats, only when a supervisor asks for them.
    heartbeat = None
    hb_dir = os.environ.get("TPU_TRAINER_HEARTBEAT_DIR")
    if hb_dir:
        heartbeat = flight_lib.HeartbeatWriter(
            hb_dir, host=trainer.process_index,
            min_interval_s=float(
                os.environ.get("TPU_TRAINER_HEARTBEAT_INTERVAL_S", "0")),
            recorder=recorder, start_step=int(state.step))

    def dump_flight(reason: str, exc: Optional[BaseException] = None):
        """Best-effort ``crash_report.json``: never masks the failure."""
        if recorder is None:
            return
        try:
            path = recorder.dump(
                ckpt_dir, reason=reason, exc=exc,
                step=int(state.step) if state is not None else None)
            print(f"flight recorder: wrote {path} ({reason})", flush=True)
        except Exception as dump_err:
            print(f"flight recorder dump failed: {dump_err}", flush=True)

    # Live metrics: the bridge rides the logger's observer hook; with
    # --metrics_port unset none of it exists.
    metrics_server = None
    metrics_bridge = None
    if data_opts["metrics_port"] is not None:
        from tpu_trainer_torch.obs.http import MetricsServer
        from tpu_trainer_torch.obs.metrics import MetricsRegistry

        metrics_bridge = telemetry_lib.MetricsBridge(MetricsRegistry())
        metrics_server = MetricsServer(
            metrics_bridge.registry, port=data_opts["metrics_port"],
            statusz_fn=metrics_bridge.statusz)
        metrics_server.health.add_probe(
            "first_record", lambda: metrics_bridge.n_records > 0)
        print(f"metrics: serving {metrics_server.url}/metrics", flush=True)

    logger = MetricLogger(
        model_config, tokens_per_step=tokens_per_step,
        log_interval=training_config.log_interval,
        jsonl_path=data_opts["metrics_jsonl"], is_main_process=main,
        wandb_project=data_opts["wandb_project"],
        tensorboard_dir=data_opts["tensorboard_dir"],
        run_config={"model": dataclasses.asdict(model_config),
                    "training": dataclasses.asdict(training_config)},
        seq_len=training_config.max_seq_len, device=device,
        recorder=recorder, observer=metrics_bridge)
    logger.tokens_seen = tokens_seen

    if data_opts["nan_scan"]:
        # Debug mode: bisect the first non-finite site of one forward, exit
        # (every rank scans its rows; every rank gets the global report).
        try:
            report = trainer.nan_scan(state, next(iter(train_loader)))
            if main:
                _print_nan_scan(report)
            logger.log_record({
                "kind": "nan_scan", "step": int(state.step),
                "first_nan": report["first_nan"], "sites": report["sites"],
                **report["stats"]})
            return 0
        finally:
            logger.close()
            if metrics_server is not None:
                metrics_server.close()
            if installed_plan is not None:
                faults.clear()

    # SIGTERM: "at" anchors the --preemption_grace_s deadline at receipt.
    preempted = {"hit": False, "at": None}

    def _on_sigterm(signum, frame):
        preempted["hit"] = True
        if preempted["at"] is None:
            preempted["at"] = time.monotonic()

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    # The polled preemption notice arrives before the kill deadline runs;
    # a noticed run drains at the next step boundary.
    notice_source = preemption_lib.build_notice_source(
        data_opts["preempt_notice"]
        or os.environ.get("TPU_TRAINER_PREEMPT_NOTICE"),
        poll_interval_s=data_opts["preempt_notice_poll_s"])
    notice = {"rec": None}

    def check_notice(step: int) -> bool:
        """Poll the notice source and the ``preempt_notice`` fault once a
        step (sticky); logs on first receipt."""
        if notice["rec"] is not None:
            return True
        if faults.fire("preempt_notice", step) and faults.targets_host(
                trainer.process_index, trainer.process_count):
            grace = data_opts["preemption_grace_s"]
            notice["rec"] = preemption_lib.PreemptionNotice(
                source="fault:preempt_notice", received_unix=time.time(),
                deadline_unix=(time.time() + grace) if grace else None)
        elif notice_source is not None:
            notice["rec"] = notice_source.poll()
        if notice["rec"] is not None:
            remaining = notice["rec"].remaining_s()
            print(f"preemption notice received ({notice['rec'].source})"
                  + (f": {remaining:.1f}s to the kill deadline"
                     if remaining is not None else "")
                  + "; draining at the next step boundary", flush=True)
            return True
        return False

    saver = (ckpt_lib.AsyncSaver() if training_config.async_checkpointing
             else None)
    saved_step = {"step": None}
    # Set when a grace deadline left a commit running: exit without it.
    abandoned = {"commit": False}

    def drain_save(timeout: Optional[float] = None) -> bool:
        """Drain the in-flight async write; False when ``timeout`` expired
        with it still running (the daemon writer dies with the process,
        leaving the usual meta-less directory)."""
        if saver is not None and saver.in_flight:
            with ledger.track("checkpoint_commit_wait"):
                saver.wait(timeout)
            return not saver.in_flight
        if saver is not None:
            saver.wait()          # surface a finished writer's failure
        return True

    def drain_by(deadline: Optional[float], what: str) -> bool:
        """``drain_save`` within a preemption deadline; past it, leave the
        commit running (and the process exits without it)."""
        if drain_save(None if deadline is None
                      else max(0.0, deadline - time.monotonic())):
            return True
        abandoned["commit"] = True
        print(f"preemption grace expired {what}; exiting with the commit "
              f"in flight", flush=True)
        return False

    def save(tag: str = "", wait: bool = False,
             deadline: Optional[float] = None) -> None:
        if not drain_by(deadline, "draining the previous commit, before "
                                  "the final checkpoint"):
            return
        with ledger.track("checkpoint_save"):
            # The feed's cursor: the loader runs ahead of what the trainer
            # consumed by the prefetch depth.
            save_fn = (saver.save if saver is not None
                       else ckpt_lib.save_checkpoint)
            data_sd = feed.state_dict()
            if data_sd is not None:
                # Lets a restart on another mesh (an elastic reform of
                # this one) remap the cursor.
                data_sd = dict(data_sd, **trainer.feed_signature)
            path = save_fn(ckpt_dir, state, model_config=model_config,
                           training_config=training_config,
                           tokens_seen=logger.tokens_seen,
                           data_state=data_sd,
                           keep_last_n=data_opts["keep_last_n"])
        saved_step["step"] = state.step
        if wait and not drain_by(deadline, "before the final commit landed"):
            return
        if main:
            print(f"saved checkpoint{' (' + tag + ')' if tag else ''}: "
                  f"{path}", flush=True)

    eval_warned = {"hit": False}

    def run_eval() -> None:
        if eval_loader is None:
            return
        losses = []
        with ledger.track("eval"):
            for i, batch in enumerate(eval_loader):
                if i >= data_opts["eval_batches"]:
                    break
                losses.append(trainer.eval_step(state, batch))
            losses = [float(x) for x in losses]
        if losses:
            logger.log_eval(state.step, float(np.mean(losses)), len(losses))
        elif not eval_warned["hit"]:
            eval_warned["hit"] = True
            print("eval | no full eval batch (held-out rows < batch rows); "
                  "grow --eval_split / --eval_holdout_every or the dataset",
                  flush=True)

    data_iter = iter(train_loader)
    # Mixture sources, recorded at pull time: the feed pulls ahead, but in
    # consume order, so one entry a consumed batch re-aligns them.
    source_fifo = []
    source_by_step = {}

    def next_batch():
        nonlocal data_iter
        try:
            b = next(data_iter)
        except StopIteration:
            data_iter = iter(train_loader)   # a new epoch
            try:
                b = next(data_iter)
            except StopIteration:
                raise SystemExit(
                    "the dataset yields zero batches for this "
                    "configuration: it is smaller than one batch of "
                    f"{training_config.gradient_accumulation_steps * training_config.batch_size}"
                    f" sequences of {training_config.max_seq_len} tokens"
                ) from None
        src = getattr(train_loader, "last_source", None)
        if src is not None:
            source_fifo.append(src)
        return b

    def make_feed() -> DevicePrefetcher:
        # Batches buffered in a discarded feed were never consumed.
        source_fifo.clear()
        # ``place`` binds late, so a rollback's rebuilt trainer is used.
        return DevicePrefetcher(
            next_batch,
            place=lambda b: trainer.put_batch(b, non_blocking=True),
            cursor_fn=(train_loader.state_dict
                       if hasattr(train_loader, "state_dict") else None),
            depth=data_opts["device_prefetch"], device=device)

    feed = make_feed()
    profiler = profiling.WindowedTrace(
        data_opts["profile_dir"],
        start=int(state.step) + data_opts["profile_start"],
        num_steps=data_opts["profile_steps"])
    guard_interval = data_opts["guard_interval"]
    max_rollbacks = data_opts["max_rollbacks"]
    rollbacks = 0
    steps_this_run = 0
    base_lr = training_config.learning_rate
    telemetry_interval = data_opts["telemetry_interval"]
    spike = (telemetry_lib.SpikeDetector(sigma=data_opts["spike_sigma"])
             if data_opts["spike_sigma"] > 0 else None)
    deferred = telemetry_lib.DeferredFetcher(window=_DEFERRED_SYNC_WINDOW)

    def consume(entries, check: bool = True) -> None:
        """Log, spike-check and guard each matured metric entry;
        ``check=False`` (exit paths) logs without raising."""
        for mstep, mmetrics, mend in entries:
            src = source_by_step.pop(mstep, None)
            rec = logger.log(mstep, mmetrics, extra=None if src is None
                             else {"data_source": src}, now=mend)
            if not check:
                continue
            if spike is not None and rec is not None:
                is_spike, z = spike.update(rec["loss"])
                if is_spike:
                    print(f"loss spike at step {mstep}: loss "
                          f"{rec['loss']:.4f} is z={z:.1f} above the "
                          f"rolling median (sigma="
                          f"{data_opts['spike_sigma']:g}); rolling back "
                          f"before divergence", flush=True)
                    raise guards.LossSpikeError(
                        f"loss spike (z={z:.1f}) at step {mstep}")
            if guard_interval and (mstep + 1) % guard_interval == 0:
                loss = float((rec or mmetrics)["loss"])
                guards.check_finite(mstep, loss)
                guards.check_hosts_in_sync(mstep, loss)

    # Goodput: the first step of each variant (plain, telemetry) pays the
    # one-time costs (kernel build and load, first launches, allocator
    # growth) and goes to "compile"; re-covered ground after a rollback to
    # "rollback_replay". Eager PyTorch never recompiles the step and has no
    # compiler cost model, so the JAX CLI's recompile watchdog and
    # cost-analysis record have nothing to report here
    # (``trainer.RecompileWatchdog``, ``Trainer.step_cost_analysis``).
    warm = {"step": False, "telemetry": False}
    replay_until = -1
    try:
        while True:
            try:
                start_step = int(state.step)
                step = start_step
                if heartbeat is not None:
                    heartbeat.beat(start_step)
                for step in range(start_step, training_config.max_steps):
                    if faults.fire("kill", step):
                        faults.kill()
                    if faults.fire("sigterm", step):
                        os.kill(os.getpid(), signal.SIGTERM)
                    if faults.fire("kill_host", step) and faults.targets_host(
                            trainer.process_index, world):
                        # This rank dies hard; the others run on until the
                        # supervisor reforms the world.
                        faults.kill()
                    if faults.fire("hang_host", step) and faults.targets_host(
                            trainer.process_index, world):
                        # Look dead without dying: only the supervisor's
                        # heartbeat timeout catches it.
                        if heartbeat is not None:
                            heartbeat.stop()
                    if (faults.fire("return_host", step) and main
                            and int(os.environ.get("TPU_TRAINER_ATTEMPT",
                                                   "0")) > 0):
                        # The cluster re-grants a host: rank 0 plays the
                        # granting agent (live at world 1, where a shrunk
                        # run needs to grow back), after a death only.
                        cap_file = os.environ.get("TPU_TRAINER_CAPACITY_FILE")
                        if cap_file:
                            total = preemption_lib.grant_capacity(cap_file, 1)
                            print(f"fault return_host@{step}: capacity grant "
                                  f"written ({total} host(s) available)",
                                  flush=True)
                    has_notice = check_notice(step)
                    with profiler.step(step):
                        with ledger.track("data_wait"):
                            batch = feed.next()
                        if source_fifo:
                            source_by_step[step] = source_fifo.pop(0)
                        tel_step = _due(step, telemetry_interval)
                        variant = "telemetry" if tel_step else "step"
                        category = ("compile" if not warm[variant]
                                    else "rollback_replay"
                                    if step <= replay_until else "step")
                        with ledger.track(category):
                            state, metrics = trainer.train_step(
                                state, batch, telemetry=tel_step,
                                sync=False)
                            if not warm[variant]:
                                if cuda:
                                    torch.cuda.synchronize(device)
                                warm[variant] = True
                            steps_this_run += 1
                            transform = None
                            if faults.fire("nan_loss", step):
                                transform = _nan_loss_transform
                            if faults.fire("loss_spike", step):
                                transform = _loss_spike_transform
                            npf = getattr(train_loader, "non_pad_frac",
                                          None)
                            if npf is not None:
                                logger.non_pad_frac = float(npf)
                            ledger.add_tokens(
                                tokens_per_step, None if npf is None
                                else int(round(tokens_per_step * float(npf))))
                            # The matured fetches are where the host meets
                            # the device, so they stay in the tracked block.
                            consume(deferred.push(step, metrics, transform))
                    if heartbeat is not None:
                        heartbeat.beat(step + 1)
                    if tel_step or _due(step, training_config.log_interval):
                        logger.log_record(ledger.record(step=step))
                    eval_now = _due(step, training_config.eval_interval)
                    save_now = _due(step, training_config.save_interval)
                    if eval_now or save_now:
                        # Records in step order before eval's, and an exact
                        # tokens_seen in the checkpoint.
                        consume(deferred.drain())
                    if eval_now:
                        run_eval()
                    if save_now:
                        save()
                    # The save is collective: one rank's SIGTERM or notice
                    # must pull every rank in, so the ranks vote, at a
                    # cadence every rank reaches at the same step.
                    vote_now = (world == 1 or (step + 1) % max(
                        1, data_opts["preempt_vote_interval"]) == 0)
                    if vote_now and mesh_lib.global_any(
                            preempted["hit"] or has_notice):
                        proactive = not preempted["hit"]
                        if main:
                            print("proactive drain: checkpointing and "
                                  "exiting before the kill lands"
                                  if proactive else
                                  "SIGTERM received: checkpointing and "
                                  "exiting", flush=True)
                        consume(deferred.drain(), check=False)
                        grace = data_opts["preemption_grace_s"]
                        deadline = None
                        rec = notice["rec"]
                        if rec is not None and rec.deadline_unix is not None:
                            # The notice named the kill time.
                            deadline = (time.monotonic()
                                        + (rec.deadline_unix - time.time()))
                        elif grace and grace > 0:
                            deadline = (preempted["at"] or time.monotonic()
                                        ) + grace
                        if saved_step["step"] == state.step:
                            drain_by(deadline, "before the step's commit "
                                               "landed")
                        else:
                            save("preempt", wait=True, deadline=deadline)
                        if rec is not None and hb_dir:
                            # Deregister: a planned departure, not a crash.
                            flight_lib.write_drain(
                                hb_dir, trainer.process_index,
                                step=int(state.step), cause=rec.source,
                                deadline_unix=rec.deadline_unix)
                        dump_flight("preempt_notice" if proactive
                                    else "sigterm")
                        return 143
                consume(deferred.drain())
                if saved_step["step"] == state.step:
                    drain_save()
                else:
                    save("final", wait=True)
                # Skip only when the last step just ran eval.
                if not (step + 1 == training_config.max_steps
                        and _due(step, training_config.eval_interval)):
                    run_eval()
                break
            except (FloatingPointError, guards.DivergenceError) as err:
                if rollbacks >= max_rollbacks:
                    print(f"divergence persisted after {rollbacks} "
                          f"rollback(s); giving up", flush=True)
                    raise
                # Past the last consumed batch (with the deferred window,
                # up to that many batches past the one that diverged).
                failure_cursor = feed.state_dict()
                rollbacks += 1
                backoff = data_opts["rollback_lr_backoff"] ** rollbacks
                state = None      # drop the diverged tensors
                if backoff != 1.0:
                    training_config = dataclasses.replace(
                        training_config, learning_rate=base_lr * backoff)
                    trainer = Trainer(model_config, training_config,
                                      parallel_config, device=device)
                if spike is not None:
                    spike.reset()
                # Unread metrics predate the rollback: drop them.
                deferred = telemetry_lib.DeferredFetcher(
                    window=_DEFERRED_SYNC_WINDOW)
                replay_until = step
                drain_save()
                with ledger.track("checkpoint_restore"):
                    restored = ckpt_lib.restore_latest(ckpt_dir, trainer,
                                                       verify=True)
                if restored is None:
                    print("rollback impossible: no valid checkpoint to "
                          "rewind to", flush=True)
                    raise
                state, meta, ckpt_path = restored
                saved_step["step"] = state.step
                logger.tokens_seen = meta.get("tokens_seen", 0)
                skip = data_opts["skip_batches_on_rollback"]
                if hasattr(train_loader, "load_state_dict"):
                    if skip > 0 and failure_cursor is not None:
                        # Resume past the diverging batch.
                        cursor = dict(failure_cursor)
                        cursor["batch_index"] += skip - 1
                        train_loader.load_state_dict(cursor)
                    elif meta.get("data_state") is not None:
                        train_loader.load_state_dict(meta["data_state"])
                if hasattr(data_iter, "close"):
                    data_iter.close()
                data_iter = iter(train_loader)
                feed = make_feed()
                logger.log_record({
                    "kind": "rollback", "step": int(step),
                    "rollback": rollbacks, "max_rollbacks": max_rollbacks,
                    "cause": type(err).__name__,
                    "restored_step": int(state.step),
                    "lr_backoff": backoff,
                })
                dump_flight(f"rollback:{type(err).__name__}", exc=err)
                print(f"rollback {rollbacks}/{max_rollbacks}: "
                      f"{type(err).__name__} at step {step}; rewound to "
                      f"{ckpt_path} (step {state.step}), lr x {backoff:g}, "
                      f"skipping {skip} batch(es)", flush=True)
        logger.log_record(ledger.record(step=int(state.step), final=True),
                          stdout_lines=ledger.summary_lines())
    except (FloatingPointError, guards.DivergenceError) as err:
        dump_flight("divergence", exc=err)
        raise                 # poisoned state: never crash-save it
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as err:
        dump_flight("crash", exc=err)
        # Crash checkpoint, only after progress in this run.
        if steps_this_run >= 1 and state is not None:
            try:
                save("crash", wait=True)
            except Exception as save_err:
                print(f"crash checkpoint failed: {save_err}", flush=True)
        raise
    finally:
        if saver is not None and saver.in_flight and not abandoned["commit"]:
            try:
                drain_save()
            except Exception as commit_err:
                print(f"async checkpoint write failed: {commit_err}",
                      flush=True)
        signal.signal(signal.SIGTERM, old_handler)
        profiler.close()
        logger.close()
        if metrics_server is not None:
            metrics_server.close()
        if installed_plan is not None:
            faults.clear()
    if main:
        print(f"done: {steps_this_run} steps this run, "
              f"{logger.tokens_seen:,} tokens total", flush=True)
    return 0
