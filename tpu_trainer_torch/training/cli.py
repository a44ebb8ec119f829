"""Training CLI (port of ``tpu_trainer/training/cli.py``): the
single-process loop behind ``python -m tpu_trainer_torch.training.train_ddp``
and ``python -m tpu_trainer_torch.training.train_fsdp``.

The same flag names and YAML schema as the JAX CLI (``configs/*.yaml``
load unchanged; CLI flags over YAML over the dataclass defaults), on one
device. ``mode="fsdp"`` adds the JAX fsdp flags (``--sharding`` in the
reference spellings, ``--cpu_offload``, ``--offload_dtype``,
``--offload_budget_gb``, ``--no_activation_checkpointing``; activation
checkpointing on by default) and the YAML ``fsdp:`` section; at one
process every sharding strategy is the ddp step, and the strategy only
shows in the startup line.

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
- SIGTERM: checkpoint at the next step boundary and exit 143;
- divergence rollback: a non-finite loss (checked every
  ``guard_interval`` steps) rewinds to the last checkpoint, skips past the
  diverging batch and backs the LR off (a new ``Trainer``), at most
  ``max_rollbacks`` times.

Every option of a later ROADMAP item raises ``NotImplementedError``
naming the item (``check_supported``); none is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import signal
from typing import Optional

import numpy as np

from tpu_trainer_torch.data.device_prefetch import DevicePrefetcher
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.optimizer import STATE_DTYPES
from tpu_trainer_torch.training.trainer import ParallelConfig, Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt_lib
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.guards import check_finite
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

    parallel_config = ParallelConfig()
    if mode == "fsdp":
        parallel_config = ParallelConfig(
            sharding_strategy=_require_choice(
                _pick(getattr(args, "sharding", None),
                      y_fsdp.get("sharding_strategy"), "FULL_SHARD"),
                _SHARDING_CHOICES, "sharding_strategy"),
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


# ROADMAP Queue 1 items that own the options this port does not run yet.
_ITEM_RUN = "ROADMAP Queue 1 item 4 (fault injection, elastic training, " \
            "telemetry, profiling, mixtures)"
_ITEM_MESH = "ROADMAP Queue 1 item 5 (multi-GPU parallelism)"
_ITEM_MOE = "ROADMAP Queue 1 item 8 (the rest of MoE)"


def check_supported(args, model_config: GPTConfig,
                    parallel_config: ParallelConfig, data_opts: dict
                    ) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for every
    requested option that a later port slice brings."""
    later = []
    mesh_flags = [f"--mesh_{a}" for a in ("data", "fsdp", "sequence",
                                          "tensor", "expert", "stage")
                  if getattr(args, f"mesh_{a}") not in (None, 1)]
    if args.mesh is not None:
        mesh_flags.append("--mesh")
    for flag, on in (("--hbm_gb", args.hbm_gb is not None),
                     ("--multihost", bool(args.multihost)),
                     ("--pipeline_microbatches",
                      model_config.pipeline_microbatches > 0),
                     ("--no_comms_model", bool(args.no_comms_model))):
        if on:
            mesh_flags.append(flag)
    if parallel_config.sharding_strategy == "HYBRID_SHARD":
        mesh_flags.append("HYBRID_SHARD (data replicas x fsdp shards)")
    if mesh_flags:
        later.append((", ".join(mesh_flags), _ITEM_MESH))
    if model_config.num_experts > 0 and model_config.moe_impl == "capacity":
        later.append(('moe_impl="capacity" (use --moe_impl dropless)',
                      _ITEM_MOE))
    run_flags = [flag for flag, on in (
        ("--data_mixture", data_opts["data_mixture"] is not None),
        ("--inject_fault", data_opts["inject_fault"] is not None),
        ("--telemetry_interval", args.telemetry_interval is not None),
        ("--spike_sigma", args.spike_sigma is not None),
        ("--flight_recorder_steps", args.flight_recorder_steps is not None),
        ("--nan_scan", data_opts["nan_scan"]),
        ("--profile_dir", data_opts["profile_dir"] is not None),
        ("--profile_start", args.profile_start is not None),
        ("--profile_steps", args.profile_steps is not None),
        ("--metrics_port", data_opts["metrics_port"] is not None),
        ("--preempt_notice", data_opts["preempt_notice"] is not None),
        ("--preempt_notice_poll_s", args.preempt_notice_poll_s is not None),
        ("--preempt_vote_interval", args.preempt_vote_interval is not None),
        ("--preemption_grace_s", data_opts["preemption_grace_s"] > 0),
        ("TPU_TRAINER_HEARTBEAT_DIR (heartbeats)",
         bool(os.environ.get("TPU_TRAINER_HEARTBEAT_DIR"))),
        ("TPU_TRAINER_STANDBY_FILE (elastic standby)",
         bool(os.environ.get("TPU_TRAINER_STANDBY_FILE"))),
        ("TPU_TRAINER_PREEMPT_NOTICE",
         bool(os.environ.get("TPU_TRAINER_PREEMPT_NOTICE"))),
    ) if on]
    if run_flags:
        later.append((", ".join(run_flags), _ITEM_RUN))
    if later:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(f"{what} -> {item}"
                                           for what, item in later))


# -- data --------------------------------------------------------------------

def _packed_text_loader(data_opts, rows, seq_len, seed):
    """Packed loader binning a text file's documents (lines) into full
    rows; held-out eval (streaming holdout) stays on the plain stream."""
    from tpu_trainer_torch.data.packing import PackedDataLoader
    from tpu_trainer_torch.data.text import (StreamingTextDataset,
                                             TextDataLoader)

    holdout_every = (data_opts["eval_holdout_every"]
                     if data_opts["streaming"] else 0)
    common = dict(tokenizer_name=data_opts["tokenizer"],
                  max_tokens=data_opts["max_tokens"],
                  cache_max_tokens=data_opts["cache_max_tokens"],
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
        eval_loader = TextDataLoader(eval_ds, rows, seed=seed, prefetch=0)
    return train, eval_loader


def build_dataloaders(data_opts, trainer: Trainer, model_config: GPTConfig):
    """Train and (optional) eval loaders of ``[rows, seq]`` (``[rows, seq,
    2]`` when packing or masking document boundaries), rows = accum x
    micro-batch."""
    c = trainer.training_config
    rows = c.gradient_accumulation_steps * c.batch_size
    name = data_opts["dataset"]
    pack = data_opts.get("pack_sequences")
    if pack and name != "dummy":
        if not data_opts["data_path"]:
            raise SystemExit(f"--data_path is required for dataset {name!r}")
        return _packed_text_loader(data_opts, rows, c.max_seq_len, c.seed)
    if name == "dummy":
        if pack:
            from tpu_trainer_torch.data.packing import packed_synthetic_loader

            strategy = data_opts.get("pack_strategy", "first_fit")
            return tuple(packed_synthetic_loader(
                rows, c.max_seq_len, model_config.vocab_size, n, seed,
                max_open_bins=data_opts["max_open_bins"], strategy=strategy)
                for n, seed in ((data_opts["num_batches"], c.seed + 1234),
                                (data_opts["eval_batches"], c.seed + 4321)))
        from tpu_trainer_torch.data.dummy import create_dummy_dataloader

        return tuple(create_dummy_dataloader(
            batch_size=rows, seq_len=c.max_seq_len,
            vocab_size=model_config.vocab_size, num_batches=n, seed=seed)
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
                             else False))
    return train, train.eval_loader


# -- the run -----------------------------------------------------------------

def _due(step: int, interval: int) -> bool:
    """Does a cadence of ``interval`` steps fire after ``step``?"""
    return interval > 0 and (step + 1) % interval == 0


def run_training(argv=None, mode: str = "ddp") -> int:
    """Train as the flags and YAML say (``mode`` "ddp" or "fsdp");
    returns the exit code (0, or 143 after a SIGTERM save)."""
    if mode not in ("ddp", "fsdp"):
        raise ValueError(f"mode {mode!r}; choose ddp or fsdp")
    args = build_parser(mode).parse_args(argv)
    model_config, training_config, parallel_config, data_opts = (
        resolve_configs(args, mode))
    check_supported(args, model_config, parallel_config, data_opts)
    device = resolve_device(args.device)
    trainer = Trainer(model_config, training_config, parallel_config,
                      device=device)
    tokens_per_step = (training_config.gradient_accumulation_steps
                       * training_config.batch_size
                       * training_config.max_seq_len)
    remat = (f"remat {model_config.remat_policy}"
             if model_config.gradient_checkpointing else "no remat")
    print(f"mode={mode} strategy={parallel_config.sharding_strategy} "
          f"device={device} | model: "
          f"{model_config.num_parameters():,} params | batch "
          f"{training_config.gradient_accumulation_steps} x "
          f"{training_config.batch_size} seqs x "
          f"{training_config.max_seq_len} tokens | {remat}, adam moments "
          f"{training_config.optimizer_state_dtype}"
          + (f", offloaded as {parallel_config.offload_dtype}"
             if trainer.cpu_offload else ""), flush=True)
    if trainer.cpu_offload and trainer.offload_resident_bytes:
        print(f"partial offload: "
              f"{trainer.offload_resident_bytes / 2**30:.2f} GB of "
              f"optimizer moments device-resident (exact f32), overflow "
              f"streams to host", flush=True)

    state = None
    tokens_seen = 0
    data_state = None
    ckpt_dir = training_config.checkpoint_dir
    if training_config.resume_from:
        state, meta = ckpt_lib.restore_checkpoint(
            training_config.resume_from, trainer)
        tokens_seen = meta.get("tokens_seen", 0)
        data_state = meta.get("data_state")
        print(f"resumed from {training_config.resume_from} at step "
              f"{state.step}", flush=True)
    elif data_opts["auto_resume"]:
        restored = ckpt_lib.restore_latest(ckpt_dir, trainer, verify=True)
        if restored is not None:
            state, meta, path = restored
            tokens_seen = meta.get("tokens_seen", 0)
            data_state = meta.get("data_state")
            print(f"resumed from {path} at step {state.step}", flush=True)
    if state is None:
        state = trainer.init_state()

    train_loader, eval_loader = build_dataloaders(data_opts, trainer,
                                                  model_config)
    if data_state is not None and hasattr(train_loader, "load_state_dict"):
        try:
            train_loader.load_state_dict(data_state)
        except ValueError as e:
            print(f"data state not restored ({e}); reading the dataset "
                  f"from the start", flush=True)

    logger = MetricLogger(
        model_config, tokens_per_step=tokens_per_step,
        log_interval=training_config.log_interval,
        jsonl_path=data_opts["metrics_jsonl"],
        wandb_project=data_opts["wandb_project"],
        tensorboard_dir=data_opts["tensorboard_dir"],
        run_config={"model": dataclasses.asdict(model_config),
                    "training": dataclasses.asdict(training_config)},
        seq_len=training_config.max_seq_len, device=device)
    logger.tokens_seen = tokens_seen

    preempted = {"hit": False}

    def _on_sigterm(signum, frame):
        preempted["hit"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    saver = (ckpt_lib.AsyncSaver() if training_config.async_checkpointing
             else None)
    saved_step = {"step": None}

    def drain_save() -> None:
        if saver is not None:
            saver.wait()

    def save(tag: str = "", wait: bool = False) -> None:
        drain_save()
        # The feed's cursor: the loader runs ahead of what the trainer
        # consumed by the prefetch depth.
        save_fn = (saver.save if saver is not None
                   else ckpt_lib.save_checkpoint)
        path = save_fn(ckpt_dir, state, model_config=model_config,
                       training_config=training_config,
                       tokens_seen=logger.tokens_seen,
                       data_state=feed.state_dict(),
                       keep_last_n=data_opts["keep_last_n"])
        saved_step["step"] = state.step
        if wait:
            drain_save()
        print(f"saved checkpoint{' (' + tag + ')' if tag else ''}: {path}",
              flush=True)

    eval_warned = {"hit": False}

    def run_eval() -> None:
        if eval_loader is None:
            return
        losses = []
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

    def next_batch():
        nonlocal data_iter
        try:
            return next(data_iter)
        except StopIteration:
            data_iter = iter(train_loader)   # a new epoch
            try:
                return next(data_iter)
            except StopIteration:
                raise SystemExit(
                    "the dataset yields zero batches for this "
                    "configuration: it is smaller than one batch of "
                    f"{training_config.gradient_accumulation_steps * training_config.batch_size}"
                    f" sequences of {training_config.max_seq_len} tokens"
                ) from None

    def make_feed() -> DevicePrefetcher:
        # ``place`` binds late, so a rollback's rebuilt trainer is used.
        return DevicePrefetcher(
            next_batch,
            place=lambda b: trainer.put_batch(b, non_blocking=True),
            cursor_fn=(train_loader.state_dict
                       if hasattr(train_loader, "state_dict") else None),
            depth=data_opts["device_prefetch"], device=device)

    feed = make_feed()
    guard_interval = data_opts["guard_interval"]
    max_rollbacks = data_opts["max_rollbacks"]
    rollbacks = 0
    steps_this_run = 0
    base_lr = training_config.learning_rate
    try:
        while True:
            try:
                step = state.step
                for step in range(state.step, training_config.max_steps):
                    batch = feed.next()
                    state, metrics = trainer.train_step(state, batch)
                    steps_this_run += 1
                    npf = getattr(train_loader, "non_pad_frac", None)
                    if npf is not None:
                        logger.non_pad_frac = float(npf)
                    rec = logger.log(step, metrics)
                    if guard_interval and (step + 1) % guard_interval == 0:
                        check_finite(step, (rec or metrics)["loss"])
                    if _due(step, training_config.eval_interval):
                        run_eval()
                    if _due(step, training_config.save_interval):
                        save()
                    if preempted["hit"]:
                        print("SIGTERM received: checkpointing and exiting",
                              flush=True)
                        if saved_step["step"] == state.step:
                            drain_save()
                        else:
                            save("preempt", wait=True)
                        return 143
                if saved_step["step"] == state.step:
                    drain_save()
                else:
                    save("final", wait=True)
                # Skip only when the last step just ran eval.
                if not (step + 1 == training_config.max_steps
                        and _due(step, training_config.eval_interval)):
                    run_eval()
                break
            except FloatingPointError as err:
                if rollbacks >= max_rollbacks:
                    print(f"divergence persisted after {rollbacks} "
                          f"rollback(s); giving up", flush=True)
                    raise
                failure_cursor = feed.state_dict()
                rollbacks += 1
                backoff = data_opts["rollback_lr_backoff"] ** rollbacks
                state = None      # drop the diverged tensors
                if backoff != 1.0:
                    training_config = dataclasses.replace(
                        training_config, learning_rate=base_lr * backoff)
                    trainer = Trainer(model_config, training_config,
                                      parallel_config, device=device)
                drain_save()
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
                print(f"rollback {rollbacks}/{max_rollbacks}: "
                      f"{type(err).__name__} at step {step}; rewound to "
                      f"{ckpt_path} (step {state.step}), lr x {backoff:g}, "
                      f"skipping {skip} batch(es)", flush=True)
    except FloatingPointError:
        raise                 # poisoned state: never crash-save it
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        # Crash checkpoint, only after progress in this run.
        if steps_this_run >= 1 and state is not None:
            try:
                save("crash", wait=True)
            except Exception as save_err:
                print(f"crash checkpoint failed: {save_err}", flush=True)
        raise
    finally:
        if saver is not None and saver.in_flight:
            try:
                drain_save()
            except Exception as commit_err:
                print(f"async checkpoint write failed: {commit_err}",
                      flush=True)
        signal.signal(signal.SIGTERM, old_handler)
        logger.close()
    print(f"done: {steps_this_run} steps this run, "
          f"{logger.tokens_seen:,} tokens total", flush=True)
    return 0
