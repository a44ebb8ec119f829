"""Training metrics (port of ``tpu_trainer/utils/logging.py``):
``flops_per_token`` and ``mfu`` with peaks keyed on CUDA device names, and
``MetricLogger``, the step/eval record writer of the training CLI.

``MetricLogger``'s JSONL records keep the JAX package's field names and
``kind`` values (``train``, ``eval``, and pre-built records such as
``rollback``), so the run analyzer (``tools/analyze.py``, either
package's) reads a port run. The W&B and TensorBoard sinks are
import-guarded: a missing package is a warning. ``recorder=`` (the crash
flight recorder) and ``observer=`` (the live-metrics bridge) see every
record the sinks see.
"""

from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import IO, Callable, Optional

import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.utils import telemetry as telemetry_lib
from tpu_trainer_torch.utils.schema import SCHEMA_VERSION

# Peak dense bf16 tensor-core FLOP/s by CUDA device name (substring,
# case-insensitive), from NVIDIA's H100 data sheet (dense, no sparsity):
# H100 SXM 989 TFLOP/s, H100 PCIe 756 TFLOP/s. Checked in order.
_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),        # "NVIDIA H100 80GB HBM3" (SXM)
)


def peak_flops_for_name(device_name: str) -> float:
    """Peak dense bf16 FLOP/s for a CUDA device name; raises for a card
    without a known peak (an MFU against a guessed peak is no number)."""
    name = (device_name or "").lower()
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    raise ValueError(f"no peak FLOP/s known for device {device_name!r}")


def flops_per_token(config: GPTConfig, seq_len: Optional[int] = None
                    ) -> float:
    """Training FLOPs per token: 6*N (N active parameters, fwd + bwd) plus
    12*L*S*H for the attention score/value products (full S^2, not halved
    for causality)."""
    s = seq_len if seq_len else config.max_seq_len
    attn = 12 * config.num_layers * s * config.hidden_size
    return 6.0 * config.num_active_parameters() + attn


def mfu(tokens_per_sec: float, config: GPTConfig, *, peak_flops: float,
        n_devices: int = 1, seq_len: Optional[int] = None) -> float:
    """Model FLOPs utilization: achieved model FLOP/s over peak FLOP/s."""
    return (tokens_per_sec * flops_per_token(config, seq_len)
            / (n_devices * peak_flops))


class MetricLogger:
    """Step-metrics logger with windowed rates and pluggable sinks.

    ``log(step, metrics)`` counts a step's tokens and emits a ``train``
    record every ``log_interval`` steps: loss, lr, grad norm, tokens seen,
    tokens/s over the window since the last record, MFU against the
    card's peak (CUDA only), and the peak device memory. The window's
    edges are the steps' ends: given as ``now`` (the training CLI's
    deferred fetch), else read after a synchronize, so the rate counts
    finished work. A ``metrics["telemetry"]`` subtree
    forces a record whatever the interval and is flattened into
    ``telemetry/*`` scalars. ``recorder`` and ``observer`` (anything with
    ``observe(record)``) see every record written.
    """

    def __init__(self, model_config: Optional[GPTConfig] = None, *,
                 tokens_per_step: int = 0, log_interval: int = 1,
                 jsonl_path: Optional[str] = None, stdout: bool = True,
                 is_main_process: Optional[bool] = None,
                 wandb_project: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 run_config: Optional[dict] = None,
                 seq_len: Optional[int] = None, device=None,
                 recorder=None, observer=None):
        self._recorder = recorder
        self._observer = observer
        self.model_config = model_config
        self.tokens_per_step = tokens_per_step
        self.seq_len = seq_len
        self.log_interval = max(1, log_interval)
        self._chips = mesh_lib.process_count()
        # Rank 0 alone prints and writes every sink (default: this
        # process's rank).
        self.is_main = (is_main_process if is_main_process is not None
                        else mesh_lib.process_index() == 0)
        self.stdout = stdout and self.is_main
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._sync: Callable[[], None] = (
            (lambda: torch.cuda.synchronize(dev)) if self._cuda
            else (lambda: None))
        self._peak = (peak_flops_for_name(torch.cuda.get_device_name(dev))
                      if self._cuda else None)
        self._jsonl: Optional[IO[str]] = None
        if jsonl_path and self.is_main:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._jsonl = open(jsonl_path, "a", buffering=1)
        self._wandb = None
        if wandb_project and self.is_main:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project,
                                         config=run_config or {})
            except Exception as e:
                warnings.warn(f"wandb sink disabled: {type(e).__name__}: {e}")
        self._tb = None
        if tensorboard_dir and self.is_main:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:
                warnings.warn(
                    f"tensorboard sink disabled: {type(e).__name__}: {e}")
        self.tokens_seen = 0
        # Non-pad token fraction of the batches fed (sequence packing); None
        # leaves the effective-throughput fields out.
        self.non_pad_frac: Optional[float] = None
        self._t0 = time.perf_counter()
        self._window_t = self._t0
        self._window_tokens = 0

    def log(self, step: int, metrics: dict, extra: Optional[dict] = None,
            now: Optional[float] = None) -> Optional[dict]:
        """Record one step; emit (and return) a record every
        ``log_interval`` steps. ``now`` is when the step finished on the
        ``time.perf_counter`` clock (a deferred fetch knows it: see
        ``utils/telemetry.DeferredFetcher``); without it the record waits
        for the device and reads the clock."""
        self.tokens_seen += self.tokens_per_step
        self._window_tokens += self.tokens_per_step
        if (step + 1) % self.log_interval != 0 and "telemetry" not in metrics:
            return None
        if now is None:
            self._sync()
            now = time.perf_counter()
        window_s = max(now - self._window_t, 1e-9)
        tok_per_sec = self._window_tokens / window_s
        record = {
            "kind": "train",
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "loss": float(metrics.get("loss", float("nan"))),
            "lr": float(metrics.get("lr", 0.0)),
            "grad_norm": float(metrics.get("grad_norm", 0.0)),
            "tokens_seen": int(self.tokens_seen),
            "tokens_per_sec": round(tok_per_sec, 1),
            "tokens_per_sec_per_chip": round(tok_per_sec / self._chips, 1),
            "elapsed_s": round(now - self._t0, 3),
        }
        if self.non_pad_frac is not None:
            record["non_pad_frac"] = round(float(self.non_pad_frac), 4)
            record["effective_tokens_per_sec"] = round(
                tok_per_sec * float(self.non_pad_frac), 1)
        if self.model_config is not None and self._peak is not None:
            record["mfu"] = round(mfu(tok_per_sec / self._chips,
                                      self.model_config,
                                      peak_flops=self._peak,
                                      seq_len=self.seq_len), 4)
        if self._cuda:
            record["peak_mem_gb"] = round(
                torch.cuda.max_memory_allocated() / 2**30, 3)
        if "telemetry" in metrics:
            record.update(telemetry_lib.flatten_scalars(metrics["telemetry"]))
        if extra:
            record.update(extra)
        self._window_t = now
        self._window_tokens = 0
        if self.stdout:
            parts = [f"step {record['step']:>6d}",
                     f"loss {record['loss']:.4f}", f"lr {record['lr']:.2e}",
                     f"{record['tokens_per_sec']:,.0f} tok/s"]
            if "effective_tokens_per_sec" in record:
                parts.append(
                    f"{record['effective_tokens_per_sec']:,.0f} eff tok/s")
            if "mfu" in record:
                parts.append(f"mfu {record['mfu']:.1%}")
            if "peak_mem_gb" in record:
                parts.append(f"mem {record['peak_mem_gb']:.2f}GB")
            print(" | ".join(parts), flush=True)
        self._write(record)
        self._emit_scalars(record["step"], {
            k: v for k, v in record.items()
            if isinstance(v, (int, float)) and k != "step"}, prefix="train")
        return record

    def log_eval(self, step: int, eval_loss: float, n_batches: int,
                 extra: Optional[dict] = None) -> dict:
        """Held-out eval record: loss and perplexity (exp clamped)."""
        record = {
            "kind": "eval",
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "eval_loss": float(eval_loss),
            "perplexity": round(math.exp(min(float(eval_loss), 30.0)), 4),
            "eval_batches": int(n_batches),
        }
        if extra:
            record.update(extra)
        if self.stdout:
            print(f"eval | step {record['step']:>6d} | "
                  f"loss {record['eval_loss']:.4f} | "
                  f"ppl {record['perplexity']:.2f} ({n_batches} batches)",
                  flush=True)
        self._write(record)
        self._emit_scalars(record["step"], {
            "loss": record["eval_loss"], "perplexity": record["perplexity"],
        }, prefix="eval")
        return record

    def log_record(self, record: dict, stdout_lines=None) -> dict:
        """Write a pre-built record (``kind`` already set) to the sinks;
        ``stdout_lines`` are its console form."""
        record.setdefault("schema_version", SCHEMA_VERSION)
        if self.stdout and stdout_lines:
            for line in stdout_lines:
                print(line, flush=True)
        self._write(record)
        step = record.get("step")
        if step is not None:
            self._emit_scalars(int(step), {
                k: v for k, v in record.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                and k != "step"}, prefix=str(record.get("kind", "misc")))
        return record

    def _write(self, record: dict) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
        if self._recorder is not None:
            self._recorder.observe(record)
        if self._observer is not None:
            self._observer.observe(record)

    def _emit_scalars(self, step: int, scalars: dict, prefix: str) -> None:
        if self._wandb is not None:
            self._wandb.log({f"{prefix}/{k}": v for k, v in scalars.items()},
                            step=step)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
