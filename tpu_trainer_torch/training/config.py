"""Training configuration and LR schedule (port of
``tpu_trainer/training/config.py``).

The fields the port reads, with the JAX ``TrainingConfig``'s names and
defaults; ``lr_at`` is the same linear-warmup -> cosine-to-10%-of-peak
schedule, clamped past ``max_steps``, in plain Python floats (the step
counter is a host int). ``carry_cast_params`` (a JAX step-layout knob) has
no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Single-device training configuration."""

    # Data
    batch_size: int = 8           # micro-batch size
    max_seq_len: int = 1024

    # Optimization
    learning_rate: float = 6e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0

    # Schedule
    max_steps: int = 10000
    warmup_steps: int = 1000
    log_interval: int = 1
    eval_interval: int = 500
    save_interval: int = 1000

    # Mixed precision: "fp32" | "bf16" | "fp16"
    mixed_precision: str = "bf16"

    # Adam moment storage of the large leaves: "float32", "bfloat16" or
    # "int8" (``training/optimizer.py``).
    optimizer_state_dtype: str = "float32"

    gradient_accumulation_steps: int = 4

    # Step overlap: host batches assembled ahead on the Prefetcher thread
    # (0 = synchronous); batches copied to the device ahead on a side
    # stream (0 = placed inside the step); interval checkpoints copied to
    # host memory and written on a background thread.
    prefetch_depth: int = 2
    device_prefetch_depth: int = 2
    async_checkpointing: bool = True

    # Checkpointing: the training CLI restores ``resume_from`` when set,
    # else the latest checkpoint under ``checkpoint_dir``.
    checkpoint_dir: str = "checkpoints"
    resume_from: Optional[str] = None

    # RNG: parameter init and the dropout-seed generator.
    seed: int = 0

    @property
    def min_lr(self) -> float:
        return 0.1 * self.learning_rate

    def lr_at(self, step: int) -> float:
        """LR as a pure function of the step."""
        step = float(step)
        peak = self.learning_rate
        if step < self.warmup_steps:
            return peak * step / max(1, self.warmup_steps)
        decay_steps = max(1, self.max_steps - self.warmup_steps)
        ratio = min(max((step - self.warmup_steps) / decay_steps, 0.0), 1.0)
        coeff = 0.5 * (1.0 + math.cos(math.pi * ratio))
        return self.min_lr + coeff * (peak - self.min_lr)
