"""Training configuration and LR schedule (port of
``tpu_trainer/training/config.py``).

The fields this slice reads, with the JAX ``TrainingConfig``'s names and
defaults; ``lr_at`` is the same linear-warmup -> cosine-to-10%-of-peak
schedule, clamped past ``max_steps``, in plain Python floats (the step
counter is a host int). The JAX config's logging, evaluation, prefetch
and checkpoint fields come with the slice that reads them (ROADMAP
Queue 1).
"""

from __future__ import annotations

import dataclasses
import math


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

    # Mixed precision: "fp32" | "bf16" | "fp16"
    mixed_precision: str = "bf16"

    # Adam moment storage. Only "float32" is ported; "bfloat16" / "int8"
    # raise (ROADMAP Queue 1).
    optimizer_state_dtype: str = "float32"

    gradient_accumulation_steps: int = 4

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
