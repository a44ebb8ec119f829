"""Training guards (port of ``tpu_trainer/utils/guards.py``; the
single-host check only — the cross-host check waits for multi-GPU)."""

from __future__ import annotations

import math


def check_finite(step: int, loss: float) -> None:
    """Raise if the loss is NaN/Inf (bf16/fp32 paths have no loss scaler to
    absorb it; with fp16 the scaler skips the step before this sees it)."""
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss {loss} at step {step}: check data, learning "
            f"rate, or use mixed_precision=bf16 (fp16 requires loss scaling)")
