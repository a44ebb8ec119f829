"""Training guards (port of ``tpu_trainer/utils/guards.py``).

- ``check_finite`` fails fast on a non-finite loss with the step number.
- ``check_hosts_in_sync`` compares every process's ``(step, loss)``; the
  port runs one process, where it has nothing to compare (the
  multi-process check comes with ROADMAP Queue 1 item 5).
- ``LossSpikeError`` is what the telemetry spike detector raises; it is a
  ``FloatingPointError``, so the CLI's rollback handler takes it as it
  takes a NaN loss.
"""

from __future__ import annotations

import math


class DivergenceError(RuntimeError):
    pass


class LossSpikeError(FloatingPointError):
    """Loss-spike early warning (``utils/telemetry.SpikeDetector``
    tripped): routed into the same restore-and-back-off path as a NaN
    loss, while the checkpointed state is still healthy."""


def check_finite(step: int, loss: float) -> None:
    """Raise if the loss is NaN/Inf (bf16/fp32 paths have no loss scaler to
    absorb it; with fp16 the scaler skips the step before this sees it)."""
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss {loss} at step {step}: check data, learning "
            f"rate, or use mixed_precision=bf16 (fp16 requires loss scaling)")


def check_hosts_in_sync(step: int, loss: float, atol: float = 0.0) -> None:
    """Verify every process agrees on ``(step, loss)``: a no-op, as the
    JAX one is at one process (the port runs one)."""
