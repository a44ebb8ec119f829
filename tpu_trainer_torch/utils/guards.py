"""Training guards (port of ``tpu_trainer/utils/guards.py``).

- ``check_finite`` fails fast on a non-finite loss with the step number.
- ``check_hosts_in_sync`` all-gathers every process's ``(step, loss)``
  and raises ``DivergenceError`` when they differ (the loss metric is the
  all-reduced mean, so healthy ranks agree bit for bit); at one process it
  has nothing to compare.
- ``LossSpikeError`` is what the telemetry spike detector raises; it is a
  ``FloatingPointError``, so the CLI's rollback handler takes it as it
  takes a NaN loss.
"""

from __future__ import annotations

import math

from tpu_trainer_torch.parallel import collectives
from tpu_trainer_torch.parallel import mesh as mesh_lib


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
    """Verify every process agrees on ``(step, loss)``; disagreement means
    a rank diverged (bad data sharding, a nondeterministic op, a hardware
    fault) and its collectives are corrupting the others."""
    if mesh_lib.process_count() <= 1:
        return
    allv = collectives.gather_scalars([step, loss])      # [ranks, 2]
    steps, losses = allv[:, 0], allv[:, 1]
    if not bool((steps == steps[0]).all()) or not bool(
            ((losses - losses[0]).abs() <= atol).all()):
        raise DivergenceError(
            f"cross-host divergence at step {step}: steps={steps.tolist()} "
            f"losses={losses.tolist()} (host {mesh_lib.process_index()})")
