"""Profiling (port of ``tpu_trainer/utils/profiling.py``) on
``torch.profiler``.

- ``trace(dir)`` — context manager capturing a ``torch.profiler`` trace of
  the host and, on a CUDA machine, the device (CUPTI kernel events) for
  the duration of the block.
- ``WindowedTrace(dir, start, num_steps)`` — the step-driven window the
  training CLI opens with ``--profile_dir`` / ``--profile_start`` /
  ``--profile_steps``; each traced step runs under a ``record_function``
  mark, as the JAX ``StepTraceAnnotation``.

Traces are Chrome trace JSON files (``chrome://tracing``, Perfetto)
written to ``<dir>/host_0/`` (one process: host 0). The JAX module's
``start_server`` (a live-attach profiler server) has no PyTorch
counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _host_dir(log_dir: str) -> str:
    path = os.path.join(log_dir, "host_0")
    os.makedirs(path, exist_ok=True)
    return path


def _start_trace(host_dir: str):
    """A started profiler of the host and, with CUDA, the device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, host_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``host_dir``; returns
    the path."""
    prof.stop()
    path = os.path.join(
        host_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    return path


def _annotation(label: str, step: int):
    return torch.profiler.record_function(f"{label}_step_{step}")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace for the duration of the block."""
    host_dir = _host_dir(log_dir)
    prof = _start_trace(host_dir)
    try:
        yield
    finally:
        _stop_trace(prof, host_dir)


class WindowedTrace:
    """Trace ``num_steps`` consecutive steps starting at the first step
    ``>= start``.

    Call ``step(i)`` at the top of every training step — it returns a
    context manager to run the step's work under, so traced steps carry a
    ``record_function`` mark named ``<label>_step_<i>`` (a no-op context
    outside the window)::

        with profiler.step(i):
            ... data wait + train_step ...

    The first traced step is the first one at or past ``start`` (a resume
    that lands beyond ``start`` still opens the window); the trace stops
    after ``num_steps`` traced steps or at ``close()``, and never re-opens
    (one window per run).
    """

    def __init__(self, log_dir: Optional[str], start: int = 5,
                 num_steps: int = 5, label: str = "train"):
        self.log_dir = log_dir
        self.start = start
        self.num_steps = num_steps
        self.label = label
        self._active = False
        self._stop_at: Optional[int] = None   # set when the window opens
        self._prof = None
        self._dir: Optional[str] = None

    def step(self, i: int):
        if self.log_dir:
            if (not self._active and self._stop_at is None
                    and i >= self.start):
                self._dir = _host_dir(self.log_dir)
                self._prof = _start_trace(self._dir)
                self._active = True
                self._stop_at = i + self.num_steps
            elif self._active and i >= self._stop_at:
                self.close()
        if self._active:
            return _annotation(self.label, i)
        return contextlib.nullcontext()

    def close(self) -> None:
        if self._active:
            self._active = False
            _stop_trace(self._prof, self._dir)
            self._prof = None
