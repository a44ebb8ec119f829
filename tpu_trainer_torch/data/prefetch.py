"""Bounded background prefetch over an iterator (port of
``tpu_trainer/data/prefetch.py``).

``Prefetcher`` runs the loader's batch assembly (tokenization, stacking)
on a daemon thread into a bounded queue, so the host builds batch N+1
while the device runs step N. The thread handles host numpy only and
never touches a CUDA tensor; the host-to-device copy is the next layer's
(``data/device_prefetch.py``)::

    TextDataLoader -> Prefetcher (host thread) -> DevicePrefetcher -> step
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class _ProducerError:
    """In-band carrier for a producer-thread exception: queued *after* the
    batches produced before the failure, so the consumer sees every good
    batch and then the error — never a silently-shortened epoch (which a
    resume/rollback loop would misread as dataset exhaustion)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate ``make_iter()`` on a background thread, ``depth`` items ahead.

    - Exceptions in the producer re-raise in the consumer with the
      producer's original traceback (the frames below ``__iter__`` are the
      producer's), after all batches produced before the failure.
    - Early termination (consumer breaks / generator closed) signals the
      producer to stop; the thread is a daemon either way.
    - Each ``__iter__`` starts a fresh producer (epoch semantics match the
      wrapped loader's).
    """

    _SENTINEL = object()

    def __init__(self, make_iter: Callable[[], Iterable], depth: int = 2):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self) -> Iterator:
        if self._depth == 0:
            # Passthrough: no thread, no buffer — lets call sites treat the
            # depth as a plain knob (0 = synchronous) instead of branching.
            yield from self._make_iter()
            return
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._make_iter():
                    if not _put(item):
                        return
                _put(self._SENTINEL)
            except BaseException as e:  # delivered in-band, re-raised below
                _put(_ProducerError(e))

        thread = threading.Thread(
            target=produce, daemon=True, name="tpu-trainer-torch-prefetch"
        )
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, _ProducerError):
                    # Same exception object: its __traceback__ still points
                    # into the producer's frames, so the re-raise reads like
                    # the failure happened inline.
                    raise item.exc.with_traceback(item.exc.__traceback__)
                yield item
        finally:
            stop.set()
