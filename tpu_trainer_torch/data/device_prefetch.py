"""Device prefetch: keep the next batches already on the card (port of
``tpu_trainer/data/device_prefetch.py``).

``DevicePrefetcher`` pulls ``depth`` batches ahead of the trainer and
places each at once. On a CUDA device the placement runs on a side CUDA
stream (``place`` is ``Trainer.put_batch`` with ``non_blocking=True``: a
copy from pinned host memory), an event is recorded behind it, and
``next()`` makes the consuming stream wait on that event and
``record_stream``s the batch for it, so the copy of batch N+1 runs under
step N and the caching allocator never reuses the batch's memory while
the step still reads it. On the CPU, ``place`` runs inline. No thread
lives here: only this class places batches, on the caller's thread.

Cursor contract: the wrapped loader's ``state_dict()`` advances when a
batch leaves the loader, up to ``depth`` batches ahead of what the
trainer consumed. So this class snapshots the loader cursor at each pull
and republishes, through its own ``state_dict()``, the snapshot of the
batch most recently handed to the trainer. Checkpoints and rollbacks read
this cursor, never the raw loader's.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch


class DevicePrefetcher:
    """Pull batches from ``next_fn`` and place them on the device ahead of
    use.

    - ``next_fn``: the next host batch (``StopIteration`` ends the stream).
    - ``place``: host batch -> device tensor.
    - ``cursor_fn``: the wrapped loader's ``state_dict`` (optional).
    - ``depth``: batches kept placed ahead; ``0`` places on demand.
    - ``device``: a CUDA device places on a side stream (see the module
      docstring); None or the CPU places inline.
    """

    def __init__(self, next_fn: Callable[[], object], *,
                 place: Callable[[object], torch.Tensor],
                 cursor_fn: Optional[Callable[[], dict]] = None,
                 depth: int = 2, device=None):
        if depth < 0:
            raise ValueError(
                f"device prefetch depth must be >= 0, got {depth}")
        self._next_fn = next_fn
        self._place = place
        self._cursor_fn = cursor_fn
        self.depth = depth
        dev = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(device=dev)
                        if dev is not None and dev.type == "cuda" else None)
        self._buf: collections.deque = collections.deque()
        self._exhausted = False
        self._cursor = cursor_fn() if cursor_fn is not None else None

    def _pull(self) -> bool:
        try:
            batch = self._next_fn()
        except StopIteration:
            self._exhausted = True
            return False
        cur = self._cursor_fn() if self._cursor_fn is not None else None
        if self._stream is None:
            self._buf.append((self._place(batch), None, cur))
            return True
        with torch.cuda.stream(self._stream):
            placed = self._place(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._buf.append((placed, event, cur))
        return True

    def _fill(self) -> None:
        while not self._exhausted and len(self._buf) < max(self.depth, 1):
            self._pull()

    def next(self) -> torch.Tensor:
        """The next device batch, ready for the current stream; advances
        the published cursor to its snapshot. ``StopIteration`` once the
        stream is exhausted and the buffer drained."""
        if not self._buf:
            self._fill()
        if not self._buf:
            raise StopIteration
        batch, event, cur = self._buf.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(batch.device)
            consumer.wait_event(event)
            batch.record_stream(consumer)
        self._cursor = cur
        # Top up now so the next copies run under this step's compute.
        self._fill()
        return batch

    def state_dict(self) -> Optional[dict]:
        """Loader cursor of the last batch the trainer consumed."""
        return self._cursor

    def buffered(self) -> int:
        return len(self._buf)

    def reset(self) -> None:
        """Drop the buffer and re-base the cursor on the (rewound) loader:
        call after ``load_state_dict`` on the wrapped loader."""
        self._buf.clear()
        self._exhausted = False
        self._cursor = (self._cursor_fn() if self._cursor_fn is not None
                        else None)
