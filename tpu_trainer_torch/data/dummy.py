"""Synthetic random-token data (a copy of ``tpu_trainer/data/dummy.py``).

A deterministic per-seed corpus of random tokens, per-process disjoint
slices, numpy on the host (device placement happens in
``Trainer.put_batch``). Batch ``i`` is a pure function of ``(seed, i)``, so
the port and the JAX package see the same batches from the same seed.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class DummyDataLoader:
    """Yields ``[local_batch_size, seq_len]`` int32 token batches.

    ``batch_size`` is the *global* loader batch (micro_batch x grad_accum x
    data shards); each process receives its disjoint
    ``batch_size / process_count`` rows.
    """

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        vocab_size: int = 50257,
        num_batches: int = 100,
        seed: int = 1234,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by {process_count} processes"
            )
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_batches = num_batches
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        # Consumer-side cursor for exact resume.
        self._cur_epoch = 0
        self._cur_batch = 0
        self._resume_skip = 0

    def __len__(self) -> int:
        return self.num_batches

    def state_dict(self) -> dict:
        """Exact data-stream position: batches *consumed* this epoch (the
        cursor advances before each yield, so a checkpoint taken after
        training on batch k records k+1 — resuming continues at k+1)."""
        return {
            "kind": "dummy",
            "epoch": self._cur_epoch,
            "batch_index": self._cur_batch,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind", "dummy") != "dummy":
            raise ValueError(
                f"data state kind {state.get('kind')!r} does not match this "
                f"dummy loader — the resumed run changed --dataset"
            )
        self._cur_epoch = int(state["epoch"])
        self._cur_batch = int(state["batch_index"])
        self._resume_skip = self._cur_batch

    def __iter__(self) -> Iterator[np.ndarray]:
        start = self._resume_skip
        self._resume_skip = 0
        self._cur_batch = start
        for i in range(start, self.num_batches):
            # Batch i is a pure function of (seed, i): all processes agree on
            # the global batch and carve out disjoint row ranges — and a
            # resumed run regenerates batch i bit-exactly from the cursor.
            rng = np.random.default_rng((self.seed, i))
            batch = rng.integers(
                0, self.vocab_size, (self.batch_size, self.seq_len), dtype=np.int32
            )
            lo = self.process_index * self.local_batch_size
            self._cur_batch = i + 1
            yield batch[lo : lo + self.local_batch_size]
        self._cur_epoch += 1
        self._cur_batch = 0


def create_dummy_dataloader(
    batch_size: int,
    seq_len: int,
    vocab_size: int = 50257,
    num_batches: int = 100,
    seed: int = 1234,
    process_index: int = 0,
    process_count: int = 1,
) -> DummyDataLoader:
    """Factory with the JAX package's signature."""
    return DummyDataLoader(
        batch_size=batch_size,
        seq_len=seq_len,
        vocab_size=vocab_size,
        num_batches=num_batches,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )
