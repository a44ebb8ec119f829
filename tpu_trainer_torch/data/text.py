"""Text data (port of ``tpu_trainer/data/text.py``): map-style and
streaming tokenized datasets, the batching loader and its cursor.

- **LRU token cache**: an ``OrderedDict`` keyed by line index with a
  total-token budget (``cache_max_tokens``), evicting from the front.
- **Map-style dataset**: tokenize the whole file up front (optionally
  capped by ``max_tokens``), concatenate, split into ``seq_len`` chunks.
- **Streaming dataset**: line-modulo sharding across processes
  (``line_idx % num_shards == shard_id``), a rolling token buffer over the
  shard's lines emitting ``seq_len`` chunks, a ``max_tokens`` budget,
  optional per-document segment ids (``mask_doc_boundaries``) and an
  every-N-th-line holdout for eval.
- **gzip transparency** and the ``.gz``/plain path fallback.
- **Sampling** (map-style): disjoint per-process strides of one
  epoch-seeded permutation (``process_index`` / ``process_count``),
  ``drop_last`` batches, reshuffled every epoch.
- **Cursor**: ``TextDataLoader.state_dict`` / ``load_state_dict`` give the
  exact consumed-batch position a checkpoint resumes from.

Host numpy only; the trainer places batches on the device
(``Trainer.put_batch``). Batches, chunks and cursors are bitwise those of
the JAX package for the same file, tokenizer and seed.
"""

from __future__ import annotations

import functools
import gzip
import os
from collections import OrderedDict
from typing import Iterator, List, Optional

import numpy as np

from tpu_trainer_torch.utils.tokenizer import ByteTokenizer, get_tokenizer


class LRUTokenCache:
    """Token-budget LRU cache keyed by line index (reference
    ``tinystories.py:62-82``)."""

    def __init__(self, max_tokens: Optional[int]):
        self.max_tokens = max_tokens
        self._cache: OrderedDict[int, List[int]] = OrderedDict()
        self._tokens = 0

    def get(self, key: int) -> Optional[List[int]]:
        if key not in self._cache:
            return None
        self._cache.move_to_end(key)
        return self._cache[key]

    def put(self, key: int, tokens: List[int]) -> None:
        if self.max_tokens is None or self.max_tokens <= 0:
            return
        if key in self._cache:
            return
        self._cache[key] = tokens
        self._tokens += len(tokens)
        while self._tokens > self.max_tokens and self._cache:
            _, evicted = self._cache.popitem(last=False)  # evict oldest
            self._tokens -= len(evicted)

    def __len__(self) -> int:
        return len(self._cache)


def resolve_path(path: str) -> str:
    """``.gz``↔plain fallback (reference ``openwebtext.py:147-155``): if the
    given path is missing but its gz (or ungz) sibling exists, use that."""
    if os.path.exists(path):
        return path
    if path.endswith(".gz") and os.path.exists(path[:-3]):
        return path[:-3]
    if not path.endswith(".gz") and os.path.exists(path + ".gz"):
        return path + ".gz"
    raise FileNotFoundError(path)


def open_text(path: str):
    """Transparent text open for plain or gzip files
    (reference ``openwebtext.py:32-37``)."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def read_bytes(path: str, limit: Optional[int] = None) -> bytes:
    """Raw bytes with gzip transparency (native fast path). ``limit`` caps
    the read so a token budget doesn't force loading a huge corpus."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read() if limit is None else f.read(limit)
    with open(path, "rb") as f:
        return f.read() if limit is None else f.read(limit)


class TextDataset:
    """Map-style: tokenize the whole file, chunk to ``seq_len``
    (reference ``tinystories.py:22-50``).

    ``__getitem__(i)`` returns an int32 ``[seq_len]`` chunk.
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        tokenizer_name: str = "gpt2",
        max_tokens: Optional[int] = None,
        num_workers: int = 0,
        tokenizer_on_fallback: str = "warn",
    ):
        self.path = resolve_path(path)
        self.seq_len = seq_len
        tokenizer = get_tokenizer(tokenizer_name, on_fallback=tokenizer_on_fallback)

        arr: Optional[np.ndarray] = None
        if isinstance(tokenizer, ByteTokenizer):
            # Native one-pass strip/tokenize (tpu_trainer/native); falls
            # through to the Python loop when the library is unavailable or
            # the bytes need Python text semantics. With a token budget,
            # read only a bounded prefix (>= 1 byte/token plus slack); if
            # that prefix can't fill the budget the Python path decides.
            from tpu_trainer_torch import native

            limit = None if max_tokens is None else 4 * max_tokens + 65536
            data = read_bytes(self.path, limit)
            arr = native.byte_tokenize(
                data, tokenizer.eos_token_id, max_tokens=max_tokens,
            )
            if (
                arr is not None
                and max_tokens is not None
                and arr.size < max_tokens
                and limit is not None
                and len(data) == limit  # possibly truncated read
            ):
                arr = None
        if arr is None:
            ids: List[int] = []
            eos = tokenizer.eos_token_id
            if num_workers > 0:
                # Up-front tokenization parallelized over lines (the
                # map-style analogue of streaming num_workers; HF fast
                # tokenizers release the GIL).
                from concurrent.futures import ThreadPoolExecutor

                with open_text(self.path) as f:
                    lines = [l.strip() for l in f if l.strip()]
                with ThreadPoolExecutor(max_workers=num_workers) as pool:
                    for toks in pool.map(tokenizer.encode, lines, chunksize=64):
                        ids.extend(toks)
                        ids.append(eos)
                        if max_tokens is not None and len(ids) >= max_tokens:
                            break
                if max_tokens is not None:
                    ids = ids[:max_tokens]
            else:
                with open_text(self.path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        ids.extend(tokenizer.encode(line))
                        ids.append(eos)
                        if max_tokens is not None and len(ids) >= max_tokens:
                            ids = ids[:max_tokens]
                            break
            arr = np.asarray(ids, dtype=np.int32)

        n_chunks = arr.size // seq_len
        if n_chunks == 0:
            raise ValueError(
                f"{path}: only {arr.size} tokens, need >= seq_len ({seq_len})"
            )
        self.chunks = arr[: n_chunks * seq_len].reshape(n_chunks, seq_len)

    def __len__(self) -> int:
        return self.chunks.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.chunks[i]


class ChunkSubset:
    """Contiguous index-range view over a map-style dataset's chunks — the
    held-out split mechanism (train = head, eval = tail; see
    ``create_text_dataloader(eval_split=...)``)."""

    def __init__(self, dataset, start: int, stop: int):
        if not (0 <= start <= stop <= len(dataset)):
            raise ValueError(f"bad subset [{start}, {stop}) of {len(dataset)}")
        self.dataset = dataset
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.dataset[self.start + i]


class StreamingTextDataset:
    """Iterable: line-modulo sharded streaming with a rolling token buffer
    (reference ``tinystories.py:53-119``, ``openwebtext.py:95-130``).

    Yields int32 ``[seq_len]`` chunks. Re-iterating starts a new pass over
    the file (the LRU cache persists across passes, which is when it pays —
    reference behavior, SURVEY.md §2.1 b10).
    """

    # Lines per tokenizer-pool submission; large enough to amortize thread
    # handoff, small enough to keep the pipeline responsive.
    _GROUP = 64

    def __init__(
        self,
        path: str,
        seq_len: int,
        tokenizer_name: str = "gpt2",
        max_tokens: Optional[int] = None,
        cache_max_tokens: Optional[int] = None,
        num_workers: int = 0,
        tokenizer_on_fallback: str = "warn",
        holdout=None,
        mask_doc_boundaries: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """Process ``shard_id`` of ``num_shards`` reads the lines with
        ``line_idx % num_shards == shard_id``. ``holdout=(role, N)`` carves
        an eval split out of the stream: every N-th line *of each shard*
        (``(line_idx // num_shards) % N == N - 1``) belongs to eval, so a
        shared factor of N and the shard count never leaves a shard an
        empty stream. ``role="train"`` skips those lines; ``role="eval"``
        yields only them."""
        self.path = resolve_path(path)
        self.seq_len = seq_len
        self.tokenizer = get_tokenizer(
            tokenizer_name, on_fallback=tokenizer_on_fallback
        )
        self.max_tokens = max_tokens
        self.num_workers = num_workers
        self.shard_id = shard_id
        self.num_shards = num_shards
        if holdout is not None:
            role, every = holdout
            if role not in ("train", "eval") or every < 2:
                raise ValueError(f"bad holdout {holdout!r}")
        self.holdout = holdout
        # Cross-document loss-leak fix: with the flag on, each yielded chunk
        # carries a segment channel ([seq_len, 2]: tokens, segment ids)
        # derived from the EOS positions inside the window, so attention is
        # isolated per document and the loss skips targets that would cross
        # a boundary. Default OFF for bit-compat with runs checkpointed on
        # the leaky stream (identical batches, identical loss curve).
        self.mask_doc_boundaries = mask_doc_boundaries
        self.cache = LRUTokenCache(cache_max_tokens)

    def _encode(self, line: str) -> List[int]:
        return self.tokenizer.encode(line) + [self.tokenizer.eos_token_id]

    def _sharded_lines(self, f) -> Iterator[tuple]:
        """(line_idx, stripped line) pairs belonging to this shard (and to
        this dataset's side of the train/eval holdout, if any)."""
        role, every = self.holdout if self.holdout else (None, 0)
        for line_idx, line in enumerate(f):
            if role is not None:
                is_eval_line = (
                    (line_idx // self.num_shards) % every == every - 1)
                if is_eval_line == (role == "train"):
                    continue
            if line_idx % self.num_shards != self.shard_id:
                continue
            line = line.strip()
            if line:
                yield line_idx, line

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self.mask_doc_boundaries:
            yield from self._iter_tokens()
            return
        eos = self.tokenizer.eos_token_id
        for chunk in self._iter_tokens():
            # Document d's positions are those after the (d-1)-th EOS in the
            # window: seg = 1 + #EOS strictly before. The EOS itself closes
            # its document, so the boundary target (EOS -> next doc's first
            # token) gets seg[t+1] != seg[t] and is loss-masked
            # (ops/loss.segment_target_mask). A doc spanning two windows
            # restarts at seg 1 in the next window — consistent: the window
            # is the attention scope. No padding, so no seg-0 positions.
            segs = 1 + np.cumsum(
                np.concatenate([[0], (chunk[:-1] == eos).astype(np.int32)])
            )
            yield np.stack([chunk, segs.astype(np.int32)], axis=-1)

    def iter_documents(self) -> Iterator[List[int]]:
        """Per-line token lists (EOS appended) under the same shard/holdout/
        budget rules as the chunk stream — the document source the packing
        loader (``data/packing.py``) bins into full rows."""
        tokens_seen = 0
        with open_text(self.path) as f:
            for line_idx, line in self._sharded_lines(f):
                tokens = self.cache.get(line_idx)
                if tokens is None:
                    tokens = self._encode(line)
                    self.cache.put(line_idx, tokens)
                if self.max_tokens is not None:
                    remaining = self.max_tokens - tokens_seen
                    if remaining <= 0:
                        return
                    tokens = tokens[:remaining]
                tokens_seen += len(tokens)
                yield tokens

    def _iter_tokens(self) -> Iterator[np.ndarray]:
        if self.num_workers > 0:
            yield from self._iter_parallel()
            return
        buffer: List[int] = []
        tokens_seen = 0
        with open_text(self.path) as f:
            for line_idx, line in self._sharded_lines(f):
                tokens = self.cache.get(line_idx)
                if tokens is None:
                    tokens = self._encode(line)
                    self.cache.put(line_idx, tokens)
                # max_tokens budget (reference tinystories.py:103-108)
                if self.max_tokens is not None:
                    remaining = self.max_tokens - tokens_seen
                    if remaining <= 0:
                        return
                    tokens = tokens[:remaining]
                tokens_seen += len(tokens)
                buffer.extend(tokens)
                while len(buffer) >= self.seq_len:
                    yield np.asarray(buffer[: self.seq_len], dtype=np.int32)
                    buffer = buffer[self.seq_len :]

    def _iter_parallel(self) -> Iterator[np.ndarray]:
        """Same stream, with uncached lines tokenized by a thread pool in
        groups (the ``num_workers`` knob — reference ``tinystories.py:131``;
        HF fast tokenizers release the GIL, so threads parallelize for
        real). Chunk order, LRU caching, and the ``max_tokens`` budget are
        identical to the serial path.
        """
        from concurrent.futures import ThreadPoolExecutor

        buffer: List[int] = []
        tokens_seen = 0

        with open_text(self.path) as f, ThreadPoolExecutor(
            max_workers=self.num_workers
        ) as pool:
            group: List[tuple] = []  # (line_idx, line, cached | None)

            def resolved(group):
                uncached = [(i, l) for i, l, t in group if t is None]
                encoded = dict(
                    zip(
                        (i for i, _ in uncached),
                        pool.map(self._encode, (l for _, l in uncached)),
                    )
                )
                for i, _, t in group:
                    if t is None:
                        t = encoded[i]
                        self.cache.put(i, t)
                    yield t

            def emit(group):
                nonlocal buffer, tokens_seen
                for tokens in resolved(group):
                    if self.max_tokens is not None:
                        remaining = self.max_tokens - tokens_seen
                        if remaining <= 0:
                            return False
                        tokens = tokens[:remaining]
                    tokens_seen += len(tokens)
                    buffer.extend(tokens)
                    while len(buffer) >= self.seq_len:
                        yield np.asarray(
                            buffer[: self.seq_len], dtype=np.int32
                        )
                        buffer = buffer[self.seq_len :]
                return True

            for line_idx, line in self._sharded_lines(f):
                group.append((line_idx, line, self.cache.get(line_idx)))
                if len(group) >= self._GROUP:
                    done = yield from emit(group)
                    group = []
                    if done is False:
                        return
            if group:
                yield from emit(group)


class TextDataLoader:
    """Batches chunks into ``[batch_size, seq_len]`` int32 arrays.

    ``batch_size`` is this process's row count of one optimizer step (=
    micro_batch x grad_accum, torch's per-rank DataLoader semantics,
    ``ddp_trainer.py:538``). Map-style epochs reshuffle with an
    epoch-seeded permutation, of which process ``process_index`` of
    ``process_count`` takes every ``process_count``-th row (disjoint
    strides, the same number of full batches on every process); streaming
    reads the dataset's own line shard in file order.

    ``prefetch > 0`` assembles batches on a background thread, ``prefetch``
    batches ahead (``data/prefetch.py``) — the torch-DataLoader overlap the
    reference relies on: host tokenization/stacking runs while the device
    executes the current step.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.streaming = not hasattr(dataset, "__len__")
        # Consumer-side cursor for exact resume: which epoch is being
        # iterated and how many batches the *consumer* has pulled from it.
        # Counted here (not in the producer) because with prefetch the
        # background thread runs batches ahead of what training actually
        # consumed — a crash must resume at the consumed position.
        self._cur_epoch = 0
        self._cur_batch = 0
        self._resume_skip = 0

    def state_dict(self) -> dict:
        """Exact data-stream position, persisted into checkpoint meta.json.

        ``batch_index`` counts batches *consumed* in epoch ``epoch`` (the
        cursor advances before each yield, so a checkpoint taken after
        training on batch k records k+1). The shuffle RNG needs no separate
        state: the map-style permutation is a pure function of
        ``(seed, epoch)`` and the streaming line order is the file order.
        """
        return {
            "kind": "streaming" if self.streaming else "map",
            "epoch": self._cur_epoch,
            "batch_index": self._cur_batch,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict) -> None:
        """Position the next ``__iter__`` at the saved cursor.

        Map-style re-derives the epoch's permutation and jumps straight to
        the batch (index arithmetic, no re-tokenization); streaming
        fast-forwards by re-reading and discarding ``batch_index`` batches —
        exact, because the stream is a deterministic function of the file.
        """
        kind = state.get("kind", "map")
        here = "streaming" if self.streaming else "map"
        if kind != here:
            raise ValueError(
                f"data state kind {kind!r} does not match this {here!r} "
                f"loader — the resumed run changed --dataset/--streaming"
            )
        self.epoch = self._cur_epoch = int(state["epoch"])
        self._cur_batch = int(state["batch_index"])
        self._resume_skip = self._cur_batch

    def __iter__(self) -> Iterator[np.ndarray]:
        # Map-style epoch state advances HERE, on the consumer's thread, not
        # inside the (possibly background-threaded) generator: with prefetch
        # a consumer breaking early would otherwise leave "did the epoch
        # advance?" up to producer-thread timing. Each __iter__ is one epoch.
        epoch = self.epoch
        if not self.streaming:
            self.epoch += 1
        start = self._resume_skip
        self._resume_skip = 0
        self._cur_epoch = epoch
        self._cur_batch = start
        make = functools.partial(self._iter_batches, epoch, start)
        if self.prefetch > 0:
            from tpu_trainer_torch.data.prefetch import Prefetcher

            it = iter(Prefetcher(make, self.prefetch))
        else:
            it = make()
        for batch in it:
            self._cur_batch += 1
            yield batch
        self._cur_epoch = epoch + 1
        self._cur_batch = 0

    def _iter_batches(self, epoch: int, start: int = 0) -> Iterator[np.ndarray]:
        if self.streaming:
            rows = []
            skipped = 0
            for chunk in self.dataset:
                rows.append(chunk)
                if len(rows) == self.batch_size:
                    if skipped < start:
                        skipped += 1  # resume fast-forward: discard
                    else:
                        yield np.stack(rows)
                    rows = []
            if rows and not self.drop_last and skipped >= start:
                yield np.stack(rows)
        else:
            n = len(self.dataset)
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(n)
            # Disjoint per-process strides; drop the ragged tail so every
            # process sees the same number of full batches (drop_last=True,
            # reference tinystories.py:158).
            stride = self.process_count * self.batch_size
            order = order[: (n // stride) * stride]
            local = order[self.process_index :: self.process_count]
            for b in range(start, len(local) // self.batch_size):
                idx = local[b * self.batch_size : (b + 1) * self.batch_size]
                yield np.stack([self.dataset[i] for i in idx])

    def __len__(self) -> int:
        if self.streaming:
            raise TypeError("streaming loader has no length")
        return len(self.dataset) // (self.process_count * self.batch_size)


def create_text_dataloader(
    path: str,
    batch_size: int,
    seq_len: int,
    *,
    tokenizer_name: str = "gpt2",
    max_tokens: Optional[int] = None,
    streaming: bool = False,
    cache_max_tokens: Optional[int] = None,
    seed: int = 0,
    num_workers: int = 0,
    prefetch: int = 2,
    tokenizer_on_fallback: str = "warn",
    eval_split: float = 0.0,
    eval_holdout_every: int = 0,
    mask_doc_boundaries: bool = False,
    process_index: int = 0,
    process_count: int = 1,
) -> TextDataLoader:
    """Factory shared by the dataset-specific wrappers (reference factory
    signatures: ``tinystories.py:122-134``, ``openwebtext.py:133-145``).
    ``num_workers`` parallelizes tokenization (streaming and map-style);
    ``prefetch`` overlaps batch assembly with device steps (0 disables).
    ``tokenizer_on_fallback="error"`` is the training guardrail: no silent
    byte-level fallback (utils/tokenizer.py).

    Held-out eval (the loop the reference's dead ``eval_interval`` promised,
    ``ddp_trainer.py:52``): ``eval_split > 0`` (map-style) carves the last
    ``eval_split`` fraction of chunks; ``eval_holdout_every = N > 0``
    (streaming) reserves every N-th line. Either attaches an ``eval_loader``
    (batching over the held-out rows only, prefetch off) to the returned
    train loader; train and eval rows are disjoint by construction. The
    attribute is None when no split is requested. ``process_index`` /
    ``process_count`` shard both: streaming by line, map-style by row.
    """
    ranks = dict(process_index=process_index, process_count=process_count)
    eval_loader = None
    if streaming:
        holdout = ("train", eval_holdout_every) if eval_holdout_every else None
        common = dict(
            tokenizer_name=tokenizer_name,
            max_tokens=max_tokens,
            cache_max_tokens=cache_max_tokens,
            tokenizer_on_fallback=tokenizer_on_fallback,
        )
        dataset = StreamingTextDataset(
            path, seq_len, num_workers=num_workers, holdout=holdout,
            mask_doc_boundaries=mask_doc_boundaries, shard_id=process_index,
            num_shards=process_count, **common
        )
        if eval_holdout_every:
            eval_ds = StreamingTextDataset(
                path, seq_len, holdout=("eval", eval_holdout_every),
                shard_id=process_index, num_shards=process_count, **common
            )
            eval_loader = TextDataLoader(eval_ds, batch_size, seed=seed,
                                         prefetch=0, **ranks)
    else:
        full = TextDataset(
            path, seq_len, tokenizer_name=tokenizer_name,
            max_tokens=max_tokens, num_workers=num_workers,
            tokenizer_on_fallback=tokenizer_on_fallback,
        )
        dataset = full
        if eval_split > 0.0:
            n = len(full)
            n_eval = max(1, int(n * eval_split))
            if n - n_eval < 1:
                # Too small to split (eval_split defaults on): degrade to
                # no-eval with a warning rather than refusing a tiny corpus
                # that would previously train.
                import warnings

                warnings.warn(
                    f"{path}: {n} chunk(s) cannot hold out eval_split="
                    f"{eval_split} and still train; continuing without an "
                    f"eval split"
                )
            else:
                dataset = ChunkSubset(full, 0, n - n_eval)
                eval_loader = TextDataLoader(
                    ChunkSubset(full, n - n_eval, n), batch_size, seed=seed,
                    prefetch=0, **ranks,
                )
    loader = TextDataLoader(dataset, batch_size, seed=seed, prefetch=prefetch,
                            **ranks)
    loader.eval_loader = eval_loader
    return loader
