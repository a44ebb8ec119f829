"""Sequence packing: first-fit binning of ragged documents into full rows
(port of ``tpu_trainer/data/packing.py``, pure numpy: the same rows and
segment ids as the JAX package's for the same documents and seed).

The corpora are ragged (TinyStories ~200-token stories, OpenWebText
documents) while the trainer consumes fixed ``[batch, seq_len]`` rows. The
two pre-existing strategies both waste something: padding each document to
``seq_len`` burns compute on pad positions, and concatenating the stream
attends (and computes loss) across document boundaries. Packing keeps full
rows AND document isolation: several documents share one row, a per-position
``segment_ids`` channel marks which (0 = padding, documents 1..K), the flash
kernels skip/mask cross-segment tiles (``ops/flash.py``,
``csrc/flash_attn.cu``) and the loss masks targets that would cross a
boundary (``ops/loss.segment_target_mask``).

Packed batches travel channel-last: int32 ``[rows, seq_len, 2]`` with
``[..., 0]`` tokens and ``[..., 1]`` segment ids — the shape contract
``Trainer.put_batch`` recognizes (a trailing dim of 2; a real seq dim is
never 2).

Packing efficiency: with mean document length m and first-fit into bins of
size S, the expected non-pad fraction approaches 1 - O(m/S) (the only waste
is the per-bin tail smaller than the shortest open document), versus m/S for
pad-to-seq — the ratio S/m is the effective-throughput headroom of the
packed training path.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np


def synthetic_documents(
    num_docs: int,
    mean_len: int,
    vocab_size: int,
    seed: int = 0,
    min_len: int = 1,
) -> Iterator[List[int]]:
    """Deterministic ragged corpus: doc lengths ~ geometric around
    ``mean_len`` (clipped at ``min_len``), tokens uniform over the vocab.
    The stand-in for a real ragged dataset."""
    rng = np.random.default_rng(seed)
    for _ in range(num_docs):
        n = max(min_len, int(rng.geometric(1.0 / max(mean_len, 1))))
        yield rng.integers(0, vocab_size, n).astype(np.int32).tolist()


def _split_long(doc: List[int], seq_len: int) -> Iterator[List[int]]:
    """Documents longer than a row split at row boundaries; each piece packs
    as its own document (pieces separated into different rows could not
    attend to each other anyway)."""
    for i in range(0, len(doc), seq_len):
        yield doc[i : i + seq_len]


def pack_documents(
    docs: Iterable[List[int]],
    seq_len: int,
    max_open_bins: int = 8,
    strategy: str = "first_fit",
    lookahead: int = 64,
) -> Iterator[np.ndarray]:
    """Bin packing → int32 ``[seq_len, 2]`` rows (tokens, segment ids).

    ``strategy="first_fit"``: each document goes into the first open bin
    with room, in stream order. ``strategy="best_fit"``: best-fit-
    decreasing over a ``lookahead``-piece window — repeatedly place the
    LONGEST buffered piece into the bin with the TIGHTEST remaining space
    that fits (length-aware bin selection; the window is what makes
    "decreasing" possible on a stream), and when a bin must flush to keep
    memory bounded, top it off with the largest windowed pieces that
    still fit its tail. BFD trades a small reorder buffer for fewer
    stranded bin tails, squeezing the last few non-pad points.

    Either way a full bin is emitted immediately, and when more than
    ``max_open_bins`` bins are open the oldest is flushed (bounded memory,
    deterministic order — both strategies are pure functions of the
    stream, so resume replays the exact same rows). Pad positions carry
    token 0 and segment 0.
    """
    if strategy not in ("first_fit", "best_fit"):
        raise ValueError(
            f"unknown packing strategy {strategy!r}; "
            f"choose first_fit or best_fit")
    bins: List[Tuple[List[int], List[int], int]] = []  # (tokens, segs, next_id)

    def finish(tokens: List[int], segs: List[int]) -> np.ndarray:
        pad = seq_len - len(tokens)
        row = np.zeros((seq_len, 2), dtype=np.int32)
        row[: len(tokens), 0] = tokens
        row[: len(segs), 1] = segs
        assert pad >= 0
        return row

    pieces = (
        piece for doc in docs
        for piece in _split_long(list(doc), seq_len) if piece
    )
    if strategy == "first_fit":
        for piece in pieces:
            placed = False
            for j, (toks, segs, nxt) in enumerate(bins):
                if seq_len - len(toks) >= len(piece):
                    toks.extend(piece)
                    segs.extend([nxt] * len(piece))
                    if len(toks) == seq_len:
                        yield finish(toks, segs)
                        bins.pop(j)
                    else:
                        bins[j] = (toks, segs, nxt + 1)
                    placed = True
                    break
            if not placed:
                if len(piece) == seq_len:
                    yield finish(piece, [1] * seq_len)
                else:
                    bins.append((list(piece), [1] * len(piece), 2))
                    if len(bins) > max_open_bins:
                        toks, segs, _ = bins.pop(0)
                        yield finish(toks, segs)
    else:
        window: List[List[int]] = []
        it = iter(pieces)
        exhausted = False

        def refill() -> None:
            nonlocal exhausted
            while not exhausted and len(window) < max(1, lookahead):
                try:
                    window.append(next(it))
                except StopIteration:
                    exhausted = True

        def pick(limit: int) -> Optional[List[int]]:
            """Largest windowed piece of length <= limit (ties: oldest)."""
            cands = [i for i in range(len(window))
                     if len(window[i]) <= limit]
            if not cands:
                return None
            j = max(cands, key=lambda i: (len(window[i]), -i))
            return window.pop(j)

        while True:
            refill()
            piece = pick(seq_len)
            if piece is None:
                break
            best, best_rem = None, None
            for j, (toks, _, _) in enumerate(bins):
                rem = seq_len - len(toks)
                if rem >= len(piece) and (best_rem is None or rem < best_rem):
                    best, best_rem = j, rem
            if best is not None:
                toks, segs, nxt = bins[best]
                toks.extend(piece)
                segs.extend([nxt] * len(piece))
                if len(toks) == seq_len:
                    yield finish(toks, segs)
                    bins.pop(best)
                else:
                    bins[best] = (toks, segs, nxt + 1)
                continue
            if len(piece) == seq_len:
                yield finish(piece, [1] * seq_len)
                continue
            bins.append((list(piece), [1] * len(piece), 2))
            while len(bins) > max_open_bins:
                toks, segs, nxt = bins.pop(0)
                # Top off the flushing bin from the window — the
                # length-aware move that earns BFD its tighter tails
                # (without it, a run of long pieces exhausts the open
                # bins and flushes them with their tails stranded).
                while True:
                    refill()
                    extra = pick(seq_len - len(toks))
                    if extra is None:
                        break
                    toks.extend(extra)
                    segs.extend([nxt] * len(extra))
                    nxt += 1
                yield finish(toks, segs)
    for toks, segs, _ in bins:
        yield finish(toks, segs)


def pad_documents(
    docs: Iterable[List[int]], seq_len: int
) -> Iterator[np.ndarray]:
    """One document per row, padded to ``seq_len`` — the baseline packing
    replaces. Same ``[seq_len, 2]`` row format (doc = segment 1, pad = 0) so
    packed and padded batches run the identical trainer path."""
    for doc in docs:
        for piece in _split_long(list(doc), seq_len):
            if not piece:
                continue
            row = np.zeros((seq_len, 2), dtype=np.int32)
            row[: len(piece), 0] = piece
            row[: len(piece), 1] = 1
            yield row


class PackedDataLoader:
    """Batches packed rows into ``[batch_size, seq_len, 2]`` int32 arrays.

    ``doc_fn`` is a re-invocable factory returning a fresh document iterator
    (one pass = one epoch); packing is a deterministic function of that
    stream, so the cursor protocol is the streaming one: ``state_dict``
    records batches consumed and resume fast-forwards by re-packing and
    discarding. ``pack=False`` switches to the pad-to-seq baseline with the
    same batch format.

    Tracks padding waste: ``non_pad_frac`` is the cumulative non-pad token
    fraction over everything yielded (the effective tokens/s input),
    ``last_non_pad_frac`` the most recent batch's.
    """

    def __init__(
        self,
        doc_fn: Callable[[], Iterable[List[int]]],
        batch_size: int,
        seq_len: int,
        *,
        max_open_bins: int = 8,
        pack: bool = True,
        strategy: str = "first_fit",
        lookahead: int = 64,
        seed: int = 0,
        drop_last: bool = True,
        num_batches: Optional[int] = None,
    ):
        self.doc_fn = doc_fn
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.max_open_bins = max_open_bins
        self.pack = pack
        self.strategy = strategy
        self.lookahead = lookahead
        self.seed = seed
        self.drop_last = drop_last
        self.num_batches = num_batches
        self._cur_epoch = 0
        self._cur_batch = 0
        self._resume_skip = 0
        self._tokens = 0
        self._nonpad = 0
        self.last_non_pad_frac = 1.0

    @property
    def non_pad_frac(self) -> float:
        return 1.0 if self._tokens == 0 else self._nonpad / self._tokens

    def state_dict(self) -> dict:
        return {
            "kind": "packed",
            "epoch": self._cur_epoch,
            "batch_index": self._cur_batch,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != "packed":
            raise ValueError(
                f"data state kind {state.get('kind')!r} does not match this "
                f"'packed' loader — the resumed run changed the data config"
            )
        self._cur_epoch = int(state["epoch"])
        self._cur_batch = int(state["batch_index"])
        self._resume_skip = self._cur_batch

    def _rows(self) -> Iterator[np.ndarray]:
        if self.pack:
            return pack_documents(
                self.doc_fn(), self.seq_len, self.max_open_bins,
                strategy=self.strategy, lookahead=self.lookahead,
            )
        return pad_documents(self.doc_fn(), self.seq_len)

    def __iter__(self) -> Iterator[np.ndarray]:
        start = self._resume_skip
        self._resume_skip = 0
        self._cur_batch = start
        rows: List[np.ndarray] = []
        emitted = 0
        skipped = 0
        for row in self._rows():
            rows.append(row)
            if len(rows) < self.batch_size:
                continue
            batch, rows = np.stack(rows), []
            if skipped < start:
                skipped += 1
                continue
            if self.num_batches is not None and emitted >= self.num_batches:
                return
            yield self._account(batch)
            emitted += 1
        if (rows and not self.drop_last and skipped >= start
                and (self.num_batches is None or emitted < self.num_batches)):
            yield self._account(np.stack(rows))
        self._cur_epoch += 1
        self._cur_batch = 0

    def _account(self, batch: np.ndarray) -> np.ndarray:
        nonpad = int((batch[..., 1] != 0).sum())
        total = int(batch[..., 1].size)
        self._nonpad += nonpad
        self._tokens += total
        self.last_non_pad_frac = nonpad / total if total else 1.0
        self._cur_batch += 1
        return batch


def packed_synthetic_loader(rows, seq_len, vocab_size, num_batches, seed,
                            feed_rank=0, feed_world=1, max_open_bins=8,
                            pack=True, strategy="first_fit"):
    """Packed loader over a deterministic synthetic ragged corpus (the JAX
    package's ``training/cli.py::_packed_synthetic_loader``): mean document
    length ``max(8, seq_len // 4)``, enough documents for ``num_batches``
    batches of ``rows`` rows on every feed rank, documents strided across
    feed ranks so ranks pack disjoint rows."""
    mean_len = max(8, seq_len // 4)
    # ~seq/mean docs land per packed row, plus slack for pad waste (the
    # pad-to-seq baseline needs one row per document).
    per_row = max(1, seq_len // mean_len) if pack else 1
    total_docs = num_batches * rows * feed_world * (per_row + 2)

    def doc_fn():
        docs = synthetic_documents(total_docs, mean_len, vocab_size,
                                   seed=seed)
        return (d for i, d in enumerate(docs)
                if i % feed_world == feed_rank)

    return PackedDataLoader(
        doc_fn, rows, seq_len, max_open_bins=max_open_bins, pack=pack,
        strategy=strategy, seed=seed, num_batches=num_batches,
    )
