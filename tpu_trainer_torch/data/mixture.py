"""Weighted multi-source data mixture with deterministic, resumable cursors
(port of ``tpu_trainer/data/mixture.py``; numpy only).

One loader per source (dummy / tinystories / openwebtext / packed — anything
with the loader protocol: ``__iter__`` yielding host batches, plus
``state_dict``/``load_state_dict``), mixed per *global batch*: step ``i``
draws its source from ``np.random.default_rng((seed, i))`` against the
normalized weights. The choice sequence is a pure function of ``(seed, i)``
— no RNG object state to persist — so:

- **Exact resume**: the cursor is just ``batch_index`` plus
  each source's own cursor; replaying from it regenerates the identical
  batch sequence.
- **Elastic remap** (multi-process: ``training/cli.py`` on a restart,
  ``training/elastic.py`` across a resized world):
  ``utils/checkpoint.remap_data_state`` floor-divides the top-level
  ``batch_index`` onto a resized global batch; the per-source cursors are then *re-derived* from it (the number of draws
  source ``s`` received in steps ``[0, n)`` is itself a pure function of
  ``(seed, weights, n)`` — ``source_counts``), rather than trusted from the
  checkpoint, so a remapped top index never leaves a source cursor
  inconsistent with the mixture position.

Sources exhausting mid-run restart transparently (a new pass = the source
loader's next epoch), keeping the mixture an endless stream; ``num_batches``
bounds it for map-style-like use.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def _normalized(weights: Dict[str, float]) -> Dict[str, float]:
    names = sorted(weights)
    total = float(sum(weights[n] for n in names))
    if total <= 0 or any(weights[n] < 0 for n in names):
        raise ValueError(f"mixture weights must be positive: {weights!r}")
    return {n: weights[n] / total for n in names}


def choose_source(seed: int, step: int, weights: Dict[str, float]) -> str:
    """The source for global batch ``step`` — pure in ``(seed, step)``.
    Names are consumed in sorted order so dict ordering can't skew draws."""
    u = np.random.default_rng((seed, step)).random()
    acc = 0.0
    names = sorted(weights)
    for name in names:
        acc += weights[name]
        if u < acc:
            return name
    return names[-1]  # float-sum slack


def source_counts(
    seed: int, weights: Dict[str, float], n: int
) -> Dict[str, int]:
    """Batches drawn from each source over steps ``[0, n)`` — the pure
    function the elastic resume path uses to rebuild per-source cursors
    after the top-level index was remapped."""
    w = _normalized(weights)
    counts = {name: 0 for name in w}
    for i in range(n):
        counts[choose_source(seed, i, w)] += 1
    return counts


class MixtureDataLoader:
    """Weighted round-per-batch mixture over named source loaders.

    ``sources``: name → loader; ``weights``: name → unnormalized weight.
    All sources must yield batches of identical shape (the trainer compiles
    one step). ``seed`` drives only the source choice; each source keeps its
    own data order and cursor.
    """

    def __init__(
        self,
        sources: Dict[str, object],
        weights: Dict[str, float],
        *,
        seed: int = 0,
        num_batches: Optional[int] = None,
    ):
        if set(sources) != set(weights):
            raise ValueError(
                f"sources {sorted(sources)} != weights {sorted(weights)}"
            )
        self.sources = sources
        self.weights = _normalized(weights)
        self.seed = seed
        self.num_batches = num_batches
        self._cur_batch = 0
        self._resume_skip = 0
        # Telemetry: the source of the batch most recently yielded, and
        # cumulative per-source batch counts this process — the trainer
        # threads last_source into the train JSONL (``data_source``) so
        # per-source loss can be read back out of one mixed run.
        self.last_source: Optional[str] = None
        self.batches_by_source: Dict[str, int] = {n: 0 for n in sources}

    # --- cursor protocol ---------------------------------------------------

    def state_dict(self) -> dict:
        """Top-level ``batch_index`` rides the standard remap path
        (``remap_data_state`` floor-divides it on a global-batch resize);
        per-source cursors are carried for the common same-geometry resume
        and re-derived from ``batch_index`` when they disagree with it."""
        return {
            "kind": "mixture",
            "batch_index": self._cur_batch,
            "seed": self.seed,
            "weights": dict(self.weights),
            "sources": {
                name: src.state_dict() for name, src in self.sources.items()
            },
        }

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != "mixture":
            raise ValueError(
                f"data state kind {state.get('kind')!r} does not match this "
                f"'mixture' loader — the resumed run changed the data config"
            )
        n = int(state["batch_index"])
        self._cur_batch = n
        self._resume_skip = n
        saved = state.get("sources", {})
        if set(saved) != set(self.sources):
            raise ValueError(
                f"mixture sources changed across resume: checkpoint has "
                f"{sorted(saved)}, this run has {sorted(self.sources)}"
            )
        counts = source_counts(self.seed, self.weights, n)
        for name, src in self.sources.items():
            sub = dict(saved[name])
            drawn = counts[name]
            # Trust the saved sub-cursor only when it matches the pure
            # derivation (same-geometry resume); otherwise the top index was
            # remapped (elastic restart) and the sub-cursor is rebuilt from
            # the draw count — epoch wraps derived from the source's length
            # when it has one, assumed un-wrapped otherwise (the streaming
            # caveat remap_data_state already documents).
            consumed = self._consumed(sub, src)
            if consumed != drawn:
                per_epoch = None
                try:
                    per_epoch = len(src)
                except TypeError:
                    pass
                if per_epoch:
                    sub["epoch"] = drawn // per_epoch
                    sub["batch_index"] = drawn % per_epoch
                else:
                    sub["epoch"] = 0
                    sub["batch_index"] = drawn
            src.load_state_dict(sub)

    @staticmethod
    def _consumed(sub_state: dict, src) -> int:
        """Total batches a source consumed per its own cursor."""
        epoch = int(sub_state.get("epoch", 0))
        idx = int(sub_state.get("batch_index", 0))
        if epoch == 0:
            return idx
        try:
            return epoch * len(src) + idx
        except TypeError:
            return -1  # unknowable → force re-derivation

    # --- iteration ---------------------------------------------------------

    def __iter__(self) -> Iterator[np.ndarray]:
        start = self._resume_skip
        self._resume_skip = 0
        self._cur_batch = start
        its = {}
        i = start
        while self.num_batches is None or i < self.num_batches:
            name = choose_source(self.seed, i, self.weights)
            if name not in its:
                its[name] = iter(self.sources[name])
            try:
                batch = next(its[name])
            except StopIteration:
                its[name] = iter(self.sources[name])
                try:
                    batch = next(its[name])
                except StopIteration:
                    raise RuntimeError(
                        f"mixture source {name!r} yields no batches"
                    ) from None
            self._cur_batch = i + 1
            self.last_source = name
            self.batches_by_source[name] += 1
            yield batch
            i += 1

    @property
    def non_pad_frac(self) -> float:
        """Weighted padding accounting across sources that track it (packed
        sources); sources without the stat count as fully dense."""
        fracs = []
        for name in sorted(self.sources):
            fracs.append(
                (self.weights[name],
                 getattr(self.sources[name], "non_pad_frac", 1.0))
            )
        total = sum(w for w, _ in fracs)
        return sum(w * f for w, f in fracs) / total if total else 1.0
