"""Digest-addressed tiered KV block store (port of
``tpu_trainer/serving/kv_store.py``, numpy only, decision for decision
the JAX package's).

The chained blake2b block digests (``paged_cache.chained_block_digests``)
are exact content addresses: a digest pins the block's tokens AND its
whole left context, so two engines that computed the same digest hold
the same K/V for that block (same reduce order, same quantization).
That makes the digest a safe cache key — this module is the tier behind
an engine's device pool:

    device pool (HBM)  ->  host DRAM tier (byte-budgeted LRU)
                       ->  optional disk tier (npz files, LRU)

``PagedKVCache`` spills refcount-1 prefix-index blocks here on LRU
eviction instead of destroying them, and ``prefix_lookup`` falls through
a device-index miss to a store hit, filling a fresh device block — so
admission skips prefill for any block an engine sharing the store has
ever computed. Engines in one process share one ``KVBlockStore`` object.

Tiers are exclusive: a disk hit promotes the entry to the host tier and
removes the file; host eviction writes it back out. Entries are lists of
numpy arrays — one per pool leaf of one block (``pool_k``/``pool_v`` and,
for int8 pools, ``scale_k``/``scale_v``; ``ServingEngine.read_block``),
dtype and shape preserved exactly (a bf16 leaf as its raw 2-byte words,
numpy void ``V2``), so fill-then-read round-trips bitwise.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


def leaves_nbytes(leaves: List[np.ndarray]) -> int:
    """Total payload bytes of one block entry."""
    return sum(int(a.nbytes) for a in leaves)


class KVBlockStore:
    """Digest-addressed block store: host-DRAM LRU over an optional
    disk tier.

    ``put`` is idempotent per digest (content-addressed — a duplicate
    put is by definition the same bytes) and never blocks: inserting
    past the byte budget evicts oldest-first, spilling to disk when a
    ``disk_dir`` is configured. ``get`` returns ``(tier, leaves)`` or
    None; hits touch the LRU order and promote disk entries to host.
    """

    def __init__(self, *, host_bytes: int = 64 << 20,
                 disk_dir: Optional[str] = None,
                 disk_bytes: int = 256 << 20):
        if host_bytes <= 0:
            raise ValueError(f"host_bytes={host_bytes}")
        self.host_budget = int(host_bytes)
        self.disk_budget = int(disk_bytes)
        self.disk_dir = disk_dir
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
        self._host: "OrderedDict[bytes, List[np.ndarray]]" = OrderedDict()
        self._host_nbytes: Dict[bytes, int] = {}
        self.host_bytes_used = 0
        self._disk: "OrderedDict[bytes, int]" = OrderedDict()  # digest -> nbytes
        self.disk_bytes_used = 0
        # Digests put since the last drain: the catalog feed a front end
        # reads to learn who holds what.
        self._new: List[bytes] = []
        self.reset_stats()

    def reset_stats(self) -> None:
        self.counters = {
            "puts": 0, "dup_puts": 0, "put_bytes": 0,
            "hits_host": 0, "hits_disk": 0, "misses": 0, "hit_bytes": 0,
            "evictions_host": 0, "evictions_disk": 0, "spills_to_disk": 0,
        }

    # -- tier bookkeeping --------------------------------------------------

    def _disk_path(self, digest: bytes) -> str:
        return os.path.join(self.disk_dir, digest.hex() + ".npz")

    def _disk_put(self, digest: bytes, leaves: List[np.ndarray],
                  nbytes: int) -> bool:
        """True when the entry landed on disk. An entry too big for the
        whole tier is rejected BEFORE the eviction loop — it could never
        fit, so evicting for it would just flush the tier for nothing."""
        if nbytes > self.disk_budget:
            return False
        while self._disk and self.disk_bytes_used + nbytes > self.disk_budget:
            old, old_n = self._disk.popitem(last=False)
            self.disk_bytes_used -= old_n
            self.counters["evictions_disk"] += 1
            try:
                os.remove(self._disk_path(old))
            except OSError:
                pass
        # Atomic publish: a torn write must never surface as a partial npz.
        fd, tmp = tempfile.mkstemp(dir=self.disk_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{f"a{i}": a for i, a in enumerate(leaves)})
            os.replace(tmp, self._disk_path(digest))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        self._disk[digest] = nbytes
        self.disk_bytes_used += nbytes
        return True

    def _disk_get(self, digest: bytes) -> Optional[List[np.ndarray]]:
        if digest not in self._disk:
            return None
        try:
            with np.load(self._disk_path(digest)) as z:
                leaves = [z[f"a{i}"] for i in range(len(z.files))]
        except (OSError, KeyError, ValueError):
            self.disk_bytes_used -= self._disk.pop(digest)
            return None
        return leaves

    def _disk_remove(self, digest: bytes) -> None:
        n = self._disk.pop(digest, None)
        if n is not None:
            self.disk_bytes_used -= n
            try:
                os.remove(self._disk_path(digest))
            except OSError:
                pass

    def _host_insert(self, digest: bytes, leaves: List[np.ndarray],
                     nbytes: int) -> bool:
        """True when the entry is actually held by SOME tier afterwards
        — the caller only counts/announces a put that stuck."""
        if nbytes > self.host_budget:
            # Oversized for the host tier entirely: disk or drop.
            return bool(self.disk_dir) and self._disk_put(
                digest, leaves, nbytes)
        while self._host and self.host_bytes_used + nbytes > self.host_budget:
            old, old_leaves = self._host.popitem(last=False)
            old_n = self._host_nbytes.pop(old)
            self.host_bytes_used -= old_n
            self.counters["evictions_host"] += 1
            if self.disk_dir and old not in self._disk:
                if self._disk_put(old, old_leaves, old_n):
                    self.counters["spills_to_disk"] += 1
        self._host[digest] = leaves
        self._host_nbytes[digest] = nbytes
        self.host_bytes_used += nbytes
        return True

    # -- public surface ----------------------------------------------------

    def put(self, digest: bytes, leaves: List[np.ndarray], *,
            announce: bool = True) -> bool:
        """Insert one block entry. Returns True only when the entry was
        actually stored in some tier: False (with an LRU touch) for a
        duplicate digest — content addressing makes the duplicate bytes
        identical by construction — and False for an entry no tier
        could hold, which is neither counted nor announced (the catalog
        must never advertise a digest the store doesn't have).
        ``announce=False`` skips the new-digest catalog feed — for
        blocks pushed by a front end, which knows them already."""
        if digest in self._host:
            self._host.move_to_end(digest)
            self.counters["dup_puts"] += 1
            return False
        if digest in self._disk:
            self.counters["dup_puts"] += 1
            return False
        leaves = [np.ascontiguousarray(a) for a in leaves]
        nbytes = leaves_nbytes(leaves)
        if not self._host_insert(digest, leaves, nbytes):
            return False
        self.counters["puts"] += 1
        self.counters["put_bytes"] += nbytes
        if announce:
            self._new.append(digest)
            # A standalone engine never drains the catalog feed; keep
            # only the newest announcements rather than growing without
            # bound.
            if len(self._new) > 4096:
                del self._new[:-4096]
        return True

    def get(self, digest: bytes) -> Optional[Tuple[str, List[np.ndarray]]]:
        """``(tier, leaves)`` for a stored digest, else None. Disk hits
        promote to the host tier (exclusive tiers)."""
        leaves = self._host.get(digest)
        if leaves is not None:
            self._host.move_to_end(digest)
            self.counters["hits_host"] += 1
            self.counters["hit_bytes"] += self._host_nbytes[digest]
            return "host", leaves
        leaves = self._disk_get(digest)
        if leaves is not None:
            self.counters["hits_disk"] += 1
            self.counters["hit_bytes"] += leaves_nbytes(leaves)
            self._disk_remove(digest)
            self._host_insert(digest, leaves, leaves_nbytes(leaves))
            return "disk", leaves
        self.counters["misses"] += 1
        return None

    def has(self, digest: bytes) -> bool:
        return digest in self._host or digest in self._disk

    def entry_nbytes(self, digest: bytes) -> Optional[int]:
        """Stored payload size without fetching (the admission pricer's
        transfer-bytes input)."""
        n = self._host_nbytes.get(digest)
        if n is not None:
            return n
        return self._disk.get(digest)

    def drain_new_digests(self) -> List[bytes]:
        out, self._new = self._new, []
        return out

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def stats(self) -> dict:
        s = {
            "host_entries": len(self._host),
            "host_bytes": self.host_bytes_used,
            "disk_entries": len(self._disk),
            "disk_bytes": self.disk_bytes_used,
        }
        s.update(self.counters)
        return s

    def clear(self) -> None:
        self._host.clear()
        self._host_nbytes.clear()
        self.host_bytes_used = 0
        for dig in list(self._disk):
            self._disk_remove(dig)
        self._new = []


@dataclasses.dataclass
class MigrationPricer:
    """Migration-vs-recompute admission pricing: both sides reduce to
    seconds on an analytic roofline — transfer moves ``nbytes`` over the
    link,
    recompute replays ``tokens`` forward passes at the device's peak.
    Admission takes the store/migration path only when transfer wins;
    otherwise it falls back to plain prefill, which is always correct
    (the digests guarantee either path produces identical K/V)."""

    flops_per_token: float       # forward FLOPs per token of this model
    device_flops: float          # peak FLOP/s of one serving device
    link_bytes_per_s: float      # host-to-host / host-DRAM transfer rate
    # Fixed cost of the prefill dispatch the transfer avoids (the step's
    # launches + host scheduling). Chunked prefill pays it per chunk, so
    # charging it per priced unit is the right order of magnitude; without
    # it the FLOP term alone claims a tiny model "recomputes" a block in
    # nanoseconds, which no real dispatch path can do.
    dispatch_overhead_s: float = 5e-4

    def recompute_s(self, tokens: int) -> float:
        return (self.dispatch_overhead_s
                + tokens * self.flops_per_token / max(1.0, self.device_flops))

    def transfer_s(self, nbytes: int) -> float:
        return nbytes / max(1.0, self.link_bytes_per_s)

    def prefers_transfer(self, tokens: int, nbytes: int) -> bool:
        return self.transfer_s(nbytes) <= self.recompute_s(tokens)
