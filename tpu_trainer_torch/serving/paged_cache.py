"""Paged KV cache host side (port of ``tpu_trainer/serving/paged_cache.py``):
a refcounted block pool with free-list allocation, host mirrors, and a
copy-on-write prefix index.

The device side is ``models.gpt.init_paged_cache``: per-layer k/v pools
``[L, num_blocks, block_size, kvh, head_dim]`` (compute dtype or int8 +
scales), plus block tables, lengths and chunk offsets. The pools are the
only persistent device state — tables, lengths and offsets are copied
from the host mirrors kept here before every engine step, so all
scheduling (allocation, reclaim, preemption, prefix sharing) is plain
deterministic Python, identical to the JAX package's decision for
decision.

Block 0 is reserved as the null block: unallocated table entries point at
it and masked writes (prefill padding, idle slots) land there. Reads
always mask by length, so its contents are never observed.

**Prefix caching** (``prefix_cache=True``): full prompt blocks are
content-addressed by a chained blake2b digest (parent digest + the
block's token ids). A request whose leading full blocks hit the index
shares those physical blocks; the match is rounded down to a block
boundary strictly inside the prompt, so every write a request makes lands
in blocks it allocated privately (copy-on-write by construction). The
index holds one reference per entry; entries referenced by the index
alone form the LRU eviction pool that backstops allocation.

**The KV store** (``kv_store=``, ``serving/kv_store.py``): an evicted
prefix block is spilled into the store instead of forgotten, a
device-index miss falls through to the store and fills a fresh device
block, and a migrated request's raw tail block is written through
``fill_raw``. Device I/O is the owning engine's: it installs the hooks.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np


def chained_block_digests(tokens: List[int], block_size: int) -> List[bytes]:
    """Chained content digests of ``tokens``' FULL blocks: digest[i] =
    blake2b(digest[i-1] + block i's int32 token bytes)."""
    out: List[bytes] = []
    parent = b""
    for i in range(len(tokens) // block_size):
        blk = np.asarray(
            tokens[i * block_size:(i + 1) * block_size], np.int32)
        parent = hashlib.blake2b(
            parent + blk.tobytes(), digest_size=16).digest()
        out.append(parent)
    return out


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` blocks (id 0
    reserved). LIFO free list with deterministic order: the same request
    sequence always produces the same block ids."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros((num_blocks,), np.int32)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_blocks / (self.num_blocks - 1)

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks at refcount 1, or None (pool untouched) if short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        return out

    def retain(self, ids) -> None:
        """Add one reference to each (already-allocated) block."""
        for bid in ids:
            if not 0 < bid < self.num_blocks:
                raise ValueError(f"retaining invalid block id {bid}")
            if self._ref[bid] == 0:
                raise ValueError(f"retain of free block {bid}")
            self._ref[bid] += 1

    def free(self, ids) -> None:
        """Drop one reference per block; refcount-0 blocks return to the
        free list. Freeing a free block raises (double free)."""
        for bid in ids:
            if not 0 < bid < self.num_blocks:
                raise ValueError(f"freeing invalid block id {bid}")
            if self._ref[bid] == 0:
                raise ValueError(f"double free of block {bid}")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                self._free.append(bid)


class PagedKVCache:
    """Host mirrors (tables, lengths, pool, prefix index) for one engine's
    slot batch."""

    def __init__(self, config, slots: int, *, prefix_cache: bool = False,
                 kv_store=None):
        if not config.decode_paged:
            raise ValueError("PagedKVCache needs config.decode_paged=True")
        self.config = config
        self.slots = slots
        self.block_size = config.paged_block_size
        self.max_blocks = config.paged_max_blocks
        self.pool = BlockPool(config.paged_num_blocks)
        self.tables = np.zeros((slots, self.max_blocks), np.int32)
        self.lengths = np.zeros((slots,), np.int32)
        self._n_blocks = np.zeros((slots,), np.int32)  # allocated per slot
        # Prefix index: chained digest -> block id, LRU order (oldest
        # first). Each entry holds one pool reference.
        self.prefix_cache = prefix_cache
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self.n_prefix_evictions = 0
        # The store tier behind the device pool. The engine installs
        # ``spill_fn(digest, bid) -> bool`` (device block into the store),
        # ``fill_fn(digest, bid) -> tier | None`` (store bytes into a
        # device block), ``raw_fill_fn(bid, leaves) -> bool`` (a migrated
        # raw tail) and ``pricer`` (``kv_store.MigrationPricer``).
        self.store = kv_store
        self.spill_fn = None
        self.fill_fn = None
        self.raw_fill_fn = None
        self.pricer = None
        self.n_store_spills = 0
        self.n_store_declined = 0      # store hits priced out of transfer
        self.store_hit_tokens_host = 0
        self.store_hit_tokens_disk = 0

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens``."""
        return -(-n_tokens // self.block_size)

    def capacity_tokens(self) -> int:
        """Per-request token ceiling (the table width)."""
        return self.max_blocks * self.block_size

    def assign(self, slot: int, block_ids: List[int]) -> None:
        """Install an allocation into an empty slot's table row."""
        if self._n_blocks[slot] != 0:
            raise RuntimeError(f"slot {slot} not released")
        n = len(block_ids)
        if n > self.max_blocks:
            raise RuntimeError(f"slot {slot}: {n} blocks > table width")
        self.tables[slot, :n] = block_ids
        self._n_blocks[slot] = n

    def extend(self, slot: int, block_ids: List[int]) -> None:
        n0 = int(self._n_blocks[slot])
        n = len(block_ids)
        if n0 + n > self.max_blocks:
            raise RuntimeError(f"slot {slot} table overflow")
        self.tables[slot, n0:n0 + n] = block_ids
        self._n_blocks[slot] = n0 + n

    def slot_blocks(self, slot: int) -> List[int]:
        return [int(b) for b in self.tables[slot, :self._n_blocks[slot]]]

    def release(self, slot: int) -> None:
        """Drop the slot's references (blocks shared with the prefix index
        or other slots survive) and null its table row."""
        self.pool.free(self.slot_blocks(slot))
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self._n_blocks[slot] = 0

    def shrink(self, slot: int, keep_blocks: int) -> int:
        """Drop the slot's trailing blocks past ``keep_blocks`` — the
        speculative-decode rewind: blocks grown for a draft window the
        verifier rejected go back to the pool the same iteration. The
        tail past a request's cached tokens is always private (shared
        blocks are full prompt blocks at the front). Returns blocks
        freed."""
        n0 = int(self._n_blocks[slot])
        if keep_blocks >= n0:
            return 0
        if keep_blocks < 1:
            raise ValueError(f"shrink(slot={slot}, keep={keep_blocks})")
        tail = [int(b) for b in self.tables[slot, keep_blocks:n0]]
        self.pool.free(tail)
        self.tables[slot, keep_blocks:n0] = 0
        self._n_blocks[slot] = keep_blocks
        return len(tail)

    # -- prefix index ------------------------------------------------------

    def block_digests(self, tokens: List[int]) -> List[bytes]:
        return chained_block_digests(tokens, self.block_size)

    def prefix_lookup(self, prompt: List[int], *,
                      digests: Optional[List[bytes]] = None,
                      context_len: Optional[int] = None,
                      ) -> Tuple[List[int], int]:
        """Longest indexed prefix of ``prompt`` as ``(block_ids,
        matched_tokens)``, capped at the last full block strictly inside
        the context (at least one token is always fed). Hits touch the LRU
        order. The returned blocks carry ONE caller-owned reference each:
        the caller installs them in a slot table (``release`` drops it) or
        ``pool.free``s them when admission is abandoned. ``([], 0)`` when
        the index is off.

        ``context_len`` widens the cap for a request resuming with
        generated tokens (KV migration): every full prompt block is then
        matchable. A device-index miss falls through to the store: a
        stored digest fills a freshly allocated device block, adopted
        into the index. Each match is retained inside the walk, so a
        later digest's fill allocation cannot evict it."""
        if not self.prefix_cache:
            return [], 0
        ctx = len(prompt) if context_len is None else context_len
        k_max = max(0, min(len(prompt), ctx - 1) // self.block_size)
        if digests is None:
            digests = self.block_digests(prompt[:k_max * self.block_size])
        shared: List[int] = []
        for dig in digests[:k_max]:
            bid = self._prefix.get(dig)
            if bid is None:
                bid = self._store_fill(dig)
            if bid is None:
                break
            self.pool.retain([bid])
            self._prefix.move_to_end(dig)
            shared.append(bid)
        return shared, len(shared) * self.block_size

    def _store_fill(self, dig: bytes) -> Optional[int]:
        """Store fall-through for one missed digest: allocate a device
        block, fill it from the store, adopt it into the prefix index
        (the allocation's reference becomes the index's). None on a store
        miss, a pricer veto, or a dry pool."""
        if self.store is None or self.fill_fn is None:
            return None
        if not self.store.has(dig):
            return None
        if self.pricer is not None:
            nbytes = self.store.entry_nbytes(dig) or 0
            if not self.pricer.prefers_transfer(self.block_size, nbytes):
                self.n_store_declined += 1
                return None
        got = self.alloc_blocks(1)
        if got is None:
            return None
        bid = got[0]
        tier = self.fill_fn(dig, bid)
        if tier is None:
            self.pool.free([bid])
            return None
        self._prefix[dig] = bid
        if tier == "disk":
            self.store_hit_tokens_disk += self.block_size
        else:
            self.store_hit_tokens_host += self.block_size
        return bid

    def fill_raw(self, block_id: int, leaves) -> bool:
        """Write a migrated raw (tail) block's leaves into a private
        device block through the engine's hook. False without a hook or
        when the payload does not match the pool layout."""
        if self.raw_fill_fn is None:
            return False
        return bool(self.raw_fill_fn(block_id, leaves))

    def prefix_register(self, digest: bytes, block_id: int) -> bool:
        """Publish a freshly filled full block under its digest; the index
        takes its own reference. False when already indexed or off."""
        if not self.prefix_cache or digest in self._prefix:
            return False
        self.pool.retain([block_id])
        self._prefix[digest] = block_id
        return True

    @property
    def evictable_blocks(self) -> int:
        """Index entries whose block is referenced by the index alone."""
        return sum(1 for bid in self._prefix.values()
                   if self.pool.refcount(bid) == 1)

    @property
    def available_blocks(self) -> int:
        """Free blocks plus what LRU eviction could reclaim — the
        admission budget."""
        return self.pool.free_blocks + self.evictable_blocks

    @property
    def referenced_blocks(self) -> int:
        """Used blocks pinned by a live request. free + evictable +
        referenced == pool blocks."""
        return self.pool.used_blocks - self.evictable_blocks

    @property
    def prefix_index_entries(self) -> int:
        return len(self._prefix)

    def fragmentation(self) -> dict:
        """Free / evictable / referenced split of the pool plus the
        prefix-index size."""
        return {
            "pool_free_blocks": self.pool.free_blocks,
            "pool_evictable_blocks": self.evictable_blocks,
            "pool_referenced_blocks": self.referenced_blocks,
            "prefix_index_entries": len(self._prefix),
        }

    def alloc_blocks(self, n: int) -> Optional[List[int]]:
        """``pool.alloc`` with LRU prefix eviction as the backstop: pop
        index entries (oldest first) that only the index holds until the
        free list covers ``n``. With a store attached, a victim's device
        bytes are spilled into it before the block is freed."""
        while self.pool.free_blocks < n:
            victim = None
            for dig, bid in self._prefix.items():
                if self.pool.refcount(bid) == 1:
                    victim = dig
                    break
            if victim is None:
                return None
            bid = self._prefix.pop(victim)
            if self.store is not None and self.spill_fn is not None:
                if self.spill_fn(victim, bid):
                    self.n_store_spills += 1
            self.pool.free([bid])
            self.n_prefix_evictions += 1
        return self.pool.alloc(n)
