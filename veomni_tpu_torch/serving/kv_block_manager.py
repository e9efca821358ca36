"""Paged KV-cache block accounting (host side) with shared, refcounted blocks.

Copy of ``veomni_tpu/serving/kv_block_manager.py``.

The device arrays — ``[L, num_blocks, block_size, hkv, d]`` pools — live in
the engine; this manager owns the free list, per-block reference counts, and
the per-sequence block tables that index into them (vLLM's BlockSpaceManager
translated to what a single-host recompute-preemption engine needs).

Ownership model: blocks are **shared**, not exclusive. A block is in
exactly one of three states:

- **free** — on the free list; content is garbage.
- **active** — refcount >= 1: referenced by one or more sequence tables (a
  prefix-cache hit gives several sequences the same prompt blocks) or
  pinned as a copy-on-write source.
- **cached** — refcount == 0 but registered in the attached
  :class:`~veomni_tpu_torch.serving.prefix_cache.PrefixCache`: content is a valid
  full block of KV, kept warm for future prefix hits and **evictable** LRU
  when the pool runs dry. The effective free set is therefore
  ``free ∪ evictable`` — eviction always reclaims cached blocks before the
  scheduler ever has to preempt a running sequence.

Writes only ever target exclusively-owned blocks: full cached blocks are
immutable, partial tail blocks are never shared, and a sequence that must
write into a cached block (a fully-cached prompt recomputing its final
token) gets a **copy-on-write** replacement via
``allocate_shared(cow_src=...)`` — the engine device-copies the block's rows
before the write lands.

Block 0 is reserved as the **null block**: block tables handed to the
device are padded with it past each sequence's allocation, and inactive
decode slots write their garbage row into it, so every table entry is
always a valid pool index and no program ever branches on table length.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class KVBlockManager:
    NULL_BLOCK = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved null block)")
        if block_size < 1 or (block_size & (block_size - 1)):
            raise ValueError(f"block_size must be a power of two, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # deque: freed blocks are reused FIFO, keeping allocation deterministic
        self._free = deque(range(1, num_blocks))
        self._tables: Dict[str, List[int]] = {}
        self._ref = [0] * num_blocks
        # attached PrefixCache (duck-typed: num_evictable/evict_lru/has_block);
        # None keeps the manager's pre-cache exclusive-ownership behavior
        self._cache = None
        self.cow_count = 0  # copy-on-write allocations (divergence blocks)
        self.evictions = 0  # cached blocks reclaimed to satisfy allocations

    def attach_cache(self, cache) -> None:
        """Attach the prefix cache whose registered refcount-0 blocks extend
        the free list (``free ∪ evictable``). Called by the cache's own
        constructor so the two can never disagree about ownership."""
        self._cache = cache

    # ---------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        """Blocks an allocation can claim: truly free plus evictable cached
        (refcount-0) blocks the attached prefix cache would give back."""
        n = len(self._free)
        if self._cache is not None:
            n += self._cache.num_evictable()
        return n

    @property
    def num_free_uncached(self) -> int:
        """Blocks on the raw free list only (no eviction needed)."""
        return len(self._free)

    @property
    def num_used(self) -> int:
        """Blocks actively referenced by sequences (cached refcount-0 blocks
        are reclaimable, so they count as free, not used)."""
        return (self.num_blocks - 1) - self.num_free

    @property
    def num_cached(self) -> int:
        """Blocks registered in the prefix cache with refcount 0 (warm,
        evictable)."""
        return 0 if self._cache is None else self._cache.num_evictable()

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to hold ``n_positions`` cache rows (>= 1)."""
        return max(1, -(-int(n_positions) // self.block_size))

    def can_allocate(self, n_blocks: int) -> bool:
        return self.num_free >= n_blocks

    def num_allocated(self, seq_id: str) -> int:
        return len(self._tables.get(seq_id, ()))

    def table(self, seq_id: str) -> List[int]:
        if seq_id not in self._tables:
            raise KeyError(
                f"sequence {seq_id!r} has no block table: table() is only "
                "valid between allocate()/allocate_shared() and free_seq() "
                f"(currently allocated: {sorted(self._tables) or 'none'})"
            )
        return list(self._tables[seq_id])

    def utilization(self) -> float:
        """Fraction of allocatable (non-null) blocks actively in use."""
        return self.num_used / max(1, self.num_blocks - 1)

    # ------------------------------------------------------------- internals
    def _pop_block(self) -> int:
        """Claim one block: free list first, then LRU eviction from the
        prefix cache (cached blocks are reclaimed before any caller has to
        preempt)."""
        if self._free:
            return self._free.popleft()
        if self._cache is not None:
            blk = self._cache.evict_lru()
            if blk is not None:
                self.evictions += 1
                return blk
        raise RuntimeError(
            "out of KV blocks: free list empty and no evictable cached "
            "blocks"
        )

    def _take_ref(self, block: int) -> None:
        self._ref[block] += 1
        if (self._ref[block] == 1 and self._cache is not None
                and self._cache.has_block(block)):
            # a cached block leaving refcount 0 leaves the evictable set
            self._cache.note_referenced(block)

    def _release_ref(self, block: int) -> None:
        self._ref[block] -= 1
        assert self._ref[block] >= 0, f"refcount underflow on block {block}"
        if self._ref[block] == 0:
            if self._cache is not None and self._cache.has_block(block):
                # cached blocks stay warm in the prefix cache (evictable)
                self._cache.note_unreferenced(block)
            else:
                self._free.append(block)

    def reclaim_cached(self, block: int) -> None:
        """Return a refcount-0 block the prefix cache is dropping to the
        free list. Only the cache's flush/invalidation paths call this —
        normal eviction hands the block straight to the claimant via
        ``_pop_block`` and never lands it back on the free list."""
        if self._ref[block] != 0:
            raise RuntimeError(
                f"reclaim_cached(block={block}) with refcount "
                f"{self._ref[block]}: cache dropped a referenced block"
            )
        self._free.append(block)

    # ------------------------------------------------------------ transitions
    def allocate(self, seq_id: str, n_blocks: int) -> List[int]:
        table, _ = self.allocate_shared(seq_id, [], n_blocks)
        return table

    def allocate_shared(
        self,
        seq_id: str,
        shared: List[int],
        n_new: int,
        cow_src: Optional[int] = None,
    ) -> Tuple[List[int], List[int]]:
        """Build ``seq_id``'s table from ``shared`` (prefix-cache hits, one
        reference taken on each) plus ``n_new`` freshly claimed blocks.

        ``cow_src`` marks a copy-on-write divergence: the caller matched a
        cached block it must write into, so the last fresh block is its
        replacement. The source is **pinned** (refcounted) here so claiming
        the fresh blocks can never evict it before the engine's device copy;
        the engine releases the pin via :meth:`release_block` after copying.
        Returns ``(full table, fresh blocks)``."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already has blocks")
        # reference shared + pinned blocks FIRST: they leave the evictable
        # set before _pop_block can consider them
        for b in shared:
            self._take_ref(b)
        if cow_src is not None:
            self._take_ref(cow_src)
        if not self.can_allocate(n_new):
            for b in shared:
                self._release_ref(b)
            if cow_src is not None:
                self._release_ref(cow_src)
            raise RuntimeError(
                f"out of KV blocks: need {n_new}, free {self.num_free}"
            )
        fresh = [self._pop_block() for _ in range(n_new)]
        for b in fresh:
            self._ref[b] = 1
        if cow_src is not None:
            self.cow_count += 1
        self._tables[seq_id] = list(shared) + fresh
        return self.table(seq_id), fresh

    def grow(self, seq_id: str, n_blocks: int = 1) -> List[int]:
        if seq_id not in self._tables:
            raise KeyError(
                f"sequence {seq_id!r} has no block table to grow: grow() is "
                "only valid between allocate()/allocate_shared() and "
                f"free_seq() (currently allocated: "
                f"{sorted(self._tables) or 'none'})"
            )
        if not self.can_allocate(n_blocks):
            raise RuntimeError(
                f"out of KV blocks: need {n_blocks}, free {self.num_free}"
            )
        fresh = [self._pop_block() for _ in range(n_blocks)]
        for b in fresh:
            self._ref[b] = 1
        self._tables[seq_id].extend(fresh)
        return self.table(seq_id)

    def shrink(self, seq_id: str, n_keep: int) -> List[int]:
        """Release the sequence's trailing table entries down to ``n_keep``
        blocks — the speculative-decoding rollback: blocks claimed for
        drafted positions whose drafts were rejected go back to the pool
        the same tick they were claimed.

        Releases go through the shared refcount machinery
        (:meth:`_release_ref`), NOT straight to the free list: if a trailing
        block is somehow still shared (a refcount > 1 cached prefix block
        can never legally be a speculative claim, but the invariant is
        enforced here rather than assumed), shrinking this sequence only
        drops ITS reference — a rollback can never strand a block another
        sequence (or the prefix cache) still holds. Returns the released
        block ids (tail first)."""
        if seq_id not in self._tables:
            raise KeyError(
                f"sequence {seq_id!r} has no block table to shrink: shrink()"
                " is only valid between allocate()/allocate_shared() and "
                f"free_seq() (currently allocated: "
                f"{sorted(self._tables) or 'none'})"
            )
        if n_keep < 1:
            raise ValueError(f"shrink() must keep >= 1 block, got {n_keep}")
        table = self._tables[seq_id]
        released: List[int] = []
        while len(table) > n_keep:
            blk = table.pop()
            self._release_ref(blk)
            released.append(blk)
        return released

    def release_block(self, block: int) -> None:
        """Drop one reference taken outside a table (the copy-on-write
        source pin)."""
        self._release_ref(block)

    def free_seq(self, seq_id: str) -> int:
        """Release a sequence's references. Blocks whose refcount drops to 0
        return to the free list unless the prefix cache holds them (then
        they stay warm as evictable). Returns the number of table entries
        released."""
        blocks = self._tables.pop(seq_id, [])
        for b in blocks:
            self._release_ref(b)
        return len(blocks)
