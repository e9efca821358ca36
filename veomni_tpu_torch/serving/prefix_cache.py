"""Radix prefix cache: share prompt KV blocks across requests.

Copy of ``veomni_tpu/serving/prefix_cache.py``.

When millions of users share system prompts, most prefill FLOPs recompute
KV that already sits in the block pool. This module is the vLLM automatic-
prefix-caching idea over our :class:`KVBlockManager`: a radix tree keyed on
**block-aligned token chunks** (one node per full block, key = that block's
exact ``block_size`` token ids) mapping to pool block ids. Admission walks
the tree with the request's prompt and charges only the uncached suffix;
the matched blocks are shared by reference (the manager refcounts them).

Only *full* blocks are ever cached — a partial tail block is exclusively
owned by its sequence and still being written, so sharing it would let one
request corrupt another's context. Full blocks are registered when a
prefill completes and when a sequence releases its blocks (finish or
preemption: a preempted sequence's blocks staying cached is what turns
LIFO-recompute re-admission from a full re-prefill into a near-free hit).

Eviction is **LRU over refcount-0 leaves**: a cached block with no
references and no cached children is reclaimed first, ordered by a
monotonic access clock (deterministic — no wall time). Because a sequence
referencing a block also references every ancestor on its path (tables are
root paths of the tree), a refcount-0 node's descendants are refcount-0
too, so every refcount-0 cached block is transitively reclaimable and
``num_evictable()`` can count them all — the manager's ``free ∪ evictable``
accounting rests on this invariant.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from veomni_tpu_torch.serving.kv_block_manager import KVBlockManager


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_access")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_access = 0


class PrefixCache:
    """One instance per engine, attached to its block manager."""

    def __init__(self, manager: KVBlockManager):
        self.manager = manager
        self.block_size = manager.block_size
        self._root = _Node((), KVBlockManager.NULL_BLOCK, None)
        self._by_block: Dict[int, _Node] = {}
        self._clock = 0  # monotonic LRU clock: deterministic, no wall time
        # cached blocks with refcount 0, maintained incrementally on every
        # 0<->1 refcount transition (the manager notifies) — num_evictable()
        # sits on the per-tick hot path (can_allocate/utilization), so an
        # O(cached-blocks) scan there would cost O(slots x blocks) python
        # per generated token batch
        self._evictable = 0
        # weight-publication epoch: bumped by flush(). Cached KV is only
        # valid for the weights that produced it, so a weight swap flushes
        # the whole tree and advances the epoch — a cheap observable for
        # tests/metrics that stale entries cannot have survived
        self.epoch = 0
        manager.attach_cache(self)

    # ---------------------------------------------------------------- queries
    def __len__(self) -> int:
        """Number of cached blocks (any refcount)."""
        return len(self._by_block)

    def has_block(self, block: int) -> bool:
        return block in self._by_block

    def num_evictable(self) -> int:
        """Cached blocks with refcount 0. All are transitively reclaimable
        via repeated leaf eviction (see module docstring invariant)."""
        return self._evictable

    # --------------------------------------------- manager refcount callbacks
    def note_unreferenced(self, block: int) -> None:
        """A cached block's refcount dropped to 0: it is warm + evictable."""
        self._evictable += 1

    def note_referenced(self, block: int) -> None:
        """A cached block's refcount left 0: no longer evictable."""
        self._evictable -= 1
        assert self._evictable >= 0, "evictable count underflow"

    # ------------------------------------------------------------ transitions
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached block-aligned prefix of ``tokens``; returns the
        pool block ids in sequence order and bumps their LRU clocks. The
        caller must take references (``allocate_shared``) before claiming
        any new blocks, or the match could be evicted out from under it."""
        bs = self.block_size
        node = self._root
        out: List[int] = []
        t = self._tick()
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.last_access = t
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register ``blocks`` (full blocks, in sequence order, with
        ``tokens`` covering them exactly) under the radix tree. A chunk
        whose key already exists keeps the **existing** block — the caller's
        duplicate (e.g. a copy-on-write replacement) stays private and is
        freed normally when its references drop. Returns the number of
        blocks newly registered."""
        bs = self.block_size
        assert len(tokens) >= len(blocks) * bs, "tokens must cover blocks"
        node = self._root
        t = self._tick()
        added = 0
        for i, blk in enumerate(blocks):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                if blk in self._by_block:
                    # already cached under a different path — the engine flow
                    # never produces this; refuse to alias rather than corrupt
                    break
                child = _Node(key, blk, node)
                node.children[key] = child
                self._by_block[blk] = child
                if self.manager.refcount(blk) == 0:
                    # callers normally insert while still holding references
                    # (prefill completion / just before release), but a
                    # direct refcount-0 insert must land in the count too
                    self._evictable += 1
                added += 1
            child.last_access = t
            node = child
        return added

    def flush(self) -> int:
        """Drop EVERY cached block and return them to the manager's free
        list, bumping the cache epoch. This is the weight-publication
        invalidation: KV computed under the old weights must become
        unreachable before the first request runs on the new ones.

        The caller must have drained the engine first — a cached block
        still referenced by a live sequence cannot be invalidated without
        corrupting that sequence, so a referenced block is a hard error,
        not a skip. Blocks return to the free list in sorted order so the
        post-flush allocation sequence is deterministic. Returns the
        number of blocks flushed; the no-leak identity is conserved:
        ``num_cached`` drops to 0 and ``num_free_uncached`` grows by
        exactly the flushed count."""
        rc = self.manager.refcount
        held = sorted(b for b in self._by_block if rc(b) != 0)
        if held:
            raise RuntimeError(
                f"prefix cache flush with {len(held)} referenced cached "
                f"blocks (e.g. block {held[0]}): engine not drained"
            )
        flushed = sorted(self._by_block)
        for b in flushed:
            self.manager.reclaim_cached(b)
        self._root = _Node((), KVBlockManager.NULL_BLOCK, None)
        self._by_block = {}
        self._evictable = 0
        self.epoch += 1
        return len(flushed)

    def evict_lru(self) -> Optional[int]:
        """Remove and return the least-recently-used refcount-0 **leaf**
        block (evicting a parent would orphan cached children). Returns
        None when nothing is evictable. The scan is O(cached blocks) but
        runs only under pool pressure (the free list is already empty) —
        never on the per-tick accounting path."""
        rc = self.manager.refcount
        best: Optional[_Node] = None
        for b, node in self._by_block.items():
            if node.children or rc(b) != 0:
                continue
            if (best is None or node.last_access < best.last_access
                    or (node.last_access == best.last_access
                        and b < best.block)):
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        del self._by_block[best.block]
        self._evictable -= 1
        return best.block
