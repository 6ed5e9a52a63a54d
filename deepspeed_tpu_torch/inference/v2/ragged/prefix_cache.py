"""Radix-tree prefix cache over the blocked KV pool (counterpart of
``deepspeed_tpu/inference/v2/ragged/prefix_cache.py``; the vLLM automatic-
prefix-caching / SGLang RadixAttention idea, recast at KV-block granularity
over :class:`BlockedAllocator`).

Requests that share a token prefix — a fleet-wide system prompt, a few-shot
header, a preempted request's own history on resume — attach to the warm KV
blocks the first request wrote instead of re-prefilling them.  The tree is
keyed by *token content*: each node covers exactly one KV block
(``block_size`` tokens), its edge label is that block's token tuple, and its
payload is the block id in the paged pool.  KV content at block ``i`` is a
pure function of the token prefix, so any sequence whose tokens match a
root path can read those blocks verbatim.

Ownership protocol (refcounts live in the allocator):

* every cached block carries ONE tree reference;
* a sequence attaching to a cached prefix ``acquire``\\s +1 per block, and
  its normal ``flush`` releases it — warm blocks survive the sequence;
* a *write* into a shared block is forbidden; the state manager
  copy-on-write forks the block first (fresh private block, device copy);
* eviction walks least-recently-used leaves whose refcount is 1 (held by
  the tree alone) and frees them — blocks any live sequence still reads
  are never evicted.

Everything here is host-side bookkeeping; the only device work the cache
ever *causes* is the COW block copy, issued by the state manager.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixCacheStats:
    """Counters the serving metrics / bench layers report."""

    lookups: int = 0
    hits: int = 0                 # lookups that attached >= 1 cached token
    misses: int = 0
    hit_tokens: int = 0           # prefill tokens served from cache
    inserted_blocks: int = 0
    evicted_blocks: int = 0
    cow_forks: int = 0

    #: every counter ``attach_prefix`` advances — the scheduler snapshots
    #: these around an attach so a discarded (deferred) attach rolls back
    #: cleanly; eviction/insert counters stay out (those block frees and
    #: registrations really happened)
    ATTACH_COUNTERS = ("lookups", "hits", "misses", "hit_tokens",
                       "cow_forks")

    def attach_snapshot(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self.ATTACH_COUNTERS}

    def restore_attach(self, snap: Dict[str, int]) -> None:
        for f, v in snap.items():
            setattr(self, f, v)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def as_dict(self) -> Dict[str, float]:
        return {
            "lookups": float(self.lookups),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "hit_rate": self.hit_rate,
            "hit_tokens": float(self.hit_tokens),
            "inserted_blocks": float(self.inserted_blocks),
            "evicted_blocks": float(self.evicted_blocks),
            "cow_forks": float(self.cow_forks),
        }


class _Node:
    """One cached KV block: edge label ``key`` (its block's token tuple),
    pool block id, and an LRU stamp."""

    __slots__ = ("key", "block", "children", "parent", "stamp", "queued")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = 0
        self.queued = False   # has a live entry in the eviction heap


class RadixPrefixCache:
    """Block-granular radix tree mapping token prefixes to warm KV blocks.

    The cache does not own device memory — it holds *references* on pool
    blocks through the allocator, and the engine's normal block tables
    point at them.  All methods are O(prefix length) except :meth:`evict`
    (O(cached nodes), called only under KV pressure).
    """

    def __init__(self, allocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self._n_nodes = 0
        self.stats = PrefixCacheStats()
        # incremental eviction state: node per cached block, plus a lazy-
        # deletion min-heap of (stamp, id, node) eviction candidates fed
        # by the allocator's refcount-drops-to-1 transitions — evict()
        # never has to walk the tree
        self._by_block: Dict[int, _Node] = {}
        self._evict_heap: List[Tuple[int, int, _Node]] = []
        allocator.rc1_listener = self._note_evictable

    def _note_evictable(self, block: int) -> None:
        """Allocator callback: ``block``'s refcount just dropped to 1
        (tree-only).  If its node is a leaf it becomes an eviction
        candidate now; interior nodes become candidates when their last
        child is evicted (see :meth:`evict`).

        ``queued`` keeps at most one live heap entry per node — without it
        a server that never reaches KV pressure (evict() never pops) leaks
        one tuple per warm attach/flush cycle for its whole lifetime."""
        node = self._by_block.get(block)
        if node is not None and not node.children and not node.queued:
            node.queued = True
            heapq.heappush(self._evict_heap, (node.stamp, id(node), node))

    # ------------------------------------------------------------------ #
    # Lookup
    # ------------------------------------------------------------------ #
    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        bs = self.block_size
        node, path = self._root, []
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match_blocks(self, tokens: Sequence[int],
                     touch: bool = True) -> List[int]:
        """Pool block ids covering the longest cached prefix of ``tokens``
        (full blocks only).  ``touch`` refreshes the path's LRU stamps —
        :meth:`match_len` probes with ``touch=False`` (a probe is not a
        use)."""
        path = self._walk(tokens)
        if touch and path:
            stamp = next(self._clock)
            for n in path:
                n.stamp = stamp
        return [n.block for n in path]

    def match_len(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix of ``tokens`` in tokens, without touching
        LRU state."""
        return len(self.match_blocks(tokens, touch=False)) * self.block_size

    def lookup_continuation(self, tokens: Sequence[int],
                            k: int) -> List[int]:
        """Up to ``k`` cached token values that follow ``tokens`` along the
        tree — the speculative drafter's probe: if an earlier request
        already generated through this exact history, the deeper edge
        labels predict the continuation verbatim.

        ``tokens`` must lie entirely on a cached path (full blocks plus a
        partial tail that prefix-matches one child's edge label); otherwise
        returns ``[]``.  Never touches LRU stamps.
        """
        if k <= 0:
            return []
        bs = self.block_size
        toks = [int(t) for t in tokens]
        path = self._walk(toks)
        if len(path) < len(toks) // bs:
            return []                  # the history leaves the cached paths
        node = path[-1] if path else self._root
        tail = tuple(toks[(len(toks) // bs) * bs:])
        out: List[int] = []
        while len(out) < k:
            nxt = None
            for key, child in node.children.items():
                if key[:len(tail)] == tail:
                    nxt = (key[len(tail):], child)
                    break
            if nxt is None:
                break
            label_rest, node = nxt
            out.extend(label_rest)
            tail = ()
        return out[:k]

    # ------------------------------------------------------------------ #
    # Insert
    # ------------------------------------------------------------------ #
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               start_block: int = 0) -> Tuple[int, bool]:
        """Register ``blocks[start_block:]`` (full blocks of ``tokens``)
        under the tree, taking one tree reference per newly inserted block.

        Returns ``(n_registered, diverged)`` where ``n_registered`` counts
        blocks now reachable through the tree from ``start_block`` on, and
        ``diverged`` is True when an existing node already caches the same
        token content under a DIFFERENT block id (two requests prefilled
        the same prompt concurrently) — the caller's block stays private
        and registration stops, keeping each sequence's shared region a
        leading prefix.
        """
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        node = self._root
        for i in range(start_block):
            node = node.children[tuple(tokens[i * bs:(i + 1) * bs])]
        stamp = next(self._clock)
        registered = 0
        for i in range(start_block, n_full):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is not None:
                if child.block != blocks[i]:
                    return registered, True
                child.stamp = stamp
            else:
                child = _Node(key, int(blocks[i]), node)
                self.allocator.acquire([blocks[i]])
                self._by_block[int(blocks[i])] = child
                self.allocator.watch(int(blocks[i]))
                node.children[key] = child
                child.stamp = stamp
                self._n_nodes += 1
                self.stats.inserted_blocks += 1
            node = child
            registered += 1
        return registered, False

    # ------------------------------------------------------------------ #
    # Eviction
    # ------------------------------------------------------------------ #
    @property
    def cached_blocks(self) -> int:
        return self._n_nodes

    @property
    def evictable_blocks(self) -> int:
        """Blocks only the tree still references (refcount 1).  Live
        sequences hold root-contiguous paths, so refcounts are
        non-increasing with depth and every refcount-1 subtree can be
        evicted leaf-first — this count is genuinely reclaimable.

        O(1): the allocator maintains the count across refcount
        transitions of watched (tree-held) blocks — this property sits on
        the scheduler's admission hot path via ``DSStateManager.free_blocks``."""
        return self.allocator.watched_refcount1

    def evict(self, want: int) -> int:
        """Free up to ``want`` blocks, least-recently-used leaves first
        (a freed leaf may expose its parent as the next candidate).
        Returns the number of blocks actually freed.

        The candidate heap is persistent and fed incrementally — by the
        allocator's refcount-drops-to-1 callback and by parent exposure
        here — so a call under steady KV pressure is O(want log nodes)
        plus lazy-deletion skips, never a tree walk (this runs on every
        block allocation once the pool is warm).  The victims' blocks are
        freed in one allocator call."""
        freed = 0
        heap = self._evict_heap
        victims: List[_Node] = []
        while freed < want and heap:
            stamp, _, victim = heapq.heappop(heap)
            victim.queued = False
            if (self._by_block.get(victim.block) is not victim
                    or victim.children
                    or self.allocator.refcount(victim.block) != 1):
                continue        # stale: evicted, grew children, or re-shared
            if stamp != victim.stamp:
                # LRU-touched since queued: re-queue at its current stamp
                victim.queued = True
                heapq.heappush(heap, (victim.stamp, id(victim), victim))
                continue
            # detach from the tree now (victim.parent stays intact: the
            # parent-exposure step below reads it)
            del victim.parent.children[victim.key]
            del self._by_block[victim.block]
            self.allocator.unwatch(victim.block)
            self._n_nodes -= 1
            self.stats.evicted_blocks += 1
            victims.append(victim)
            freed += 1
            parent = victim.parent
            if (parent is not self._root and not parent.children
                    and not parent.queued
                    and self.allocator.refcount(parent.block) == 1):
                parent.queued = True
                heapq.heappush(heap, (parent.stamp, id(parent), parent))
        if victims:
            self.allocator.free([v.block for v in victims])
        return freed
