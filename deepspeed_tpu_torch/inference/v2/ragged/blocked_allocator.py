"""Block allocator for the paged KV cache (counterpart of
``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``; reference:
inference/v2/ragged/blocked_allocator.py ``BlockedAllocator`` — a linked-list
free list over int32 blocks; this is the same structure in plain python).

Block 0 is reserved as the *trash block*: padding tokens in a ragged batch
scatter their (garbage) KV writes there, so the device program needs no
branches for pad lanes.

Blocks are **ref-counted**: ``allocate`` hands out blocks at refcount 1,
``acquire`` adds a reference to a live block (prefix-cache sharing: several
sequences — plus the radix tree itself — can hold the same warm KV block),
and ``free`` drops one reference, returning the block to the
free list only when the count reaches zero.  Freeing a shared block
therefore *decrements*; only freeing an already-free block is a
double-free error (the PR-2 companion-set check, unchanged).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set


class BlockedAllocator:
    TRASH_BLOCK = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the trash block)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(1, num_blocks))  # 0 reserved
        # companion set: O(1) membership for the double-free check (the
        # list scan is O(n) per block -> O(n^2) per batch flush at serving
        # scale); the list still carries allocation ORDER
        self._free_set = set(self._free)
        #: references per live (allocated) block; absent -> free
        self._refs: Dict[int, int] = {}
        # watched blocks (the prefix cache's tree references) and how many
        # of them sit at refcount exactly 1 — kept in lockstep by
        # acquire/free so `watched_refcount1` (the cache's evictable-block
        # count, read on the scheduler's admission hot path) is O(1)
        # instead of a tree walk
        self._watched: Set[int] = set()
        self._watched_rc1 = 0
        #: called with the block id whenever a watched block's refcount
        #: DROPS to exactly 1 (it just became reclaimable) — the prefix
        #: cache uses this to keep its eviction heap incremental
        self.rc1_listener: Optional[Callable[[int], None]] = None

    @property
    def free_blocks(self) -> int:
        """reference blocked_allocator.py free_blocks property."""
        return len(self._free)

    def allocate(self, num_blocks: int) -> List[int]:
        """reference ``allocate``: returns block ids (each at refcount 1)
        or raises when exhausted."""
        if num_blocks > len(self._free):
            raise RuntimeError(
                f"KV cache exhausted: requested {num_blocks} blocks, "
                f"{len(self._free)} free")
        out, self._free = self._free[:num_blocks], self._free[num_blocks:]
        self._free_set.difference_update(out)
        for b in out:
            self._refs[b] = 1
        return out

    def _check_block_id(self, b: int) -> None:
        if b == self.TRASH_BLOCK:
            raise ValueError("cannot free the trash block")
        if not 0 < b < self.num_blocks:
            raise ValueError(f"invalid block id {b}")

    def refcount(self, block: int) -> int:
        """References held on ``block`` (0 for a free block)."""
        return self._refs.get(block, 0)

    def watch(self, block: int) -> None:
        """Mark a live block as tree-held so ``watched_refcount1`` counts
        it while its refcount is exactly 1 (i.e. only the watcher holds
        it).  Idempotent."""
        if block in self._watched:
            return
        self._watched.add(block)
        if self._refs.get(block, 0) == 1:
            self._watched_rc1 += 1

    def unwatch(self, block: int) -> None:
        """Stop watching ``block`` (the tree dropped its node).  Idempotent."""
        if block not in self._watched:
            return
        self._watched.remove(block)
        if self._refs.get(block, 0) == 1:
            self._watched_rc1 -= 1

    @property
    def watched_refcount1(self) -> int:
        """Watched blocks currently at refcount 1 — the prefix cache's
        evictable-block count, maintained O(1)."""
        return self._watched_rc1

    def acquire(self, blocks: Iterable[int]) -> None:
        """Add one reference to each live block (prefix-cache attach /
        copy-on-write sharing).  Acquiring a free block is an error — a
        reference can only be added to KV content somebody still owns."""
        blocks = list(blocks)
        for b in blocks:
            if b == self.TRASH_BLOCK:
                raise ValueError("cannot acquire the trash block")
            if not 0 < b < self.num_blocks:
                raise ValueError(f"invalid block id {b}")
            if b in self._free_set:
                raise ValueError(
                    f"acquire of free block {b} — its KV content is gone")
        for b in blocks:
            old = self._refs[b]
            self._refs[b] = old + 1
            if old == 1 and b in self._watched:
                self._watched_rc1 -= 1

    def free(self, blocks: Iterable[int]) -> None:
        """reference ``free``: drop one reference per listed block,
        returning blocks whose count hits zero to the free list.

        The whole call is validated before any state changes: a
        double-free (more releases than references, within this call or
        across calls) raises and leaves the allocator untouched.
        """
        blocks = list(blocks)
        drops: Dict[int, int] = {}
        for b in blocks:
            self._check_block_id(b)
            drops[b] = drops.get(b, 0) + 1
            if b in self._free_set or drops[b] > self._refs.get(b, 0):
                raise ValueError(f"double free of block {b}")
        freed = []
        for b in blocks:
            old = self._refs[b]
            self._refs[b] = old - 1
            if b in self._watched:
                if old == 2:
                    self._watched_rc1 += 1
                    if self.rc1_listener is not None:
                        self.rc1_listener(b)
                elif old == 1:            # watched block fully released
                    self._watched_rc1 -= 1
                    self._watched.remove(b)
            if self._refs[b] == 0:
                del self._refs[b]
                freed.append(b)
        self._free.extend(freed)
        self._free_set.update(freed)
