"""Sequence/KV state manager (counterpart of
``deepspeed_tpu/inference/v2/ragged/ragged_manager.py``; reference:
inference/v2/ragged/ragged_manager.py ``DSStateManager`` — tracks live
sequences and owns the blocked KV cache).

Host-side bookkeeping only: which sequences are live, how many KV blocks each
owns, and whether a proposed ragged batch fits the cache.  All device state
lives in :class:`BlockedKVCache`, which the forward updates in place.

With ``kv_cache.enable_prefix_cache`` the manager also owns a
:class:`RadixPrefixCache`: new sequences attach to warm KV blocks covering
their longest cached token prefix (:meth:`attach_prefix`), full blocks are
registered back into the tree as prefill/decode advances
(:meth:`register_prefix`), and allocation evicts cold cache entries under
KV pressure — ``free_blocks`` counts evictable warm blocks as free, so the
scheduler's admission view stays truthful.

With ``kv_cache.host_tier`` the prefix cache's LRU eviction spools cold
blocks to a :class:`HostKVTier` in host memory, and ``attach_prefix``
restores them (see ``_spool_nodes`` / ``_restore_blocks``).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig,
                                                        KVCacheConfig)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.host_tier import HostKVTier
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import (
    RadixPrefixCache)
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (
    DSSequenceDescriptor,
)


class DSStateManager:
    """reference ragged_manager.py:DSStateManager."""

    def __init__(self, config: DSStateManagerConfig,
                 kv_config: KVCacheConfig,
                 num_layers: int, num_kv_heads: int, head_dim: int,
                 dtype=None, device="cpu"):
        self.config = config
        self.kv_config = kv_config
        self.block_size = kv_config.block_size
        num_blocks = kv_config.num_blocks
        if num_blocks is None:
            # enough for max_ragged_sequence_count sequences at max_context,
            # +1 for the trash block
            per_seq = -(-config.max_context // self.block_size)
            num_blocks = config.max_ragged_sequence_count * per_seq + 1
        self.allocator = BlockedAllocator(num_blocks)
        kwargs = {}
        # precedence: explicit kv_cache.dtype string > legacy cache_dtype
        # > the model's compute dtype
        if getattr(kv_config, "dtype", None) is not None:
            kwargs["dtype"] = kv_config.dtype
        elif dtype is not None or kv_config.cache_dtype is not None:
            kwargs["dtype"] = kv_config.cache_dtype or dtype
        self.kv_cache = BlockedKVCache(num_layers, num_blocks, self.block_size,
                                       num_kv_heads, head_dim, device=device,
                                       **kwargs)
        self.prefix_cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.allocator, self.block_size)
            if kv_config.enable_prefix_cache else None)
        self.host_tier: Optional[HostKVTier] = None
        if kv_config.host_tier:
            if self.prefix_cache is None:
                raise ValueError(
                    "kv_cache.host_tier requires enable_prefix_cache — "
                    "cold blocks spool from the radix tree's LRU "
                    "eviction path")
            tier_bytes = kv_config.host_tier_bytes
            if tier_bytes is None:
                from deepspeed_tpu_torch.utils.logging import log_dist

                log_dist(
                    "kv_cache.host_tier with host_tier_bytes unset: "
                    "every LRU-evicted block spools to host memory and "
                    "stays until resumed — a long-running server with "
                    "non-repeating prompts grows host RSS without bound; "
                    "set kv_cache.host_tier_bytes to cap it",
                    level=logging.WARNING)
            self.host_tier = HostKVTier(max_bytes=tier_bytes)
            self.prefix_cache.spool_fn = self._spool_nodes
        self._seqs: Dict[int, DSSequenceDescriptor] = {}

    # ------------------------------------------------------------------ #
    # Sequence tracking (reference get_or_create_sequence / flush)
    # ------------------------------------------------------------------ #
    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_blocks(self) -> int:
        """Schedulable capacity: genuinely free blocks plus warm cache
        blocks nothing but the radix tree still references (allocation
        evicts those on demand)."""
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks
        return free

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is None:
            if len(self._seqs) >= self.config.max_tracked_sequences:
                raise RuntimeError(
                    f"too many tracked sequences "
                    f"({self.config.max_tracked_sequences})")
            seq = DSSequenceDescriptor(uid=uid)
            self._seqs[uid] = seq
        return seq

    def blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        return seq.tokens_needed_capacity(new_tokens, self.block_size)

    def _allocate(self, num_blocks: int) -> List[int]:
        """Allocate, evicting cold prefix-cache entries when the free list
        alone cannot cover the request."""
        short = num_blocks - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.allocator.allocate(num_blocks)

    def maybe_allocate_kv(self, seq: DSSequenceDescriptor,
                          new_tokens: int) -> None:
        """reference engine_v2.py maybe_allocate_kv: grow the block table."""
        need = self.blocks_needed(seq, new_tokens)
        if need:
            seq.blocks.extend(self._allocate(need))

    def flush_sequence(self, uid: int) -> None:
        """reference flush: release a finished sequence's KV blocks.
        Shared (prefix-cached) blocks just drop this sequence's reference
        — the radix tree keeps them warm for the next matching request."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            raise ValueError(f"unknown sequence uid {uid}")
        if seq.blocks:
            self.allocator.free(seq.blocks)

    def flush(self, uids: Iterable[int]) -> None:
        for uid in uids:
            self.flush_sequence(uid)

    # ------------------------------------------------------------------ #
    # Prefix cache (attach on admission, register as KV fills)
    # ------------------------------------------------------------------ #
    def attach_prefix(self, seq: DSSequenceDescriptor,
                      tokens: Sequence[int]) -> int:
        """Attach a FRESH sequence to the warm KV blocks covering its
        longest cached prefix of ``tokens``; returns the number of prompt
        tokens whose prefill is thereby skipped (0 on miss / cache off).

        At least one token is always left to run — the engine must still
        produce last-token logits — so a fully cached prompt attaches
        ``len(tokens) - 1`` positions, copy-on-write forking the final
        block (its last row gets rewritten by the re-run token, and shared
        blocks are never written).
        """
        cache = self.prefix_cache
        if (cache is None or seq.seen_tokens or seq.blocks or seq.pending
                or len(tokens) < 2):
            return 0
        cache.stats.lookups += 1
        blocks = cache.match_blocks(tokens)
        usable = len(tokens) - 1
        # Acquire the match BEFORE anything below can allocate (tier
        # restores, the cow fork): the matched blocks are tree-held at
        # refcount 1, and an allocation under pressure evicts exactly such
        # blocks — unprotected, a restore could recycle a block that is
        # already in this match list.
        self.allocator.acquire(blocks)
        if self.host_tier is not None:
            # extend the in-device match through the host cold tier: the
            # hits are restored (payload and scales, bit-exact) into fresh
            # device blocks that re-enter the tree, already holding the
            # sequence's reference
            blocks = blocks + self._restore_blocks(tokens, len(blocks),
                                                   usable)
        bs = self.block_size
        cached = min(len(blocks) * bs, usable)
        n_keep = -(-cached // bs)
        # match_blocks covers only full blocks of `tokens` and restores
        # stop at ceil(usable/bs), so the match can never exceed n_keep —
        # every acquired reference is kept
        if len(blocks) > n_keep:
            raise RuntimeError(
                f"prefix match of {len(blocks)} blocks exceeds the "
                f"{n_keep} blocks {usable} usable tokens need")
        if cached <= 0:
            cache.stats.misses += 1
            return 0
        cow = cached < n_keep * bs
        fresh: Optional[int] = None
        if cow:
            # Allocate the fork target with the match already acquired
            # (refcount >= 2), so eviction under pressure can reclaim cold
            # tree blocks but never the match itself.
            try:
                fresh = self._allocate(1)[0]
            except RuntimeError:
                # no room to fork the trimmed block: drop it from the match
                self.allocator.free([blocks[-1]])
                n_keep -= 1
                cached = n_keep * bs
                blocks = blocks[:n_keep]
                cow = False
                if cached <= 0:
                    cache.stats.misses += 1
                    return 0
        seq.blocks = list(blocks)
        seq.seen_tokens = cached
        seq.tokens = [int(t) for t in tokens[:cached]]
        seq.shared_blocks = n_keep
        if cow:
            self.kv_cache.copy_block(seq.blocks[-1], fresh)
            self.allocator.free([seq.blocks[-1]])     # drop our shared ref
            seq.blocks[-1] = fresh
            seq.shared_blocks = n_keep - 1
            # the tree already caches this content under the old block —
            # re-registering the fork would diverge, so stop here
            seq.register_stopped = True
            cache.stats.cow_forks += 1
        cache.stats.hits += 1
        cache.stats.hit_tokens += cached
        return cached

    def register_prefix(self, seq: DSSequenceDescriptor) -> None:
        """Register ``seq``'s newly completed full blocks into the radix
        tree (called wherever ``seen_tokens`` advances).  No-op unless the
        host knows the token values for every cached position."""
        cache = self.prefix_cache
        if cache is None or seq.register_stopped:
            return
        n_full = min(seq.seen_tokens // self.block_size, len(seq.blocks))
        if n_full <= seq.shared_blocks:
            return
        if len(seq.tokens) != seq.seen_tokens:
            seq.register_stopped = True   # values lost to the device
            return
        n, diverged = cache.insert(seq.tokens, seq.blocks,
                                   start_block=seq.shared_blocks)
        seq.shared_blocks += n
        if diverged:
            seq.register_stopped = True

    def record_fed_tokens(self, seq: DSSequenceDescriptor, tokens) -> None:
        """Append host-known token values the engine just wrote KV for
        (keeps ``seq.tokens`` in lockstep with ``seen_tokens``)."""
        if self.prefix_cache is None or seq.register_stopped:
            return
        seq.tokens.extend(int(t) for t in tokens)

    # ------------------------------------------------------------------ #
    # Host cold tier (kv_cache.host_tier): spool on LRU evict, restore on
    # attach.  free_blocks stays truthful — tier entries are not device
    # capacity; a restore consumes real free blocks through _allocate.
    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        if self.kv_cache.device.type == "cuda":
            torch.cuda.synchronize(self.kv_cache.device)

    def _spool_nodes(self, nodes) -> None:
        """Prefix-cache eviction hook: demote the whole victim batch to
        host memory — one ``gather_blocks`` call and one synchronization
        for every victim block — as one block record each, keyed by the
        token prefix the block completes.  Each record is a buffer of its
        own, not a view of a shared gather buffer, so the tier's byte
        budget releases memory as it drops entries.  Runs on the
        allocation path under KV pressure, never on a pressure-free
        decode tick."""
        cache = self.prefix_cache
        tier = self.host_tier
        # keys read the parent chains first — evict() guarantees they are
        # intact when it calls the hook
        keys = [cache.node_tokens(n) for n in nodes]
        t0 = time.perf_counter()
        records = self.kv_cache.gather_blocks([n.block for n in nodes],
                                              per_block=True)
        tier.stats.spool_s.append(time.perf_counter() - t0)
        tier.stats.spool_blocks_per_call.append(len(nodes))
        for key, record in zip(keys, records):
            tier.put(key, record)

    def _restore_blocks(self, tokens: Sequence[int], depth: int,
                        usable: int) -> List[int]:
        """Pull spooled continuation blocks of ``tokens`` (tree depth
        ``depth`` onward) back to the device while they cover usable
        prompt positions.  The whole contiguous run of tier hits restores
        in one ``scatter_blocks`` call and one synchronization: the hits
        are popped first, their device blocks allocated in one
        :meth:`_allocate` call (which may itself evict and spool colder
        blocks, batched too), the block records scattered together in one
        host-to-device transfer, then each block re-enters the radix tree
        holding the fresh refcount-1 reference as the tree's own, with the
        attaching sequence's reference acquired on top.  Nothing allocates
        between the scatter and those acquires, so no eviction can recycle
        a block this match is about to use.  Hits the device cannot admit go back
        to the tier (never recounted as spools)."""
        tier = self.host_tier
        cache = self.prefix_cache
        bs = self.block_size
        keys: List[tuple] = []
        payloads: List[dict] = []
        i = depth
        while i * bs < usable:
            key = tuple(int(t) for t in tokens[:(i + 1) * bs])
            payload = tier.get(key)
            if payload is None:
                break
            keys.append(key)
            payloads.append(payload)
            i += 1
        if not keys:
            return []
        # allocate for as many hits as the device admits (deepest-first
        # surrender keeps the restored span a contiguous prefix)
        blks: List[int] = []
        while keys:
            try:
                blks = self._allocate(len(keys))
                break
            except RuntimeError:
                tier.put(keys.pop(), payloads.pop(), count_spool=False)
        if not blks:
            return []
        t0 = time.perf_counter()
        self.kv_cache.scatter_blocks(blks, payloads)
        # the copies are asynchronous: synchronize so the restore latency
        # measures the transfer, not the launch
        self._sync()
        tier.stats.restore_s.append(time.perf_counter() - t0)
        tier.stats.restore_blocks_per_call.append(len(blks))
        tier.stats.restored_blocks += len(blks)
        for key, blk in zip(keys, blks):
            cache.insert_restored(key, blk)
            self.allocator.acquire([blk])
        return blks
