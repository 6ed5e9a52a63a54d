"""Host-memory cold tier for the blocked KV cache (counterpart of
``deepspeed_tpu/inference/v2/ragged/host_tier.py``; the ZeRO-Offload /
``swap_tensor`` idea aimed at inference: KV capacity far beyond device
memory).

The :class:`~deepspeed_tpu_torch.inference.v2.ragged.prefix_cache.
RadixPrefixCache` LRU-evicts refcount-1 leaves under KV pressure; with the
tier enabled those blocks are *spooled* — one block record of
``BlockedKVCache.gather_blocks(..., per_block=True)`` each, a host buffer of
its own (int8 payload and scale records travel together, so restored
contents are bit-exact) — instead of
destroyed, keyed by the full token prefix the block covers (KV content is
a pure function of the token prefix for a fixed engine, which is why a
content-keyed host copy can be re-attached later).
``DSStateManager.attach_prefix`` extends a radix match through the tier:
the hits get fresh device blocks, the payloads are scattered back, and the
blocks re-enter the tree, so an idle chat session resumes from host memory
with no recompute.

The tier itself is storage with LRU-ordered bookkeeping: a byte budget
(oldest entries drop first), latency deques for the spool / restore
percentiles the session-mix bench reports, and counters the
``observability/kv_*`` gauges export.  Capacity accounting stays truthful:
tier entries never count toward ``free_blocks`` — a restore always
consumes real device capacity through the normal allocator path.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Tuple


def _tree_nbytes(tree: Any) -> int:
    """Bytes of a (nested-dict) tree of host tensors or numpy arrays — the
    ``gather_blocks`` payload shape."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if hasattr(tree, "element_size"):            # a torch tensor
        return int(tree.numel() * tree.element_size())
    return int(getattr(tree, "nbytes", 0))


class HostTierStats:
    """Counters + bounded latency windows for the tier gauges.

    Spool/restore move BATCHES since the tier traffic was batched
    (``evict()`` hands the spool hook its whole victim list, restore
    scatters every contiguous hit at once): each ``spool_s``/
    ``restore_s`` sample is one dispatch+sync for N blocks, and the
    companion ``*_blocks_per_call`` windows record that N — the
    histogram that shows whether multi-block traffic amortises the
    per-call cost instead of paying it block by block."""

    __slots__ = ("spooled_blocks", "restored_blocks", "dropped_blocks",
                 "spool_s", "restore_s", "spool_blocks_per_call",
                 "restore_blocks_per_call")

    def __init__(self, latency_window: int = 2048):
        self.spooled_blocks = 0     # blocks ever written to the tier
        self.restored_blocks = 0    # blocks pulled back into HBM
        self.dropped_blocks = 0     # evicted past the byte budget
        self.spool_s: "collections.deque[float]" = collections.deque(
            maxlen=latency_window)
        self.restore_s: "collections.deque[float]" = collections.deque(
            maxlen=latency_window)
        # blocks moved per gather/scatter dispatch (one sample per call)
        self.spool_blocks_per_call: "collections.deque[int]" = \
            collections.deque(maxlen=latency_window)
        self.restore_blocks_per_call: "collections.deque[int]" = \
            collections.deque(maxlen=latency_window)

    @staticmethod
    def _pct(window, q: float) -> float:
        if not window:
            return 0.0
        import numpy as np

        return float(np.percentile(np.asarray(window, np.float64), q))

    def spool_pct(self, q: float) -> float:
        return self._pct(self.spool_s, q)

    def restore_pct(self, q: float) -> float:
        return self._pct(self.restore_s, q)

    def spool_blocks_pct(self, q: float) -> float:
        return self._pct(self.spool_blocks_per_call, q)

    def restore_blocks_pct(self, q: float) -> float:
        return self._pct(self.restore_blocks_per_call, q)

    def as_dict(self) -> Dict[str, float]:
        return {
            "spooled_blocks": float(self.spooled_blocks),
            "restored_blocks": float(self.restored_blocks),
            "dropped_blocks": float(self.dropped_blocks),
            "spool_p50_s": self.spool_pct(50),
            "spool_p95_s": self.spool_pct(95),
            "restore_p50_s": self.restore_pct(50),
            "restore_p95_s": self.restore_pct(95),
            "spool_blocks_per_call_p50": self.spool_blocks_pct(50),
            "spool_blocks_per_call_max": self.spool_blocks_pct(100),
            "restore_blocks_per_call_p50": self.restore_blocks_pct(50),
            "restore_blocks_per_call_max": self.restore_blocks_pct(100),
        }


class HostKVTier:
    """Content-keyed host store of spooled KV blocks.

    Keys are the full token prefix a block covers (a tuple of ints,
    length = tree depth * block_size); values are ``gather_blocks``
    block records, one block each.  ``get`` POPS — a restored block is
    HBM-resident and tree-held again, keeping exactly one owner per
    content so the byte gauge never double-counts.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        self.bytes = 0
        self.stats = HostTierStats()
        #: key -> (payload, nbytes), insertion == LRU order
        self._store: "collections.OrderedDict[Tuple[int, ...], Tuple[Any, int]]" = (
            collections.OrderedDict())

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._store

    def put(self, key, payload: Any, count_spool: bool = True) -> None:
        """Store one block's payload under its token-prefix key.
        ``count_spool=False`` re-inserts a payload that never left the
        tier (the restore-found-no-HBM-room put-back path)."""
        key = tuple(int(t) for t in key)
        old = self._store.pop(key, None)
        if old is not None:
            self.bytes -= old[1]
        n = _tree_nbytes(payload)
        self._store[key] = (payload, n)
        self.bytes += n
        if count_spool:
            self.stats.spooled_blocks += 1
        while (self.max_bytes is not None and self.bytes > self.max_bytes
               and self._store):
            _, (_, dropped) = self._store.popitem(last=False)
            self.bytes -= dropped
            self.stats.dropped_blocks += 1

    def get(self, key) -> Optional[Any]:
        """Pop and return the payload for ``key`` (None on miss)."""
        entry = self._store.pop(tuple(int(t) for t in key), None)
        if entry is None:
            return None
        payload, n = entry
        self.bytes -= n
        return payload

    def clear(self) -> int:
        n = len(self._store)
        self._store.clear()
        self.bytes = 0
        return n
