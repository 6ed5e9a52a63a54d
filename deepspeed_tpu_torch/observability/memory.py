"""Live occupancy gauges (counterpart of the live half of
``deepspeed_tpu/observability/memory.py``).

:func:`kv_occupancy` / :func:`tenant_occupancy` / :func:`hbm_footprint`
read HOST-SIDE bookkeeping only (allocator free lists, refcounts,
``seen_tokens``, static geometry arithmetic): wiring them into a
:class:`~deepspeed_tpu_torch.observability.registry.MetricsRegistry`
provider adds no device sync to the steady-state tick.  The compile-time
memory ledger (``MemoryLedger``, ``virtual_mesh_probe``) is ROADMAP A11.

Every gauge name lives in the declared ``observability/*`` namespace
(:mod:`deepspeed_tpu_torch.observability.metrics`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def kv_occupancy(state_manager) -> Dict[str, float]:
    """KV-pool occupancy from allocator/refcount bookkeeping: blocks
    total/free/live, warm (radix-tree-held) and evictable counts, live
    token occupancy, and the derived byte gauges, plus the host cold
    tier's gauges when ``kv_cache.host_tier`` is on.  Reads NO device
    state."""
    alloc = state_manager.allocator
    kv = state_manager.kv_cache
    total = alloc.num_blocks - 1                     # trash block reserved
    free = alloc.free_blocks
    pc = state_manager.prefix_cache
    evictable = pc.evictable_blocks if pc is not None else 0
    warm = len(alloc._watched)
    live_tokens = sum(s.seen_tokens
                      for s in state_manager._seqs.values())
    # per_token_bytes is dtype-aware (int8 payload + scale records), so
    # the byte gauges stay truthful under KV quantization instead of
    # over-reporting bf16 bytes
    block_bytes = kv.block_size * kv.per_token_bytes
    out = {
        "observability/kv_blocks_total": float(total),
        "observability/kv_blocks_free": float(free),
        "observability/kv_blocks_live": float(total - free),
        "observability/kv_blocks_warm": float(warm),
        "observability/kv_blocks_evictable": float(evictable),
        "observability/kv_tokens_live": float(live_tokens),
        "observability/kv_pool_bytes": float(
            (total + 1) * block_bytes),
        "observability/kv_live_bytes": float(
            (total - free) * block_bytes),
        "observability/kv_sequences_live": float(
            state_manager.n_tracked_sequences),
    }
    tier = getattr(state_manager, "host_tier", None)
    if tier is not None:
        st = tier.stats
        out.update({
            # device-resident and host-restorable capacity, gauged apart:
            # tier entries never inflate kv_blocks_free — a restore
            # consumes real free blocks
            "observability/kv_host_tier_bytes": float(tier.bytes),
            "observability/kv_host_tier_blocks": float(len(tier)),
            "observability/kv_spooled_blocks": float(st.spooled_blocks),
            "observability/kv_restored_blocks": float(st.restored_blocks),
            "observability/kv_tier_dropped_blocks": float(
                st.dropped_blocks),
            "observability/kv_spool_p50_s": st.spool_pct(50),
            "observability/kv_spool_p95_s": st.spool_pct(95),
            "observability/kv_restore_p50_s": st.restore_pct(50),
            "observability/kv_restore_p95_s": st.restore_pct(95),
            # batched tier traffic: blocks moved per gather / scatter call
            # (a p50 of ~1 means the batching never engages)
            "observability/kv_spool_blocks_per_call_p50":
                st.spool_blocks_pct(50),
            "observability/kv_restore_blocks_per_call_p50":
                st.restore_blocks_pct(50),
        })
    return out


def tree_bytes(tree) -> float:
    """Bytes a tree (nested dicts / lists / tuples) of tensors occupies —
    metadata arithmetic only, no transfer."""
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, dict):
        return float(sum(tree_bytes(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return float(sum(tree_bytes(v) for v in tree))
    return 0.0


def hbm_footprint(params) -> Dict[str, float]:
    """Static HBM residency arithmetic: weight bytes.  Pure tree-shape
    arithmetic — no transfers.  (The JAX package's optional KV-pool term
    has no caller: ``kv_occupancy`` carries the pool bytes.)"""
    return {"observability/hbm_weights_bytes": tree_bytes(params)}


def tenant_occupancy(requests) -> Dict[str, float]:
    """Per-tenant token occupancy over live requests (scheduler queues):
    ``observability/tenant_tokens_<tenant>`` counts each live request's
    full token history.  Host-side list walk, bounded by max_seqs +
    queue depth."""
    out: Dict[str, float] = {}
    for req in requests:
        tenant = getattr(req, "tenant", None) or "default"
        key = f"observability/tenant_tokens_{tenant}"
        out[key] = out.get(key, 0.0) + float(len(req.history))
    return out


def make_occupancy_provider(engine, scheduler=None) -> Callable[
        [], Dict[str, float]]:
    """A registry provider closing over an engine (and optionally its
    scheduler, for tenant occupancy).  The engine's own
    ``occupancy()`` is the canonical gauge set (one body, not two);
    every read is host-side — safe to snapshot between steady-state
    decode ticks."""
    def provider() -> Dict[str, float]:
        out = engine.occupancy()
        if scheduler is not None:
            live = [*scheduler._queued, *scheduler._running.values(),
                    *scheduler._preempted]
            out.update(tenant_occupancy(live))
        return out

    return provider
