"""``observability/*`` metric declarations (counterpart of the names
``deepspeed_tpu/observability/metrics.py`` declares for what the port
emits: tracer ring health, static HBM residency, the live KV / tenant
occupancy gauges and the host cold tier's).  Declaring them puts them under the registry's
unknown-name runtime check.
"""

from __future__ import annotations

from deepspeed_tpu_torch.observability.registry import MetricsRegistry


def _declare(reg: MetricsRegistry) -> None:
    # tracer ring health (silent ring-wrap made visible)
    reg.counter("observability/dropped_spans",
                help="tracer ring records overwritten before export")
    reg.counter("observability/spans_recorded",
                help="total span/instant records ever written")
    reg.gauge("observability/spans_open",
              help="currently open (unfinished) spans")
    # static HBM residency
    reg.gauge("observability/hbm_*", unit="bytes",
              help="static HBM residency gauges")
    # live KV-pool occupancy (host-side bookkeeping reads only)
    reg.gauge("observability/kv_*",
              help="KV pool occupancy: blocks live/warm/evictable, "
                   "token + byte gauges")
    # host cold-tier gauges (kv_cache.host_tier): spooled / restored block
    # counters, tier residency, and the spool / restore latency
    # percentiles, declared exactly on top of the kv_* family
    reg.gauge("observability/kv_host_tier_bytes", unit="bytes",
              help="bytes of KV spooled to the host cold tier")
    reg.gauge("observability/kv_host_tier_blocks",
              help="blocks currently resident in the host cold tier")
    reg.counter("observability/kv_spooled_blocks",
                help="blocks ever demoted device -> host tier")
    reg.counter("observability/kv_restored_blocks",
                help="blocks restored host tier -> device on attach/resume")
    reg.counter("observability/kv_tier_dropped_blocks",
                help="tier entries dropped past the host byte budget")
    reg.gauge("observability/kv_spool_p50_s", unit="s",
              help="spool (gather -> host) latency p50 over a bounded "
                   "window")
    reg.gauge("observability/kv_spool_p95_s", unit="s",
              help="spool latency p95")
    reg.gauge("observability/kv_restore_p50_s", unit="s",
              help="restore (host -> scatter) latency p50, transfer "
                   "synchronized")
    reg.gauge("observability/kv_restore_p95_s", unit="s",
              help="restore latency p95")
    reg.gauge("observability/kv_spool_blocks_per_call_p50",
              help="blocks demoted per batched gather call (p50)")
    reg.gauge("observability/kv_restore_blocks_per_call_p50",
              help="blocks restored per batched scatter call (p50)")
    # per-tenant token occupancy over live requests
    reg.gauge("observability/tenant_tokens_*", unit="tokens",
              help="live token occupancy per tenant")


_declare(MetricsRegistry.default())
