"""``observability/*`` metric declarations (counterpart of the names
``deepspeed_tpu/observability/metrics.py`` declares for what the port
emits: tracer ring health, static HBM residency and the live KV / tenant
occupancy gauges).  Declaring them puts them under the registry's
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
    # per-tenant token occupancy over live requests
    reg.gauge("observability/tenant_tokens_*", unit="tokens",
              help="live token occupancy per tenant")


_declare(MetricsRegistry.default())
