"""Observability layer of the serving stack (counterpart of
``deepspeed_tpu/observability/``): request-scoped tracing, the unified
metrics registry and the live occupancy gauges.  The flight recorder,
roofline attribution and the compile-time memory ledger are ROADMAP A11.

Typical use::

    from deepspeed_tpu_torch.observability import Tracer, write_chrome_trace

    tracer = Tracer(tid="replica0")
    sched = ContinuousBatchScheduler(engine, tracer=tracer)
    ...drive traffic...
    write_chrome_trace("trace.json", tracer.export_events())
    # -> load in https://ui.perfetto.dev
"""

from deepspeed_tpu_torch.observability import metrics as _metrics  # noqa: F401
from deepspeed_tpu_torch.observability.memory import (hbm_footprint,
                                                      kv_occupancy,
                                                      make_occupancy_provider,
                                                      tenant_occupancy)
from deepspeed_tpu_torch.observability.registry import (MetricSpec,
                                                        MetricsRegistry,
                                                        default_registry)
from deepspeed_tpu_torch.observability.tracer import (
    Tracer, annotate, device_annotations_enabled, enable_device_annotations,
    load_chrome_trace, merge_events, mint_trace_id, step_annotation,
    write_chrome_trace)

__all__ = ["MetricSpec", "MetricsRegistry", "Tracer", "annotate",
           "default_registry", "device_annotations_enabled",
           "enable_device_annotations", "hbm_footprint", "kv_occupancy",
           "load_chrome_trace", "make_occupancy_provider", "merge_events",
           "mint_trace_id", "step_annotation", "tenant_occupancy",
           "write_chrome_trace"]
