"""Resilience telemetry: save latency, verify failures, resumes, rollbacks,
and the supervision series (restarts by reason, hangs, SIGKILL
escalations, blacklisted hosts, world size).

Counterpart of ``deepspeed_tpu/resilience/metrics.py``, with its counters,
``snapshot()`` keys and hooks.  The loop, the verified loader and
:class:`~deepspeed_tpu_torch.resilience.supervisor.JobSupervisor` call the
``record_*`` hooks; ``export(monitor)`` pushes ``resilience/*`` scalars
with a wall-clock float x to any object with a ``write_events(events)``
method and a true ``enabled`` attribute (the monitor fan-out is not
ported; ROADMAP A11).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.observability.registry import MetricsRegistry


def _declare(reg: MetricsRegistry) -> None:
    """Declare every ``resilience/*`` name :meth:`snapshot` emits."""
    for n in ("saves", "save_failures", "verify_failures", "fallbacks",
              "resumes", "rollbacks", "skipped_steps", "gc_deleted_tags",
              "restart_total", "restart_crash", "restart_hang",
              "restart_startup", "hangs", "escalations",
              "blacklisted_hosts"):
        reg.counter(f"resilience/{n}")
    for n in ("save_latency_s", "mean_save_latency_s", "restart_attempt",
              "restart_backoff_s", "world_size"):
        reg.gauge(f"resilience/{n}")


_declare(MetricsRegistry.default())


class ResilienceMetrics:
    def __init__(self, monitor=None):
        self.monitor = monitor
        self.saves = 0
        self.save_failures = 0
        self.last_save_latency_s = 0.0
        self.total_save_latency_s = 0.0
        self.verify_failures = 0
        self.fallbacks = 0
        self.resumes = 0
        self.rollbacks = 0
        self.skipped_steps = 0
        self.gc_deleted_tags = 0
        # supervision (JobSupervisor / the launcher's elastic loop)
        self.restarts = 0
        self.restart_crash = 0
        self.restart_hang = 0
        self.restart_startup = 0
        self.restart_attempt = 0
        self.last_restart_backoff_s = 0.0
        self.hangs = 0
        self.escalations = 0
        self.blacklisted_hosts = 0
        self.world_size = 0

    # -- hooks ---------------------------------------------------------- #
    def record_save(self, latency_s: float) -> None:
        self.saves += 1
        self.last_save_latency_s = float(latency_s)
        self.total_save_latency_s += float(latency_s)

    def record_save_failure(self) -> None:
        self.save_failures += 1

    def record_verify_failure(self, tag: str, problems: List[str]) -> None:
        self.verify_failures += 1

    def record_fallback(self, from_tag: str, to_tag: Optional[str]) -> None:
        self.fallbacks += 1

    def record_resume(self, tag: Optional[str], step: int) -> None:
        self.resumes += 1

    def record_rollback(self, at_step: int) -> None:
        self.rollbacks += 1

    def record_skip(self, step: int) -> None:
        self.skipped_steps += 1

    def record_gc(self, deleted: int) -> None:
        self.gc_deleted_tags += deleted

    # -- supervision hooks ---------------------------------------------- #
    def record_restart(self, reason: str, attempt: int, backoff_s: float,
                       world_before: int, world_after: int) -> None:
        """One worker-group restart (reason: "crash" | "hang" |
        "startup" — the worker died/stalled before its FIRST heartbeat:
        bad binary/config, not steady-state bad luck)."""
        self.restarts += 1
        if reason == "crash":
            self.restart_crash += 1
        elif reason == "hang":
            self.restart_hang += 1
        elif reason == "startup":
            self.restart_startup += 1
        self.restart_attempt = int(attempt)
        self.last_restart_backoff_s = float(backoff_s)
        self.world_size = int(world_after)

    def record_hang(self, host: str, age_s: float) -> None:
        self.hangs += 1

    def record_escalation(self, host: str) -> None:
        """A worker ignored SIGTERM and had to be SIGKILLed."""
        self.escalations += 1

    def record_blacklist(self, host: str) -> None:
        self.blacklisted_hosts += 1

    # -- aggregates ----------------------------------------------------- #
    def mean_save_latency_s(self) -> float:
        return self.total_save_latency_s / max(self.saves, 1)

    def snapshot(self) -> Dict[str, float]:
        return {
            "saves": float(self.saves),
            "save_failures": float(self.save_failures),
            "save_latency_s": self.last_save_latency_s,
            "mean_save_latency_s": self.mean_save_latency_s(),
            "verify_failures": float(self.verify_failures),
            "fallbacks": float(self.fallbacks),
            "resumes": float(self.resumes),
            "rollbacks": float(self.rollbacks),
            "skipped_steps": float(self.skipped_steps),
            "gc_deleted_tags": float(self.gc_deleted_tags),
            "restart_total": float(self.restarts),
            "restart_crash": float(self.restart_crash),
            "restart_hang": float(self.restart_hang),
            "restart_startup": float(self.restart_startup),
            "restart_attempt": float(self.restart_attempt),
            "restart_backoff_s": self.last_restart_backoff_s,
            "hangs": float(self.hangs),
            "escalations": float(self.escalations),
            "blacklisted_hosts": float(self.blacklisted_hosts),
            "world_size": float(self.world_size),
        }

    def export(self, monitor=None,
               now: Optional[float] = None) -> List[Tuple[str, float, float]]:
        monitor = monitor if monitor is not None else self.monitor
        wall = time.time() if now is None else now
        events = [(f"resilience/{k}", v, wall)
                  for k, v in self.snapshot().items()]
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events(events)
        return events

    def register_into(self, registry, key: str = "resilience") -> None:
        """Join the unified :class:`MetricsRegistry`: one ``snapshot()``/
        ``export()`` path alongside the serving/fleet providers."""
        registry.register_provider(
            key, lambda: {f"resilience/{k}": float(v)
                          for k, v in self.snapshot().items()})
