"""Per-request SLO metrics and aggregate serving telemetry.

Counterpart of ``deepspeed_tpu/serving/metrics.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

Tracks, per request: TTFT (arrival -> first token), TPOT (mean inter-token
latency), queue wait (arrival -> first scheduled), and preemption count;
and in aggregate: p50/p95 percentiles plus rolling tokens/s goodput
(completed-request tokens only — tokens thrown away by preemption recompute
don't count, which is what makes it goodput rather than throughput).

``export()`` pushes ``serving/*`` scalars through the existing
``MonitorMaster`` (the JAX package's ``monitor/``; any object with
``enabled`` and ``write_events`` serves) fan-out
(TensorBoard / WandB / CSV).  Serving has no training step counter, so
events carry a WALL-CLOCK x value (float seconds) — the monitor writers
accept float steps for exactly this (see monitor.py ``Event``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.observability.registry import MetricsRegistry
from deepspeed_tpu_torch.serving.request import Request


def _declare(reg: MetricsRegistry) -> None:
    """Declare every ``serving/*`` name this module (and the scheduler's
    extra telemetry) can emit — the contract the metric-name lint checks
    string literals against and the exposition types names with."""
    for n in ("submitted", "rejected", "finished", "failed",
              "deadline_exceeded", "shutdown_failed", "preemptions",
              "handoffs", "preempted_requests", "total_tokens",
              "decode_ticks", "decode_tokens_delivered",
              "fast_decode_ticks"):
        reg.counter(f"serving/{n}")
    for n in ("preemption_rate", "goodput_tokens_per_s",
              "overall_tokens_per_s", "tokens_per_decode_tick",
              "tokens_per_request_tick", "tpot_delivered_s"):
        reg.gauge(f"serving/{n}", unit="s" if n.endswith("_s") else "")
    reg.histogram("serving/p50_*", help="rolling percentile series")
    reg.histogram("serving/p95_*", help="rolling percentile series")
    #: scheduler-attached telemetry families (speculative decode stats,
    #: radix prefix-cache stats) — derived names, declared as families
    reg.gauge("serving/spec_*", help="speculative decoding stats")
    reg.gauge("serving/prefix_*", help="radix prefix-cache stats")


_declare(MetricsRegistry.default())


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class ServingMetrics:
    """Aggregates request lifecycles into SLO telemetry.

    The scheduler calls the ``record_*`` hooks; everything derived (TTFT,
    TPOT, queue wait) is read off the :class:`Request`'s own timestamps so
    there is exactly one source of per-request truth.
    """

    def __init__(self, monitor=None, window_s: float = 10.0):
        self.monitor = monitor
        self.window_s = window_s
        self.started = time.monotonic()
        self.submitted = 0
        self.rejected = 0                # bounded-queue admission rejects
        self.finished = 0
        self.failed = 0
        self.deadline_exceeded = 0       # failed with reason "deadline"
        self.shutdown_failed = 0         # failed with reason "shutdown"
        self.preemptions = 0
        self.handoffs = 0                # requests handed to another replica
        self.preempted_requests = 0      # ever preempted (incl. in-flight)
        self._terminal_preempted = 0     # preempted AND reached a terminal state
        self.total_tokens = 0            # tokens of FINISHED requests only
        self.ttft_s: List[float] = []
        self.tpot_s: List[float] = []
        self.queue_wait_s: List[float] = []
        #: (emit time, 1) per goodput-counted token, for the rolling rate
        self._token_times: Deque[float] = deque()
        # -- decode-tick accounting ------------------------------------ #
        # TPOT derived here divides by tokens DELIVERED per tick, not by
        # tick count: the moment multi-token speculative acceptance
        # lands, one decode tick emits several tokens and the old
        # one-token-per-tick assumption overstates per-token latency by
        # the acceptance factor.  The raw per-tick latency list is kept
        # as its own derived series (p50/p95_decode_tick_s).
        self.decode_ticks = 0
        self.decode_tick_tokens = 0
        self.decode_tick_requests = 0
        self._decode_tick_time_s = 0.0
        #: request-seconds: Σ elapsed * batched-requests — dividing by
        #: tokens delivered gives the mean inter-token latency a REQUEST
        #: experiences (batch-independent, acceptance-aware)
        self._decode_req_seconds = 0.0
        self.decode_tick_s: List[float] = []

    # ------------------------------------------------------------------ #
    # Lifecycle hooks
    # ------------------------------------------------------------------ #
    def record_submit(self, req: Request) -> None:
        self.submitted += 1

    def record_reject(self, req: Request) -> None:
        self.rejected += 1

    def record_preemption(self, req: Request) -> None:
        self.preemptions += 1
        if req.preemptions == 1:
            self.preempted_requests += 1

    def record_handoff(self, req: Request) -> None:
        """The request left this scheduler ALIVE (drain-handoff or
        prefill→decode migration) — neither finished nor failed here."""
        self.handoffs += 1

    def record_decode_tick(self, tokens: int, requests: int,
                           elapsed_s: float) -> None:
        """One pure-decode scheduler tick batched ``requests`` requests
        and delivered ``tokens`` tokens in ``elapsed_s`` seconds.
        ``tokens == requests`` on a plain decode tick; speculative
        acceptance delivers more."""
        self.decode_ticks += 1
        self.decode_tick_tokens += int(tokens)
        self.decode_tick_requests += int(requests)
        self._decode_tick_time_s += float(elapsed_s)
        self._decode_req_seconds += float(elapsed_s) * int(requests)
        self.decode_tick_s.append(float(elapsed_s))

    def tpot_delivered_s(self) -> float:
        """Per-request inter-token latency, dividing by tokens DELIVERED
        per tick — the TPOT that stays truthful under multi-token
        (speculative) acceptance.  Request-seconds over tokens: on plain
        one-token-per-request ticks this reduces to the mean tick time
        (the old TPOT); under acceptance it shrinks by the per-request
        tokens-per-tick factor, exactly as a client experiences."""
        return self._decode_req_seconds / max(self.decode_tick_tokens, 1)

    def record_finish(self, req: Request) -> None:
        now = time.monotonic()
        req.finish_time = now
        if req.preemptions > 0:
            self._terminal_preempted += 1
        if req.state.value == "failed":
            self.failed += 1
            if req.finish_reason == "deadline":
                self.deadline_exceeded += 1
            elif req.finish_reason == "shutdown":
                self.shutdown_failed += 1
            return
        self.finished += 1
        self.total_tokens += len(req.generated)
        if req.ttft is not None:
            self.ttft_s.append(req.ttft)
        if req.tpot is not None:
            self.tpot_s.append(req.tpot)
        if req.queue_wait is not None:
            self.queue_wait_s.append(req.queue_wait)
        # goodput counts a finished request's tokens at completion time
        self._token_times.extend([now] * len(req.generated))
        self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._token_times and self._token_times[0] < cutoff:
            self._token_times.popleft()

    # ------------------------------------------------------------------ #
    # Aggregates
    # ------------------------------------------------------------------ #
    def goodput_tokens_per_s(self) -> float:
        """Rolling tokens/s over the last ``window_s`` seconds (finished
        requests' tokens only)."""
        now = time.monotonic()
        self._trim(now)
        span = min(self.window_s, max(now - self.started, 1e-9))
        return len(self._token_times) / span

    def overall_tokens_per_s(self) -> float:
        span = max(time.monotonic() - self.started, 1e-9)
        return self.total_tokens / span

    def preemption_rate(self) -> float:
        """Fraction of terminal (finished or failed) requests that were
        preempted at least once — bounded to [0, 1] by construction
        (in-flight preempted requests don't enter the numerator until
        they terminate)."""
        return self._terminal_preempted / max(self.finished + self.failed, 1)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "submitted": float(self.submitted),
            "rejected": float(self.rejected),
            "finished": float(self.finished),
            "failed": float(self.failed),
            "deadline_exceeded": float(self.deadline_exceeded),
            "shutdown_failed": float(self.shutdown_failed),
            "preemptions": float(self.preemptions),
            "handoffs": float(self.handoffs),
            "preempted_requests": float(self.preempted_requests),
            "preemption_rate": self.preemption_rate(),
            "total_tokens": float(self.total_tokens),
            "goodput_tokens_per_s": self.goodput_tokens_per_s(),
            "overall_tokens_per_s": self.overall_tokens_per_s(),
        }
        if self.decode_ticks:
            out["decode_ticks"] = float(self.decode_ticks)
            out["decode_tokens_delivered"] = float(self.decode_tick_tokens)
            out["tokens_per_decode_tick"] = (self.decode_tick_tokens
                                             / self.decode_ticks)
            # per-request acceptance factor: 1.0 on plain decode, >1
            # when speculative acceptance delivers token bursts
            out["tokens_per_request_tick"] = (
                self.decode_tick_tokens
                / max(self.decode_tick_requests, 1))
            out["tpot_delivered_s"] = self.tpot_delivered_s()
        for name, vals in (("ttft_s", self.ttft_s),
                           ("tpot_s", self.tpot_s),
                           ("queue_wait_s", self.queue_wait_s),
                           # old one-token-per-tick view, as a ticks series
                           ("decode_tick_s", self.decode_tick_s)):
            if vals:
                out[f"p50_{name}"] = _pct(vals, 50)
                out[f"p95_{name}"] = _pct(vals, 95)
        return out

    # ------------------------------------------------------------------ #
    # Monitor fan-out
    # ------------------------------------------------------------------ #
    def export(self, monitor=None, now: Optional[float] = None,
               extra: Optional[List[Tuple[str, float]]] = None,
               snapshot: Optional[Dict[str, float]] = None,
               ) -> List[Tuple[str, float, float]]:
        """Emit ``serving/*`` scalars through the monitor writers.

        The x value is wall-clock ``time.time()`` (float) — no fabricated
        step numbers; the writers persist it as-is (CSV), or as the
        TensorBoard walltime axis.  ``extra`` appends caller-supplied
        ``(name, value)`` scalars (the scheduler's prefix-cache and
        fast-tick telemetry) at the same x.  ``snapshot`` reuses a
        snapshot the caller already computed (percentiles are not free).
        Returns the event list (also when no monitor is attached, for
        callers that fan out themselves).
        """
        monitor = monitor if monitor is not None else self.monitor
        wall = time.time() if now is None else now
        if snapshot is None:
            snapshot = self.snapshot()
        events = [(f"serving/{k}", v, wall)
                  for k, v in snapshot.items()]
        if extra:
            events.extend((name, float(v), wall) for name, v in extra)
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events(events)
        return events
