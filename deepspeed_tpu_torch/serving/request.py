"""Serving request lifecycle (reference: the role MII's ``RaggedRequest`` /
request tracking plays above the FastGen engine — deepspeed-mii
batching/ragged_batching.py — recast as a host-side state machine the
:class:`~deepspeed_tpu_torch.serving.scheduler.ContinuousBatchScheduler` owns).

Counterpart of ``deepspeed_tpu/serving/request.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

A :class:`Request` is everything the scheduler needs to drive one user
generation through :class:`InferenceEngineV2`: the prompt, sampling
parameters, a priority, and the lifecycle state machine::

    QUEUED -> PREFILL -> DECODE -> FINISHED
                 ^  \\        \\-> PREEMPTED -> (resume) PREFILL
                 |   \\-> FAILED
                 \\-- admission

On preemption the request's KV blocks are flushed device-side; the prompt
AND every generated token stay host-side on the request, so resumption is
recompute (re-prefill ``prompt + generated``) — greedy output is therefore
token-for-token identical to an unpreempted run.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
from typing import Callable, List, Optional, Tuple


class RequestState(enum.Enum):
    QUEUED = "queued"        # submitted, no engine state yet
    PREFILL = "prefill"      # admitted; prompt (or recompute) chunks in flight
    DECODE = "decode"        # prompt consumed; generating one token per tick
    PREEMPTED = "preempted"  # KV flushed under pressure; awaiting re-admission
    FINISHED = "finished"    # terminal: stop token / length reached
    FAILED = "failed"        # terminal: could never be scheduled
    HANDED_OFF = "handed_off"  # terminal HERE: continues on another replica


#: Legal state-machine edges (from -> to). Anything else is a scheduler bug.
_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILL, RequestState.FAILED,
                          RequestState.HANDED_OFF},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.PREEMPTED,
                           RequestState.FINISHED, RequestState.FAILED,
                           RequestState.HANDED_OFF},
    RequestState.DECODE: {RequestState.DECODE, RequestState.PREEMPTED,
                          RequestState.FINISHED, RequestState.FAILED,
                          RequestState.HANDED_OFF},
    RequestState.PREEMPTED: {RequestState.PREFILL, RequestState.FINISHED,
                             RequestState.FAILED, RequestState.HANDED_OFF},
    RequestState.FINISHED: set(),
    RequestState.FAILED: set(),
    RequestState.HANDED_OFF: set(),
}


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling (greedy / temperature / top-k).

    ``seed`` keys the noise stream together with the request uid and the
    generation position: the token drawn at position ``i`` depends only on
    (seed, uid, i, logits), so a preempt/recompute resume reproduces the
    same continuation, and requests sharing a ``SamplingParams`` still
    draw independently.
    """

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0                       # 0 -> full vocab
    max_new_tokens: int = 16
    eos_token_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.greedy and self.temperature <= 0.0:
            raise ValueError("temperature must be > 0 when sampling")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

    def is_stop_token(self, token: int) -> bool:
        return (token in self.stop_token_ids
                or (self.eos_token_id is not None
                    and token == self.eos_token_id))


@dataclasses.dataclass(eq=False)
class Request:
    """One user generation request plus its scheduler-side bookkeeping.

    ``eq=False``: requests are identity objects (the scheduler keeps them
    in lists/dicts); two requests are never "equal" by field values.
    """

    uid: int
    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    priority: int = 0                    # higher = preempted later
    #: wall-clock budget from arrival; past it the scheduler fails the
    #: request with reason "deadline" at the next tick (None = no SLO)
    deadline_s: Optional[float] = None
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    #: called as ``on_token(request, token)`` for every emitted token
    #: (streaming hook).  A raising callback is disabled and logged, not
    #: propagated — one client's broken stream handler must not corrupt
    #: the whole batch's scheduling state mid-tick
    on_token: Optional[Callable[["Request", int], None]] = None

    # -- lifecycle ---------------------------------------------------- #
    state: RequestState = RequestState.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    #: tokens of ``history`` whose KV lives on device (engine seen_tokens)
    fed: int = 0
    finish_reason: Optional[str] = None
    #: admission order stamp (scheduler-assigned; preemption tie-break)
    admitted_at: int = -1
    #: set by CacheAwareRouter at placement; None for requests submitted
    #: directly to a scheduler
    tenant: Optional[str] = None
    replica: Optional[str] = None
    #: distributed-tracing id, minted ONCE at first submit and carried
    #: through every replica incarnation via :class:`RequestSnapshot` —
    #: spans from a kill→replay, a rolling-restart migration, and a
    #: disaggregated prefill→decode handoff all share it, so the
    #: exported timeline shows one request's whole life
    trace_id: Optional[str] = None

    # -- per-request SLO accounting (wall-clock, time.monotonic) ------- #
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"request {self.uid}: deadline_s must be > 0")

    @property
    def past_deadline(self) -> bool:
        return (self.deadline_s is not None
                and time.monotonic() - self.arrival_time > self.deadline_s)

    # ------------------------------------------------------------------ #
    @property
    def history(self) -> List[int]:
        """Full token history the engine must hold KV for: the prompt plus
        every generated token (the recompute-resume unit)."""
        return self.prompt + self.generated

    @property
    def remaining_feed(self) -> int:
        """Tokens of ``history`` not yet consumed by the engine.  1 means a
        plain decode step; >1 means (re)prefill chunks are outstanding."""
        return len(self.history) - self.fed

    @property
    def is_running(self) -> bool:
        return self.state in (RequestState.PREFILL, RequestState.DECODE)

    @property
    def done(self) -> bool:
        """Terminal on THIS replica (a HANDED_OFF request lives on as a
        new object elsewhere — see :class:`RequestSnapshot`)."""
        return self.state in (RequestState.FINISHED, RequestState.FAILED,
                              RequestState.HANDED_OFF)

    def transition(self, new_state: RequestState) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise RuntimeError(
                f"request {self.uid}: illegal transition "
                f"{self.state.value} -> {new_state.value}")
        self.state = new_state

    # ------------------------------------------------------------------ #
    def emit(self, token: int, now: float) -> None:
        """Record one generated token (and stream it)."""
        self.generated.append(int(token))
        if self.first_token_time is None:
            self.first_token_time = now
        self.last_token_time = now
        if self.on_token is not None:
            try:
                self.on_token(self, int(token))
            except Exception:  # noqa: BLE001
                from deepspeed_tpu_torch.utils.logging import logger

                logger.exception(
                    f"request {self.uid}: on_token callback raised — "
                    f"disabling streaming for this request")
                self.on_token = None

    def should_stop(self) -> Optional[str]:
        """Termination check after the latest emit: reason or None."""
        if self.generated and self.sampling.is_stop_token(self.generated[-1]):
            return "stop"
        if len(self.generated) >= self.sampling.max_new_tokens:
            return "length"
        return None

    # -- handoff ------------------------------------------------------- #
    def snapshot(self, fed_tokens: int = 0) -> "RequestSnapshot":
        """Serializable replay state for cross-replica handoff (see
        :class:`RequestSnapshot`).  ``fed_tokens`` > 0 records how many
        history tokens have device KV travelling WITH the snapshot (the
        disaggregated prefill→decode path); 0 means recompute-replay."""
        remaining = None
        if self.deadline_s is not None:
            remaining = max(
                self.deadline_s - (time.monotonic() - self.arrival_time),
                1e-3)
        return RequestSnapshot(
            uid=self.uid,
            prompt=list(self.prompt),
            generated=list(self.generated),
            sampling=dataclasses.asdict(self.sampling),
            priority=self.priority,
            deadline_s=remaining,
            tenant=self.tenant,
            preemptions=self.preemptions,
            fed_tokens=fed_tokens,
            trace_id=self.trace_id,
        )

    # -- derived SLO metrics ------------------------------------------- #
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def queue_wait(self) -> Optional[float]:
        if self.first_scheduled_time is None:
            return None
        return self.first_scheduled_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean per-token latency AFTER the first token (time-per-output-
        token, the decode-side SLO)."""
        if (self.first_token_time is None or self.last_token_time is None
                or len(self.generated) < 2):
            return None
        span = self.last_token_time - self.first_token_time
        return span / (len(self.generated) - 1)


@dataclasses.dataclass
class RequestSnapshot:
    """Everything needed to continue a request on ANOTHER replica:
    the prompt, every token already emitted, the full sampling config
    (seed included), and the admission attributes (tenant / priority /
    remaining deadline).

    Replay contract: :meth:`to_request` rebuilds a QUEUED request whose
    ``generated`` is pre-seeded with the emitted tokens — the target
    scheduler re-prefills ``prompt + generated`` (or attaches the span
    carried as KV, see ``fed_tokens``) and generation continues at
    position ``len(generated)``.  Because sampling noise is keyed by
    ``(seed, uid, position)`` and the uid is preserved, the continuation
    is the exact token stream the request would have produced uninterrupted
    (greedy: always; stochastic: same draws, same tokens up to logits
    rounding across kernels).
    """

    uid: int
    prompt: List[int]
    generated: List[int]
    #: ``dataclasses.asdict(SamplingParams)`` — JSON-clean
    sampling: dict
    priority: int = 0
    #: deadline REMAINING at snapshot time (the clock restarts at
    #: resubmission; the client's budget keeps draining across the hop)
    deadline_s: Optional[float] = None
    tenant: Optional[str] = None
    preemptions: int = 0
    #: leading ``history`` tokens whose KV travels with the snapshot
    #: (``flush_to_host(include_kv=True)`` payload); 0 = recompute-replay
    fed_tokens: int = 0
    #: the request's distributed-tracing id — it travels WITH the
    #: snapshot so the continuation's spans join the same trace
    trace_id: Optional[str] = None

    @property
    def history(self) -> List[int]:
        return self.prompt + self.generated

    def to_request(self, on_token=None) -> Request:
        """Reconstruct a QUEUED :class:`Request` ready for
        ``scheduler.submit(request=...)`` / ``scheduler.resubmit``.  The
        uid is preserved — it keys the sampling noise stream."""
        sampling = dict(self.sampling)
        sampling["stop_token_ids"] = tuple(
            sampling.get("stop_token_ids", ()))
        req = Request(uid=self.uid, prompt=list(self.prompt),
                      sampling=SamplingParams(**sampling),
                      priority=self.priority, deadline_s=self.deadline_s,
                      on_token=on_token)
        req.generated = list(self.generated)
        req.preemptions = self.preemptions
        req.tenant = self.tenant
        req.trace_id = self.trace_id
        return req

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "RequestSnapshot":
        return cls(**json.loads(text))
