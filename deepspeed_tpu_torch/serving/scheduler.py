"""Iteration-level continuous-batching scheduler (reference: the Orca-style
request loop DeepSpeed-MII runs above the FastGen engine —
mii/batching/ragged_batching.py ``schedule_requests`` — with Dynamic
SplitFuse packing per blogs/deepspeed-fastgen).

Counterpart of ``deepspeed_tpu/serving/scheduler.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

Each :meth:`ContinuousBatchScheduler.step` packs exactly one engine forward
under the fixed token budget:

1. every running DECODE sequence first (one token each) — decode latency is
   the SLO, so decodes are never displaced by prefill work;
2. then SplitFuse prefill chunks — mid-prefill continuations, preempted
   requests being resumed (recompute), and new admissions — each sized by
   binary search against ``engine.can_schedule()`` to fill the remaining
   budget without overcommitting KV blocks or sequence slots.

KV pressure: when the decode set itself no longer fits (every decode token
may need a fresh block), the scheduler preempts the lowest-priority /
most-recently-admitted running request — ``engine.flush_to_host()`` drops
its device blocks, the prompt + generated tokens stay host-side on the
:class:`Request`, and it re-admits later by recompute (re-prefilling
``prompt + generated``), which under greedy sampling reproduces the exact
unpreempted continuation.

Everything here is host-side python; device work is the engine's ragged
step — the same split the reference keeps.  Where the JAX scheduler
fetches a tick's result with ``jax.device_get``, this one makes one
``.cpu()`` copy a tick (the sampled tokens of an all-greedy batch, else
the logits rows the host sampler needs).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.speculative import (SpeculativeConfig,
                                                    SpeculativeStats,
                                                    accept_drafts)
from deepspeed_tpu_torch.observability.tracer import (Tracer, mint_trace_id,
                                                step_annotation)
from deepspeed_tpu_torch.resilience import chaos
from deepspeed_tpu_torch.resilience.heartbeat import Heartbeat
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import (Request, RequestState,
                                           SamplingParams)
from deepspeed_tpu_torch.serving.sampler import sample_batch
from deepspeed_tpu_torch.utils.logging import logger

_NULL_CM = contextlib.nullcontext()


class QueueFullError(RuntimeError):
    """``submit()`` rejected: the admission queue is at ``max_queue``.
    Back off and retry (or shed load) — the queue will not grow without
    bound under overload."""


class TickDeadlineError(RuntimeError):
    """The tick watchdog tripped: one scheduler tick (engine forward +
    sample) exceeded ``tick_deadline_s``.  Carries the packed batch's
    uids so the fleet's crash-blame tracker can attribute the stall to
    the requests that were actually in the forward — a slow-but-
    returning tick is *detected here* (the scheduler still beats its
    heartbeat), while a truly wedged forward never returns and is the
    supervisor's hang detector's job."""

    def __init__(self, uids, elapsed_s: float, deadline_s: float):
        super().__init__(
            f"scheduler tick blew its {deadline_s:.3f}s deadline "
            f"({elapsed_s:.3f}s) with uids {sorted(uids)} in the batch")
        self.uids = list(uids)
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s


class ContinuousBatchScheduler:
    """Owns the request lifecycle between user ``submit()`` calls and
    :class:`~deepspeed_tpu_torch.inference.v2.engine_v2.InferenceEngineV2`."""

    def __init__(self, engine, monitor=None,
                 metrics: Optional[ServingMetrics] = None,
                 export_every: int = 0,
                 max_queue: Optional[int] = None,
                 fast_decode: bool = True,
                 tick_deadline_s: Optional[float] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 tracer: Optional[Tracer] = None,
                 registry=None, registry_key: str = "serving"):
        self.engine = engine
        #: request-scoped tracing (None = zero-overhead off).  Tick
        #: phases (pack, prefill, decode/verify, sample, emit) record as
        #: child spans under a per-tick span on the scheduler's own
        #: trace; request lifecycle spans carry each request's trace_id.
        #: The fleet re-points tracer/trace_tid at respawn so spans are
        #: tagged ``replica#incarnation``.
        self.tracer = tracer
        self.trace_tid = tracer.default_tid if tracer is not None \
            else "scheduler"
        #: the tick timeline's own trace (request traces are per-request)
        self.sched_trace_id = mint_trace_id()
        #: uid -> open request-phase SpanHandle
        self._req_spans: Dict[int, object] = {}
        #: unified metrics registry (observability.registry): when given,
        #: this scheduler's serving/* snapshot registers as a provider
        #: under the STABLE ``registry_key`` — a respawned scheduler
        #: registering the same key supersedes its dead incarnation
        #: (an id()-keyed scheme would leak dead engines into the
        #: registry and let a stale provider shadow the live one)
        self._registry = registry
        self._registry_key = registry_key
        if registry is not None:
            registry.register_provider(registry_key, self.telemetry)
            # live occupancy gauges (observability/kv_*, hbm_*,
            # tenant_tokens_*): host-side bookkeeping reads only, so a
            # scrape between steady-state decode ticks adds no device
            # sync
            if hasattr(engine, "state_manager") \
                    and hasattr(engine.state_manager, "kv_cache"):
                from deepspeed_tpu_torch.observability.memory import (
                    make_occupancy_provider)

                registry.register_provider(
                    f"{registry_key}/occupancy",
                    make_occupancy_provider(engine, self))
            if tracer is not None:
                registry.register_provider(f"{registry_key}/tracer",
                                           tracer.telemetry)
        #: speculative decoding (ROADMAP item 1): pure-decode ticks run a
        #: drafter + one multi-token verify_step instead of decode_step,
        #: emitting 1..draft_k+1 tokens per weight pass; a tick with no
        #: drafts (or no KV/context room for the lookahead) falls back to
        #: the plain fast decode tick
        if speculative is not None:
            if not hasattr(engine, "verify_step"):
                raise ValueError(
                    "speculative decoding needs an engine with "
                    "verify_step/commit_verified (InferenceEngineV2)")
            if not fast_decode:
                raise ValueError(
                    "speculative decoding runs on the fast decode tick — "
                    "fast_decode=False would silently never speculate")
        self.speculative = speculative
        self.spec_stats = SpeculativeStats()
        #: acceptance-aware K autotuning (speculative.autotune_k): per-
        #: request accept-rate EWMA and the effective K it currently
        #: prescribes (both dropped when the request terminalizes)
        self._spec_accept_ewma: Dict[int, float] = {}
        self._spec_k: Dict[int, int] = {}
        #: runtime degradation knobs (fleet/brownout.py): a draft-K cap
        #: that squeezes speculation without touching config, a master
        #: speculative enable, and tightened admission caps — all
        #: reversible through the set_* setters below
        self.spec_k_cap: Optional[int] = None
        self._speculative_enabled = True
        self.admit_max_new_tokens: Optional[int] = None
        self.admit_max_context: Optional[int] = None
        #: pure-decode ticks go through ``engine.decode_step`` — block
        #: tables/positions stay device-resident across ticks and the
        #: only host transfer is the sampled-token fetch, instead of a
        #: full metadata pack+upload and an [S, vocab] logits download
        #: per tick (the put()-path cost the bench's put_decode_step_ms
        #: measures)
        self.fast_decode = fast_decode and hasattr(engine, "decode_step")
        self.fast_ticks = 0
        sm_cfg = engine.config.state_manager
        self.token_budget = sm_cfg.max_ragged_batch_size
        #: the configured budget, for set_token_budget(None) to restore
        self._base_token_budget = self.token_budget
        self.max_seqs = sm_cfg.max_ragged_sequence_count
        self.max_context = sm_cfg.max_context
        self.metrics = metrics if metrics is not None \
            else ServingMetrics(monitor)
        #: export serving/* scalars through the monitor every N ticks
        #: (0 = only on run_until_idle/drain completion)
        self.export_every = export_every
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        #: bounded admission: submit() raises QueueFullError past this
        self.max_queue = max_queue
        if tick_deadline_s is not None and tick_deadline_s <= 0:
            raise ValueError("tick_deadline_s must be > 0 (or None)")
        #: tick watchdog: a tick slower than this raises
        #: :class:`TickDeadlineError` naming the packed batch, AFTER the
        #: engine returns (a wedged forward that never returns is the
        #: supervisor heartbeat detector's case, not this one)
        self.tick_deadline_s = tick_deadline_s
        self.tick_deadline_trips = 0
        self._queued: List[Request] = []
        self._running: Dict[int, Request] = {}
        self._preempted: List[Request] = []
        self._finished: List[Request] = []
        #: uids of every non-terminal request — O(1) collision probes for
        #: auto-uid allocation (here and in the fleet router)
        self._live_uids: set = set()
        self._uid_counter = itertools.count(1)
        self._admit_counter = itertools.count()
        #: summed _work() of queued+preempted requests — frozen while
        #: parked (no feeding/decoding), maintained at the five bucket
        #: transitions so backlog_tokens() never walks the queue
        self._parked_backlog = 0
        self._tick = 0
        #: set by shutdown(): admission is closed for good
        self._shutting_down = False
        #: liveness ticker for the job supervisor's hang detector (one
        #: beat per scheduler tick; a wedged engine forward goes stale)
        self._heartbeat = Heartbeat.from_env()

    # ------------------------------------------------------------------ #
    # Runtime degradation knobs (brownout)
    # ------------------------------------------------------------------ #
    @property
    def _spec_active(self):
        """The speculative config when speculation is enabled right now
        (brownout stage 3 flips the enable without losing the config)."""
        return self.speculative if self._speculative_enabled else None

    def set_speculative_enabled(self, enabled: bool) -> None:
        """Disable/re-enable speculative decoding at runtime.  A no-op
        on schedulers built without a speculative config."""
        self._speculative_enabled = bool(enabled)

    def set_spec_k_cap(self, cap: Optional[int]) -> None:
        """Cap the effective draft K below the configured ``draft_k``
        (None restores).  Shrinks the verify lookahead immediately —
        the pass's gamma follows the longest draft actually proposed."""
        if cap is not None and cap < 1:
            raise ValueError("spec_k_cap must be >= 1 (or None)")
        self.spec_k_cap = cap

    def set_token_budget(self, budget: Optional[int]) -> None:
        """Cap the per-tick prefill token budget (None restores the
        configured ``max_ragged_batch_size``).  Caps only — the budget
        never rises above the compiled batch geometry."""
        if budget is None:
            self.token_budget = self._base_token_budget
        elif budget < 1:
            raise ValueError("token_budget must be >= 1 (or None)")
        else:
            self.token_budget = min(budget, self._base_token_budget)

    def set_admission_caps(self, max_new_tokens: Optional[int] = None,
                           max_context: Optional[int] = None) -> None:
        """Tighten admission at runtime: clamp each new request's
        ``max_new_tokens`` and reject prompts longer than the tightened
        context cap with a retryable :class:`QueueFullError` (None/None
        restores).  Already-admitted requests are untouched."""
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError("admit_max_new_tokens must be >= 1 (or None)")
        if max_context is not None and max_context < 2:
            raise ValueError("admit_max_context must be >= 2 (or None)")
        self.admit_max_new_tokens = max_new_tokens
        self.admit_max_context = max_context

    # ------------------------------------------------------------------ #
    # Submission
    # ------------------------------------------------------------------ #
    def submit(self, prompt: Optional[Sequence[int]] = None,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, uid: Optional[int] = None,
               on_token=None, deadline_s: Optional[float] = None,
               request: Optional[Request] = None,
               trace_id: Optional[str] = None) -> Request:
        """Enqueue one generation request; returns the tracked
        :class:`Request` (read its ``state``/``generated`` as it runs)."""
        if request is None:
            if prompt is None:
                raise ValueError("submit: prompt or request required")
            if uid is None:
                # auto uids skip anything live (a caller-supplied uid may
                # have claimed a counter value)
                uid = next(self._uid_counter)
                while self._is_tracked_uid(uid):
                    uid = next(self._uid_counter)
            request = Request(
                uid=uid,
                prompt=[int(t) for t in prompt],
                sampling=sampling or SamplingParams(),
                priority=priority, deadline_s=deadline_s,
                on_token=on_token, trace_id=trace_id)
        # a replayed/handed-off request keeps its original trace_id (the
        # whole point: one trace across incarnations); fresh ones mint
        if request.trace_id is None:
            request.trace_id = mint_trace_id()
        if self._shutting_down:
            self.metrics.record_reject(request)
            raise RuntimeError(
                f"submit: scheduler is shutting down — request "
                f"{request.uid} rejected (admission closed)")
        if request.state is not RequestState.QUEUED:
            raise ValueError(f"submit: request {request.uid} already "
                             f"{request.state.value}")
        if self._is_tracked_uid(request.uid):
            raise ValueError(f"submit: uid {request.uid} already live")
        if self.max_queue is not None and len(self._queued) >= self.max_queue:
            self.metrics.record_reject(request)
            raise QueueFullError(
                f"submit: admission queue full ({len(self._queued)} waiting, "
                f"max_queue={self.max_queue}) — request {request.uid} "
                "rejected; retry after the queue drains")
        # brownout stage-4 admission tightening: clamp the generation
        # budget (shorter answers, not failures) and shed over-long
        # prompts with a retryable error instead of a permanent one
        if self.admit_max_new_tokens is not None \
                and request.sampling.max_new_tokens \
                > self.admit_max_new_tokens:
            request.sampling.max_new_tokens = self.admit_max_new_tokens
        if self.admit_max_context is not None \
                and len(request.history) + 1 > self.admit_max_context:
            self.metrics.record_reject(request)
            raise QueueFullError(
                f"submit: history of {len(request.history)} tokens exceeds "
                f"the brownout-tightened context cap "
                f"{self.admit_max_context} — request {request.uid} "
                "rejected; retry when pressure recedes")
        # history, not prompt: a resubmitted (handed-off) request carries
        # already-generated tokens that need KV room too
        if len(request.history) + 1 > self.max_context:
            raise ValueError(
                f"submit: history of {len(request.history)} tokens cannot "
                f"fit max_context {self.max_context} with room to generate")
        sm = self.engine.state_manager
        hist_blocks = -(-(len(request.history) + 1) // sm.block_size)
        if hist_blocks > sm.allocator.num_blocks - 1:
            raise ValueError(
                f"submit: history needs {hist_blocks} KV blocks but the "
                f"pool only has {sm.allocator.num_blocks - 1} usable")
        self._queued.append(request)
        self._live_uids.add(request.uid)
        self._parked_backlog += self._work(request)
        self.metrics.record_submit(request)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("request/submit", trace_id=request.trace_id,
                       tid=self.trace_tid,
                       attrs={"uid": request.uid,
                              "prompt_tokens": len(request.prompt),
                              "resumed": len(request.generated)})
        return request

    def _is_tracked_uid(self, uid: int) -> bool:
        return uid in self._live_uids

    def unregister_metrics(self) -> None:
        """Detach this scheduler's providers from the registry (teardown
        of a scheduler that is NOT being superseded under its key)."""
        if self._registry is not None:
            self._registry.unregister_provider(self._registry_key)
            self._registry.unregister_provider(
                f"{self._registry_key}/occupancy")
            self._registry.unregister_provider(
                f"{self._registry_key}/tracer")

    def attach_tracer(self, tracer: Optional[Tracer],
                      tid: Optional[str] = None) -> None:
        """Point this scheduler at ``tracer``, spans tid-tagged ``tid``
        (default: the tracer's own tid).  The tracer/trace_tid pair must
        move together — this is the one place that knows that."""
        self.tracer = tracer
        if self._registry is not None:
            # a respawn's fresh tracer supersedes the dead one's ring
            # gauges under the same stable provider key; detaching
            # (tracer=None) drops the provider too — a dead ring must
            # not keep reporting (or stay pinned in memory) forever
            if tracer is not None:
                self._registry.register_provider(
                    f"{self._registry_key}/tracer", tracer.telemetry)
            else:
                self._registry.unregister_provider(
                    f"{self._registry_key}/tracer")
        if tracer is not None:
            self.trace_tid = tid if tid is not None else tracer.default_tid

    # ------------------------------------------------------------------ #
    # Request-phase spans (one open phase per live request)
    # ------------------------------------------------------------------ #
    def _open_req_span(self, req: Request, phase: str) -> None:
        tr = self.tracer
        if tr is None or not tr.enabled:
            return
        self._close_req_span(req.uid)
        self._req_spans[req.uid] = tr.start(
            f"request/{phase}", trace_id=req.trace_id, tid=self.trace_tid,
            attrs={"uid": req.uid, "fed": req.fed,
                   "generated": len(req.generated)})

    def _close_req_span(self, uid: int, **attrs) -> None:
        h = self._req_spans.pop(uid, None)
        if h is not None and self.tracer is not None:
            self.tracer.finish(h, attrs=attrs or None)

    def abort_request_spans(self, outcome: str) -> None:
        """Close every open request-phase span.  The fleet calls this on
        a replica death so the dead incarnation's spans export closed
        and tagged with the outcome instead of dangling — the request's
        NEXT incarnation opens fresh spans under the same trace_id."""
        for uid in list(self._req_spans):
            self._close_req_span(uid, outcome=outcome)

    # ------------------------------------------------------------------ #
    # State inspection
    # ------------------------------------------------------------------ #
    @property
    def num_pending(self) -> int:
        """Requests not yet in a terminal state."""
        return len(self._queued) + len(self._running) + len(self._preempted)

    @staticmethod
    def _work(req: Request) -> int:
        """Outstanding tokens for one request: unfed history plus
        remaining generation budget."""
        return (req.remaining_feed
                + max(req.sampling.max_new_tokens - len(req.generated), 0))

    def backlog_tokens(self) -> int:
        """Outstanding work in tokens across every non-terminal request
        (the router's load signal).  O(max_seqs), not O(queue): parked
        requests' contributions are frozen, so only the bounded running
        set is walked."""
        return self._parked_backlog + sum(
            self._work(r) for r in self._running.values())

    @property
    def finished_requests(self) -> List[Request]:
        return list(self._finished)

    @property
    def running_uids(self) -> List[int]:
        return list(self._running)

    @property
    def running_decode_uids(self) -> List[int]:
        """Running requests whose prefill completed (state DECODE) — the
        disaggregated fleet migrates exactly these off a prefill replica,
        KV in hand, the tick they finish prefilling."""
        return [r.uid for r in self._running.values()
                if r.state is RequestState.DECODE]

    # ------------------------------------------------------------------ #
    # One scheduling tick
    # ------------------------------------------------------------------ #
    def step(self) -> List[Tuple[Request, int]]:
        """Pack one engine forward and sample its logits.  Returns the
        ``(request, token)`` pairs emitted this tick."""
        if self._heartbeat is not None:
            self._heartbeat.beat(self._tick)
        tr = self.tracer
        tracing = tr is not None and tr.enabled
        tick_h = tr.start("tick", trace_id=self.sched_trace_id,
                          tid=self.trace_tid,
                          attrs={"tick": self._tick}) if tracing else None
        try:
            return self._step_traced(tr, tick_h)
        finally:
            if tick_h is not None:
                tr.finish(tick_h)

    def _phase(self, name: str, tick_h):
        """Child span for one tick phase (no-op context without a
        tracer/tick span)."""
        if tick_h is None:
            return _NULL_CM
        return self.tracer.span(name, trace_id=self.sched_trace_id,
                                parent=tick_h.span_id, tid=self.trace_tid)

    def _step_traced(self, tr, tick_h) -> List[Tuple[Request, int]]:
        self._expire_deadlines()
        self._reap_unservable()
        uids: List[int] = []
        chunks: List[List[int]] = []
        packed: List[Request] = []

        with self._phase("pack", tick_h):
            self._pack_decodes(uids, chunks, packed)
            self._pack_prefills(uids, chunks, packed)

        if not uids:
            self._handle_stall()
            return []

        now = time.monotonic()
        for req in packed:
            if req.first_scheduled_time is None:
                req.first_scheduled_time = now
        if chaos.armed("poison_request") is not None:
            # a malformed request deterministically crashes the engine
            # the moment it is batched into a forward — the crash the
            # fleet's quarantine layer must attribute and contain
            for req in packed:
                chaos.fire("poison_request", key=str(req.uid))
        # monotonic on purpose: this is a liveness DEADLINE (host-side
        # control flow), not a device-compute timing bracket — a tick
        # that stalls on anything (engine, allocator, GIL) should trip
        t0 = time.monotonic()
        chaos.fire("tick_stall")
        decode_tick = all(r.state is RequestState.DECODE for r in packed)
        with step_annotation(self._tick):
            if self.fast_decode and decode_tick:
                emitted = None
                if self._spec_active is not None:
                    with self._phase("verify", tick_h):
                        emitted = self._speculative_decode_tick(
                            uids, chunks, packed)
                if emitted is None:
                    if self._spec_active is not None:
                        self.spec_stats.fallback_ticks += 1
                    with self._phase("decode", tick_h):
                        emitted = self._fast_decode_tick(uids, chunks,
                                                         packed)
            else:
                with self._phase("prefill", tick_h):
                    logits = self.engine.put(uids, chunks, sync=True)
                    for req, chunk in zip(packed, chunks):
                        req.fed += len(chunk)
                with self._phase("sample", tick_h):
                    emitted = self._sample_and_advance(packed, logits)
        if tick_h is not None and emitted:
            tr.instant("emit", trace_id=self.sched_trace_id,
                       parent=tick_h.span_id, tid=self.trace_tid,
                       attrs={"tokens": len(emitted),
                              "requests": len(packed)})
        if decode_tick:
            # per-tick TPOT accounting divides by tokens DELIVERED (a
            # speculative tick can emit several per request)
            self.metrics.record_decode_tick(len(emitted), len(packed),
                                            time.monotonic() - t0)
        if self.tick_deadline_s is not None:
            elapsed = time.monotonic() - t0
            if elapsed > self.tick_deadline_s:
                self.tick_deadline_trips += 1
                self._tick += 1
                raise TickDeadlineError([r.uid for r in packed],
                                        elapsed, self.tick_deadline_s)
        self._tick += 1
        if self.export_every and self._tick % self.export_every == 0:
            self._export_metrics()
        return emitted

    def _fast_decode_tick(self, uids, chunks, packed) -> List[Tuple[Request,
                                                                    int]]:
        """Steady-state decode tick: one ``decode_step`` dispatch against
        the device-resident block tables.  All-greedy batches fetch only
        the argmax'd token vector (a few bytes/request); any stochastic
        request still needs its logits row on the host for the
        (seed, uid, position)-keyed sampler."""
        tokens = [c[0] for c in chunks]
        n = len(uids)
        self.fast_ticks += 1
        if all(r.sampling.greedy for r in packed):
            _, nxt = self.engine.decode_step(uids, tokens, greedy=True)
            toks = nxt[:n].cpu().tolist()
            for req in packed:
                req.fed += 1
            return self._advance_emitted(packed, toks)
        logits = self.engine.decode_step(uids, tokens)
        rows = logits[:n].float().cpu().numpy()
        for req in packed:
            req.fed += 1
        tokens_out = sample_batch(rows, [r.sampling for r in packed],
                                  [len(r.generated) for r in packed],
                                  [r.uid for r in packed])
        return self._advance_emitted(packed, tokens_out.tolist())

    # -- speculative decode -------------------------------------------- #
    def _speculative_decode_tick(self, uids, chunks, packed
                                 ) -> Optional[List[Tuple[Request, int]]]:
        """Draft + one multi-token verify pass over the decode batch.

        Returns the emitted ``(request, token)`` pairs, or None when
        speculation opted out this tick (no drafts anywhere, or no room
        for the K-token lookahead) — the caller then runs the plain fast
        decode tick.  Output is token-for-token what sequential decode
        would emit: acceptance reuses the (seed, uid, position)-keyed
        sampler against each candidate slot's logits, and a stop
        token / length limit inside an accepted run truncates exactly
        where the sequential run would have stopped.
        """
        spec = self.speculative
        drafts: List[List[int]] = []
        k_targets: List[int] = []
        for r in packed:
            # acceptance-aware K: a request whose accept-rate EWMA has
            # decayed drafts fewer tokens (down to min_draft_k), so the
            # verify pass stops paying lookahead it never cashes;
            # draft_k is the cap, so program shapes stay bounded
            k_r = (self._spec_k.get(r.uid, spec.draft_k)
                   if spec.autotune_k else spec.draft_k)
            if self.spec_k_cap is not None:
                k_r = max(1, min(k_r, self.spec_k_cap))
            k_targets.append(k_r)
            # never draft past the generation budget: at most
            # remaining - 1 drafts can be emitted alongside the bonus
            remaining = r.sampling.max_new_tokens - len(r.generated)
            drafts.append(list(
                spec.drafter.draft(r.history, min(k_r, remaining - 1))
            )[:k_r])
        if not any(drafts):
            return None
        # the pass's K covers the longest draft actually proposed — an
        # all-shrunk batch runs a genuinely smaller verify program
        gamma = (max(len(d) for d in drafts)
                 if spec.autotune_k or self.spec_k_cap is not None
                 else spec.draft_k)
        K = gamma + 1
        if not self.engine.can_schedule(uids, [K] * len(uids)):
            return None                  # lookahead KV/context won't fit

        feed = [[r.history[-1]] + d + [0] * (gamma - len(d))
                for r, d in zip(packed, drafts)]
        spans = [len(d) + 1 for d in drafts]
        if all(r.sampling.greedy for r in packed):
            # all-greedy: the step program argmax'd every candidate slot
            # on device — fetch K ints per sequence, never the [n, K,
            # vocab] logits (the same asymmetry the plain greedy fast
            # tick exploits via decode_step(greedy=True))
            _, nxt = self.engine.verify_step(uids, feed, greedy=True)
            toks = nxt[:len(uids)].cpu().numpy()
            cand = np.concatenate(
                [toks[i, :m] for i, m in enumerate(spans)])
        else:
            # device logits [max_seqs, K, vocab]; the stochastic sampler
            # needs them on host — one fetch per verify pass (vs one per
            # token unspeculated).  One vectorised sampler call over
            # every candidate slot: slot k of request i draws at
            # generation position len(generated)+k — the exact key
            # sequential decode would use
            rows = self.engine.verify_step(uids, feed)[
                :len(uids)].float().cpu().numpy()
            flat_rows, flat_params, flat_pos, flat_uids = [], [], [], []
            for i, (r, d) in enumerate(zip(packed, drafts)):
                m = spans[i]
                flat_rows.append(rows[i, :m])
                flat_params.extend([r.sampling] * m)
                flat_pos.extend(len(r.generated) + k for k in range(m))
                flat_uids.extend([r.uid] * m)
            cand = sample_batch(np.concatenate(flat_rows, axis=0),
                                flat_params, flat_pos, flat_uids)
        emitted: List[Tuple[Request, int]] = []
        now = time.monotonic()
        self.spec_stats.ticks += 1
        off = 0
        for i, (req, d) in enumerate(zip(packed, drafts)):
            out, acc = accept_drafts(cand[off:off + spans[i]], d)
            off += spans[i]
            self.spec_stats.drafted += len(d)
            self.spec_stats.accepted += acc
            self.spec_stats.k_sum += k_targets[i]
            self.spec_stats.k_requests += 1
            if spec.autotune_k and d:
                a = spec.accept_ewma_alpha
                rate = acc / len(d)
                prev = self._spec_accept_ewma.get(req.uid)
                ew = rate if prev is None else (1.0 - a) * prev + a * rate
                self._spec_accept_ewma[req.uid] = ew
                k_cur = k_targets[i]
                if ew < spec.shrink_threshold and k_cur > spec.min_draft_k:
                    k_cur -= 1
                elif ew > spec.grow_threshold and k_cur < spec.draft_k:
                    k_cur += 1
                self._spec_k[req.uid] = k_cur
            # commit the accepted feed prefix (input + accepted drafts);
            # the engine trims rejected lookahead blocks back
            self.engine.commit_verified(req.uid, feed[i][:1 + acc])
            req.fed += 1 + acc
            got = self._emit_many(req, out, now)
            # count what was DELIVERED, not what was accepted — a stop
            # token mid-burst truncates delivery exactly where
            # sequential decode would have stopped
            self.spec_stats.emitted += len(got)
            emitted.extend(got)
        return emitted

    def _emit_many(self, req: Request, tokens: Sequence[int],
                   now: float) -> List[Tuple[Request, int]]:
        """Emit a verify pass's accepted burst, stopping exactly where
        sequential decode would (stop token / max_new_tokens /
        max_context truncate the burst)."""
        emitted: List[Tuple[Request, int]] = []
        for tok in tokens:
            req.emit(int(tok), now)
            emitted.append((req, int(tok)))
            reason = req.should_stop()
            if reason is None and len(req.history) >= self.max_context:
                reason = "length"
            if reason is not None:
                self._finish(req, reason)
                break
        return emitted

    # -- packing ------------------------------------------------------- #
    def _pack_decodes(self, uids, chunks, packed) -> None:
        """All running decode sequences, one token each; preempt under KV
        pressure until the set fits."""
        decodes = sorted(
            (r for r in self._running.values() if r.remaining_feed == 1),
            key=lambda r: r.admitted_at)
        while decodes:
            cand_uids = [r.uid for r in decodes]
            if self.engine.can_schedule(cand_uids, [1] * len(cand_uids)):
                break
            victim = self._pick_victim()
            self._preempt(victim)
            decodes = [r for r in decodes if r.uid != victim.uid]
        for r in decodes:
            uids.append(r.uid)
            chunks.append([r.history[-1]])
            packed.append(r)

    def _pack_prefills(self, uids, chunks, packed) -> None:
        """SplitFuse: fill the remaining budget with prefill chunks —
        running mid-prefill first, then preempted resumes, then new
        admissions (priority, then FIFO)."""
        budget_left = self.token_budget - sum(len(c) for c in chunks)
        mid = sorted((r for r in self._running.values()
                      if r.remaining_feed > 1 and r not in packed),
                     key=lambda r: r.admitted_at)
        resumes = sorted(self._preempted,
                         key=lambda r: (-r.priority, r.arrival_time))
        fresh = sorted(self._queued,
                       key=lambda r: (-r.priority, r.arrival_time))
        for req in itertools.chain(mid, resumes, fresh):
            if budget_left <= 0 or len(uids) >= self.max_seqs:
                break
            admitting = req.state in (RequestState.QUEUED,
                                      RequestState.PREEMPTED)
            if admitting and len(self._running) + 1 > self.max_seqs:
                continue   # running set must stay one-forward-sized
            want = min(req.remaining_feed, budget_left,
                       self.max_context - req.fed)
            chunk = self._max_feasible_chunk(uids, chunks, req.uid, want)
            if chunk <= 0:
                if admitting:
                    break  # KV full: later (lower-priority) queue entries
                           # can't fit either — don't starve order
                continue
            if admitting:
                self._admit(req)
                # prefix-cache attach: (re)admission skips the prefill of
                # any cached span — including a preempted request's own
                # still-warm history, making recompute-resume nearly free
                if hasattr(self.engine, "attach_prefix"):
                    stats = getattr(self.engine, "prefix_cache_stats", None)
                    snap = (None if stats is None else
                            stats.attach_snapshot())
                    hit = self.engine.attach_prefix(req.uid, req.history)
                    if hit:
                        req.fed = hit
                        chunk = min(chunk, req.remaining_feed)
                        # attaching pinned warm blocks that can_schedule
                        # counted as evictable when the already-packed
                        # chunks were validated — re-check the whole set
                        # and defer this request if it no longer fits
                        lens = [len(c) for c in chunks]
                        if not self.engine.can_schedule(
                                uids + [req.uid], lens + [chunk]):
                            # the discarded attach saved nothing — its
                            # prefill skip never ran, and the retry next
                            # tick records the lookup/hit/fork again
                            # (evicted_blocks stays: those frees happened)
                            if snap is not None:
                                stats.restore_attach(snap)
                            self._preempt(req)
                            break
            hist = req.history
            uids.append(req.uid)
            chunks.append(hist[req.fed:req.fed + chunk])
            packed.append(req)
            budget_left -= chunk

    def _max_feasible_chunk(self, uids, chunks, uid: int, want: int) -> int:
        """Largest chunk <= want that ``can_schedule`` accepts alongside
        the already-packed set (binary search: feasibility is monotone)."""
        if want <= 0:
            return 0
        lens = [len(c) for c in chunks]
        lo, hi = 0, want
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.engine.can_schedule(uids + [uid], lens + [mid]):
                lo = mid
            else:
                hi = mid - 1
        return lo

    # -- admission / preemption ---------------------------------------- #
    def _admit(self, req: Request) -> None:
        if req.state is RequestState.QUEUED:
            self._queued.remove(req)
        else:
            self._preempted.remove(req)
        self._parked_backlog -= self._work(req)
        req.transition(RequestState.PREFILL)
        req.admitted_at = next(self._admit_counter)
        self._running[req.uid] = req
        self._open_req_span(req, "prefill")

    def _pick_victim(self) -> Request:
        """Lowest priority, then most recently admitted."""
        if not self._running:
            raise RuntimeError("no running request to preempt")
        return min(self._running.values(),
                   key=lambda r: (r.priority, -r.admitted_at))

    def _preempt(self, req: Request) -> None:
        self.engine.flush_to_host([req.uid])
        del self._running[req.uid]
        req.fed = 0
        req.preemptions += 1
        self._close_req_span(req.uid, outcome="preempted")
        req.transition(RequestState.PREEMPTED)
        self._preempted.append(req)
        self._parked_backlog += self._work(req)
        self.metrics.record_preemption(req)
        logger.debug(f"serving: preempted request {req.uid} "
                     f"({len(req.generated)} tokens generated)")

    def _fail(self, req: Request, reason: str) -> None:
        # a QUEUED request can hold engine state too: resubmit() with a KV
        # payload injects the sequence before admission packs it
        if self.engine.state_manager.get_sequence(req.uid) is not None:
            self.engine.flush([req.uid])
        if req.uid in self._running:
            del self._running[req.uid]
        if req in self._queued:
            self._queued.remove(req)
            self._parked_backlog -= self._work(req)
        if req in self._preempted:
            self._preempted.remove(req)
            self._parked_backlog -= self._work(req)
        req.finish_reason = reason
        self._close_req_span(req.uid, outcome="failed", reason=reason)
        req.transition(RequestState.FAILED)
        self._drop_request_state(req.uid)
        self._finished.append(req)
        self.metrics.record_finish(req)
        logger.warning(f"serving: request {req.uid} failed: {reason}")

    def _expire_deadlines(self) -> None:
        """Fail every non-terminal request past its ``deadline_s`` (reason
        "deadline") — queued, running, or preempted alike.  Tokens already
        generated stay on the request, but a blown SLO is a failure: the
        client stopped waiting, so finishing the work is wasted compute."""
        for req in [*self._queued, *self._running.values(),
                    *self._preempted]:
            if req.past_deadline:
                self._fail(req, "deadline")

    def _reap_unservable(self) -> None:
        """Terminate requests whose token history has outgrown the ENTIRE
        KV pool: they can never feed again, alone or otherwise.  Without
        this guard a decode at the pool boundary enters an infinite
        preempt -> recompute -> preempt cycle.  Generated tokens are kept
        (FINISHED, truncated by capacity); a request that never produced
        a token fails instead."""
        sm = self.engine.state_manager
        usable = sm.allocator.num_blocks - 1          # trash block reserved
        for req in [*self._running.values(), *self._preempted]:
            if -(-len(req.history) // sm.block_size) <= usable:
                continue
            if req.uid in self._running:
                self.engine.flush([req.uid])
                del self._running[req.uid]
            else:
                self._preempted.remove(req)
                self._parked_backlog -= self._work(req)
            if req.generated:
                req.finish_reason = "length"
                self._close_req_span(req.uid, outcome="finished",
                                     reason="length")
                req.transition(RequestState.FINISHED)
            else:
                req.finish_reason = "kv_capacity"
                self._close_req_span(req.uid, outcome="failed",
                                     reason="kv_capacity")
                req.transition(RequestState.FAILED)
            self._drop_request_state(req.uid)
            self._finished.append(req)
            self.metrics.record_finish(req)
            logger.warning(
                f"serving: request {req.uid} truncated — history of "
                f"{len(req.history)} tokens exceeds the {usable}-block "
                f"KV pool")

    def _handle_stall(self) -> None:
        """Nothing could be packed.  With two or more running requests
        this is a recoverable mid-prefill deadlock (they jointly hold the
        pool, none can extend): preempt one — its blocks let the others
        finish, and it resumes by recompute.  A SINGLE stalled holder (or
        a stall with nothing running) can never fit and is failed rather
        than spun on; _reap_unservable catches the history-outgrew-pool
        case before it reaches here."""
        if len(self._running) > 1:
            self._preempt(self._pick_victim())
        elif self._running:
            self._fail(self._pick_victim(), "kv_capacity")
        elif self._preempted:
            self._fail(self._preempted[0], "kv_capacity")
        elif self._queued:
            self._fail(self._queued[0], "kv_capacity")

    # -- sampling / lifecycle advance ---------------------------------- #
    def _sample_and_advance(self, packed, logits) -> List[Tuple[Request, int]]:
        ready = [r for r in packed if r.remaining_feed == 0]
        if not ready:
            return []
        rows = np.stack([np.asarray(logits[r.uid], np.float32)
                         for r in ready])
        tokens = sample_batch(rows, [r.sampling for r in ready],
                              [len(r.generated) for r in ready],
                              [r.uid for r in ready])
        return self._advance_emitted(ready, tokens.tolist())

    def _advance_emitted(self, ready,
                         tokens: List[int]) -> List[Tuple[Request, int]]:
        now = time.monotonic()
        emitted: List[Tuple[Request, int]] = []
        for req, tok in zip(ready, tokens):
            req.emit(tok, now)
            emitted.append((req, tok))
            reason = req.should_stop()
            if reason is None and len(req.history) >= self.max_context:
                reason = "length"
            if reason is not None:
                self._finish(req, reason)
            elif req.state is RequestState.PREFILL:
                req.transition(RequestState.DECODE)
                # prefill phase over: the span chain continues as decode
                self._open_req_span(req, "decode")
        return emitted

    def _drop_request_state(self, uid: int) -> None:
        """Terminal-transition bookkeeping shared by finish/fail/reap/
        handoff: the uid leaves the live set and its speculative
        autotune state (accept-rate EWMA + effective K) is dropped so
        the tables stay bounded by the live request set."""
        self._live_uids.discard(uid)
        self._spec_accept_ewma.pop(uid, None)
        self._spec_k.pop(uid, None)

    def _finish(self, req: Request, reason: str) -> None:
        self.engine.flush([req.uid])
        del self._running[req.uid]
        req.finish_reason = reason
        self._close_req_span(req.uid, outcome="finished", reason=reason)
        req.transition(RequestState.FINISHED)
        self._drop_request_state(req.uid)
        self._finished.append(req)
        self.metrics.record_finish(req)

    # ------------------------------------------------------------------ #
    # Driving loops
    # ------------------------------------------------------------------ #
    def telemetry(self, _snapshot: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
        """Every ``serving/*`` scalar this scheduler emits, fully
        namespaced — the SLO snapshot plus prefix-cache and fast-tick
        telemetry.  This is both ``_export_metrics``'s source and the
        provider a unified :class:`MetricsRegistry` snapshots."""
        if _snapshot is None:
            _snapshot = self.metrics.snapshot()
        out = {f"serving/{k}": float(v) for k, v in _snapshot.items()}
        out["serving/fast_decode_ticks"] = float(self.fast_ticks)
        if self.speculative is not None:
            out.update((f"serving/spec_{k}", float(v))
                       for k, v in self.spec_stats.as_dict().items())
        pc = getattr(self.engine.state_manager, "prefix_cache", None) \
            if hasattr(self.engine, "state_manager") else None
        if pc is not None:
            out.update((f"serving/prefix_{k}", float(v))
                       for k, v in pc.stats.as_dict().items())
        return out

    def _export_metrics(self) -> None:
        """serving/* scalars plus prefix-cache and fast-tick telemetry.
        ONE metrics snapshot feeds both the base-name set and the extra
        list (snapshot percentiles are not free on the export path)."""
        snap = self.metrics.snapshot()
        base = {f"serving/{k}" for k in snap}
        extra = [(k, v) for k, v in self.telemetry(snap).items()
                 if k not in base]
        self.metrics.export(extra=extra, snapshot=snap)

    def run_until_idle(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Step until every submitted request reaches a terminal state
        (or ``max_ticks``).  Returns all finished/failed requests so far."""
        ticks = 0
        while self.num_pending:
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        self._export_metrics()
        return self.finished_requests

    def run_with_arrivals(self, prompts, arrivals, sampling=None,
                          priority: int = 0,
                          poll_s: float = 0.005) -> List[Request]:
        """Open-loop arrival driver: submit ``prompts[i]`` once
        ``arrivals[i]`` seconds of wall clock have elapsed, stepping the
        scheduler between arrivals until everything terminates.  Used by
        the Poisson benches (``bench_serving.py --scheduler``) and the
        tier-1 smoke.  ``sampling`` is one :class:`SamplingParams` shared
        by all requests, or a per-request sequence."""
        n = len(prompts)
        per_req = isinstance(sampling, (list, tuple))
        reqs: List[Request] = []
        t0 = time.monotonic()
        while len(reqs) < n or self.num_pending:
            now = time.monotonic() - t0
            while len(reqs) < n and arrivals[len(reqs)] <= now:
                i = len(reqs)
                reqs.append(self.submit(
                    prompts[i],
                    sampling=sampling[i] if per_req else sampling,
                    priority=priority))
            if self.num_pending:
                self.step()
            elif len(reqs) < n:
                time.sleep(min(arrivals[len(reqs)] - now, poll_s))
        return reqs

    def shutdown(self, drain_deadline: float = 30.0, handoff: bool = False):
        """Graceful shutdown: close admission immediately (``submit``
        raises from now on) and let in-flight work finish via
        :meth:`drain`.

        ``handoff=False`` (the default): whatever is still pending after
        ``drain_deadline`` seconds is failed with reason ``"shutdown"``
        (counted in ``serving/shutdown_failed``).  Returns True when
        everything drained — nothing was dropped.

        ``handoff=True`` (rolling restarts / elastic downsize): pending
        requests are DETACHED instead of failed — each becomes a
        serializable :class:`~deepspeed_tpu_torch.serving.request.RequestSnapshot`
        (tokens emitted, sampler seed, tenant/priority/remaining deadline)
        that another replica's :meth:`resubmit` continues token-exactly.
        Returns ``(drained, snapshots)``; ``snapshots`` is empty when the
        drain completed in time."""
        self._shutting_down = True
        idle = self.drain(drain_deadline)
        if handoff:
            snaps = []
            if not idle:
                leftovers = [*self._queued, *list(self._running.values()),
                             *self._preempted]
                logger.info(
                    f"serving: shutdown drain deadline ({drain_deadline}s) "
                    f"expired — handing off {len(leftovers)} request(s)")
                snaps = [self._detach(req)[0] for req in leftovers]
                self._export_metrics()
            return idle, snaps
        if not idle:
            leftovers = [*self._queued, *list(self._running.values()),
                         *self._preempted]
            logger.warning(
                f"serving: shutdown drain deadline ({drain_deadline}s) "
                f"expired with {len(leftovers)} request(s) pending — "
                "failing them with reason 'shutdown'")
            for req in leftovers:
                self._fail(req, "shutdown")
            self._export_metrics()
        return idle

    def close_admission(self) -> None:
        """Close admission WITHOUT draining: ``submit`` raises from now
        on and routers skip this replica, but in-flight work keeps
        stepping under the caller's control.  The fleet's graceful
        scale-down uses this to quiesce a victim while it keeps pumping
        the victim's scheduler (and chaos-injecting its drain) itself,
        then calls :meth:`shutdown(0, handoff=True)` to detach whatever
        is left."""
        self._shutting_down = True

    # ------------------------------------------------------------------ #
    # Cross-replica handoff (the fleet layer's migration primitive)
    # ------------------------------------------------------------------ #
    @property
    def accepting_submissions(self) -> bool:
        """False once :meth:`shutdown` closed admission (a router skips
        draining replicas)."""
        return not self._shutting_down

    def _detach(self, req: Request, include_kv: bool = False):
        """Remove ``req`` from every scheduler structure and return
        ``(snapshot, kv_state)`` — the request continues elsewhere as a
        NEW object; this one transitions to the terminal ``HANDED_OFF``
        (so tenant-quota views prune it, and a holder sees it is gone).
        ``include_kv=True`` (running requests only) carries the device KV
        along so the target replica skips the recompute re-prefill."""
        kv_state = None
        fed = 0
        if req.uid in self._running:
            if include_kv and hasattr(self.engine, "flush_to_host"):
                kv_state = self.engine.flush_to_host(
                    [req.uid], include_kv=True)[req.uid]
                fed = kv_state["seen_tokens"]
            else:
                self.engine.flush_to_host([req.uid])
            del self._running[req.uid]
            req.fed = 0
        elif self.engine.state_manager.get_sequence(req.uid) is not None:
            # an injected-KV request still queued: release its blocks
            self.engine.flush([req.uid])
        if req in self._queued:
            self._queued.remove(req)
            self._parked_backlog -= self._work(req)
        elif req in self._preempted:
            self._preempted.remove(req)
            self._parked_backlog -= self._work(req)
        self._drop_request_state(req.uid)
        snap = req.snapshot(fed_tokens=fed)
        req.finish_reason = "handoff"
        self._close_req_span(req.uid, outcome="handoff",
                             fed_tokens=fed)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("request/handoff", trace_id=req.trace_id,
                       tid=self.trace_tid,
                       attrs={"uid": req.uid, "fed_tokens": fed,
                              "kv": kv_state is not None})
        req.transition(RequestState.HANDED_OFF)
        self.metrics.record_handoff(req)
        return snap, kv_state

    def extract_for_handoff(self, uid: int, include_kv: bool = False):
        """Detach one live request for migration to another replica.
        Returns ``(snapshot, kv_state)``; ``kv_state`` is the
        ``flush_to_host(include_kv=True)`` payload when requested and the
        request was running (None otherwise).  The disaggregated
        prefill→decode pump calls this the tick a prefill completes."""
        for req in [*self._running.values(), *self._queued,
                    *self._preempted]:
            if req.uid == uid:
                return self._detach(req, include_kv=include_kv)
        raise ValueError(f"extract_for_handoff: uid {uid} is not live")

    def resubmit(self, snap, kv_state=None, on_token=None) -> Request:
        """Continue a handed-off request on THIS replica.

        Reconstructs a :class:`Request` from ``snap`` (uid preserved — it
        keys the sampling noise stream) and submits it.  Without
        ``kv_state`` the request re-prefills ``prompt + generated``
        (recompute, warm prefix blocks re-attach via the radix cache when
        enabled).  With ``kv_state`` the carried KV is injected through
        ``engine.resume(..., kv_state=...)`` so only the unfed tail is
        ever recomputed; when the KV no longer fits this replica's pool
        the payload is dropped and the request falls back to recompute —
        a handoff may get slower, never lost."""
        req = snap.to_request(on_token=on_token)
        injected = False
        if kv_state is not None and hasattr(self.engine, "resume"):
            sm = self.engine.state_manager
            seen = min(int(kv_state["seen_tokens"]), len(req.history) - 1)
            need = -(-seen // sm.block_size) if seen > 0 else 0
            if seen > 0 and need <= sm.free_blocks \
                    and sm.get_sequence(req.uid) is None \
                    and not self._shutting_down:
                self.engine.resume(req.uid, req.history[:seen],
                                   kv_state=kv_state)
                req.fed = seen
                injected = True
        try:
            return self.submit(request=req)
        except Exception:
            if injected:
                self.engine.flush([req.uid])
            raise

    def drain(self, deadline: float) -> bool:
        """Async-friendly bounded drain: step until idle or ``deadline``
        seconds of wall clock elapse, then return control to the caller
        (an event loop can interleave submits between drains).  Returns
        True when fully idle."""
        end = time.monotonic() + deadline
        while self.num_pending and time.monotonic() < end:
            self.step()
        if not self.num_pending:
            self._export_metrics()
        return self.num_pending == 0
