"""Cache-aware multi-replica front-end router (counterpart of
``deepspeed_tpu/serving/router.py``; the role DeepSpeed-MII's
multi-replica load balancer plays above FastGen — ``mii/backend`` round-
robin — made prefix-cache-aware and policy-rich, owned in-repo).

Placement: each replica's radix prefix cache is probed for the request's
longest cached prefix, and the request routes to the replica scoring
highest on ``cache_weight * cached_tokens - load_weight * backlog_tokens``
— a request carrying a fleet-common system prompt lands where that
prompt's KV is already warm (no re-prefill), while cold requests spread by
load.  Ties break toward the emptier replica, then round-robin.

Admission composes three gates IN FRONT of the schedulers' own
deadline/queue-bound machinery:

* **per-tenant quotas** — bounded in-flight requests and/or in-flight
  tokens per tenant (:class:`TenantQuota`); past them ``submit`` raises
  :class:`QuotaExceededError` (one noisy tenant cannot starve the fleet);
* **priority classes** — named classes (``interactive``/``standard``/
  ``batch`` by default) mapping to the scheduler's numeric priority (who
  gets preempted under KV pressure) plus a default deadline;
* **SLO-aware admission** — a deadline'd request is rejected up front
  (:class:`AdmissionRejectedError`) when the chosen replica's backlog,
  divided by its measured token throughput, already exceeds the deadline:
  shedding doomed work at the door instead of failing it after it burned
  a prefill.

Everything here is host-side policy; replicas do the device work through
their own :class:`ContinuousBatchScheduler`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from deepspeed_tpu_torch.serving.request import Request, SamplingParams
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchScheduler
from deepspeed_tpu_torch.utils.logging import logger


class QuotaExceededError(RuntimeError):
    """``submit()`` rejected: the tenant is at its in-flight quota.
    Back off and retry once some of the tenant's requests finish."""


class AdmissionRejectedError(RuntimeError):
    """``submit()`` rejected: the target replica's backlog already exceeds
    the request's deadline — admitting it would only burn prefill compute
    on a response nobody will wait for."""


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """A named service class: scheduler priority (higher preempts later)
    plus an optional default SLO deadline."""

    name: str
    priority: int = 0
    deadline_s: Optional[float] = None


DEFAULT_PRIORITY_CLASSES: Dict[str, PriorityClass] = {
    "interactive": PriorityClass("interactive", priority=10),
    "standard": PriorityClass("standard", priority=0),
    "batch": PriorityClass("batch", priority=-10),
}


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant admission bounds (None = unbounded)."""

    max_inflight: Optional[int] = None          # live requests
    max_inflight_tokens: Optional[int] = None   # live prompt+gen budget

    def __post_init__(self):
        for v in (self.max_inflight, self.max_inflight_tokens):
            if v is not None and v < 1:
                raise ValueError("quota bounds must be >= 1 (or None)")


class Replica:
    """One serving replica: a named :class:`ContinuousBatchScheduler` plus
    the probes the router scores placement with."""

    def __init__(self, name: str, scheduler: ContinuousBatchScheduler):
        self.name = name
        self.scheduler = scheduler

    def prefix_match_tokens(self, tokens: Sequence[int]) -> int:
        """Longest prefix of ``tokens`` warm in this replica's KV cache
        (0 when prefix caching is off).  LRU state is NOT touched — a
        probe is not a use."""
        sm = getattr(self.scheduler.engine, "state_manager", None)
        pc = getattr(sm, "prefix_cache", None)
        return pc.match_len(tokens) if pc is not None else 0

    def load_tokens(self) -> int:
        """Outstanding prefill+decode tokens on this replica."""
        return self.scheduler.backlog_tokens()

    @property
    def accepting(self) -> bool:
        """False while the replica drains for a rolling restart — the
        router must place traffic elsewhere."""
        return getattr(self.scheduler, "accepting_submissions", True)

    @property
    def num_pending(self) -> int:
        return self.scheduler.num_pending

    def step(self):
        return self.scheduler.step()


class CacheAwareRouter:
    """Routes requests across serving replicas by cache affinity and load,
    under per-tenant quotas, priority classes, and SLO admission."""

    def __init__(self, replicas: Union[Sequence[ContinuousBatchScheduler],
                                       Dict[str, ContinuousBatchScheduler]],
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 priority_classes: Optional[Dict[str, PriorityClass]] = None,
                 cache_weight: float = 1.0,
                 load_weight: float = 0.5,
                 admission_tokens_per_s: Optional[float] = None):
        if isinstance(replicas, dict):
            self.replicas = [Replica(name, s) for name, s in replicas.items()]
        else:
            self.replicas = [
                r if isinstance(r, Replica) else Replica(f"replica{i}", r)
                for i, r in enumerate(replicas)]
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        self.priority_classes = dict(priority_classes
                                     if priority_classes is not None
                                     else DEFAULT_PRIORITY_CLASSES)
        self.cache_weight = cache_weight
        self.load_weight = load_weight
        #: static throughput estimate for SLO admission; None derives a
        #: per-replica estimate from its rolling (windowed) goodput
        self.admission_tokens_per_s = admission_tokens_per_s
        self._tenant_live: Dict[str, List[Request]] = {}
        self._rr = itertools.count()
        #: fleet-global uid allocator — every scheduler's own counter
        #: starts at 1, so router-placed requests on different replicas
        #: would collide and draw the same (seed, uid, position) sampling
        #: noise stream
        self._uid_counter = itertools.count(1)
        # telemetry
        self.routed: Dict[str, int] = {r.name: 0 for r in self.replicas}
        self.cache_hit_routed = 0           # requests placed on a warm match
        self.cache_hit_tokens = 0           # prefix tokens warm at placement
        self.quota_rejects = 0
        self.slo_rejects = 0

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _score(self, prompt: Sequence[int]) -> List[Tuple[float, int, int,
                                                          Replica]]:
        out = []
        for i, rep in enumerate(self.replicas):
            hit = rep.prefix_match_tokens(prompt)
            load = rep.load_tokens()
            score = self.cache_weight * hit - self.load_weight * load
            out.append((score, hit, load, rep))
        return out

    def _ranked(self, prompt: Sequence[int]) -> List[Tuple[float, int, int,
                                                           Replica]]:
        """Accepting replicas in placement-preference order: highest
        cache-minus-load score, ties to the lighter replica, then
        rotating round-robin so equal replicas share cold traffic.
        Draining replicas (rolling restart) are never candidates; the
        router raises only when EVERY replica drains."""
        scored = [s for s in self._score(prompt) if s[3].accepting]
        if not scored:
            raise RuntimeError(
                "router: no replica is accepting — every replica is "
                "draining; retry after the upgrade wave")
        rr = next(self._rr)
        n = len(scored)
        order = sorted(
            range(n),
            key=lambda i: (scored[i][0], -scored[i][2], -((i - rr) % n)),
            reverse=True)
        return [scored[i] for i in order]

    def _pick_scored(self, prompt: Sequence[int]) -> Tuple[Replica, int,
                                                           int]:
        _, hit, load, rep = self._ranked(prompt)[0]
        return rep, hit, load

    def pick_replica(self, prompt: Sequence[int]) -> Tuple[Replica, int]:
        """Best replica for ``prompt`` and its warm-prefix length there:
        highest cache-minus-load score, ties to the lighter replica, then
        rotating round-robin so equal replicas share cold traffic."""
        rep, hit, _ = self._pick_scored(prompt)
        return rep, hit

    # ------------------------------------------------------------------ #
    # Admission gates
    # ------------------------------------------------------------------ #
    def _live(self, tenant: str) -> List[Request]:
        live = [r for r in self._tenant_live.get(tenant, ())
                if not r.done]
        self._tenant_live[tenant] = live
        return live

    def tenant_inflight(self, tenant: str) -> int:
        return len(self._live(tenant))

    def _check_quota(self, tenant: str, prompt_len: int,
                     max_new: int) -> None:
        quota = self.quotas.get(tenant, self.default_quota)
        if quota is None:
            return
        live = self._live(tenant)
        if quota.max_inflight is not None and \
                len(live) >= quota.max_inflight:
            self.quota_rejects += 1
            raise QuotaExceededError(
                f"tenant {tenant!r} at max_inflight="
                f"{quota.max_inflight} — request rejected")
        if quota.max_inflight_tokens is not None:
            used = sum(len(r.prompt) + r.sampling.max_new_tokens
                       for r in live)
            if used + prompt_len + max_new > quota.max_inflight_tokens:
                self.quota_rejects += 1
                raise QuotaExceededError(
                    f"tenant {tenant!r} at max_inflight_tokens="
                    f"{quota.max_inflight_tokens} ({used} in flight) — "
                    f"request of {prompt_len}+{max_new} tokens rejected")

    def _check_slo(self, rep: Replica, hit: int, load: int, prompt_len: int,
                   deadline_s: Optional[float]) -> None:
        if deadline_s is None:
            return
        rate = self.admission_tokens_per_s
        if rate is None:
            # windowed rate, not the lifetime average: the latter decays
            # toward zero while a replica idles, predicting hour-long
            # waits against a free machine.  The rolling window reads 0
            # after an idle spell, which the no-evidence branch admits.
            rate = rep.scheduler.metrics.goodput_tokens_per_s()
        if rate <= 0:
            return            # no throughput evidence yet: admit
        # ``load`` comes from the scoring pass — don't re-walk the
        # replica's backlog on the admission path
        backlog = load + max(prompt_len - hit, 0)
        est_wait = backlog / rate
        if est_wait > deadline_s:
            raise AdmissionRejectedError(
                f"replica {rep.name}: backlog of {backlog} tokens at "
                f"~{rate:.1f} tok/s predicts {est_wait:.2f}s to first "
                f"token — past the {deadline_s}s deadline; rejected at "
                f"admission")

    # ------------------------------------------------------------------ #
    # Submission / driving
    # ------------------------------------------------------------------ #
    def submit(self, prompt: Sequence[int], *, tenant: str = "default",
               priority_class: Optional[str] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None,
               on_token=None, uid: Optional[int] = None,
               trace_id: Optional[str] = None) -> Request:
        """Admit one request through quota/priority/SLO gates and place it
        on the cache-affine replica.  The returned :class:`Request` is
        annotated with ``.replica`` (name) and ``.tenant``.  Raises
        :class:`QuotaExceededError`, :class:`AdmissionRejectedError`, or
        the target scheduler's own admission errors
        (:class:`~deepspeed_tpu_torch.serving.scheduler.QueueFullError`, ...)."""
        if priority_class is not None:
            try:
                cls = self.priority_classes[priority_class]
            except KeyError:
                raise ValueError(
                    f"unknown priority class {priority_class!r} "
                    f"(have {sorted(self.priority_classes)})") from None
            if priority is None:
                priority = cls.priority
            if deadline_s is None:
                deadline_s = cls.deadline_s
        sampling = sampling or SamplingParams()
        if uid is None:
            # skip uids a caller-supplied submit may have claimed anywhere
            # in the fleet
            tracked = [r.scheduler for r in self.replicas
                       if hasattr(r.scheduler, "_is_tracked_uid")]
            uid = next(self._uid_counter)
            while any(s._is_tracked_uid(uid) for s in tracked):
                uid = next(self._uid_counter)
        self._check_quota(tenant, len(prompt), sampling.max_new_tokens)
        # place on the preferred replica that can still meet the deadline
        # — a buried warm replica must not doom a request another replica
        # could serve in time; reject only when every replica blows it
        rep, hit = None, 0
        slo_err: Optional[AdmissionRejectedError] = None
        for _, cand_hit, cand_load, cand in self._ranked(prompt):
            try:
                self._check_slo(cand, cand_hit, cand_load, len(prompt),
                                deadline_s)
            except AdmissionRejectedError as e:
                if slo_err is None:
                    slo_err = e   # the preferred replica's verdict
                continue
            rep, hit = cand, cand_hit
            break
        if rep is None:
            self.slo_rejects += 1
            raise slo_err
        req = rep.scheduler.submit(
            prompt, sampling=sampling, priority=priority or 0,
            deadline_s=deadline_s, on_token=on_token, uid=uid,
            trace_id=trace_id)
        req.tenant = tenant
        req.replica = rep.name
        # prune finished requests even when no quota gated this tenant —
        # otherwise an unquota'd tenant's list grows without bound
        self._live(tenant)
        self._tenant_live.setdefault(tenant, []).append(req)
        self.routed[rep.name] += 1
        if hit > 0:
            self.cache_hit_routed += 1
            self.cache_hit_tokens += hit
        logger.debug(f"router: request {req.uid} (tenant={tenant}) -> "
                     f"{rep.name} (warm prefix {hit} tokens)")
        return req

    def resubmit(self, snap, kv_state=None, on_token=None,
                 exclude: Sequence[str] = ()) -> Request:
        """Place a handed-off request (a
        :class:`~deepspeed_tpu_torch.serving.request.RequestSnapshot`) on the
        best accepting replica — scored by the FULL history so a replica
        holding the request's own warm prefix wins — and continue it via
        the target scheduler's ``resubmit``.  ``exclude`` names replicas
        that must not receive it (e.g. the one it just left)."""
        ranked = [(s, h, l, rep)
                  for s, h, l, rep in self._ranked(snap.history)
                  if rep.name not in exclude]
        if not ranked:
            raise RuntimeError(
                f"router: no replica can take handed-off request "
                f"{snap.uid} (excluded: {list(exclude)})")
        _, hit, _, rep = ranked[0]
        req = rep.scheduler.resubmit(snap, kv_state=kv_state,
                                     on_token=on_token)
        req.tenant = snap.tenant
        req.replica = rep.name
        if snap.tenant is not None:
            self._live(snap.tenant)
            self._tenant_live.setdefault(snap.tenant, []).append(req)
        self.routed[rep.name] = self.routed.get(rep.name, 0) + 1
        # KV-injected handoffs never attach the prefix cache (the carried
        # KV wins) — counting the scoring hit would over-report saved
        # prefill exactly in the disaggregated mode the bench measures
        if hit > 0 and kv_state is None:
            self.cache_hit_routed += 1
            self.cache_hit_tokens += hit
        return req

    # ------------------------------------------------------------------ #
    # Elastic replica set (fleet scale-up/down and rolling restarts)
    # ------------------------------------------------------------------ #
    def add_replica(self, name: str,
                    scheduler: ContinuousBatchScheduler) -> Replica:
        """Join a fresh replica to the placement set (elastic scale-up)."""
        if any(r.name == name for r in self.replicas):
            raise ValueError(f"router: replica {name!r} already present")
        rep = Replica(name, scheduler)
        self.replicas.append(rep)
        self.routed.setdefault(name, 0)
        return rep

    def remove_replica(self, name: str) -> Replica:
        """Detach a replica from placement (elastic downsize).  The
        caller drains it (``shutdown(handoff=True)``) and feeds the
        snapshots back through :meth:`resubmit`; its lifetime ``routed``
        count stays in the telemetry."""
        for i, rep in enumerate(self.replicas):
            if rep.name == name:
                if len(self.replicas) == 1:
                    raise ValueError(
                        "router: cannot remove the last replica")
                return self.replicas.pop(i)
        raise ValueError(f"router: unknown replica {name!r}")

    def replace_replica(self, name: str,
                        scheduler: ContinuousBatchScheduler) -> Replica:
        """Swap a replica's scheduler in place (rolling restart respawn:
        same name, fresh engine from checkpointed state)."""
        for rep in self.replicas:
            if rep.name == name:
                rep.scheduler = scheduler
                return rep
        raise ValueError(f"router: unknown replica {name!r}")

    @property
    def num_pending(self) -> int:
        return sum(r.num_pending for r in self.replicas)

    def step(self) -> List[Tuple[Request, int]]:
        """One tick on every replica with pending work; returns the
        merged ``(request, token)`` emissions."""
        emitted: List[Tuple[Request, int]] = []
        for rep in self.replicas:
            if rep.num_pending:
                emitted.extend(rep.step())
        return emitted

    def run_until_idle(self,
                       max_ticks: Optional[int] = None) -> List[Request]:
        ticks = 0
        while self.num_pending:
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        return [r for rep in self.replicas
                for r in rep.scheduler.finished_requests]

    def snapshot(self) -> Dict[str, float]:
        """Router-level telemetry (per-replica placement and load plus the
        admission-gate counters)."""
        out: Dict[str, float] = {
            "replicas": float(len(self.replicas)),
            "cache_hit_routed": float(self.cache_hit_routed),
            "cache_hit_tokens": float(self.cache_hit_tokens),
            "quota_rejects": float(self.quota_rejects),
            "slo_rejects": float(self.slo_rejects),
        }
        for rep in self.replicas:
            out[f"routed_{rep.name}"] = float(self.routed[rep.name])
            out[f"load_tokens_{rep.name}"] = float(rep.load_tokens())
        return out
