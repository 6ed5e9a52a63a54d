"""The port's cache-aware router against the JAX package's, on the CPU.

Each case drives both routers with the same traffic and compares what they
decide: replica picks, ``cache_hit_routed`` / ``cache_hit_tokens``, request
uids, quota / priority / SLO outcomes, the elastic replica set and the
snapshot.  Policy cases run over engine-free stand-in schedulers (the
placement probe reads a stub cache); the end-to-end shared-prefix run and
the handoff run drive real engines on ``LlamaConfig.tiny`` in f32 with the
same weights (``params_from_jax``), so their generated tokens must be
equal too.  Mirrors ``tests/unit/test_serving_router.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu.serving import request as jrequest
from deepspeed_tpu_torch import serving as tserving
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig
from deepspeed_tpu_torch.serving import request as trequest

from torch_port_common import single_process_env  # noqa: F401 (autouse)

BS = 8
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = TLlamaConfig.tiny(dtype=torch.float32)
SIDES = ((jserving, jrequest), (tserving, trequest))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The test workers share the CPU: one torch thread each keeps these
    small-tensor tests from spinning up a thread pool per operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, JLlamaForCausalLM(JCFG).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))["params"])


# --------------------------------------------------------------------- #
# Engine-free stand-ins (one per package: each builds its own Request)
# --------------------------------------------------------------------- #
class _FakeCache:
    def __init__(self):
        self.warm = []

    def match_len(self, tokens):
        n = 0
        for a, b in zip(self.warm, tokens):
            if a != b:
                break
            n += 1
        return n


class _FakeScheduler:
    """Queues requests and reports backlog; never runs a model."""

    def __init__(self, pkg, req_mod, rate=0.0):
        self.pkg, self.req_mod = pkg, req_mod
        self._queued, self._running, self._preempted = [], {}, []
        self.metrics = types.SimpleNamespace(
            goodput_tokens_per_s=lambda: rate)
        self._uid = 100
        self.engine = types.SimpleNamespace(
            state_manager=types.SimpleNamespace(prefix_cache=_FakeCache()))
        self.accepting_submissions = True

    def submit(self, prompt, sampling=None, priority=0, deadline_s=None,
               on_token=None, uid=None, trace_id=None):
        self._uid += 1
        req = self.req_mod.Request(
            uid=uid or self._uid, prompt=list(prompt),
            sampling=sampling or self.pkg.SamplingParams(),
            priority=priority, deadline_s=deadline_s, trace_id=trace_id)
        self._queued.append(req)
        return req

    def finish_all(self):
        for r in self._queued:
            r.state = self.req_mod.RequestState.FAILED
        self._queued.clear()

    def backlog_tokens(self):
        return sum(r.remaining_feed
                   + max(r.sampling.max_new_tokens - len(r.generated), 0)
                   for r in [*self._queued, *self._running.values(),
                             *self._preempted])

    @property
    def num_pending(self):
        return len(self._queued)

    @property
    def finished_requests(self):
        return []

    def step(self):
        return []


def _fake_routers(n=2, warm=None, rate=0.0, **kw):
    out = []
    for pkg, req_mod in SIDES:
        scheds = [_FakeScheduler(pkg, req_mod, rate) for _ in range(n)]
        for name, tokens in (warm or {}).items():
            scheds[int(name[-1])].engine.state_manager.prefix_cache.warm = \
                list(tokens)
        out.append((pkg, pkg.CacheAwareRouter(
            [pkg.Replica(f"replica{i}", s) for i, s in enumerate(scheds)],
            **kw), scheds))
    return out


def _outcome(fn):
    try:
        req = fn()
    except Exception as e:  # noqa: BLE001 — the outcome compared
        return type(e).__name__, str(e)
    return (req.replica, req.uid, req.priority, req.deadline_s,
            getattr(req, "tenant", None))


def _counters(router):
    return (router.cache_hit_routed, router.cache_hit_tokens,
            router.quota_rejects, router.slo_rejects, dict(router.routed),
            router.snapshot())


def _prompt_stream(seed, n, size=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(size,)).tolist() for _ in range(n)]


# --------------------------------------------------------------------- #
# Placement, uids, quotas, priority classes and SLO admission
# --------------------------------------------------------------------- #
def _cold_spread(pkg, router, scheds):
    return [_outcome(lambda p=p: router.submit(
        p, sampling=pkg.SamplingParams(max_new_tokens=2)))
        for p in _prompt_stream(1, 6)]


def _affinity_then_imbalance(pkg, router, scheds):
    prompt = list(range(16))
    out = [_outcome(lambda: router.submit(
        prompt, sampling=pkg.SamplingParams(max_new_tokens=2)))]
    for _ in range(4):
        scheds[0].submit(list(range(100, 124)),
                         sampling=pkg.SamplingParams(max_new_tokens=16))
    out.append(_outcome(lambda: router.submit(
        prompt, sampling=pkg.SamplingParams(max_new_tokens=2))))
    return out


def _unique_uids(pkg, router, scheds):
    # a caller-supplied uid claims 2 on one replica: the router skips it
    scheds[1].submit([1, 2, 3], uid=2)
    out = [_outcome(lambda p=p: router.submit(
        p, sampling=pkg.SamplingParams(max_new_tokens=2)))
        for p in _prompt_stream(9, 9)]
    assert len({o[1] for o in out}) == len(out)
    return out


def _slo_fallback(pkg, router, scheds):
    prompt = list(range(64))
    scheds[0].submit(list(range(40)),
                     sampling=pkg.SamplingParams(max_new_tokens=200))
    return [_outcome(lambda: router.submit(prompt, deadline_s=10.0)),
            _outcome(lambda: router.submit(prompt, deadline_s=2.0)),
            _outcome(lambda: router.submit(prompt))]


def _quotas(pkg, router, scheds):
    ps = _prompt_stream(3, 8, size=8)
    out = [_outcome(lambda p=p: router.submit(p, tenant="acme"))
           for p in ps[:3]]
    out.append(_outcome(lambda: router.submit(ps[3], tenant="other")))
    out.append(_outcome(lambda: router.submit(
        ps[4], tenant="tok", sampling=pkg.SamplingParams(max_new_tokens=16))))
    out.append(_outcome(lambda: router.submit(
        ps[5], tenant="tok", sampling=pkg.SamplingParams(max_new_tokens=16))))
    for s in scheds:
        s.finish_all()              # quota frees up as requests finish
    out.append(_outcome(lambda: router.submit(ps[6], tenant="acme")))
    out.append(router.tenant_inflight("acme"))
    return out


def _priority_classes(pkg, router, scheds):
    return [_outcome(lambda: router.submit([1, 2, 3],
                                           priority_class="interactive")),
            _outcome(lambda: router.submit([4, 5], priority_class="batch")),
            _outcome(lambda: router.submit([6], priority_class="rt")),
            _outcome(lambda: router.submit([7], priority_class="rt",
                                           deadline_s=60.0)),
            _outcome(lambda: router.submit([8], priority_class="rt",
                                           priority=1)),
            _outcome(lambda: router.submit([9], priority_class="platinum"))]


def _draining(pkg, router, scheds):
    # the warm replica drains (a rolling restart): placement skips it;
    # with every replica draining, both routers refuse
    prompt = list(range(16))
    scheds[0].accepting_submissions = False
    out = [_outcome(lambda: router.submit(prompt))]
    scheds[1].accepting_submissions = False
    out.append(_outcome(lambda: router.submit(prompt))[0])
    return out


POLICY_CASES = {
    "draining": (_draining, {"warm": {"replica0": list(range(16))},
                             "cache_weight": 1.0}),
    "cold_spread": (_cold_spread, {"load_weight": 0.5}),
    "affinity_then_imbalance": (_affinity_then_imbalance, {
        "warm": {"replica0": list(range(16))}, "cache_weight": 1.0,
        "load_weight": 2.0}),
    "unique_uids": (_unique_uids, {"n": 3, "load_weight": 0.5}),
    "slo_fallback": (_slo_fallback, {
        "warm": {"replica0": list(range(64))},
        "admission_tokens_per_s": 10.0, "load_weight": 0.01}),
    "slo_measured_rate": (_slo_fallback, {
        "warm": {"replica0": list(range(64))}, "rate": 10.0,
        "load_weight": 0.01}),
    "quotas": (_quotas, "quotas"),
    "priority_classes": (_priority_classes, "classes"),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_router_policy_matches_jax(case):
    """The same decisions, counters and snapshot from both routers."""
    script, kw = POLICY_CASES[case]
    results = []
    for pkg, router, scheds in _fake_routers_for(kw):
        results.append((script(pkg, router, scheds), _counters(router)))
    assert results[1] == results[0]


def _fake_routers_for(kw):
    if kw == "quotas":
        return [(pkg, *_quota_router(pkg)) for pkg, _ in SIDES]
    if kw == "classes":
        return [(pkg, *_class_router(pkg)) for pkg, _ in SIDES]
    return _fake_routers(**kw)


def _quota_router(pkg):
    req_mod = dict(SIDES)[pkg]
    scheds = [_FakeScheduler(pkg, req_mod) for _ in range(2)]
    return pkg.CacheAwareRouter(
        scheds, quotas={"acme": pkg.TenantQuota(max_inflight=2),
                        "tok": pkg.TenantQuota(max_inflight_tokens=40)}), \
        scheds


def _class_router(pkg):
    req_mod = dict(SIDES)[pkg]
    scheds = [_FakeScheduler(pkg, req_mod)]
    classes = {"interactive": pkg.PriorityClass("interactive", 10),
               "batch": pkg.PriorityClass("batch", -10),
               "rt": pkg.PriorityClass("rt", priority=5, deadline_s=30.0)}
    return pkg.CacheAwareRouter(scheds, priority_classes=classes), scheds


def test_router_elastic_replica_set_matches_jax():
    """add / remove / replace replicas, placement on the changed set, the
    errors, and the lifetime telemetry of a removed replica."""
    results = []
    for pkg, router, scheds in _fake_routers(n=2, load_weight=0.5):
        req_mod = dict(SIDES)[pkg]
        out = []
        extra = _FakeScheduler(pkg, req_mod)
        out.append(router.add_replica("replica2", extra).name)
        out.append(_outcome(lambda: router.add_replica("replica2", extra)))
        out += [_outcome(lambda p=p: router.submit(p))
                for p in _prompt_stream(4, 4)]
        out.append(router.remove_replica("replica0").name)
        out += [_outcome(lambda p=p: router.submit(p))
                for p in _prompt_stream(5, 3)]
        fresh = _FakeScheduler(pkg, req_mod)
        out.append(router.replace_replica("replica1", fresh).scheduler
                   is fresh)
        out.append(_outcome(lambda: router.replace_replica("nope", fresh)))
        out.append(_outcome(lambda: router.remove_replica("nope")))
        router.remove_replica("replica1")
        out.append(_outcome(lambda: router.remove_replica("replica2")))
        out.append(router.num_pending)
        results.append((out, _counters(router)))
    assert results[1] == results[0]


def test_router_validation_matches_jax(jparams):
    for pkg, _ in SIDES:
        with pytest.raises(ValueError, match="at least one"):
            pkg.CacheAwareRouter([])
        with pytest.raises(ValueError):
            pkg.TenantQuota(max_inflight=0)
        with pytest.raises(ValueError):
            pkg.TenantQuota(max_inflight_tokens=-1)
    s = _sched_pair(jparams)[1]
    assert tserving.CacheAwareRouter({"a": s}).replicas[0].name == "a"
    with pytest.raises(ValueError, match="duplicate"):
        tserving.CacheAwareRouter([tserving.Replica("a", s),
                                   tserving.Replica("a", s)])


# --------------------------------------------------------------------- #
# Real engines: the shared-prefix fleet and handoffs
# --------------------------------------------------------------------- #
def _cfg(num_blocks=None):
    kv = {"block_size": BS, "enable_prefix_cache": True}
    if num_blocks is not None:
        kv["num_blocks"] = num_blocks
    return {"state_manager": {"max_ragged_batch_size": 32,
                              "max_ragged_sequence_count": 4,
                              "max_context": 64}, "kv_cache": kv}


def _sched_pair(jparams, num_blocks=None):
    cfg = _cfg(num_blocks)
    return (jserving.ContinuousBatchScheduler(
                JEngine(JRaggedLlama(JCFG, BS), jparams,
                        JConfig.from_dict(cfg))),
            tserving.ContinuousBatchScheduler(
                TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams,
                                                                "cpu"),
                        TConfig.from_dict(cfg), device="cpu")))


def _real_routers(jparams, n=2):
    pairs = [_sched_pair(jparams) for _ in range(n)]
    return [pkg.CacheAwareRouter([p[side] for p in pairs])
            for side, (pkg, _) in enumerate(SIDES)]


def test_router_end_to_end_shared_prefix_matches_jax(jparams):
    """Two tenants' shared prompts over two replicas: the same placements,
    uids, generated tokens and cache-hit accounting, and every tenant's
    warm requests on one replica."""
    results = []
    for router, (pkg, _) in zip(_real_routers(jparams), SIDES):
        rng = np.random.default_rng(7)
        pools = {f"t{i}": rng.integers(0, 256, size=(16,)).tolist()
                 for i in range(2)}
        reqs = []
        for i in range(8):
            tenant = f"t{i % 2}"
            prompt = pools[tenant] + rng.integers(0, 256, size=(4,)).tolist()
            reqs.append(router.submit(
                prompt, tenant=tenant,
                sampling=pkg.SamplingParams(max_new_tokens=3)))
            router.step()
        done = router.run_until_idle()
        assert all(r.state.value == "finished" for r in reqs)
        assert len({r.uid for r in reqs}) == len(reqs)
        by_tenant = {}
        for r in reqs[2:]:
            by_tenant.setdefault(r.tenant, set()).add(r.replica)
        assert all(len(v) == 1 for v in by_tenant.values()), by_tenant
        results.append(([(r.uid, r.replica, r.tenant, r.generated)
                         for r in reqs], len(done), _counters(router)))
    assert results[0][2][0] >= 4
    assert results[1] == results[0]


@pytest.mark.parametrize("include_kv", [False, True],
                         ids=["recompute", "kv_state"])
def test_router_resubmit_matches_jax(jparams, include_kv):
    """A request drained off its replica mid-generation continues on the
    other one through ``resubmit`` (recompute, or with its KV carried):
    the same target, tokens and hit accounting as the JAX router."""
    results = []
    for router, (pkg, _) in zip(_real_routers(jparams), SIDES):
        prompt = np.random.default_rng(11).integers(
            0, 256, size=(20,)).tolist()
        req = router.submit(prompt, tenant="t",
                            sampling=pkg.SamplingParams(max_new_tokens=8))
        for _ in range(4):
            router.step()
        src = next(r for r in router.replicas if r.name == req.replica)
        snap, kv = src.scheduler.extract_for_handoff(req.uid,
                                                     include_kv=include_kv)
        new = router.resubmit(snap, kv_state=kv, exclude=(src.name,))
        router.run_until_idle()
        assert new.replica != src.name and new.state.value == "finished"
        results.append((new.replica, new.uid, new.generated,
                         _counters(router)))
    assert results[1] == results[0]


def test_serving_smoke_tool_on_the_cpu():
    """``tools/serving_smoke.py --cpu``: the scheduler under preemption,
    the router over two prefix-cached replicas and speculative decoding,
    with the JAX smokes' token-equality checks (f32)."""
    from deepspeed_tpu_torch.tools import serving_smoke

    snap = {}
    snap.update(serving_smoke.run_smoke("cpu"))
    snap.update(serving_smoke.run_prefix_router_smoke("cpu"))
    snap.update(serving_smoke.run_speculative_smoke("cpu"))
    assert snap["router_warm_equal_share"] == 1.0
    assert snap["spec_equal_share"] == 1.0
    assert snap["preemptions"] >= 1
