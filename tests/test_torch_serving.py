"""The port's continuous-batching scheduler against the JAX package's, on the
CPU.

Both schedulers drive an engine over ``LlamaConfig.tiny`` in f32 with the
same weights (``params_from_jax``) and the same requests, submitted at the
same ticks; every tick's emitted ``(uid, token)`` pairs, the running set
after it, and each request's tokens, state, finish reason and preemption
count must be equal:

* greedy and seeded top-k requests through KV-pressure preemption and
  recompute resume (a 7-block pool), with the allocator back to its size;
* the exact token budget and the max-seqs boundary of admission;
* deadlines, shutdown (drain and expiry) and the bounded queue;
* fast-decode and speculative (n-gram draft + verify) ticks;
* handoff: ``extract_for_handoff`` then ``resubmit`` on a second
  scheduler, by recompute and with the KV carried.

Also: ``sample_batch`` bit-equal to JAX's, the request state machine and
snapshot round trip, and ``telemetry()`` / registry keys equal to JAX's.
"""

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
from deepspeed_tpu.inference.v2.speculative import NgramDrafter as JNgram
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu.observability.registry import MetricsRegistry as JRegistry
from deepspeed_tpu_torch import serving as tserving
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.inference.v2.speculative import NgramDrafter
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig
from deepspeed_tpu_torch.observability.registry import (
    MetricsRegistry as TRegistry)

from torch_port_common import single_process_env  # noqa: F401 (autouse)

BS = 8
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = TLlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, JLlamaForCausalLM(JCFG).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))["params"])


def _cfg(token_budget=32, max_seqs=4, max_context=48, num_blocks=None,
         prefix_cache=False):
    kv = {"block_size": BS, "enable_prefix_cache": prefix_cache}
    if num_blocks is not None:
        kv["num_blocks"] = num_blocks
    return {"state_manager": {"max_ragged_batch_size": token_budget,
                              "max_ragged_sequence_count": max_seqs,
                              "max_context": max_context},
            "kv_cache": kv}


def _pair(jparams, **kw):
    """(JAX engine, port engine) of one geometry over the same weights."""
    cfg = _cfg(**kw)
    return (JEngine(JRaggedLlama(JCFG, BS), jparams, JConfig.from_dict(cfg)),
            TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                    TConfig.from_dict(cfg), device="cpu"))


def _prompts(n, seed, lo=6, hi=16, rep=None):
    rng = np.random.default_rng(seed)
    if rep is not None:          # a repeated phrase: the n-gram drafter bites
        base = rng.integers(0, 256, size=(6,)).tolist()
        return [base * rep + rng.integers(0, 256, size=(2,)).tolist()
                for _ in range(n)]
    return [rng.integers(0, 256, size=(int(m),)).tolist()
            for m in rng.integers(lo, hi, size=n)]


def _sampling(pkg, i, n_new, mixed=True):
    """Even requests greedy, odd ones seeded top-k."""
    if mixed and i % 2:
        return pkg.SamplingParams(greedy=False, temperature=0.8, top_k=20,
                                  seed=1234, max_new_tokens=n_new)
    return pkg.SamplingParams(max_new_tokens=n_new)


def _drive(pkg, sched, prompts, arrivals, n_new, mixed=True, **submit_kw):
    """Submit ``prompts[i]`` at tick ``arrivals[i]`` and step to idle.
    Returns (requests, per-tick trace of emitted pairs and running uids)."""
    reqs, trace, tick = [], [], 0
    while len(reqs) < len(prompts) or sched.num_pending:
        while len(reqs) < len(prompts) and arrivals[len(reqs)] <= tick:
            i = len(reqs)
            reqs.append(sched.submit(prompts[i], uid=100 + i,
                                     sampling=_sampling(pkg, i, n_new, mixed),
                                     **submit_kw))
        out = sched.step()
        trace.append(([(r.uid, t) for r, t in out], sorted(sched.running_uids)))
        tick += 1
        assert tick < 2000, "scheduler failed to converge"
    return reqs, trace


def _summary(reqs):
    return [(r.uid, r.generated, r.state.value, r.finish_reason,
             r.preemptions) for r in reqs]


def _assert_same_run(j, t):
    (jr, jtrace), (tr, ttrace) = j, t
    assert _summary(tr) == _summary(jr)
    assert ttrace == jtrace


@pytest.mark.parametrize("mixed", [False, True], ids=["greedy", "seeded"])
def test_preemption_and_resume_match_jax(jparams, mixed):
    # 6 usable blocks of 8 tokens against 8 requests needing up to 3 each:
    # concurrency is KV-bound, so preemption must occur
    prompts = _prompts(8, seed=7)
    arrivals = np.floor(np.cumsum(np.random.default_rng(7).exponential(
        1.2, size=8))).astype(int)
    je, te = _pair(jparams, num_blocks=7)
    js = jserving.ContinuousBatchScheduler(je)
    ts = tserving.ContinuousBatchScheduler(te)
    j = _drive(jserving, js, prompts, arrivals, 8, mixed)
    t = _drive(tserving, ts, prompts, arrivals, 8, mixed)
    _assert_same_run(j, t)
    assert ts.metrics.preemptions == js.metrics.preemptions >= 1
    assert ts.fast_ticks == js.fast_ticks > 0
    assert all(r.state is tserving.RequestState.FINISHED for r in t[0])
    sm = te.state_manager
    assert sm.n_tracked_sequences == 0
    assert sm.free_blocks == sm.allocator.num_blocks - 1


@pytest.mark.parametrize("case", ["token_budget", "max_seqs"])
def test_admission_boundaries_match_jax(jparams, case):
    if case == "token_budget":    # prompts of 16 + 16 fill the budget of 32
        kw, prompts = dict(token_budget=32), _prompts(4, 3, lo=16, hi=17)
    else:                         # 5 short requests over 2 sequence slots
        kw, prompts = dict(max_seqs=2), _prompts(5, 4, lo=4, hi=8)
    je, te = _pair(jparams, **kw)
    arrivals = [0] * len(prompts)
    j = _drive(jserving, jserving.ContinuousBatchScheduler(je), prompts,
               arrivals, 4)
    t = _drive(tserving, tserving.ContinuousBatchScheduler(te), prompts,
               arrivals, 4)
    _assert_same_run(j, t)
    if case == "max_seqs":
        assert max(len(run) for _, run in t[1]) == 2


def test_deadline_shutdown_and_queue_bound_match_jax(jparams):
    results = []
    for pkg, eng in zip((jserving, tserving), _pair(jparams)):
        sched = pkg.ContinuousBatchScheduler(eng, max_queue=3)
        prompts = _prompts(4, 5)
        reqs = [sched.submit(prompts[0], uid=1, deadline_s=1e-9,
                             sampling=pkg.SamplingParams(max_new_tokens=4))]
        reqs += [sched.submit(p, uid=2 + i,
                              sampling=pkg.SamplingParams(max_new_tokens=4))
                 for i, p in enumerate(prompts[1:3])]
        with pytest.raises(pkg.QueueFullError):
            sched.submit(prompts[3], uid=9)
        sched.step()                          # fails uid 1, packs 2 and 3
        sched.step()
        idle = sched.shutdown(drain_deadline=0.0)   # expiry: fail the rest
        with pytest.raises(RuntimeError, match="shutting down"):
            sched.submit(prompts[3], uid=10)
        results.append((_summary(reqs), idle, sched.metrics.snapshot()[
            "deadline_exceeded"], sched.metrics.snapshot()["shutdown_failed"],
            eng.state_manager.n_tracked_sequences))
    assert results[1] == results[0]
    assert results[1][0][0][3] == "deadline"
    assert results[1][0][1][3] == "shutdown"
    # a drain that completes returns True and drops nothing
    for pkg, eng in zip((jserving, tserving), _pair(jparams)):
        sched = pkg.ContinuousBatchScheduler(eng)
        r = sched.submit(_prompts(1, 6)[0], uid=1,
                         sampling=pkg.SamplingParams(max_new_tokens=3))
        assert sched.shutdown(drain_deadline=60.0) is True
        assert r.state.value == "finished" and len(r.generated) == 3


@pytest.mark.parametrize("mixed", [False, True], ids=["greedy", "seeded"])
def test_speculative_ticks_match_jax(jparams, mixed):
    prompts = _prompts(3, seed=0, rep=3)
    je, te = _pair(jparams, max_context=64)
    js = jserving.ContinuousBatchScheduler(
        je, speculative=jserving.SpeculativeConfig(
            draft_k=3, drafter=JNgram(max_ngram=3)))
    ts = tserving.ContinuousBatchScheduler(
        te, speculative=tserving.SpeculativeConfig(
            draft_k=3, drafter=NgramDrafter(max_ngram=3)))
    j = _drive(jserving, js, prompts, [0, 0, 1], 12, mixed)
    t = _drive(tserving, ts, prompts, [0, 0, 1], 12, mixed)
    _assert_same_run(j, t)
    assert ts.spec_stats.as_dict() == js.spec_stats.as_dict()
    assert ts.spec_stats.ticks > 0 and ts.spec_stats.accepted > 0
    # and the tokens are sequential decode's
    plain = _drive(tserving, tserving.ContinuousBatchScheduler(_pair(
        jparams, max_context=64)[1]), prompts, [0, 0, 1], 12, mixed)
    assert [r.generated for r in plain[0]] == [r.generated for r in t[0]]


@pytest.mark.parametrize("include_kv", [False, True], ids=["recompute", "kv"])
def test_handoff_matches_jax(jparams, include_kv):
    prompts = _prompts(2, seed=9)
    got = []
    engines = [_pair(jparams), _pair(jparams)]
    for side, pkg in enumerate((jserving, tserving)):
        src = pkg.ContinuousBatchScheduler(engines[0][side])
        dst = pkg.ContinuousBatchScheduler(engines[1][side])
        reqs = [src.submit(p, uid=40 + i, sampling=_sampling(pkg, i, 6))
                for i, p in enumerate(prompts)]
        for _ in range(4):
            src.step()
        snap, kv = src.extract_for_handoff(40, include_kv=include_kv)
        moved = dst.resubmit(snap, kv_state=kv)
        src.run_until_idle()
        dst.run_until_idle()
        got.append((reqs[0].state.value, snap.generated, snap.fed_tokens,
                    moved.generated, reqs[1].generated,
                    src.metrics.snapshot()["handoffs"]))
    assert got[1] == got[0]
    assert got[1][0] == "handed_off" and len(got[1][3]) == 6
    assert (got[1][2] > 0) == include_kv


def test_sample_batch_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 97)).astype(np.float32) * 3
    cfgs = [dict(), dict(greedy=False, temperature=0.7, top_k=5, seed=3),
            dict(greedy=False, temperature=1.3, seed=11),
            dict(greedy=False, top_k=1, seed=0), dict(),
            dict(greedy=False, temperature=0.5, top_k=50, seed=3)]
    pos, uids = [0, 3, 7, 1, 2, 9], [5, 5, 6, 7, 8, 9]
    for trial in range(3):
        want = jserving.sample_batch(
            logits, [jserving.SamplingParams(**c) for c in cfgs],
            [p + trial for p in pos], uids)
        got = tserving.sample_batch(
            logits, [tserving.SamplingParams(**c) for c in cfgs],
            [p + trial for p in pos], uids)
        assert got.dtype == want.dtype and (got == want).all()
    assert tserving.sample_one(logits[1], tserving.SamplingParams(
        **cfgs[1]), 4, 5) == jserving.sample_one(
        logits[1], jserving.SamplingParams(**cfgs[1]), 4, 5)


def test_request_state_machine_and_snapshot_match_jax():
    for pkg in (jserving, tserving):
        r = pkg.Request(uid=1, prompt=[1, 2, 3])
        for s in ("prefill", "decode", "preempted", "prefill", "decode",
                  "finished"):
            r.transition(pkg.RequestState(s))
        with pytest.raises(RuntimeError, match="illegal transition"):
            r.transition(pkg.RequestState.DECODE)
        with pytest.raises(ValueError):
            pkg.Request(uid=2, prompt=[])
    assert [s.value for s in tserving.RequestState] == \
        [s.value for s in jserving.RequestState]
    t = tserving.Request(uid=7, prompt=[4, 5], sampling=tserving.SamplingParams(
        greedy=False, seed=9, stop_token_ids=(3,)), priority=2, deadline_s=5.0)
    t.generated = [8, 9]
    js = jserving.RequestSnapshot.from_json(t.snapshot(fed_tokens=3).to_json())
    back = tserving.RequestSnapshot.from_json(js.to_json()).to_request()
    assert (back.uid, back.history, back.priority, back.sampling) == (
        7, [4, 5, 8, 9], 2, t.sampling)


def test_telemetry_and_registry_keys_match_jax(jparams):
    prompts = _prompts(3, seed=2)
    keys = []
    for side, (pkg, reg_cls) in enumerate(((jserving, JRegistry),
                                           (tserving, TRegistry))):
        eng = _pair(jparams, prefix_cache=True)[side]
        reg = reg_cls()
        sched = pkg.ContinuousBatchScheduler(
            eng, registry=reg, speculative=pkg.SpeculativeConfig(
                draft_k=2, drafter=(JNgram if side == 0 else NgramDrafter)()))
        for i, p in enumerate(prompts):
            sched.submit(p, uid=i + 1,
                         sampling=pkg.SamplingParams(max_new_tokens=4))
        sched.run_until_idle()
        snap = reg.snapshot()
        keys.append((sorted(sched.telemetry()), sorted(snap),
                     sorted(reg.unknown_names),
                     {k: v for k, v in snap.items()
                      if k.startswith("observability/kv_")}))
    assert keys[1] == keys[0]
    assert not keys[1][2]


def test_serving_exports_jax_names_but_the_routers():
    """Every JAX serving name is exported, the router's six included (the
    name dates from before the router was ported)."""
    assert set(tserving.__all__) == set(jserving.__all__)
    for name in tserving.__all__:
        assert getattr(tserving, name).__name__ == getattr(
            jserving, name).__name__
