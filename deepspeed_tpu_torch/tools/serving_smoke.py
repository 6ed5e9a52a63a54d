"""Serving smoke of the port: a small RaggedLlama behind the
continuous-batching scheduler and the cache-aware router (counterpart of
``tools/serving_smoke.py``'s ``run_smoke``, ``run_prefix_router_smoke`` and
``run_speculative_smoke``).

    python3 deepspeed_tpu_torch/tools/serving_smoke.py [--cpu]

On the card (the default) the model is ``LlamaConfig.tiny`` widened to
head_dim 64 in bf16, so the paged attention kernels serve it; with
``--cpu`` it is ``LlamaConfig.tiny`` in f32 on the plain paths.  Weights
are random from a seed.  Each smoke raises on a failure; the last line
printed is a JSON summary.

Greedy tokens of a warm (prefix-attached) or speculative run must equal
the cold / plain run's on the CPU, in f32, as the JAX smokes assert.  On
the card, in bf16, a near-tie can argmax differently between the batch
shapes of those runs, so there the share of equal tokens is reported
instead; every other check holds on both.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _model(device):
    """(config, params, exact): the geometry, random weights on
    ``device`` and whether greedy tokens are held equal."""
    import torch

    from deepspeed_tpu_torch.checkpoint import random_llama_params
    from deepspeed_tpu_torch.models import LlamaConfig

    if device == "cpu":
        cfg = LlamaConfig.tiny(dtype=torch.float32)
    else:
        cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                               dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, random_llama_params(cfg, device=device, generator=gen), \
        device == "cpu"


def _engine(cfg, params, device, block_size, max_context, num_blocks,
            prefix_cache=False):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)

    eng_cfg = RaggedInferenceEngineConfig.from_dict({
        "state_manager": {"max_ragged_batch_size": 32,
                          "max_ragged_sequence_count": 4,
                          "max_context": max_context},
        "kv_cache": {"block_size": block_size, "num_blocks": num_blocks,
                     "enable_prefix_cache": prefix_cache},
    })
    return InferenceEngineV2(RaggedLlama(cfg, block_size), params, eng_cfg,
                             device=device)


def _equal_share(got, want) -> float:
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
    return sum(int(a == b) for a, b in pairs) / max(len(pairs), 1)


def run_smoke(device="cuda", n_requests: int = 8, seed: int = 0) -> dict:
    """``n_requests`` Poisson arrivals through the scheduler with the KV
    pool sized to force preemption; returns the metrics snapshot."""
    import numpy as np

    from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler,
                                             SamplingParams)

    cfg, params, _ = _model(device)
    # 6 usable KV blocks of 8 tokens against 8 requests of ~14+8 tokens:
    # at most ~2 can be resident, so the scheduler must preempt
    engine = _engine(cfg, params, device, 8, 48, 7)
    sched = ContinuousBatchScheduler(engine)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).tolist()
               for n in rng.integers(8, 20, size=n_requests)]
    arrivals = np.cumsum(rng.exponential(0.02, size=n_requests))
    reqs = sched.run_with_arrivals(
        prompts, arrivals,
        sampling=SamplingParams(greedy=True, max_new_tokens=8))
    bad = [r for r in reqs if r.state.value != "finished"]
    assert not bad, [(r.uid, r.state.value, r.finish_reason) for r in bad]
    for r in reqs:
        assert len(r.generated) == 8, (r.uid, r.generated)
        assert r.ttft is not None and r.ttft >= 0
        assert r.queue_wait is not None
        assert r.tpot is not None and r.tpot >= 0
    snap = sched.metrics.snapshot()
    assert snap["finished"] == n_requests and snap["failed"] == 0, snap
    assert snap["p50_ttft_s"] > 0 and snap["p95_ttft_s"] > 0, snap
    assert snap["total_tokens"] == 8 * n_requests, snap
    assert snap["overall_tokens_per_s"] > 0, snap
    assert snap["preemptions"] >= 1, snap
    sm = engine.state_manager
    assert sm.n_tracked_sequences == 0
    assert sm.free_blocks == sm.allocator.num_blocks - 1
    return snap


def run_prefix_router_smoke(device="cuda", seed: int = 2) -> dict:
    """Prefix cache + cache-aware router: two replicas, two tenants with
    shared system prompts, interleaved submits.  Warm requests hit the
    radix cache, the router places a tenant's traffic on the replica that
    holds its prefix, and teardown releases every non-cached block."""
    import numpy as np

    from deepspeed_tpu_torch.serving import CacheAwareRouter, \
        ContinuousBatchScheduler, SamplingParams

    cfg, params, exact = _model(device)
    router = CacheAwareRouter([
        ContinuousBatchScheduler(_engine(cfg, params, device, 8, 48, 17,
                                         prefix_cache=True))
        for _ in range(2)])
    rng = np.random.default_rng(seed)
    pools = {t: rng.integers(0, cfg.vocab_size, size=(16,)).tolist()
             for t in ("t0", "t1")}
    sampling = SamplingParams(greedy=True, max_new_tokens=6)
    gold, reqs = {}, []
    for i in range(8):
        tenant = f"t{i % 2}"
        tail = rng.integers(0, cfg.vocab_size, size=(3,)).tolist()
        # identical per-tenant prompt: a warm run reads the cold run's KV
        prompt = pools[tenant] + (gold[tenant].prompt[16:19]
                                  if tenant in gold else tail)
        req = router.submit(prompt, tenant=tenant, sampling=sampling)
        gold.setdefault(tenant, req)
        reqs.append(req)
        router.step()
    router.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished", (r.uid, r.state, r.finish_reason)
    share = _equal_share([r.generated for r in reqs],
                         [gold[r.tenant].generated for r in reqs])
    if exact:
        assert share == 1.0, "a warm run diverged from its tenant's cold run"
    snap = router.snapshot()
    assert snap["cache_hit_routed"] >= 4, snap
    for tenant in pools:
        replicas = {r.replica for r in reqs[2:] if r.tenant == tenant}
        assert len(replicas) == 1, (tenant, replicas)
    assert len({r.uid for r in reqs}) == len(reqs)
    for rep in router.replicas:
        sm = rep.scheduler.engine.state_manager
        assert sm.n_tracked_sequences == 0
        assert sm.free_blocks == sm.allocator.num_blocks - 1
    hits = sum(rep.scheduler.engine.state_manager.prefix_cache.stats.hits
               for rep in router.replicas)
    assert hits >= 6, hits
    return {"router_smoke": "ok", "router_cache_hits": hits,
            "router_hit_routed": int(snap["cache_hit_routed"]),
            "router_warm_equal_share": share}


def run_speculative_smoke(device="cuda", seed: int = 0) -> dict:
    """Repetitive prompts through a plain scheduler and a speculative one
    (n-gram self-drafter, K=3 drafts): drafts are proposed and accepted,
    the delivered-token accounting sees more than one token a decode tick,
    and rejected lookahead leaves the allocator as the plain run's."""
    import numpy as np

    from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler,
                                             SamplingParams,
                                             SpeculativeConfig)

    cfg, params, exact = _model(device)

    def make_sched(spec=None):
        return ContinuousBatchScheduler(
            _engine(cfg, params, device, 8, 64, 33), speculative=spec)

    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, size=(6,)).tolist()
    prompts = [base * 3 + rng.integers(0, cfg.vocab_size,
                                       size=(2,)).tolist()
               for _ in range(3)]
    sampling = SamplingParams(greedy=True, max_new_tokens=12)
    s0 = make_sched()
    gold = [s0.submit(p, sampling=sampling) for p in prompts]
    s0.run_until_idle()
    s1 = make_sched(SpeculativeConfig(draft_k=3))
    reqs = [s1.submit(p, sampling=sampling) for p in prompts]
    s1.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished", (r.uid, r.state, r.finish_reason)
    share = _equal_share([r.generated for r in reqs],
                         [g.generated for g in gold])
    if exact:
        assert share == 1.0, "speculative output diverged"
    st = s1.spec_stats
    assert st.ticks >= 1 and st.drafted >= 1, st.as_dict()
    assert st.accepted >= 1, st.as_dict()
    snap = s1.metrics.snapshot()
    assert snap["tokens_per_request_tick"] > 1.0, snap
    assert s0.metrics.snapshot()["tokens_per_request_tick"] == 1.0
    assert snap["tpot_delivered_s"] > 0, snap
    sm0, sm1 = s0.engine.state_manager, s1.engine.state_manager
    assert sm1.n_tracked_sequences == 0
    assert sm1.free_blocks == sm0.free_blocks == \
        sm1.allocator.num_blocks - 1
    return {"speculative_smoke": "ok",
            "spec_accept_rate": round(st.accept_rate, 4),
            "spec_tokens_per_pass": round(st.tokens_per_pass, 3),
            "spec_ticks": st.ticks, "spec_equal_share": share}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (f32, plain paths)")
    args = p.parse_args(argv)
    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no GPU (torch.cuda.is_available() is False); pass --cpu",
              file=sys.stderr)
        return 1
    t0 = time.monotonic()
    snap = run_smoke(device)
    snap.update(run_prefix_router_smoke(device))
    snap.update(run_speculative_smoke(device))
    snap["wall_s"] = round(time.monotonic() - t0, 2)
    snap["device"] = device
    print(json.dumps({"serving_smoke": "ok", **snap}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
