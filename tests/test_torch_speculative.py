"""Speculative verify in the port against the JAX package on the CPU.

* the plain verify version (the wrapper's CPU path) against JAX
  ``paged_verify_attention(..., interpret=True)``: window None and 24, D 64
  and 128, f32 pools and int8 pools with scales, two slots sharing a block:
  f32, <= 2e-5;
* the engine (``LlamaConfig.tiny``, block 8, f32 activations, the JAX
  weights carried across with ``params_from_jax``), with an f32 and an int8
  pool: ``verify_step`` logits against the JAX engine's <= 2e-5, with two
  sequences sharing prefix blocks; verify rows against sequential
  ``decode_step`` rows <= 2e-5; ``commit_verified`` allocator counts equal
  to the JAX engine's after reject, partial and full accept; the input
  checks with the same messages;
* an engine-level greedy speculative loop (n-gram drafts → ``verify_step``
  → ``accept_drafts`` → ``commit_verified``) gives the tokens of
  ``decode_loop`` and of the same loop on the JAX engine;
* the drafters and ``accept_drafts`` give the JAX package's outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2 import speculative as jspec
from deepspeed_tpu.inference.v2.kernels import blocked_flash as jbf
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2 import speculative as tspec
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import quantize_kv
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig

TOL = 2e-5                  # f32 on both sides, different summation orders
BS = 8
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = TLlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, JLlamaForCausalLM(JCFG).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))["params"])


def _cfg(kv_dtype, prefix_cache=False, num_blocks=33, max_context=64):
    return {"state_manager": {"max_ragged_batch_size": 32,
                              "max_ragged_sequence_count": 4,
                              "max_context": max_context},
            "kv_cache": {"block_size": BS, "num_blocks": num_blocks,
                         "dtype": kv_dtype,
                         "enable_prefix_cache": prefix_cache}}


def _port(jparams, kv_dtype="f32", **kw):
    return TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                   TConfig.from_dict(_cfg(kv_dtype, **kw)), device="cpu")


def _jax(jparams, kv_dtype="f32", **kw):
    return JEngine(JRaggedLlama(JCFG, BS), jparams,
                   JConfig.from_dict(_cfg(kv_dtype, **kw)))


def _prompts(n=3, seed=0, rep=3):
    """Prompts with a repeated phrase so the n-gram drafter has bite (the
    JAX package's speculative tests use the same recipe)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(6,)).tolist()
    return [base * rep + rng.integers(0, 256, size=(2,)).tolist()
            for _ in range(n)]


# --------------------------------------------------------------------- #
# The verify function against the JAX package's verify kernel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("window", [None, 24])
def test_plain_verify_matches_jax_kernel(window, head_dim, int8):
    rng = np.random.default_rng(3)
    bs, S, B, K, H, Hkv = 16, 3, 6, 4, 8, 2
    kf, vf = (rng.standard_normal(((S * B + 1) * bs, Hkv, head_dim))
              .astype(np.float32) for _ in range(2))
    tables = rng.permutation(np.arange(1, S * B + 1, dtype=np.int32)
                             ).reshape(S, B)
    tables[1, 0] = tables[0, 0]             # slots 0 and 1 share a block
    pos0 = np.asarray([37, 5, 61], np.int32)
    slot = np.repeat(np.arange(S, dtype=np.int32), K)
    pos = (pos0[:, None] + np.arange(K, dtype=np.int32)[None, :]).reshape(-1)
    q = rng.standard_normal((S * K, H, head_dim)).astype(np.float32)
    scales = {}
    if int8:
        (kf, ks), (vf, vs) = (
            (t.numpy() for t in quantize_kv(torch.from_numpy(a)))
            for a in (kf, vf))
        scales = {"k_scale": ks, "v_scale": vs}
    arrs = (q, kf, vf, tables, slot, pos)
    want = np.asarray(jbf.paged_verify_attention(
        *map(jnp.asarray, arrs), block_size=bs, k_tokens=K, window=window,
        interpret=True, **{k: jnp.asarray(v) for k, v in scales.items()}))
    launches = dict(tbf.LAUNCHES)
    got = tbf.paged_verify_attention(
        *map(torch.from_numpy, arrs), block_size=bs, k_tokens=K,
        window=window, **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert tbf.LAUNCHES == launches          # CPU tensors: plain version
    assert np.abs(got.numpy() - want).max() <= TOL
    # verify computes the generic kernel's function (one plain version)
    generic = tbf.paged_attention(
        *map(torch.from_numpy, arrs), block_size=bs, window=window,
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert torch.equal(got, generic)


def test_verify_wrapper_checks_rows():
    q = torch.zeros((7, 4, 64))
    pool = torch.zeros((32, 2, 64))
    idx = torch.zeros((7,), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole number"):
        tbf.paged_verify_attention(q, pool, pool, torch.zeros((1, 2),
                                                              dtype=torch.int32),
                                   idx, idx, block_size=16, k_tokens=2)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tbf.paged_attention(q, pool, pool, torch.zeros((1, 2),
                                                       dtype=torch.int32),
                            idx, idx, block_size=16, k_scale=pool[:, :, 0])


# --------------------------------------------------------------------- #
# The engine: verify_step against the JAX engine and sequential decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_verify_step_matches_jax_engine(jparams, kv_dtype):
    """Two sequences share two full prefix blocks (both live), a third is
    unrelated; one verify pass at K=4 over all three, a fourth slot
    padding: logits <= 2e-5, argmax tokens equal, pad rows finite."""
    a = np.random.default_rng(1).integers(0, 256, 2 * BS + 3).tolist()
    prompts = [a, a[:2 * BS] + [5, 6, 7], _prompts(1, seed=2)[0]]
    feeds = [[3, 4, 5, 6], [9, 9, 9, 9], [1, 2, 3, 4]]
    out = {}
    for side, eng in (("port", _port(jparams, kv_dtype, prefix_cache=True)),
                      ("jax", _jax(jparams, kv_dtype, prefix_cache=True))):
        for uid, p in enumerate(prompts):
            eng.put([uid], [p])
        assert eng.prefix_cache_stats.hit_tokens == 2 * BS
        logits, nxt = eng.verify_step([0, 1, 2], feeds, greedy=True)
        out[side] = (np.asarray(logits), np.asarray(nxt))
        assert out[side][0].shape == (4, 4, 256)
        for u in (0, 1, 2):
            eng.commit_verified(u, feeds[u][:2])
        out[side] += (eng.state_manager.free_blocks,
                      [eng.query(u)["seen_tokens"] for u in (0, 1, 2)])
    (tl, tn, tf, ts), (jl, jn, jf, js) = out["port"], out["jax"]
    assert np.abs(tl[:3] - jl[:3]).max() <= TOL
    np.testing.assert_array_equal(tn[:3], jn[:3])
    assert np.isfinite(tl).all()
    assert (tf, ts) == (jf, js)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_verify_step_matches_sequential_decode(jparams, kv_dtype):
    prompt = _prompts(1)[0]
    eng = _port(jparams, kv_dtype)
    toks = [int(np.argmax(eng.put([0], [prompt])[0]))]
    seq_logits = []
    for _ in range(3):
        logits = eng.decode_step([0], [toks[-1]])[0].numpy()
        seq_logits.append(logits)
        toks.append(int(np.argmax(logits)))
    eng2 = _port(jparams, kv_dtype)
    assert int(np.argmax(eng2.put([0], [prompt])[0])) == toks[0]
    rows = eng2.verify_step([0], [toks[:3]])[0].numpy()
    for k in range(3):
        assert np.argmax(rows[k]) == np.argmax(seq_logits[k])
        assert np.abs(rows[k] - seq_logits[k]).max() <= TOL


def test_commit_verified_allocator_counts_match_jax(jparams):
    """Reject (only the fed token), then full accept, then partial accept:
    block counts, free blocks and refcounts equal the JAX engine's at every
    step, and all blocks come back after flush."""
    prompt = _prompts(1)[0][:13]             # seen 13 after the prefill
    steps = [([1, 2, 3, 4], [1]), ([5, 6, 7, 8], [5, 6, 7, 8]),
             ([2, 3, 4, 5], [2, 3])]
    seen = {}
    for side, eng in (("port", _port(jparams)), ("jax", _jax(jparams))):
        sm = eng.state_manager
        eng.put([0], [prompt])
        trace = [(len(sm.get_sequence(0).blocks), sm.free_blocks)]
        for feed, acc in steps:
            eng.verify_step([0], [feed])
            trace.append((len(sm.get_sequence(0).blocks), sm.free_blocks))
            eng.commit_verified(0, acc)
            seq = sm.get_sequence(0)
            trace.append((len(seq.blocks), sm.free_blocks, seq.seen_tokens,
                          dict(sm.allocator._refs)))
        eng.flush([0])
        trace.append(sm.free_blocks == sm.allocator.num_blocks - 1)
        seen[side] = trace
    assert seen["port"] == seen["jax"]
    # the first pass spilled into a third block and rolled it back
    assert seen["port"][1][0] == 3 and seen["port"][2][0] == 2
    assert seen["port"][-1] is True


def test_verify_step_validates_inputs(jparams):
    for eng in (_port(jparams), _jax(jparams)):
        eng.put([0], [_prompts(1)[0]])
        with pytest.raises(ValueError, match="share one draft length"):
            eng.verify_step([0, 1], [[1, 2], [1]])
        with pytest.raises(ValueError, match="token rows"):
            eng.verify_step([0], [[1], [2]])
        with pytest.raises(RuntimeError, match="missing or has pending"):
            eng.verify_step([99], [[1, 2]])
        with pytest.raises(RuntimeError, match="max_context"):
            eng.verify_step([0], [[0] * 60])
        with pytest.raises(ValueError, match="at least the fed input"):
            eng.commit_verified(0, [])
        with pytest.raises(ValueError, match="unknown sequence"):
            eng.commit_verified(7, [1])
        eng.flush([0])


# --------------------------------------------------------------------- #
# A greedy speculative loop, end to end
# --------------------------------------------------------------------- #
def _speculative_greedy(eng, spec, uids, prompts, n_new, draft_k=3):
    """draft → verify_step(greedy) → accept_drafts → commit_verified, one
    verify pass a round for every live sequence.  Returns the generated
    tokens per uid and the stats."""
    drafter = spec.NgramDrafter()
    stats = spec.SpeculativeStats()
    first = eng.put(uids, prompts)
    hist = {u: list(p) for u, p in zip(uids, prompts)}
    gen = {u: [int(np.argmax(np.asarray(first[u])))] for u in uids}
    while any(len(gen[u]) < n_new for u in uids):
        live = [u for u in uids if len(gen[u]) < n_new]
        feeds, drafts = [], []
        for u in live:
            d = drafter.draft(hist[u] + gen[u], draft_k)
            d = (d + [0] * draft_k)[:draft_k]          # one K for the pass
            drafts.append(d)
            feeds.append([gen[u][-1]] + d)
        _, nxt = eng.verify_step(live, feeds, greedy=True)
        nxt = np.asarray(nxt)
        stats.ticks += 1
        for i, u in enumerate(live):
            emitted, acc = spec.accept_drafts(nxt[i].tolist(), drafts[i])
            stats.drafted += len(drafts[i])
            stats.accepted += acc
            stats.emitted += len(emitted)
            eng.commit_verified(u, feeds[i][:acc + 1])
            gen[u].extend(emitted)
    eng.flush(uids)
    return {u: gen[u][:n_new] for u in uids}, stats


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_greedy_speculative_loop_matches_decode_loop_and_jax(jparams,
                                                             kv_dtype):
    uids, n_new = [0, 1, 2], 12
    prompts = _prompts()
    gold_eng = _port(jparams, kv_dtype)
    first = gold_eng.put(uids, prompts)
    start = [int(np.argmax(first[u])) for u in uids]
    gold = gold_eng.decode_loop(uids, start, n_new - 1)
    gold_eng.flush(uids)
    port_eng = _port(jparams, kv_dtype)
    got, stats = _speculative_greedy(port_eng, tspec, uids, prompts, n_new)
    jgot, jstats = _speculative_greedy(_jax(jparams, kv_dtype), jspec, uids,
                                       prompts, n_new)
    for i, u in enumerate(uids):
        assert got[u] == [start[i]] + gold[i].tolist()
        assert jgot[u] == got[u]
    assert stats.as_dict() == jstats.as_dict()
    assert stats.accepted >= 1 and stats.emitted >= stats.ticks
    sm = port_eng.state_manager
    assert sm.free_blocks == gold_eng.state_manager.free_blocks
    assert not sm.allocator._refs


# --------------------------------------------------------------------- #
# Drafters and the acceptance rule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("history,k,kw", [
    ([5, 9, 7, 1, 2, 5, 9, 7], 3, {}),
    ([5, 9, 7, 1, 2, 5, 9, 7], 1, {}),
    ([1, 2, 3, 4], 4, {}),
    ([1], 4, {}),
    ([5, 9, 7, 1, 2, 5, 9, 7], 0, {}),
    ([3, 8, 3, 4, 3], 2, {"max_ngram": 2}),
    (list(np.random.default_rng(4).integers(0, 6, 300)), 5,
     {"max_ngram": 4, "min_ngram": 2, "max_history": 64}),
])
def test_ngram_drafter_matches_jax(history, k, kw):
    assert (tspec.NgramDrafter(**kw).draft(history, k)
            == jspec.NgramDrafter(**kw).draft(history, k))


def test_drafters_and_acceptance_rule_match_jax(jparams):
    def propose(history, k):
        return [history[-1]] * (k + 3)

    for hist, k in (([4, 5], 2), ([7], 0)):
        assert (tspec.SmallModelDrafter(propose).draft(hist, k)
                == jspec.SmallModelDrafter(propose).draft(hist, k))
    for cand, drafts in (([7, 8, 9], [7, 8]), ([7, 5, 9], [7, 8]),
                         ([4, 5, 9], [7, 8]), ([3], [])):
        assert tspec.accept_drafts(cand, drafts) \
            == jspec.accept_drafts(cand, drafts)
    for bad in ({"draft_k": 0}, {"min_draft_k": 5},
                {"accept_ewma_alpha": 0.0},
                {"shrink_threshold": 0.9, "grow_threshold": 0.1}):
        with pytest.raises(ValueError):
            tspec.SpeculativeConfig(**bad)
        with pytest.raises(ValueError):
            jspec.SpeculativeConfig(**bad)
    assert isinstance(tspec.SpeculativeConfig().drafter, tspec.NgramDrafter)
    with pytest.raises(NotImplementedError):
        tspec.Drafter().draft([1], 1)


def test_prefix_cache_drafter_matches_jax(jparams):
    """A finished request leaves its prompt and greedy continuation in the
    radix tree; a second request's history along that path is drafted from
    the tree in both packages, a diverged one falls back to n-gram."""
    prompt = _prompts(1)[0]
    drafts = {}
    for side, eng, spec in (
            ("port", _port(jparams, prefix_cache=True), tspec),
            ("jax", _jax(jparams, prefix_cache=True), jspec)):
        first = eng.put([0], [prompt])
        toks = eng.decode_loop([0], [int(np.argmax(np.asarray(first[0])))],
                               12)
        full = prompt + [int(np.argmax(np.asarray(first[0])))] \
            + np.asarray(toks)[0].tolist()
        eng.flush([0])
        drafter = spec.PrefixCacheDrafter(eng.state_manager)
        assert isinstance(spec.make_self_drafter(eng),
                          spec.PrefixCacheDrafter)
        cut = BS + 3
        drafts[side] = [drafter.draft(full[:cut], 4),
                        drafter.draft(full[:2 * BS], 3),
                        drafter.draft([255, 1, 2], 4),
                        eng.state_manager.prefix_cache.match_len(full),
                        full]
        assert drafts[side][0] == full[cut:cut + 4]
    assert drafts["port"] == drafts["jax"]
    assert isinstance(tspec.make_self_drafter(_port(jparams)),
                      tspec.NgramDrafter)
