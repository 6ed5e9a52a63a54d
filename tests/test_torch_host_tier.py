"""The port's host cold KV tier against the JAX package's on the CPU.

* ``HostKVTier``: the byte budget (oldest entries drop first), ``get`` pops,
  and its counters and ``as_dict`` keys equal JAX's on the same puts;
* the engine over an int8 pool with ``kv_cache.host_tier``
  (``LlamaConfig.tiny``, block 8, f32 activations, the JAX weights carried
  across with ``params_from_jax``), driven by the same operations as the
  JAX engine:

  - a spool -> restore round trip is bit-exact (``gather_blocks`` of the
    restored blocks equals the pre-eviction gather), one ``gather_blocks``
    call a spool and one ``scatter_blocks`` call a restore (counted as in
    JAX ``test_kv_quant_tier.py:588``);
  - the continuation after a restore equals a never-evicted run bitwise,
    and the JAX engine's within the int8 parity bar (2e-5);
  - the tier and occupancy counters and the occupancy keys equal JAX's;
  - a restore under a full pool never recycles the match;
  - a tier miss (a 1-byte budget) recomputes: the logits agree with the
    JAX engine's computed logits on the same operations (2e-5) — not with
    the JAX assertion that a miss is bit-equal to a fresh engine, which is
    red in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.inference.v2.ragged import HostKVTier as JTier
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.inference.v2.ragged import HostKVTier as TTier
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkv
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig

TOL = 2e-5                  # f32 on both sides, different summation orders
BS = 8
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = TLlamaConfig.tiny(dtype=torch.float32)


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


def _cfg(host_tier=True, num_blocks=10, host_tier_bytes=None,
         kv_dtype="int8"):
    kv = {"block_size": BS, "dtype": kv_dtype, "enable_prefix_cache": True,
          "host_tier": host_tier, "num_blocks": num_blocks}
    if host_tier_bytes is not None:
        kv["host_tier_bytes"] = host_tier_bytes
    return {"state_manager": {"max_ragged_batch_size": 64,
                              "max_ragged_sequence_count": 4,
                              "max_context": 64}, "kv_cache": kv}


def _tengine(jparams, **kw):
    return TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                   TConfig.from_dict(_cfg(**kw)), device="cpu")


def _jengine(jparams, **kw):
    return JEngine(JRaggedLlama(JCFG, BS), jparams,
                   JConfig.from_dict(_cfg(**kw)))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _grow_session(eng, uid, prompt, n_new):
    """``put`` the prompt and feed ``n_new - 1`` greedy tokens back."""
    logits = eng.put([uid], [prompt])
    toks = [int(np.argmax(np.asarray(logits[uid])))]
    for _ in range(n_new - 1):
        logits = eng.put([uid], [[toks[-1]]])
        toks.append(int(np.argmax(np.asarray(logits[uid]))))
    return prompt + toks


def _pressure(eng, seeds):
    """Two 32-token sessions, put and flushed: under a 10-block pool they
    evict the idle session's warm blocks."""
    for uid, seed in zip((2, 3), seeds):
        eng.put([uid], [_prompt(seed, 32)])
        eng.flush([uid])


def _leaves(tree):
    return [np.asarray(tree[l][k]) for l in sorted(tree)
            for k in sorted(tree[l])]


# --------------------------------------------------------------------- #
# The tier itself
# --------------------------------------------------------------------- #
def test_tier_budget_and_stats_match_jax():
    """The same puts (a re-put, a put-back, drops past the budget) and gets
    on both tiers: bytes, length, hits, drop order and stats equal."""
    results = []
    for tier, leaf in ((JTier(max_bytes=100), lambda n: np.zeros(n, np.int8)),
                       (TTier(max_bytes=100),
                        lambda n: torch.zeros(n, dtype=torch.int8))):
        trace = []
        for key, n, spool in (((1,), 40, True), ((2,), 40, True),
                              ((3,), 40, True), ((2,), 30, True),
                              ((4,), 20, False), ((5,), 90, True)):
            tier.put(key, {"layer_0": {"k": leaf(n)}}, count_spool=spool)
            trace.append((tier.bytes, len(tier), key in tier))
        trace.append([tier.get(k) is not None for k in ((1,), (2,), (5,))])
        trace.append((tier.bytes, len(tier), tier.clear(), tier.bytes))
        st = tier.stats
        st.spool_s.extend([0.1, 0.3, 0.2])
        st.restore_blocks_per_call.extend([3, 1])
        results.append((trace, st.as_dict()))
    assert results[1] == results[0]


def test_tier_config_checks():
    with pytest.raises(ValueError, match="enable_prefix_cache"):
        TEngine(TRaggedLlama(TCFG, BS), {}, TConfig.from_dict(
            {"kv_cache": {"block_size": BS, "host_tier": True}}),
            device="cpu")


def test_gather_blocks_is_one_host_buffer():
    """``gather_blocks`` copies every leaf of every layer into one host
    buffer: one storage for the whole payload, each leaf equal to its
    rows of the pool."""
    c = tkv.BlockedKVCache(3, 6, 4, 2, 8, dtype="int8")
    gen = torch.Generator().manual_seed(0)
    for layer in c.cache.values():
        for pool in layer.values():
            pool.copy_(torch.randint(-100, 100, pool.shape, generator=gen)
                       .to(pool.dtype))
    payload = c.gather_blocks([4, 1])
    storages = {t.untyped_storage().data_ptr()
                for layer in payload.values() for t in layer.values()}
    assert len(storages) == 1
    rows = torch.tensor([16, 17, 18, 19, 4, 5, 6, 7])
    for lname, layer in c.cache.items():
        assert sorted(payload[lname]) == sorted(layer)
        for leaf, pool in layer.items():
            assert torch.equal(payload[lname][leaf], pool[rows])


def test_block_records_own_buffers_and_round_trip():
    """``gather_blocks(..., per_block=True)``: one record a block in table
    order, each viewing a host buffer of its own that holds that block
    alone, each leaf equal to the block's rows; ``scatter_blocks`` of the
    records writes them back bit for bit into other blocks, and refuses a
    record of another geometry."""
    c = tkv.BlockedKVCache(3, 6, 4, 2, 8, dtype="int8")
    gen = torch.Generator().manual_seed(0)
    for layer in c.cache.values():
        for pool in layer.values():
            pool.copy_(torch.randint(-100, 100, pool.shape, generator=gen)
                       .to(pool.dtype))
    records = c.gather_blocks([4, 1], per_block=True)
    _, rec_bytes = c._record_layout()
    storages = []
    for rec, blk in zip(records, (4, 1)):
        ptrs = {t.untyped_storage().data_ptr()
                for layer in rec.values() for t in layer.values()}
        assert len(ptrs) == 1
        storages.append(ptrs.pop())
        rows = torch.arange(blk * 4, blk * 4 + 4)
        for lname, layer in c.cache.items():
            assert sorted(rec[lname]) == sorted(layer)
            for leaf, pool in layer.items():
                assert torch.equal(rec[lname][leaf], pool[rows])
                assert rec[lname][leaf].untyped_storage().nbytes() \
                    == rec_bytes
    assert len(set(storages)) == 2
    want = c.gather_blocks([4, 1])
    c.scatter_blocks([0, 3], records)
    got = c.gather_blocks([0, 3])
    for lname in want:
        for leaf in want[lname]:
            assert torch.equal(got[lname][leaf], want[lname][leaf])
    other = tkv.BlockedKVCache(3, 6, 4, 2, 16, dtype="int8")
    with pytest.raises(ValueError, match="block record"):
        other.scatter_blocks([0, 3], records)


# --------------------------------------------------------------------- #
# The engine over an int8 pool with the tier
# --------------------------------------------------------------------- #
def _count_calls(eng):
    calls = {"gather": [], "scatter": []}
    kv = eng.state_manager.kv_cache
    real_gather, real_scatter = kv.gather_blocks, kv.scatter_blocks

    def gather(blocks, **kw):
        calls["gather"].append(list(blocks))
        return real_gather(blocks, **kw)

    def scatter(blocks, payload):
        calls["scatter"].append(list(blocks))
        return real_scatter(blocks, payload)

    kv.gather_blocks, kv.scatter_blocks = gather, scatter
    return calls


def _tier_counters(eng):
    sm = eng.state_manager
    st = sm.host_tier.stats
    occ = eng.occupancy()
    return {"tier_len": len(sm.host_tier), "tier_bytes": sm.host_tier.bytes,
            "spooled": st.spooled_blocks, "restored": st.restored_blocks,
            "dropped": st.dropped_blocks,
            "spool_calls": list(st.spool_blocks_per_call),
            "restore_calls": list(st.restore_blocks_per_call),
            "free": sm.free_blocks, "evictable":
                sm.prefix_cache.evictable_blocks,
            "occupancy_keys": sorted(occ),
            "occupancy": {k: v for k, v in occ.items()
                          if not k.endswith("_s")}}


@pytest.mark.parametrize("evict", ["pressure", "explicit"])
def test_spool_restore_bit_exact_and_matches_jax(jparams, evict):
    """Eviction by allocation pressure, or one explicit ``evict(3)``: the
    round trip is bit-exact, one gather a spool and one scatter a restore,
    the continuation equals a never-evicted run bitwise and the JAX
    engine's within the bar, and every counter equals JAX's."""
    out = {}
    for side, eng in (("jax", _jengine(jparams)),
                      ("port", _tengine(jparams))):
        sm = eng.state_manager
        calls = _count_calls(eng) if side == "port" else None
        hist = _grow_session(eng, 1, _prompt(8, 16), 9)  # 24 seen: 3 blocks
        pre = _leaves(sm.kv_cache.gather_blocks(
            list(sm.get_sequence(1).blocks)[:3]))
        eng.flush([1])
        assert sm.prefix_cache.evictable_blocks == 3
        if calls is not None:
            calls["gather"].clear()
        if evict == "pressure":
            _pressure(eng, (5, 6))
        else:
            assert sm.prefix_cache.evict(3) == 3
        spooled = sm.host_tier.stats.spooled_blocks
        assert spooled >= 2
        if calls is not None:
            assert len(calls["gather"]) == len(
                sm.host_tier.stats.spool_blocks_per_call)
            assert [len(g) for g in calls["gather"]] == list(
                sm.host_tier.stats.spool_blocks_per_call)
            calls["scatter"].clear()
        cached = eng.attach_prefix(1, hist)
        assert cached == 24
        restored = sm.host_tier.stats.restored_blocks
        assert restored == min(spooled, 3)
        if calls is not None:
            assert [len(s) for s in calls["scatter"]] == [restored]
        post = _leaves(sm.kv_cache.gather_blocks(
            list(sm.get_sequence(1).blocks)[:3]))
        for a, b in zip(pre, post):
            np.testing.assert_array_equal(a, b)
        logits = np.asarray(eng.put([1], [hist[cached:]])[1])
        out[side] = (logits, _tier_counters(eng))
    # a never-evicted run of the port: the same history, warm in the tree,
    # re-attached from the device
    ref = _tengine(jparams, num_blocks=33)
    _grow_session(ref, 1, _prompt(8, 16), 9)
    ref.flush([1])
    assert ref.attach_prefix(1, hist) == 24
    never = np.asarray(ref.put([1], [hist[24:]])[1])
    np.testing.assert_array_equal(out["port"][0], never)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=TOL,
                               atol=TOL)
    assert out["port"][1] == out["jax"][1]


def test_restore_under_full_pool_never_recycles_the_match(jparams):
    """A restore allocates with the in-device match acquired, so eviction
    under a full pool never recycles the match; the hits go back to the
    tier uncounted, and restore once the pressure is released — on both
    engines alike."""
    out = []
    for eng in (_jengine(jparams), _tengine(jparams)):
        sm = eng.state_manager
        alloc = sm.allocator
        hist = _grow_session(eng, 1, _prompt(27, 16), 9)
        eng.flush([1])
        assert sm.prefix_cache.evict(2) == 2
        a0 = sm.prefix_cache.match_blocks(hist)[0]
        hoard = alloc.allocate(alloc.free_blocks)        # the pool is full
        trace = [eng.attach_prefix(4, hist), sm.get_sequence(4).blocks == [a0],
                 alloc.refcount(a0), len(sm.host_tier),
                 sm.host_tier.stats.restored_blocks,
                 sm.host_tier.stats.spooled_blocks]
        eng.flush([4])
        alloc.free(hoard)
        trace += [eng.attach_prefix(5, hist),
                  sm.host_tier.stats.restored_blocks]
        logits = np.asarray(eng.put([5], [hist[24:]])[5])
        out.append((trace, logits))
    assert out[1][0] == out[0][0] == [8, True, 2, 2, 0, 2, 24, 2]
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=TOL, atol=TOL)


def test_tier_miss_recompute_matches_jax_logits(jparams):
    """A 1-byte budget drops every spool: the resume recomputes through
    the normal prefill path.  The port's logits agree with the JAX
    engine's on the same operations (the JAX package's own assertion that
    a miss is bit-equal to a fresh engine is red in the reference, so it
    is no oracle here)."""
    out = []
    for eng in (_jengine(jparams, host_tier_bytes=1),
                _tengine(jparams, host_tier_bytes=1)):
        sm = eng.state_manager
        hist = _grow_session(eng, 1, _prompt(10, 16), 9)
        eng.flush([1])
        _pressure(eng, (22, 23))
        st = sm.host_tier.stats
        assert st.dropped_blocks >= 1 and st.restored_blocks == 0
        got = np.asarray(eng.put([1], [hist])[1])
        out.append((got, st.dropped_blocks, st.spooled_blocks))
    assert out[1][1:] == out[0][1:]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=TOL, atol=TOL)
