"""The port's int8 KV cache against the JAX package's on the CPU.

* ``quantize_kv`` / ``dequantize_kv``: bit for bit, on seeded inputs, on
  exact .5 ties (round half to even) and on all-zero rows (scale 1.0);
* the int8 ``BlockedKVCache``: its leaves, shapes and ``per_token_bytes``;
  ``copy_block`` / ``gather_blocks`` / ``scatter_blocks`` bit-exact with
  their scales, and a JAX ``gather_blocks`` payload scattered into the port;
* the plain int8 decode against JAX ``paged_decode_attention(k_scale,
  v_scale, interpret=True)``: f32, <= 2e-5;
* the engine over an int8 pool (``LlamaConfig.tiny``, block 8, f32
  activations, the JAX weights carried across with ``params_from_jax``):
  ``put`` / ``decode_step`` logits against the JAX engine <= 2e-5, with two
  sequences sharing prefix blocks; the disaggregated handoff
  (``flush_to_host(include_kv=True)`` → ``resume(kv_state=...)``) bitwise
  equal to the colocated run and within 2e-5 of the JAX engine's;
* the int8 guards: a model without ``supports_quantized_kv`` is refused
  (the host cold tier, ported since, is held to JAX in
  ``test_torch_host_tier.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.kernels import blocked_flash as jbf
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.inference.v2.ragged import kv_cache as jkv
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.config_v2 import KVCacheConfig
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkv
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig

TOL = 2e-5                  # f32 on both sides, different summation orders
BS = 8
JCFG = JLlamaConfig.tiny(dtype=jnp.float32)
TCFG = TLlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree_util.tree_map(np.asarray, JLlamaForCausalLM(JCFG).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))["params"])


def _cfg(kv_dtype="int8", prefix_cache=False):
    return {"state_manager": {"max_ragged_batch_size": 32,
                              "max_ragged_sequence_count": 4,
                              "max_context": 64},
            "kv_cache": {"block_size": BS, "dtype": kv_dtype,
                         "enable_prefix_cache": prefix_cache}}


def _engines(jparams, **kw):
    cfg = _cfg(**kw)
    teng = TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                   TConfig.from_dict(cfg), device="cpu")
    jeng = JEngine(JRaggedLlama(JCFG, BS), jparams, JConfig.from_dict(cfg))
    return teng, jeng


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


# --------------------------------------------------------------------- #
# The quantizer and the cache structure
# --------------------------------------------------------------------- #
def _tie_rows():
    """Rows whose absmax is 127 * 2**-2, so the scale is exact and x/scale
    lands on every half-integer from -7.5 to 6.5."""
    x = np.zeros((8, 2, 16), np.float32)
    x[..., 0] = 127.0
    x[..., 1:] = np.arange(-7.5, 7.0, 1.0)
    return x * np.float32(0.25)


@pytest.mark.parametrize("case", ["seeded", "ties", "zeros"])
def test_quantize_kv_matches_jax_bitwise(case):
    x = {"seeded": lambda: 3.0 * np.random.default_rng(0).standard_normal(
            (64, 4, 64)).astype(np.float32),
         "ties": _tie_rows,
         "zeros": lambda: np.zeros((4, 2, 8), np.float32)}[case]()
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq, ts).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js)))
    if case == "ties":                  # half to even: -7.5 -> -8, 6.5 -> 6
        assert tq[0, 0, 1].item() == -8 and tq[0, 0, -1].item() == 6
    if case == "zeros":
        assert (tq == 0).all() and (ts == 1.0).all()


def test_int8_cache_layout_and_bytes_match_jax():
    for dtype in ("int8", "bf16", "f32"):
        t = tkv.BlockedKVCache(2, 4, 8, 2, 32, dtype=dtype)
        j = jkv.BlockedKVCache(2, 4, 8, 2, 32, dtype=dtype)
        assert t.quantized == j.quantized == (dtype == "int8")
        assert t.per_token_bytes == j.per_token_bytes
        for lname, layer in j.cache.items():
            assert set(t.cache[lname]) == set(layer)
            for leaf, arr in layer.items():
                got = t.cache[lname][leaf]
                assert tuple(got.shape) == arr.shape
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(arr, np.float32))
    assert tkv.BlockedKVCache(2, 4, 8, 2, 32, "int8").per_token_bytes \
        == 2 * 2 * 2 * (32 + 4)


def _filled(seed):
    """A port int8 cache with random payloads and scales."""
    rng = np.random.default_rng(seed)
    cache = tkv.BlockedKVCache(2, 5, 4, 2, 16, dtype="int8")
    for layer in cache.cache.values():
        for leaf, pool in layer.items():
            if pool.dtype == torch.int8:
                pool.copy_(torch.from_numpy(rng.integers(
                    -127, 128, pool.shape).astype(np.int8)))
            else:
                pool.copy_(torch.from_numpy(
                    rng.random(tuple(pool.shape)).astype(np.float32)))
    return cache


def test_int8_block_ops_carry_scales_bitexact():
    """copy_block / gather_blocks / scatter_blocks move payload and scales
    together, bit-exactly, in the port and between the two packages."""
    c = _filled(1)
    before = {ln: {k: v.clone() for k, v in lv.items()}
              for ln, lv in c.cache.items()}
    c.copy_block(1, 3)
    for lname, lv in c.cache.items():
        assert set(lv) == {"k", "v", "k_scale", "v_scale"}
        for leaf, pool in lv.items():
            assert torch.equal(pool[12:16], before[lname][leaf][4:8])
            assert torch.equal(pool[:12], before[lname][leaf][:12])
    payload = c.gather_blocks([1, 2])
    c2 = tkv.BlockedKVCache(2, 5, 4, 2, 16, dtype="int8")
    c2.scatter_blocks([2, 4], payload)
    back = c2.gather_blocks([2, 4])
    for lname, lv in payload.items():
        for leaf, arr in lv.items():
            assert arr.device.type == "cpu" and torch.equal(arr,
                                                            back[lname][leaf])
    # the JAX package's handoff payload lands bit-exactly in the port
    j = jkv.BlockedKVCache(2, 5, 4, 2, 16, dtype="int8")
    j.cache = jax.tree_util.tree_map(
        jnp.asarray, {ln: {k: v.numpy() for k, v in lv.items()}
                      for ln, lv in c.cache.items()})
    jpay = j.gather_blocks([3, 1])
    c3 = tkv.BlockedKVCache(2, 5, 4, 2, 16, dtype="int8")
    c3.scatter_blocks([4, 2], jpay)
    for lname, lv in c3.gather_blocks([4, 2]).items():
        for leaf, arr in lv.items():
            np.testing.assert_array_equal(arr.numpy(),
                                          np.asarray(jpay[lname][leaf]))
    with pytest.raises(ValueError, match="geometry"):
        c3.scatter_blocks([1], payload)
    with pytest.raises(ValueError, match="dtype differs"):
        tkv.BlockedKVCache(2, 5, 4, 2, 16, dtype="f32").scatter_blocks(
            [1, 2], payload)


# --------------------------------------------------------------------- #
# The plain int8 decode against the JAX package's decode kernel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [None, 100])
def test_plain_int8_decode_matches_jax_kernel(window):
    bs, d, h, hkv, slots, width = 128, 128, 4, 2, 5, 4
    rng = np.random.default_rng(7)
    nb = slots * width + 1
    kf = rng.standard_normal((nb * bs, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((nb * bs, hkv, d)).astype(np.float32)
    kq, ks = (t.numpy() for t in tkv.quantize_kv(torch.from_numpy(kf)))
    vq, vs = (t.numpy() for t in tkv.quantize_kv(torch.from_numpy(vf)))
    tables = ((rng.permutation(slots * width) + 1)
              .reshape(slots, width).astype(np.int32))
    tables[1, 0] = tables[0, 0]                     # a shared block
    pos = np.asarray([bs - 1, bs, -1, 2 * bs + 5, 450], np.int32)
    slot = np.arange(slots, dtype=np.int32)
    q = rng.standard_normal((slots, h, d)).astype(np.float32)
    arrs = (q, kq, vq, tables, slot, pos)
    want = np.asarray(jbf.paged_decode_attention(
        *map(jnp.asarray, arrs), block_size=bs, window=window,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    launches = dict(tbf.LAUNCHES)
    got = tbf.paged_decode_attention(
        *map(torch.from_numpy, arrs), block_size=bs, window=window,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert tbf.LAUNCHES == launches                 # CPU: the plain version
    assert np.abs(got.numpy() - want).max() <= TOL
    assert np.abs(got.numpy()[2]).max() == 0.0      # pad slot: zeros


# --------------------------------------------------------------------- #
# The engine over an int8 pool
# --------------------------------------------------------------------- #
def test_int8_engine_matches_jax(jparams):
    """put of three prompts (one shares two full blocks with another while
    it is live), then 5 greedy decode_step rounds: logits <= 2e-5 at every
    step, tokens equal, allocator counts equal."""
    teng, jeng = _engines(jparams, prefix_cache=True)
    a = _prompt(0, 2 * BS + 3)
    prompts = [a, a[:2 * BS] + _prompt(1, 5), _prompt(2, 11)]
    tok = []
    for uid, p in enumerate(prompts):        # one at a time: 1 hits 0's cache
        tl = teng.put([uid], [p])[uid]
        jl = np.asarray(jeng.put([uid], [p])[uid])
        assert np.abs(tl - jl).max() <= TOL
        tok.append(int(np.argmax(jl)))
    assert teng.prefix_cache_stats.hit_tokens == 2 * BS
    assert jeng.prefix_cache_stats.hit_tokens == 2 * BS
    uids = [0, 1, 2]
    for _ in range(5):
        tlog, ttok = teng.decode_step(uids, tok, greedy=True)
        jlog, jtok = jeng.decode_step(uids, tok, greedy=True)
        assert np.abs(tlog.numpy() - np.asarray(jlog)).max() <= TOL
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        tok = [int(t) for t in np.asarray(jtok)[:3]]
    assert teng.state_manager.free_blocks == jeng.state_manager.free_blocks
    teng.flush(uids)
    jeng.flush(uids)
    assert teng.state_manager.free_blocks == jeng.state_manager.free_blocks


def test_int8_vs_f32_logits_close(jparams):
    """The quantization error is real but small: int8-pool prompt logits
    within 5% of the f32 pool's largest magnitude (the JAX package's
    bar)."""
    p = _prompt(3, 17)
    t8 = TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                 TConfig.from_dict(_cfg("int8")), device="cpu")
    t32 = TEngine(TRaggedLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                  TConfig.from_dict(_cfg("f32")), device="cpu")
    l8, l32 = t8.put([1], [p])[1], t32.put([1], [p])[1]
    assert np.abs(l8 - l32).max() / np.abs(l32).max() < 0.05
    assert t8.state_manager.kv_cache.per_token_bytes \
        < t32.state_manager.kv_cache.per_token_bytes


def test_disaggregated_handoff_carries_int8_scales(jparams):
    """flush_to_host(include_kv=True) -> resume(kv_state=...) between two
    int8 engines: the payload carries the scale records, so the target's
    next-token logits equal the colocated run bitwise, and the JAX
    package's handoff within 2e-5."""
    prompt = _prompt(11, 15)
    out = {}
    for side in ("port", "jax"):
        teng, jeng = _engines(jparams)
        eng = teng if side == "port" else jeng
        dst = _engines(jparams)[0 if side == "port" else 1]
        ref_eng = _engines(jparams)[0 if side == "port" else 1]
        tok = int(np.argmax(eng.put([4], [prompt])[4]))
        snap = eng.flush_to_host([4], include_kv=True)[4]
        assert set(snap["kv"]["layer_0"]) == {"k", "v", "k_scale",
                                              "v_scale"}
        assert dst.resume(4, prompt, kv_state=snap) == {}
        got = np.asarray(dst.put([4], [[tok]])[4])
        ref_eng.put([5], [prompt])
        ref = np.asarray(ref_eng.put([5], [[tok]])[5])
        np.testing.assert_array_equal(got, ref)
        out[side] = got
    assert np.abs(out["port"] - out["jax"]).max() <= TOL


def test_resume_from_snapshot_with_tail_and_bad_snapshots(jparams):
    """A snapshot covering part of the history: only the tail is
    prefilled, and the logits match a fresh engine's; a snapshot of the
    wrong block size or length is refused and leaves nothing allocated."""
    prompt = _prompt(12, 20)
    teng, _ = _engines(jparams)
    teng.put([1], [prompt[:13]])
    snap = teng.flush_to_host([1], include_kv=True)[1]
    free = teng.state_manager.free_blocks
    for bad, match in (({**snap, "block_size": 16}, "block_size"),
                       ({**snap, "seen_tokens": 30}, "covers")):
        with pytest.raises(ValueError, match=match):
            teng.resume(1, prompt, kv_state=bad)
        assert teng.state_manager.get_sequence(1) is None
        assert teng.state_manager.free_blocks == free
    got = teng.resume(1, prompt, kv_state=snap)[1]
    fresh, _ = _engines(jparams)
    np.testing.assert_array_equal(got, fresh.put([1], [prompt])[1])


def test_int8_guards(jparams):
    class NoQuantLlama(TRaggedLlama):
        supports_quantized_kv = False

    with pytest.raises(ValueError, match="int8"):
        TEngine(NoQuantLlama(TCFG, BS), params_from_jax(jparams, "cpu"),
                TConfig.from_dict(_cfg("int8")), device="cpu")
    assert KVCacheConfig.from_dict({"dtype": "int8"}).dtype == "int8"
    with pytest.raises(ValueError, match="not understood"):
        KVCacheConfig.from_dict({"dtype": "fp7"})
