"""The serving slice as a whole: the port's ``InferenceEngineV2`` against
the JAX package's on the same f32 tiny Llama (plain weights and int8
records) and the same engine config.  ``put`` of three prompts — one longer
than the token budget, so SplitFuse chunks it — then 16 greedy
``decode_step(greedy=True)`` steps with device-resident feedback, then
``decode_loop``, then ``generate``: greedy tokens identical, first-step
logits <= 1e-4 max abs.  Token parity is asserted in f32 only (bf16
near-ties flip between program shapes).  The prefix-cache case shares
full blocks between two live sequences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig
from torch_port_common import engine_config_dict, llama_params, tiny_geometry

BS = 16


def _engines(int8=False, prefix_cache=False, jax_side=True, **cfg_kw):
    geom = tiny_geometry()
    params = llama_params(geom, seed=5, int8=int8)
    cfg_kw.setdefault("max_context", 128)
    cfg = engine_config_dict(block_size=BS, prefix_cache=prefix_cache,
                             **cfg_kw)
    teng = TEngine(TRaggedLlama(TLlamaConfig(**geom, dtype=torch.float32), BS),
                   params_from_jax(params, device="cpu"),
                   TConfig.from_dict(cfg), device="cpu")
    if not jax_side:
        return teng, None
    jeng = JEngine(JRaggedLlama(JLlamaConfig(**geom, dtype=jnp.float32), BS),
                   params, JConfig.from_dict(cfg))
    return teng, jeng


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


@pytest.mark.parametrize("int8", [False, True])
def test_engine_matches_jax(int8):
    teng, jeng = _engines(int8=int8)
    prompts = _prompts(0, (5, 70, 33))          # 70 > the 64-token budget
    uids = [0, 1, 2]
    tl = teng.put(uids, prompts)
    jl = jeng.put(uids, prompts)
    for u in uids:
        assert np.abs(tl[u] - jl[u]).max() <= 1e-4
    first = [int(np.argmax(jl[u])) for u in uids]
    assert first == [int(np.argmax(tl[u])) for u in uids]

    # 16 greedy decode_step rounds, token feedback staying on the device
    ttok, jtok = first, first
    for _ in range(16):
        _, ttok = teng.decode_step(uids, ttok, greedy=True)
        _, jtok = jeng.decode_step(uids, jtok, greedy=True)
        assert isinstance(ttok, torch.Tensor)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    nxt = [int(t) for t in ttok[:3]]
    np.testing.assert_array_equal(teng.decode_loop(uids, nxt, 16),
                                  jeng.decode_loop(uids, nxt, 16))
    assert teng.query(1) == jeng.query(1)
    assert (teng.can_schedule([1, 5], [7, 40])
            == jeng.can_schedule([1, 5], [7, 40]))
    teng.flush(uids)
    jeng.flush(uids)

    gen_prompts = _prompts(1, (9, 40, 3, 21))
    for got, want in zip(teng.generate(gen_prompts, max_new_tokens=12),
                         jeng.generate(gen_prompts, max_new_tokens=12)):
        np.testing.assert_array_equal(got, want)
    assert teng.state_manager.free_blocks == jeng.state_manager.free_blocks


def test_tile_aligned_prefill_matches_jax():
    """Every pending chunk >= 128 tokens: both engines pack the batch
    tile-aligned (pads at position -1) and SplitFuse the longer prompt."""
    teng, jeng = _engines(token_budget=256, max_context=384)
    prompts = _prompts(4, (130, 300))
    tl = teng.put([0, 1], prompts)
    jl = jeng.put([0, 1], prompts)
    for u in (0, 1):
        assert np.abs(tl[u] - jl[u]).max() <= 1e-4
    start = [int(np.argmax(jl[u])) for u in (0, 1)]
    np.testing.assert_array_equal(teng.decode_loop([0, 1], start, 5),
                                  jeng.decode_loop([0, 1], start, 5))


def _shared_prefix_tokens(teng):
    """Sequence A's prompt fills two blocks and a bit; B shares A's two
    full blocks while A is still live, then both decode together (the
    decode batch sees the shared blocks in two tables)."""
    a, b = _prompts(2, (2 * BS + 5, 7))
    b = a[:2 * BS] + b
    la = teng.put([10], [a])
    lb = teng.put([11], [b])
    start = [int(np.argmax(la[10])), int(np.argmax(lb[11]))]
    toks = teng.decode_loop([10, 11], start, 12)
    teng.flush([10, 11])
    return start, toks, lb[11]


def test_prefix_cache_gives_the_same_tokens():
    cached, jcached = _engines(prefix_cache=True)
    plain, _ = _engines(prefix_cache=False, jax_side=False)
    got = _shared_prefix_tokens(cached)
    want = _shared_prefix_tokens(plain)
    assert cached.prefix_cache_stats.hit_tokens == 2 * BS
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[2] - want[2]).max() <= 1e-4
    jgot = _shared_prefix_tokens(jcached)
    assert jgot[0] == got[0]
    np.testing.assert_array_equal(jgot[1], got[1])


def test_flush_to_host_then_resume_recomputes():
    teng, jeng = _engines()
    prompt = _prompts(3, (20,))[0]
    outs = []
    for eng in (teng, jeng):
        logits = eng.put([4], [prompt])
        toks = eng.decode_loop([4], [int(np.argmax(logits[4]))], 5)
        snap = eng.flush_to_host([4])
        assert snap[4] == {"seen_tokens": 25, "pending_tokens": 0}
        history = prompt + [int(np.argmax(logits[4]))] + toks[0].tolist()[:-1]
        outs.append(eng.resume(4, history)[4])
        eng.flush([4])
    assert np.abs(outs[0] - outs[1]).max() <= 1e-4


def test_unported_entry_points_raise():
    """What is still to port raises; speculative verify and the KV handoff
    (ported since) are covered in test_torch_speculative.py and
    test_torch_kv_quant.py, ``from_hf`` in test_torch_hf_loader.py (its
    tensor-parallel landing is still to port), ``serialize`` in
    test_torch_checkpoint.py."""
    teng, _ = _engines(jax_side=False)
    teng.put([0], [[1, 2, 3]])
    teng.flush_to_host([0])
    for call in (lambda: TEngine.from_hf("unused", mesh=object()),
                 teng.capture_memory_ledger):
        with pytest.raises(NotImplementedError):
            call()
