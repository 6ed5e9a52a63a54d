"""The Mixtral serving slice as a whole: the port's ``InferenceEngineV2`` +
``RaggedMixtral`` against the JAX package's on ``MixtralConfig.tiny`` in
f32 (block 8), with weights made with numpy from a seed and carried across
with ``params_from_jax``.  ``put`` and ``decode_step`` logits <= 2e-5 max
abs and greedy tokens equal over 6 steps; with ``PREFILL_TILE = 16``, so
that the engine packs tile-aligned and hands the tile to the model; over
an int8 KV pool.  Also: the dense all-experts oracle equals the grouped
path, ``verify_step`` on Mixtral matches JAX's, the weight bridge carries the
Mixtral tree, and ``random_mixtral_params`` builds the JAX package's tree
on the device it is given."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedMixtral as JRaggedMixtral)
from deepspeed_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM
from deepspeed_tpu_torch.checkpoint import (params_from_jax,
                                            random_mixtral_params)
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedMixtral as TRaggedMixtral)
from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_mixtral import (  # noqa: E501
    dropless_moe)
from deepspeed_tpu_torch.models import MixtralConfig as TMixtralConfig
from torch_port_common import engine_config_dict

BS = 8
TOL = 2e-5


def mixtral_params(cfg, seed=0):
    """The JAX ``MixtralForCausalLM`` param tree of ``cfg`` as numpy f32
    arrays, with weights large enough that greedy tokens vary."""
    rng = np.random.default_rng(seed)
    H, I, V, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_local_experts)
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    def norm():
        return {"scale": (1.0 + 0.1 * rng.standard_normal(H)).astype(
            np.float32)}

    params = {"embed_tokens": {"embedding": rng.standard_normal(
        (V, H)).astype(np.float32)}}
    for i in range(cfg.num_hidden_layers):
        params[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(H, H)},
                          "k_proj": {"kernel": w(H, kv)},
                          "v_proj": {"kernel": w(H, kv)},
                          "o_proj": {"kernel": w(H, H)}},
            "block_sparse_moe": {"deepspeed_moe": {
                "gate": {"wg": {"kernel": 2.0 * w(H, E)}},
                "experts": {"w_gate": w(E, H, I), "w_up": w(E, H, I),
                            "w_down": w(E, I, H)}}},
            "input_layernorm": norm(),
            "post_attention_layernorm": norm(),
        }
    params["norm"] = norm()
    params["lm_head"] = {"kernel": w(H, V)}
    return params


def _engines(kv_dtype=None, **cfg_kw):
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_key_value_heads=2)
    params = mixtral_params(JMixtralConfig.tiny(**cfg))
    eng_cfg = engine_config_dict(block_size=BS, **cfg_kw)
    if kv_dtype is not None:
        eng_cfg["kv_cache"]["dtype"] = kv_dtype
    teng = TEngine(TRaggedMixtral(TMixtralConfig.tiny(
        **cfg, dtype=torch.float32), BS), params_from_jax(params, "cpu"),
        TConfig.from_dict(eng_cfg), device="cpu")
    jeng = JEngine(JRaggedMixtral(JMixtralConfig.tiny(
        **cfg, dtype=jnp.float32), BS), params, JConfig.from_dict(eng_cfg))
    return teng, jeng


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


def _put_decode_match(teng, jeng, prompts, steps=6):
    uids = list(range(len(prompts)))
    tl = teng.put(uids, prompts)
    jl = jeng.put(uids, prompts)
    for u in uids:
        assert np.abs(tl[u] - jl[u]).max() <= TOL
    tok = [int(np.argmax(jl[u])) for u in uids]
    assert tok == [int(np.argmax(tl[u])) for u in uids]
    seen = [tok]
    for _ in range(steps):
        tlog, ttok = teng.decode_step(uids, tok, greedy=True)
        jlog, jtok = jeng.decode_step(uids, tok, greedy=True)
        n = len(uids)
        assert np.abs(tlog[:n].numpy() - np.asarray(jlog)[:n]).max() <= TOL
        np.testing.assert_array_equal(ttok[:n].numpy(), np.asarray(jtok)[:n])
        tok = [int(t) for t in ttok[:n]]
        seen.append(tok)
    teng.flush(uids)
    jeng.flush(uids)
    return seen


def test_engine_matches_jax():
    teng, jeng = _engines(max_context=128)
    # 70 tokens exceed the 64-token budget: SplitFuse chunks it
    seen = _put_decode_match(teng, jeng, _prompts(0, (5, 70, 33)))
    assert len({t for row in seen for t in row}) > 3     # tokens vary
    assert (teng.state_manager.free_blocks
            == jeng.state_manager.free_blocks)


def test_engine_tiled_prefill_matches_jax(monkeypatch):
    """Prompts of 17 and 20 tokens with PREFILL_TILE = 16 pack tile-aligned
    (pad rows at position -1), and the engine hands the tile to the model
    (the JAX engine does the same, ``engine_v2.py:362-365``)."""
    teng, jeng = _engines(max_context=64)
    teng.PREFILL_TILE = jeng.PREFILL_TILE = 16
    tiles = []
    call = TRaggedMixtral.__call__

    def spy(self, params, kv_cache, batch, prefill_tile=None, **kw):
        tiles.append(prefill_tile)
        return call(self, params, kv_cache, batch, prefill_tile, **kw)

    monkeypatch.setattr(TRaggedMixtral, "__call__", spy)
    _put_decode_match(teng, jeng, _prompts(17, (17, 20)))
    assert tiles[0] == 16 and tiles[1:] == [None] * 6


def test_engine_int8_kv_matches_jax():
    teng, jeng = _engines(kv_dtype="int8", max_context=128)
    assert teng.state_manager.kv_cache.quantized
    _put_decode_match(teng, jeng, _prompts(1, (9, 40)))


def test_dense_oracle_equals_grouped():
    cfg = JMixtralConfig.tiny()
    lp = params_from_jax(mixtral_params(cfg, seed=3), "cpu")["layers_0"]
    moe = lp["block_sparse_moe"]["deepspeed_moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (37, cfg.hidden_size)).astype(np.float32))
    grouped = dropless_moe(x, moe, 2, torch.float32)
    dense = dropless_moe(x, moe, 2, torch.float32, grouped=False)
    assert (grouped - dense).abs().max().item() <= TOL


def test_verify_step_matches_jax():
    """``verify_step`` on Mixtral scores its rows through the generic
    ragged path, as the JAX engine does: one 6-token prompt, then three
    fed tokens; all three logits rows within the f32 bar of JAX's."""
    teng, jeng = _engines(max_context=64)
    prompt = _prompts(2, (6,))
    tl = teng.put([0], prompt)
    jl = jeng.put([0], prompt)
    t0 = int(np.argmax(jl[0]))
    assert t0 == int(np.argmax(tl[0]))
    tlog = teng.verify_step([0], [[t0, 1, 2]])
    jlog = jeng.verify_step([0], [[t0, 1, 2]])
    assert tlog.shape == np.asarray(jlog).shape == (4, 3, 256)
    assert np.abs(tlog[0].numpy() - np.asarray(jlog)[0]).max() <= TOL


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_weight_bridges_carry_the_mixtral_tree():
    """The JAX package's ``MixtralForCausalLM`` tree (its paths and shapes,
    from ``jax.eval_shape`` of its init) is the tree this file builds;
    ``params_from_jax`` carries that tree — [E, H, F] experts and the fp32
    router included — bit for bit; ``random_mixtral_params`` builds the
    same paths and shapes (bf16 weights, fp32 router and norms)."""
    jcfg = JMixtralConfig.tiny(dtype=jnp.float32, num_key_value_heads=2)
    shapes = jax.eval_shape(lambda: MixtralForCausalLM(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"])
    want = {path: tuple(leaf.shape) for path, leaf in _leaves(shapes)}
    tree = mixtral_params(jcfg, seed=7)
    built = dict(_leaves(tree))
    assert {p: a.shape for p, a in built.items()} == want
    carried = dict(_leaves(params_from_jax(tree, "cpu")))
    assert carried.keys() == built.keys()
    for path, arr in built.items():
        assert carried[path].dtype == torch.float32
        np.testing.assert_array_equal(carried[path].numpy(), arr)
    moe = ("layers_1", "block_sparse_moe", "deepspeed_moe")
    assert carried[moe + ("experts", "w_gate")].shape == (4, 64, 128)

    tcfg = TMixtralConfig.tiny(num_key_value_heads=2)
    gen = torch.Generator().manual_seed(0)
    rand = dict(_leaves(random_mixtral_params(tcfg, "cpu", gen)))
    assert {p: tuple(t.shape) for p, t in rand.items()} == want
    for path, t in rand.items():
        fp32 = path[-1] == "scale" or "gate" in path
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
    again = random_mixtral_params(tcfg, "cpu",
                                  torch.Generator().manual_seed(0))
    assert torch.equal(again["lm_head"]["kernel"],
                       rand[("lm_head", "kernel")])
