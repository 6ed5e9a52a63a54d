"""The port's training Llama against the Flax ``LlamaForCausalLM`` on the
CPU, in f32: logits, loss and the gradient of every parameter.

Bars: logits and loss <= 2e-5 (relative to the largest logit), gradients
<= 1e-4 (relative to each gradient's largest entry).  Flax's init carries
across through ``llama_state_dict_from_flax``; the ids are numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.models.llama import cross_entropy_loss as jce
from deepspeed_tpu_torch.checkpoint import (flax_params_from_llama_state_dict,
                                            llama_state_dict_from_flax)
from deepspeed_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                        cross_entropy_loss)
from torch_port_common import tiny_geometry

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _pair(**kw):
    geom = tiny_geometry(**kw)
    jmodel = JLlama(JLlamaConfig(**geom, dtype=jnp.float32))
    ids = np.random.default_rng(1).integers(
        0, geom["vocab_size"], size=(2, 64)).astype(np.int32)
    params = jax.device_get(jmodel.init(jax.random.key(0), ids))
    tmodel = LlamaForCausalLM(LlamaConfig(**geom, dtype=torch.float32),
                              device="cpu")
    tmodel.load_state_dict(llama_state_dict_from_flax(params, device="cpu"))
    return jmodel, tmodel, params, ids


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


@pytest.mark.parametrize("options", [
    {},
    {"fused_qkv": True},
    {"fused_gate_up": True},
    {"tie_word_embeddings": True},
    {"remat": True},
    {"sliding_window": 24},
    {"num_key_value_heads": 4},
])
def test_logits_loss_and_grads_match_flax(options):
    jmodel, tmodel, params, ids = _pair(**options)
    # logits
    jlogits = np.asarray(jmodel.apply(params, ids))
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(ids)).numpy()
    _close(tlogits, jlogits, FWD_TOL, "logits")
    # loss and every gradient
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, ids, ids))(params["params"])
    tids = torch.from_numpy(ids)
    tloss = tmodel(tids, tids)
    tloss.backward()
    _close(np.float32(tloss.item()), np.float32(jloss), FWD_TOL, "loss")
    tgrads = flax_params_from_llama_state_dict(
        {n: p.grad for n, p in tmodel.named_parameters()})
    jflat = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    tflat = jax.tree_util.tree_leaves(tgrads)
    assert len(jflat) == len(tflat)
    for (path, want), got in zip(jflat, tflat):
        _close(got, np.asarray(want), GRAD_TOL, jax.tree_util.keystr(path))


def test_cross_entropy_ignore_index_matches():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 16, 32)).astype(np.float32)
    labels = rng.integers(0, 32, size=(2, 16))
    labels[0, 3:9] = -100
    want = float(jce(logits, labels))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    assert abs(got - want) <= FWD_TOL * abs(want)


def test_state_dict_bridge_round_trips():
    _, tmodel, params, _ = _pair(fused_qkv=True, tie_word_embeddings=True)
    back = flax_params_from_llama_state_dict(tmodel.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params["params"])
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(params["params"])):
        np.testing.assert_array_equal(a, b)


def test_kv_cache_branch_and_unported_layouts_raise():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A9"):
        model(ids, cache={})
    # the folded and paired layouts are ported: they no longer raise, and
    # give the bshd layout's logits (d = 64, so both entries take it)
    logits = {}
    for layout in ("bshd", "folded", "paired"):
        model = LlamaForCausalLM(LlamaConfig.tiny(
            dtype=torch.float32, hidden_size=256, attention_layout=layout),
            device="cpu")
        logits[layout] = model(ids)
    for layout in ("folded", "paired"):
        torch.testing.assert_close(logits[layout], logits["bshd"], rtol=0,
                                   atol=0)


def test_seed_fixes_the_weights():
    """A seed draws its weights from a CPU generator, whatever the device:
    the same seed gives the same weights, another seed others."""
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    a, b, c = (LlamaForCausalLM(cfg, seed=s, device="cpu").state_dict()
               for s in (4, 4, 5))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    gen = torch.Generator().manual_seed(4)
    first = torch.empty(a["model.embed_tokens.weight"].shape).normal_(
        0.0, cfg.hidden_size ** -0.5, generator=gen)
    torch.testing.assert_close(a["model.embed_tokens.weight"], first,
                               rtol=0, atol=0)


def test_llama2_70b_geometry():
    cfg = LlamaConfig.llama2_70b(num_hidden_layers=1)
    assert (cfg.hidden_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.head_dim) == (8192, 64, 8, 128)
    jcfg = JLlamaConfig.llama2_70b()
    assert cfg.intermediate_size == jcfg.intermediate_size
