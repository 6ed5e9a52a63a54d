"""The port's GPT-2 (``models/gpt2.py``) and the training slice under
``attention_layout`` "folded" and "paired", against the JAX package on the
CPU in f32.

* logits and loss of ``GPT2LMHeadModel`` at ``GPT2Config.tiny(hidden_size=
  128, num_attention_heads=2)`` (d = 64, so the folded and paired entries
  take it) under the three layouts and with ``remat``, on Flax's weights
  carried across with ``gpt2_state_dict_from_flax``: <= 2e-5;
* the weight bridges' round trip is exact;
* 20 engine steps of the bench ds_config with ``"attention_layout":
  "paired"`` on that GPT-2 and on a d = 64 tiny Llama (4 heads over 2 KV
  heads), loss by loss against the JAX engine: <= 1e-4;
* dropout: reproducible from the seed, and the same under ``remat``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.checkpoint import (flax_params_from_gpt2_state_dict,
                                            gpt2_state_dict_from_flax,
                                            llama_state_dict_from_flax)
from deepspeed_tpu_torch.models import (GPT2Config, GPT2LMHeadModel,
                                        LlamaConfig, LlamaForCausalLM)
from deepspeed_tpu_torch.ops import attention as tattn
from torch_port_common import single_process_env  # noqa: F401 (autouse)
from torch_port_common import tiny_geometry

FWD_TOL = 2e-5
TOL = 1e-4
GEOM = dict(hidden_size=128, num_attention_heads=2)


@pytest.fixture(autouse=True)
def _restore_default_layout():
    """An engine with an explicit ``attention_layout`` sets the
    process-wide default in both packages: put it back."""
    yield
    jattn.set_default_attention_layout("bshd")
    tattn.set_default_attention_layout("bshd")


def _ids(batch, seq=64, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)


def _gpt2_pair(seed=0, **kw):
    jmodel = JGPT2(JGPT2Config.tiny(**GEOM, dtype=jnp.float32, **kw))
    params = jax.device_get(jmodel.init(jax.random.key(seed),
                                        _ids(1, 8)))["params"]
    tmodel = GPT2LMHeadModel(GPT2Config.tiny(**GEOM, dtype=torch.float32,
                                             **kw), device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_flax(params, device="cpu"))
    return jmodel, tmodel, params


@pytest.mark.parametrize("layout,remat", [("bshd", False), ("folded", False),
                                          ("paired", False),
                                          ("paired", True)])
def test_gpt2_logits_and_loss_match_jax(layout, remat):
    jmodel, tmodel, params = _gpt2_pair(attention_layout=layout,
                                        remat=remat)
    ids = _ids(2, seed=1)
    want_logits = jmodel.apply({"params": params}, ids)
    want_loss = jmodel.apply({"params": params}, ids, ids)
    tids = torch.from_numpy(ids)
    got_logits = tmodel(tids)
    got_loss = tmodel(tids, tids)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=FWD_TOL, rtol=0)
    assert abs(float(got_loss.detach()) - float(want_loss)) <= FWD_TOL
    got_loss.backward()                 # remat recomputes through the entry
    assert all(torch.isfinite(p.grad).all() for p in tmodel.parameters())


def test_gpt2_weight_bridges_round_trip_exactly():
    jmodel, tmodel, params = _gpt2_pair(seed=3)
    sd = gpt2_state_dict_from_flax(params, device="cpu")
    assert set(sd) == {n for n, _ in tmodel.named_parameters()}
    assert sd["h.0.c_attn.weight"].shape == (3 * 128, 128)
    assert sd["h.1.ln_2.weight"].shape == (128,)
    back = flax_params_from_gpt2_state_dict(sd)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat_back.keys() == flat_want.keys()
    for path, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(arr),
                                      err_msg=jax.tree_util.keystr(path))


def _bench_config(micro_batch, layout):
    """bench.py:88-100 with bf16 off (the parity bar is f32)."""
    return {"train_micro_batch_size_per_gpu": micro_batch,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "zero_optimization": {"stage": 1},
            "gradient_clipping": 1.0,
            "attention_layout": layout}


def _one_device():
    return groups.initialize_mesh(devices=jax.devices()[:1])


def _step(engine, ids):
    loss = engine(ids, ids)
    engine.backward(loss)
    engine.step()
    return float(loss.detach()) if isinstance(loss, torch.Tensor) \
        else float(loss)


def _models(kind):
    if kind == "gpt2":
        jmodel, tmodel, params = _gpt2_pair()
        return jmodel, tmodel, params, gpt2_state_dict_from_flax
    geom = tiny_geometry()
    jmodel = JLlama(JLlamaConfig(**geom, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.key(0),
                                        _ids(1, 8)))["params"]
    tmodel = LlamaForCausalLM(LlamaConfig(**geom, dtype=torch.float32),
                              device="cpu")
    return jmodel, tmodel, params, llama_state_dict_from_flax


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_paired_layout_20_engine_steps_match_jax(monkeypatch, kind):
    """The bench ds_config with ``"attention_layout": "paired"``: the
    engine installs the layout and every step goes through the paired
    entry (d = 64)."""
    jmodel, tmodel, params, bridge = _models(kind)
    cfg = _bench_config(4, "paired")
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=cfg, model_parameters=params,
        topology=_one_device())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, config=cfg, device="cpu",
        model_parameters=bridge(params, device="cpu"))
    entries = []
    real = tattn.flash_attention_paired

    def spy(*a, **kw):
        entries.append("paired")
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_paired", spy)
    ids = _ids(4, seed=2)
    for _ in range(20):
        lj = _step(jeng, ids)
        lt = _step(teng, ids)
        assert abs(lt - lj) <= TOL * max(1.0, abs(lj)), (lt, lj)
    layers = 2
    assert entries == ["paired"] * (20 * layers)


def test_gpt2_dropout_is_seeded_and_survives_remat():
    """Residual and embedding dropout draw their masks from the model's
    generator outside the remat'd blocks: the same seed gives the same
    loss and gradients with and without ``remat``."""
    ids = torch.from_numpy(_ids(2, seed=4)).long()
    grads = []
    for remat in (False, True):
        model = GPT2LMHeadModel(GPT2Config.tiny(
            **GEOM, dtype=torch.float32, embd_pdrop=0.1, resid_pdrop=0.1,
            remat=remat), seed=5, device="cpu")
        loss = model(ids, ids)
        loss.backward()
        grads.append((float(loss.detach()),
                      model.h[0].c_attn.weight.grad.clone()))
        with torch.no_grad():
            model.eval()
            assert float(model(ids, ids)) != float(loss)   # dropout was on
    assert grads[0][0] == grads[1][0]
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6,
                               rtol=1e-6)
