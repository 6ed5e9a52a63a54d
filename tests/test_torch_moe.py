"""The port's MoE training path (``deepspeed_tpu_torch/moe/``,
``models/mixtral.py``) against the JAX package's on the CPU, in f32:

* ``top1gating`` / ``top2gating``: ``l_aux``, combine and dispatch at
  several capacities, token drops included; the RSample noise path;
* ``MOELayer`` / ``MoE``: output, ``l_aux`` and every gradient on the
  capacity path (k = 1, 2), the dropless path and the residual MoE, weights
  carried across with ``moe_state_dict_from_flax``;
* ``MixtralForCausalLM`` at ``MixtralConfig.tiny``: logits, loss and
  gradients; 20 engine steps through ``initialize`` against the JAX engine's
  losses and final masters; a few engine steps of the same model with
  ``MoE(dropless=True)`` layers (the JAX side built from the JAX package's
  ``LlamaAttention``, ``RMSNorm`` and ``MoE``);
* ``MixtralConfig`` takes every field of the JAX package's.

Inputs are made with numpy from a seed.  Bars: forward <= 2e-5, gradients
<= 1e-4, engine losses and masters <= 1e-4 (the indices exactly).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaAttention as JLlamaAttention
from deepspeed_tpu.models.llama import RMSNorm as JRMSNorm
from deepspeed_tpu.models.llama import cross_entropy_loss as j_cross_entropy
from deepspeed_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.checkpoint import (
    flax_params_from_mixtral_state_dict, flax_params_from_moe_state_dict,
    mixtral_state_dict_from_flax, moe_state_dict_from_flax)
from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.moe import MoE, top1gating, top2gating
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.ops import grouped_gemm as tgg
from torch_port_common import single_process_env  # noqa: F401 (autouse)

TOL = 2e-5
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------- #
# Gating
# ---------------------------------------------------------------------- #
def _gate_logits(s=32, e=4, seed=0, skew=0.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    logits[:, 0] += skew           # crowd expert 0 so capacity drops bite
    return logits


@pytest.mark.parametrize("cf,min_cap,drop,skew", [
    (1.0, 4, True, 0.0), (0.5, 1, True, 1.5), (2.0, 4, True, 0.0),
    (0.5, 1, False, 1.5)])
def test_top1gating_matches_jax(cf, min_cap, drop, skew):
    logits = _gate_logits(skew=skew)
    want = jsm.top1gating(jnp.asarray(logits), cf, min_cap,
                          drop_tokens=drop)
    got = top1gating(torch.from_numpy(logits), cf, min_cap,
                     drop_tokens=drop)
    _close(got[0].numpy(), want[0], TOL, "l_aux")
    _close(got[1].numpy(), want[1], TOL, "combine")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if drop and skew:              # the capacity dropped some tokens
        assert got[2].sum() < logits.shape[0]


@pytest.mark.parametrize("cf,min_cap,drop,skew", [
    (1.0, 4, True, 0.0), (0.5, 1, True, 1.5), (0.25, 1, True, 3.0),
    (0.5, 1, False, 1.5)])
def test_top2gating_matches_jax(cf, min_cap, drop, skew):
    logits = _gate_logits(seed=1, skew=skew)
    want = jsm.top2gating(jnp.asarray(logits), cf, min_cap,
                          drop_tokens=drop)
    got = top2gating(torch.from_numpy(logits), cf, min_cap,
                     drop_tokens=drop)
    _close(got[0].numpy(), want[0], TOL, "l_aux")
    _close(got[1].numpy(), want[1], TOL, "combine")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if drop and skew:
        assert got[2].sum() < 2 * logits.shape[0]


def test_gating_noise_comes_from_the_generator():
    """RSample (top-1) and second-expert sampling (top-2) take Gumbel noise
    from the generator (``jax.random`` gives other numbers, so the noise is
    checked by its definition): the expert is the argmax of the logits plus
    the noise, the gates stay the clean softmax's, ``l_aux`` counts the
    noisy choices; without a generator there is no noise.  Capacity 8x: no
    drops."""
    one_hot = torch.nn.functional.one_hot
    logits = torch.from_numpy(_gate_logits(s=64, e=8, seed=2))
    noise = tsm._gumbel(logits, torch.Generator().manual_seed(3))
    l_aux, combine, dispatch = top1gating(
        logits, 8.0, 4, "RSample", torch.Generator().manual_seed(3))
    chosen = torch.argmax(logits + noise, dim=-1)
    assert not torch.equal(chosen, torch.argmax(logits, dim=-1))
    assert torch.equal(dispatch.any(dim=2), one_hot(chosen, 8).bool())
    gates = torch.softmax(logits, dim=-1)
    _close(combine.sum(dim=(1, 2)), gates.gather(1, chosen[:, None])[:, 0],
           1e-6)
    _close(l_aux, (gates.mean(0) * one_hot(chosen, 8).float().mean(0)).sum()
           * 8, 1e-6)
    assert torch.equal(top1gating(logits, 8.0, 4, "RSample")[2],
                       top1gating(logits, 8.0, 4)[2])

    _, _, d2 = top2gating(logits, 8.0, 4, torch.Generator().manual_seed(4))
    noise2 = tsm._gumbel(logits, torch.Generator().manual_seed(4))
    first = torch.argmax(logits, dim=-1)
    second = torch.argmax((logits + noise2).masked_fill(
        one_hot(first, 8).bool(), -float("inf")), dim=-1)
    assert torch.equal(d2.any(dim=2), one_hot(first, 8).bool()
                       | one_hot(second, 8).bool())
    top2_clean = top2gating(logits, 8.0, 4)[2]
    assert not torch.equal(d2, top2_clean)


# ---------------------------------------------------------------------- #
# MOELayer / MoE
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(k=1),                                # capacity top-1, some drops
    dict(k=2, capacity_factor=0.5, min_capacity=1),   # top-2, many drops
    dict(k=2, dropless=True),                 # exact top-2, grouped GEMMs
    dict(k=2, use_residual=True),             # PR-MoE
], ids=["top1", "top2-drops", "dropless", "residual"])
def test_moe_layer_matches_jax(kw):
    """Output, ``l_aux`` and the gradients of ``sum(out * cot) + 0.7 l_aux``
    with respect to every parameter and the input."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jlayer = JMoE(hidden_size=32, intermediate_size=64, num_experts=4,
                  dtype=jnp.float32, **kw)
    params = _np(jax.jit(jlayer.init)(jax.random.key(0),
                                      jnp.asarray(x))["params"])

    def jloss(p, x_):
        out, l_aux = jlayer.apply({"params": p}, x_)
        return jnp.sum(out * cot) + 0.7 * l_aux, (out, l_aux)

    (_, (want_out, want_aux)), (want_gp, want_gx) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))

    tlayer = MoE(32, 64, 4, dtype=torch.float32, device="cpu", **kw)
    tlayer.load_state_dict(moe_state_dict_from_flax(params, device="cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    before = dict(tgg.LAUNCHES)
    out, l_aux = tlayer(tx)
    (torch.sum(out * torch.from_numpy(cot)) + 0.7 * l_aux).backward()
    assert tgg.LAUNCHES == before
    _close(out.detach().numpy(), want_out, TOL, "out")
    _close(l_aux.detach().numpy(), want_aux, TOL, "l_aux")
    _close(tx.grad.numpy(), want_gx, GRAD_TOL, "dx")
    got_gp = flax_params_from_moe_state_dict(
        {n: p.grad for n, p in tlayer.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(_np(want_gp)),
            jax.tree_util.tree_leaves(got_gp)):
        _close(got, want, GRAD_TOL, jax.tree_util.keystr(path))


def test_moe_validates_its_options():
    with pytest.raises(ValueError, match="divisible"):
        MoE(8, 16, num_experts=3, ep_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        MoE(8, 16, num_experts=4, ep_size=2, device="cpu")
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        MoE(8, 16, num_experts=4, dropless=True, noisy_gate_policy="RSample",
            device="cpu")
    layer = MoE(8, 16, num_experts=4, k=3, device="cpu")
    with pytest.raises(ValueError, match="k=3"):
        layer(torch.ones(1, 4, 8))


def test_moe_bridge_round_trips():
    jlayer = JMoE(hidden_size=8, intermediate_size=16, num_experts=4, k=2,
                  use_residual=True, dtype=jnp.float32)
    params = _np(jax.jit(jlayer.init)(jax.random.key(1),
                                      jnp.ones((1, 4, 8)))["params"])
    sd = moe_state_dict_from_flax(params, device="cpu")
    assert sd["deepspeed_moe.gate.wg.weight"].shape == (4, 8)
    assert sd["deepspeed_moe.experts.w_down"].shape == (4, 16, 8)
    back = flax_params_from_moe_state_dict(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


# ---------------------------------------------------------------------- #
# Mixtral
# ---------------------------------------------------------------------- #
def _ids(batch=4, seq=32, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)


def test_mixtral_config_takes_the_jax_fields():
    jcfg = JMixtralConfig.mixtral_8x7b()
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = MixtralConfig(**fields)
    assert cfg.router_aux_loss_coef == 0.02
    assert cfg.moe_capacity_factor == 1.25
    assert dataclasses.asdict(cfg).keys() == dataclasses.asdict(jcfg).keys()


def test_mixtral_matches_jax():
    """Logits, loss (cross entropy + 0.02 mean l_aux) and the gradient of
    every parameter at ``MixtralConfig.tiny`` (capacity top-2)."""
    ids = _ids()
    jmodel = JMixtral(JMixtralConfig.tiny(dtype=jnp.float32))
    params = _np(jax.jit(jmodel.init)(jax.random.key(2),
                                      jnp.asarray(ids))["params"])
    want_logits = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids))
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, ids, ids)))(params)

    tmodel = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32),
                                device="cpu")
    tmodel.load_state_dict(mixtral_state_dict_from_flax(params, "cpu"))
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        _close(tmodel(tids).numpy(), want_logits, TOL, "logits")
    loss = tmodel(tids, tids)
    loss.backward()
    _close(loss.item(), want_loss, TOL, "loss")
    got_g = flax_params_from_mixtral_state_dict(
        {n: p.grad for n, p in tmodel.named_parameters()})
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(_np(want_g)),
            jax.tree_util.tree_leaves(got_g)):
        _close(got, want, GRAD_TOL, jax.tree_util.keystr(path))


class _JDroplessBlock(fnn.Module):
    """MixtralBlock with its MoE dropless, from the JAX package's parts."""
    config: JMixtralConfig

    @fnn.compact
    def __call__(self, x, positions):
        cfg = self.config
        a, _ = JLlamaAttention(cfg, name="self_attn")(
            JRMSNorm(cfg.rms_norm_eps, name="input_layernorm")(x), positions)
        x = x + a
        moe_out, l_aux = JMoE(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_experts=cfg.num_local_experts, k=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor,
            eval_capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
            dropless=True, name="block_sparse_moe")(
                JRMSNorm(cfg.rms_norm_eps,
                         name="post_attention_layernorm")(x))
        return x + moe_out, l_aux


class _JDroplessMixtral(fnn.Module):
    """MixtralForCausalLM with dropless MoE layers (same param tree)."""
    config: JMixtralConfig

    @fnn.compact
    def __call__(self, input_ids, labels=None):
        cfg = self.config
        b, s = input_ids.shape
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None],
                                     (b, s))
        x = fnn.Embed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                      param_dtype=jnp.float32, name="embed_tokens")(input_ids)
        aux_total = jnp.float32(0.0)
        for i in range(cfg.num_hidden_layers):
            x, l_aux = _JDroplessBlock(cfg, name=f"layers_{i}")(x, positions)
            aux_total = aux_total + l_aux
        x = JRMSNorm(cfg.rms_norm_eps, name="norm")(x)
        logits = fnn.Dense(cfg.vocab_size, use_bias=False, dtype=cfg.dtype,
                           param_dtype=jnp.float32, name="lm_head")(x)
        if labels is None:
            return logits
        return j_cross_entropy(logits, labels) + cfg.router_aux_loss_coef * \
            (aux_total / cfg.num_hidden_layers)


def _engine_config(micro_batch=4):
    return {"train_micro_batch_size_per_gpu": micro_batch,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 1},
            "gradient_clipping": 1.0,
            "attention_layout": "bshd"}


def _engines(jmodel, dropless):
    cfg = _engine_config()
    params = _np(jax.jit(jmodel.init)(jax.random.key(3),
                                      jnp.asarray(_ids()))["params"])
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=cfg, model_parameters=params,
        topology=groups.initialize_mesh(devices=jax.devices()[:1]))
    tmodel = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32),
                                device="cpu", dropless=dropless)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, config=cfg, device="cpu",
        model_parameters=mixtral_state_dict_from_flax(params, "cpu"))
    return jeng, teng


@pytest.mark.parametrize("dropless,steps", [(False, 20), (True, 5)],
                         ids=["capacity", "dropless"])
def test_mixtral_engine_steps_match_jax(dropless, steps):
    """``initialize`` -> engine steps of ``MixtralForCausalLM`` (capacity
    top-2; 20 steps) and of the same model with ``MoE(dropless=True)``
    layers (5 steps): every loss and the final fp32 masters."""
    jcfg = JMixtralConfig.tiny(dtype=jnp.float32)
    jmodel = _JDroplessMixtral(jcfg) if dropless else JMixtral(jcfg)
    jeng, teng = _engines(jmodel, dropless)
    ids = _ids(seed=5)
    for _ in range(steps):
        lj = jeng(ids, ids)
        jeng.backward(lj)
        jeng.step()
        lt = teng(ids, ids)
        teng.backward(lt)
        teng.step()
        lj, lt = float(jax.device_get(lj)), float(lt.detach())
        assert abs(lt - lj) <= GRAD_TOL * max(1.0, abs(lj)), (lt, lj)
    assert teng.global_steps == jeng.global_steps == steps
    want = jax.device_get(jeng.state["master"])
    got = flax_params_from_mixtral_state_dict(teng.module_state_dict())
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
