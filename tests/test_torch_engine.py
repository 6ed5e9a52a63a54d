"""The port's training engine against ``deepspeed_tpu.initialize`` on the
CPU, in f32 (bars: loss and parameters within 1e-4).

The JAX engine is built on a one-device mesh, so both engines see the same
global batch.  Weights start identical: Flax's init, carried across with
``llama_state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch.checkpoint import (flax_params_from_llama_state_dict,
                                            llama_state_dict_from_flax)
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from torch_port_common import single_process_env  # noqa: F401 (autouse)
from torch_port_common import tiny_geometry

TOL = 1e-4


def bench_config(micro_batch, gas=1, **extra):
    """bench.py:88-100 with bf16 off (the parity bar is f32)."""
    cfg = {"train_micro_batch_size_per_gpu": micro_batch,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
           "zero_optimization": {"stage": 1},
           "gradient_clipping": 1.0,
           "attention_layout": "bshd"}
    cfg.update(extra)
    return cfg


def _one_device():
    return groups.initialize_mesh(devices=jax.devices()[:1])


def _llama_pair(seed=0, **geom_kw):
    geom = tiny_geometry(**geom_kw)
    jmodel = JLlama(JLlamaConfig(**geom, dtype=jnp.float32))
    ids = np.zeros((1, 8), np.int32)
    params = jax.device_get(jmodel.init(jax.random.key(seed), ids))["params"]
    tmodel = LlamaForCausalLM(LlamaConfig(**geom, dtype=torch.float32),
                              device="cpu")
    return jmodel, tmodel, params


def _engines(cfg, seed=0):
    jmodel, tmodel, params = _llama_pair(seed)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=cfg, model_parameters=params,
        topology=_one_device())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, config=cfg, device="cpu",
        model_parameters=llama_state_dict_from_flax(params, device="cpu"))
    return jeng, teng


def _ids(batch, seq=64, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)


def _step(engine, ids):
    loss = engine(ids, ids)
    engine.backward(loss)
    engine.step()
    return float(loss.detach()) if isinstance(loss, torch.Tensor) \
        else float(loss)


def _assert_masters_close(jeng, teng, tol=TOL):
    want = jax.device_get(jeng.state["master"])
    got = flax_params_from_llama_state_dict(teng.module_state_dict())
    pairs = zip(jax.tree_util.tree_leaves_with_path(want),
                jax.tree_util.tree_leaves(got))
    for (path, a), b in pairs:
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_bench_config_20_steps_match():
    """20 steps of the bench ds_config at 2 layers: every loss and the
    final fp32 master weights."""
    cfg = bench_config(micro_batch=4)
    jeng, teng = _engines(cfg)
    ids = _ids(4)
    for _ in range(20):
        lj = _step(jeng, ids)
        lt = _step(teng, ids)
        assert abs(lt - lj) <= TOL * max(1.0, abs(lj)), (lt, lj)
    assert teng.global_steps == jeng.global_steps == 20
    _assert_masters_close(jeng, teng)


def test_gradient_accumulation_matches_double_batch():
    """gas=2 over two halves == gas=1 over the whole batch, and both match
    the JAX engine's gas=2 run."""
    ids = _ids(8, seed=3)
    jeng, teng2 = _engines(bench_config(micro_batch=4, gas=2))
    _, teng1 = _engines(bench_config(micro_batch=8))
    for half in (slice(0, 4), slice(4, 8)):
        _step(jeng, ids[half])
        _step(teng2, ids[half])
    _step(teng1, ids)
    assert teng2.global_steps == teng1.global_steps == 1
    _assert_masters_close(jeng, teng2)
    for a, b in zip(teng1.master, teng2.master):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-6)


def test_train_batch_matches():
    ids = _ids(8, seed=5).reshape(2, 4, 64)
    jeng, teng = _engines(bench_config(micro_batch=4, gas=2))
    for _ in range(2):
        lj = float(jeng.train_batch(batch=(ids, ids)))
        lt = float(teng.train_batch(batch=(torch.from_numpy(ids),) * 2))
        assert abs(lt - lj) <= TOL * max(1.0, abs(lj))
    _assert_masters_close(jeng, teng)


def test_clipping_active_matches():
    """A clip far below the gradient norm: the clip coefficient scales
    every update, and the reported norm is the unclipped one."""
    jeng, teng = _engines(bench_config(micro_batch=4, gradient_clipping=0.05,
                                       optimizer={"type": "SGD",
                                                  "params": {"lr": 0.1}}))
    ids = _ids(4, seed=9)
    for _ in range(3):
        _step(jeng, ids)
        _step(teng, ids)
        assert teng.get_global_grad_norm() > 0.05
    _assert_masters_close(jeng, teng)


# --------------------------------------------------------------------- #
# fp16 dynamic loss scaling, on the JAX package's SimpleModel
# --------------------------------------------------------------------- #
HIDDEN = 16


class SimpleModel(nn.Module):
    """tests/unit/simple_model.py ``SimpleModel`` (2 linear layers, tanh
    gelu between, MSE loss) with weights handed in."""

    def __init__(self, params):
        super().__init__()
        self.w = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(params[f"layer_{i}"][k])))
            for i in range(2) for k in ("kernel", "bias"))

    def forward(self, x, y):
        h = x
        for i in range(2):
            h = h @ self.w[2 * i].to(h.dtype) + self.w[2 * i + 1].to(h.dtype)
            if i == 0:
                h = F.gelu(h, approximate="tanh")
        return torch.mean(torch.square(h - y))


def _fp16_engines(**fp16):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent / "unit"))
    from simple_model import SimpleModel as JSimple

    cfg = {"train_micro_batch_size_per_gpu": 16,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": 0},
           "gradient_clipping": 1.0,
           "fp16": {"enabled": True, "initial_scale_power": 8, **fp16}}
    jm = JSimple(hidden_dim=HIDDEN)
    x = np.zeros((16, HIDDEN), np.float32)
    params = jax.device_get(jm.init(jax.random.key(0), x, x))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=(jm.init, jm.apply), config=cfg, model_parameters=params,
        topology=_one_device())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=SimpleModel(params), config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, HIDDEN)).astype(np.float32)
    y = rng.normal(size=(16, HIDDEN)).astype(np.float32)
    return jeng, teng, x, y


def _fp16_state(eng):
    if hasattr(eng, "state"):
        return (eng.get_loss_scale(), eng.skipped_steps,
                int(jax.device_get(eng.state["hysteresis"])))
    return eng.get_loss_scale(), eng.skipped_steps, eng.hysteresis


@pytest.mark.parametrize("sequence,fp16", [
    # test_engine.py::test_fp16_overflow_skips_step
    ("coo", {}),
    # test_engine.py::test_fp16_hysteresis_refill_on_growth
    ("cocco", {"hysteresis": 2, "loss_scale_window": 2}),
    # consecutive hysteresis refills on every clean step
    ("ococo", {"consecutive_hysteresis": True, "loss_scale_window": 3}),
])
def test_fp16_overflow_sequences_match(sequence, fp16):
    """Clean (c) and overflow (o: inputs of 1e30) steps: after each one the
    loss scale, skipped steps and hysteresis counter equal the JAX
    engine's; the masters too, so an overflow step left them alone."""
    jeng, teng, x, y = _fp16_engines(**fp16)
    bad = (np.full_like(x, 1e30), np.full_like(y, -1e30))
    for kind in sequence:
        args = (x, y) if kind == "c" else bad
        for eng in (jeng, teng):
            loss = eng(*args)
            eng.backward(loss)
            eng.step()
        assert _fp16_state(teng) == _fp16_state(jeng), kind
    master = jax.device_get(jeng.state["master"])
    want = [master[f"layer_{i}"][k] for i in range(2)
            for k in ("kernel", "bias")]
    for a, b in zip(want, [m.numpy() for m in teng.master]):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("key,value", [
    ("zero_optimization", {"stage": 2}),
    ("zero_optimization", {"stage": 3}),
    ("zero_optimization", {"stage": 1,
                           "offload_optimizer": {"device": "cpu"}}),
    ("zero_optimization", {"stage": 1, "zero_quantized_gradients": True}),
    ("optimizer", {"type": "OneBitAdam", "params": {"lr": 1e-3}}),
    ("pipeline", {"stages": 2}),
    ("train_batch_size", 64),     # 64 = 8 x 8: a world size of 8
])
def test_unported_config_keys_raise(key, value):
    cfg = bench_config(micro_batch=8)
    cfg[key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        DeepSpeedConfig(cfg).resolve_batch_size(
            8 if key == "train_batch_size" else 1)


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tmodel, _ = _llama_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=tmodel,
                                       config=bench_config(micro_batch=2))


def test_dataloader_feeds_the_engine_and_timers_record():
    """``initialize(training_data=...)``: a DeepSpeedDataLoader of micro
    batches, wrapped in a RepeatingLoader, driving ``train_batch``; with
    ``wall_clock_breakdown`` the timers record each phase."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    _, tmodel, params = _llama_pair()
    data = [(row, row) for row in _ids(6, seed=11)]
    cfg = bench_config(micro_batch=2, gas=2, wall_clock_breakdown=True,
                       steps_per_print=1)
    teng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tmodel, config=cfg, training_data=data, device="cpu",
        model_parameters=llama_state_dict_from_flax(params, device="cpu"))
    assert len(loader) == 3
    first = next(iter(loader))
    assert first[0].shape == (2, 64) and first[0].dtype == torch.int32
    it = RepeatingLoader(loader)
    losses = [float(teng.train_batch(data_iter=it)) for _ in range(3)]
    assert teng.global_steps == 3 and teng.micro_steps == 6
    assert all(np.isfinite(losses))
    assert teng.tput_timer.global_step_count == 3
    with pytest.raises(RuntimeError, match="backward"):
        teng.backward(torch.zeros(()))


def test_eval_mode_computes_without_stepping():
    _, teng = _engines(bench_config(micro_batch=2))
    ids = _ids(2)
    teng.eval()
    loss = teng(ids, ids)
    assert not loss.requires_grad and teng.micro_steps == 0
    teng.train()
    assert teng.get_lr() == [1e-4]
    assert teng.zero_optimization() and teng.zero_optimization_stage() == 1
