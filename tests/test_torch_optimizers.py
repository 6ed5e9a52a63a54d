"""Every optimizer of the port's registry against
``deepspeed_tpu.ops.optimizers``: 5 updates of fp32 masters from the same
numpy gradients and learning rates (bar: 1e-6 relative, 1e-7 absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.runtime.fp16.onebit  # noqa: F401  (registers 1-bit)
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.ops import optimizers as topt

SHAPES = [(16, 8), (8,), (3, 4, 5)]
# registered by the JAX package's fp16/onebit.py; not ported (ROADMAP A6)
ONEBIT = {"onebitadam", "onebitlamb", "zerooneadam"}


@pytest.mark.parametrize("name,params", [
    ("adam", {"lr": 1e-3}),
    ("adam", {"lr": 1e-3, "weight_decay": 0.1}),
    ("adamw", {"lr": 1e-3, "weight_decay": 0.1, "betas": (0.8, 0.99)}),
    ("fusedadam", {"lr": 1e-3, "bias_correction": False}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("fusedlamb", {"lr": 1e-2, "max_coeff": 0.5}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("fusedlion", {"lr": 1e-4}),
    ("sgd", {"lr": 0.1}),
    ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
    ("sgd", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
    ("adagrad", {"lr": 0.1, "weight_decay": 0.01}),
])
def test_five_updates_match(name, params):
    rng = np.random.default_rng(len(name) + len(params))
    master = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jdef = jopt.get_optimizer(name, params)
    tdef = topt.get_optimizer(name, params)
    assert tdef.name == jdef.name
    jmaster = [jnp.asarray(m) for m in master]
    jstate = jdef.init(jmaster)
    tmaster = [torch.from_numpy(m.copy()) for m in master]
    tstate = tdef.init(tmaster)
    for step in range(1, 6):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        lr = np.float32(params["lr"] * (1.0 - 0.1 * step))
        jmaster, jstate = jdef.update([jnp.asarray(g) for g in grads], jstate,
                                      jmaster, lr, jnp.int32(step))
        tdef.update([torch.from_numpy(g) for g in grads], tstate, tmaster,
                    float(lr), step)
    for want, got in zip(jmaster, tmaster):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    for key in jstate:
        for want, got in zip(jstate[key], tstate[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=key)


def test_registry_names_and_unknown():
    assert set(topt._REGISTRY) == set(jopt._REGISTRY) - ONEBIT
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.get_optimizer("nope", {})
    topt.register_optimizer("My_SGD", topt.sgd)
    assert topt.get_optimizer("mysgd", {"lr": 1.0}).name == "sgd"
    del topt._REGISTRY["mysgd"]
