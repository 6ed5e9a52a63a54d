"""The port's int8-weight matmul (``deepspeed_tpu_torch/ops/
quantized_matmul.py``) against the JAX package's: the plain PyTorch
version runs on the CPU and is held against JAX ``quantized_matmul`` with
its Pallas kernel in interpret mode (N = 256, a tileable shape) or its XLA
composition (N = 200, not a multiple of the 256-column tile), and against
``dequant_reference``.  Bars: f32 <= 2e-5, bf16 <= 2e-2 max abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantized_matmul as tqm

K = 512


def _inputs(m, n, groups, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, n)).astype(np.int8)
    # weights of std ~1/sqrt(K), as the served model's records have
    scale = ((rng.random(groups) * 0.5 + 0.75)
             / (73.3 * np.sqrt(K))).astype(np.float32)
    return x, q, scale


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_plain_matches_jax(m, groups, n, dtype):
    x, q, scale = _inputs(m, n, groups, seed=m * 100 + groups + n)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jrec = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    jx = jnp.asarray(x, jdt)
    want = _to_np(jqm.quantized_matmul(jx, jrec, interpret=True))
    want_ref = _to_np(jx @ jqm.dequant_reference(jrec, jdt))
    trec = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
    tx = torch.from_numpy(x).to(tdt)
    launches = tqm.LAUNCHES["quantized_matmul"]
    got = tqm.quantized_matmul(tx, trec)
    assert got.dtype == tdt and got.shape == (m, n)
    assert tqm.LAUNCHES["quantized_matmul"] == launches   # CPU: plain path
    got = got.float().numpy()
    tol = 2e-5 if dtype == "f32" else 2e-2
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - want_ref).max() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_reference_matches_jax(dtype):
    _, q, scale = _inputs(1, 200, 4, seed=3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _to_np(jqm.dequant_reference(
        {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}, jdt))
    got = tqm.dequant_reference(
        {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_record_predicate_and_qmm_dense():
    q = torch.zeros((4, 4), dtype=torch.int8)
    assert tqm.is_quant_record({"q": q, "scale": torch.ones(1)})
    assert not tqm.is_quant_record({"q": q.float(), "scale": torch.ones(1)})
    assert not tqm.is_quant_record({"q": q, "scale": torch.ones(1), "b": 1})
    w = torch.randn(4, 3, dtype=torch.float64)
    x = torch.randn(2, 4)
    torch.testing.assert_close(tqm.qmm(x, w, torch.float32),
                               x @ w.float())
