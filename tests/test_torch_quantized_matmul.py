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


@pytest.mark.parametrize("m,k,n,want", [
    # skinny path: one block an SM over the 512-column blocks, >= 64 rows
    (8, 4096, 4096, 16), (1, 4096, 32000, 2), (8, 128, 4096, 2),
    # tiled path, 64-row tiles at medium M: 32 tiles of 128 columns at
    # N = 4096 fill a quarter of 132 SMs, so K splits in 4
    (16, 4096, 4096, 4), (40, 4096, 4096, 4), (64, 4096, 4096, 4),
    (40, 11008, 4096, 4), (40, 4096, 11008, 1), (40, 4096, 32000, 1),
    # 128-row tiles up to M = 128 (and where 256-row tiles take no fewer
    # waves), 256-row tiles at M = 1024 and the 32000-column lm_head
    (65, 4096, 4096, 4), (128, 4096, 4096, 4), (129, 4096, 4096, 2),
    (512, 4096, 4096, 1), (1024, 4096, 4096, 1), (512, 11008, 4096, 1),
    (512, 4096, 11008, 1), (512, 4096, 32000, 1),
    # at least 4 k-tiles of 64 rows a split
    (40, 256, 4096, 1), (40, 512, 4096, 2), (70, 1024, 4112, 4)])
def test_tiled_route_and_k_splits(m, k, n, want):
    """The launch geometry the wrapper hands the kernel (132 SMs, an
    H100's count): skinny below M = 9, then the tiled path's rows a block
    and split-K."""
    assert tqm.k_splits_for(m, k, n, 132) == want
    if m > 8:
        rows = tqm.tiled_rows(m, n, 132)
        assert rows == (64 if m <= 64 else 256 if (m, n) in (
            (1024, 4096), (512, 32000)) else 128)
        splits = want
        k_tiles = -(-k // 64)
        per = -(-k_tiles // splits)
        assert -(-k_tiles // per) <= splits       # partials the kernel fills


@pytest.mark.parametrize("groups", [64, 43])
def test_plain_matches_jax_group_boundary_inside_k_tile(groups):
    """K = 11008 over 64 groups (from_hf's), 172 rows a group, and 43
    groups of 256 rows: group boundaries fall inside the tiled kernel's
    64-row k-tiles, where the scale is looked up per k row.  The plain
    version (the kernel's CPU path) against the JAX package's
    ``dequant_reference`` product."""
    k, n, m = 11008, 48, 3
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.random(groups) * 0.5 + 0.75)
             / (73.3 * np.sqrt(k))).astype(np.float32)
    jrec = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    want = _to_np(jnp.asarray(x) @ jqm.dequant_reference(jrec, jnp.float32))
    got = tqm.quantized_matmul(torch.from_numpy(x),
                               {"q": torch.from_numpy(q),
                                "scale": torch.from_numpy(scale)})
    assert np.abs(got.numpy() - want).max() <= 2e-5
