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
@pytest.mark.parametrize("m", [1, 2, 8, 64])
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


#: the skinny kernel's clusters of c blocks an H100 holds at once, c = 2
#: .. 8, as its occupancy query reports them (resident_clusters)
H100_RESIDENT = ((2, 66), (3, 39), (4, 30), (5, 22), (6, 17), (7, 15), (8, 15))


@pytest.mark.parametrize("m,k,n,want", [
    # skinny path: the cluster of blocks each 128-column tile's K is cut
    # over (skinny_plan, an H100's resident clusters): 3 at 4096 x 4096,
    # none for the 250-tile lm_head or a K within one 256-row unit
    (8, 4096, 4096, 3), (1, 4096, 32000, 1), (8, 128, 4096, 1),
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
    H100's count): skinny below M = 9 (the cluster a tile's K is cut
    over), then the tiled path's rows a block and split-K."""
    if m <= 8:
        assert tqm.skinny_plan(k, n, H100_RESIDENT)["cluster"] == want
    else:
        assert tqm.k_splits_for(m, k, n, 132) == want
        rows = tqm.tiled_rows(m, n, 132)
        assert rows == (64 if m <= 64 else 256 if (m, n) in (
            (1024, 4096), (512, 32000)) else 128)
        splits = want
        k_tiles = -(-k // 64)
        per = -(-k_tiles // splits)
        assert -(-k_tiles // per) <= splits       # partials the kernel fills


@pytest.mark.parametrize("k,n,tiles,cluster,run", [
    # Llama-2-7B's four projection shapes: q/k/v/o, gate/up, down, lm_head
    (4096, 4096, 32, 3, (5, 6)), (4096, 11008, 86, 1, (16, 16)),
    (11008, 4096, 32, 3, (14, 15)), (4096, 32000, 250, 1, (16, 16))])
def test_skinny_plan_fills_the_sms(k, n, tiles, cluster, run):
    """The skinny path's launch on an H100 (132 SMs, its resident
    clusters) at the four projection shapes: column tiles of 128, each cut
    along K over a cluster of c blocks, c the most (up to 8) for which
    every cluster of the launch is resident at once; the blocks of a
    cluster walk runs of 256-row units within one unit of each other and
    together every unit of the tile once."""
    plan = tqm.skinny_plan(k, n, H100_RESIDENT)
    assert (plan["tiles"], plan["cluster"], plan["run"]) == (tiles, cluster,
                                                             run)
    assert plan["blocks"] == tiles * cluster <= 132 or cluster == 1
    assert plan["chunks"] == -(-k // 256)
    # the kernel's runs (csrc/quantized_matmul.cu: rank r of c walks units
    # [r chunks / c, (r + 1) chunks / c))
    chunks = plan["chunks"]
    runs = [(r * chunks // cluster, (r + 1) * chunks // cluster)
            for r in range(cluster)]
    assert [u for a, b in runs for u in range(a, b)] == list(range(chunks))
    assert {b - a for a, b in runs} <= set(range(run[0], run[1] + 1))
    # one more block a tile would not keep every cluster resident
    assert (cluster == 8 or tiles > dict(H100_RESIDENT)[cluster + 1]
            or chunks == cluster)


def test_skinny_plan_takes_the_clusters_the_device_holds():
    """The cluster follows the device's resident counts, not its SMs: with
    one block an SM (132 // c clusters of c), 4096 x 4096's 32 tiles would
    take clusters of 4 (128 blocks); an H100 holds 30 clusters of 4 (its
    SMs are grouped, and a cluster's blocks share a group), so they take
    clusters of 3 (96 blocks); with no cluster resident, a block a
    tile."""
    per_sm = tuple((c, 132 // c) for c in range(2, 9))
    plan = tqm.skinny_plan(4096, 4096, per_sm)
    assert (plan["cluster"], plan["blocks"], plan["run"]) == (4, 128, (4, 4))
    plan = tqm.skinny_plan(4096, 4096, H100_RESIDENT)
    assert (plan["cluster"], plan["blocks"], plan["run"]) == (3, 96, (5, 6))
    plan = tqm.skinny_plan(4096, 4096, tuple((c, 0) for c in range(2, 9)))
    assert (plan["cluster"], plan["blocks"]) == (1, 32)


def test_skinny_plan_small_k_and_ragged_n():
    """K within one 256-row unit gives a block a tile (no cluster, the
    part stored straight from the block); a ragged N of 4112 takes one
    more tile."""
    for k, n in ((128, 4096), (32, 4112), (96, 256)):
        plan = tqm.skinny_plan(k, n, H100_RESIDENT)
        assert plan["chunks"] == 1 and plan["cluster"] == 1
        assert plan["blocks"] == plan["tiles"] == -(-n // 128)
    assert tqm.skinny_plan(1024, 4112, H100_RESIDENT)["tiles"] == 33


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
