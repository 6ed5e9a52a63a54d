"""The port's grouped expert GEMM and dropless MoE FFN
(``deepspeed_tpu_torch/ops/grouped_gemm.py``) against the JAX package's on
the CPU: ``gmm_plain`` against the Pallas ``gmm`` run in interpret mode
(an empty group, a boundary m-tile shared by two groups, rows past the
groups) and against ``gmm_reference`` at an M that is not a multiple of the
tile (where the JAX package itself takes the reference); the router's
top-k with ties; ``grouped_moe_ffn`` whole.  Inputs are made with numpy
from a seed.  Bar: f32 <= 2e-5 (the indices exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import grouped_gemm as jgg
from deepspeed_tpu_torch.ops import grouped_gemm as tgg

TOL = 2e-5


def _inputs(seed, m, k, n, sizes):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), k, n))
           / np.sqrt(k)).astype(np.float32)
    return lhs, rhs, np.asarray(sizes, np.int32)


def _port_gmm(lhs, rhs, sizes):
    before = dict(tgg.LAUNCHES)
    out = tgg.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                  torch.from_numpy(sizes))
    assert tgg.LAUNCHES == before              # CPU tensors: plain version
    return out.numpy()


@pytest.mark.parametrize("sizes", [
    [20, 0, 30, 10],       # group 0 ends inside m-tile 1, which group 2
                           # shares; an empty group; 4 rows past the sum
    [0, 64, 0, 0],         # one group holds every row
    [0, 0, 0, 0],          # no rows at all: zeros
])
def test_gmm_plain_matches_pallas_interpret(sizes):
    lhs, rhs, gs = _inputs(0, 64, 32, 64, sizes)
    want = np.asarray(jgg.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(gs), 16, 32, True))
    got = _port_gmm(lhs, rhs, gs)
    assert np.abs(got - want).max() <= TOL
    assert np.all(got[sum(sizes):] == 0)


def test_gmm_plain_matches_reference_at_ragged_m():
    """M = 50 is no multiple of the JAX package's tile: it takes
    ``gmm_reference`` there; the port's kernel masks the edge instead."""
    lhs, rhs, gs = _inputs(1, 50, 24, 40, [7, 0, 19, 16, 3])
    want = np.asarray(jgg.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(gs), 16, 8, True))
    ref = np.asarray(jgg.gmm_reference(jnp.asarray(lhs), jnp.asarray(rhs),
                                       jnp.asarray(gs)))
    np.testing.assert_array_equal(want, ref)
    got = _port_gmm(lhs, rhs, gs)
    assert np.abs(got - ref).max() <= TOL
    assert np.all(got[45:] == 0)


def test_gmm_is_forward_only():
    lhs = torch.randn(8, 16, requires_grad=True)
    rhs = torch.randn(2, 16, 8)
    gs = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tgg.gmm(lhs, rhs, gs)
    with torch.no_grad():
        assert tgg.gmm(lhs, rhs, gs).shape == (8, 8)


def test_exact_topk_routing_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 8)).astype(np.float32)
    logits[0] = 0.0                             # all eight tied
    logits[1, [2, 5]] = 4.0                     # a tie for the top
    logits[2, [1, 3, 6]] = 3.0                  # a tie across the cut
    ji, jw = jgg.exact_topk_routing(jnp.asarray(logits), 2)
    ti, tw = tgg.exact_topk_routing(torch.from_numpy(logits), 2)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.abs(tw.numpy() - np.asarray(jw)).max() <= 1e-7


@pytest.mark.parametrize("t,e,k", [(64, 4, 2), (13, 8, 2)])
def test_grouped_moe_ffn_matches_jax(t, e, k):
    """(64, 4, 2): T*k = 128 rows run the Pallas gmm in interpret mode;
    (13, 8, 2): 26 rows, where the JAX package takes gmm_reference."""
    rng = np.random.default_rng(4)
    h, f = 32, 128
    x = rng.standard_normal((t, h)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    w_gate, w_up = (rng.standard_normal((e, h, f)).astype(np.float32)
                    / np.sqrt(h) for _ in range(2))
    w_down = rng.standard_normal((e, f, h)).astype(np.float32) / np.sqrt(f)
    topi, topw = jgg.exact_topk_routing(jnp.asarray(logits), k)
    want = np.asarray(jgg.grouped_moe_ffn(
        jnp.asarray(x), topi, topw, jnp.asarray(w_gate), jnp.asarray(w_up),
        jnp.asarray(w_down), interpret=True))
    got = tgg.grouped_moe_ffn(
        torch.from_numpy(x), torch.from_numpy(np.array(topi)),
        torch.from_numpy(np.array(topw)), torch.from_numpy(w_gate),
        torch.from_numpy(w_up), torch.from_numpy(w_down)).numpy()
    assert np.abs(got - want).max() <= TOL
