"""The port's grouped expert GEMM and dropless MoE FFN
(``deepspeed_tpu_torch/ops/grouped_gemm.py``) against the JAX package's on
the CPU: ``gmm_plain`` against the Pallas ``gmm`` run in interpret mode
(an empty group, a boundary m-tile shared by two groups, rows past the
groups) and against ``gmm_reference`` at an M that is not a multiple of the
tile (where the JAX package itself takes the reference); ``gmm``'s
gradients (the plain dlhs and drhs) against ``jax.vjp`` of the Pallas
``gmm``, whose backward runs the dlhs and drhs kernels in interpret mode;
the router's top-k with ties; ``grouped_moe_ffn`` whole, with its
gradients.  Inputs are made with numpy from a seed.  Bars: f32 forward
<= 2e-5 (the indices exactly), gradients <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import grouped_gemm as jgg
from deepspeed_tpu_torch.ops import grouped_gemm as tgg

TOL = 2e-5
GRAD_TOL = 1e-4


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


def _port_gmm_vjp(lhs, rhs, sizes, cot):
    """(out, dlhs, drhs) of the port's gmm on CPU tensors, with the launch
    counts unchanged (the plain versions ran)."""
    before = dict(tgg.LAUNCHES)
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = tgg.gmm(tl, tr, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(cot))
    assert tgg.LAUNCHES == before
    return out.detach().numpy(), tl.grad.numpy(), tr.grad.numpy()


@pytest.mark.parametrize("sizes", [
    [40, 0, 50, 30],       # an empty group, groups starting inside m-tiles
                           # 1 and 2 (tile 32), the total 8 rows short of M
    [17, 33, 0, 78],       # every row in a group, no boundary on a tile edge
    [0, 0, 0, 0],          # no rows at all: every gradient zero
])
def test_gmm_gradients_match_pallas_interpret(sizes):
    """jax.vjp of the Pallas gmm (M = N = 128, tiles 32 x 64) runs
    ``_gmm_dlhs_kernel`` and ``_gmm_drhs_kernel`` in interpret mode; the
    port's gradients are its plain dlhs and drhs."""
    lhs, rhs, gs = _inputs(5, 128, 64, 128, sizes)
    cot = np.random.default_rng(6).standard_normal((128, 128)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda a, b: jgg.gmm(a, b, jnp.asarray(gs), 32, 64,
                                            True),
                       jnp.asarray(lhs), jnp.asarray(rhs))
    want_dl, want_dr = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    got, got_dl, got_dr = _port_gmm_vjp(lhs, rhs, gs, cot)
    assert np.abs(got - np.asarray(out)).max() <= TOL
    assert np.abs(got_dl - want_dl).max() <= GRAD_TOL
    assert np.abs(got_dr - want_dr).max() <= GRAD_TOL
    total = sum(sizes)
    assert np.all(got_dl[total:] == 0)          # rows past the groups
    for e, size in enumerate(sizes):
        if size == 0:                           # an empty group
            assert np.all(got_dr[e] == 0)


def test_gmm_gradients_match_reference_at_ragged_m():
    """M = 50 is no multiple of the JAX package's tile: the gradient of
    ``gmm_reference`` (its path there) against the port's dlhs and drhs."""
    lhs, rhs, gs = _inputs(7, 50, 24, 40, [7, 0, 19, 16, 3])
    cot = np.random.default_rng(8).standard_normal((50, 40)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: jgg.gmm_reference(a, b, jnp.asarray(gs)),
                     jnp.asarray(lhs), jnp.asarray(rhs))
    want_dl, want_dr = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    _, got_dl, got_dr = _port_gmm_vjp(lhs, rhs, gs, cot)
    assert np.abs(got_dl - want_dl).max() <= GRAD_TOL
    assert np.abs(got_dr - want_dr).max() <= GRAD_TOL
    assert np.all(got_dl[45:] == 0) and np.all(got_dr[1] == 0)


def test_gmm_takes_no_gradient_it_is_not_asked_for():
    """Only the inputs that require a gradient get one; group_sizes never
    does; under no_grad nothing is recorded."""
    lhs = torch.randn(8, 16, requires_grad=True)
    rhs = torch.randn(2, 16, 8)
    gs = torch.tensor([3, 5], dtype=torch.int32)
    tgg.gmm(lhs, rhs, gs).sum().backward()
    assert lhs.grad is not None and rhs.grad is None
    with torch.no_grad():
        assert not tgg.gmm(lhs, rhs, gs).requires_grad


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


def _ffn_inputs(t, e, k, seed=4):
    rng = np.random.default_rng(seed)
    h, f = 32, 128
    x = rng.standard_normal((t, h)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    w_gate, w_up = (rng.standard_normal((e, h, f)).astype(np.float32)
                    / np.sqrt(h) for _ in range(2))
    w_down = rng.standard_normal((e, f, h)).astype(np.float32) / np.sqrt(f)
    topi, topw = jgg.exact_topk_routing(jnp.asarray(logits), k)
    return x, np.array(topi), np.array(topw), w_gate, w_up, w_down


@pytest.mark.parametrize("t,e,k", [(64, 4, 2), (13, 8, 2)])
def test_grouped_moe_ffn_matches_jax(t, e, k):
    """(64, 4, 2): T*k = 128 rows run the Pallas gmm in interpret mode;
    (13, 8, 2): 26 rows, where the JAX package takes gmm_reference."""
    x, topi, topw, w_gate, w_up, w_down = _ffn_inputs(t, e, k)
    want = np.asarray(jgg.grouped_moe_ffn(
        jnp.asarray(x), jnp.asarray(topi), jnp.asarray(topw),
        jnp.asarray(w_gate), jnp.asarray(w_up), jnp.asarray(w_down),
        interpret=True))
    got = tgg.grouped_moe_ffn(
        torch.from_numpy(x), torch.from_numpy(topi), torch.from_numpy(topw),
        torch.from_numpy(w_gate), torch.from_numpy(w_up),
        torch.from_numpy(w_down)).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("t,e,k", [(64, 4, 2), (13, 8, 2)])
def test_grouped_moe_ffn_gradients_match_jax(t, e, k):
    """Gradients with respect to x, topw and the three expert weights, the
    JAX side through the Pallas gmm's custom VJP in interpret mode at
    T*k = 128 rows (the dlhs and drhs kernels), through gmm_reference's
    at 26."""
    x, topi, topw, w_gate, w_up, w_down = _ffn_inputs(t, e, k, seed=9)
    cot = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    diff = (x, topw, w_gate, w_up, w_down)
    _, vjp = jax.vjp(
        lambda x_, tw, wg, wu, wd: jgg.grouped_moe_ffn(
            x_, jnp.asarray(topi), tw, wg, wu, wd, interpret=True),
        *(jnp.asarray(a) for a in diff))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ins = [torch.from_numpy(a).requires_grad_() for a in diff]
    out = tgg.grouped_moe_ffn(ins[0], torch.from_numpy(topi), *ins[1:])
    out.backward(torch.from_numpy(cot))
    for name, t_in, w in zip(("x", "topw", "w_gate", "w_up", "w_down"),
                             ins, want):
        assert np.abs(t_in.grad.numpy() - w).max() <= GRAD_TOL, name
