"""The grouped-GEMM wgmma kernel's tile walk (``gmm_tile_walk``, mirrored
by ``gmm_wgmma_kernel`` in ``csrc/grouped_gemm.cu``) and its arithmetic
(``gmm_fwd_tiled_plain``, ``gmm_dlhs_tiled_plain`` /
``gmm_drhs_tiled_plain``) on the CPU.

The walk is held by brute force: every output element is written by
exactly one forward or dlhs unit or drhs tile, and in the launch order
exactly once; a forward or dlhs row is written with its own group's
product, or as zeros past the groups; a warpgroup's rows stored whole by
TMA hold only rows its unit owns;
every row of a group is summed once into its own group's drhs and never
into another's (the rows of the next group in the last chunk are the
zeroed tail); an empty group and M = 0 give zeros.  The arithmetic is held
to the JAX package's ``_gmm_kernel``, ``_gmm_dlhs_kernel`` and
``_gmm_drhs_kernel`` in interpret mode, in f32, at 1e-4 max abs.  Inputs are made with numpy from a
seed: ragged sizes, an empty group, rows past the sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import grouped_gemm as jgg
from deepspeed_tpu_torch.ops import grouped_gemm as tgg

TOL = 1e-4

#: small tiles that put several units, boundaries and chunks in a small
#: shape, and the kernels' own
SMALL = {"bm": 32, "bn": 32, "bk": 16, "band": 2}
TILES = [SMALL, {"bm": 16, "bn": 64, "bk": 8, "band": 3, "by_work": False,
                 "n_fast": 1}, {}]
#: the forward's: the above (the kernel's own: 128-row units in bands of
#: 8), 64-row units with several n-tiles, and 128-row units in bands of 16
#: (dlhs's band)
FWD_TILES = TILES + [{"bm": 64, "bn": 64, "band": 2}, {"band": 16}]
FWD_IDS = ["small", "narrow", "kernel", "rows64", "band16"]

#: m, k, n, group sizes
WALK_SHAPES = [
    (128, 64, 128, [40, 0, 50, 30]),     # an empty group, 8 rows past the sum
    (128, 72, 40, [17, 33, 0, 78]),      # every row in a group, K and N edges
    (100, 64, 96, [10, 0, 33, 40, 0, 0, 7, 0]),   # ragged M, 10 rows past
    (300, 48, 24, [0, 300, 0]),          # one group holds every row
    (64, 32, 32, [0, 0, 0, 0]),          # no rows in any group: zeros
    (0, 32, 32, [0, 0]),                 # M = 0
    (256, 40, 56, [3, 200, 1, 0, 52]),   # a skewed group and tiny ones
]


def _starts(sizes, m):
    out, start = [], 0
    for size in sizes:
        end = min(start + max(size, 0), m)
        out.append((start, end))
        start = end
    return out


@pytest.mark.parametrize("tiles", TILES, ids=["small", "narrow", "kernel"])
@pytest.mark.parametrize("m,k,n,sizes", WALK_SHAPES)
def test_dlhs_walk_writes_every_element_once(m, k, n, sizes, tiles):
    t = dict(tgg.GRAD_TILES, **tiles)
    walk = tgg.gmm_tile_walk(sizes, m, k, n, tiles)
    units = walk["units"]
    nt = -(-k // t["bn"])
    assert sorted(walk["dlhs_order"]) == [(w, j) for w in range(len(units))
                                          for j in range(nt)]
    group_of = np.full(m, -1)
    for g, (start, end) in enumerate(_starts(sizes, m)):
        group_of[start:end] = g
    count = np.zeros((m, k), int)
    prod = np.zeros((m, k), int)
    for w, j in walk["dlhs_order"]:
        group, m_tile, lo, hi, zlo, zhi = units[w]
        cols = slice(j * t["bn"], min(j * t["bn"] + t["bn"], k))
        for r in range(m_tile * t["bm"], min(m_tile * t["bm"] + t["bm"], m)):
            if lo <= r < hi:
                assert group_of[r] == group >= 0, (w, r)
                count[r, cols] += 1
                prod[r, cols] += 1
            elif zlo <= r < zhi:
                assert group_of[r] == -1, (w, r)     # zeros only past the sum
                count[r, cols] += 1
    assert (count == 1).all()
    assert (prod[group_of >= 0] == 1).all() and (prod[group_of < 0] == 0).all()
    for (group, m_tile, lo, hi, zlo, zhi), halves in zip(units,
                                                         walk["dlhs_stores"]):
        for r0, r1, by_tma in halves:
            mine = [lo <= r < hi or zlo <= r < zhi for r in range(r0, r1)]
            assert by_tma == all(mine)


@pytest.mark.parametrize("tiles", TILES, ids=["small", "narrow", "kernel"])
@pytest.mark.parametrize("m,k,n,sizes", WALK_SHAPES)
def test_drhs_walk_sums_each_row_once_into_its_group(m, k, n, sizes, tiles):
    t = dict(tgg.GRAD_TILES, **tiles)
    walk = tgg.gmm_tile_walk(sizes, m, k, n, tiles)
    kt, nt = -(-k // t["bm"]), -(-n // t["bn"])
    order = walk["drhs_order"]
    assert sorted(order) == [(g, a, b) for g in range(len(sizes))
                             for a in range(kt) for b in range(nt)]
    count = np.zeros((len(sizes), k, n), int)
    for g, a, b in order:
        count[g, a * t["bm"]:(a + 1) * t["bm"], b * t["bn"]:(b + 1) * t["bn"]] += 1
    assert (count == 1).all()
    # within a group, the tile of the shorter of K and N changes fastest
    n_fast = t["n_fast"] == 1 or (t["n_fast"] == 2 and n < k)
    for i in range(0, len(order), kt * nt):
        g = order[i][0]
        assert order[i:i + kt * nt] == (
            [(g, a, b) for a in range(kt) for b in range(nt)] if n_fast
            else [(g, a, b) for b in range(nt) for a in range(kt)])
    first = [order[i][0] for i in range(0, len(order), kt * nt)]
    spans = _starts(sizes, m)
    if t["by_work"]:                  # the larger group first, ties by index
        assert first == sorted(range(len(sizes)),
                               key=lambda g: (spans[g][0] - spans[g][1], g))
    else:
        assert first == list(range(len(sizes)))
    for g, (start, end, chunks, tail) in enumerate(walk["groups"]):
        assert (start, end) == spans[g]
        summed = np.zeros(max(m, 1) + t["bk"], int)
        for r0, r1 in chunks:
            assert r1 - r0 == t["bk"]
            summed[r0:min(r1, end)] += 1
        assert (summed[start:end] == 1).all()
        assert summed[:start].sum() == 0 and summed[end:].sum() == 0
        if start == end:
            assert chunks == [] and tail is None
        else:
            assert tail == (end, chunks[-1][1]) and chunks[0][0] == start


@pytest.mark.parametrize("tiles", FWD_TILES, ids=FWD_IDS)
@pytest.mark.parametrize("m,k,n,sizes", WALK_SHAPES)
def test_fwd_walk_writes_every_element_once(m, k, n, sizes, tiles):
    """The forward's (unit, n-tile) pairs cover every unit and n-tile once,
    a band's units changing fastest; each warpgroup's stores write every
    element of the output once: a row in a group with its own group's
    product, a row past the groups as zeros, and a TMA store only where
    every row is its unit's."""
    f = dict(tgg.FWD_TILES, **tiles)
    walk = tgg.gmm_tile_walk(sizes, m, k, n, fwd_tiles=tiles)
    units = walk["fwd_units"]
    assert len(units) == -(-m // f["bm"]) + len(sizes) - 1
    nt = -(-n // f["bn"])
    order = walk["fwd_order"]
    assert sorted(order) == [(w, j) for w in range(len(units))
                             for j in range(nt)]
    # within a band the units change fastest: a group's units at one n-tile
    # run side by side
    for b0 in range(0, len(units), f["band"]):
        width = min(f["band"], len(units) - b0)
        assert order[b0 * nt:(b0 + width) * nt] == [
            (b0 + i % width, i // width) for i in range(width * nt)]
    group_of = np.full(m, -1)
    for g, (start, end) in enumerate(_starts(sizes, m)):
        group_of[start:end] = g
    count = np.zeros((m, n), int)
    prod = np.zeros((m, n), int)
    for w, j in order:
        group, m_tile, lo, hi, zlo, zhi = units[w]
        halves = walk["fwd_stores"][w]
        # the halves cover the unit's rows below M once
        assert [r for r0, r1, _ in halves for r in range(r0, r1)] == list(
            range(m_tile * f["bm"], min(m_tile * f["bm"] + f["bm"], m)))
        cols = slice(j * f["bn"], min(j * f["bn"] + f["bn"], n))
        for r0, r1, by_tma in halves:
            assert r1 - r0 <= f["bm"] // 2
            assert by_tma == all(lo <= r < hi or zlo <= r < zhi
                                 for r in range(r0, r1))
            for r in range(r0, r1):
                if group >= 0 and lo <= r < hi:
                    assert group_of[r] == group, (w, r)
                    count[r, cols] += 1
                    prod[r, cols] += 1
                elif by_tma or zlo <= r < zhi:
                    assert group_of[r] == -1, (w, r)     # zeros past the sum
                    count[r, cols] += 1
    assert (count == 1).all()
    assert (prod[group_of >= 0] == 1).all() and (prod[group_of < 0] == 0).all()


def _inputs(seed, m, k, n, sizes):
    rng = np.random.default_rng(seed)
    dout = rng.standard_normal((m, n)).astype(np.float32)
    rhs = (rng.standard_normal((len(sizes), k, n))
           / np.sqrt(n)).astype(np.float32)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    return lhs, dout, rhs, np.asarray(sizes, np.int32)


#: shapes the JAX kernels take (M % tile_m == 0, N % tile_n == 0): m, k, n,
#: sizes, the JAX package's tile_m and tile_n
JAX_CASES = [
    (128, 64, 128, [40, 0, 50, 30], 32, 64),     # empty group, rows past
    (128, 48, 64, [17, 33, 0, 78], 32, 32),      # every row in a group
    (96, 40, 64, [5, 0, 60, 0, 11, 0], 16, 32),  # ragged, 20 rows past
]


@pytest.mark.parametrize("tiles", TILES, ids=["small", "narrow", "kernel"])
@pytest.mark.parametrize("m,k,n,sizes,tm,tn", JAX_CASES)
def test_tiled_plain_matches_pallas_interpret(m, k, n, sizes, tm, tn, tiles):
    """The walk's arithmetic (each tile as the kernels form it, the drhs
    tail masked in lhs) against the Pallas dlhs and drhs kernels in
    interpret mode; every element written (no NaN left), rows past the
    groups and empty groups exact zeros."""
    lhs, dout, rhs, gs = _inputs(m + k + n, m, k, n, sizes)
    want_dl = np.asarray(jgg._gmm_dlhs_kernel_call(
        jnp.asarray(dout), jnp.asarray(rhs), jnp.asarray(gs), tm, tn, True))
    want_dr = np.asarray(jgg._gmm_drhs_kernel_call(
        jnp.asarray(lhs), jnp.asarray(dout), jnp.asarray(gs), tm, tn, True))
    got_dl = tgg.gmm_dlhs_tiled_plain(torch.from_numpy(dout),
                                      torch.from_numpy(rhs),
                                      torch.from_numpy(gs), tiles).numpy()
    got_dr = tgg.gmm_drhs_tiled_plain(torch.from_numpy(lhs),
                                      torch.from_numpy(dout),
                                      torch.from_numpy(gs), tiles).numpy()
    assert np.isfinite(got_dl).all() and np.isfinite(got_dr).all()
    assert np.abs(got_dl - want_dl).max() <= TOL
    assert np.abs(got_dr - want_dr).max() <= TOL
    total = sum(sizes)
    assert np.all(got_dl[total:] == 0)
    for e, size in enumerate(sizes):
        if size == 0:
            assert np.all(got_dr[e] == 0)


@pytest.mark.parametrize("tiles", FWD_TILES, ids=FWD_IDS)
@pytest.mark.parametrize("m,k,n,sizes,tm,tn", JAX_CASES)
def test_fwd_tiled_plain_matches_pallas_interpret(m, k, n, sizes, tm, tn,
                                                  tiles):
    """The forward's walk (each unit multiplying its whole m-tile, each
    warpgroup storing as the kernel stores) against the Pallas forward
    kernel in interpret mode; every element written (no NaN left), rows
    past the groups exact zeros."""
    lhs, _, rhs, gs = _inputs(m + k + n + 1, m, k, n, sizes)
    want = np.asarray(jgg._gmm_fwd_kernel_call(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs), tm, tn, True))
    got = tgg.gmm_fwd_tiled_plain(torch.from_numpy(lhs),
                                  torch.from_numpy(rhs),
                                  torch.from_numpy(gs), tiles).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL
    assert np.all(got[sum(sizes):] == 0)


def test_tiled_plain_at_m0_and_past_m():
    """M = 0: drhs of every group zeros (dlhs has no rows); group sizes
    that sum past M are clamped to M as the kernels clamp them."""
    lhs = torch.zeros((0, 24))
    dout = torch.zeros((0, 16))
    got = tgg.gmm_drhs_tiled_plain(lhs, dout, torch.tensor([0, 0, 0]), SMALL)
    assert got.shape == (3, 24, 16) and (got == 0).all()
    l2, d2, r2, _ = _inputs(3, 40, 24, 16, [0, 0])
    gs = torch.tensor([30, 25], dtype=torch.int32)          # 55 > 40 rows
    l2, d2, r2 = (torch.from_numpy(a) for a in (l2, d2, r2))
    for tiles in (SMALL, {}):
        assert torch.allclose(tgg.gmm_fwd_tiled_plain(l2, r2, gs, tiles),
                              tgg.gmm_plain(l2, r2, gs), atol=TOL)
        assert torch.allclose(tgg.gmm_drhs_tiled_plain(l2, d2, gs, tiles),
                              tgg.gmm_drhs_plain(l2, d2, gs), atol=TOL)
        assert torch.allclose(tgg.gmm_dlhs_tiled_plain(d2, r2, gs, tiles),
                              tgg.gmm_dlhs_plain(d2, r2, gs), atol=TOL)
