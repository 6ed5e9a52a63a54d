"""The flash kernels' tile walk (``flash_tile_walk``, mirrored by
``csrc/flash_attention.cu``) and its arithmetic (``flash_attention_tiled_plain``)
on the CPU.

The walk is held to the visibility mask by brute force: every visible
(row, key) pair lies in exactly one visited tile, every visited tile holds
a visible pair, and a tile marked whole holds only visible, in-range pairs
(a walk that drops a tile, as the planted fault of the cuda tests does,
fails the first).  The arithmetic is held to the JAX package's Pallas
kernels in interpret mode, in f32: forward 2e-5, dK / dV 1e-4, max abs.
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

BLOCKS = [(64, 64), (128, 64), (128, 128), (64, 128), (32, 64)]
#: sq, sk, causal, window
WALK_SHAPES = [
    (200, 200, True, None),       # S not a multiple of the tile
    (333, 333, True, 17),         # a window narrower than a tile
    (300, 300, True, 1000),       # a window wider than S
    (130, 300, True, None),       # rectangular Sq < Sk
    (160, 700, True, 90),         # rectangular, windowed
    (1, 1, True, None),           # Sq = 1
    (1, 300, True, None),
    (1, 300, True, 5),
    (130, 300, False, None),      # non-causal
    (256, 256, True, 64),         # tile-aligned band
    (96, 64, True, None),         # Sq > Sk: rows that see nothing
]


def _visible(sq, sk, causal, window):
    r = np.arange(sq)[:, None] + (sk - sq)
    c = np.arange(sk)[None, :]
    if not causal:
        return np.ones((sq, sk), bool)
    keep = r >= c
    if window:
        keep &= c > r - window
    return keep


def _check_tiles(vis, tiles, what):
    """``tiles``: (rows, keys, whole) of every visited tile."""
    count = np.zeros(vis.shape, int)
    for rows, keys, whole in tiles:
        block = vis[rows, keys]
        assert block.any(), f"{what}: visited tile {rows} x {keys} sees nothing"
        count[rows, keys] += 1
        if whole:
            assert block.all() and block.shape == (
                rows.stop - rows.start, keys.stop - keys.start), (
                f"{what}: tile {rows} x {keys} marked whole")
    assert (count[vis] == 1).all(), f"{what}: a visible pair missed or doubled"


@pytest.mark.parametrize("block_q,block_k", BLOCKS)
@pytest.mark.parametrize("sq,sk,causal,window", WALK_SHAPES)
def test_tile_walk_covers_the_mask(sq, sk, causal, window, block_q, block_k):
    vis = _visible(sq, sk, causal, window)
    walk = tfa.flash_tile_walk(sq, sk, causal, window, block_q, block_k)

    q_tiles = []
    for r0, r1, begin, end, whole in walk["q"]:
        assert r1 == min(r0 + block_q, sq) and len(whole) == max(end - begin, 0)
        for j, w in zip(range(begin, end), whole):
            q_tiles.append((slice(r0, r1), slice(j * block_k,
                                                 min((j + 1) * block_k, sk)),
                            w))
    _check_tiles(vis, q_tiles, "forward / dQ walk")

    k_tiles = []
    for c0, c1, begin, end, whole in walk["k"]:
        assert c1 == min(c0 + block_k, sk) and len(whole) == max(end - begin, 0)
        for i, w in zip(range(begin, end), whole):
            k_tiles.append((slice(i * block_q, min((i + 1) * block_q, sq)),
                            slice(c0, c1), w))
    _check_tiles(vis, k_tiles, "dK/dV walk")

    # launch order: a permutation, and with a causal band and no window
    # the tiles that do the most work come first
    n_q, n_k = len(walk["q"]), len(walk["k"])
    assert sorted(walk["q_order"]) == list(range(n_q))
    assert sorted(walk["k_order"]) == list(range(n_k))
    if causal and not window:
        work = [walk["q"][i][3] - walk["q"][i][2] for i in walk["q_order"]]
        assert work == sorted(work, reverse=True)
        work = [walk["k"][j][3] - walk["k"][j][2] for j in walk["k_order"]]
        assert work == sorted(work, reverse=True)


def test_tile_walk_masks_only_edge_tiles():
    """At the bench shape (S 1024, causal) only the diagonal tiles pay the
    mask: one a q tile when the tiles are square."""
    walk = tfa.flash_tile_walk(1024, 1024, True, None, 128, 128)
    assert [len(w) - sum(w) for *_, w in walk["q"]] == [1] * 8
    assert [len(w) - sum(w) for *_, w in walk["k"]] == [1] * 8
    # a 128-row block (two warpgroups, the forward at D = 128) masks per
    # 64-row warpgroup: both visit the block's k tiles, each masking only
    # the ones that cross its own diagonal
    half = tfa.flash_tile_walk(1024, 1024, True, None, tfa.MASK_ROWS, 128)
    assert [len(w) - sum(w) for *_, w in half["q"]] == [1] * 16


def _inputs(b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, h, d))]


def _jax_block(n):
    return 128 if n % 128 == 0 else n


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window,blocks", [
    (2, 128, 128, 4, 4, 64, True, None, (128, 128)),     # causal MHA
    (1, 200, 200, 4, 2, 64, True, None, (128, 64)),      # tail, GQA 2
    (1, 256, 256, 4, 1, 128, True, 100, (64, 64)),       # window, GQA 4
    (1, 128, 256, 4, 2, 64, True, None, (128, 128)),     # rectangular
    (1, 130, 300, 2, 2, 128, True, 50, (64, 128)),       # rect + window, tails
    (2, 96, 160, 4, 2, 64, False, None, (64, 128)),      # non-causal
    (1, 72, 72, 2, 1, 128, True, 500, (128, 64)),        # window wider than S
])
def test_tiled_plain_matches_interpret_kernel(b, sq, sk, h, hkv, d, causal,
                                              window, blocks):
    """The tile walk's arithmetic (online softmax, exp2, tile masks, the
    dK/dV walk over the group) against the JAX Pallas kernels and their
    ``jax.vjp`` in interpret mode, f32."""
    q, k, v, do = _inputs(b, sq, sk, h, hkv, d, seed=sq + h + d)
    scale = d ** -0.5

    def jf(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   block_q=_jax_block(sq),
                                   block_k=_jax_block(sk), interpret=True)

    jo, vjp = jax.vjp(jf, q, k, v)
    _, jdk, jdv = vjp(jnp.asarray(do))
    qs = torch.from_numpy(q) * scale
    o, lse, dk, dv = tfa.flash_attention_tiled_plain(
        qs, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do),
        causal=causal, window=window, block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=FWD_TOL,
                               rtol=0)
    _, plse = tfa.flash_attention_plain_fwd(
        qs, torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        window=window)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=GRAD_TOL,
                               rtol=0, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=GRAD_TOL,
                               rtol=0, err_msg="dv")


def test_tiled_plain_rounds_like_the_dense_plain_version():
    """In bf16 the tiled walk rounds P and dS where the dense plain
    versions do: its o and dK/dV agree with theirs far inside the kernels'
    bars (3e-2 of the largest magnitude)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(2, 200, 200, 4, 2, 64, seed=3))
    qs = (q.float() * 0.125).to(torch.bfloat16)
    o, lse, dk, dv = tfa.flash_attention_tiled_plain(qs, k, v, do,
                                                     block_q=64, block_k=128)
    po, plse = tfa.flash_attention_plain_fwd(qs, k, v)
    _, pdelta = tfa.flash_attention_plain_bwd_dq(qs, k, v, po, do, plse,
                                                 scale=0.125)
    pdk, pdv = tfa.flash_attention_plain_bwd_dkv(qs, k, v, do, plse, pdelta)
    for got, want in ((o, po), (lse, plse), (dk, pdk), (dv, pdv)):
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max(), err


def test_kernel_tiles_walk_the_bench_shape():
    """Each launch's tiles (``KERNEL_TILES``) cover the bench model's causal
    mask at S = 1024 with one masked tile a block row on the diagonal, and
    launch as many blocks as the kernels do."""
    vis = _visible(1024, 1024, True, None)
    for d, tiles in tfa.KERNEL_TILES.items():
        for launch, (bq, bk) in tiles.items():
            walk = tfa.flash_tile_walk(1024, 1024, True, None, bq, bk)
            side = walk["k"] if launch == "bwd_dkv" else walk["q"]
            assert len(side) == 1024 // (bk if launch == "bwd_dkv" else bq)
            assert all(len(w) - sum(w) >= 1 for *_, w in side), (d, launch)
            _check_tiles(vis, [
                (slice(r0, r1), slice(j * bk, (j + 1) * bk), w)
                for r0, r1, b0, b1, ws in walk["q"]
                for j, w in zip(range(b0, b1), ws)], f"{d} {launch}")


def test_flash_variants_tool_edits_the_current_source():
    """``tools/flash_variants.py`` builds its variants by editing the kernel
    source: every edit still applies to it and changes it."""
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.tools import flash_variants as fv

    src = (_build.CSRC / "flash_attention.cu").read_text()
    for name, spec in fv.VARIANTS.items():
        assert fv.variant_source(src, spec) != src, name
