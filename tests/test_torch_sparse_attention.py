"""Block-sparse attention in the port against the JAX package on the CPU.

* every ``SparsityConfig`` layout bit-equal to JAX's, over several parameter
  sets and seeds (the random ones draw the same ``default_rng`` sequence);
* ``sparse_self_attention`` (the dense-masked composition) in both
  key-padding modes, f32, within 2e-5;
* ``block_sparse_attention`` (CPU tensors: the kernels' plain versions)
  against JAX's ``block_sparse_attention`` with its Pallas kernels in
  interpret mode, forward within 2e-5 and gradients within rtol 2e-4 /
  atol 2e-5 (the JAX package's own bars, ``tests/unit/test_ops_kernels.py``),
  at h 2, s 256, d 32, block 16 and tiles 64, and at S = 1040 (a tail tile
  for the kernels' 64-row tiles);
* the block layout the port's ``BlockSparseLayout`` holds equal to the one
  JAX's tile-major cells hold;
* a key-padding mask, both modes, through the kernels' plain versions (the
  key bias) against JAX's dense composition, forward and gradients;
* the kernels' host tables (live-tile lists and 16 x 16 sub-block masks,
  both orientations) cover exactly the layout's cells, no more and no less,
  and ``tiles_skipped`` counts the kernels' dead 64 x 64 tiles;
* the routing rules of ``SparseSelfAttention``;
* a row that keeps no key gives zeros (and zero gradients), as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import block_sparse_attention as jbsa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5

#: (config class name, keyword arguments) — JAX and the port take the same
LAYOUTS = [
    ("DenseSparsityConfig", dict()),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_local_blocks=4,
                                 attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_local_blocks=3, num_global_blocks=2,
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2)),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    local_window_blocks=[4],
                                    global_block_indices=[0])),
    ("VariableSparsityConfig", dict(num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[1, 5],
                                    global_block_end_indices=[2, 7],
                                    different_layout_per_head=True,
                                    horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1)),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2,
                                   num_sliding_window_blocks=5,
                                   num_global_blocks=2,
                                   different_layout_per_head=True)),
    ("BigBirdSparsityConfig", dict(attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[0])),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=5,
                                        global_block_indices=[2, 9],
                                        global_block_end_indices=[4, 10],
                                        attention="unidirectional")),
]
_IDS = [f"{name[:-14]}{i}" for i, (name, _) in enumerate(LAYOUTS)]


def _configs(name, kw, heads, block, seed=None):
    extra = {} if seed is None else {"seed": seed}
    return (getattr(jsa, name)(heads, block, **kw, **extra),
            getattr(tsa, name)(heads, block, **kw, **extra))


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=_IDS)
def test_layouts_bit_equal_to_jax(name, kw):
    seeded = name in ("VariableSparsityConfig", "BigBirdSparsityConfig")
    for seed in ((0, 7) if seeded else (None,)):
        for heads, block, s in ((3, 16, 256), (2, 32, 640)):
            jc, tc = _configs(name, kw, heads, block, seed)
            # twice: the random layouts advance their generator per call
            for _ in range(2):
                want, got = jc.make_layout(s), tc.make_layout(s)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert (got == want).all()


def test_layout_rejects_what_jax_rejects():
    for pkg in (jsa, tsa):
        with pytest.raises(ValueError, match="not divisible"):
            pkg.DenseSparsityConfig(2, 16).make_layout(100)
        with pytest.raises(ValueError, match="invalid attention"):
            pkg.FixedSparsityConfig(2, attention="sideways")
        with pytest.raises(ValueError, match="different_layout_per_head"):
            pkg.FixedSparsityConfig(2, num_different_global_patterns=2)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("mode", [None, "mul", "add"])
def test_sparse_self_attention_matches_jax(mode):
    h, s, d, block = 2, 128, 32, 16
    layout = jsa.BigBirdSparsityConfig(h, block, seed=1).make_layout(s)
    q, k, v = _qkv((2, h, s, d), 0)
    kpm = None
    if mode == "mul":
        kpm = np.ones((2, s), np.float32)
        kpm[1, 100:] = 0
    elif mode == "add":
        kpm = np.zeros((2, s), np.float32)
        kpm[0, 7:20] = -1e4
    want = jsa.sparse_self_attention(
        q, k, v, layout, block, key_padding_mask=kpm,
        key_padding_mask_mode=mode or "mul")
    got = tsa.sparse_self_attention(
        *map(torch.from_numpy, (q, k, v)), layout, block,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        key_padding_mask_mode=mode or "mul")
    assert np.abs(got.numpy() - np.asarray(want)).max() <= FWD_TOL


def _grads_jax(q, k, v, bsl, do):
    def loss(a, b, c):
        return jnp.sum(jbsa.block_sparse_attention(a, b, c, bsl,
                                                   interpret=True) * do)
    out = jbsa.block_sparse_attention(q, k, v, bsl, interpret=True)
    return np.asarray(out), [np.asarray(g) for g in
                             jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _grads_port(q, k, v, bsl, do):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tbsa.block_sparse_attention(*ts, bsl)
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("layout_idx", [2, 5, 8, 11], ids=[
    _IDS[i] for i in (2, 5, 8, 11)])
@pytest.mark.parametrize("s,tiles", [(256, 64), (1040, None)],
                         ids=["s256", "s1040"])
def test_block_sparse_attention_matches_jax(layout_idx, s, tiles):
    name, kw = LAYOUTS[layout_idx]
    h, d, block = 2, 32, 16
    jc, tc = _configs(name, kw, h, block)
    jl, tl = jc.make_layout(s), tc.make_layout(s)
    jl_, tl_ = (jbsa.BlockSparseLayout(jl, block, s, tile_q=tiles,
                                       tile_k=tiles),
                tbsa.BlockSparseLayout(tl, block, s, tile_q=tiles,
                                       tile_k=tiles))
    # JAX keeps the layout as tile-major cells [h, TQ, TK, cq, ck]
    cells = np.asarray(jl_.cells).transpose(0, 1, 3, 2, 4).reshape(
        tl_.layout.shape)
    assert (tl_.layout == cells.astype(bool)).all()
    assert tl_.density == jl_.density
    q, k, v = _qkv((2, h, s, d), 1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    want, gwant = _grads_jax(q, k, v, jl_, do)
    launches = dict(tbsa.LAUNCHES)
    got, ggot = _grads_port(q, k, v, tl_, do)
    assert tbsa.LAUNCHES == launches          # CPU tensors: plain versions
    assert np.abs(got - want).max() <= FWD_TOL
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _cells_from_lists(bsl, orient):
    """The element mask the kernels' lists admit, rebuilt on the host."""
    ptr, idx, mask = (t.numpy() for t in bsl.kernel_lists("cpu")[orient])
    s, h = bsl.seq_len, bsl.num_heads
    n = -(-s // 64)
    keep = np.zeros((h, n * 64, n * 64), bool)
    for row in range(h * n):
        hh, i = divmod(row, n)
        for e in range(ptr[row], ptr[row + 1]):
            j = idx[e]
            qt, kt = (i, j) if orient == "q" else (j, i)
            assert mask[e] != 0
            for bit in range(16):
                if mask[e] >> bit & 1:
                    qs, ks = divmod(bit, 4)
                    keep[hh, qt * 64 + qs * 16:qt * 64 + qs * 16 + 16,
                         kt * 64 + ks * 16:kt * 64 + ks * 16 + 16] = True
    return keep[:, :s, :s], keep


@pytest.mark.parametrize("block,s,heads_differ", [
    (16, 256, False), (16, 1040, True), (32, 640, True), (64, 512, False),
    (128, 1024, True)])
def test_kernel_tables_cover_exactly_the_layout(block, s, heads_differ):
    layout = tsa.BigBirdSparsityConfig(
        3, block, different_layout_per_head=heads_differ,
        num_random_blocks=2, seed=4).make_layout(s)
    bsl = tbsa.BlockSparseLayout(layout, block, s)
    want = bsl.element_mask("cpu").numpy()
    for orient in ("q", "k"):
        got, padded = _cells_from_lists(bsl, orient)
        assert (got == want).all()
        assert not padded[:, s:].any() and not padded[:, :, s:].any()
    dead, total = bsl.tiles_skipped()
    assert total == 3 * (-(-s // 64)) ** 2
    assert total - dead == len(bsl.kernel_lists("cpu")["q"][1])
    assert total - dead == len(bsl.kernel_lists("cpu")["k"][1])
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        tbsa.kernel_tile_masks(np.ones((1, 4, 4), bool), 8)


@pytest.mark.parametrize("mode", ["mul", "add"])
def test_key_padding_through_the_kernels_matches_jax_dense(mode):
    """The kernels' route takes a key-padding mask as a key bias: its plain
    versions (CPU tensors) agree with JAX's dense composition under the
    same mask, forward and gradients."""
    h, s, d, block = 2, 256, 32, 16
    layout = jsa.BigBirdSparsityConfig(h, block, seed=2).make_layout(s)
    q, k, v = _qkv((3, h, s, d), 6)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    valid = np.arange(s)[None] < np.array([[s], [181], [37]])
    kpm = (valid.astype(np.float32) if mode == "mul"
           else np.where(valid, 0.0, -1e4).astype(np.float32))

    def loss(a, b, c):
        return jnp.sum(jsa.sparse_self_attention(
            a, b, c, layout, block, key_padding_mask=kpm,
            key_padding_mask_mode=mode) * do)

    want = np.asarray(jsa.sparse_self_attention(
        q, k, v, layout, block, key_padding_mask=kpm,
        key_padding_mask_mode=mode))
    gwant = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
    bias = tsa.key_padding_bias(torch.from_numpy(kpm), mode)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tbsa.block_sparse_attention(
        *ts, tbsa.BlockSparseLayout(layout, block, s), key_bias=bias)
    (out * torch.from_numpy(do)).sum().backward()
    assert np.abs(out.detach().numpy() - want).max() <= FWD_TOL
    for t, g in zip(ts, gwant):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert torch.equal(bias[1, 181:], torch.full((s - 181,), float(
        "-inf") if mode == "mul" else -1e4))


def test_empty_rows_give_zeros_like_jax():
    h, s, d, block = 1, 128, 16, 16
    layout = np.ones((h, s // block, s // block), bool)
    layout[0, 2, :] = False                    # rows 32..47 see no key
    q, k, v = _qkv((1, h, s, d), 3)
    do = np.ones_like(q)
    jl = jbsa.BlockSparseLayout(layout.astype(np.int32), block, s,
                                tile_q=64, tile_k=64)
    want, gwant = _grads_jax(q, k, v, jl, do)
    got, ggot = _grads_port(q, k, v, tbsa.BlockSparseLayout(layout, block, s),
                            do)
    assert not got[0, 0, 32:48].any() and not want[0, 0, 32:48].any()
    assert not ggot[0][0, 0, 32:48].any()
    assert np.abs(got - want).max() <= FWD_TOL
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the dense composition gives the mean of v there, in both packages
    dense = tsa.sparse_self_attention(*map(torch.from_numpy, (q, k, v)),
                                      layout, block).numpy()
    np.testing.assert_allclose(dense[0, 0, 40], v[0, 0].mean(0), atol=1e-5)


def test_sparse_self_attention_routing():
    h, s, d, block = 2, 128, 16, 16
    cfg = tsa.BSLongformerSparsityConfig(h, block)
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, h, s, d), 5))
    kpm = torch.ones((1, s))
    kpm[0, 100:] = 0
    dense = tsa.LAUNCHES["sparse_self_attention_dense"]
    kernel = dict(tbsa.LAUNCHES)

    auto = tsa.SparseSelfAttention(cfg)
    out = auto(q, k, v)                         # the kernels' route
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense
    assert isinstance(auto._bs_layouts[s], tbsa.BlockSparseLayout)
    ref = tbsa.block_sparse_attention(q, k, v, auto._bs_layouts[s])
    assert torch.equal(out, ref)
    masked = auto(q, k, v, key_padding_mask=kpm)    # CPU: JAX's rule, dense
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense + 1
    assert (masked - out).abs().max() > 1e-3         # the mask bites

    xla = tsa.SparseSelfAttention(cfg, implementation="xla")
    assert (xla(q, k, v) - out).abs().max() <= FWD_TOL
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense + 2
    assert list(xla._layouts[s][1]) == [q.device]   # mask cached per device

    pallas = tsa.SparseSelfAttention(cfg, implementation="pallas")
    assert torch.equal(pallas(q, k, v), out)
    # "pallas" with a mask: the kernels' route (here its plain version),
    # the mask as a key bias
    assert (pallas(q, k, v, key_padding_mask=kpm) - masked).abs().max() \
        <= FWD_TOL
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense + 2
    for bad in (dict(implementation="triton"),
                dict(key_padding_mask_mode="max")):
        with pytest.raises(ValueError):
            tsa.SparseSelfAttention(cfg, **bad)
    assert tbsa.LAUNCHES == kernel              # CPU: no kernel launches
    assert tsa.SparseAttnBuilder().load() is tsa


def test_kernel_wrappers_refuse_cpu_tensors():
    layout = np.ones((1, 4, 4), bool)
    bsl = tbsa.BlockSparseLayout(layout, 16, 64)
    q = torch.zeros((1, 1, 64, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbsa.block_sparse_attention_fwd(q, q, q, bsl)
