"""The bf16 / fp16 block-sparse kernels' walk (``bsa_tile_walk``) on the
CPU: what the forward, dQ and dK/dV kernels of
``deepspeed_tpu_torch/csrc/block_sparse_attention.cu`` read (the forward
and dQ one query-major walk, dK/dV a key-major one).

* over the six layouts of ``chip_smoke.py`` phase 23 at h 2, block 16 / 32,
  S 256 and 1040, with the split rule's parts and with every list split
  into parts of two stages or of one: every kept (query, key) 16 x 16
  sub-block is visited exactly once by the dQ walk and once by the dK/dV
  walk and no dead one is counted as work, every 16-row slice lies in one
  group, a split list's parts cover its stages in part order with their
  own partial slots, the blocks run longest list first, and
  ``BlockSparseLayout.walk_tables`` are these tables;
* ``block_sparse_tiled_plain_fwd`` (the forward's walk evaluated in fp32,
  split parts merged in part order) against the JAX package's ``_fwd``
  (its Pallas forward kernel in interpret mode, jitted once a shape)
  within 1e-4 on o and lse, at the same two shapes and splits as the
  backward below;
* ``block_sparse_tiled_plain_bwd`` (the walk evaluated in fp32, split
  parts summed) against the JAX package's ``_bwd`` (its Pallas dQ and
  dK/dV kernels in interpret mode, jitted once a shape) within 1e-4, at
  S 256 (block 32, the split rule) and 1040 (block 16, every list split
  into parts of two stages), d 32;
* the fp32 forward kernel's products, 3xTF32 (``split``: the port's
  ``tf32_split`` for the high part, the remainder truncated as the tensor
  cores read it), on its walk (``FP32_SPLIT`` times finer splits) against
  the same JAX ``_fwd`` within 1e-4 at D 64 and 20, with the split rule
  and every list split into parts of one stage; with the split's cross
  terms dropped the same evaluation misses 1e-4;
* the planted faults of ``chip_smoke.py`` (edited masks, cleared lists)
  reach their walks: the query-major one the forward's and dQ's, the
  key-major one dK/dV's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import block_sparse_attention as jbsa
from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

#: chip_smoke.py's BSA_LAYOUTS
LAYOUTS = {
    "fixed": ("FixedSparsityConfig",
              dict(num_local_blocks=4, num_global_blocks=1)),
    "fixed_uni": ("FixedSparsityConfig",
                  dict(num_local_blocks=4, num_global_blocks=1,
                       attention="unidirectional")),
    "bigbird": ("BigBirdSparsityConfig",
                dict(num_random_blocks=1, num_sliding_window_blocks=3,
                     num_global_blocks=1)),
    "bslongformer": ("BSLongformerSparsityConfig",
                     dict(num_sliding_window_blocks=3,
                          global_block_indices=[0])),
    "variable": ("VariableSparsityConfig",
                 dict(num_random_blocks=1, local_window_blocks=[4],
                      global_block_indices=[0])),
    "dense": ("DenseSparsityConfig", {}),
}
SHAPES = [(256, 16), (256, 32), (1040, 16)]
H, D, B = 2, 32, 2
TOL = 1e-4


def _layout(name, s, block):
    cls, kw = LAYOUTS[name]
    return tbsa.BlockSparseLayout(
        getattr(tsa, cls)(H, block, **kw).make_layout(s), block, s)


def _force_split(monkeypatch, split_stages):
    """The split rule's constants set so that every list longer than
    ``split_stages`` stages is cut into parts of that many (None: the
    kernels' rule)."""
    if split_stages is not None:
        monkeypatch.setattr(tbsa, "SPLIT_MIN", split_stages)
        monkeypatch.setattr(tbsa, "WAVE", 1 << 40)


def _walks(bsl, batch):
    masks = bsl.kernel_masks
    return {"dq": tbsa.bsa_tile_walk(masks, bsl.seq_len, False, batch),
            "dkv": tbsa.bsa_tile_walk(
                np.ascontiguousarray(masks.transpose(0, 2, 1)),
                bsl.seq_len, True, batch)}


def _visits(walk, h, n):
    """[h, n, n] count of (stationary slice, streamed slice) visits."""
    count = np.zeros((h, n, n), np.int64)
    stat_seen = np.zeros((h, n), np.int64)
    blocks, stages = walk["blocks"], walk["stages"]
    g = tbsa.SLOTS
    for row in blocks:
        head, stat, (b0, b1, part) = row[0], row[1:1 + g], row[1 + g:4 + g]
        if part == 0:
            for sl in stat[stat >= 0]:
                stat_seen[head, sl] += 1
        for st in stages[b0:b1]:
            slots, mask = st[:4], int(st[4]) & 0xFFFFFFFF
            for r in range(g):
                for c in range(4):
                    if mask >> (4 * r + c) & 1:
                        assert stat[r] >= 0 and slots[c] >= 0
                        count[head, stat[r], slots[c]] += 1
    return count, stat_seen


def _check_splits(walk):
    blocks = walk["blocks"]
    # columns: begin, end, part, parts, partial slot, split group
    b0, b1, pt, pts, ws, grp = range(tbsa.SLOTS + 1, tbsa.SLOTS + 7)
    lens = blocks[:, b1] - blocks[:, b0]
    assert (np.diff(lens) <= 0).all()                 # longest list first
    slots = []
    for g in range(walk["groups"]):
        rows = blocks[blocks[:, grp] == g]
        rows = rows[np.argsort(rows[:, pt])]
        parts = rows[0, pts]
        assert list(rows[:, pt]) == list(range(parts))
        assert (rows[1:, b0] == rows[:-1, b1]).all()  # part p, then p + 1
        assert (rows[:, 1:b0] == rows[0, 1:b0]).all() and parts > 1
        slots += list(rows[:, ws] + rows[:, pt])
    assert sorted(slots) == list(range(walk["parts"]))
    single = blocks[blocks[:, grp] < 0]
    assert (single[:, pt] == 0).all() and (single[:, pts] == 1).all()
    # a group's list in index order (a packed stage: its live slices)
    st = walk["stages"]
    for row in blocks[blocks[:, pt] == 0]:
        first = row[b0]
        last = row[b1] if row[pts] == 1 else \
            blocks[(blocks[:, grp] == row[grp])
                   & (blocks[:, pt] == row[pts] - 1), b1][0]
        flat = st[first:last, :4].reshape(-1)
        flat = flat[flat >= 0]
        assert (np.diff(flat) > 0).all()


@pytest.mark.parametrize("split_stages", [None, 2, 1],
                         ids=["rule", "split2", "split1"])
@pytest.mark.parametrize("s,block", SHAPES, ids=[f"s{s}b{b}" for s, b in
                                                 SHAPES])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_walk_visits_each_kept_sub_block_once(name, s, block, split_stages,
                                               monkeypatch):
    bsl = _layout(name, s, block)
    n = s // 16
    sub = bsl.layout.repeat(block // 16, 1).repeat(block // 16, 2)
    _force_split(monkeypatch, split_stages)
    walks = _walks(bsl, B)
    for orient, want in (("dq", sub), ("dkv", sub.transpose(0, 2, 1))):
        count, seen = _visits(walks[orient], H, n)
        assert (count == want).all(), orient          # once, and only live
        assert (seen == 1).all(), orient              # one group a slice
        _check_splits(walks[orient])
        assert walks[orient]["blocks"].shape[1] == tbsa.ITEM_INTS
        if split_stages == 1:                         # the split path runs
            assert walks[orient]["groups"] > 0, orient
    got = bsl.walk_tables("cpu", B)
    for orient in ("dq", "dkv"):
        w = walks[orient]
        assert (got[orient]["blocks"].numpy().reshape(-1, tbsa.ITEM_INTS)
                == w["blocks"]).all()
        assert (got[orient]["stages"].numpy().reshape(-1, 8)
                == w["stages"]).all()
        assert got[orient]["n_blocks"] == len(w["blocks"])
        assert (got[orient]["groups"], got[orient]["parts"]) == \
            (w["groups"], w["parts"])


def _qkv(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, D)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _jax_bwd(block, block_q, block_k, scale):
    """The JAX package's ``_bwd`` in interpret mode, jitted: one compile a
    shape serves every layout (the layout's cells are an argument)."""
    return jax.jit(functools.partial(jbsa._bwd, block=block, block_q=block_q,
                                     block_k=block_k, scale=scale,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_fwd(block, block_q, block_k):
    """The JAX package's ``_fwd`` in interpret mode, jitted: one compile a
    shape serves every layout."""
    return jax.jit(functools.partial(jbsa._fwd, block=block, block_q=block_q,
                                     block_k=block_k, interpret=True))


@pytest.mark.parametrize("s,block,split_stages", [(256, 32, None),
                                                  (1040, 16, 2)],
                         ids=["s256b32", "s1040b16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tiled_plain_fwd_matches_jax(name, s, block, split_stages,
                                     monkeypatch):
    bsl = _layout(name, s, block)
    q, k, v, _ = _qkv(s, s + block + 1)
    qs = q / np.sqrt(D)
    _force_split(monkeypatch, split_stages)
    walk = _walks(bsl, B)["dq"]
    if split_stages is not None:
        assert walk["groups"] > 0
    o, lse = tbsa.block_sparse_tiled_plain_fwd(
        *(torch.from_numpy(x) for x in (qs, k, v)), walk)
    jl = jbsa.BlockSparseLayout(bsl.layout.astype(np.int32), block, s)
    jo, jlse = _jax_fwd(block, jl.tile_q, jl.tile_k)(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jl.cells,
        jl.tile_any)
    assert np.abs(o.numpy() - np.asarray(jo)).max() <= TOL
    assert np.abs(lse.numpy() - np.asarray(jlse)[..., 0]).max() <= TOL


@pytest.mark.parametrize("s,block,split_stages", [(256, 32, None),
                                                  (1040, 16, 2)],
                         ids=["s256b32", "s1040b16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tiled_plain_bwd_matches_jax(name, s, block, split_stages,
                                     monkeypatch):
    bsl = _layout(name, s, block)
    q, k, v, do = _qkv(s, s + block)
    scale = 1.0 / np.sqrt(D)
    qs, k_t, v_t, do_t = (torch.from_numpy(x) for x in (q * scale, k, v, do))
    o, lse = tbsa.block_sparse_plain_fwd(qs, k_t, v_t,
                                         bsl.element_mask("cpu"))
    _force_split(monkeypatch, split_stages)
    got = tbsa.block_sparse_tiled_plain_bwd(qs, k_t, v_t, o, lse, do_t,
                                            _walks(bsl, B), scale)
    jl = jbsa.BlockSparseLayout(bsl.layout.astype(np.int32), block, s)
    lse8 = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None],
                            lse.shape + (8,))
    want = _jax_bwd(block, jl.tile_q, jl.tile_k, float(scale))(
        (jnp.asarray(qs.numpy()), jnp.asarray(k), jnp.asarray(v),
         jnp.asarray(o.numpy()), lse8, jl.cells, jl.tile_any),
        jnp.asarray(do))
    for g, w in zip(got[:3], want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL


#: (layout, D) of the split-TF32 forward's cases at S 256, block 16
_SPLIT_CASES = [("bslongformer", 64), ("bigbird", 64), ("fixed", 20),
                ("bslongformer", 20)]


def _split_inputs(name, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, 256, d)).astype(np.float32)
               for _ in range(3))
    qs = q / np.sqrt(d)
    bsl = _layout(name, 256, 16)
    jl = jbsa.BlockSparseLayout(bsl.layout.astype(np.int32), 16, 256)
    jo, jlse = _jax_fwd(16, jl.tile_q, jl.tile_k)(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jl.cells,
        jl.tile_any)
    return bsl, (qs, k, v), np.asarray(jo), np.asarray(jlse)[..., 0]


@pytest.mark.parametrize("split_stages", [None, 1], ids=["rule", "split1"])
@pytest.mark.parametrize("name,d", _SPLIT_CASES,
                         ids=[f"{n}-d{d}" for n, d in _SPLIT_CASES])
def test_split_tf32_fwd_matches_jax(name, d, split_stages, monkeypatch):
    """The fp32 forward's walk (``BlockSparseLayout.fp32_walk``) evaluated
    with its 3xTF32 products against the JAX package's ``_fwd`` (interpret
    mode) in fp32: o and lse within 1e-4."""
    bsl, ops, jo, jlse = _split_inputs(name, d, d + 7)
    _force_split(monkeypatch, split_stages)
    got = bsl.fp32_walk("cpu", B)
    walk = {key: got[key].numpy().reshape(-1, width)
            for key, width in (("blocks", tbsa.ITEM_INTS),
                               ("stages", tbsa.STAGE_INTS))}
    if split_stages is not None:
        assert got["groups"] > 0
    o, lse = tbsa.block_sparse_tiled_plain_fwd(
        *(torch.from_numpy(x) for x in ops), walk, split=True)
    assert np.abs(o.numpy() - jo).max() <= TOL
    assert np.abs(lse.numpy() - jlse).max() <= TOL


def test_split_without_cross_terms_misses_the_bar():
    """At BSLongformer, D 64 (the first case above), TF32 products alone
    (the split's hi.lo and lo.hi dropped: chip_smoke.py's planted fault)
    put o more than 1e-4 off JAX's fp32 forward; with them it is within."""
    bsl, ops, jo, _ = _split_inputs("bslongformer", 64, 71)
    walk = tbsa.bsa_tile_walk(bsl.kernel_masks, 256, False, B,
                              tbsa.FP32_SPLIT * tbsa.WAVE)
    ts = [torch.from_numpy(x) for x in ops]
    full = tbsa.block_sparse_tiled_plain_fwd(*ts, walk, split=True)[0]
    hi = tbsa.block_sparse_tiled_plain_fwd(*ts, walk, split=True,
                                           cross=False)[0]
    assert np.abs(full.numpy() - jo).max() <= TOL
    assert np.abs(hi.numpy() - jo).max() > TOL


def _planted(bsl, side):
    """``chip_smoke.py``'s ``bsa_planted_fault``: side "q" drops the last
    live key tile of query tile 1 of head 0 from ``_masks``, side "k" the
    last live query tile of key tile 1 from ``_masks_t``; the lists are
    cleared."""
    import copy

    bad = copy.copy(bsl)
    m = bsl.kernel_masks.copy()
    mt = np.ascontiguousarray(m.transpose(0, 2, 1))
    cut = m if side == "q" else mt
    live = np.nonzero(cut[0, 1])[0]
    cut[0, 1, live[-1]] = 0
    bad._masks, bad._masks_t, bad._lists, bad._elem = m, mt, {}, {}
    return bad


def _visit_count(tables, orient):
    w = {key: tables[orient][key].numpy().reshape(-1, width)
         for key, width in (("blocks", tbsa.ITEM_INTS),
                            ("stages", tbsa.STAGE_INTS))}
    w.update(groups=tables[orient]["groups"], parts=tables[orient]["parts"])
    return _visits(w, H, 256 // 16)[0].sum()


def test_planted_key_major_fault_reaches_the_dkv_walk():
    """chip_smoke.py's ``bsa_planted_fault(side="k")`` edits ``_masks_t``
    and clears ``_lists``: the dK/dV walk loses a visit, the query-major
    walk (the forward's and dQ's) keeps every one."""
    bsl = _layout("bigbird", 256, 16)
    good = bsl.walk_tables("cpu", B)
    got = _planted(bsl, "k").walk_tables("cpu", B)
    assert _visit_count(got, "dq") == _visit_count(good, "dq")
    assert _visit_count(got, "dkv") < _visit_count(good, "dkv")


def test_planted_query_major_fault_reaches_the_forward_walk():
    """``bsa_planted_fault(side="q")`` edits ``_masks``: the query-major
    walk, which the forward reads, loses a visit (and the forward's plain
    evaluation of it moves off the layout's answer), the dK/dV walk keeps
    every one."""
    bsl = _layout("bigbird", 256, 16)
    bad = _planted(bsl, "q")
    good_t, bad_t = bsl.walk_tables("cpu", B), bad.walk_tables("cpu", B)
    assert _visit_count(bad_t, "dq") < _visit_count(good_t, "dq")
    assert _visit_count(bad_t, "dkv") == _visit_count(good_t, "dkv")
    q, k, v, _ = (torch.from_numpy(x) for x in _qkv(256, 5))
    walks = [{key: t["dq"][key].numpy().reshape(-1, width)
              for key, width in (("blocks", tbsa.ITEM_INTS),
                                 ("stages", tbsa.STAGE_INTS))}
             for t in (good_t, bad_t)]
    want = tbsa.block_sparse_plain_fwd(q, k, v, bsl.element_mask("cpu"))[0]
    good, bad_o = (tbsa.block_sparse_tiled_plain_fwd(q, k, v, w)[0]
                   for w in walks)
    assert (good - want).abs().max() <= TOL
    assert (bad_o - want).abs().max() > 1e-2
