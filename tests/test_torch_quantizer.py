"""The port's groupwise quantizer (``ops/quantizer.py``) and
``WeightQuantization`` (``runtime/weight_quantizer.py``) against the JAX
package on the CPU, bit for bit: the same numpy inputs (made from a seed,
with exact .5 ties and all-zero groups) through both.  The cases mirror
``tests/unit/test_quantizer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as JQ
from deepspeed_tpu.runtime.weight_quantizer import (
    WeightQuantization as JWeightQuantization)
from deepspeed_tpu_torch.ops import quantizer as TQ
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization
from torch_port_common import llama_params, tiny_geometry


def _x(shape=(16, 256), seed=0):
    """Normal values with an all-zero group (the first 256 values), a group
    whose absmax is exactly 127 * 2^-3 with ties on its quantization grid,
    and a constant group (asymmetric scale 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).reshape(-1)
    n = x.size // 16
    x[:n] = 0.0
    ties = (rng.integers(-126, 126, size=n) + 0.5) * 0.125
    ties[0] = 127 * 0.125                         # scale = 0.125 exactly
    x[n:2 * n] = ties
    x[2 * n:3 * n] = 0.75
    return x.reshape(shape)


def _eq(t, j):
    """torch tensor and JAX array hold the same bits."""
    if j is None:
        assert t is None
        return
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("num_bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_dequantize_match_jax(num_bits, symmetric):
    x = _x()
    tq, ts, to = TQ.quantize(torch.from_numpy(x), 16, num_bits, symmetric)
    jq, js, jo = JQ.quantize(jnp.asarray(x), 16, num_bits, symmetric)
    for t, j in ((tq, jq), (ts, js), (to, jo)):
        _eq(t, j)
    if symmetric:
        assert ts[0].item() == 1.0                 # the all-zero group
    _eq(TQ.dequantize(tq, ts, to, num_bits),
        JQ.dequantize(jq, js, jo, num_bits))
    _eq(TQ.fake_quantize(torch.from_numpy(x), 16, num_bits, symmetric),
        JQ.fake_quantize(jnp.asarray(x), 16, num_bits, symmetric))


def test_ties_round_half_to_even():
    x = _x()
    q, s, _ = TQ.quantize(torch.from_numpy(x), 16)
    assert s[1].item() == 0.125
    want = np.round(x[1] / np.float32(0.125))      # numpy rounds half even
    np.testing.assert_array_equal(q[1].numpy(), want.astype(np.int8))
    assert np.any(np.abs(x[1] / 0.125 % 1) == 0.5)


def test_bf16_input_and_kernel_entry_match_jax():
    """bf16 in (both sides round the same fp32 values to bf16), and the
    kernel's entry, whose CPU path is its plain version, against the JAX
    ``quantize`` and the TPU kernel's entry ``quantize_pallas`` (the jnp
    rule off the TPU, but under ``jax.jit``, where XLA turns absmax / 127
    into absmax * fl(1/127): its scales may sit one ulp from the division
    that eager JAX, the plain version and the CUDA kernel compute)."""
    x = _x((8, 512), seed=1)
    tb = torch.from_numpy(x).bfloat16()
    jb = jnp.asarray(x, jnp.bfloat16)
    tq, ts, _ = TQ.quantize(tb, 8)
    jq, js, _ = JQ.quantize(jb, 8)
    _eq(tq, jq)
    _eq(ts, js)
    _eq(TQ.fake_quantize(tb, 8).view(torch.int16),
        JQ.fake_quantize(jb, 8).view(jnp.int16))
    kq, ks = TQ.quantize_kernel(torch.from_numpy(x), 8)
    jq, js, _ = JQ.quantize(jnp.asarray(x), 8)
    _eq(kq, jq)
    _eq(ks, js)
    pq, ps = JQ.quantize_pallas(jnp.asarray(x), 8)
    _eq(kq, pq)
    absmax = np.abs(x.reshape(8, -1)).max(axis=1)
    _eq(torch.from_numpy(absmax * np.float32(1 / 127)), ps)
    ulps = np.abs(ks.numpy().view(np.int32) - np.asarray(ps).view(np.int32))
    assert ulps.max() == 1                         # this input shows it
    assert TQ.LAUNCHES["quantize"] == 0            # CPU calls do not count


@pytest.mark.parametrize("symmetric", [True, False])
def test_stochastic_quantize_on_the_integer_grid_matches_jax(symmetric):
    """Values on the quantization grid have no fractional part: no draw can
    move them, so both packages give the same bits whatever their random
    numbers."""
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, size=(4, 256)).astype(np.float32)
    # scale 1 exactly: absmax 127, or max - min = 255
    x[:, 0], x[:, 1] = -127.0, (127.0 if symmetric else 128.0)
    gen = torch.Generator().manual_seed(0)
    tq, ts, to = TQ.stochastic_quantize(torch.from_numpy(x), 4, gen,
                                        symmetric=symmetric)
    jq, js, jo = JQ.stochastic_quantize(jnp.asarray(x), 4,
                                        jax.random.PRNGKey(0),
                                        symmetric=symmetric)
    for t, j in ((tq, jq), (ts, js), (to, jo)):
        _eq(t, j)


def test_stochastic_quantize_unbiased():
    x = torch.full((1, 4096), 0.3)  # 0.3 not representable on the int8 grid
    gen = torch.Generator().manual_seed(1)
    outs = []
    for _ in range(64):
        q, s, o = TQ.stochastic_quantize(x, 1, gen)
        outs.append(TQ.dequantize(q, s, o).mean().item())
    # mean over many SR draws converges to the true value
    assert abs(np.mean(outs) - 0.3) < 1e-3


def test_quantized_reduce_matches_jax():
    ranks, groups, gs = 4, 8, 128
    x = np.random.default_rng(3).standard_normal(
        (ranks, groups * gs)).astype(np.float32)
    x[:, :gs] = 0.0                                # an all-zero group
    qs, ss = zip(*(TQ.quantize(torch.from_numpy(x[r]), groups)[:2]
                   for r in range(ranks)))
    tq, ts = TQ.quantized_reduce(torch.stack(qs), torch.stack(ss), ranks)
    jq, js = JQ.quantized_reduce(jnp.asarray(np.stack(qs)),
                                 jnp.asarray(np.stack(ss)), ranks)
    _eq(tq, jq)
    _eq(ts, js)
    got = TQ.dequantize(tq, ts).reshape(-1).numpy()
    assert np.abs(got - x.mean(axis=0)).max() < 0.02


def test_swizzle_and_int4_packing_match_jax():
    x = _x((4, 256), seed=4)
    tq, ts = TQ.swizzle_quant(torch.from_numpy(x), 4, pipeline_size=4)
    jq, js = JQ.swizzle_quant(jnp.asarray(x), 4, pipeline_size=4)
    _eq(tq, jq)
    _eq(ts, js)
    deq = TQ.dequantize(tq, ts).reshape(-1)
    _eq(TQ.unswizzle(deq, 4), JQ.unswizzle(jnp.asarray(deq.numpy()), 4))
    q4, _, _ = TQ.quantize(torch.from_numpy(x), 8, 4, True)
    assert q4.min().item() < 0                    # sign extension is tested
    packed = TQ.pack_int4(q4)
    _eq(packed, JQ.pack_int4(jnp.asarray(q4.numpy())))
    assert packed.shape == (8, 64)
    _eq(TQ.unpack_int4(packed), JQ.unpack_int4(jnp.asarray(packed.numpy())))
    _eq(TQ.unpack_int4(packed, signed=False),
        JQ.unpack_int4(jnp.asarray(packed.numpy()), signed=False))
    assert torch.equal(TQ.unpack_int4(packed), q4)


def test_builder_and_errors():
    mod = TQ.QuantizerBuilder().load()
    assert mod.quantize is TQ.quantize
    assert TQ.QuantizerBuilder().is_compatible()
    with pytest.raises(ValueError, match="not divisible"):
        TQ.quantize(torch.zeros(10), 3)
    with pytest.raises(ValueError, match="even"):
        TQ.pack_int4(torch.zeros(3, dtype=torch.int8))


def _trees():
    geom = tiny_geometry(intermediate_size=320)
    params = llama_params(geom, seed=5)
    # a leaf whose rows no wanted group count divides evenly
    params["model"]["layers_0"]["mlp"]["down_proj"]["kernel"] = \
        params["model"]["layers_0"]["mlp"]["down_proj"]["kernel"][:300]
    tparams = jax.tree.map(torch.from_numpy, params)
    return params, tparams


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("groups,mlp_extra", [(64, False), (7, True)])
def test_model_quantize_records_match_jax(groups, mlp_extra):
    params, tparams = _trees()
    kw = dict(quantize_bits=8, quantize_groups=groups,
              mlp_extra_grouping=mlp_extra)
    jtree, jn = JWeightQuantization(**kw).model_quantize(
        params, exclude=("embed",))
    wq = WeightQuantization(**kw)
    ttree, tn = wq.model_quantize(tparams, exclude=("embed",))
    assert tn == jn == 15                          # 2 x 7 + lm_head
    jflat, tflat = dict(_flat(jtree)), dict(_flat(ttree))
    assert jflat.keys() == tflat.keys()
    for path, j in jflat.items():
        t = tflat[path]
        if isinstance(j, dict):
            assert WeightQuantization.is_quantized_record(t), path
            _eq(t["q"], j["q"])
            _eq(t["scale"], j["scale"])
        else:                                      # embed, norms
            _eq(t, j)
    assert isinstance(ttree["model"]["embed_tokens"]["embedding"],
                      torch.Tensor)
    back = wq.dequantize_tree(ttree, torch.float32)
    jback = JWeightQuantization(**kw).dequantize_tree(jtree, jnp.float32)
    for (path, t), (_, j) in zip(_flat(back), _flat(jback)):
        _eq(t, j)


@pytest.mark.parametrize("rows,groups,align", [(96, 64, 8), (96, 10, 4),
                                               (90, 16, 4), (7, 64, 1)])
def test_quantize_leaf_alignment_matches_jax(rows, groups, align):
    w = np.random.default_rng(rows + groups).standard_normal(
        (rows, 40)).astype(np.float32)
    kw = dict(quantize_bits=8, quantize_groups=groups)
    t = WeightQuantization(**kw).quantize_leaf(torch.from_numpy(w), groups,
                                               align)
    j = JWeightQuantization(**kw).quantize_leaf(jnp.asarray(w), groups, align)
    assert t["q"].shape == w.shape
    _eq(t["q"], j["q"])
    _eq(t["scale"], j["scale"])


# ----------------------------------------------------------------------------
# The CUDA kernel's launch plan (csrc/quantizer.cu), on the CPU
# ----------------------------------------------------------------------------
#: (numel, groups, element bytes): chip_smoke.py phase 19's Llama-2-7B
#: matrices at 64 and 16 groups and 128-value groups, fp32 and fp16, a
#: group of 2000 bytes, groups that are no multiple of 16 bytes (the scalar
#: path, also of many pieces), one group, odd sizes, one group larger than
#: a grid of pieces and one larger than the card's shared memory
_PLAN_CASES = [
    (4096 * 4096, 64, 2), (4096 * 11008, 64, 2), (11008 * 4096, 64, 2),
    (4096 * 32000, 64, 2), (4096 * 4096, 16, 2), (4096 * 11008, 16, 2),
    (4096 * 32000, 16, 2), (4096 * 4096, 4096 * 4096 // 128, 2),
    (4096 * 4096, 64, 4), (512 * 1024, 8, 2), (512 * 1024, 8, 4),
    (3000, 3, 2), (700, 7, 4), (129 * 37, 3, 2), (4097 * 11, 11, 2),
    (100003, 1, 2), (1 << 20, 1, 4), (6, 6, 2), (70 << 20, 1, 2),
    (1 << 30, 4, 2),
]


def _plan_parts(numel, groups, elt, **kw):
    """The value ranges [start, end) of the plan's pieces, with the groups
    each piece touches, and the plan."""
    p = TQ.quantize_plan(numel, groups, elt, **kw)
    vec, gl = p["vec"], p["group_vecs"]
    parts = []
    for pc in range(p["n_pieces"]):
        if p["route"] == "block":
            g0 = pc * p["gpp"]
            g1 = min(groups, g0 + p["gpp"])
            parts.append((g0 * gl * vec, g1 * gl * vec, g0))
        else:
            g, w = divmod(pc, p["parts"])
            s0 = min(w * p["piece"], gl)
            s1 = min(s0 + p["piece"], gl)
            parts.append(((g * gl + s0) * vec, (g * gl + s1) * vec, g))
    return parts, p


@pytest.mark.parametrize("numel,groups,elt", _PLAN_CASES)
def test_quantize_plan_covers_every_value_once(numel, groups, elt):
    """Every value lies in exactly one piece; a piece is a whole number of
    groups (route "block", of at most QUANT_PIECE_BLOCK bytes) or a part of
    one group (of at most QUANT_PIECE bytes unless a group needs more than
    a grid of them); a group's parts are consecutive pieces, at most one
    grid of them (they wait on each other, so all must be resident at
    once); the staged pieces fit a block's shared memory; 16-byte vectors
    exactly when a group is a whole number of them."""
    parts, p = _plan_parts(numel, groups, elt)
    n = numel // groups
    assert p["vec"] == (16 // elt if n * elt % 16 == 0 else 1)
    assert p["vec"] * p["group_vecs"] == n
    spans = sorted((a, b) for a, b, _ in parts)
    assert spans[0][0] == 0 and spans[-1][1] == numel
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    assert all(b > a for a, b in spans)                  # none empty
    per = TQ.QUANT_PIECE // (p["vec"] * elt)
    held = TQ.H100_SMS * TQ.h100_resident(p["smem"])
    assert p["grid"] == min(p["n_pieces"], held) >= 1
    assert p["smem"] <= TQ.QUANT_SMEM_MAX
    assert p["nbuf"] in ((0,) if p["vec"] == 1 else
                         (0, TQ.QUANT_NBUF, TQ.QUANT_NBUF_GROUP))
    if p["route"] == "block":
        assert p["parts"] == 1 and p["gpp"] >= 1
        assert p["piece"] == p["gpp"] * p["group_vecs"] <= \
            TQ.QUANT_PIECE_BLOCK // (p["vec"] * elt)
        assert p["n_pieces"] == -(-groups // p["gpp"])
        return
    assert p["gpp"] == 0 and p["n_pieces"] == groups * p["parts"]
    assert p["piece"] * p["parts"] >= p["group_vecs"]
    assert (p["parts"] - 1) * p["piece"] < p["group_vecs"]
    assert p["parts"] <= p["grid"]
    assert p["piece"] <= per or p["parts"] == p["grid"]
    if p["vec"] > 1 and p["parts"] > 1 and p["nbuf"] != TQ.QUANT_NBUF_GROUP:
        # a group of more pieces than a grid of staging blocks holds, read
        # twice from global memory
        assert p["nbuf"] == 0
        assert -(-p["group_vecs"] // per) > TQ.H100_SMS * TQ.h100_resident(
            TQ.QUANT_NBUF_GROUP * per * 16)


def _plan_inputs(dtype, shape, groups, seed):
    """Normal values as fp32 numpy with an all-zero group and a group of
    exact .5 ties on its grid (absmax 127 / 8: scale 1/8), and the same
    values in ``dtype`` (exact in bf16 and fp16: the ties are multiples of
    1/16 below 16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32).reshape(groups, -1)
    x[0] = 0.0
    if groups > 1:
        n = x.shape[1]
        ties = (rng.integers(-126, 126, size=n) + 0.5) / 8
        ties[n // 2] = 127 / 8
        x[1] = ties
    x = x.reshape(shape)
    return x, torch.from_numpy(x).to(dtype)


#: (shape, groups): 128-value groups, a group size that is no multiple of
#: 8 (the scalar path), groups of many pieces, and groups of more pieces
#: than the cut card's grid holds
_PLANNED = [((64, 256), 128), ((20, 35), 4), ((16, 1024), 4), ((4, 4096), 2),
            ((2, 40000), 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("shape,groups", _PLANNED,
                         ids=[f"{s[0]}x{s[1]}g{g}" for s, g in _PLANNED])
def test_planned_quantize_matches_jax_bit_for_bit(shape, groups, dtype,
                                                  monkeypatch):
    """The plan's reduction (each group in its piece, or each piece of a
    group reduced on its own and the pieces' maxima combined) gives the
    bits of JAX's ``quantize`` and of ``quantize_plain``, an all-zero
    group's scale 1 and exact .5 ties included.  The plan's sizes are cut
    (pieces of 256 bytes, a card of 4 SMs) so that these inputs take the
    "group" route with many parts, and a grid too small for them (larger
    pieces), as the Llama-2-7B matrices do on the card."""
    monkeypatch.setattr(TQ, "QUANT_PIECE", 256)
    monkeypatch.setattr(TQ, "QUANT_PIECE_BLOCK", 256)
    kw = {"sms": 4}
    x, tx = _plan_inputs(dtype, shape, groups, sum(shape) + groups)
    parts, plan = _plan_parts(tx.numel(), groups, tx.element_size(), **kw)
    if shape in ((16, 1024), (4, 4096)):
        assert plan["route"] == "group" and plan["parts"] > 1
    q, s = TQ.quantize_planned_plain(tx, groups, **kw)
    pq, ps = TQ.quantize_plain(tx, groups)
    jx = jnp.asarray(x, {torch.float32: jnp.float32,
                         torch.bfloat16: jnp.bfloat16,
                         torch.float16: jnp.float16}[dtype])
    jq, js, _ = JQ.quantize(jx, groups)
    _eq(q, jq)
    _eq(s, js)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert s[0].item() == 1.0 and not q[0].any()
    if groups > 1:
        assert s[1].item() == 0.125
        want = np.round(x.reshape(groups, -1)[1] * 8)   # numpy: half even
        np.testing.assert_array_equal(q[1].numpy(), want.astype(np.int8))
