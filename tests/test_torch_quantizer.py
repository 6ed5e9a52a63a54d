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
