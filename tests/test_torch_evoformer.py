"""The port's Evoformer attention (``ops/evoformer_attn.py``) against the JAX
package on the CPU in f32: the forward against the JAX op run through its
Pallas kernel in interpret mode (as ``tests/unit/test_ops_kernels.py:294``
runs it) and against the dense composition, <= 2e-5; the gradients of the
port's autograd Function (its chunked dense-recompute backward) against the
JAX op's custom VJP, <= 1e-4.  Cases: OpenFold's two bias patterns (the
mask bias [B, N, 1, 1, S] full in the lead dims, the pair bias
[B, 1, H, S, S] broadcast over N), no biases, rows whose keys are all
masked (-1e9), a bias broadcast over B but full over N, and three biases
at D = 12 (outside the tensor-core kernel's domain; on the CPU every call
takes the same autograd Function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attn as jevo
from deepspeed_tpu_torch.ops import evoformer_attn as tevo

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(lead, s, h, d, seed, biases="both"):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(lead + (s, h, d)).astype(np.float32)
           for _ in range(3)]
    b, n = lead
    mask = np.where(rng.standard_normal((b, n, 1, 1, s)) > 0, 0.0,
                    -1e9).astype(np.float32)
    pair = rng.standard_normal((b, 1, h, s, s)).astype(np.float32)
    if biases == "both":
        bs = [mask, pair]
    elif biases == "masked_rows":
        mask[0, 1] = -1e9                      # every key of rows (0, 1)
        mask[1, 0, ..., :s // 2] = -1e9
        bs = [mask, pair]
    elif biases == "n_only":                   # broadcast over B, full in N
        bs = [rng.standard_normal((1, n, h, 1, s)).astype(np.float32),
              rng.standard_normal((h, s, s)).astype(np.float32)]
    elif biases == "three":                    # + a per-query-row bias
        bs = [mask, pair,
              rng.standard_normal((1, n, h, s, 1)).astype(np.float32)]
    else:
        bs = []
    return qkv, bs


CASES = [((2, 3), 32, 2, 8, "both"), ((2, 3), 32, 2, 8, "none"),
         ((2, 2), 24, 2, 16, "masked_rows"), ((1, 4), 16, 3, 32, "n_only"),
         ((2, 3), 16, 2, 12, "three")]


@pytest.mark.parametrize("lead,s,h,d,biases", CASES)
def test_forward_matches_jax(lead, s, h, d, biases):
    (q, k, v), bs = _inputs(lead, s, h, d, seed=s + d, biases=biases)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = [torch.from_numpy(b) for b in bs]
    got = tevo.DS4Sci_EvoformerAttention(*t, tb)
    j = [jnp.asarray(a) for a in (q, k, v)]
    jb = [jnp.asarray(b) for b in bs]
    want = jevo.DS4Sci_EvoformerAttention(*j, jb, interpret=True)
    dense = jevo.evoformer_attention_dense(*j, jb)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(
        tevo.evoformer_attention_dense(*t, tb).numpy(), np.asarray(dense),
        atol=FWD_TOL, rtol=0)
    if biases == "masked_rows":                # uniform over all keys
        np.testing.assert_allclose(
            got.numpy()[0, 1], np.broadcast_to(v[0, 1].mean(axis=0),
                                               got.shape[2:]),
            atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("lead,s,h,d,biases", CASES)
def test_gradients_match_jax(monkeypatch, lead, s, h, d, biases):
    """Every input's gradient, the biases' summed over the lead slices that
    share them; the backward's chunks hold 2 lead slices here, so chunk
    edges and sums across chunks are crossed."""
    monkeypatch.setattr(tevo, "BWD_CHUNK_BYTES",
                        2 * tevo._BWD_BUFFERS * 4 * h * s * s)
    (q, k, v), bs = _inputs(lead, s, h, d, seed=s + d + 1, biases=biases)
    n_in = 3 + len(bs)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)

    def jloss(*args):
        out = jevo.DS4Sci_EvoformerAttention(args[0], args[1], args[2],
                                             list(args[3:]), interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=tuple(range(n_in)))(
        *(jnp.asarray(a) for a in (q, k, v, *bs)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, *bs)]
    out = tevo.DS4Sci_EvoformerAttention(t[0], t[1], t[2], t[3:])
    (out * torch.from_numpy(w)).sum().backward()
    for i, (tt, jw) in enumerate(zip(t, want)):
        assert tt.grad.shape == tt.shape
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jw),
                                   atol=GRAD_TOL, rtol=0, err_msg=str(i))


def test_routing_and_counts():
    """On the CPU every call takes the autograd Function with the plain
    forward (no launch counted), three biases and D = 12 included.
    :func:`kernel_route`, which the card's forward asks, reads only types
    and shapes: the tensor-core kernel for bf16 / fp16 with D % 8 == 0 up
    to 128 and up to eight biases of any float type (three, eight and an
    fp32 bias on bf16 inputs included), the general kernel for fp32, D not
    a multiple of 8 and D up to 256, NotImplementedError past that."""
    (q, k, v), bs = _inputs((1, 2), 16, 2, 8, seed=0)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = [torch.from_numpy(b) for b in bs]
    before = dict(tevo.LAUNCHES)
    (q12, k12, v12), _ = _inputs((1, 2), 16, 2, 12, seed=1)
    odd = [torch.from_numpy(a) for a in (q12, k12, v12)]
    for args in ((*t, tb), (*t, tb + [tb[1]]), (*odd, [])):
        leaves = [a.clone().requires_grad_() for a in args[:3]]
        out = tevo.DS4Sci_EvoformerAttention(*leaves, args[3])
        assert type(out.grad_fn).__name__ == "_EvoformerBackward"
        torch.testing.assert_close(
            out, tevo.evoformer_attention_dense(*args[:3], args[3]),
            rtol=0, atol=0)
    assert tevo.LAUNCHES == before

    def route(dtype, d=8, n_biases=2, bias_dtype=None):
        x = torch.zeros((1, 2, 16, 2, d), dtype=dtype)
        b = torch.zeros((1, 1, 2, 16, 16), dtype=bias_dtype or dtype)
        return tevo.kernel_route(x, x, x, [b] * n_biases)

    assert route(torch.bfloat16) == route(torch.float16) == "mma"
    assert route(torch.bfloat16, d=128, n_biases=0) == "mma"
    for kw in ({"n_biases": 3}, {"n_biases": 8},
               {"bias_dtype": torch.float32}):
        assert route(torch.bfloat16, **kw) == "mma", kw
    assert route(torch.float32) == "simt"
    for kw in ({"d": 12}, {"d": 136}, {"d": 256}):
        assert route(torch.bfloat16, **kw) == "simt", kw
    for kw in ({"d": 264}, {"n_biases": 9}, {"bias_dtype": torch.float64}):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            route(torch.bfloat16, **kw)
    with pytest.raises(NotImplementedError, match="one type"):
        tevo.kernel_route(t[0].bfloat16(), t[1], t[2])
    with pytest.raises(ValueError, match="not broadcastable"):
        tevo.DS4Sci_EvoformerAttention(*t, [torch.zeros(1, 2, 2, 16, 15)])
    with pytest.raises(ValueError, match="of one shape"):
        tevo.DS4Sci_EvoformerAttention(t[0], t[1][:, :1], t[2][:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        tevo.evoformer_attention_kernel(*t, tb)
    assert tevo.EvoformerAttnBuilder().load() is tevo


def test_lead_offsets_match_jax_bias_lead_index():
    lead = (2, 3, 4)
    for blead in ((2, 1, 4), (1, 3, 1), (2, 3, 4), (1, 1, 1)):
        f = jevo._bias_lead_index(lead, blead)
        want = [f(l) for l in range(24)]
        got = tevo._lead_offsets(lead, blead,
                                 tevo._contiguous_strides(blead))
        assert got.tolist() == want
