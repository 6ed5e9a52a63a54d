"""The port's folded and paired flash attention (its plain versions, the CPU
path) against the JAX package's folded and paired Pallas kernels run in
interpret mode, and their ``jax.vjp``.

Bars: f32 forward <= 2e-5 and gradients <= 1e-4; bf16 forward <= 2e-2 and
gradients <= 2.5e-1 (max abs).  Inputs are made with numpy from a seed and
handed to both sides; on the port's side q, k and v are column views of one
fused ``[B, S, (H + 2 Hkv) D]`` buffer, as a fused projection leaves them.
Also: the geometry rules equal the JAX package's, the dispatchers' fallback
chain (paired -> folded -> bshd), and that the views reach the plain
functions uncopied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import flash_attention as tfa

BARS = {"f32": (2e-5, 1e-4), "bf16": (2e-2, 2.5e-1)}
ENTRIES = {"folded": (jfa.flash_attention_folded, tfa.flash_attention_folded),
           "paired": (jfa.flash_attention_paired, tfa.flash_attention_paired)}


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    """q [B,Sq,H*D], k / v [B,Sk,Hkv*D], dO [B,Sq,H*D], numpy f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h * d), (b, sk, hkv * d), (b, sk, hkv * d),
                          (b, sq, h * d))]


def _fused_views(q, k, v, dtype):
    """q, k and v as column views of one fused buffer (Sq == Sk), or as
    tensors of their own (rectangular), with ``requires_grad`` on the
    leaf(s)."""
    if q.shape[1] != k.shape[1]:
        leaves = [torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v)]
        return leaves, leaves
    buf = torch.tensor(np.concatenate([q, k, v], axis=-1), dtype=dtype,
                       requires_grad=True)
    return [buf], buf.split([q.shape[-1], k.shape[-1], v.shape[-1]], dim=-1)


CASES = [
    # entry, b, sq, sk, h, hkv, d, window, block, dtype
    ("folded", 1, 128, 128, 4, 4, 64, None, None, "f32"),
    ("paired", 1, 128, 128, 4, 4, 64, None, None, "f32"),
    ("folded", 2, 128, 128, 4, 2, 64, None, None, "f32"),
    ("paired", 2, 128, 128, 4, 2, 64, None, None, "f32"),
    ("folded", 1, 128, 128, 2, 2, 128, None, None, "f32"),
    ("folded", 1, 128, 128, 8, 8, 32, None, None, "f32"),
    ("paired", 1, 128, 128, 8, 8, 32, None, None, "f32"),
    ("folded", 1, 256, 256, 4, 2, 64, 100, 128, "f32"),     # sliding window
    ("paired", 1, 256, 256, 4, 2, 64, 100, 128, "f32"),
    ("folded", 1, 128, 256, 4, 4, 64, None, 128, "f32"),    # rectangular
    ("paired", 1, 128, 256, 4, 2, 64, None, 128, "f32"),
    ("folded", 1, 128, 128, 4, 2, 64, None, None, "bf16"),
    ("paired", 1, 128, 128, 4, 2, 64, None, None, "bf16"),
]


@pytest.mark.parametrize("entry,b,sq,sk,h,hkv,d,window,block,dtype", CASES)
def test_layout_entry_matches_interpret_kernel(entry, b, sq, sk, h, hkv, d,
                                               window, block, dtype):
    jfn, tfn = ENTRIES[entry]
    fwd_tol, grad_tol = BARS[dtype]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    q, k, v, do = _inputs(b, sq, sk, h, hkv, d, seed=sq + h + d)

    def jf(q_, k_, v_):
        return jfn(q_, k_, v_, num_heads=h, num_kv_heads=hkv, causal=True,
                   window=window, block_q=block, block_k=block,
                   interpret=True)

    jo, vjp = jax.vjp(jf, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = [np.asarray(g, np.float32)
              for g in vjp(jnp.asarray(do, jdt))]
    leaves, (tq, tk, tv) = _fused_views(q, k, v, tdt)
    to = tfn(tq, tk, tv, num_heads=h, num_kv_heads=hkv, causal=True,
             window=window, block_q=block, block_k=block)
    assert to.shape == (b, sq, h * d) and to.dtype == tdt
    to.backward(torch.tensor(do, dtype=tdt))
    if len(leaves) == 1:
        grads = leaves[0].grad.split([h * d, hkv * d, hkv * d], dim=-1)
    else:
        grads = [t.grad for t in leaves]
    np.testing.assert_allclose(to.detach().float().numpy(),
                               np.asarray(jo, np.float32), atol=fwd_tol,
                               rtol=0)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.float().numpy(), want, atol=grad_tol,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 64, 96, 128, 192, 256])
def test_heads_per_block_rules_equal_jax(d):
    for h in range(1, 17):
        for hkv in range(1, h + 1):
            for tfn, jfn in ((tfa.folded_heads_per_block,
                              jfa.folded_heads_per_block),
                             (tfa.paired_heads_per_block,
                              jfa.paired_heads_per_block)):
                assert tfn(h, hkv, d) == jfn(h, hkv, d), (tfn, h, hkv, d)


def test_usable_on_the_cpu_is_the_shape_rules():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 4, 2, 64))
    for usable in (tfa.flash_attention_folded_usable,
                   tfa.flash_attention_paired_usable):
        assert usable(q, k, v, 4, 2, True, None)
        assert not usable(q, k, v, 4, 2, True, torch.ones(1, dtype=bool))
        assert not usable(q[..., :-1], k, v, 4, 2, True, None)
        assert not usable(q.unflatten(-1, (4, 64)), k, v, 4, 2, True, None)
    # d = 128: folded takes it, pairing does not apply
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 2, 2, 128))
    assert tfa.flash_attention_folded_usable(q, k, v, 2, 2, True, None)
    assert not tfa.flash_attention_paired_usable(q, k, v, 2, 2, True, None)
    # 3 heads of d = 64: no lane-aligned grouping for either
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 3, 3, 64))
    assert not tfa.flash_attention_folded_usable(q, k, v, 3, 3, True, None)
    assert not tfa.flash_attention_paired_usable(q, k, v, 3, 3, True, None)


def _spy(monkeypatch, module, names):
    calls = []
    for name in names:
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("h,hkv,d,route", [
    (4, 2, 64, "flash_attention_paired"),
    (2, 2, 128, "flash_attention_folded"),      # d >= 128: paired -> folded
    (4, 4, 16, "flash_attention"),               # GPT2Config.tiny: -> bshd
])
@pytest.mark.parametrize("implementation", ["auto", "plain"])
def test_paired_attention_fallback_chain(monkeypatch, h, hkv, d, route,
                                         implementation):
    """The route each geometry takes, shown by spies on the entries, and
    the output against the JAX package's bshd flash kernel (interpret
    mode) on the same heads."""
    calls = _spy(monkeypatch, tattn, ["flash_attention_paired",
                                      "flash_attention_folded",
                                      "flash_attention"])
    q, k, v, _ = _inputs(1, 64, 64, h, hkv, d, seed=d)
    got = tattn.paired_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), num_heads=h,
        num_kv_heads=hkv, causal=True, implementation=implementation)
    want = jax.jit(lambda a, b_, c: jfa.flash_attention(
        a.reshape(1, 64, h, d), b_.reshape(1, 64, hkv, d),
        c.reshape(1, 64, hkv, d), causal=True, interpret=True))(q, k, v)
    assert calls == [route]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(got.shape),
                               atol=2e-5, rtol=0)


def test_views_of_a_fused_buffer_reach_the_plain_functions_uncopied(
        monkeypatch):
    """k and v, column views of one fused projection output, reach the
    forward and both backward functions as the same memory (q is the
    pre-scaled copy, as in the JAX package)."""
    h, hkv, d = 4, 2, 64
    buf = torch.randn(2, 32, (h + 2 * hkv) * d, requires_grad=True)
    q, k, v = buf.split([h * d, hkv * d, hkv * d], dim=-1)
    seen = []
    for name in ("flash_attention_plain_fwd", "flash_attention_plain_bwd_dq",
                 "flash_attention_plain_bwd_dkv"):
        real = getattr(tfa, name)

        def spy(qs, k_, v_, *a, _real=real, **kw):
            seen.append((k_.data_ptr(), v_.data_ptr(), k_.stride(1)))
            return _real(qs, k_, v_, *a, **kw)

        monkeypatch.setattr(tfa, name, spy)
    out = tattn.paired_attention(q, k, v, num_heads=h, num_kv_heads=hkv)
    out.sum().backward()
    want = (k.data_ptr(), v.data_ptr(), buf.shape[-1])
    assert len(seen) == 3 and all(s == want for s in seen)


def test_entries_raise_as_jax_does():
    x = torch.zeros((1, 128, 4 * 64))
    for entry, fn in (("folded", tfa.flash_attention_folded),
                      ("paired", tfa.flash_attention_paired)):
        with pytest.raises(NotImplementedError, match="custom masks"):
            fn(x, x, x, num_heads=4, mask=torch.ones(1, dtype=bool))
        with pytest.raises(ValueError, match="requires causal"):
            fn(x, x, x, num_heads=4, causal=False, window=8)
        with pytest.raises(ValueError, match="positive"):
            fn(x, x, x, num_heads=4, window=0)
        with pytest.raises(ValueError, match="rank-3"):
            fn(x.unflatten(-1, (4, 64)), x, x, num_heads=4)
        with pytest.raises(ValueError, match="GQA"):
            fn(x, x, x, num_heads=4, num_kv_heads=3)
        with pytest.raises(ValueError, match="divisible"):
            fn(x[..., :-1], x, x, num_heads=4)
        with pytest.raises(ValueError, match="must divide blocks"):
            fn(x, x, x, num_heads=4, block_q=96)
        assert fn(x, x, x, num_heads=4, block_q=64, block_k=128,
                  interpret=True).shape == x.shape
    x3 = torch.zeros((1, 128, 3 * 64))
    with pytest.raises(ValueError, match="lane-aligned"):
        tfa.flash_attention_folded(x3, x3, x3, num_heads=3)
    x128 = torch.zeros((1, 128, 2 * 128))
    with pytest.raises(ValueError, match="lane-full"):
        tfa.flash_attention_paired(x128, x128, x128, num_heads=2)
