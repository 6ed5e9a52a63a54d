"""The port's flash attention (its plain versions, the CPU path) against the
JAX package's Pallas kernels run in interpret mode, and their ``jax.vjp``.

Bars (f32): forward <= 2e-5, gradients <= 1e-4, max abs.  Inputs are made
with numpy from a seed and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import attention as jattn
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import attention as tattn
from deepspeed_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                          (b, sq, h, d))]


@pytest.mark.parametrize("b,sq,sk,h,hkv,causal,window,scale,block", [
    (2, 128, 128, 4, 4, True, None, None, None),     # causal MHA
    (2, 128, 128, 4, 2, False, None, None, None),    # full, GQA
    (1, 256, 256, 4, 2, True, None, None, 128),      # blocks split S
    (1, 256, 256, 4, 2, True, 100, None, 128),       # sliding window
    (1, 128, 256, 4, 2, True, None, None, None),     # rectangular
    (1, 128, 256, 4, 4, True, 50, None, 128),        # rect + window
    (2, 128, 128, 4, 1, True, None, 0.3, None),      # custom scale, GQA 4
])
def test_flash_attention_matches_interpret_kernel(b, sq, sk, h, hkv, causal,
                                                  window, scale, block):
    q, k, v, do = _inputs(b, sq, sk, h, hkv, 64, seed=sq + h)

    def jf(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   scale=scale, block_q=block,
                                   block_k=block, interpret=True)

    jo, vjp = jax.vjp(jf, q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                             scale=scale)
    to.backward(torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=FWD_TOL, rtol=0)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,window", [(128, 128, None), (128, 256, 70)])
def test_lse_matches_interpret_kernel(sq, sk, window):
    """The forward's log-sum-exp residual (the TPU stores it 8 wide, the
    port 1 wide)."""
    q, k, v, _ = _inputs(1, sq, sk, 4, 2, 64, seed=7)
    qs = q * np.float32(64 ** -0.5)
    _, jlse = jfa._fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                         for x in (qs, k, v)), causal=True, block_q=sq,
                       block_k=128, interpret=True, window=window)
    _, tlse = tfa.flash_attention_plain_fwd(
        torch.from_numpy(qs), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FWD_TOL, rtol=0)


def test_rows_that_see_no_key_are_zero():
    """Sq > Sk, end-aligned: the first Sq - Sk rows see nothing; they come
    out as zeros with a finite lse, and their gradients are zero."""
    q, k, v, do = _inputs(1, 96, 64, 2, 2, 64)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    o.backward(torch.from_numpy(do))
    assert torch.isfinite(o).all() and o[:, :32].abs().max() == 0
    assert tq.grad[:, :32].abs().max() == 0
    _, lse = tfa.flash_attention_plain_fwd(tq.detach(), tk.detach(),
                                           tv.detach(), causal=True)
    assert torch.isfinite(lse).all()
    # the rows that do see keys match the composition
    want = tattn._xla_attention(tq.detach(), tk.detach(), tv.detach(),
                                causal=True, mask=None, scale=None)
    np.testing.assert_allclose(o[:, 32:].detach().numpy(),
                               want[:, 32:].numpy(), atol=FWD_TOL)


@pytest.mark.parametrize("kind", ["mask", "bias"])
def test_mask_and_bias_take_the_plain_composition(kind):
    """``dot_product_attention`` sends a mask or a bias to the plain
    composition, as the JAX package sends them to XLA."""
    q, k, v, _ = _inputs(2, 32, 32, 4, 2, 64, seed=3)
    rng = np.random.default_rng(4)
    if kind == "mask":
        extra = rng.random((2, 1, 32, 32)) > 0.3
        extra[..., 0] = True
    else:
        extra = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    want = jattn.dot_product_attention(q, k, v, causal=True,
                                       **{kind: extra})
    got = tattn.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        **{kind: torch.from_numpy(extra)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)


@pytest.mark.parametrize("implementation", ["auto", "plain"])
def test_dot_product_attention_routes_to_flash(implementation):
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 64, seed=5)
    want = jattn.dot_product_attention(q, k, v, causal=True, window=16)
    got = tattn.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=16,
        implementation=implementation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL)


def test_unported_layouts_and_bad_arguments_raise():
    """The folded and paired layouts are ported (they no longer raise:
    their outputs equal the bshd path's); bad arguments still raise."""
    x = torch.from_numpy(_inputs(1, 8, 8, 4, 4, 64)[0]).flatten(2)
    want = tfa.flash_attention(*(x.unflatten(-1, (4, 64)),) * 3).flatten(2)
    for fn in (tattn.folded_attention, tattn.paired_attention):
        torch.testing.assert_close(fn(x, x, x, num_heads=4), want,
                                   atol=0, rtol=0)
        with pytest.raises(ValueError, match="implementation"):
            fn(x, x, x, num_heads=4, implementation="pallas")
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="GQA"):
        tfa.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="attention_layout"):
        tattn.set_default_attention_layout("nope")
