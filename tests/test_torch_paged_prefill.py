"""The port's tiled paged prefill (``paged_prefill_attention`` in
``deepspeed_tpu_torch/inference/v2/kernels/blocked_flash.py``) against the
JAX package's Pallas ``_prefill_kernel`` run in interpret mode on the CPU.
The port's wrapper takes its plain version for CPU tensors.  The cases are
those of ``tests/unit/test_inference_v2.py``'s tiled-prefill tests — two
tile-aligned chunks with pad rows, and a sliding window — plus a GQA case
with four query heads per KV head (Mixtral's grouping), with stripes whose
pad rows carry another slot than their stripe's.  Bar: f32 <= 2e-5 on
every row; pad rows exact zeros on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.kernels import blocked_flash as jbf
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf

TOL = 2e-5


def _case(name):
    if name == "pads":                # test_tiled_prefill_kernel_matches_xla
        rng = np.random.default_rng(15)
        bs, nb, hkv, d, h, tile, window = 8, 12, 2, 16, 4, 16, None
        tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
        t = 48
        slot = np.zeros((t,), np.int32)
        pos = np.full((t,), -1, np.int32)
        pos[0:22] = np.arange(10, 32)
        slot[32:41] = 1
        pos[32:41] = np.arange(0, 9)  # rows 41..47: pads of slot 0
    elif name == "window":     # test_tiled_prefill_kernel_window_matches_xla
        rng = np.random.default_rng(16)
        bs, nb, hkv, d, h, tile, window = 8, 12, 2, 16, 4, 16, 12
        tables = np.asarray([[1, 2, 3, 4]], np.int32)
        t = 32
        slot = np.zeros((t,), np.int32)
        pos = np.full((t,), -1, np.int32)
        pos[0:30] = np.arange(0, 30)
    else:                                            # GQA, G = 4
        rng = np.random.default_rng(17)
        bs, nb, hkv, d, h, tile, window = 8, 16, 2, 32, 8, 16, None
        tables = (rng.permutation(15) + 1)[:15].reshape(3, 5).astype(
            np.int32)
        t = 64
        slot = np.full((t,), 2, np.int32)
        pos = np.full((t,), -1, np.int32)
        slot[0:32] = 1
        pos[0:32] = np.arange(3, 35)           # two stripes of slot 1
        slot[32:48] = 0
        pos[32:45] = np.arange(0, 13)          # rows 45..47: pads, slot 0
        pos[48:64] = np.arange(20, 36)         # slot 2, a full stripe
    k_pool = rng.normal(size=(nb * bs, hkv, d)).astype(np.float32)
    v_pool = rng.normal(size=(nb * bs, hkv, d)).astype(np.float32)
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, slot, pos, bs, tile, window


@pytest.mark.parametrize("name", ["pads", "window", "gqa4"])
def test_plain_prefill_matches_pallas_interpret(name):
    q, k_pool, v_pool, tables, slot, pos, bs, tile, window = _case(name)
    want = np.asarray(jbf.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(slot), jnp.asarray(pos),
        block_size=bs, tile_q=tile, window=window, interpret=True))
    before = dict(tbf.LAUNCHES)
    got = tbf.paged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, slot,
                                        pos)),
        block_size=bs, tile_q=tile, window=window).numpy()
    assert tbf.LAUNCHES == before              # CPU tensors: plain version
    assert np.abs(got - want).max() <= TOL
    pads = pos < 0
    assert np.all(got[pads] == 0) and np.all(want[pads] == 0)


def test_prefill_refuses_unaligned_buffers():
    q, k_pool, v_pool, tables, slot, pos, bs, _, _ = _case("pads")
    with pytest.raises(ValueError, match="stripes"):
        tbf.paged_prefill_attention_plain(
            *(torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, slot,
                                            pos)),
            block_size=bs, tile_q=20)
