"""The port's decode and verify wrappers (``paged_decode_attention`` and
``paged_verify_attention`` in ``deepspeed_tpu_torch/inference/v2/kernels/
blocked_flash.py``) against the JAX package's Pallas kernels run in
interpret mode on the CPU, over the shapes the CUDA kernel takes: G = 1,
4 and 8 query heads a KV head, up to 16 query rows a unit (K x G), D = 64
and 128, f32 and int8 pools, block sizes 8, 16, 64 and 128, windows that
leave a unit one live tile or none before its frontier, pad units,
one-tile contexts and contexts that cross many blocks.  For CPU tensors
the wrappers take their plain version.  Bar: f32 <= 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.kernels import blocked_flash as jbf
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import quantize_kv

HKV, SLOTS = 2, 5
TOL = 2e-5
CAPACITY = 512

# (k_tokens, G, D, int8, block size, window); k_tokens 1: decode
CASES = [
    (1, 1, 64, False, 8, None),
    (1, 4, 128, True, 16, None),
    (1, 8, 64, True, 64, 20),
    (1, 1, 128, False, 64, 100),
    (1, 4, 64, False, 8, 30),
    (1, 8, 128, False, 16, None),
    (1, 1, 128, True, 8, 20),
    (1, 4, 64, True, 64, None),
    (1, 8, 128, True, 128, 1),
    (1, 2, 64, False, 128, None),
    (4, 1, 128, False, 16, None),
    (4, 4, 64, True, 8, 24),
    (2, 8, 128, True, 64, None),
    (5, 1, 64, False, 64, 24),
    (3, 4, 128, False, 8, None),
    (2, 8, 64, False, 16, 40),
    (16, 1, 64, True, 16, 70),
    (4, 4, 128, False, 128, None),
    (5, 2, 128, True, 128, 3),
    (8, 2, 64, False, 8, None),
]

#: decode positions: a one-tile context, a tile edge, a pad unit (-1), a
#: block-crossing middle and a long context; verify: each slot's first
#: position (rows pos0 .. pos0 + K - 1)
DECODE_POS = [10, 63, -1, 200, 450]
VERIFY_POS0 = [37, 5, 300, 0, 441]


def _inputs(seed, k_tokens, group, d, int8, bs):
    rng = np.random.default_rng(seed)
    width = CAPACITY // bs
    nb = SLOTS * width + 1
    kf, vf = (rng.standard_normal((nb * bs, HKV, d)).astype(np.float32)
              for _ in range(2))
    tables = (rng.permutation(SLOTS * width) + 1).reshape(SLOTS, width)
    tables[1, 0] = tables[0, 0]             # slots 0 and 1 share a block
    if k_tokens == 1:
        pos = np.asarray(DECODE_POS, np.int32)
    else:
        pos = (np.asarray(VERIFY_POS0)[:, None]
               + np.arange(k_tokens)[None, :]).reshape(-1).astype(np.int32)
    slot = np.repeat(np.arange(SLOTS), k_tokens).astype(np.int32)
    q = rng.standard_normal((len(pos), group * HKV, d)).astype(np.float32)
    scales = {}
    if int8:
        (kf, ks), (vf, vs) = ((t.numpy() for t in quantize_kv(
            torch.from_numpy(a))) for a in (kf, vf))
        scales = {"k_scale": ks, "v_scale": vs}
    return q, kf, vf, tables.astype(np.int32), slot, pos, scales


@pytest.mark.parametrize("k_tokens,group,d,int8,bs,window", CASES)
def test_decode_verify_match_jax_kernels(k_tokens, group, d, int8, bs,
                                         window):
    q, kf, vf, tables, slot, pos, scales = _inputs(
        k_tokens * 100 + group * 10 + bs, k_tokens, group, d, int8, bs)
    arrs = (q, kf, vf, tables, slot, pos)
    jargs = [jnp.asarray(a) for a in arrs]
    jscales = {k: jnp.asarray(v) for k, v in scales.items()}
    targs = [torch.from_numpy(a) for a in arrs]
    tscales = {k: torch.from_numpy(v) for k, v in scales.items()}
    launches = dict(tbf.LAUNCHES)
    if k_tokens == 1:
        want = jbf.paged_decode_attention(*jargs, block_size=bs,
                                          window=window, interpret=True,
                                          **jscales)
        got = tbf.paged_decode_attention(*targs, block_size=bs,
                                         window=window, **tscales)
    else:
        want = jbf.paged_verify_attention(*jargs, block_size=bs,
                                          k_tokens=k_tokens, window=window,
                                          interpret=True, **jscales)
        got = tbf.paged_verify_attention(*targs, block_size=bs,
                                         k_tokens=k_tokens, window=window,
                                         **tscales)
    assert tbf.LAUNCHES == launches          # CPU tensors: plain version
    got = got.numpy()
    assert np.abs(got - np.asarray(want)).max() <= TOL
    if k_tokens == 1:                       # the pad unit: exact zeros
        assert np.abs(got[DECODE_POS.index(-1)]).max() == 0.0
