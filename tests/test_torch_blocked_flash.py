"""The port's paged attention (``deepspeed_tpu_torch/inference/v2/kernels/
blocked_flash.py``) against the JAX package's Pallas kernels run in
interpret mode on the CPU: ``paged_decode_attention`` (one query per slot)
and the generic ``paged_attention`` (tokens of a ragged batch).  The port's
wrappers take their plain version for CPU tensors.  Bar: f32 <= 2e-5.

The inputs cover GQA (H/Hkv = 2), a sliding window, positions on a block
boundary, pad slots (position -1 -> zeros) and two slots whose tables share
a leading block (the prefix cache's case)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.kernels import blocked_flash as jbf
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_llama import (
    _paged_attention)

H, HKV = 4, 2


def _pool_and_tables(seed, bs, d, slots=5, width=4):
    """Pool with distinct, non-contiguous blocks per slot; slots 0 and 1
    share their leading block."""
    rng = np.random.default_rng(seed)
    nb = slots * width + 1
    k_pool = rng.standard_normal((nb * bs, HKV, d)).astype(np.float32)
    v_pool = rng.standard_normal((nb * bs, HKV, d)).astype(np.float32)
    tables = (rng.permutation(slots * width) + 1).reshape(slots, width)
    tables[1, 0] = tables[0, 0]
    return rng, k_pool, v_pool, tables.astype(np.int32)


def _both(fn_name, q, k_pool, v_pool, tables, slot, pos, bs, window):
    jfn = getattr(jbf, fn_name)
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k_pool),
                          jnp.asarray(v_pool), jnp.asarray(tables),
                          jnp.asarray(slot), jnp.asarray(pos),
                          block_size=bs, window=window, interpret=True))
    tfn = getattr(tbf, fn_name)
    launches = dict(tbf.LAUNCHES)
    got = tfn(torch.from_numpy(q), torch.from_numpy(k_pool),
              torch.from_numpy(v_pool), torch.from_numpy(tables),
              torch.from_numpy(slot), torch.from_numpy(pos),
              block_size=bs, window=window)
    assert tbf.LAUNCHES == launches          # CPU tensors: plain version
    return got.numpy(), want


@pytest.mark.parametrize("window", [None, 100])
def test_decode_matches_jax_kernel(window):
    bs, d = 128, 128
    rng, k_pool, v_pool, tables = _pool_and_tables(0, bs, d)
    # block edge (bs-1, bs), a pad slot (-1), a long context, and slot 1
    # reading the block it shares with slot 0
    pos = np.asarray([bs - 1, bs, -1, 2 * bs + 5, 450], np.int32)
    slot = np.arange(5, dtype=np.int32)
    q = rng.standard_normal((5, H, d)).astype(np.float32)
    got, want = _both("paged_decode_attention", q, k_pool, v_pool, tables,
                      slot, pos, bs, window)
    assert np.abs(got - want).max() <= 2e-5
    assert np.abs(got[2]).max() == 0.0                 # pad slot: zeros


@pytest.mark.parametrize("window", [None, 20])
def test_generic_matches_jax_kernel(window):
    bs, d = 16, 64
    rng, k_pool, v_pool, tables = _pool_and_tables(1, bs, d)
    # a ragged batch: a prefill chunk of slot 0 across a block edge, slot 1
    # over the shared block, a decode token of slot 3, tile-aligned pads
    # (slot 0, position -1) and unaligned pads (slot 0, position 0)
    slot = np.asarray([0] * 6 + [1] * 3 + [3] + [0] * 3 + [0] * 3, np.int32)
    pos = np.asarray([12, 13, 14, 15, 16, 17, 0, 1, 2, 50]
                     + [-1] * 3 + [0] * 3, np.int32)
    q = rng.standard_normal((len(pos), H, d)).astype(np.float32)
    got, want = _both("paged_attention", q, k_pool, v_pool, tables, slot,
                      pos, bs, window)
    assert np.abs(got - want).max() <= 2e-5
    assert np.abs(got[10:13]).max() == 0.0             # position -1: zeros


def test_plain_matches_ragged_llama_gather_path():
    """The kernels' plain version and the model's plain gather path (the
    JAX package's XLA composition) agree on every real row."""
    bs, d = 16, 64
    rng, k_pool, v_pool, tables = _pool_and_tables(2, bs, d)
    slot = np.asarray([0, 0, 1, 2, 4], np.int32)
    pos = np.asarray([3, 17, 30, 63, 40], np.int32)
    q = torch.from_numpy(rng.standard_normal((5, H, d)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (k_pool, v_pool)]
    batch = {"block_tables": torch.from_numpy(tables),
             "token_slot": torch.from_numpy(slot),
             "token_pos": torch.from_numpy(pos)}
    got = tbf.paged_attention(q, *args, batch["block_tables"],
                              batch["token_slot"], batch["token_pos"],
                              block_size=bs)
    want = _paged_attention(q, *args, batch, bs, use_kernel=False)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_usable_on_cpu_and_gqa_rule():
    q = torch.zeros((2, 4, 64))
    assert tbf.paged_attention_usable(q, torch.zeros((16, 2, 64)), 8)
    assert not tbf.paged_attention_usable(q, torch.zeros((16, 3, 64)), 8)


@pytest.mark.parametrize("group,d,window", [(1, 64, None), (4, 64, 20),
                                            (8, 128, None)])
def test_generic_any_token_order_matches_jax(group, d, window):
    """The generic kernel's contract holds for any token order: the tiled
    CUDA kernel walks each distinct slot of a 64-row stripe once, so a
    shuffled batch — one slot's tokens in two runs, pads and decode tokens
    between them — must give what the JAX package's per-token kernel
    gives (G = H / Hkv query heads a KV head: 1, 4 and 8)."""
    bs = 16
    rng, k_pool, v_pool, tables = _pool_and_tables(3 + group, bs, d)
    slot = np.asarray([0] * 20 + [1] * 6 + [3] + [0] * 14
                      + [2] * 9 + [0] * 4, np.int32)
    pos = np.asarray(list(range(20)) + list(range(40, 46)) + [50]
                     + list(range(20, 34)) + list(range(3, 12))
                     + [-1] * 4, np.int32)
    order = rng.permutation(len(pos))[:24]
    order = np.concatenate([np.sort(order), np.setdiff1d(
        np.arange(len(pos)), order)])               # two sorted runs
    slot, pos = slot[order], pos[order]
    h = group * HKV
    q = rng.standard_normal((len(pos), h, d)).astype(np.float32)
    jfn = jbf.paged_attention
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k_pool),
                          jnp.asarray(v_pool), jnp.asarray(tables),
                          jnp.asarray(slot), jnp.asarray(pos),
                          block_size=bs, window=window, interpret=True))
    launches = dict(tbf.LAUNCHES)
    got = tbf.paged_attention(
        *(torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, slot,
                                        pos)), block_size=bs, window=window)
    assert tbf.LAUNCHES == launches
    assert np.abs(got.numpy() - want).max() <= 2e-5
    assert np.abs(got.numpy()[pos < 0]).max() == 0.0
