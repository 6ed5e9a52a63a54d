"""One ragged forward of the port's ``RaggedLlama`` against the JAX
package's on the same f32 weights, KV pool and batch: a prefill batch
(three sequences, SplitFuse-style packing, unaligned and tile-aligned),
then a decode batch over the KV it wrote.  Projections are plain f32
kernels or int8 records; the decode batch runs over a tight pool (the
masked dense path) and a large one (the gather path).  Bars: logits
<= 1e-4 max abs, written KV pools within 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine_v2 as jeng
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.inference.v2.ragged import BlockedKVCache as JKVCache
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import engine_v2 as teng
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.inference.v2.ragged import (BlockedAllocator,
                                                     BlockedKVCache,
                                                     RaggedBatchWrapper)
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (
    DSSequenceDescriptor)
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig
from torch_port_common import llama_params, tiny_geometry

BS, S, B = 8, 4, 8          # block size, max sequences, table width


def _pools_np(cache):
    return {f"{layer}/{k}": np.asarray(v) for layer, kv in cache.items()
            for k, v in kv.items()}


@pytest.mark.parametrize("align", [0, 16])
@pytest.mark.parametrize("pool_blocks", [S * B + 1, 200])
@pytest.mark.parametrize("int8", [False, True])
def test_forward_matches_jax(int8, pool_blocks, align):
    geom = tiny_geometry()
    params = llama_params(geom, seed=7, int8=int8)
    jmodel = JRaggedLlama(JLlamaConfig(**geom, dtype=jnp.float32), BS)
    tmodel = TRaggedLlama(TLlamaConfig(**geom, dtype=torch.float32), BS)
    hkv = geom["num_key_value_heads"]
    d = geom["hidden_size"] // geom["num_attention_heads"]
    L = geom["num_hidden_layers"]
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_jax(params, device="cpu")
    jcache = JKVCache(L, pool_blocks, BS, hkv, d, dtype=jnp.float32).cache
    tcache = BlockedKVCache(L, pool_blocks, BS, hkv, d,
                            dtype=torch.float32).cache

    # prefill: three sequences, the first spilling over two blocks
    rng = np.random.default_rng(11)
    alloc = BlockedAllocator(pool_blocks)
    alloc.allocate(5)                      # non-trivial block ids
    w = RaggedBatchWrapper(token_budget=64, max_seqs=S, max_blocks=B,
                           block_size=BS)
    if align:
        w.set_alignment(align)
    seqs = []
    for uid, n in enumerate((19, 7, 12)):
        seq = DSSequenceDescriptor(uid=uid, blocks=alloc.allocate(-(-n // BS)))
        w.insert_sequence(seq, rng.integers(0, geom["vocab_size"], n))
        seqs.append((seq, n))
    meta = w.finalize(64)
    jbatch = {k: jnp.asarray(v) for k, v in meta.items() if k != "n_valid"}
    tbatch = {k: torch.from_numpy(v) for k, v in meta.items()
              if k != "n_valid"}
    jlog, jcache = jmodel(jparams, jcache, jbatch)
    tlog, tcache = tmodel(tparams, tcache, tbatch)
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() <= 1e-4

    # decode: one token per live sequence at its next position
    tables = np.full((S, B), BlockedAllocator.TRASH_BLOCK, np.int32)
    pos = np.zeros((S,), np.int32)
    for i, (seq, n) in enumerate(seqs):
        if n % BS == 0:
            seq.blocks += alloc.allocate(1)
        tables[i, :len(seq.blocks)] = seq.blocks
        pos[i] = n
    tok = rng.integers(0, geom["vocab_size"], S).astype(np.int32)
    jdec = jeng._device_decode_batch(jnp.asarray(tables), jnp.asarray(pos),
                                     jnp.asarray(tok), BS, B)
    tdec = teng._device_decode_batch(torch.from_numpy(tables),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(tok), BS, B)
    for key in jdec:
        np.testing.assert_array_equal(tdec[key].numpy(),
                                      np.asarray(jdec[key]))
    jlog, jcache = jmodel(jparams, jcache, jdec, decode=True)
    tlog, tcache = tmodel(tparams, tcache, tdec, decode=True)
    assert np.abs(tlog.numpy() - np.asarray(jlog)).max() <= 1e-4

    tpools, jpools = _pools_np(tcache), _pools_np(jcache)
    for key in jpools:
        # the trash block (rows [0, BS)) takes every pad write
        assert np.abs(tpools[key][BS:] - jpools[key][BS:]).max() <= 2e-5
