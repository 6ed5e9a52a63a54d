"""The port's ragged host structures against the JAX package's: the
block allocator (refcounts, the double-free check), the radix prefix cache
(attach, register, evict), the ragged batch metadata (byte-equal packed
arrays for the same insert sequence, aligned and unaligned) and the state
manager / KV cache on the CPU."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged import blocked_allocator as jalloc
from deepspeed_tpu.inference.v2.ragged import prefix_cache as jpc
from deepspeed_tpu.inference.v2.ragged import ragged_wrapper as jrw
from deepspeed_tpu.inference.v2.ragged import sequence_descriptor as jsd
from deepspeed_tpu_torch.inference.v2 import config_v2 as tcfg
from deepspeed_tpu_torch.inference.v2.ragged import blocked_allocator as talloc
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkv
from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache as tpc
from deepspeed_tpu_torch.inference.v2.ragged import ragged_manager as tmgr
from deepspeed_tpu_torch.inference.v2.ragged import ragged_wrapper as trw
from deepspeed_tpu_torch.inference.v2.ragged import sequence_descriptor as tsd


def _allocator_trace(mod):
    """The same allocate / acquire / free sequence; returns what it saw."""
    a = mod.BlockedAllocator(8)
    seen = [a.free_blocks]
    b = a.allocate(3)
    a.acquire(b[:1])
    seen += [list(b), a.refcount(b[0]), a.free_blocks]
    a.free(b)                       # b[0] drops to 1, the rest are freed
    seen += [a.refcount(b[0]), a.free_blocks]
    for bad in ([b[1]], [b[0], b[0]], [0]):
        with pytest.raises(ValueError):
            a.free(bad)             # double frees and the trash block
    seen.append(a.free_blocks)      # a refused free changes nothing
    a.free([b[0]])
    seen += [a.free_blocks, a.allocate(7)]
    with pytest.raises(RuntimeError):
        a.allocate(1)
    return seen


def test_allocator_matches_jax():
    assert _allocator_trace(talloc) == _allocator_trace(jalloc)


def _prefix_trace(alloc_mod, pc_mod):
    a = alloc_mod.BlockedAllocator(10)
    pc = pc_mod.RadixPrefixCache(a, block_size=4)
    toks = list(range(12))
    blocks = a.allocate(3)
    n, div = pc.insert(toks, blocks)
    hit = pc.match_blocks(toks[:8] + [99, 98, 97, 96])
    a.acquire(hit)                                  # a sequence attaches
    seen = [n, div, hit, pc.cached_blocks, pc.evictable_blocks]
    a.free(blocks)                                  # the writer flushes
    seen.append(pc.evictable_blocks)
    seen.append(pc.evict(5))                        # only the unshared leaf
    a.free(hit)                                     # the reader flushes
    seen += [pc.evictable_blocks, pc.evict(5), a.free_blocks,
             pc.cached_blocks, pc.stats.evicted_blocks]
    return seen


def test_prefix_cache_matches_jax():
    assert _prefix_trace(talloc, tpc) == _prefix_trace(jalloc, jpc)


def _metadata(rw_mod, sd_mod, align):
    w = rw_mod.RaggedBatchWrapper(token_budget=64, max_seqs=4,
                                  max_blocks=4, block_size=8)
    if align:
        w.set_alignment(align)
    seqs = [sd_mod.DSSequenceDescriptor(uid=1, seen_tokens=0, blocks=[2, 5]),
            sd_mod.DSSequenceDescriptor(uid=2, seen_tokens=9,
                                        blocks=[3, 1, 7]),
            sd_mod.DSSequenceDescriptor(uid=3, seen_tokens=4, blocks=[6])]
    for seq, n in zip(seqs, (11, 5, 3)):
        w.insert_sequence(seq, np.arange(100, 100 + n, dtype=np.int32))
    return w.finalize(64 if align else 32)


@pytest.mark.parametrize("align", [0, 16])
def test_batch_metadata_byte_equal(align):
    t = _metadata(trw, tsd, align)
    j = _metadata(jrw, jsd, align)
    tp, jp = trw.pack_metadata(t), jrw.pack_metadata(j)
    assert tp.dtype == jp.dtype == np.int32
    assert tp.tobytes() == jp.tobytes()
    # the device-side unpack gives back every field
    T = 64 if align else 32
    got = trw.unpack_metadata(torch.from_numpy(tp), T, 4, 4)
    for key, val in got.items():
        np.testing.assert_array_equal(val.numpy(), t[key])
    if align:
        assert (t["token_pos"][t["token_ids"] == 0] == -1).all()


def test_state_manager_and_kv_cache():
    sm = tmgr.DSStateManager(
        tcfg.DSStateManagerConfig.from_dict({"max_context": 16,
                                             "max_ragged_sequence_count": 2,
                                             "max_ragged_batch_size": 8}),
        tcfg.KVCacheConfig.from_dict({"block_size": 4}),
        num_layers=2, num_kv_heads=2, head_dim=8, dtype=torch.float32)
    free0 = sm.free_blocks
    seq = sm.get_or_create_sequence(1)
    sm.maybe_allocate_kv(seq, 6)
    assert len(seq.blocks) == 2 and sm.free_blocks == free0 - 2
    pool = sm.kv_cache.cache["layer_1"]["v"]
    assert pool.shape == (9 * 4, 2, 8) and pool.dtype == torch.float32
    pool[seq.blocks[0] * 4:(seq.blocks[0] + 1) * 4] = 3.0
    sm.kv_cache.copy_block(seq.blocks[0], seq.blocks[1])      # in place
    assert (pool[seq.blocks[1] * 4:(seq.blocks[1] + 1) * 4] == 3.0).all()
    assert sm.kv_cache.per_token_bytes == 2 * 2 * 2 * 8 * 4
    sm.flush_sequence(1)
    assert sm.free_blocks == free0
    with pytest.raises(ValueError):
        sm.flush_sequence(1)


@pytest.mark.parametrize("cfg", [
    {"tensor_parallel": {"tp_size": 2}},
])
def test_unported_options_raise(cfg):
    with pytest.raises(NotImplementedError):
        tcfg.RaggedInferenceEngineConfig.from_dict(cfg)


def test_kv_dtype_spellings():
    assert tkv.resolve_kv_dtype("bf16") == torch.bfloat16
    assert tkv.resolve_kv_dtype(torch.float32) == torch.float32
    with pytest.raises(ValueError):
        tkv.resolve_kv_dtype("fp4")
