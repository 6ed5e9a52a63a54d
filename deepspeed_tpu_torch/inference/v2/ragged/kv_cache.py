"""Blocked (paged) KV cache (counterpart of
``deepspeed_tpu/inference/v2/ragged/kv_cache.py`` ``BlockedKVCache``).

Device layout per layer: ``k/v: [num_blocks * block_size, Hkv, D]`` — a flat
pool indexed by ``block_id * block_size + offset``, the layout the paged
attention kernels read.  Ragged token writes are one ``index_copy_``; the
plain attention paths gather each sequence's rows through its block table.

The JAX package threads the pool through its jitted forward and donates the
old buffers, so each step *replaces* the pool.  Here the pools are torch
tensors that the forward updates **in place**: ``update`` only re-binds the
tree, and ``copy_block`` writes the destination rows directly.

The int8 KV mode (per-row/per-head fp32 scales) and the host-handoff
``gather_blocks``/``scatter_blocks`` are later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

#: accepted ``kv_cache.dtype`` spellings -> pool storage dtype
KV_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
    "f16": torch.float16, "float16": torch.float16,
    "int8": torch.int8,
}


def resolve_kv_dtype(dtype: Any) -> torch.dtype:
    """Map a config string (``"bf16" | "f32" | ...``) or torch dtype to the
    pool storage dtype.  int8 pools are not ported yet and raise."""
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in KV_DTYPES:
            raise ValueError(
                f"kv_cache dtype {dtype!r} not understood — one of "
                f"{sorted(KV_DTYPES)} (or a torch dtype)")
        dtype = KV_DTYPES[key]
    if dtype == torch.int8:
        raise NotImplementedError(
            "kv_cache.dtype=int8 (block-quantized KV) is not ported to "
            "deepspeed_tpu_torch yet; use bf16 or f32")
    return dtype


class BlockedKVCache:
    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: Any = torch.bfloat16, device="cpu"):
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = resolve_kv_dtype(dtype)
        shape = (num_blocks * block_size, num_kv_heads, head_dim)
        self.cache: Dict[str, Dict[str, torch.Tensor]] = {
            f"layer_{i}": {
                "k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device),
            }
            for i in range(num_layers)
        }

    def update(self, new_cache) -> None:
        """Re-bind the tree the forward returned (the same tensors, which
        it updated in place)."""
        self.cache = new_cache

    def copy_block(self, src: int, dst: int) -> None:
        """Copy one block's KV rows ``src -> dst`` across every layer (the
        prefix cache's copy-on-write fork), in place."""
        bs = self.block_size
        for layer in self.cache.values():
            for pool in layer.values():
                pool[dst * bs:(dst + 1) * bs].copy_(pool[src * bs:(src + 1) * bs])

    @property
    def per_token_bytes(self) -> int:
        """Device bytes one cached token occupies across every layer."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim \
            * itemsize
