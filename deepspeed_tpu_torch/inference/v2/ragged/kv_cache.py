"""Blocked (paged) KV cache (counterpart of
``deepspeed_tpu/inference/v2/ragged/kv_cache.py`` ``BlockedKVCache``).

Device layout per layer: ``k/v: [num_blocks * block_size, Hkv, D]`` — a flat
pool indexed by ``block_id * block_size + offset``, the layout the paged
attention kernels read.  Ragged token writes are one ``index_copy_``; the
plain attention paths gather each sequence's rows through its block table.

**Quantized mode** (``dtype="int8"``): the pool stores symmetric int8
payloads, and fp32 scale records ride beside them in the same tree —
``k_scale/v_scale: [num_blocks * block_size, Hkv]``, one scale per pool row
per KV head (the quantization group is one head's D-vector, absmax/127).
The scales share the pool's row indexing, so every block operation
(``copy_block``, the ``gather_blocks`` / ``scatter_blocks`` handoff) moves
payload and scales together.  Writes quantize on insert
(:func:`quantize_kv`); the paged kernels dequantize on their block walk.

The JAX package threads the pool through its jitted forward and donates the
old buffers, so each step *replaces* the pool.  Here the pools are torch
tensors that the forward updates **in place**: ``update`` only re-binds the
tree, and ``copy_block`` / ``scatter_blocks`` write the destination rows
directly.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

#: accepted ``kv_cache.dtype`` spellings -> pool storage dtype
KV_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "fp32": torch.float32, "float32": torch.float32,
    "f16": torch.float16, "float16": torch.float16,
    "int8": torch.int8,
}


def resolve_kv_dtype(dtype: Any) -> torch.dtype:
    """Map a config string (``"bf16" | "int8" | ...``) or torch dtype to the
    pool storage dtype."""
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in KV_DTYPES:
            raise ValueError(
                f"kv_cache dtype {dtype!r} not understood — one of "
                f"{sorted(KV_DTYPES)} (or a torch dtype)")
        return KV_DTYPES[key]
    return dtype


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantize per (row, KV head) over the head vector:
    ``x [..., Hkv, D] -> (q int8 same shape, scale fp32 [..., Hkv])`` with
    ``scale = absmax / 127`` (1.0 for an all-zero vector).  A true division
    and round-half-to-even, as the JAX package computes it, so both write
    the same records bit for bit."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the plain paths' read; the kernels
    fold the scales into their block walk instead)."""
    return (q.float() * scale[..., None].float()).to(dtype)


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
        self.device = torch.device(device)
        #: int8 pools carry per-row / per-head fp32 scale records in-tree
        self.quantized = self.dtype == torch.int8
        rows = num_blocks * block_size

        def layer():
            leaves = {
                "k": torch.zeros((rows, num_kv_heads, head_dim),
                                 dtype=self.dtype, device=device),
                "v": torch.zeros((rows, num_kv_heads, head_dim),
                                 dtype=self.dtype, device=device),
            }
            if self.quantized:
                # scale 1.0 on never-written rows: the zero payload
                # dequantizes to zero, as in an unquantized pool
                for name in ("k_scale", "v_scale"):
                    leaves[name] = torch.ones((rows, num_kv_heads),
                                              dtype=torch.float32,
                                              device=device)
            return leaves

        self.cache: Dict[str, Dict[str, torch.Tensor]] = {
            f"layer_{i}": layer() for i in range(num_layers)
        }

    def update(self, new_cache) -> None:
        """Re-bind the tree the forward returned (the same tensors, which
        it updated in place)."""
        self.cache = new_cache

    def copy_block(self, src: int, dst: int) -> None:
        """Copy one block's rows ``src -> dst`` across every layer and leaf
        (payload and scales; the prefix cache's copy-on-write fork), in
        place."""
        bs = self.block_size
        for layer in self.cache.values():
            for pool in layer.values():
                pool[dst * bs:(dst + 1) * bs].copy_(pool[src * bs:(src + 1) * bs])

    def _block_rows(self, blocks: Sequence[int]) -> torch.Tensor:
        """Flat pool row indices covering ``blocks`` in table order."""
        base = np.asarray(blocks, np.int64)[:, None] * self.block_size
        rows = (base + np.arange(self.block_size, dtype=np.int64)).ravel()
        return torch.from_numpy(rows).to(self.device)

    def gather_blocks(self, blocks: Sequence[int]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The rows of ``blocks`` (one sequence's block table) copied to the
        host: ``{layer: {leaf: [len(blocks) * block_size, ...]}}`` for every
        leaf, scales included — the disaggregated prefill → decode handoff
        payload.  Row order follows the table, so position ``p`` lives at
        row ``p`` whichever physical blocks held it."""
        rows = self._block_rows(blocks)
        return {lname: {leaf: pool[rows].cpu() for leaf, pool in layer.items()}
                for lname, layer in self.cache.items()}

    def scatter_blocks(self, blocks: Sequence[int], host_tree) -> None:
        """Write a :meth:`gather_blocks` payload (torch tensors or numpy
        arrays) into ``blocks`` of this pool, in place.  Its leaves and
        shapes must match this cache's geometry — a handoff between
        replicas of different geometry is a deployment error, not a
        cast."""
        rows = self._block_rows(blocks)
        n = rows.numel()
        for lname, layer in self.cache.items():
            src = host_tree[lname]
            if set(src) != set(layer):
                raise ValueError(
                    f"scatter_blocks: payload leaves {sorted(src)} do not "
                    f"match the cache's {sorted(layer)} (KV dtype differs)")
            for leaf, pool in layer.items():
                h = src[leaf]
                if not isinstance(h, torch.Tensor):   # a (read-only) array
                    h = torch.from_numpy(np.array(h))
                if tuple(h.shape) != (n,) + tuple(pool.shape[1:]):
                    raise ValueError(
                        f"scatter_blocks: payload {tuple(h.shape)} does not "
                        f"match {(n,) + tuple(pool.shape[1:])} (cache "
                        f"geometry differs)")
                pool.index_copy_(0, rows, h.to(device=pool.device,
                                               dtype=pool.dtype))

    @property
    def per_token_bytes(self) -> int:
        """Device bytes one cached token occupies across every layer — in
        int8 mode the payload byte per element plus the fp32 scale per
        (row, head)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_head = self.head_dim * itemsize
        if self.quantized:
            per_head += 4
        return 2 * self.num_layers * self.num_kv_heads * per_head
