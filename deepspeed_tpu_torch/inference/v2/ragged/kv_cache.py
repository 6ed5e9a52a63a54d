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

from typing import Any, Dict, List, Sequence, Tuple

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
        self._layout = None       # see _record_layout
        self._stage = None        # the pinned staging buffer (a GPU pool)
        self._stage_read = None   # an event: the last transfer out of it

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

    def gather_blocks(self, blocks: Sequence[int], per_block: bool = False):
        """The rows of ``blocks`` (one sequence's block table) copied to the
        host: ``{layer: {leaf: [len(blocks) * block_size, ...]}}`` for every
        leaf, scales included — the disaggregated prefill -> decode handoff
        payload.  Row order follows the table, so position ``p`` lives at
        row ``p`` whichever physical blocks held it.

        Every leaf of every layer is gathered on the device and copied,
        without blocking, into one host buffer (pinned when the pool is on
        a GPU), followed by one synchronization: one round trip for the
        whole tree instead of one per leaf.  The returned tensors are views
        of that buffer.

        ``per_block=True`` returns instead one *block record* per block, in
        table order: the same tree with ``block_size`` rows a leaf, viewing
        one host buffer of that block alone (the host tier's spool, whose
        entries are dropped block by block).  See :meth:`_gather_records`."""
        if per_block:
            return self._gather_records(blocks)
        rows = self._block_rows(blocks)
        parts = [(lname, leaf, pool.index_select(0, rows))
                 for lname, layer in self.cache.items()
                 for leaf, pool in layer.items()]
        offsets, total = [], 0
        for _, _, t in parts:
            offsets.append(total)
            total += -(-t.numel() * t.element_size() // 16) * 16
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for (lname, leaf, t), off in zip(parts, offsets):
            n = t.numel() * t.element_size()
            view = host[off:off + n].view(t.dtype).view(t.shape)
            view.copy_(t, non_blocking=True)
            out.setdefault(lname, {})[leaf] = view
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def scatter_blocks(self, blocks: Sequence[int], host_tree) -> None:
        """Write a :meth:`gather_blocks` payload (torch tensors or numpy
        arrays), or a list of its block records (``per_block=True``, one a
        block), into ``blocks`` of this pool, in place.  Its leaves and
        shapes must match this cache's geometry — a handoff between
        replicas of different geometry is a deployment error, not a
        cast."""
        if isinstance(host_tree, (list, tuple)):
            self._scatter_records(blocks, host_tree)
            return
        rows = self._block_rows(blocks)
        n = rows.numel()
        for lname, layer in self.cache.items():
            src = host_tree[lname]
            self._check_leaves(src, layer)
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

    # ------------------------------------------------------------------ #
    # Block records: the host tier's unit
    # ------------------------------------------------------------------ #
    # A record holds every leaf's rows of one block, layer by layer, each
    # at a 16-byte aligned offset of one host byte buffer.  A spool packs
    # its blocks' records side by side on the device, copies them to the
    # host in one transfer through a pinned staging buffer that the cache
    # keeps (grown to the largest transfer, so the page-locking cost is
    # paid once, not on every spool), and copies each record out into a
    # buffer of its own; a restore packs the records into the staging
    # buffer and sends them in one transfer the other way.  The records
    # themselves live in pageable memory at their exact size, so the
    # tier's byte budget is the memory it holds.
    def _check_leaves(self, tree, layer) -> None:
        if set(tree) != set(layer):
            raise ValueError(
                f"scatter_blocks: payload leaves {sorted(tree)} do not "
                f"match the cache's {sorted(layer)} (KV dtype differs)")

    def _record_layout(self):
        """``([(dtype, shape, [(layer, leaf), ...], byte offset, bytes a
        leaf)], record bytes)`` of one block record: leaves of one dtype
        and shape lie side by side, so one ``unbind`` views them all."""
        if self._layout is None:
            groups: Dict[Tuple, List[Tuple[str, str]]] = {}
            for lname, layer in self.cache.items():
                for leaf, pool in layer.items():
                    key = (pool.dtype, (self.block_size,)
                           + tuple(pool.shape[1:]))
                    groups.setdefault(key, []).append((lname, leaf))
            layout, off = [], 0
            for (dtype, shape), leaves in groups.items():
                n = int(np.prod(shape)) * torch.empty(
                    (), dtype=dtype).element_size()
                layout.append((dtype, shape, leaves, off, n))
                off += -(-len(leaves) * n // 16) * 16
            self._layout = (layout, off)
        return self._layout

    @staticmethod
    def _group(buf: torch.Tensor, dtype, shape, leaves, off, n):
        """``buf``'s (a record's, or ``[blocks, record]``) bytes of one
        group as ``[..., len(leaves), *shape]``."""
        lead = tuple(buf.shape[:-1])
        return buf[..., off:off + len(leaves) * n].view(dtype).view(
            lead + (len(leaves),) + shape)

    def _staging(self, nbytes: int) -> torch.Tensor:
        """``nbytes`` of the pinned host staging buffer (a GPU pool), once
        the last transfer that read it has finished; a fresh host buffer
        for a pool on the CPU."""
        if self.device.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        stage = self._stage
        if stage is None or stage.numel() < nbytes:
            stage = self._stage = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
            self._stage_read = None
        elif self._stage_read is not None:
            self._stage_read.synchronize()
        return stage[:nbytes]

    def _gather_records(self, blocks: Sequence[int]) -> List[Dict]:
        layout, rec = self._record_layout()
        nb = len(blocks)
        rows = self._block_rows(blocks)
        packed = torch.empty((nb, rec), dtype=torch.uint8, device=self.device)
        for g in layout:
            dst = self._group(packed, *g)
            for j, (lname, leaf) in enumerate(g[2]):
                dst[:, j].copy_(self.cache[lname][leaf].index_select(0, rows)
                                .view((nb,) + g[1]))
        if self.device.type == "cuda":
            host = self._staging(nb * rec).view(nb, rec)
            host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            packed = host
        records = []
        for i in range(nb):
            buf = torch.empty(rec, dtype=torch.uint8)
            buf.copy_(packed[i])
            out: Dict[str, Dict[str, torch.Tensor]] = {
                lname: {} for lname in self.cache}
            for g in layout:
                for (lname, leaf), view in zip(
                        g[2], self._group(buf, *g).unbind(0)):
                    out[lname][leaf] = view
            records.append(out)
        return records

    def _record_bytes(self, record) -> torch.Tensor:
        """The host byte buffer that a block record's leaves view."""
        layout, rec = self._record_layout()
        for lname, layer in self.cache.items():
            self._check_leaves(record[lname], layer)
        (lname, leaf), = layout[0][2][:1]
        buf = torch.empty(0, dtype=torch.uint8).set_(
            record[lname][leaf].untyped_storage())
        for dtype, shape, leaves, off, _ in layout:
            t = record[leaves[0][0]][leaves[0][1]]
            if (buf.numel() != rec or t.dtype != dtype
                    or tuple(t.shape) != shape
                    or t.data_ptr() != buf.data_ptr() + off):
                raise ValueError(
                    "scatter_blocks: not a block record of this cache "
                    "(gather_blocks(..., per_block=True) makes them)")
        return buf

    def _scatter_records(self, blocks: Sequence[int], records) -> None:
        layout, rec = self._record_layout()
        nb = len(blocks)
        if len(records) != nb:
            raise ValueError(f"scatter_blocks: {len(records)} block records "
                             f"for {nb} blocks")
        host = self._staging(nb * rec).view(nb, rec)
        for i, record in enumerate(records):
            host[i].copy_(self._record_bytes(record))
        packed = host.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._stage_read = torch.cuda.Event()
            self._stage_read.record(torch.cuda.current_stream(self.device))
        rows = self._block_rows(blocks)
        for g in layout:
            src = self._group(packed, *g)
            for j, (lname, leaf) in enumerate(g[2]):
                self.cache[lname][leaf].index_copy_(
                    0, rows, src[:, j].reshape((nb * g[1][0],) + g[1][1:]))

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
