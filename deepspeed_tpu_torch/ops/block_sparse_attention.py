"""Block-sparse attention that skips the layout's empty tiles (counterpart of
``deepspeed_tpu/ops/block_sparse_attention.py``; the splash-attention analog
of the reference's Triton kernels, deepspeed/ops/sparse_attention/trsrc/
matmul.tr sdd/dsd + softmax.tr).

:func:`block_sparse_attention` takes q / k / v ``[B, H, S, D]`` and a
:class:`BlockSparseLayout` (a ``[H, S/block, S/block]`` block layout and
the tables built from it on the host) and returns ``[B, H, S, D]``.  It is
one ``torch.autograd.Function`` mirroring the JAX package's ``custom_vjp``:
the forward pre-scales q once, rounds it to the input type and saves
``(q_scaled, k, v, o, lse)``; the backward runs dQ (which also forms
``delta = rowsum(dO * O)`` in fp32), then dK / dV.

On CUDA tensors the three steps are the hand-written kernels of
``deepspeed_tpu_torch/csrc/block_sparse_attention.cu``: the tensor-core
kernels for bf16 / fp16 with D a multiple of 8 up to 128; for fp32 up to
D = 128 the split-TF32 forward and the general dQ and dK/dV.  The general
kernels walk only the live 64 x 64 tiles of the layout (compacted lists
per head that :class:`BlockSparseLayout` builds and keeps on the device)
and, inside a tile, only its live 16 x 16 sub-blocks.  The bf16 / fp16
kernels (forward, dQ and dK/dV on wgmma fed by TMA) and the fp32 forward
(mma.sync in split TF32) walk 16-row slices instead: a block holds up to
four slices of one side (query slices for the forward and dQ, key slices
for dK/dV) and streams the live slices of the other side, four to a
stage; :func:`bsa_tile_walk` builds those tables (groups, stages, the
split of long lists, the longest-first order), and
:func:`block_sparse_tiled_plain_fwd` (with ``split``, the fp32 forward's
3xTF32 products) and :func:`block_sparse_tiled_plain_bwd` evaluate them in
fp32 on any device.  Other inputs on the card (another type, D > 128, a layout
block that is not a multiple of 16) raise ``NotImplementedError`` naming
ROADMAP C: a CUDA tensor never reaches the plain version.  On CPU tensors
the steps are the plain versions, :func:`block_sparse_plain_fwd`,
:func:`block_sparse_plain_bwd_dq` and :func:`block_sparse_plain_bwd_dkv`:
the same masking, pre-scaling and rounding (P and dS rounded to the input
type before their products) in fp32 math.  An optional key bias ``[B, S]``
(a key-padding mask, -inf where a key is dropped) is added to the scores
by the kernels and the plain versions alike.
:func:`block_sparse_attention_reference` runs the plain versions on any
device (the on-card check's yardstick).  ``LAUNCHES`` counts the kernel
launches.

A row whose layout admits no key (or whose kept keys are all dropped by
the key bias) comes out as zeros (the JAX kernel's
``safe_l`` rule); the dense-masked composition of
:mod:`deepspeed_tpu_torch.ops.sparse_attention` gives the mean of v there,
as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.evoformer_attn import tf32_split

__all__ = ["BlockSparseLayout", "block_sparse_attention",
           "block_sparse_attention_reference", "block_sparse_plain_fwd",
           "block_sparse_plain_bwd_dq", "block_sparse_plain_bwd_dkv",
           "block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
           "block_sparse_attention_bwd_dkv", "bsa_tile_walk",
           "block_sparse_tiled_plain_fwd", "block_sparse_tiled_plain_bwd",
           "launch_info"]

#: kernel launches (plain CPU calls do not count)
LAUNCHES = {"block_sparse_attention_fwd": 0,
            "block_sparse_attention_bwd_dq": 0,
            "block_sparse_attention_bwd_dkv": 0}

NEG_INF = -1e30
#: rows (and keys) of a kernel tile, and the side of the sub-blocks its
#: masks name (csrc/block_sparse_attention.cu)
KERNEL_TILE = 64
SUB_BLOCK = 16
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_MAX_D = 128
#: the bf16 / fp16 kernels' walk (csrc/block_sparse_attention.cu): a
#: block holds SLOTS 16-row slices of one side, a stage SLOTS slices of the
#: other; a block-table row is ITEM_INTS ints, a stage-table row STAGE_INTS
SLOTS = 4
ITEM_INTS = 8 + SLOTS
STAGE_INTS = 8
#: a stationary slice whose streamed set is larger than HEAVY_FACTOR times
#: the median (and than HEAVY_MIN slices) is "heavy" (a global row or
#: column): heavy slices are grouped among themselves, the rest stay in
#: their 64-row tile
HEAVY_FACTOR = 4
HEAVY_MIN = 16
#: the blocks the card runs at once (132 SMs x 2 blocks of the wgmma
#: kernels, forward and backward alike): a list longer than twice the
#: launch's stages over WAVE (and than SPLIT_MIN) is split into parts of at
#: most that many stages
WAVE = 264
SPLIT_MIN = 8
#: the fp32 forward's walk splits lists FP32_SPLIT times finer (its wave is
#: FP32_SPLIT x WAVE): its stages take several times a bf16 stage's time,
#: so a global row's list would otherwise outlast the rest of the launch
FP32_SPLIT = 4


def kernel_tile_masks(layout: np.ndarray, block: int) -> np.ndarray:
    """The kernels' view of a layout: ``[h, n, n]`` int32, n = ceil(S / 64),
    entry (h, i, j) the 16-bit mask of the 64 x 64 tile (query tile i, key
    tile j), bit ``qs * 4 + ks`` set when the layout keeps the tile's 16 x 16
    sub-block (qs, ks).  Sub-blocks past S are 0.  ``block`` must be a
    multiple of 16, so that each sub-block lies in one layout cell."""
    if block % SUB_BLOCK:
        raise NotImplementedError(
            f"block_sparse_attention on the card: the kernels take a layout "
            f"block that is a multiple of {SUB_BLOCK} (got {block}); see "
            f"ROADMAP C, block-sparse attention on the card")
    h, nc, _ = layout.shape
    r = block // SUB_BLOCK
    sub = np.asarray(layout, bool).repeat(r, axis=1).repeat(r, axis=2)
    per = KERNEL_TILE // SUB_BLOCK
    n = -(-sub.shape[1] // per)
    pad = n * per - sub.shape[1]
    sub = np.pad(sub, ((0, 0), (0, pad), (0, pad)))
    sub = sub.reshape(h, n, per, n, per).transpose(0, 1, 3, 2, 4)
    bits = (1 << np.arange(per * per, dtype=np.int64)).reshape(per, per)
    return np.tensordot(sub.astype(np.int64), bits, axes=([3, 4], [0, 1])
                        ).astype(np.int32)


def _csr(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-major compacted lists of the nonzero entries of ``[h, n, n]``:
    ``ptr`` (h * n + 1 offsets), the column of each entry, its mask."""
    h, n, _ = masks.shape
    flat = masks.reshape(h * n, n)
    rows, cols = np.nonzero(flat)
    ptr = np.zeros(h * n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=h * n), out=ptr[1:])
    return ptr.astype(np.int32), cols.astype(np.int32), flat[rows, cols]


def _slice_sets(masks: np.ndarray, n_slices: int, key_major: bool
                ) -> np.ndarray:
    """``[h, n, n]`` tile masks -> ``[h, n_slices, n_slices]`` bool: entry
    (h, a, c) whether stationary slice a keeps streamed slice c (query x
    key for the query-major masks, key x query for the key-major ones,
    whose entry (j, i) holds tile (i, j)'s bits)."""
    h, n, _ = masks.shape
    bits = ((masks[..., None] >> np.arange(16)) & 1).astype(bool)
    bits = bits.reshape(h, n, n, SLOTS, SLOTS)          # [.., qs, ks]
    if key_major:
        bits = bits.swapaxes(-1, -2)
    sub = bits.transpose(0, 1, 3, 2, 4).reshape(h, n * SLOTS, n * SLOTS)
    return sub[:, :n_slices, :n_slices]


def _groups(sets: np.ndarray):
    """The stationary groups of one head, SLOTS slices at most: heavy
    slices (largest first), then every other slice with the rest of its
    64-row tile (empty slices too: their outputs are written as zeros)."""
    ns = sets.shape[0]
    sizes = sets.sum(1)
    heavy = np.zeros(ns, bool)
    live = sizes[sizes > 0]
    if live.size:
        heavy = sizes > max(HEAVY_FACTOR * float(np.median(live)), HEAVY_MIN)
    hv = np.nonzero(heavy)[0]
    hv = hv[np.argsort(-sizes[hv], kind="stable")]
    out = [hv[i:i + SLOTS] for i in range(0, hv.size, SLOTS)]
    for t in range(0, ns, SLOTS):
        rest = [a for a in range(t, min(t + SLOTS, ns)) if not heavy[a]]
        if rest:
            out.append(np.asarray(rest))
    return out


def _stages(sets: np.ndarray, grp: np.ndarray) -> np.ndarray:
    """The stage rows of one group: its live streamed slices in order, four
    to a stage (-1 past the end), with the stage's mask."""
    union = np.nonzero(sets[grp].any(0))[0]
    slots = np.full(-(-union.size // SLOTS) * SLOTS, -1, np.int64)
    slots[:union.size] = union
    slots = slots.reshape(-1, SLOTS)
    rows = np.zeros((slots.shape[0], STAGE_INTS), np.int64)
    rows[:, :SLOTS] = slots
    live = sets[grp][:, np.maximum(slots, 0)] & (slots >= 0)   # [r, n, c]
    bit = (np.arange(grp.size)[:, None] * SLOTS
           + np.arange(SLOTS)[None, :])                         # [r, c]
    rows[:, SLOTS] = (live.transpose(1, 0, 2).astype(np.int64)
                      << bit[None]).sum((1, 2))
    return rows


def bsa_tile_walk(masks: np.ndarray, seq_len: int, key_major: bool,
                  batch: int, wave: Optional[int] = None
                  ) -> Dict[str, object]:
    """The bf16 / fp16 kernels' walk, as they read it.

    ``masks``: the ``[h, n, n]`` 16-bit tile masks, query-major
    (:func:`kernel_tile_masks`; the forward's and dQ's walk, query slices
    stationary) or key-major (their transpose; the dK/dV walk, key slices
    stationary).
    Every stationary 16-row slice lies in exactly one group of at most
    :data:`SLOTS` (:func:`_groups`); a group's list is the union of its
    slices' live streamed slices, packed :data:`SLOTS` to a stage.  A list
    longer than twice the launch's stages over ``wave`` (:data:`WAVE` by
    default; and than :data:`SPLIT_MIN`) is cut into parts of equal
    length, whose fp32 partials the last part to finish merges in part
    order.  Blocks are ordered longest list first.

    Returns ``blocks`` (int32 ``[n, ITEM_INTS]``: head, the group's
    stationary slices (-1: none), stage range [begin, end), part, parts,
    the partials' first slot, split group (-1: not split), 0), ``stages``
    (int32 ``[m, STAGE_INTS]``: four streamed slices (-1: none) and the
    mask, bit ``r * 4 + c`` set when stationary slot r keeps streamed slot
    c), ``groups`` (split groups) and ``parts`` (partial slots a batch
    row)."""
    sub = _slice_sets(masks, seq_len // SUB_BLOCK, key_major)
    items, stages, begin = [], [], 0
    for hh in range(sub.shape[0]):
        for grp in _groups(sub[hh]):
            rows = _stages(sub[hh], grp)
            stages.append(rows)
            items.append((hh, grp, begin, begin + rows.shape[0]))
            begin += rows.shape[0]
    split_stages = max(SPLIT_MIN, -(-2 * begin * batch // (wave or WAVE)))
    blocks, groups, parts_all = [], 0, 0
    for hh, grp, b0, b1 in items:
        n = b1 - b0
        parts = -(-n // split_stages) if n > split_stages else 1
        head = [hh, *grp.tolist(), *[-1] * (SLOTS - grp.size)]
        for p in range(parts):
            blocks.append(head + [b0 + p * n // parts,
                                  b0 + (p + 1) * n // parts, p, parts,
                                  parts_all if parts > 1 else 0,
                                  groups if parts > 1 else -1, 0])
        if parts > 1:
            groups += 1
            parts_all += parts
    blocks = np.asarray(blocks, np.int64).reshape(-1, ITEM_INTS)
    order = np.argsort(-_lens(blocks), kind="stable")
    stages = np.concatenate(stages) if stages else \
        np.zeros((0, STAGE_INTS), np.int64)
    return {"blocks": blocks[order].astype(np.int32),
            "stages": stages.astype(np.int32), "groups": groups,
            "parts": parts_all}


def _lens(blocks: np.ndarray) -> np.ndarray:
    """Stages a block of a block table."""
    return blocks[:, SLOTS + 2] - blocks[:, SLOTS + 1]


def walk_stats(walk: Dict[str, object]) -> Dict[str, float]:
    """A walk's packing and split figures: blocks, stages, the longest and
    mean list a block, split groups and partial slots, and the share of
    the stages' 16 x 16 slot pairs that are live."""
    blocks, stages = walk["blocks"], walk["stages"]
    lens = _lens(blocks)
    pairs = SLOTS * SLOTS * len(stages)
    bits = int(np.unpackbits(stages[:, SLOTS].astype(">u4").view(np.uint8)
                             ).sum()) if len(stages) else 0
    return {"blocks": int(len(blocks)), "stages": int(len(stages)),
            "max_stages": int(lens.max()) if len(lens) else 0,
            "mean_stages": float(lens.mean()) if len(lens) else 0.0,
            "split_groups": int(walk["groups"]),
            "partial_slots": int(walk["parts"]),
            "slot_fill": bits / pairs if pairs else 0.0}


def _on_device(walk: Dict[str, object], dev) -> Dict[str, object]:
    """A walk's tables as device tensors ``blocks`` and ``stages`` (one
    upload) beside ``n_blocks``, ``groups``, ``parts`` and ``stats``
    (:func:`walk_stats`)."""
    nb = walk["blocks"].size
    flat = torch.from_numpy(np.concatenate(
        [walk["blocks"].ravel(), walk["stages"].ravel()])).to(dev)
    return {"blocks": flat[:nb], "stages": flat[nb:],
            "n_blocks": len(walk["blocks"]), "groups": walk["groups"],
            "parts": walk["parts"], "stats": walk_stats(walk)}


class BlockSparseLayout:
    """Host-precomputed kernel inputs for one (layout, seq_len).

    The kernels' tables, at 64 x 64 tiles with 16 x 16 sub-block masks
    (:func:`kernel_tile_masks`), are built here on the host and copied to a
    device once (:meth:`kernel_lists`).  ``tile_q`` / ``tile_k`` (the JAX
    package's TPU tile) are accepted and ignored: the kernels pick their
    own."""

    def __init__(self, layout: np.ndarray, block: int, seq_len: int,
                 tile_q: Optional[int] = None, tile_k: Optional[int] = None):
        del tile_q, tile_k
        h, nc, _ = layout.shape
        if nc * block != seq_len:
            raise ValueError(f"layout {nc}x{block} != seq {seq_len}")
        self.layout = np.asarray(layout).astype(bool)
        self.block = block
        self.seq_len = seq_len
        self.num_heads = h
        self.density = float(self.layout.mean())
        self._masks: Optional[np.ndarray] = None
        #: the key-major view of ``_masks`` (the dK/dV lists' source)
        self._masks_t: Optional[np.ndarray] = None
        self._lists: Dict[torch.device, Dict[str, Tuple]] = {}
        self._elem: Dict[torch.device, torch.Tensor] = {}

    @property
    def kernel_masks(self) -> np.ndarray:
        """:func:`kernel_tile_masks` of this layout (built once)."""
        if self._masks is None:
            self._masks = kernel_tile_masks(self.layout, self.block)
        return self._masks

    def tiles_skipped(self) -> Tuple[int, int]:
        """(dead tiles, all tiles) at the kernels' 64 x 64 tile."""
        m = self.kernel_masks
        return int((m == 0).sum()), int(m.size)

    def kernel_lists(self, device) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """The kernels' compacted lists on ``device``: ``"q"`` (for each
        query tile its live key tiles; the forward and dQ) and ``"k"`` (for
        each key tile its live query tiles; dK/dV), each ``(ptr, idx,
        mask)`` int32, uploaded as one tensor and cached per device."""
        device = torch.device(device)
        got = self._lists.get(device)
        if got is None:
            m = self.kernel_masks
            if self._masks_t is None:
                self._masks_t = np.ascontiguousarray(m.transpose(0, 2, 1))
            parts = [*_csr(m), *_csr(self._masks_t)]
            flat = torch.from_numpy(np.concatenate(parts)).to(device)
            views = torch.split(flat, [p.size for p in parts])
            got = {"q": views[:3], "k": views[3:]}
            self._lists[device] = got
        return got

    def walk_tables(self, device, batch: int) -> Dict[str, Dict]:
        """The bf16 / fp16 kernels' walks on ``device`` for a batch of
        ``batch``: ``"dq"`` from the query-major masks (the forward and dQ
        read it) and ``"dkv"`` from the key-major ones
        (:func:`bsa_tile_walk`), each as device tensors ``blocks`` and
        ``stages`` beside ``n_blocks``, ``groups``, ``parts`` and ``stats``
        (:func:`walk_stats`); kept with :meth:`kernel_lists`' lists, per
        device and batch."""
        lists = self.kernel_lists(device)
        key = ("walk", int(batch))
        got = lists.get(key)
        if got is None:
            dev = lists["q"][0].device
            got = {name: _on_device(bsa_tile_walk(masks, self.seq_len,
                                                  key_major, batch), dev)
                   for name, masks, key_major in (
                       ("dq", self._masks, False),
                       ("dkv", self._masks_t, True))}
            lists[key] = got
        return got

    def fp32_walk(self, device, batch: int) -> Dict[str, object]:
        """The fp32 forward's walk on ``device`` for a batch of ``batch``:
        the query-major walk with lists split by ``FP32_SPLIT x WAVE``, in
        :meth:`walk_tables`' form; kept beside them."""
        lists = self.kernel_lists(device)
        key = ("walk_fp32", int(batch))
        got = lists.get(key)
        if got is None:
            got = _on_device(bsa_tile_walk(self.kernel_masks, self.seq_len,
                                           False, batch, FP32_SPLIT * WAVE),
                             lists["q"][0].device)
            lists[key] = got
        return got

    def element_mask(self, device) -> torch.Tensor:
        """The ``[h, S, S]`` bool element mask on ``device`` (the plain
        versions' input), expanded once per device."""
        device = torch.device(device)
        got = self._elem.get(device)
        if got is None:
            m = torch.from_numpy(self.layout).to(device)
            got = m.repeat_interleave(self.block, 1).repeat_interleave(
                self.block, 2)
            self._elem[device] = got
        return got


# --------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------- #
def _scores(qs, k, bias):
    """fp32 q k^T, plus the key bias ``[B, S]`` on every row when given."""
    s = torch.einsum("bhsd,bhtd->bhst", qs.float(), k.float())
    return s if bias is None else s.add_(bias[:, None, None, :])


def block_sparse_plain_fwd(qs, k, v, keep, bias=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes: ``qs`` pre-scaled q, ``keep`` the
    ``[H, S, S]`` element mask, ``bias`` an optional fp32 ``[B, S]`` added
    to each row's kept scores (-inf drops a key).  Returns ``(o, lse fp32
    [B, H, S])``; a row that keeps no key gives zeros and lse = -1e30."""
    s = _scores(qs, k, bias)
    s.masked_fill_(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min_(NEG_INF)
    s.sub_(m).exp_()                                  # p; masked -> 0
    l = s.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    s.copy_(s.to(v.dtype))                            # P in v's type
    o = torch.einsum("bhst,bhtd->bhsd", s, v.float()) / safe_l
    return o.to(qs.dtype), (m + safe_l.log())[..., 0]


def _plain_probs(qs, k, lse, keep, bias):
    s = _scores(qs, k, bias)
    return torch.where(keep, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=s.device))


def block_sparse_plain_bwd_dq(qs, k, v, o, lse, do, keep, scale: float,
                              bias=None):
    """What the dQ kernel computes: ``(dq, delta fp32 [B, H, S])``."""
    p = _plain_probs(qs, k, lse, keep, bias)
    delta = (do.float() * o.float()).sum(-1)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", do.float(), v.float())
              - delta[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(qs.dtype), delta


def block_sparse_plain_bwd_dkv(qs, k, v, do, lse, delta, keep, bias=None):
    """What the dK/dV kernel computes: ``(dk, dv)``."""
    p = _plain_probs(qs, k, lse, keep, bias)
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(do.dtype).float(), do.float())
    ds = p * (torch.einsum("bhsd,bhtd->bhst", do.float(), v.float())
              - delta[..., None])
    del p
    dk = torch.einsum("bhst,bhsd->bhtd", ds.to(qs.dtype).float(), qs.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _walk_pairs(walk: Dict[str, object], dev):
    """Every (block, stage) pair of a walk, in order: the block's index,
    head and stationary slices, the stage's four streamed slices and its
    mask as a ``[pairs, 64, 64]`` bool (stationary rows x streamed rows)."""
    blocks = torch.as_tensor(np.asarray(walk["blocks"], np.int64), device=dev)
    stages = torch.as_tensor(np.asarray(walk["stages"], np.int64), device=dev)
    lens = blocks[:, SLOTS + 2] - blocks[:, SLOTS + 1]
    blk = torch.repeat_interleave(torch.arange(len(blocks), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    st = blocks[blk, SLOTS + 1] + torch.arange(len(blk), device=dev) \
        - first[blk]
    bits = (stages[st, SLOTS][:, None]
            >> torch.arange(SLOTS * SLOTS, device=dev)) & 1
    m = bits.bool().reshape(-1, SLOTS, SLOTS).repeat_interleave(
        SUB_BLOCK, 1).repeat_interleave(SUB_BLOCK, 2)
    return (blk, blocks[blk, 0], blocks[blk, 1:1 + SLOTS],
            stages[st, :SLOTS], m)


def _gather(x, heads, slices):
    """Rows of ``x`` [B, H, S, ...] for each pair's 16-row slices (slice -1
    reads slice 0: masked, never stored) -> [B, pairs, 16 slices, ...]."""
    rows = (slices.clamp(min=0)[:, :, None] * SUB_BLOCK
            + torch.arange(SUB_BLOCK, device=x.device)).reshape(len(heads), -1)
    return x[:, heads[:, None], rows]


def _scatter(part, walk, blk, n_heads, seq):
    """Sum each pair's ``[B, pairs, 64, D]`` into its block, then each
    block's valid slots into their rows -> [B, H, S, D] fp32."""
    acc = part.new_zeros((part.shape[0], len(walk["blocks"]))
                         + part.shape[2:])
    acc.index_add_(1, blk, part)
    rows, valid = _slot_rows(walk, seq, part.device)
    out = part.new_zeros((part.shape[0], n_heads * seq, part.shape[-1]))
    out.index_add_(1, rows[valid], acc[:, valid])
    return out.reshape(part.shape[0], n_heads, seq, part.shape[-1])


def _key_bias(bias, shape, heads, slices):
    """The key bias [B, S] of each pair's 16-row slices -> [B, pairs, 64]
    (0.0 without a bias)."""
    b, h, s, _ = shape
    return 0.0 if bias is None else _gather(
        bias.float()[:, None, :, None].expand(b, h, s, 1), heads,
        slices)[..., 0]


def _slot_rows(walk, seq, dev):
    """Each block's 64 stationary rows as flat (head, row) indices, and
    which of them are a slice's ([n, 64] each)."""
    blocks = torch.as_tensor(np.asarray(walk["blocks"], np.int64), device=dev)
    slices = blocks[:, 1:1 + SLOTS]
    rows = (blocks[:, :1] * seq + slices.clamp(min=0) * SUB_BLOCK)[..., None] \
        + torch.arange(SUB_BLOCK, device=dev)                # [n, 4, 16]
    valid = (slices >= 0)[..., None].expand_as(rows)
    return rows.reshape(len(blocks), -1), valid.reshape(len(blocks), -1)


def _tf32_parts(x):
    """The fp32 forward kernel's split of x: hi = x rounded to TF32
    (:func:`~deepspeed_tpu_torch.ops.evoformer_attn.tf32_split`'s), lo =
    x - hi as the tensor cores read it (truncated to TF32)."""
    hi = tf32_split(x)[0]
    lo = (x.float() - hi).contiguous().view(torch.int32)
    return hi, (lo & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, cross: bool = True):
    """a @ b as the fp32 forward kernel forms it: hi.hi + hi.lo + lo.hi of
    the TF32 parts (:func:`_tf32_parts`) in fp32, the remainders' product
    dropped; without ``cross``, hi.hi alone (the planted fault that drops
    the split's cross terms)."""
    (ah, al), (bh, bl) = _tf32_parts(a), _tf32_parts(b)
    return ah @ bh + (ah @ bl + al @ bh) if cross else ah @ bh


def block_sparse_tiled_plain_fwd(qs, k, v, walk, bias=None,
                                 split: bool = False, cross: bool = True):
    """The forward kernels' walk evaluated in fp32 on any device: ``walk``
    is :func:`bsa_tile_walk`'s query-major table; each block (a list, or a
    part of a split list) takes its rows' largest kept score m_p, l_p =
    sum exp(s - m_p) and the unnormalised O_p = round(exp(s - m_p)) V over
    its stages' 64 x 64 slot pairs (dead pairs masked, P rounded to the
    input type), and a row's parts merge as the kernel merges them: m* =
    max m_p, O and l summed with weights exp(m_p - m*).  With ``split``
    both products are the fp32 kernel's 3xTF32 (:func:`_split_mm`;
    ``cross=False`` drops its cross terms).  Returns ``(o, lse fp32 [B, H,
    S])``; a row that sees no key gives zeros and lse = -1e30."""
    dt, (b, h, s, d) = qs.dtype, qs.shape
    dev, inf = qs.device, float("inf")
    mm = functools.partial(_split_mm, cross=cross) if split else torch.matmul
    blk, heads, stat, strm, m = _walk_pairs(walk, dev)
    n = len(walk["blocks"])
    sc = mm(_gather(qs.float(), heads, stat), _gather(
        k.float(), heads, strm).transpose(-1, -2))
    if bias is not None:
        sc = sc + _key_bias(bias, qs.shape, heads, strm)[..., None, :]
    sc = sc.masked_fill(~m, -inf)                       # [B, pairs, 64, 64]
    idx = blk[None, :, None].expand(b, -1, KERNEL_TILE)
    m_blk = sc.new_full((b, n, KERNEL_TILE), -inf).scatter_reduce(
        1, idx, sc.amax(-1), "amax")
    base = torch.where(m_blk == -inf, 0.0, m_blk)
    p = torch.exp(sc - base[:, blk, :, None])
    l_blk = sc.new_zeros((b, n, KERNEL_TILE)).index_add_(1, blk, p.sum(-1))
    o_blk = sc.new_zeros((b, n, KERNEL_TILE, d)).index_add_(
        1, blk, mm(p.to(dt).float(), _gather(v.float(), heads, strm)))
    rows, valid = _slot_rows(walk, s, dev)
    at = rows[valid]
    m_row = sc.new_full((b, h * s), -inf).scatter_reduce(
        1, at[None].expand(b, -1), m_blk[:, valid], "amax")
    w = torch.exp(m_blk[:, valid] - torch.where(
        m_row == -inf, 0.0, m_row)[:, at])
    o = sc.new_zeros((b, h * s, d)).index_add_(
        1, at, w[..., None] * o_blk[:, valid])
    l = sc.new_zeros((b, h * s)).index_add_(1, at, w * l_blk[:, valid])
    safe_l = torch.where(l == 0, 1.0, l)
    lse = m_row.clamp_min(NEG_INF) + safe_l.log()
    return ((o / safe_l[..., None]).reshape(b, h, s, d).to(dt),
            lse.reshape(b, h, s))


def block_sparse_tiled_plain_bwd(qs, k, v, o, lse, do, walks, scale: float,
                                 bias=None):
    """The bf16 / fp16 backward kernels' walk evaluated in fp32 on any
    device: ``walks`` holds :func:`bsa_tile_walk`'s ``"dq"`` and ``"dkv"``
    tables; each (block, stage) pair computes what the kernels compute on
    its 64 x 64 slot pairs (dead pairs 0 by the mask, P and dS rounded to
    the input type), and the pairs sum into their blocks' stationary rows,
    split parts included.  Returns ``(dq, dk, dv, delta)``."""
    dt, (b, h, s, d) = qs.dtype, qs.shape
    f = [t.float() for t in (qs, k, v, do)]
    delta = (do.float() * o.float()).sum(-1)

    zero = torch.zeros((), device=qs.device)
    blk, heads, stat, strm, m = _walk_pairs(walks["dq"], qs.device)
    q_t, do_t = _gather(f[0], heads, stat), _gather(f[3], heads, stat)
    k_t, v_t = _gather(f[1], heads, strm), _gather(f[2], heads, strm)
    sc = q_t @ k_t.transpose(-1, -2)
    if bias is not None:
        sc = sc + _key_bias(bias, qs.shape, heads, strm)[..., None, :]
    p = torch.where(m, torch.exp(sc - _gather(lse, heads, stat)[..., None]),
                    zero)
    ds = p * (do_t @ v_t.transpose(-1, -2)
              - _gather(delta, heads, stat)[..., None])
    dq = _scatter(ds.to(dt).float() @ k_t, walks["dq"], blk, h, s) * scale

    blk, heads, stat, strm, m = _walk_pairs(walks["dkv"], qs.device)
    k_t, v_t = _gather(f[1], heads, stat), _gather(f[2], heads, stat)
    q_t, do_t = _gather(f[0], heads, strm), _gather(f[3], heads, strm)
    st = k_t @ q_t.transpose(-1, -2)
    if bias is not None:
        st = st + _key_bias(bias, qs.shape, heads, stat)[..., None]
    p = torch.where(m, torch.exp(st - _gather(lse, heads, strm)[..., None, :]),
                    zero)
    dst = p * (v_t @ do_t.transpose(-1, -2)
               - _gather(delta, heads, strm)[..., None, :])
    dv = _scatter(p.to(dt).float() @ do_t, walks["dkv"], blk, h, s)
    dk = _scatter(dst.to(dt).float() @ q_t, walks["dkv"], blk, h, s)
    return dq.to(dt), dk.to(dt), dv.to(dt), delta


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #
def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and on 16 bytes, as the kernels read it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check(name: str, bs_layout: BlockSparseLayout, bias, *ts) -> None:
    """Every operand a CUDA tensor on one device, q's [B, H, S, D] shape
    and type, with S and H the layout's, the bias (when given) fp32
    ``[B, S]``; raises what the kernels do not take."""
    q = ts[0]
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{name}: q, k, v (and dO) must be CUDA tensors on "
                         f"one device (the plain versions are "
                         f"block_sparse_plain_fwd / _bwd_dq / _bwd_dkv)")
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{name}: q, k, v (and dO) of one shape [B, H, S, "
                         f"D] (got {[tuple(t.shape) for t in ts]})")
    b, h, s, d = q.shape
    if s != bs_layout.seq_len or h != bs_layout.num_heads:
        raise ValueError(f"{name}: [B, H, S, D] = {tuple(q.shape)} against "
                         f"a layout of {bs_layout.num_heads} heads and "
                         f"S = {bs_layout.seq_len}")
    if bias is not None and (bias.device != q.device or bias.dtype !=
                             torch.float32 or tuple(bias.shape) != (b, s)):
        raise ValueError(f"{name}: the key bias is fp32 [B, S] = {(b, s)} on "
                         f"q's device (got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device})")
    why = None
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPE_CODE:
        why = (f"q, k, v of one type, bf16, fp16 or fp32 (got "
               f"{[t.dtype for t in ts]})")
    elif d > _MAX_D or (q.dtype != torch.float32 and d % 8):
        why = (f"D <= {_MAX_D}, a multiple of 8 in bf16 / fp16 (got "
               f"D = {d}, {q.dtype})")
    if why is not None:
        raise NotImplementedError(
            f"{name} on the card: the kernels take {why}; see ROADMAP C, "
            f"block-sparse attention on the card")


def _launch(entry: str, key: str, ref, ints, floats, tensors, bias, lists,
            walk):
    bias = None if bias is None else bias.contiguous()
    with torch.cuda.device(ref.device):
        rc = _kernel(entry)(_DTYPE_CODE[ref.dtype],
                            *(t.data_ptr() for t in tensors),
                            None if bias is None else bias.data_ptr(),
                            *ints, *floats,
                            *(t.data_ptr() for t in lists), *walk,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{key}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[key] += 1


def _padded_d(d: int) -> int:
    """D padded as the slice-walk kernels stage it: 16, 32, 64 or 128."""
    return next(p for p in (16, 32, 64, 128) if d <= p)


#: the last slice-walk launch's kernel ("fwd", "dq" or "dkv") and its
#: walk's :func:`walk_stats`, for :func:`launch_info`
_LAST_WALK: Dict[str, object] = {}
#: a partial slot's fp32 values, by kernel, at padded head dim DP: one
#: [64, DP] tile (dQ), two (dK/dV), one and 128 threads' row maxima and
#: sums, 4 each (the forward)
_SLOT_FLOATS = {"fwd": lambda dp: KERNEL_TILE * dp + 512,
                "dq": lambda dp: KERNEL_TILE * dp,
                "dkv": lambda dp: 2 * KERNEL_TILE * dp}


def _walk_args(bs_layout: BlockSparseLayout, ref: torch.Tensor,
               kernel: str) -> Tuple:
    """The walk arguments of a launch of ``kernel`` ("fwd", "dq" or
    "dkv"): (blocks, stages, n_blocks, partials, counters) for bf16 / fp16
    and the fp32 forward (:meth:`BlockSparseLayout.fp32_walk`), where
    ``partials`` holds the fp32 partials of split lists (a slot a part and
    batch row, ``_SLOT_FLOATS`` long) and ``counters`` one zeroed int a
    (split group, batch row), both None when no list is split; Nones for
    fp32 dQ and dK/dV (the general kernels walk the tile lists)."""
    b, d = ref.shape[0], ref.shape[-1]
    if ref.dtype != torch.float32:
        w = bs_layout.walk_tables(ref.device, b)[
            "dkv" if kernel == "dkv" else "dq"]
    elif kernel == "fwd":
        w = bs_layout.fp32_walk(ref.device, b)
    else:
        return (None, None, 0, None, None), None
    ws = counters = None
    if w["groups"]:
        ws = torch.empty(w["parts"] * b * _SLOT_FLOATS[kernel](_padded_d(d)),
                         dtype=torch.float32, device=ref.device)
        counters = torch.zeros(w["groups"] * b, dtype=torch.int32,
                               device=ref.device)
    _LAST_WALK.clear()
    _LAST_WALK.update(kernel=kernel, **w["stats"])
    return (w["blocks"].data_ptr(), w["stages"].data_ptr(), w["n_blocks"],
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr()), (ws, counters)


def block_sparse_attention_fwd(qs, k, v, bs_layout: BlockSparseLayout,
                               bias=None):
    """Forward kernel: ``qs`` pre-scaled q, k, v ``[B, H, S, D]`` and the
    optional key bias fp32 ``[B, S]`` -> ``(o, lse fp32 [B, H, S])``."""
    _check("block_sparse_attention", bs_layout, bias, qs, k, v)
    qs, k, v = _ready(qs), _ready(k), _ready(v)
    b, h, s, d = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    walk, keep = _walk_args(bs_layout, qs, "fwd")
    _launch("fwd", "block_sparse_attention_fwd", qs, [b, h, s, d], [],
            [qs, k, v, o, lse], bias, bs_layout.kernel_lists(qs.device)["q"],
            walk)
    del keep        # the stream orders the launch before any reuse
    return o, lse


def block_sparse_attention_bwd_dq(qs, k, v, o, lse, do,
                                  bs_layout: BlockSparseLayout, scale: float,
                                  bias=None):
    """dQ kernel: the forward's residuals and dO -> ``(dq, delta fp32
    [B, H, S])``; the kernel forms delta = rowsum(dO * O) for its rows and
    writes it for the dK/dV kernel."""
    _check("block_sparse_attention dQ", bs_layout, bias, qs, k, v, o, do)
    qs, k, v, o, do = (_ready(t) for t in (qs, k, v, o, do))
    b, h, s, d = qs.shape
    dq = torch.empty_like(qs)
    delta = torch.empty_like(lse)
    walk, keep = _walk_args(bs_layout, qs, "dq")
    _launch("bwd_dq", "block_sparse_attention_bwd_dq", qs, [b, h, s, d],
            [scale], [qs, k, v, o, do, lse, delta, dq], bias,
            bs_layout.kernel_lists(qs.device)["q"], walk)
    del keep        # the stream orders the launch before any reuse
    return dq, delta


def block_sparse_attention_bwd_dkv(qs, k, v, do, lse, delta,
                                   bs_layout: BlockSparseLayout, bias=None):
    """dK/dV kernel -> ``(dk, dv)``."""
    _check("block_sparse_attention dK/dV", bs_layout, bias, qs, k, v, do)
    qs, k, v, do = (_ready(t) for t in (qs, k, v, do))
    b, h, s, d = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    walk, keep = _walk_args(bs_layout, qs, "dkv")
    _launch("bwd_dkv", "block_sparse_attention_bwd_dkv", qs, [b, h, s, d],
            [], [qs, k, v, do, lse, delta, dk, dv], bias,
            bs_layout.kernel_lists(qs.device)["k"], walk)
    del keep
    return dk, dv


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    fn = getattr(_build.load("block_sparse_attention"), f"dstt_bsa_{entry}")
    n_ptr = {"fwd": 5, "bwd_dq": 8, "bwd_dkv": 8}[entry]
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (n_ptr + 1)  # + bias
                   + [ctypes.c_int] * 4
                   + ([ctypes.c_float] if entry == "bwd_dq" else [])
                   + [ctypes.c_void_p] * 3        # ptr, idx, mask
                   # blocks, stages, n_blocks, partials, counters
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_void_p])  # stream
    fn.restype = ctypes.c_int
    return fn


#: the keys of :func:`launch_info` that the library reports
LAUNCH_INFO_KEYS = ("grid", "threads", "smem", "stages", "step_rows",
                    "registers", "spill_bytes", "encode_ns")


def launch_info() -> dict:
    """The last slice-walk launch (``dstt_bsa_launch_info``; bf16 / fp16,
    and the fp32 forward): its kernel ("fwd", "dq" or "dkv"), blocks,
    threads and shared bytes a block,
    ring stages, streamed rows a step (64, or 32 for dK/dV at D > 64),
    registers a thread at launch, spill bytes, the host ns spent encoding
    its tensor maps, and its walk's packing and split figures
    (:func:`walk_stats`)."""
    fn = _build.load("block_sparse_attention").dstt_bsa_launch_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(LAUNCH_INFO_KEYS))()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"dstt_bsa_launch_info failed with {rc}")
    return {**dict(zip(LAUNCH_INFO_KEYS, out)), **_LAST_WALK}


# --------------------------------------------------------------------- #
# Public entry
# --------------------------------------------------------------------- #
class _BlockSparseAttention(torch.autograd.Function):
    """Forward and backward by the kernels (CUDA) or the plain versions
    (CPU, or ``plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, bs_layout, scale, plain, bias):
        # scale folded into q INSIDE the Function: the dQ kernel applies
        # the final * scale itself (dK needs none: the residual is the
        # scaled q)
        qs = (q.float() * scale).to(q.dtype)
        if plain:
            o, lse = block_sparse_plain_fwd(
                qs, k, v, bs_layout.element_mask(q.device), bias)
        else:
            o, lse = block_sparse_attention_fwd(qs, k, v, bs_layout, bias)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.bs_layout, ctx.scale, ctx.plain = bs_layout, scale, plain
        ctx.bias = bias
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        bias = ctx.bias
        if ctx.plain:
            keep = ctx.bs_layout.element_mask(qs.device)
            dq, delta = block_sparse_plain_bwd_dq(qs, k, v, o, lse, do, keep,
                                                  ctx.scale, bias)
            dk, dv = block_sparse_plain_bwd_dkv(qs, k, v, do, lse, delta,
                                                keep, bias)
        else:
            dq, delta = block_sparse_attention_bwd_dq(
                qs, k, v, o, lse, do, ctx.bs_layout, ctx.scale, bias)
            dk, dv = block_sparse_attention_bwd_dkv(qs, k, v, do, lse, delta,
                                                    ctx.bs_layout, bias)
        return dq, dk, dv, None, None, None, None


def _scale(q, scale):
    return scale if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))


def _bias(key_bias):
    return None if key_bias is None else key_bias.detach().float().contiguous()


def block_sparse_attention(q, k, v, bs_layout: BlockSparseLayout,
                           scale: Optional[float] = None,
                           interpret: Optional[bool] = None,
                           key_bias: Optional[torch.Tensor] = None):
    """q/k/v: [batch, heads, seq, dim] -> [batch, heads, seq, dim].

    The kernels on CUDA tensors, the plain versions on CPU tensors.  Rows
    whose layout admits no keys return 0 (the dense-masked composition
    returns a uniform average there; real layouts have no empty rows).
    ``key_bias`` (``[batch, seq]``, taken as fp32, no gradient) is added to
    each row's scores, key by key: a key-padding mask as
    :func:`deepspeed_tpu_torch.ops.sparse_attention.key_padding_bias` makes
    it, -inf dropping a key.  ``interpret`` (a JAX-package switch) is
    accepted and ignored.
    """
    del interpret
    return _BlockSparseAttention.apply(q, k, v, bs_layout,
                                       float(_scale(q, scale)),
                                       not q.is_cuda, _bias(key_bias))


def block_sparse_attention_reference(q, k, v, bs_layout: BlockSparseLayout,
                                     scale: Optional[float] = None,
                                     key_bias: Optional[torch.Tensor] = None):
    """The plain versions on any device, forward and backward: what the
    kernels compute, zeros for a row that sees no key included."""
    return _BlockSparseAttention.apply(q, k, v, bs_layout,
                                       float(_scale(q, scale)), True,
                                       _bias(key_bias))
