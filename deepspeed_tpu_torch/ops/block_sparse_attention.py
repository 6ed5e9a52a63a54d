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
kernels for bf16 / fp16 with D a multiple of 8 up to 128, the general
kernels for fp32 up to D = 128, each walking only the live 64 x 64 tiles of
the layout (compacted lists per head that :class:`BlockSparseLayout` builds
and keeps on the device) and, inside a tile, only its live 16 x 16
sub-blocks.  Other inputs on the card (another type, D > 128, a layout
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

__all__ = ["BlockSparseLayout", "block_sparse_attention",
           "block_sparse_attention_reference", "block_sparse_plain_fwd",
           "block_sparse_plain_bwd_dq", "block_sparse_plain_bwd_dkv",
           "block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
           "block_sparse_attention_bwd_dkv"]

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


def _launch(entry: str, key: str, ref, ints, floats, tensors, bias, lists):
    bias = None if bias is None else bias.contiguous()
    with torch.cuda.device(ref.device):
        rc = _kernel(entry)(_DTYPE_CODE[ref.dtype],
                            *(t.data_ptr() for t in tensors),
                            None if bias is None else bias.data_ptr(),
                            *ints, *floats,
                            *(t.data_ptr() for t in lists),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{key}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[key] += 1


def block_sparse_attention_fwd(qs, k, v, bs_layout: BlockSparseLayout,
                               bias=None):
    """Forward kernel: ``qs`` pre-scaled q, k, v ``[B, H, S, D]`` and the
    optional key bias fp32 ``[B, S]`` -> ``(o, lse fp32 [B, H, S])``."""
    _check("block_sparse_attention", bs_layout, bias, qs, k, v)
    qs, k, v = _ready(qs), _ready(k), _ready(v)
    lists = bs_layout.kernel_lists(qs.device)["q"]
    b, h, s, d = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    _launch("fwd", "block_sparse_attention_fwd", qs, [b, h, s, d], [],
            [qs, k, v, o, lse], bias, lists)
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
    _launch("bwd_dq", "block_sparse_attention_bwd_dq", qs, [b, h, s, d],
            [scale], [qs, k, v, o, do, lse, delta, dq], bias,
            bs_layout.kernel_lists(qs.device)["q"])
    return dq, delta


def block_sparse_attention_bwd_dkv(qs, k, v, do, lse, delta,
                                   bs_layout: BlockSparseLayout, bias=None):
    """dK/dV kernel -> ``(dk, dv)``."""
    _check("block_sparse_attention dK/dV", bs_layout, bias, qs, k, v, do)
    qs, k, v, do = (_ready(t) for t in (qs, k, v, do))
    b, h, s, d = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_dkv", "block_sparse_attention_bwd_dkv", qs, [b, h, s, d],
            [], [qs, k, v, do, lse, delta, dk, dv], bias,
            bs_layout.kernel_lists(qs.device)["k"])
    return dk, dv


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    fn = getattr(_build.load("block_sparse_attention"), f"dstt_bsa_{entry}")
    n_ptr = {"fwd": 5, "bwd_dq": 8, "bwd_dkv": 8}[entry]
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (n_ptr + 1)  # + bias
                   + [ctypes.c_int] * 4
                   + ([ctypes.c_float] if entry == "bwd_dq" else [])
                   + [ctypes.c_void_p] * 4)       # ptr, idx, mask, stream
    fn.restype = ctypes.c_int
    return fn


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
