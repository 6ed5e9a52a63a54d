"""Evoformer attention, DS4Science (counterpart of
``deepspeed_tpu/ops/evoformer_attn.py``; reference:
csrc/deepspeed4science/evoformer_attn/, python surface
deepspeed/ops/deepspeed4science/evoformer_attn.py
``DS4Sci_EvoformerAttention``; built by op_builder/evoformer_attn.py).

``DS4Sci_EvoformerAttention(Q, K, V, biases)``: Q/K/V ``[*, S, H, D]`` (K and
V of one shape, with Q's lead dims, heads and D), each bias broadcastable to
``[*, H, Sq, Sk]`` (OpenFold passes ``[mask_bias, pair_bias]``, e.g.
``[B, N, 1, 1, S]`` and ``[B, 1, H, S, S]``).

Every call goes through one autograd Function:

* forward on CUDA tensors: the hand-written kernels of
  ``csrc/evoformer_attn.cu`` (:func:`evoformer_attention_kernel`), routed by
  :func:`kernel_route`: the tensor-core kernel (``LAUNCHES
  ["evoformer_attention"]``, wgmma fed by a TMA ring) for bf16 / fp16
  Q/K/V with D a multiple of 8 up to 128; the general kernel
  (``LAUNCHES["evoformer_attention_simt"]``; mma.sync in TF32, each fp32
  operand split in two TF32 parts, three products a product: 3xTF32) for
  fp32 Q/K/V, D not a multiple of 8 and D from 136 to 256.  Both take up to eight biases, each
  fp32, bf16 or fp16, of any broadcast pattern.  What neither takes raises
  ``NotImplementedError`` naming ROADMAP C: a CUDA tensor never reaches the
  dense version;
* forward on CPU tensors: :func:`evoformer_attention_dense`, the plain
  version;
* backward, on either: the JAX package's ``_bwd_chunked``, the dense
  composition recomputed with autograd over chunks of the flattened lead
  dimension, each bias gradient summed over the lead slices that share it
  (``segment_sum`` there, ``index_add_`` here, in fp32).

A row whose scores are all -inf (an fp16 mask bias of -1e9 is -inf) comes
out of the kernels as zeros, where the dense softmax gives NaN; a finite
mask (-1e9 in fp32 or bf16) gives the dense answer, the mean of v.

The tensor-core kernel stages each bias by what it varies over within one
(lead slice, head) (:func:`bias_plan`): a tile (the pair bias) by TMA when
its rows are 16-byte aligned, else copied by the producer warpgroup's lanes
(4-byte cp.async, or read and summed in fp32); a key row (the mask) summed
by the lanes; a value a row or a scalar read once.  The general kernel
stages them the same way, cp.async taking the TMA tiles too.
:func:`evoformer_attention_tiled_plain` is their walk in plain PyTorch (row
blocks, key steps, exp2 with log2(e), biases added by pattern, the running
max guarded at -inf; with ``split`` the general kernel's 3xTF32 products,
:func:`tf32_split`), tested on the CPU against the JAX kernel.

Deliberate differences from the JAX package: a backward chunk holds as many
lead slices as fit ``BWD_CHUNK_BYTES`` of fp32 score buffers (JAX: one
slice); a bias gradient is summed in fp32 and rounded once to the bias's
type; K and V must have Q's lead dims (the JAX dense path broadcasts them);
``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build

__all__ = ["DS4Sci_EvoformerAttention", "EvoformerAttnBuilder",
           "bias_plan", "evoformer_attention_dense",
           "evoformer_attention_kernel", "evoformer_attention_tiled_plain",
           "general_walk", "kernel_route", "tf32_split"]

#: launches of the tensor-core kernel and of the general kernel
LAUNCHES = {"evoformer_attention": 0, "evoformer_attention_simt": 0}

#: fp32 bytes the backward's dense recompute may hold at once (scores,
#: probabilities and their gradients: ~5 buffers of [H, Sq, Sk] a slice)
BWD_CHUNK_BYTES = 1 << 30
_BWD_BUFFERS = 5

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_MAX_BIASES, _MMA_MAX_D, _SIMT_MAX_D = 8, 128, 256

#: the tensor-core kernel's walk: query rows a block, keys a step
#: (``kRows`` * C and ``kKeys`` in ``csrc/evoformer_attn.cu``)
KERNEL_ROWS, KERNEL_KEYS = 128, 64
#: bias kinds, the codes of ``BiasKind`` in ``csrc/evoformer_attn.cu``
BIAS_KINDS = ("scalar", "row", "key_sum", "tile_tma", "tile_async",
              "tile_sum", "key_async")
_LOG2E = 1.4426950408889634


def evoformer_attention_dense(Q, K, V, biases=None):
    """Dense composition (the plain version, the CPU forward and the parity
    oracle): materializes the score tensor, computes in fp32, returns Q's
    type."""
    d = Q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    q = Q.float().movedim(-2, -3)                    # [..., h, sq, d]
    k = K.float().movedim(-2, -3)
    v = V.float().movedim(-2, -3)
    scores = torch.einsum("...hqd,...hkd->...hqk", q, k) * scale
    for bias in biases or []:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...hqk,...hkd->...hqd", probs, v)
    return out.movedim(-3, -2).to(Q.dtype)


def _canon_bias(b, lead: Tuple[int, ...], h: int, sq: int, sk: int):
    """Left-pad a bias to rank len(lead)+3 (each dim full-size or 1) and
    validate broadcastability (a view, nothing materialized)."""
    want = len(lead) + 3
    if b.dim() > want:
        raise ValueError(f"bias of rank {b.dim()} for {want}-dim scores")
    if b.dim() < want:
        b = b.reshape((1,) * (want - b.dim()) + tuple(b.shape))
    for i, (bd, full) in enumerate(zip(b.shape, tuple(lead) + (h, sq, sk))):
        if bd not in (1, full):
            raise ValueError(
                f"bias dim {i} = {bd} not broadcastable to {full}")
    return b


def _lead_offsets(lead: Tuple[int, ...], sizes: Tuple[int, ...],
                  strides: Tuple[int, ...]) -> np.ndarray:
    """For each flattened lead index l, sum_i coord_i(l) * strides[i] over
    the dims the bias does not broadcast (sizes[i] != 1): with the bias's
    own contiguous lead strides its flattened lead index (JAX's
    ``_bias_lead_index``), with its element strides its offset."""
    n = int(np.prod(lead)) if lead else 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    div = n
    for size, full, stride in zip(sizes, lead, strides):
        div //= full
        if size != 1:
            out += ((idx // div) % full) * stride
    return out


@functools.lru_cache(maxsize=256)
def _lead_table(lead, sizes, strides, device) -> torch.Tensor:
    """:func:`_lead_offsets` as an int64 tensor on ``device``, made once a
    geometry (a bias's lead sizes and strides)."""
    return torch.from_numpy(_lead_offsets(lead, sizes, strides)).to(device)


def _contiguous_strides(sizes: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(sizes):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _check_shapes(Q, K, V, biases: Sequence) -> None:
    """K and V of one shape with Q's lead dims, heads and D; every bias
    broadcastable to the scores (ValueError otherwise)."""
    if Q.dim() < 3 or K.shape != V.shape or K.dim() != Q.dim() \
            or K.shape[:-3] != Q.shape[:-3] or K.shape[-2:] != Q.shape[-2:]:
        raise ValueError(
            f"DS4Sci_EvoformerAttention: Q [*, Sq, H, D] and K, V [*, Sk, H, "
            f"D] of one shape (got Q {tuple(Q.shape)}, K {tuple(K.shape)}, V "
            f"{tuple(V.shape)})")
    *lead, sq, h, _ = Q.shape
    for b in biases:
        _canon_bias(b, tuple(lead), h, sq, K.shape[-3])


def kernel_route(Q, K, V, biases: Sequence = ()) -> str:
    """Which kernel of ``csrc/evoformer_attn.cu`` takes these inputs on the
    card: ``"mma"``, the tensor-core kernel (Q/K/V bf16 or fp16, D a multiple
    of 8 up to 128), or ``"simt"``, the general kernel (Q/K/V fp32, or D not
    a multiple of 8, or D from 136 to 256); either with at most eight
    biases, each fp32, bf16 or fp16.  Raises ``NotImplementedError``
    (ROADMAP C, "Evoformer on the card") for what neither kernel takes."""
    d = Q.shape[-1]
    why = None
    if K.dtype != Q.dtype or V.dtype != Q.dtype:
        why = f"Q, K and V of one type (got {Q.dtype}, {K.dtype}, {V.dtype})"
    elif Q.dtype not in _DTYPE_CODE or any(b.dtype not in _DTYPE_CODE
                                           for b in biases):
        why = "fp32, bf16 or fp16 inputs and biases"
    elif d > _SIMT_MAX_D or len(biases) > _MAX_BIASES:
        why = (f"D <= {_SIMT_MAX_D} and at most {_MAX_BIASES} biases "
               f"(got D = {d}, {len(biases)} biases)")
    if why is not None:
        raise NotImplementedError(
            f"DS4Sci_EvoformerAttention on the card: the kernels take {why}; "
            f"see ROADMAP C, Evoformer on the card")
    if Q.dtype != torch.float32 and d % 8 == 0 and d <= _MMA_MAX_D:
        return "mma"
    return "simt"


def bias_kind(strides: Tuple[int, int, int], sq: int, sk: int) -> str:
    """What a bias varies over within one (lead slice, head), from its (h,
    r, c) strides in the expanded view (0 on a broadcast dimension; a
    dimension of size 1 counts as broadcast): ``"scalar"``, ``"row"`` (a
    value a query row), ``"key"`` (a value a key: the mask) or ``"tile"``
    (both: the pair bias)."""
    _, sr, sc = strides
    rows, keys = sr != 0 and sq > 1, sc != 0 and sk > 1
    return ("tile" if rows and keys else "row" if rows
            else "key" if keys else "scalar")


def bias_plan(biases: Sequence, lead: Tuple[int, ...], h: int, sq: int,
              sk: int) -> List[dict]:
    """How the tensor-core kernel stages each bias: its kind (one of
    :data:`BIAS_KINDS`; a tile is ``"tile_tma"`` when TMA can read its rows
    (last stride 1, base and row pitch 16-byte aligned, every (lead slice,
    head) plane starting on a row), ``"tile_async"`` when the producer's
    lanes can copy it 4 bytes at a time (last stride 1, base, row pitch and
    plane offsets 4-byte aligned) and ``"tile_sum"`` otherwise (the lanes
    read it element by element and sum it in fp32); a key row likewise
    ``"key_async"`` or ``"key_sum"``), its (h, r, c) strides
    with size-1 dimensions set to 0, the largest plane offset
    (``lead_off[l] + h * sh``, elements) and the canonical view."""
    n = len(lead)
    out = []
    for b in biases:
        c = _canon_bias(b, lead, h, sq, sk)
        st = list(c.expand(tuple(lead) + (h, sq, sk)).stride())
        for i, size in enumerate(tuple(lead) + (h, sq, sk)):
            if size == 1:
                st[i] = 0
        sh, sr, sc = st[n:]
        max_plane = sum((size - 1) * s for size, s in
                        zip(tuple(lead) + (h,), st[:n + 1]))
        kind = bias_kind((sh, sr, sc), sq, sk)
        elt, planes = c.element_size(), st[:n + 1]
        four = (sc == 1 and c.data_ptr() % 4 == 0
                and all((s * elt) % 4 == 0 for s in planes + [sr]))
        if kind == "tile":
            tma = (sc == 1 and sr >= sk and (sr * elt) % 16 == 0
                   and c.data_ptr() % 16 == 0
                   and all(s % sr == 0 for s in planes))
            kind = "tile_tma" if tma else "tile_async" if four else "tile_sum"
        elif kind == "key":
            kind = "key_async" if four else "key_sum"
        out.append({"kind": kind, "strides": (sh, sr, sc),
                    "lead_strides": tuple(st[:n]), "max_plane": max_plane,
                    "view": c})
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (TMA reads rows of Q, K and V)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def general_walk(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The general kernel's (query rows a block, keys a step) at head dim
    ``d`` and operand type ``dtype`` (``GenTiles`` in
    ``csrc/evoformer_attn.cu``): 128 rows while D pads to at most 64 (4
    warps of two 16-row tiles), else 64; 32 keys in fp32 and wherever D
    pads past 32, else 64."""
    padded = next(p for p in (16, 32, 64, 128, 256) if d <= p)
    return (128 if padded <= 64 else 64,
            32 if dtype == torch.float32 or padded > 32 else 64)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 explicit
    mantissa bits, to nearest, ties away from zero (the magnitude's bits
    rounded, the sign's kept)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The general kernel's split of an fp32 operand: ``hi`` = x rounded to
    TF32 and ``lo`` = (x - hi) rounded to TF32, ~21 of x's 24 bits
    together.  A bf16 or fp16 value is exact in TF32: its ``lo`` is 0."""
    hi = _tf32(x)
    return hi, _tf32(x.float() - hi)


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the general kernel forms it: hi.hi + hi.lo + lo.hi of the
    TF32 parts, in fp32 (the remainders' product dropped)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def evoformer_attention_tiled_plain(Q, K, V, biases: Sequence = (),
                                    block_rows: int = KERNEL_ROWS,
                                    block_keys: int = KERNEL_KEYS,
                                    split: bool = False) -> torch.Tensor:
    """The kernels' walk in plain PyTorch: blocks of ``block_rows`` query
    rows of one (lead slice, head), steps of ``block_keys`` keys; scores in
    log2 units (the scale times log2(e), the biases by :func:`bias_plan`:
    values a row and scalars summed once, staged tiles and key rows (TMA,
    cp.async) added one by one in their order, the other tiles and key rows
    each summed first); exp2 with the running max guarded at -inf; P
    rounded to the input type before P V; a row whose sum is 0 comes out
    as zeros.  The tensor-core kernel's walk by default; the general
    kernel's with ``split`` (its products 3xTF32, :func:`tf32_split`) and
    :func:`general_walk`'s rows and keys."""
    mm = _split_matmul if split else torch.matmul
    *lead, sq, h, d = Q.shape
    lead = tuple(lead)
    L = int(np.prod(lead)) if lead else 1
    sk = K.shape[-3]
    q, k, v = (t.reshape((L, -1, h, d)).float().transpose(1, 2)
               for t in (Q, K, V))                   # [L, H, S, d]
    full = lead + (h, sq, sk)
    terms = {kind: [] for kind in BIAS_KINDS}
    plans = bias_plan(biases, lead, h, sq, sk)
    views = [p["view"].float().expand(full).reshape(L, h, sq, sk)
             for p in plans]
    for plan, b in zip(plans, views):
        terms[plan["kind"]].append(b)
    zero = Q.new_zeros((L, h, sq, sk), dtype=torch.float32)
    row = sum(terms["scalar"] + terms["row"], zero) * _LOG2E
    summed = sum(terms["tile_sum"], zero) * _LOG2E
    keys = sum(terms["key_sum"], zero) * _LOG2E
    staged = [(kind, b) for plan, b in zip(plans, views)
              if (kind := plan["kind"]) in ("tile_tma", "tile_async",
                                            "key_async")]
    scale = _LOG2E / math.sqrt(d)
    out = torch.zeros_like(q)
    for r0 in range(0, sq, block_rows):
        rs = slice(r0, min(sq, r0 + block_rows))
        m = torch.full_like(q[:, :, rs, :1], -math.inf)
        lsum = torch.zeros_like(m)
        acc = torch.zeros_like(q[:, :, rs])
        for c0 in range(0, sk, block_keys):
            cs = slice(c0, min(sk, c0 + block_keys))
            x = mm(q[:, :, rs], k[:, :, cs].transpose(-1, -2)) * scale \
                + row[:, :, rs, cs]
            for _, b in staged:
                x = x + b[:, :, rs, cs] * _LOG2E
            x = x + summed[:, :, rs, cs] + keys[:, :, rs, cs]
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            base = torch.where(m_new == -math.inf, 0.0, m_new)
            corr = torch.exp2(m - base)
            p = torch.exp2(x - base)
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(p.to(Q.dtype).float(), v[:, :, cs])
            m = m_new
        out[:, :, rs] = acc / torch.where(lsum == 0, 1.0, lsum)
    return out.transpose(1, 2).reshape(Q.shape).to(Q.dtype)


def evoformer_attention_kernel(Q, K, V, biases: Sequence = ()
                               ) -> torch.Tensor:
    """The forward on the card: one launch of the kernel :func:`kernel_route`
    picks.  Q, K and V are made contiguous; the biases are read in place
    through their strides."""
    tensors = (Q, K, V, *biases)
    if not all(t.is_cuda and t.device == Q.device for t in tensors):
        raise ValueError("evoformer_attention_kernel: Q, K, V and the biases "
                         "must be CUDA tensors on one device (the plain "
                         "version is evoformer_attention_dense)")
    _check_shapes(Q, K, V, biases)
    route = kernel_route(Q, K, V, biases)
    *lead, sq, h, d = Q.shape
    lead = tuple(lead)
    sk = K.shape[-3]
    L = int(np.prod(lead)) if lead else 1
    q, k, v = (_aligned(t) for t in (Q, K, V))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out.view(Q.shape)
    if sk == 0:                     # rows that see no key: zeros, no launch
        return out.zero_().view(Q.shape)
    n = len(lead)
    ptrs, tables, info, strides = [], [], [], []
    for plan in bias_plan(biases, lead, h, sq, sk):
        c = plan["view"]
        table = _lead_table(lead, tuple(c.shape[:n]), plan["lead_strides"],
                            q.device)
        ptrs.append(c.data_ptr())
        tables.append(table.data_ptr())
        info += [_DTYPE_CODE[c.dtype], BIAS_KINDS.index(plan["kind"]),
                 int(not any(plan["lead_strides"]))]
        strides += [*plan["strides"], plan["max_plane"]]
    nb = len(biases)
    with torch.cuda.device(q.device):
        rc = _kernel()(_DTYPE_CODE[q.dtype], int(route == "simt"),
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), L, sq, sk, h, d, nb,
                       (ctypes.c_void_p * max(nb, 1))(*ptrs),
                       (ctypes.c_void_p * max(nb, 1))(*tables),
                       (ctypes.c_int * max(3 * nb, 1))(*info),
                       (ctypes.c_longlong * max(4 * nb, 1))(*strides),
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evoformer_attention_kernel: CUDA kernel launch "
                           f"failed with error {rc}")
    LAUNCHES["evoformer_attention" if route == "mma"
             else "evoformer_attention_simt"] += 1
    return out.view(Q.shape)


def _bwd_chunked(Q, K, V, biases, dout, needs):
    """Dense recompute + autograd over chunks of the flattened lead dim
    (JAX ``_bwd_chunked``); the broadcast biases' gradients are summed over
    the lead slices that share a bias slice."""
    *lead, sq, h, d = Q.shape
    lead = tuple(lead)
    L = int(np.prod(lead)) if lead else 1
    sk = K.shape[-3]
    qf, kf, vf, dof = (t.reshape((L,) + tuple(t.shape[len(lead):]))
                       for t in (Q, K, V, dout))
    canon = [_canon_bias(b, lead, h, sq, sk) for b in biases]
    bflat = [c.reshape((-1,) + tuple(c.shape[-3:])) for c in canon]
    maps = [_lead_table(lead, tuple(c.shape[:len(lead)]),
                        _contiguous_strides(c.shape[:len(lead)]), Q.device)
            for c in canon]
    chunk = max(1, BWD_CHUNK_BYTES // max(1, _BWD_BUFFERS * 4 * h * sq * sk))
    grads = [torch.empty_like(t) if need else None
             for t, need in zip((qf, kf, vf), needs[:3])]
    dbias = [torch.zeros(bf.shape, dtype=torch.float32, device=bf.device)
             if need else None for bf, need in zip(bflat, needs[3:])]
    for l0 in range(0, L, chunk):
        sl = slice(l0, min(L, l0 + chunk))
        with torch.enable_grad():
            ins = [t[sl].detach().requires_grad_(need)
                   for t, need in zip((qf, kf, vf), needs[:3])]
            bs = [bf[m[sl]].detach().requires_grad_(need)
                  for bf, m, need in zip(bflat, maps, needs[3:])]
            out = evoformer_attention_dense(*ins, bs)
            wants = [t for t in ins + bs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wants, dof[sl]))
        for i, t in enumerate(ins):
            if t.requires_grad:
                grads[i][sl] = next(got)
        for i, (b, m) in enumerate(zip(bs, maps)):
            if b.requires_grad:
                dbias[i].index_add_(0, m[sl], next(got).float())
    dq, dk, dv = (g.reshape(t.shape) if g is not None else None
                  for g, t in zip(grads, (Q, K, V)))
    dbs = [db.reshape(b.shape).to(b.dtype) if db is not None else None
           for db, b in zip(dbias, biases)]
    return (dq, dk, dv, *dbs)


class _Evoformer(torch.autograd.Function):
    """Forward by the kernels (CUDA) or the plain version (CPU), backward by
    the chunked dense recompute."""

    @staticmethod
    def forward(ctx, Q, K, V, *biases):
        ctx.save_for_backward(Q, K, V, *biases)
        if any(t.is_cuda for t in (Q, K, V, *biases)):
            return evoformer_attention_kernel(Q, K, V, biases)
        return evoformer_attention_dense(Q, K, V, list(biases))

    @staticmethod
    def backward(ctx, dout):
        Q, K, V, *biases = ctx.saved_tensors
        return _bwd_chunked(Q, K, V, biases, dout.contiguous(),
                            ctx.needs_input_grad)


def DS4Sci_EvoformerAttention(Q: torch.Tensor, K: torch.Tensor,
                              V: torch.Tensor,
                              biases: Optional[List[torch.Tensor]] = None,
                              interpret: Optional[bool] = None
                              ) -> torch.Tensor:
    """Fused evoformer MHA (reference evoformer_attn.py API).

    Q/K/V: [..., seq, heads, head_dim]; each bias broadcastable to [...,
    heads, seq_q, seq_k].  Returns the attention output in Q's layout and
    type.  ``interpret`` (a JAX-package test switch) is ignored.
    """
    bs = list(biases or [])
    _check_shapes(Q, K, V, bs)
    return _Evoformer.apply(Q, K, V, *bs)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("evoformer_attn").dstt_evoformer_fwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2   # biases, tables
                   + [ctypes.POINTER(ctypes.c_int),          # types, kinds
                      ctypes.POINTER(ctypes.c_longlong),     # strides, planes
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


LAUNCH_INFO_KEYS = ("grid", "threads", "smem", "block_rows", "stages",
                    "staged_tiles", "summed_tiles", "key_rows", "resident",
                    "per_sm", "registers", "spill_bytes")


def launch_info() -> dict:
    """The last launch's shape, of either kernel
    (``dstt_evoformer_launch_info``): blocks (persistent for the
    tensor-core kernel), threads and shared bytes a block, query rows a
    block, ring stages, bias tiles staged in their own type (TMA or
    cp.async) and summed in fp32, key rows staged, tiles resident for all
    of a block's items, blocks an SM, registers a thread at launch and
    spill bytes."""
    fn = _build.load("evoformer_attn").dstt_evoformer_launch_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(LAUNCH_INFO_KEYS))()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"dstt_evoformer_launch_info failed with {rc}")
    return dict(zip(LAUNCH_INFO_KEYS, out))


class EvoformerAttnBuilder:
    NAME = "evoformer_attn"

    def load(self):
        import deepspeed_tpu_torch.ops.evoformer_attn as m
        return m

    def is_compatible(self) -> bool:
        return True
