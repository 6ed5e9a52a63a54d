"""Paged attention over the blocked KV pool (counterpart of
``deepspeed_tpu/inference/v2/kernels/blocked_flash.py``; reference:
inference/v2/kernels/ragged_ops/blocked_flash/).

Three wrappers, each over hand-written CUDA kernels in
``deepspeed_tpu_torch/csrc/blocked_flash.cu``, in a bf16 mode and an int8
mode (``k_scale`` / ``v_scale`` given: int8 pools with fp32 scales
``[rows, Hkv]``, dequantized on the block walk):

* :func:`paged_attention` — every token of a ragged batch attends over its
  sequence's paged context up to its own position (the JAX package's
  generic grid kernel ``_kernel``; its int8 mode computes the JAX package's
  XLA gather + dequant path, which has no TPU kernel).  On the card a
  tiled tensor-core kernel: 64 query rows of one KV head share each walk
  of the context;
* :func:`paged_decode_attention` — one query per slot walking only that
  slot's live blocks (the JAX package's ``_decode_kernel``);
* :func:`paged_verify_attention` — K query rows per slot (speculative
  verify) sharing one walk of the slot's blocks (``_verify_kernel``).

Decode and verify share one tensor-core kernel.  A unit (a decode token,
or a verify slot's K rows) holds K x G <= 16 query rows per KV head, and
one block takes one (unit, KV head): it finds the unit's live 64-key tiles
on the device from ``token_pos`` (so the wrapper never syncs), reads each
tile's K and V asynchronously in a ring of stages and runs both products
on ``mma.sync``; its warps' softmax states merge in a fixed order.

All three compute the same function; their one plain PyTorch version,
:func:`paged_attention_plain`, sits below.

:func:`paged_prefill_attention` — the tiled prefill over a tile-aligned
token buffer, bf16 only (the JAX package's ``_prefill_kernel``): on the
card a route of :func:`paged_attention`'s tiled kernel, which reads each
row's slot at its stripe's first row, counted under its own name; its
plain version is
:func:`paged_prefill_attention_plain`.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches per kernel and mode.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import _build

_KERNELS = ("paged_attention", "paged_decode_attention",
            "paged_verify_attention")
#: kernel launches per kernel and mode (plain CPU calls do not count)
LAUNCHES = {f"{name}{mode}": 0 for name in _KERNELS
            for mode in ("", "_int8")}
LAUNCHES["paged_prefill_attention"] = 0

_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
#: query rows (k_tokens x query heads per KV head) of a decode or verify
#: unit: the kernel pads them to one 16-row mma tile
MAX_VERIFY_ROWS = 16
#: rows of the tiled kernel's q tile: the prefill stripes (tile_q) it
#: takes are a multiple of it
_PREFILL_ROWS = 64


def paged_attention_usable(q, k_pool, block_size: int) -> bool:
    """Whether the wrappers take these shapes: on CUDA, bf16 queries over
    bf16 or int8 pools with a head dim of 64 or 128 and at most 8 query
    heads per KV head; on the CPU (the plain version), any whole GQA
    grouping."""
    h, d = q.shape[1], q.shape[2]
    hkv = k_pool.shape[1]
    if h % hkv or block_size <= 0:
        return False
    if not q.is_cuda:
        return True
    return (d in _HEAD_DIMS and h // hkv <= _MAX_GROUP
            and q.dtype == torch.bfloat16
            and k_pool.dtype in (torch.bfloat16, torch.int8))


def paged_attention_plain(q, k_pool, v_pool, block_tables, token_slot,
                          token_pos, *, block_size: int,
                          window: Optional[int] = None,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each token's context
    through its slot's block table (dequantizing the gathered rows of an
    int8 pool), mask by position (and window), softmax in fp32.  Rows with
    no visible key (pads, position -1) are zeros, as in the kernels
    (``l == 0 -> 1``)."""
    t_count, h, d = q.shape
    hkv = k_pool.shape[1]
    s_count, b_per_seq = block_tables.shape
    c_len = b_per_seq * block_size
    dev = q.device
    rows = (block_tables.long()[:, :, None] * block_size
            + torch.arange(block_size, device=dev)[None, None, :]
            ).reshape(s_count, c_len)
    idx = rows[token_slot.long()]                              # [T, C]
    k = k_pool[idx].float()                                    # [T, C, Hkv, D]
    v = v_pool[idx].float()
    if k_scale is not None:
        k = k * k_scale[idx].float()[..., None]
        v = v * v_scale[idx].float()[..., None]
    qg = q.float().reshape(t_count, hkv, h // hkv, d)
    s = torch.einsum("tkgd,tckd->tkgc", qg, k) * (1.0 / math.sqrt(d))
    key_pos = torch.arange(c_len, device=dev)[None, :]
    pos = token_pos.long()[:, None]
    keep = key_pos <= pos
    if window is not None:
        keep &= key_pos > pos - window
    keep = keep[:, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * keep
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("tkgc,tckd->tkgd", p, v)
    out = out / torch.where(denom == 0, torch.ones_like(denom), denom)
    return out.reshape(q.shape).to(q.dtype)


def paged_attention(q, k_pool, v_pool, block_tables, token_slot, token_pos,
                    *, block_size: int, window: Optional[int] = None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """q: [T, H, D]; k/v_pool: [num_blocks*block_size, Hkv, D];
    block_tables: [S, B] int32; token_slot/token_pos: [T] int32;
    ``k_scale``/``v_scale``: [num_blocks*block_size, Hkv] fp32 for int8
    pools.  Returns [T, H, D]: each token attends over its sequence's paged
    context up to its own position (``window``: the last ``window``
    positions only)."""
    return _route("paged_attention", 1, q, k_pool, v_pool, block_tables,
                  token_slot, token_pos, block_size, window, k_scale,
                  v_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, token_slot,
                           token_pos, *, block_size: int,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Decode-shaped paged attention: q [S, H, D], one token per slot,
    each walking only its slot's live blocks.  Returns [S, H, D]; pad
    slots (pos < 0) give zeros."""
    return _route("paged_decode_attention", 1, q, k_pool, v_pool,
                  block_tables, token_slot, token_pos, block_size, window,
                  k_scale, v_scale)


def paged_verify_attention(q, k_pool, v_pool, block_tables, token_slot,
                           token_pos, *, block_size: int, k_tokens: int,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Multi-query paged attention for speculative verify batches.

    q: [T, H, D] with ``T = S * k_tokens``, rows slot-major — row
    ``s * k_tokens + k`` is slot ``s``'s k-th fed token, at position
    ``token_pos[s * k_tokens] + k``; token_slot/token_pos are the row-level
    [T] arrays the other wrappers take.  The kernel reads each slot's
    context once for all its rows (``k_tokens * H / Hkv`` of them per KV
    head, at most :data:`MAX_VERIFY_ROWS`).  Returns [T, H, D]."""
    if k_tokens < 1 or q.shape[0] % k_tokens:
        raise ValueError(f"paged_verify_attention: {q.shape[0]} rows are "
                         f"not a whole number of {k_tokens}-token slots")
    rows = k_tokens * (q.shape[1] // k_pool.shape[1])
    if q.is_cuda and rows > MAX_VERIFY_ROWS:
        raise ValueError(
            f"paged_verify_attention: k_tokens {k_tokens} x {q.shape[1]} "
            f"query heads / {k_pool.shape[1]} KV heads = {rows} query rows "
            f"per KV head; the CUDA kernel holds at most MAX_VERIFY_ROWS = "
            f"{MAX_VERIFY_ROWS} (their accumulators live in registers)")
    return _route("paged_verify_attention", k_tokens, q, k_pool, v_pool,
                  block_tables, token_slot, token_pos, block_size, window,
                  k_scale, v_scale)


def _stripe_slots(token_slot, tile_q: int):
    """Every row's slot as the tiled kernel reads it: its stripe's first
    row's (pad rows may carry another)."""
    t_count = token_slot.shape[0]
    if tile_q < 1 or t_count % tile_q:
        raise ValueError(f"paged_prefill_attention: {t_count} rows are not "
                         f"a whole number of {tile_q}-row stripes")
    return token_slot.reshape(-1, tile_q)[:, :1].expand(
        -1, tile_q).reshape(-1)


def paged_prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                  token_slot, token_pos, *, block_size: int,
                                  tile_q: int,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """The tiled prefill kernel's function in plain PyTorch: each
    ``tile_q``-row stripe attends through its first row's slot; pad rows
    (position -1) are exact zeros, as in the kernel (the model's gather
    path gives them the mean of V instead)."""
    return paged_attention_plain(
        q, k_pool, v_pool, block_tables, _stripe_slots(token_slot, tile_q),
        token_pos, block_size=block_size, window=window)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, token_slot,
                            token_pos, *, block_size: int, tile_q: int,
                            window: Optional[int] = None) -> torch.Tensor:
    """Tiled paged attention for TILE-ALIGNED token buffers over a bf16
    pool: q [T, H, D] with every ``tile_q``-row stripe single-slot (the
    slot of its first row), token_pos [T] int32 with -1 on pad rows.
    Returns [T, H, D], pad rows exact zeros.  On the card it launches
    :func:`paged_attention`'s tiled kernel told the stripe (it reads a
    row's slot at ``token_slot[row - row % tile_q]``, and no slot of a pad
    row, whose output it writes as zeros).  It takes ``tile_q`` a multiple
    of 64."""
    if not q.is_cuda:
        return paged_prefill_attention_plain(
            q, k_pool, v_pool, block_tables, token_slot, token_pos,
            block_size=block_size, tile_q=tile_q, window=window)
    name = "paged_prefill_attention"
    t_count, h, d = q.shape
    _stripe_slots(token_slot, tile_q)               # the shape check
    _check_layout(name, {"q": q, "k_pool": k_pool, "v_pool": v_pool,
                         "block_tables": block_tables,
                         "token_slot": token_slot, "token_pos": token_pos},
                  block_size)
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16
            and d in _HEAD_DIMS and h % k_pool.shape[1] == 0
            and tile_q % _PREFILL_ROWS == 0):
        raise ValueError(
            f"{name}: the CUDA kernel takes bf16 q and pools, head_dim in "
            f"{_HEAD_DIMS}, whole GQA groups and tile_q a multiple of "
            f"{_PREFILL_ROWS} (got {q.dtype} q {tuple(q.shape)}, "
            f"{k_pool.dtype} pools {tuple(k_pool.shape)}, tile_q {tile_q}); "
            f"int8 pools take paged_attention")
    return _launch("paged_attention", 1, q, k_pool, v_pool, block_tables,
                   token_slot, token_pos, block_size, window, None, None,
                   stripe=tile_q, count=name)


def _route(name, k_tokens, q, k_pool, v_pool, block_tables, token_slot,
           token_pos, block_size, window, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale, or "
                         f"neither")
    if not q.is_cuda:
        return paged_attention_plain(
            q, k_pool, v_pool, block_tables, token_slot, token_pos,
            block_size=block_size, window=window, k_scale=k_scale,
            v_scale=v_scale)
    return _launch(name, k_tokens, q, k_pool, v_pool, block_tables,
                   token_slot, token_pos, block_size, window, k_scale,
                   v_scale)


def _launch(name, k_tokens, q, k_pool, v_pool, block_tables, token_slot,
            token_pos, block_size, window, k_scale, v_scale, stripe=1,
            count=None):
    """Launch kernel ``name``, counted under ``count`` (by default its own
    name and mode); ``stripe``: the generic kernel's rows a slot is read
    for (the first of each stripe)."""
    t_count, h, d = q.shape
    hkv = k_pool.shape[1]
    quantized = k_scale is not None
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "token_slot": token_slot,
               "token_pos": token_pos}
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    _check_layout(name, tensors, block_size)
    if not paged_attention_usable(q, k_pool, block_size) \
            or k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise ValueError(
            f"{name}: the CUDA kernel takes bf16 q over bf16 pools, or over "
            f"int8 pools with k_scale/v_scale, head_dim in {_HEAD_DIMS} and "
            f"at most {_MAX_GROUP} query heads per KV head (got {q.dtype} q "
            f"{tuple(q.shape)}, {k_pool.dtype} pools {tuple(k_pool.shape)}, "
            f"scales {'given' if quantized else 'absent'}); "
            f"RaggedLlama(use_kernels=False) takes the plain path")
    if quantized and (
            k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
            or k_scale.shape != k_pool.shape[:2]
            or v_scale.shape != k_pool.shape[:2]):
        raise ValueError(f"{name}: k_scale/v_scale must be fp32 "
                         f"{tuple(k_pool.shape[:2])}")
    out = torch.empty_like(q)
    if t_count == 0:
        return out
    mode = "int8" if quantized else "bf16"
    # the decode and verify kernel takes k_tokens, the generic one the
    # stripe; every kernel takes the pools' row count (its TMA tensor maps)
    k_arg = stripe if name == "paged_attention" else k_tokens
    with torch.cuda.device(q.device):      # the launch goes to q's GPU
        rc = _kernel(name, mode)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), token_slot.data_ptr(),
            token_pos.data_ptr(), out.data_ptr(), t_count // k_tokens, h,
            hkv, d, block_tables.shape[1], block_size,
            int(window) if window is not None else 0, k_arg,
            k_pool.shape[0], 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} ({mode}): CUDA kernel launch failed "
                           f"with error {rc}")
    LAUNCHES[count or name + ("_int8" if quantized else "")] += 1
    return out


def _check_layout(name, tensors, block_size):
    """What every paged kernel reads: one device, contiguous, q and pools
    16-byte aligned, int32 metadata, [rows, Hkv, D] pools of whole blocks
    and one slot and position a row of q."""
    q, k_pool, v_pool = tensors["q"], tensors["k_pool"], tensors["v_pool"]
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key in ("q", "k_pool", "v_pool"):       # read in 16-byte vectors
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    for key in ("block_tables", "token_slot", "token_pos"):
        if tensors[key].dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32")
    rows = (q.shape[0],)
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 3 or q.dim() != 3
            or k_pool.shape[2] != q.shape[2] or block_size <= 0
            or k_pool.shape[0] % block_size
            or tensors["token_slot"].shape != rows
            or tensors["token_pos"].shape != rows
            or tensors["block_tables"].dim() != 2):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, tables "
                         f"{tuple(tensors['block_tables'].shape)} do not "
                         f"fit")


@functools.lru_cache(maxsize=None)
def _kernel(name: str, mode: str):
    fn = getattr(_build.load("blocked_flash"), f"dstt_{name}_{mode}")
    # 9 pointers and 9 ints (the generic kernel's stripe, or decode /
    # verify's k_tokens)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
