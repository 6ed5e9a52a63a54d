"""Paged attention over the blocked KV pool (counterpart of
``deepspeed_tpu/inference/v2/kernels/blocked_flash.py``; reference:
inference/v2/kernels/ragged_ops/blocked_flash/).

Two wrappers, each over a hand-written CUDA kernel in
``deepspeed_tpu_torch/csrc/blocked_flash.cu``:

* :func:`paged_attention` — every token of a ragged batch attends over its
  sequence's paged context up to its own position (the JAX package's
  generic grid kernel ``_kernel``);
* :func:`paged_decode_attention` — one query per slot walking only that
  slot's live blocks (the JAX package's ``_decode_kernel``, bf16 mode).

Both compute the same function; their plain PyTorch version,
:func:`paged_attention_plain`, sits below.  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import _build

#: kernel launches per wrapper (plain CPU calls do not count)
LAUNCHES = {"paged_attention": 0, "paged_decode_attention": 0}

_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_C_NAMES = {"paged_attention": "dstt_paged_attention_bf16",
            "paged_decode_attention": "dstt_paged_decode_attention_bf16"}


def paged_attention_usable(q, k_pool, block_size: int) -> bool:
    """Whether the wrappers take these shapes: on CUDA, bf16 with a head
    dim of 64 or 128 and at most 8 query heads per KV head; on the CPU
    (the plain version), any whole GQA grouping."""
    h, d = q.shape[1], q.shape[2]
    hkv = k_pool.shape[1]
    if h % hkv or block_size <= 0:
        return False
    if not q.is_cuda:
        return True
    return (d in _HEAD_DIMS and h // hkv <= _MAX_GROUP
            and q.dtype == k_pool.dtype == torch.bfloat16)


def paged_attention_plain(q, k_pool, v_pool, block_tables, token_slot,
                          token_pos, *, block_size: int,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather each token's context
    through its slot's block table, mask by position (and window), softmax
    in fp32.  Rows with no visible key (pads, position -1) are zeros, as in
    the kernels (``l == 0 -> 1``)."""
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
                    *, block_size: int,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [T, H, D]; k/v_pool: [num_blocks*block_size, Hkv, D];
    block_tables: [S, B] int32; token_slot/token_pos: [T] int32.
    Returns [T, H, D]: each token attends over its sequence's paged
    context up to its own position (``window``: the last ``window``
    positions only)."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     token_slot, token_pos,
                                     block_size=block_size, window=window)
    return _launch("paged_attention", q, k_pool, v_pool, block_tables,
                   token_slot, token_pos, block_size, window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, token_slot,
                           token_pos, *, block_size: int,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode-shaped paged attention: q [S, H, D], one token per slot,
    each walking only its slot's live blocks.  Returns [S, H, D]; pad
    slots (pos < 0) give zeros."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     token_slot, token_pos,
                                     block_size=block_size, window=window)
    return _launch("paged_decode_attention", q, k_pool, v_pool,
                   block_tables, token_slot, token_pos, block_size, window)


def _launch(name, q, k_pool, v_pool, block_tables, token_slot, token_pos,
            block_size, window):
    t_count, h, d = q.shape
    hkv = k_pool.shape[1]
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "token_slot": token_slot,
               "token_pos": token_pos}
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key in ("q", "k_pool", "v_pool"):       # read in 16-byte vectors
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if not paged_attention_usable(q, k_pool, block_size) \
            or v_pool.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: the CUDA kernel takes bf16 q/pools, head_dim in "
            f"{_HEAD_DIMS} and at most {_MAX_GROUP} query heads per KV head "
            f"(got {q.dtype} q {tuple(q.shape)}, {k_pool.dtype} pools "
            f"{tuple(k_pool.shape)}); RaggedLlama(use_kernels=False) takes "
            f"the plain path")
    for key in ("block_tables", "token_slot", "token_pos"):
        if tensors[key].dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32")
    if (k_pool.shape != v_pool.shape or k_pool.dim() != 3
            or k_pool.shape[2] != d or k_pool.shape[0] % block_size
            or token_slot.shape != (t_count,)
            or token_pos.shape != (t_count,) or block_tables.dim() != 2):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, tables "
                         f"{tuple(block_tables.shape)} do not fit")
    out = torch.empty_like(q)
    if t_count == 0:
        return out
    with torch.cuda.device(q.device):      # the launch goes to q's GPU
        rc = _kernel(name)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), token_slot.data_ptr(),
            token_pos.data_ptr(), out.data_ptr(), t_count, h, hkv, d,
            block_tables.shape[1], block_size,
            int(window) if window is not None else 0, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[name] += 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("blocked_flash"), _C_NAMES[name])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
