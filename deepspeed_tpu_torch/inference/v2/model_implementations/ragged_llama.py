"""Ragged (paged-KV) Llama forward for the FastGen engine (counterpart of
``deepspeed_tpu/inference/v2/model_implementations/ragged_llama.py``;
reference: ``inference/v2/model_implementations/llama_v2``).

One forward consumes the packed token buffer that
:class:`RaggedBatchWrapper.finalize` builds (token budget T, max sequences
S, block-table width B) and the flat paged KV pool of
:class:`BlockedKVCache`:

* token embeddings / projections / MLP run over the flat ``[T, H]`` buffer —
  tokens from different sequences are just rows of the same matmul; every
  int8 projection goes through the int8-weight matmul kernel (``qmm``);
* KV writes are one ``index_copy_`` into the pool, in place (pad lanes write
  to the trash block); an int8 pool quantizes on insert, writing payload and
  scales in the same step;
* attention reads each token's context through its block table.  On CUDA
  tensors a decode batch takes the paged decode kernel, a speculative verify
  batch the paged verify kernel, a tile-aligned prefill over a bf16 pool
  whose model forwards ``prefill_tile`` (Mixtral; Llama does not, as in the
  JAX package) the tiled prefill kernel, and every other batch the generic
  paged attention kernel, each in its bf16 or int8 mode; on the CPU (or with
  ``use_kernels=False``) the plain gather / dense paths below run — the JAX
  package's XLA paths, ported one for one, dequantizing at their read sites.

The param tree is the JAX package's: ``params["model"]["layers_{i}"]...``
with every projection a ``[K, N]`` kernel or an int8 ``{"q", "scale"}``
record.  Tensor parallelism is a later slice of the port.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.kernels import (
    paged_attention, paged_decode_attention, paged_prefill_attention,
    paged_verify_attention)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (dequantize_kv,
                                                              quantize_kv)
from deepspeed_tpu_torch.models.llama import LlamaConfig, apply_rotary
from deepspeed_tpu_torch.ops.quantized_matmul import qmm


def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rotary(positions, head_dim, theta):
    """positions: [T] -> (cos, sin): [T, 1, D/2] fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / head_dim))
    angles = positions[:, None].float() * inv_freq               # [T, D/2]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def _paged_attention(q, k_pool, v_pool, batch, block_size, use_kernel=None,
                     window=None, prefill_tile=None, decode_mode=False,
                     verify_k=None, k_scale=None, v_scale=None):
    """Paged attention over the blocked KV pool.

    q: [T, H, D]; k_pool/v_pool: [num_blocks*bs, Hkv, D].  Returns
    [T, H, D].  ``window`` = Mistral sliding-window width.
    ``k_scale``/``v_scale`` (int8 pools; ``[rows, Hkv]`` fp32) select the
    block-quantized mode.

    ``use_kernel`` (default: whether q lies on a GPU) routes to the CUDA
    kernels: ``verify_k`` batches (K consecutive-position tokens per slot,
    rows slot-major) to :func:`paged_verify_attention`, ``decode_mode``
    batches (T == S with ``token_slot == arange``, set by the engine's
    decode programs) to :func:`paged_decode_attention`, a ``prefill_tile``
    batch over a bf16 pool (packed tile-aligned by the engine, T a multiple
    of the tile) to :func:`paged_prefill_attention`, every other batch to
    :func:`paged_attention` — in int8 mode too, where the JAX package
    takes its XLA gather + dequant path for prefill (its tiled kernel has
    no int8 mode, so int8 prefill keeps the generic kernel here as well).
    The JAX package
    decodes through its masked dense XLA path whenever a bf16 pool holds at
    most 2·S·C rows — always so for the default pool — but that rule was a
    TPU measurement; here the decode kernel is the decode path.  Shapes the
    kernels do not take raise (in the wrappers) rather than fall back.

    ``use_kernel=False`` (and every CPU call) takes the plain paths below:
    the JAX package's gather / dense compositions, one for one, each
    dequantizing an int8 pool at its read site.
    """
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        kw = {"block_size": block_size, "k_scale": k_scale,
              "v_scale": v_scale,
              "window": int(window) if window is not None else None}
        args = (q, k_pool, v_pool, batch["block_tables"],
                batch["token_slot"], batch["token_pos"])
        if verify_k:
            return paged_verify_attention(*args, k_tokens=int(verify_k),
                                          **kw)
        if (not decode_mode and k_scale is None and prefill_tile
                and q.shape[0] % prefill_tile == 0):
            return paged_prefill_attention(
                *args, block_size=block_size, tile_q=int(prefill_tile),
                window=kw["window"])
        fn = paged_decode_attention if decode_mode else paged_attention
        return fn(*args, **kw)
    quantized = k_scale is not None
    block_tables = batch["block_tables"].long()   # [S, B]
    token_slot = batch["token_slot"].long()       # [T]
    token_pos = batch["token_pos"].long()         # [T]
    S, B = block_tables.shape
    C = B * block_size
    T, h, d = q.shape
    hkv = k_pool.shape[1]
    group = h // hkv
    dev = q.device
    inv_sqrt_d = 1.0 / math.sqrt(d)

    if decode_mode and k_pool.shape[0] <= 2 * S * C:
        # Masked DENSE attention over the whole pool (pool ~ live
        # contexts).  Visibility is derived PER TOKEN against that token's
        # own block table — NOT via a row->owner scatter, which breaks
        # under the prefix cache where one warm block legitimately sits in
        # several sequences' tables.
        trash = BlockedAllocator.TRASH_BLOCK
        if quantized:
            # pool-wide dequant matches this branch's pool-wide read (it
            # runs only when rows <= 2*S*C, i.e. pool ~ live)
            k_pool = dequantize_kv(k_pool, k_scale)
            v_pool = dequantize_kv(v_pool, v_scale)
        rows = k_pool.shape[0]
        ar = torch.arange(rows, device=dev)
        rowblk = ar // block_size
        rowoff = ar % block_size
        tbl = block_tables[token_slot]                           # [T, B]
        match = tbl[:, :, None] == rowblk[None, None, :]         # [T, B, rows]
        # absolute position of each visible row in ITS table slot
        j_idx = torch.argmax(match.to(torch.int32), dim=1)       # [T, rows]
        row_pos = j_idx * block_size + rowoff[None, :]
        qg = q.float().reshape(T, hkv, group, d)
        scores = torch.einsum("tkgd,rkd->tkgr", qg,
                              k_pool.float()) * inv_sqrt_d
        keep = (match.any(dim=1)
                & (row_pos <= token_pos[:, None])
                & (rowblk != trash)[None, :])                    # [T, rows]
        if window is not None:
            keep &= row_pos > token_pos[:, None] - window
        # FINITE mask value: a pad slot owns no rows, so -inf would
        # softmax to NaN and poison the residual stream
        scores = torch.where(keep[:, None, None, :], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("tkgr,rkd->tkgd",
                           probs.to(v_pool.dtype).float(), v_pool.float())
        return out.reshape(q.shape).to(q.dtype)

    # Gather each slot's context: [S, C, Hkv, D].  Context index == absolute
    # position because block tables are append-ordered.
    flat_idx = (block_tables[:, :, None] * block_size
                + torch.arange(block_size, device=dev)[None, None, :]
                ).reshape(S, C)
    k_ctx = k_pool[flat_idx]                      # [S, C, Hkv, D]
    v_ctx = v_pool[flat_idx]
    if quantized:
        # dequantize the GATHERED slice — O(S*C), never the whole pool
        k_ctx = dequantize_kv(k_ctx, k_scale[flat_idx])
        v_ctx = dequantize_kv(v_ctx, v_scale[flat_idx])
    key_pos = torch.arange(C, device=dev)[None, :]

    if decode_mode:
        # large-pool decode: T == S with token_slot == arange, so the
        # per-token slot gather is the identity
        qg = q.float().reshape(T, hkv, group, d)
        scores = torch.einsum("tkgd,tckd->tkgc", qg,
                              k_ctx.float()) * inv_sqrt_d
        mask = key_pos <= token_pos[:, None]
        if window is not None:
            mask &= key_pos > token_pos[:, None] - window
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("tkgc,tckd->tkgd",
                           probs.to(v_ctx.dtype).float(), v_ctx.float())
        return out.reshape(q.shape).to(q.dtype)

    # Per-token context via slot gather: [T, C, Hkv, D].
    k_t = k_ctx[token_slot].float()
    v_t = v_ctx[token_slot].float()
    # [T, H, D] x [T, C, Hkv, D] -> [T, H, C] (GQA: head h uses kv head h//g)
    qg = q.float().reshape(T, hkv, group, d)
    scores = torch.einsum("tkgd,tckd->tkgc", qg, k_t) * inv_sqrt_d
    mask = key_pos <= token_pos[:, None]          # [T, C]
    if window is not None:
        mask &= key_pos > token_pos[:, None] - window
    # FINITE mask value: with -inf an all-masked row (tile-aligned pads
    # carry position -1) softmaxes to NaN, the NaN hidden state is written
    # to the trash block, and 0 * NaN poisons REAL rows via the masked
    # context lanes of the next layer's product
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgc,tckd->tkgd", probs, v_t)
    return out.reshape(q.shape).to(q.dtype)


def ragged_attention_block(lp_attn, xa, layer_cache, batch, block_size, cfg,
                           h, hkv, d, cos, sin, kv_dest, prefill_tile=None,
                           decode_mode=False, kernels=True, verify_k=None):
    """Per-layer attention body (RaggedLlama and RaggedMixtral): qkv proj →
    rotary → paged-KV write (in place, rows ``kv_dest``; an int8 pool
    quantizes on insert) → paged attention → o_proj.  ``kernels``: the CUDA
    kernels (on CUDA tensors) or the plain paths.  Returns
    ``attn_out [T, H_model]``."""
    dt = cfg.dtype
    q = qmm(xa, lp_attn["q_proj"]["kernel"], dt, kernels).reshape(-1, h, d)
    k = qmm(xa, lp_attn["k_proj"]["kernel"], dt, kernels).reshape(-1, hkv, d)
    v = qmm(xa, lp_attn["v_proj"]["kernel"], dt, kernels).reshape(-1, hkv, d)
    # apply_rotary broadcasts over [T, H, D] with cos/sin [T, 1, D/2]
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    k_scale = layer_cache.get("k_scale")
    v_scale = layer_cache.get("v_scale")
    if k_scale is not None:
        # payload and scales in the same step: the cache stays
        # self-describing for every reader (kernels, COW copy, handoff)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_pool.index_copy_(0, kv_dest, kq)
        v_pool.index_copy_(0, kv_dest, vq)
        k_scale.index_copy_(0, kv_dest, ks)
        v_scale.index_copy_(0, kv_dest, vs)
    else:
        k_pool.index_copy_(0, kv_dest, k.to(k_pool.dtype))
        v_pool.index_copy_(0, kv_dest, v.to(v_pool.dtype))
    out = _paged_attention(q, k_pool, v_pool, batch, block_size,
                           use_kernel=bool(kernels) and q.is_cuda,
                           window=cfg.sliding_window,
                           prefill_tile=prefill_tile, decode_mode=decode_mode,
                           verify_k=verify_k, k_scale=k_scale,
                           v_scale=v_scale)
    return qmm(out.reshape(-1, h * d), lp_attn["o_proj"]["kernel"], dt,
               kernels)


class RaggedLlama:
    """Callable ragged forward bound to a :class:`LlamaConfig`.

    On CUDA tensors the forward runs the CUDA kernels; ``use_kernels=False``
    runs the plain PyTorch paths on any device (the on-card comparison
    path).  CPU tensors always take the plain paths.
    """

    #: the attention write path quantizes on insert and threads the scales:
    #: int8 KV (``kv_cache.dtype="int8"``) is supported
    supports_quantized_kv = True

    def __init__(self, config: LlamaConfig, block_size: int,
                 use_kernels: bool = True):
        self.config = config
        self.block_size = block_size
        self.use_kernels = use_kernels

    @property
    def num_layers(self):
        return self.config.num_hidden_layers

    @property
    def num_kv_heads(self):
        return self.config.num_key_value_heads

    @property
    def head_dim(self):
        return self.config.head_dim

    @torch.no_grad()
    def __call__(self, params: Dict[str, Any], kv_cache: Dict[str, Any],
                 batch: Dict[str, torch.Tensor], prefill_tile=None,
                 decode: bool = False, verify_k: Optional[int] = None):
        """Run one ragged forward.

        Returns ``(logits [S, vocab], kv_cache)`` where row ``s`` holds the
        logits of slot ``s``'s LAST scheduled token; the pools in
        ``kv_cache`` are updated in place.  ``decode`` marks a
        one-token-per-slot batch with ``token_slot == arange`` (the decode
        attention path); ``verify_k`` a speculative verify batch — K
        consecutive-position tokens per slot, rows slot-major, whose
        ``logits_idx`` selects every row (the verify attention path).
        ``prefill_tile`` is accepted and NOT forwarded to the attention, as
        in the JAX package (``ragged_llama.py:485-488``): Llama's prefill
        keeps the generic kernel.
        """
        cfg = self.config
        m = params["model"]
        dt = cfg.dtype
        kernels = self.use_kernels
        token_ids = batch["token_ids"].long()     # [T]
        token_pos = batch["token_pos"]            # [T]
        kv_dest = batch["kv_dest"].long()         # [T]

        x = m["embed_tokens"]["embedding"].to(dt)[token_ids]     # [T, H]
        h, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        cos, sin = _rotary(token_pos, d, cfg.rope_theta)
        for i in range(cfg.num_hidden_layers):
            lp = m[f"layers_{i}"]
            mlp = lp["mlp"]
            xa = _rms_norm(x, lp["input_layernorm"]["scale"],
                           cfg.rms_norm_eps)
            x = x + ragged_attention_block(
                lp["self_attn"], xa, kv_cache[f"layer_{i}"], batch,
                self.block_size, cfg, h, hkv, d, cos, sin, kv_dest,
                decode_mode=decode, kernels=kernels, verify_k=verify_k)
            xm = _rms_norm(x, lp["post_attention_layernorm"]["scale"],
                           cfg.rms_norm_eps)
            gate = qmm(xm, mlp["gate_proj"]["kernel"], dt, kernels)
            up = qmm(xm, mlp["up_proj"]["kernel"], dt, kernels)
            x = x + qmm(F.silu(gate) * up, mlp["down_proj"]["kernel"], dt,
                        kernels)
        x = _rms_norm(x, m["norm"]["scale"], cfg.rms_norm_eps)
        # ★logits_gather analog: slice each slot's last token BEFORE the
        # unembed matmul — [S, H] @ [H, V] instead of [T, V]
        x = x[batch["logits_idx"].long()]
        if cfg.tie_word_embeddings:
            logits = x @ m["embed_tokens"]["embedding"].to(dt).T
        else:
            logits = qmm(x, params["lm_head"]["kernel"], dt, kernels)
        return logits, kv_cache
