"""Ragged (paged-KV) Mixtral forward for the FastGen engine (counterpart of
``deepspeed_tpu/inference/v2/model_implementations/ragged_mixtral.py``;
reference: ``inference/v2/model_implementations/mixtral/``).

The attention and paged-KV machinery is :class:`RaggedLlama`'s
(``ragged_attention_block``: the same flat token buffer, the same paged
kernels); unlike Llama, Mixtral forwards the engine's ``prefill_tile``, so a
tile-aligned prefill over a bf16 pool takes the tiled prefill kernel.  The
FFN is a dropless top-k routed MoE over the flat ``[T, H]`` buffer:

* router logits in fp32 + top-k + renormalised weights per token (HF
  Mixtral semantics);
* the grouped expert GEMM (``ops/grouped_gemm.py``): tokens sorted by
  expert, each expert multiplying only its own rows (``grouped=False``
  takes the dense all-experts composition, the parity oracle).

Dropless gating has no capacity buckets, so the pad rows of the token
budget never perturb real tokens' routing.

The param tree is the JAX package's ``MixtralForCausalLM`` tree, FLAT:
``params["embed_tokens"]``, ``params["layers_{i}"]`` (``self_attn``,
``block_sparse_moe/deepspeed_moe/{gate/wg/kernel [H, E], experts/w_gate
[E, H, F], w_up [E, H, F], w_down [E, F, H]}``, the two norms),
``params["norm"]``, ``params["lm_head"]`` — not under ``"model"`` as in
:class:`RaggedLlama`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_llama import (
    _rms_norm, _rotary, ragged_attention_block)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig
from deepspeed_tpu_torch.ops.grouped_gemm import (exact_topk_routing,
                                                  grouped_moe_ffn)


def dropless_moe(x, moe_params, k: int, dtype, grouped: bool = True,
                 kernels: bool = True):
    """Dropless top-k MoE over a flat token buffer: x [T, H] -> [T, H].

    Router math in fp32; expert compute in ``dtype``.  The expert FFN runs
    through the grouped GEMM (``kernels``: its CUDA kernel on CUDA tensors,
    else the plain version); ``grouped=False`` forces the dense
    all-experts composition (the parity oracle)."""
    wg = moe_params["gate"]["wg"]["kernel"]            # [H, E]
    experts = moe_params["experts"]
    logits = x.float() @ wg.float()                    # [T, E]
    topi, w = exact_topk_routing(logits, k)            # [T, k]
    w_gate = experts["w_gate"].to(dtype)               # [E, H, F]
    w_up = experts["w_up"].to(dtype)
    w_down = experts["w_down"].to(dtype)
    if grouped:
        return grouped_moe_ffn(x.to(dtype), topi, w.to(dtype), w_gate, w_up,
                               w_down, use_kernel=kernels)
    # dense all-experts composition (reference/oracle path)
    comb = (F.one_hot(topi.long(), wg.shape[1]).float()
            * w[..., None]).sum(dim=1)                 # [T, E]
    xe = x.to(dtype)
    h = F.silu(torch.einsum("tm,emf->etf", xe, w_gate)) * \
        torch.einsum("tm,emf->etf", xe, w_up)          # [E, T, F]
    out = torch.einsum("etf,efm->etm", h, w_down)      # [E, T, H]
    return torch.einsum("te,etm->tm", comb.to(dtype), out)


class RaggedMixtral:
    """Callable ragged MoE forward bound to a :class:`MixtralConfig`.

    On CUDA tensors the forward runs the CUDA kernels; ``use_kernels=False``
    runs the plain PyTorch paths on any device (the on-card comparison
    path).  CPU tensors always take the plain paths.  A speculative verify
    batch (``verify_step``) is scored as ragged rows over the paged KV by
    the generic paged-attention path, as the JAX engine scores it for a
    model without a verify route (``engine_v2.py:654-664``)."""

    #: attention goes through the shared ragged_attention_block, whose
    #: write path quantizes on insert — int8 KV works here too
    supports_quantized_kv = True

    def __init__(self, config: MixtralConfig, block_size: int,
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
        """Returns ``(logits [S, vocab], kv_cache)``, the pools updated in
        place (see :meth:`RaggedLlama.__call__`).  ``verify_k`` is accepted
        and not forwarded: the JAX package has no Mixtral verify route, so
        a verify batch takes the generic paged path."""
        del verify_k
        cfg = self.config
        dt = cfg.dtype
        kernels = self.use_kernels
        token_ids = batch["token_ids"].long()
        token_pos = batch["token_pos"]
        kv_dest = batch["kv_dest"].long()

        x = params["embed_tokens"]["embedding"].to(dt)[token_ids]
        h, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        cos, sin = _rotary(token_pos, d, cfg.rope_theta)
        for i in range(cfg.num_hidden_layers):
            lp = params[f"layers_{i}"]
            xa = _rms_norm(x, lp["input_layernorm"]["scale"],
                           cfg.rms_norm_eps)
            x = x + ragged_attention_block(
                lp["self_attn"], xa, kv_cache[f"layer_{i}"], batch,
                self.block_size, cfg, h, hkv, d, cos, sin, kv_dest,
                prefill_tile=prefill_tile, decode_mode=decode,
                kernels=kernels)
            xm = _rms_norm(x, lp["post_attention_layernorm"]["scale"],
                           cfg.rms_norm_eps)
            x = x + dropless_moe(
                xm, lp["block_sparse_moe"]["deepspeed_moe"],
                cfg.num_experts_per_tok, dt, kernels=kernels)
        x = _rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
        # slot rows gathered BEFORE the vocab matmul
        x = x[batch["logits_idx"].long()]
        return x @ params["lm_head"]["kernel"].to(dt), kv_cache
