"""Llama-family causal LM (counterpart of ``deepspeed_tpu/models/llama.py``).

``LlamaConfig`` and ``apply_rotary`` serve the ragged serving path too; the
training model is ``nn.Module``s with the Flax model's structure and names:
``model.embed_tokens`` (``nn.Embedding``), ``model.layers[i]`` with
``input_layernorm`` / ``self_attn`` / ``post_attention_layernorm`` /
``mlp``, ``model.norm``, ``lm_head`` (``nn.Linear(bias=False)``).  RMSNorm
weights are named ``scale`` as in Flax.  Parameters may be held in any
floating type: each projection casts its weight to the compute type
``config.dtype``, as Flax's ``Dense(dtype=..., param_dtype=float32)`` does;
the training engine holds them in the compute type itself.

``LlamaForCausalLM(input_ids, labels)`` returns the next-token cross
entropy (fp32 log-sum-exp, shift by one, ``ignore_index=-100``); without
labels it returns the logits.  The KV-cache branch of the Flax attention
(incremental decoding for the v1 inference engine, ROADMAP A9) raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.ops.attention import (dot_product_attention,
                                               folded_attention,
                                               paired_attention,
                                               resolve_attention_layout)
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing)


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = False  # activation checkpointing per layer
    # one wide projection then a split (the JAX package's fused_qkv /
    # fused_gate_up options; the weights are named qkv_proj / gate_up_proj)
    fused_qkv: bool = False
    fused_gate_up: bool = False
    # Mistral-style sliding-window attention: each token attends to at
    # most the previous `sliding_window` positions (None = full causal).
    sliding_window: Any = None
    # "bshd" | "folded" | "paired" | None (None -> the process default set
    # from the DeepSpeed config's `attention_layout`); "folded" and
    # "paired" hand attention the projections' [B,S,H*D] output (with
    # fused_qkv, v in place in the qkv_proj output)
    attention_layout: Any = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_70b(**kw) -> "LlamaConfig":
        base = dict(hidden_size=8192, intermediate_size=28672,
                    num_hidden_layers=80, num_attention_heads=64,
                    num_key_value_heads=8)
        base.update(kw)
        return LlamaConfig(**base)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: [B,S] int -> (cos, sin): [B,S,1,D/2] fp32."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding in fp32, cast back to ``x.dtype``;
    ``cos``/``sin`` broadcast over ``x`` ([..., D/2] against [..., D])."""
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` (no bias unless asked for) computing in ``dtype``
    whatever type its weight is held in, as Flax's ``Dense(dtype=...)``
    casts input, kernel and bias."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 bias: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.implementation = "auto" if use_kernels else "plain"
        h, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        hid = cfg.hidden_size
        if cfg.fused_qkv:
            self.qkv_proj = Dense(hid, (h + 2 * hkv) * d, cfg.dtype)
        else:
            self.q_proj = Dense(hid, h * d, cfg.dtype)
            self.k_proj = Dense(hid, hkv * d, cfg.dtype)
            self.v_proj = Dense(hid, hkv * d, cfg.dtype)
        self.o_proj = Dense(h * d, hid, cfg.dtype)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        if cfg.fused_qkv:
            q, k, v = self.qkv_proj(x).split([h * d, hkv * d, hkv * d],
                                             dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (q.reshape(b, s, h, d), k.reshape(b, s, hkv, d),
                   v.reshape(b, s, hkv, d))
        cos, sin = rotary_embedding(positions, d, cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        # the sliding window only bites once the query range exceeds it
        window = (cfg.sliding_window
                  if cfg.sliding_window is not None
                  and s > cfg.sliding_window else None)
        layout = resolve_attention_layout(cfg.attention_layout)
        if layout != "bshd":
            fn = paired_attention if layout == "paired" else folded_attention
            return self.o_proj(fn(
                q.reshape(b, s, h * d), k.reshape(b, s, hkv * d),
                v.reshape(b, s, hkv * d), num_heads=h, num_kv_heads=hkv,
                causal=True, window=window,
                implementation=self.implementation))
        out = dot_product_attention(q, k, v, causal=True, window=window,
                                    implementation=self.implementation)
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        hid, inter = cfg.hidden_size, cfg.intermediate_size
        self.fused = cfg.fused_gate_up
        if self.fused:
            self.gate_up_proj = Dense(hid, 2 * inter, cfg.dtype)
        else:
            self.gate_proj = Dense(hid, inter, cfg.dtype)
            self.up_proj = Dense(hid, inter, cfg.dtype)
        self.down_proj = Dense(inter, hid, cfg.dtype)

    def forward(self, x):
        if self.fused:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, use_kernels)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions):
        x = x + self.self_attn(self.input_layernorm(x), positions)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg, use_kernels)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids, positions=None):
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None] \
                .expand(b, s)
        x = self.embed_tokens(input_ids).to(self.cfg.dtype)
        for block in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpointing.checkpoint(block, x, positions)
            else:
                x = block(x, positions)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Returns the loss when ``labels`` are given (the training contract),
    else the logits [B, S, V] in ``config.dtype``."""

    def __init__(self, config: LlamaConfig, seed: int = 0,
                 device=None, use_kernels: bool = True):
        """Built on ``device``: CUDA unless ``device="cpu"`` is asked for
        (it raises when no GPU is visible).  ``use_kernels=False`` runs
        attention through the flash functions' plain versions even on
        CUDA (the on-card comparison path)."""
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.model = LlamaModel(config, use_kernels)
            if not config.tie_word_embeddings:
                self.lm_head = Dense(config.hidden_size, config.vocab_size,
                                     config.dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random fp32 weights from a CPU ``torch.Generator`` seeded with
        ``seed``, so that a seed gives the same weights on every device:
        each projection ~ N(0, 1/fan_in), embeddings ~ N(0, 1/hidden),
        norms 1.  The numbers differ from Flax's initialisers; the parity
        tests carry weights across instead."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            else:           # [out, in] projections and [vocab, hidden]
                p.copy_(torch.empty(p.shape).normal_(
                    0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen))

    def forward(self, input_ids, labels=None, positions=None, cache=None,
                cache_index=None):
        if cache is not None or cache_index is not None:
            raise NotImplementedError(
                "LlamaForCausalLM: incremental decoding with a KV cache "
                "serves the v1 inference engine, not ported yet (ROADMAP "
                "A9); serve with deepspeed_tpu_torch.inference.v2")
        x = self.model(input_ids, positions)
        if self.config.tie_word_embeddings:
            emb = self.model.embed_tokens.weight
            logits = F.linear(x.to(self.config.dtype),
                              emb.to(self.config.dtype))
        else:
            logits = self.lm_head(x)
        if labels is not None:
            return cross_entropy_loss(logits, labels)
        return logits


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Next-token CE in fp32 with ignore-index masking."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None]).squeeze(-1)
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
