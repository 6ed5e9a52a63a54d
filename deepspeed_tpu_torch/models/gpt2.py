"""GPT-2 causal LM (counterpart of ``deepspeed_tpu/models/gpt2.py``).

Learned positional embeddings, pre-LayerNorm blocks, a fused ``c_attn``
projection split into q, k and v, a tanh-GELU MLP, and the unembedding
tied to ``wte``.  The modules carry the Flax model's names (``wte``,
``wpe``, ``h[i]`` with ``ln_1`` / ``c_attn`` / ``attn_out`` / ``ln_2`` /
``c_fc`` / ``c_proj``, ``ln_f``); a LayerNorm's Flax ``scale`` is its
``weight`` here.  Parameters may be held in any floating type; the
compute type is ``config.dtype``, cast where Flax casts it:

* ``nn.Embed(dtype=...)`` casts the table before the lookup, so the token
  and position embeddings are summed in the compute type;
* ``nn.LayerNorm(dtype=..., param_dtype=float32)`` takes its statistics
  in fp32 and returns the compute type;
* ``Dense(dtype=...)`` casts input, kernel and bias;
* ``wte.attend`` multiplies by the table cast to the compute type.

``GPT2LMHeadModel(input_ids, labels)`` returns the next-token cross
entropy (:func:`~deepspeed_tpu_torch.models.llama.cross_entropy_loss`);
without labels it returns the logits.  Attention follows
``attention_layout``: under "folded" and "paired" the q, k and v column
slices of the ``c_attn`` output go to the attention as they are, and the
flash kernels read them in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.llama import Dense, cross_entropy_loss
from deepspeed_tpu_torch.ops.attention import (dot_product_attention,
                                               folded_attention,
                                               paired_attention,
                                               resolve_attention_layout)
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing)


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    embd_pdrop: float = 0.0
    attn_pdrop: float = 0.0         # kept for the config; unused, as in JAX
    resid_pdrop: float = 0.0
    # HF `n_inner`: MLP width (None -> the GPT-2 default of 4*n_embd)
    intermediate_size: Any = None
    dtype: Any = torch.bfloat16
    remat: bool = False
    # "paired" | "folded" | "bshd" | None (None -> the process default set
    # from the DeepSpeed config's `attention_layout`)
    attention_layout: Any = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_dim(self) -> int:
        return (self.intermediate_size if self.intermediate_size
                else 4 * self.hidden_size)

    @staticmethod
    def gpt2_125m(**kw) -> "GPT2Config":
        return GPT2Config(**kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
        base.update(kw)
        return GPT2Config(**base)


class LayerNorm(nn.LayerNorm):
    """Statistics and affine map in fp32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.compute_dtype)


def _dropout(x, keep, rate: float):
    """Flax's ``Dropout``: kept entries scaled by 1 / (1 - rate)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.implementation = "auto" if use_kernels else "plain"
        hid, dt, eps = cfg.hidden_size, cfg.dtype, cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(hid, eps, dt)
        self.c_attn = Dense(hid, 3 * hid, dt, bias=True)
        self.attn_out = Dense(hid, hid, dt, bias=True)
        self.ln_2 = LayerNorm(hid, eps, dt)
        self.c_fc = Dense(hid, cfg.mlp_dim, dt, bias=True)
        self.c_proj = Dense(cfg.mlp_dim, hid, dt, bias=True)

    def forward(self, x, keep=None):
        """``keep``: the two residual dropout masks, or None."""
        cfg = self.cfg
        h, d = cfg.num_attention_heads, cfg.head_dim
        # q, k and v are column views of the one c_attn output
        q, k, v = self.c_attn(self.ln_1(x)).split(cfg.hidden_size, dim=-1)
        layout = resolve_attention_layout(cfg.attention_layout)
        if layout in ("folded", "paired"):
            fn = paired_attention if layout == "paired" else folded_attention
            out = fn(q, k, v, num_heads=h, causal=True,
                     implementation=self.implementation)
        else:
            out = dot_product_attention(
                q.unflatten(-1, (h, d)), k.unflatten(-1, (h, d)),
                v.unflatten(-1, (h, d)), causal=True,
                implementation=self.implementation).flatten(2)
        out = self.attn_out(out)
        if keep is not None:
            out = _dropout(out, keep[0], cfg.resid_pdrop)
        x = x + out
        y = self.c_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh"))
        if keep is not None:
            y = _dropout(y, keep[1], cfg.resid_pdrop)
        return x + y


class GPT2LMHeadModel(nn.Module):
    """Returns the loss when ``labels`` are given (the training contract),
    else the logits [B, S, V] in ``config.dtype``."""

    def __init__(self, config: GPT2Config, seed: int = 0, device=None,
                 use_kernels: bool = True):
        """Built on ``device``: CUDA unless ``device="cpu"`` is asked for
        (it raises when no GPU is visible), with fp32 weights drawn there
        from ``seed``.  ``use_kernels=False`` runs attention through the
        flash functions' plain versions even on CUDA (the on-card
        comparison path).  Dropout (``embd_pdrop`` / ``resid_pdrop`` > 0,
        in training mode) draws its masks from a ``torch.Generator`` on
        the same device, seeded with ``seed``."""
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.wte = nn.Embedding(config.vocab_size, config.hidden_size)
            self.wpe = nn.Embedding(config.max_position_embeddings,
                                    config.hidden_size)
            self.h = nn.ModuleList(GPT2Block(config, use_kernels)
                                   for _ in range(config.num_hidden_layers))
            self.ln_f = LayerNorm(config.hidden_size,
                                  config.layer_norm_epsilon, config.dtype)
        self.dropout_generator = torch.Generator(device=dev)
        self.dropout_generator.manual_seed(seed)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights drawn on the parameters' device from a
        ``torch.Generator`` seeded with ``seed`` (a seed gives other
        numbers on the CPU than on the GPU): LayerNorm weights 1, biases
        0, every other weight ~ N(0, 1/fan_in) (``[out, in]`` projections:
        in; ``[rows, H]`` embeddings: H).  The numbers differ from Flax's
        initialisers; the parity tests carry weights across instead."""
        gen = torch.Generator(device=self.wte.weight.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in f".{name}":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=gen)

    def _keep(self, shape, rate: float):
        return torch.rand(shape, generator=self.dropout_generator,
                          device=self.wte.weight.device) >= rate

    def forward(self, input_ids, labels=None,
                deterministic: Optional[bool] = None):
        """``deterministic`` (default: not ``self.training``) switches
        dropout off."""
        cfg = self.config
        dt = cfg.dtype
        if deterministic is None:
            deterministic = not self.training
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = (F.embedding(input_ids, self.wte.weight.to(dt))
             + F.embedding(pos, self.wpe.weight.to(dt))[None])
        if cfg.embd_pdrop > 0 and not deterministic:
            x = _dropout(x, self._keep(x.shape, cfg.embd_pdrop),
                         cfg.embd_pdrop)
        for block in self.h:
            # masks drawn outside the block, so a recomputation reuses them
            keep = None
            if cfg.resid_pdrop > 0 and not deterministic:
                keep = (self._keep(x.shape, cfg.resid_pdrop),
                        self._keep(x.shape, cfg.resid_pdrop))
            if cfg.remat and torch.is_grad_enabled():
                x = checkpointing.checkpoint(block, x, keep)
            else:
                x = block(x, keep)
        x = self.ln_f(x)
        logits = F.linear(x.to(dt), self.wte.weight.to(dt))
        if labels is not None:
            return cross_entropy_loss(logits, labels)
        return logits
