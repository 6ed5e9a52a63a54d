"""Mixtral-style MoE causal LM (counterpart of
``deepspeed_tpu/models/mixtral.py``).

:class:`MixtralConfig` serves both the ragged serving path
(``inference/v2/model_implementations/ragged_mixtral.py``) and training.
:class:`MixtralForCausalLM` is the Llama backbone with each FFN replaced by
a top-k routed :class:`~deepspeed_tpu_torch.moe.MoE`, with the Flax model's
structure and names: ``embed_tokens``, ``layers[i]`` with
``input_layernorm`` / ``self_attn`` / ``post_attention_layernorm`` /
``block_sparse_moe`` (``deepspeed_moe.gate.wg``, ``deepspeed_moe.experts.
w_gate|w_up|w_down``), ``norm``, ``lm_head`` — no ``model`` level, as in
the Flax tree.  With labels it returns the next-token cross entropy plus
``router_aux_loss_coef`` times the mean of the layers' ``l_aux``; without,
the logits.

As in the JAX package the MoE layers route by capacity top-k (GShard
einsums, library calls).  ``dropless=True``, an option of the port's
constructor that the JAX model does not have, builds every layer as
``MoE(..., dropless=True)``: exact top-k and the expert FFN as three
grouped GEMMs, forward and backward on the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.llama import (Dense, LlamaAttention,
                                              LlamaConfig, RMSNorm,
                                              cross_entropy_loss)
from deepspeed_tpu_torch.moe.layer import MoE, reset_parameters


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    moe_capacity_factor: float = 1.25

    @staticmethod
    def tiny(**kw) -> "MixtralConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=128,
                    num_local_experts=4, num_experts_per_tok=2)
        base.update(kw)
        return MixtralConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw) -> "MixtralConfig":
        """HF ``mistralai/Mixtral-8x7B-v0.1`` geometry."""
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    num_local_experts=8, num_experts_per_tok=2,
                    rope_theta=1e6)
        base.update(kw)
        return MixtralConfig(**base)


#: The JAX package's sharding rules, as data: regexes over the Flax
#: parameter paths (the names ``checkpoint.mixtral_state_dict_from_flax``
#: maps from) and the mesh axes of each dimension.  Nothing reads them yet:
#: tensor and expert sharding come with multi-device training (ROADMAP A6).
MIXTRAL_PARTITION_RULES = [
    (r"embed_tokens/embedding", ("model", None)),
    (r"(q_proj|k_proj|v_proj)/kernel", (None, "model")),
    (r"o_proj/kernel", ("model", None)),
    (r"experts/w_(gate|up)", ("expert", None, "model")),
    (r"experts/w_down", ("expert", "model", None)),
    (r"gate/wg/kernel", ()),
    (r"lm_head/kernel", (None, "model")),
    (r".*norm.*", ()),
]


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, device, use_kernels: bool = True,
                 dropless: bool = False):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, use_kernels)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.block_sparse_moe = MoE(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_experts=cfg.num_local_experts, k=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor,
            eval_capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype,
            dropless=dropless, use_kernels=use_kernels, device=device)

    def forward(self, x, positions, train: Optional[bool] = None):
        x = x + self.self_attn(self.input_layernorm(x), positions)
        moe_out, l_aux = self.block_sparse_moe(
            self.post_attention_layernorm(x), train)
        return x + moe_out, l_aux


class MixtralForCausalLM(nn.Module):
    """Returns the loss when ``labels`` are given (the training contract),
    else the logits [B, S, V] in ``config.dtype``."""

    def __init__(self, config: MixtralConfig, seed: int = 0, device=None,
                 use_kernels: bool = True, dropless: bool = False):
        """Built on ``device``: CUDA unless ``device="cpu"`` is asked for
        (it raises when no GPU is visible), with fp32 weights drawn there
        from ``seed`` (:func:`~deepspeed_tpu_torch.moe.layer.
        reset_parameters`).  ``use_kernels=False`` runs attention and the
        grouped GEMMs through their plain versions even on CUDA (the on-card
        comparison path)."""
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.embed_tokens = nn.Embedding(config.vocab_size,
                                             config.hidden_size)
            self.layers = nn.ModuleList(
                MixtralBlock(config, dev, use_kernels, dropless)
                for _ in range(config.num_hidden_layers))
            self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
            self.lm_head = Dense(config.hidden_size, config.vocab_size,
                                 config.dtype)
        reset_parameters(self, seed)

    @property
    def partition_rules(self):
        return MIXTRAL_PARTITION_RULES

    def forward(self, input_ids, labels=None, train: Optional[bool] = None):
        cfg = self.config
        b, s = input_ids.shape
        positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        x = self.embed_tokens(input_ids).to(cfg.dtype)
        aux_total = torch.zeros((), dtype=torch.float32,
                                device=input_ids.device)
        for layer in self.layers:
            x, l_aux = layer(x, positions, train)
            aux_total = aux_total + l_aux
        logits = self.lm_head(self.norm(x))
        if labels is None:
            return logits
        return cross_entropy_loss(logits, labels) + \
            cfg.router_aux_loss_coef * (aux_total / cfg.num_hidden_layers)
