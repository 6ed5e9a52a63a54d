"""Mixtral-style MoE configuration (counterpart of
``deepspeed_tpu/models/mixtral.py``).

Only the configuration is ported: :class:`MixtralConfig` serves the ragged
serving path (``inference/v2/model_implementations/ragged_mixtral.py``).
The training model ``MixtralForCausalLM`` and ``moe/`` come with MoE
training (ROADMAP A8, with the gmm backward kernels).
"""

from __future__ import annotations

import dataclasses

from deepspeed_tpu_torch.models.llama import LlamaConfig


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

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
