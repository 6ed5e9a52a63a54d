"""Llama-family configuration and rotary embedding (counterpart of
``deepspeed_tpu/models/llama.py``: ``LlamaConfig`` and ``apply_rotary``).

Only what the ragged serving path needs is here; the Flax training model
is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


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
    # Mistral-style sliding-window attention: each token attends to at
    # most the previous `sliding_window` positions (None = full causal).
    sliding_window: Any = None

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


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding in fp32, cast back to ``x.dtype``;
    ``cos``/``sin`` broadcast over ``x`` ([..., D/2] against [..., D])."""
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
