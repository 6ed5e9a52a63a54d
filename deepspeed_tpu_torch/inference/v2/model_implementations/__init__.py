"""Inference v2 model implementations (counterpart of
``deepspeed_tpu/inference/v2/model_implementations/``)."""

from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_llama import (
    RaggedLlama,
)

__all__ = ["RaggedLlama"]
