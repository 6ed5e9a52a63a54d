"""Inference v2 model implementations (counterpart of
``deepspeed_tpu/inference/v2/model_implementations/``)."""

from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_llama import (
    RaggedLlama,
)
from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_mixtral import (
    RaggedMixtral,
)

__all__ = ["RaggedLlama", "RaggedMixtral"]
