"""Inference v2 — FastGen-style continuous batching (counterpart of
``deepspeed_tpu/inference/v2/``; reference: deepspeed/inference/v2/).

``InferenceEngineV2`` exposes the reference's ``put/query/flush`` API over a
paged (blocked) KV cache and a fixed-token-budget ragged batch.
"""

from deepspeed_tpu_torch.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig"]
