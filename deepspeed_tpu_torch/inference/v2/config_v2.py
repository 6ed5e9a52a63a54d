"""Inference v2 config (counterpart of
``deepspeed_tpu/inference/v2/config_v2.py``; reference:
inference/v2/config_v2.py ``RaggedInferenceEngineConfig``,
``DSStateManagerConfig`` ragged/manager_configs.py).

The same dict keys as the JAX package.  Options whose paths are not ported
yet (tensor parallelism) raise ``NotImplementedError`` when set, rather
than being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass
class DSStateManagerConfig(DeepSpeedConfigModel):
    """reference ragged/manager_configs.py:DSStateManagerConfig."""

    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 256      # token budget per forward
    max_ragged_sequence_count: int = 32   # sequences per forward
    max_context: int = 8192               # per-sequence context bound
    memory_config: Any = None
    offload: bool = False

    def _validate(self):
        if self.max_ragged_sequence_count > self.max_ragged_batch_size:
            raise ValueError("max_ragged_sequence_count cannot exceed the "
                             "token budget (max_ragged_batch_size)")


@dataclasses.dataclass
class KVCacheConfig(DeepSpeedConfigModel):
    """reference ragged/manager_configs.py:KVCacheConfig (blocked KV)."""

    block_size: int = 64
    num_blocks: Optional[int] = None     # None -> derived from max_context
    cache_dtype: Any = None
    #: pool storage dtype ``"bf16" | "f32" | "f16" | "int8"`` (int8:
    #: block-quantized payload + fp32 scale per row and KV head); takes
    #: precedence over the legacy ``cache_dtype``
    dtype: Optional[str] = None
    #: radix prefix cache over the block pool (ref-counted, LRU-evicted
    #: under pressure, copy-on-write on shared-block writes)
    enable_prefix_cache: bool = False
    #: host-memory cold tier: LRU-evicted prefix-cache blocks spool to host
    #: memory and restore bit-exact on resume (needs the prefix cache)
    host_tier: bool = False
    #: the tier's byte budget (oldest entries drop first); None = unbounded
    host_tier_bytes: Optional[int] = None

    def _validate(self):
        if self.dtype is not None:
            from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (
                resolve_kv_dtype)

            resolve_kv_dtype(self.dtype)   # raises on an unknown dtype


@dataclasses.dataclass
class RaggedInferenceEngineConfig(DeepSpeedConfigModel):
    """reference inference/v2/config_v2.py:30."""

    tensor_parallel: Any = None
    state_manager: Any = None
    kv_cache: Any = None
    quantization: Any = None

    def __post_init__(self):
        if not isinstance(self.state_manager, DSStateManagerConfig):
            self.state_manager = DSStateManagerConfig.from_dict(
                self.state_manager or {})
        if not isinstance(self.kv_cache, KVCacheConfig):
            self.kv_cache = KVCacheConfig.from_dict(self.kv_cache or {})
        if self.tensor_parallel is None:
            self.tensor_parallel = {"tp_size": 1}
        if int(self.tensor_parallel.get("tp_size", 1)) > 1:
            raise NotImplementedError(
                "tensor_parallel.tp_size > 1 is not ported to "
                "deepspeed_tpu_torch yet; serve on one GPU")
