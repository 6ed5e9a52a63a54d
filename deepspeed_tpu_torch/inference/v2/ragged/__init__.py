"""Ragged batching infrastructure (counterpart of
``deepspeed_tpu/inference/v2/ragged/``)."""

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.host_tier import (
    HostKVTier, HostTierStats)
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (
    BlockedKVCache, dequantize_kv, quantize_kv)
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import (
    PrefixCacheStats, RadixPrefixCache)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import (
    DSStateManager)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (
    RaggedBatchWrapper)
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (
    DSSequenceDescriptor,
)

__all__ = ["BlockedAllocator", "BlockedKVCache", "DSStateManager",
           "HostKVTier", "HostTierStats", "PrefixCacheStats", "RadixPrefixCache", "RaggedBatchWrapper",
           "DSSequenceDescriptor", "dequantize_kv", "quantize_kv"]
