"""Ragged inference kernels (counterpart of
``deepspeed_tpu/inference/v2/kernels/``)."""

from deepspeed_tpu_torch.inference.v2.kernels.blocked_flash import (
    paged_attention,
    paged_attention_plain,
    paged_attention_usable,
    paged_decode_attention,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_verify_attention,
)

__all__ = ["paged_attention", "paged_attention_plain",
           "paged_attention_usable", "paged_decode_attention",
           "paged_prefill_attention", "paged_prefill_attention_plain",
           "paged_verify_attention"]
