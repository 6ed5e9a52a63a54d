"""Speculative decoding (counterpart of
``deepspeed_tpu/inference/v2/speculative/``).

Three layers, one mechanism:

* **draft** (:mod:`drafter`) — self-speculative n-gram / prompt-lookup and
  radix-prefix-cache drafters (no extra model), plus a pluggable
  small-model drafter interface;
* **verify** — ``InferenceEngineV2.verify_step(uids, tokens[K])`` scores K
  candidate positions per sequence in one weight pass, through the paged
  verify kernel on the card (``kernels.paged_verify_attention``);
  :func:`accept_drafts` walks the sampler's draws against the drafts, and
  ``engine.commit_verified`` rolls rejected lookahead blocks back so the
  allocator ends where a never-drafted run would;
* **schedule** — the serving scheduler that runs verify passes on decode
  ticks (``SpeculativeConfig`` configures it) is not ported yet; a caller
  drives draft → ``verify_step`` → :func:`accept_drafts` →
  ``commit_verified`` itself.

The drafters and the acceptance rule are pure host Python, copied from the
JAX package with their behaviour.
"""

from deepspeed_tpu_torch.inference.v2.speculative.drafter import (
    Drafter,
    NgramDrafter,
    PrefixCacheDrafter,
    SmallModelDrafter,
    make_self_drafter,
)
from deepspeed_tpu_torch.inference.v2.speculative.verify import (
    SpeculativeConfig,
    SpeculativeStats,
    accept_drafts,
)

__all__ = ["Drafter", "NgramDrafter", "PrefixCacheDrafter",
           "SmallModelDrafter", "SpeculativeConfig", "SpeculativeStats",
           "accept_drafts", "make_self_drafter"]
