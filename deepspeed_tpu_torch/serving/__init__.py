"""Continuous-batching serving layer (counterpart of
``deepspeed_tpu/serving/``; reference: the DeepSpeed-MII request loop above
FastGen — iteration-level Orca-style scheduling with Dynamic SplitFuse
packing).  The multi-replica router (``serving/router.py``) is ROADMAP A5b.

Typical use::

    from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler,
                                             SamplingParams)

    sched = ContinuousBatchScheduler(engine)
    req = sched.submit(prompt_tokens,
                       sampling=SamplingParams(max_new_tokens=64))
    sched.run_until_idle()
    print(req.generated, req.ttft)
"""

# speculative decoding lives with the engine (inference/v2/speculative)
# but is configured at the scheduler — re-exported here for convenience
from deepspeed_tpu_torch.inference.v2.speculative import (
    NgramDrafter, PrefixCacheDrafter, SmallModelDrafter, SpeculativeConfig,
    SpeculativeStats, make_self_drafter)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import (Request, RequestSnapshot,
                                                 RequestState,
                                                 SamplingParams)
from deepspeed_tpu_torch.serving.sampler import sample_batch, sample_one
from deepspeed_tpu_torch.serving.scheduler import (ContinuousBatchScheduler,
                                                   QueueFullError,
                                                   TickDeadlineError)

__all__ = ["ContinuousBatchScheduler", "NgramDrafter", "PrefixCacheDrafter",
           "QueueFullError", "Request", "RequestSnapshot", "RequestState",
           "SamplingParams", "ServingMetrics", "SmallModelDrafter",
           "SpeculativeConfig", "SpeculativeStats", "TickDeadlineError",
           "make_self_drafter", "sample_batch", "sample_one"]
