from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import (
    ExpertsFFN,
    MOELayer,
    TopKGate,
    top1gating,
    top2gating,
)

__all__ = ["ExpertsFFN", "MoE", "MOELayer", "TopKGate", "top1gating",
           "top2gating"]
