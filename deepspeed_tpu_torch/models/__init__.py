from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              apply_rotary,
                                              cross_entropy_loss)
from deepspeed_tpu_torch.models.mixtral import MixtralConfig

__all__ = ["LlamaConfig", "LlamaForCausalLM", "MixtralConfig",
           "apply_rotary", "cross_entropy_loss"]
