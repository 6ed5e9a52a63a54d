from deepspeed_tpu_torch.models.gpt2 import (GPT2Block, GPT2Config,
                                             GPT2LMHeadModel)
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              apply_rotary,
                                              cross_entropy_loss)
from deepspeed_tpu_torch.models.mixtral import (MIXTRAL_PARTITION_RULES,
                                                MixtralConfig,
                                                MixtralForCausalLM)

__all__ = ["GPT2Block", "GPT2Config", "GPT2LMHeadModel", "LlamaConfig",
           "LlamaForCausalLM", "MIXTRAL_PARTITION_RULES", "MixtralConfig",
           "MixtralForCausalLM", "apply_rotary", "cross_entropy_loss"]
