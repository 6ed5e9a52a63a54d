from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              apply_rotary,
                                              cross_entropy_loss)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "apply_rotary",
           "cross_entropy_loss"]
