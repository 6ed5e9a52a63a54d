from deepspeed_tpu_torch.models.llama import LlamaConfig, apply_rotary

__all__ = ["LlamaConfig", "apply_rotary"]
