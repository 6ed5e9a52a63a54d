from deepspeed_tpu_torch.checkpoint.jax_params import (
    params_from_jax, random_int8_llama_params)

__all__ = ["params_from_jax", "random_int8_llama_params"]
