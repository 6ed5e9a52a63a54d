from deepspeed_tpu_torch.checkpoint.engine import (AsyncCheckpointEngine,
                                                   CheckpointEngine,
                                                   load_engine_state,
                                                   save_engine_state)
from deepspeed_tpu_torch.checkpoint.hf_loader import (HFLoadError,
                                                     config_from_hf,
                                                     hf_config,
                                                     load_hf_checkpoint)
from deepspeed_tpu_torch.checkpoint.jax_params import (
    flax_params_from_gpt2_state_dict, flax_params_from_llama_state_dict,
    flax_params_from_mixtral_state_dict, flax_params_from_moe_state_dict,
    gpt2_state_dict_from_flax, llama_state_dict_from_flax,
    mixtral_state_dict_from_flax, moe_state_dict_from_flax, params_from_jax,
    random_int8_llama_params, random_llama_params, random_mixtral_params)

__all__ = ["AsyncCheckpointEngine", "CheckpointEngine", "HFLoadError",
           "config_from_hf", "hf_config", "load_engine_state",
           "load_hf_checkpoint", "save_engine_state",
           "flax_params_from_gpt2_state_dict",
           "flax_params_from_llama_state_dict",
           "flax_params_from_mixtral_state_dict",
           "flax_params_from_moe_state_dict", "gpt2_state_dict_from_flax",
           "llama_state_dict_from_flax", "mixtral_state_dict_from_flax",
           "moe_state_dict_from_flax", "params_from_jax",
           "random_int8_llama_params", "random_llama_params",
           "random_mixtral_params"]
