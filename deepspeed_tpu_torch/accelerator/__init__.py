from deepspeed_tpu_torch.accelerator.real_accelerator import (Accelerator,
                                                             get_accelerator)

__all__ = ["Accelerator", "get_accelerator"]
