from deepspeed_tpu_torch.utils.logging import log_dist, logger

__all__ = ["log_dist", "logger"]
