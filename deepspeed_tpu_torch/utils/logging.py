"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "DeepSpeedTPUTorch",
                   level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(level=log_levels.get(
    os.environ.get("DS_LOG_LEVEL", "info"), logging.INFO))


def _process_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log only on the given process ranks (None or [-1] = all)."""
    my_rank = _process_rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
