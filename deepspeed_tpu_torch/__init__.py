"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The port mirrors the JAX package's paths and names
(``deepspeed_tpu_torch/inference/v2/ragged/kv_cache.py`` is the counterpart
of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``).  It imports torch
and numpy only: never JAX and nothing of ``deepspeed_tpu``.  Every TPU
kernel on a ported path is a CUDA kernel under ``csrc/``, built with
``nvcc`` at first use; each has a plain PyTorch version beside it, which
runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Two paths are ported: FastGen serving (``inference.v2.InferenceEngineV2``,
Llama and Mixtral) and single-device training (:func:`initialize` ->
``DeepSpeedEngine``) of Llama (``models.LlamaForCausalLM``), GPT-2
(``models.GPT2LMHeadModel``) and MoE models
(``models.MixtralForCausalLM``; ``moe.MoE``, capacity or dropless), under
every ``attention_layout`` ("bshd", "folded", "paired").
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils.logging import log_dist, logger

__version__ = "0.1.0"

__all__ = ["DeepSpeedConfig", "DeepSpeedDataLoader", "DeepSpeedEngine",
           "RepeatingLoader", "add_config_arguments", "get_accelerator",
           "init_distributed", "initialize", "log_dist", "logger"]


def _one_device_only(what: str):
    return NotImplementedError(
        f"{what}: the port's engine runs on one device (multi-device "
        f"training is ROADMAP A6)")


def initialize(args=None,
               model: Any = None,
               optimizer: Any = None,
               model_parameters: Any = None,
               training_data: Any = None,
               lr_scheduler: Any = None,
               distributed_port: int = 29500,
               mpu: Any = None,
               dist_init_required: Optional[bool] = None,
               collate_fn: Optional[Callable] = None,
               config: Any = None,
               config_params: Any = None,
               loss_fn: Optional[Callable] = None,
               topology: Any = None,
               base_param_specs: Any = None,
               batch_spec: Any = None,
               device=None) -> Tuple:
    """Build the training engine (counterpart of
    ``deepspeed_tpu/__init__.py:24``, the same parameters in the same
    order) at world size 1.

    Returns ``(engine, optimizer, dataloader, lr_scheduler)``.  ``model``
    is an ``nn.Module`` whose forward returns the loss; the config is
    ``config``, else ``config_params``, else ``args.deepspeed_config``: a
    DeepSpeed config dict, JSON path or ``DeepSpeedConfig`` (the engine
    builds its optimizer from it); ``model_parameters`` an optional
    ``state_dict`` of initial weights.  ``device`` (the port's own
    keyword) defaults to CUDA.  A client ``optimizer``, an ``mpu``, a
    ``topology`` of more than one device, ``loss_fn`` and the sharding
    specs raise ``NotImplementedError``."""
    if optimizer is not None:
        raise NotImplementedError(
            "initialize(optimizer=...): a client optimizer is not ported "
            "(ROADMAP A6); name the optimizer in the config")
    if mpu is not None:
        raise _one_device_only("initialize(mpu=...)")
    if topology is not None and getattr(topology, "world_size", 1) > 1:
        raise _one_device_only(f"initialize(topology=...) of "
                               f"{topology.world_size} devices")
    if base_param_specs is not None or batch_spec is not None:
        raise _one_device_only("initialize(base_param_specs / batch_spec)")
    if loss_fn is not None:
        raise NotImplementedError(
            "initialize(loss_fn=...): the port's model forward returns the "
            "loss (ROADMAP A6)")
    init_distributed(dist_init_required=dist_init_required,
                     distributed_port=distributed_port)
    cfg = config if config is not None else config_params
    if cfg is None and getattr(args, "deepspeed_config", None) is not None:
        cfg = args.deepspeed_config
    if cfg is None:
        raise ValueError("DeepSpeed config required (config= or "
                         "args.deepspeed_config)")
    engine = DeepSpeedEngine(model=model, config=cfg,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device)
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data,
            batch_size=engine.config.train_micro_batch_size_per_gpu,
            collate_fn=collate_fn,
            drop_last=engine.config.dataloader_drop_last)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


def add_config_arguments(parser):
    """Add the ``--deepspeed`` / ``--deepspeed_config`` argparse flags
    (``deepspeed_tpu/__init__.py:149``)."""
    import argparse

    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse.SUPPRESS)
    return parser


def init_distributed(dist_backend: str = "nccl",
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True, timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config=None, rank: int = -1,
                     world_size: int = -1) -> None:
    """Counterpart of ``deepspeed_tpu/__init__.py:168`` at world size 1:
    nothing to rendezvous.  A world of more than one process (``world_size``
    or ``$WORLD_SIZE``, or a ``torch.distributed`` group already formed)
    raises."""
    import torch.distributed as dist

    n = int(os.environ.get("WORLD_SIZE", world_size if world_size > 0 else 1))
    if dist.is_available() and dist.is_initialized():
        n = max(n, dist.get_world_size())
    if n > 1:
        raise _one_device_only(f"world size {n}")
