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
``DeepSpeedEngine``) of Llama (``models.LlamaForCausalLM``) and of MoE
models (``models.MixtralForCausalLM``; ``moe.MoE``, capacity or dropless).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

__version__ = "0.1.0"


def initialize(model: Any, config: Any, model_parameters: Any = None,
               training_data: Any = None, lr_scheduler: Any = None,
               collate_fn: Optional[Callable] = None, device=None) -> Tuple:
    """Build the training engine (counterpart of
    ``deepspeed_tpu/__init__.py:24``) at world size 1.

    Returns ``(engine, optimizer, dataloader, lr_scheduler)``.  ``model``
    is an ``nn.Module`` whose forward returns the loss; ``config`` a
    DeepSpeed config dict, JSON path or ``DeepSpeedConfig`` (the engine
    builds its optimizer from it); ``model_parameters`` an optional
    ``state_dict`` of initial weights.  ``device`` defaults to CUDA."""
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"world size {dist.get_world_size()}: the port's engine runs on "
            f"one device (multi-device training is ROADMAP A6)")
    engine = DeepSpeedEngine(model=model, config=config,
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
