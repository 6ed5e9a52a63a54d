"""DeepSpeed-compatible JSON config for the single-device engine
(counterpart of ``deepspeed_tpu/runtime/config.py``).

The same JSON keys are read.  What the port's engine runs: the batch trio,
``optimizer`` / ``scheduler``, ``fp16`` / ``bf16``, ZeRO stage 0 or 1 (one
device: nothing to shard), ``gradient_clipping``, ``attention_layout``,
``activation_checkpointing``, ``wall_clock_breakdown`` and
``steps_per_print``.  A key that turns on a path the port has not ported
raises ``NotImplementedError`` naming its ROADMAP item; a key with no
meaning on one device (communication bucket sizes and the like) is
ignored, as the JAX package ignores unknown keys.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.attention import ATTENTION_LAYOUTS
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    loss_scale: float = C.FP16_LOSS_SCALE_DEFAULT
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    consecutive_hysteresis: bool = False
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = C.ADAMW_OPTIMIZER
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ZeroConfig(DeepSpeedConfigModel):
    """Only the stage: at world size 1, stages 0 and 1 hold the same
    state (ZeRO-1 shards optimizer state over data-parallel ranks, and
    there is one)."""

    stage: int = 0

    def _validate(self) -> None:
        if not 0 <= self.stage <= 3:
            raise ValueError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.stage >= 2:
            raise NotImplementedError(
                f"zero_optimization.stage {self.stage}: ZeRO-2/3 are not "
                f"ported yet (ROADMAP A6)")


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """Read for the two keys the port refuses; every other key of the
    block (contiguous memory, profiling) is accepted and has no effect on
    one device."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False

    def _validate(self) -> None:
        if self.partition_activations or self.cpu_checkpointing:
            raise NotImplementedError(
                "activation_checkpointing.partition_activations / "
                "cpu_checkpointing are not ported yet (ROADMAP A6)")


# keys of zero_optimization that turn on an unported path (ROADMAP A6);
# the rest of that block tunes communication, which one device does not do
_ZERO_UNPORTED = {
    "offload_param": lambda v: (v or {}).get("device", "none") != "none",
    "offload_optimizer": lambda v: (v or {}).get("device", "none") != "none",
    "cpu_offload": bool,
    "cpu_offload_params": bool,
    "zero_hpz_partition_size": lambda v: int(v) > 1,
    "zero_quantized_weights": bool,
    "zero_quantized_nontrainable_weights": bool,
    "zero_quantized_gradients": bool,
    "mics_shard_size": lambda v: int(v) > 0,
}

# top-level blocks whose path is not ported, and the ROADMAP item of each
_UNPORTED_BLOCKS = {
    "pipeline": "A6", "elasticity": "A7", "hybrid_engine": "A9",
    "curriculum_learning": "A9", "data_efficiency": "A9",
    "progressive_layer_drop": "A9", "compression_training": "A9",
    "flops_profiler": "A11", "comms_logger": "A11", "tensorboard": "A11",
    "wandb": "A11", "csv_monitor": "A11", "autotuning": "A9",
}

_ONEBIT = (C.ONEBIT_ADAM_OPTIMIZER, C.ONEBIT_LAMB_OPTIMIZER,
           C.ZERO_ONE_ADAM_OPTIMIZER)


def _enabled(block) -> bool:
    if isinstance(block, dict):
        return bool(block.get("enabled", bool(block)))
    return bool(block)


class DeepSpeedConfig:
    """Parsed top-level config (a dict or a path to a JSON file).  Batch
    trio resolution follows the JAX package: ``train_batch_size =
    micro_batch * gradient_accumulation_steps * dp_world_size``."""

    def __init__(self, config: Any):
        if isinstance(config, str):
            with open(config, "r") as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = copy.deepcopy(config)
        else:
            raise ValueError(
                f"config must be dict or path, got {type(config)}")
        pd = self._param_dict
        for key, item in _UNPORTED_BLOCKS.items():
            if key in pd and (key == "pipeline" or _enabled(pd[key])):
                raise NotImplementedError(
                    f"config key '{key}': its path is not ported yet "
                    f"(ROADMAP {item})")
        zero = pd.get("zero_optimization") or {}
        for key, on in _ZERO_UNPORTED.items():
            if key in zero and on(zero[key]):
                raise NotImplementedError(
                    f"zero_optimization.{key}: offload / ZeRO++ / MiCS are "
                    f"not ported yet (ROADMAP A6)")

        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        self.steps_per_print = pd.get("steps_per_print",
                                      C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = float(pd.get("gradient_clipping",
                                              C.GRADIENT_CLIPPING_DEFAULT))
        self.wall_clock_breakdown = pd.get("wall_clock_breakdown", False)
        self.dataloader_drop_last = pd.get("dataloader_drop_last", False)
        self.attention_layout = pd.get("attention_layout", "bshd")
        self.attention_layout_explicit = "attention_layout" in pd
        if self.attention_layout not in ATTENTION_LAYOUTS:
            raise ValueError(
                f"attention_layout must be one of {ATTENTION_LAYOUTS}, got "
                f"{self.attention_layout!r}")

        self.fp16 = FP16Config.from_dict(pd.get("fp16"))
        self.bf16 = BF16Config.from_dict(pd.get("bf16", pd.get("bfloat16")))
        self.optimizer = (OptimizerConfig.from_dict(pd["optimizer"])
                          if "optimizer" in pd else None)
        if self.optimizer is not None and \
                self.optimizer.type.lower().replace("_", "") in _ONEBIT:
            raise NotImplementedError(
                f"optimizer '{self.optimizer.type}': the 1-bit optimizers "
                f"are not ported yet (ROADMAP A6)")
        self.scheduler = (SchedulerConfig.from_dict(pd["scheduler"])
                          if "scheduler" in pd else None)
        self.zero_config = ZeroConfig.from_dict(zero)
        self.activation_checkpointing = \
            ActivationCheckpointingConfig.from_dict(
                pd.get("activation_checkpointing"))

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    @property
    def loss_scale_enabled(self) -> bool:
        return self.fp16.enabled

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.fp16.enabled and self.fp16.loss_scale == 0

    def resolve_batch_size(self, dp_world_size: int = 1) -> None:
        """Batch trio algebra: any two of {train_batch_size, micro_batch,
        gas} determine the third.  The port runs at world size 1."""
        if dp_world_size > 1:
            raise NotImplementedError(
                f"world size {dp_world_size}: the port's engine runs on one "
                f"device (multi-device training is ROADMAP A6)")
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        dp = dp_world_size
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp:
                raise ValueError(
                    f"train_batch_size {tb} != micro_batch {mb} * gas {gas} "
                    f"* dp {dp}")
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp)
            if tb % (mb * dp) != 0 or gas == 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro_batch "
                    f"{mb} * dp {dp}")
        elif tb is not None and gas is not None:
            if tb % (gas * dp) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by gas {gas} * dp "
                    f"{dp}")
            mb = tb // (gas * dp)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp
        elif tb is not None:
            gas = 1
            mb = tb // dp
        else:
            raise ValueError("one of train_batch_size / "
                             "train_micro_batch_size_per_gpu required")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas
