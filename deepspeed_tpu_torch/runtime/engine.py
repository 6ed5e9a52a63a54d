"""DeepSpeedEngine on one device (counterpart of the single-device subset of
``deepspeed_tpu/runtime/engine.py``; reference runtime/engine.py:175).

The module's forward returns the loss.  The user surface is the JAX
package's: ``loss = engine(*batch)``,
``engine.backward(loss)``, ``engine.step()``, ``train_batch``, gradient
accumulation boundaries, dynamic fp16 loss scaling, global-norm clipping.

State (the JAX engine's state tree, held here as tensors and host numbers):

* the module's parameters are the compute-precision weights (bf16 under
  ``bf16.enabled``, fp16 under ``fp16.enabled``, fp32 otherwise); the
  engine keeps fp32 master copies and the optimizer's fp32 state;
* gradients are taken with respect to the compute-precision parameters of
  the loss times ``loss_scale / gas`` (in fp32), and accumulate in fp32
  buffers across micro-steps;
* ``step`` at a boundary: unscale, global L2 norm in fp32, under fp16
  ``overflow = not isfinite(norm)``, clip by ``min(1, clip / (norm +
  1e-6))``, the optimizer update with ``opt_step + 1`` on the masters, the
  dynamic loss scale with hysteresis exactly as the JAX package's
  ``_loss_scale_next`` (engine.py:693-718), then master -> compute params.
  On overflow the masters and optimizer state are kept; ``global_steps``
  always advances, ``opt_step`` only without overflow.

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX engine's
checkpoint directories (``checkpoint/engine.py``): the same files, names
and Flax layouts, so either engine resumes from the other's checkpoint.

What is not ported: the JAX engine runs a gas=1 micro step and its update
as one XLA program with donated buffers; here they are separate PyTorch
calls that compute the same state.  The overflow test reads one flag to
the host under fp16 (the JAX engine keeps it on the device); bf16 and fp32
steps never synchronise.  ZeRO stages >= 2, offload, ZeRO++, 1-bit
optimizers and more than one device raise (ROADMAP A6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import (
    get_accelerator, resolve_device)
from deepspeed_tpu_torch.ops.attention import set_default_attention_layout
from deepspeed_tpu_torch.ops.optimizers import OptimizerDef, get_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_lr_schedule_fn)
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import (BACKWARD_MICRO_TIMER,
                                             FORWARD_MICRO_TIMER,
                                             STEP_MICRO_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)


class DeepSpeedEngine:
    """Training engine on one device (``device=None`` means CUDA)."""

    def __init__(self, model: nn.Module, config: Any,
                 model_parameters: Optional[Mapping[str, Any]] = None,
                 lr_scheduler: Any = None, device=None):
        self.device = resolve_device(device)
        self.accelerator = get_accelerator(self.device)
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config))
        self.config.resolve_batch_size(1)
        self.module = model
        if self.config.attention_layout_explicit:
            set_default_attention_layout(self.config.attention_layout)

        # precision ------------------------------------------------------
        self.compute_dtype = self.config.precision_dtype
        self.fp16_enabled = self.config.fp16.enabled
        self.dynamic_loss_scale = self.config.dynamic_loss_scale
        fp16 = self.config.fp16
        if self.fp16_enabled and self.dynamic_loss_scale:
            self._initial_scale = float(2.0 ** fp16.initial_scale_power)
        elif self.fp16_enabled:
            self._initial_scale = float(fp16.loss_scale)
        else:
            self._initial_scale = 1.0
        self.zero_stage = self.config.zero_optimization_stage

        # optimizer and schedule -----------------------------------------
        opt_cfg = self.config.optimizer
        opt_type, opt_params = (("adamw", {}) if opt_cfg is None
                                else (opt_cfg.type, dict(opt_cfg.params)))
        self._base_lr = float(opt_params.get("lr", 1e-3))
        self.optimizer_def: OptimizerDef = get_optimizer(opt_type, opt_params)
        self.optimizer = self     # the reference returns engine.optimizer
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif self.config.scheduler is not None and self.config.scheduler.type:
            self.lr_scheduler = LRScheduler(get_lr_schedule_fn(
                self.config.scheduler.type,
                {**self.config.scheduler.params, "lr": self._base_lr}))
        else:
            self.lr_scheduler = None

        # state ----------------------------------------------------------
        if model_parameters is not None:
            model.load_state_dict(model_parameters)      # initial weights
        model.to(self.device)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        trained = [p for _, p in named]
        with torch.no_grad():
            self.master = [p.detach().float().clone() for p in trained]
            model.to(self.compute_dtype)
        self._params = trained
        self.opt_state = self.optimizer_def.init(self.master)
        self.acc_grads = [torch.zeros_like(m) for m in self.master]
        self.opt_step = 0
        self.loss_scale = self._initial_scale
        self.good_steps = 0
        self.hysteresis = int(fp16.hysteresis)

        # bookkeeping ----------------------------------------------------
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training = True
        self._seen_backward = True     # no forward waiting for backward
        self._last_grad_norm = None
        if "activation_checkpointing" in self.config._param_dict:
            from deepspeed_tpu_torch.runtime.activation_checkpointing import (
                checkpointing)

            checkpointing.configure(deepspeed_config=self.config)
        self.timers = (SynchronizedWallClockTimer(self.accelerator)
                       if self.config.wall_clock_breakdown else NoopTimer())
        self.tput_timer = ThroughputTimer(
            self.accelerator, batch_size=self.config.train_batch_size,
            steps_per_output=self.config.steps_per_print)
        log_dist(
            f"DeepSpeedEngine: device={self.device} zero_stage="
            f"{self.zero_stage} dtype={self.compute_dtype} micro_batch="
            f"{self.config.train_micro_batch_size_per_gpu} gas="
            f"{self.config.gradient_accumulation_steps} params="
            f"{sum(m.numel() for m in self.master) / 1e6:.2f}M", ranks=[0])

    # ------------------------------------------------------------------ #
    # Batch trio (reference getters)
    # ------------------------------------------------------------------ #
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    # ------------------------------------------------------------------ #
    # forward / backward / step
    # ------------------------------------------------------------------ #
    def _place(self, arg):
        if isinstance(arg, np.ndarray):
            arg = torch.from_numpy(arg)
        if isinstance(arg, torch.Tensor):
            return arg.to(self.device, non_blocking=True)
        return arg

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """Training: the loss, with the graph kept for ``backward``; eval:
        the module's output under ``torch.no_grad``."""
        args = tuple(self._place(a) for a in args)
        kwargs = {k: self._place(v) for k, v in kwargs.items()}
        if not self.training:
            with torch.no_grad():
                return self.module(*args, **kwargs)
        if self.micro_steps % self.gradient_accumulation_steps() == 0:
            self.tput_timer.start()
        self.timers(FORWARD_MICRO_TIMER).start()
        loss = self.module(*args, **kwargs)
        self.timers(FORWARD_MICRO_TIMER).stop(
            sync=self.config.wall_clock_breakdown)
        self._seen_backward = False
        return loss

    def backward(self, loss, retain_graph: bool = False):
        """Gradients of ``loss * loss_scale / gas`` (fp32) with respect to
        the compute-precision parameters, added to the fp32 accumulators."""
        if self._seen_backward:
            raise RuntimeError("backward() called twice for one forward(), "
                               "or without a forward()")
        self._seen_backward = True
        self.timers(BACKWARD_MICRO_TIMER).start()
        scale = self.loss_scale / self.gradient_accumulation_steps()
        (loss.float() * scale).backward(retain_graph=retain_graph)
        with torch.no_grad():
            pairs = [(a, p.grad) for a, p in zip(self.acc_grads, self._params)
                     if p.grad is not None]
            if pairs:
                torch._foreach_add_([a for a, _ in pairs],
                                    [g for _, g in pairs])
            for p in self._params:
                p.grad = None
        self.timers(BACKWARD_MICRO_TIMER).stop(
            sync=self.config.wall_clock_breakdown)
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu()
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def get_lr(self) -> List[float]:
        """The LR the next optimizer step applies: the schedule read at
        ``global_steps`` without stepping it."""
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler.lr_fn(self.global_steps))]
        return [self._base_lr]

    @torch.no_grad()
    def step(self):
        """The optimizer step at a gradient-accumulation boundary; returns
        the global gradient norm (a device scalar), else None."""
        if not self.is_gradient_accumulation_boundary():
            return None
        lr = self.get_lr()[0]
        self.timers(STEP_MICRO_TIMER).start()
        grads = self.acc_grads
        if self.fp16_enabled or self.dynamic_loss_scale:
            torch._foreach_mul_(grads, float(np.float32(1.0)
                                             / np.float32(self.loss_scale)))
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        # under fp16 the overflow flag is read on the host (one sync)
        overflow = self.fp16_enabled and not bool(torch.isfinite(gnorm))
        clip = self.config.gradient_clipping
        if clip > 0.0 and not overflow:
            torch._foreach_mul_(grads, torch.clamp(clip / (gnorm + 1e-6),
                                                   max=1.0))
        if not overflow:
            self.opt_step += 1
            self.optimizer_def.update(grads, self.opt_state, self.master, lr,
                                      self.opt_step)
            torch._foreach_copy_(self._params, self.master)
        torch._foreach_zero_(grads)
        self._loss_scale_next(overflow)
        self._last_grad_norm = gnorm
        self.timers(STEP_MICRO_TIMER).stop(
            sync=self.config.wall_clock_breakdown)
        self._post_step_bookkeeping(overflow)
        return gnorm

    def _loss_scale_next(self, overflow: bool) -> None:
        """Dynamic loss scale bookkeeping (reference fp16/loss_scaler.py
        DynamicLossScaler): lower the scale only once ``hysteresis``
        consecutive overflows have drained the counter."""
        if not (self.fp16_enabled and self.dynamic_loss_scale):
            return
        cfg = self.config.fp16
        lower = overflow and self.hysteresis <= 1
        grow = not overflow and self.good_steps + 1 >= cfg.loss_scale_window
        if lower:
            self.loss_scale = max(self.loss_scale / 2.0, cfg.min_loss_scale)
        elif grow:
            self.loss_scale *= 2.0
        self.good_steps = 0 if (overflow or grow) else self.good_steps + 1
        if overflow:
            self.hysteresis = max(self.hysteresis - 1, 1)
        elif cfg.consecutive_hysteresis or grow:
            self.hysteresis = int(cfg.hysteresis)

    def _post_step_bookkeeping(self, overflow: bool) -> None:
        report = (self.global_steps + 1) % self.config.steps_per_print == 0
        self.tput_timer.stop(global_step=True,
                             sync=report or self.config.wall_clock_breakdown)
        self.global_steps += 1
        self.skipped_steps += int(overflow)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(self.global_steps)
        if report and self.config.wall_clock_breakdown:
            self.timers.log([FORWARD_MICRO_TIMER, BACKWARD_MICRO_TIMER,
                             STEP_MICRO_TIMER], memory_breakdown=True)

    def train_batch(self, data_iter=None, batch=None):
        """Consume ``gas`` micro-batches — from ``data_iter``, or stacked
        tensors / arrays with a leading gas dim via ``batch`` — run
        forward / backward on each and one optimizer step; returns the
        mean loss."""
        gas = self.gradient_accumulation_steps()
        if self.micro_steps % gas != 0 or not self._seen_backward:
            raise RuntimeError(
                f"train_batch called mid-accumulation (micro_steps="
                f"{self.micro_steps}, gas={gas}, pending forward="
                f"{not self._seen_backward}): finish the pending "
                f"forward/backward/step sequence first")
        if batch is not None:
            micros = [tuple(leaf[g] for leaf in batch) for g in range(gas)]
        elif data_iter is not None:
            micros = [next(data_iter) for _ in range(gas)]
        else:
            raise ValueError("train_batch needs data_iter or batch")
        losses = []
        for micro in micros:
            micro = micro if isinstance(micro, (tuple, list)) else (micro,)
            loss = self.forward(*micro)
            self.backward(loss)
            self.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train_micro_batch(self, *args):
        """Forward, backward and step over one micro-batch (the step
        applies at a gradient-accumulation boundary); returns the loss."""
        loss = self.forward(*args)
        self.backward(loss)
        self.step()
        return loss

    def train(self, mode: bool = True):
        self.training = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    # ------------------------------------------------------------------ #
    # Introspection (reference engine getters)
    # ------------------------------------------------------------------ #
    def get_global_grad_norm(self) -> Optional[float]:
        """The last step's global gradient norm (reading it synchronises)."""
        if self._last_grad_norm is None:
            return None
        return float(self._last_grad_norm)

    def zero_optimization(self) -> bool:
        return self.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_loss_scale(self) -> float:
        return self.loss_scale

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 master weights by parameter name."""
        return dict(zip(self._names, self.master))

    # ------------------------------------------------------------------ #
    # Checkpointing (reference engine.save_checkpoint:3021 /
    # load_checkpoint:2672)
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        save_latest: bool = True):
        """Write the engine's state under ``save_dir/tag`` (default tag
        ``global_step{N}``) with ``client_state`` plus the engine's step
        counters and LR schedule, and publish it as ``latest``."""
        from deepspeed_tpu_torch.checkpoint.engine import save_engine_state

        if not self._seen_backward:
            raise RuntimeError(
                "save_checkpoint called between forward() and backward(): "
                "finish the micro-step first")
        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
        })
        if self.lr_scheduler is not None:
            client_state["lr_scheduler"] = self.lr_scheduler.state_dict()
        save_engine_state(self, save_dir, tag, client_state,
                          save_latest=save_latest)
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False,
                        verify: str = "full", fallback: bool = True,
                        metrics=None):
        """Load ``load_dir/tag`` (default: ``latest``, falling back to the
        newest verified tag) into this engine's tensors on its device;
        returns ``(path, client_state)`` or ``(None, {})``."""
        from deepspeed_tpu_torch.checkpoint.engine import load_engine_state

        path, client_state = load_engine_state(
            self, load_dir, tag,
            load_optimizer_states=load_optimizer_states
            and not load_module_only,
            verify=verify, fallback=fallback, metrics=metrics)
        if path is None:
            return None, {}
        if client_state:
            self.global_steps = int(client_state.get("global_steps", 0))
            self.global_samples = int(client_state.get("global_samples", 0))
            self.micro_steps = int(client_state.get("micro_steps", 0))
            self.skipped_steps = int(client_state.get("skipped_steps", 0))
            if (load_lr_scheduler_states and self.lr_scheduler is not None
                    and "lr_scheduler" in client_state):
                self.lr_scheduler.load_state_dict(
                    client_state["lr_scheduler"])
        return path, client_state
