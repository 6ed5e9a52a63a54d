"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``:
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR).

Each schedule is a function of the global step evaluated on the host, in
float32 as the JAX package evaluates it, returning a Python float.  The
engine reads the schedule at its step counter (no device round trip);
:class:`LRScheduler` keeps the reference's ``step()`` / ``get_last_lr()``
object surface.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

LRFn = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]

_f = np.float32


def _clip01(x):
    return np.clip(x, _f(0.0), _f(1.0))


def _warmup_frac(s, wsteps: int, warmup_type: str):
    if warmup_type == "log":
        return _clip01(np.log1p(s) / _f(math.log1p(wsteps)))
    return _clip01(s / _f(wsteps))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_unused) -> LRFn:
    """min -> max over the warmup steps (log or linear), then flat."""
    wmin, wmax, wsteps = _f(warmup_min_lr), _f(warmup_max_lr), \
        max(1, warmup_num_steps)

    def fn(step):
        frac = _warmup_frac(_f(step), wsteps, warmup_type)
        return float(wmin + (wmax - wmin) * frac)

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000, warmup_type: str = "log",
                    **_unused) -> LRFn:
    """WarmupLR followed by linear decay to 0 at total_num_steps."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    wsteps = max(1, warmup_num_steps)
    total = max(total_num_steps, wsteps + 1)

    def fn(step):
        s = _f(step)
        if s < wsteps:
            return base(step)
        decay = _clip01((_f(total) - s) / _f(total - wsteps))
        return float(_f(warmup_max_lr) * decay)

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_type: str = "log", lr: float = 0.001,
                     **_unused) -> LRFn:
    """Warmup (as a ratio of the peak) then cosine decay to
    cos_min_ratio * peak."""
    wsteps = max(1, warmup_num_steps)
    total = max(total_num_steps, wsteps + 1)

    def fn(step):
        s = _f(step)
        if s < wsteps:
            wfrac = _warmup_frac(s, wsteps, warmup_type)
            ratio = _f(warmup_min_ratio) + _f(1.0 - warmup_min_ratio) * wfrac
        else:
            prog = _clip01((s - _f(wsteps)) / _f(total - wsteps))
            ratio = _f(cos_min_ratio) + _f(1.0 - cos_min_ratio) * _f(0.5) * (
                _f(1.0) + np.cos(_f(math.pi) * prog))
        return float(_f(lr) * ratio)

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False,
                  **_unused) -> LRFn:
    """Linearly (optionally staircase) increasing LR for the LR range
    test."""
    size = max(1, lr_range_test_step_size)

    def fn(step):
        interval = _f(step) / _f(size)
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return float(_f(lr_range_test_min_lr)
                     * (_f(1.0) + interval * _f(lr_range_test_step_rate)))

    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_unused) -> LRFn:
    """min -> max over the first phase, max -> min over the second, then
    post-cycle decay."""
    lo, hi = _f(cycle_min_lr), _f(cycle_max_lr)
    first = max(1, cycle_first_step_size)
    second = cycle_second_step_size or first
    cycle_end = first + second

    def fn(step):
        s = _f(step)
        if s < first:
            return float(lo + (hi - lo) * _clip01(s / _f(first)))
        if s < cycle_end:
            return float(hi - (hi - lo) * _clip01((s - _f(first))
                                                  / _f(second)))
        if decay_step_size > 0 and decay_lr_rate > 0.0:
            steps = np.floor((s - _f(cycle_end)) / _f(decay_step_size))
            return float(lo / (_f(1.0) + _f(decay_lr_rate)
                               * np.maximum(steps, _f(0.0))))
        return float(lo)

    return fn


_SCHEDULES: Dict[str, Callable[..., LRFn]] = {
    WARMUP_LR.lower(): warmup_lr,
    WARMUP_DECAY_LR.lower(): warmup_decay_lr,
    WARMUP_COSINE_LR.lower(): warmup_cosine_lr,
    LR_RANGE_TEST.lower(): lr_range_test,
    ONE_CYCLE.lower(): one_cycle,
}


def get_lr_schedule_fn(name: str, params: Dict[str, Any]) -> LRFn:
    key = name.lower()
    if key not in _SCHEDULES:
        raise ValueError(
            f"Unknown scheduler '{name}'. Valid: {VALID_LR_SCHEDULES}")
    return _SCHEDULES[key](**dict(params))


class LRScheduler:
    """Host-side wrapper with the reference's object surface
    (``step`` / ``get_last_lr`` / ``state_dict``)."""

    def __init__(self, lr_fn: LRFn, last_batch_iteration: int = -1):
        self.lr_fn = lr_fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self.lr_fn(max(0, self.last_batch_iteration)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
