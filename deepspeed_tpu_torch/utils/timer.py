"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``; reference utils/timer.py:43
``SynchronizedWallClockTimer``, :198 ``ThroughputTimer``).

PyTorch on CUDA returns before the device finishes, so a region's host time
says nothing unless the work it queued is drained first: ``stop(sync=True)``
waits for the device through the accelerator the timer was given (a no-op
on the CPU).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.accelerator.real_accelerator import Accelerator
from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
BACKWARD_MICRO_TIMER = "bwd_microstep"
STEP_MICRO_TIMER = "step_microstep"


class SynchronizedWallClockTimer:
    """Named timer group on one device."""

    class Timer:
        def __init__(self, name: str, accelerator: Accelerator):
            self.name_ = name
            self.accelerator = accelerator
            self.started_ = False
            self.start_time = 0.0
            self.elapsed_records: List[float] = []

        def start(self) -> None:
            assert not self.started_, f"{self.name_} timer already started"
            self.started_ = True
            self.start_time = time.perf_counter()

        def stop(self, reset: bool = False, record: bool = True,
                 sync: bool = False) -> None:
            assert self.started_, f"{self.name_} timer is not started"
            if sync:
                self.accelerator.synchronize()
            elapsed = (time.perf_counter() - self.start_time) * 1000.0
            if reset:
                self.elapsed_records = [elapsed]
            elif record:
                self.elapsed_records.append(elapsed)
            self.started_ = False

        def reset(self) -> None:
            self.started_ = False
            self.elapsed_records = []

        def elapsed(self, reset: bool = True) -> float:
            """Total recorded msec (optionally resetting the record)."""
            started = self.started_
            if started:
                self.stop(record=True)
            total = sum(self.elapsed_records)
            if reset:
                self.elapsed_records = []
            if started:
                self.start()
            return total

    def __init__(self, accelerator: Accelerator):
        self.accelerator = accelerator
        self.timers: Dict[str, "SynchronizedWallClockTimer.Timer"] = {}

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.accelerator)
        return self.timers[name]

    def memory_usage(self) -> str:
        peak = self.accelerator.max_memory_allocated() / (1024 ** 3)
        return f"peak mem {peak:.2f} GB"

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, memory_breakdown: bool = False,
            ranks: Optional[List[int]] = None) -> Dict[str, float]:
        """Log (and return) msec / normalizer for each named timer."""
        assert normalizer > 0.0
        means = {name: self.timers[name].elapsed(reset=reset) / normalizer
                 for name in names if name in self.timers}
        string = "time (ms) | " + " | ".join(
            f"{k}: {v:.2f}" for k, v in means.items())
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])
        return means


class NoopTimer:
    """Disabled timers."""

    class Timer:
        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0.0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name: str):
        return self.timer

    def log(self, names=None, normalizer=1.0, reset=True,
            memory_breakdown=False, ranks=None):
        return {}


class ThroughputTimer:
    """Samples/sec over optimizer steps.  ``batch_size`` is the global
    train batch of one step; the first ``start_step`` steps (warm-up) are
    left out of the average."""

    def __init__(self, accelerator: Accelerator, batch_size: int,
                 start_step: int = 2, steps_per_output: int = 50,
                 logging_fn=None):
        self.accelerator = accelerator
        self.batch_size = max(1, int(batch_size))
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0   # window since the last report
        self.window_step_count = 0
        self.start_time = 0.0
        self.started = False

    def start(self):
        self.started = True
        self.start_time = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True,
             sync: bool = False):
        if not self.started:
            return
        self.started = False
        if sync:
            self.accelerator.synchronize()
        duration = time.perf_counter() - self.start_time
        if not global_step:
            return
        self.global_step_count += 1
        if self.global_step_count <= self.start_step:
            return
        self.total_elapsed_time += duration
        self.step_elapsed_time += duration
        self.window_step_count += 1
        if report_speed and \
                self.global_step_count % self.steps_per_output == 0:
            self.logging(
                f"global step {self.global_step_count}: "
                f"{self.avg_samples_per_sec():.2f} avg samples/sec, "
                f"{self.curr_samples_per_sec():.2f} curr samples/sec, "
                f"batch {self.batch_size}")
            self.step_elapsed_time = 0.0
            self.window_step_count = 0

    def avg_samples_per_sec(self) -> float:
        """Lifetime average (since ``start_step``)."""
        counted = self.global_step_count - self.start_step
        if counted > 0 and self.total_elapsed_time > 0:
            return counted * self.batch_size / self.total_elapsed_time
        return 0.0

    def curr_samples_per_sec(self) -> float:
        """Rate over the steps since the last periodic report."""
        if self.window_step_count > 0 and self.step_elapsed_time > 0:
            return self.window_step_count * self.batch_size / \
                self.step_elapsed_time
        return self.avg_samples_per_sec()
