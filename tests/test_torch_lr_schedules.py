"""Every LR schedule of the port against ``deepspeed_tpu.runtime
.lr_schedules`` at steps 0..60 (bar: 1e-6 relative, both in float32)."""

import numpy as np
import pytest

from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.runtime import lr_schedules as tlr


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20, "warmup_type": "log"}),
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 10,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 50, "warmup_min_lr": 0.0,
                       "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 8, "warmup_type": "linear"}),
    ("WarmupCosineLR", {"total_num_steps": 50, "warmup_num_steps": 10,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.01,
                        "lr": 3e-4}),
    ("WarmupCosineLR", {"total_num_steps": 30, "warmup_num_steps": 5,
                        "warmup_type": "linear", "lr": 1e-3}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 15}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 20,
                  "decay_step_size": 5, "decay_lr_rate": 0.5}),
])
def test_schedule_matches(name, params):
    jfn = jlr.get_lr_schedule_fn(name, params)
    tfn = tlr.get_lr_schedule_fn(name, params)
    for step in range(61):
        want = float(np.asarray(jfn(step)))
        got = tfn(step)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (step, got,
                                                                  want)


def test_scheduler_object_surface():
    fn = tlr.warmup_lr(warmup_max_lr=1e-3, warmup_num_steps=10,
                       warmup_type="linear")
    sched = tlr.LRScheduler(fn)
    assert sched.get_last_lr() == [0.0]
    for _ in range(5):
        sched.step()
    assert sched.get_lr() == [fn(4)]
    state = sched.state_dict()
    other = tlr.LRScheduler(fn)
    other.load_state_dict(state)
    assert other.get_last_lr() == sched.get_last_lr()
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tlr.get_lr_schedule_fn("nope", {})
