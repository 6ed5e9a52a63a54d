"""The fault points and liveness beats the serving scheduler uses
(counterpart of ``deepspeed_tpu/resilience/chaos.py`` and
``heartbeat.py``; the checkpoint manifests, the resilient train loop and
the job supervisor are not ported).

* :mod:`.chaos` — deterministic named fault points, armed through the
  environment or in-process, free no-ops until armed;
* :mod:`.heartbeat` — the worker-side liveness protocol (file-mtime
  beats + SIGUSR1 stack dumps) a supervisor's hang detector reads.
"""

from deepspeed_tpu_torch.resilience import chaos
from deepspeed_tpu_torch.resilience.chaos import ChaosInjectedError
from deepspeed_tpu_torch.resilience.heartbeat import (Heartbeat,
                                                      HeartbeatInfo,
                                                      install_stack_dump,
                                                      read_heartbeat)

__all__ = ["ChaosInjectedError", "Heartbeat", "HeartbeatInfo", "chaos",
           "install_stack_dump", "read_heartbeat"]
