"""Fault points, liveness beats and checkpoint manifests (counterpart of
``deepspeed_tpu/resilience/chaos.py``, ``heartbeat.py`` and
``manifest.py``; the resilient train loop and the job supervisor are not
ported).

* :mod:`.chaos` — deterministic named fault points, armed through the
  environment or in-process, free no-ops until armed;
* :mod:`.heartbeat` — the worker-side liveness protocol (file-mtime
  beats + SIGUSR1 stack dumps) a supervisor's hang detector reads;
* :mod:`.manifest` — checksummed checkpoint manifests and the atomic
  stage -> rename -> publish protocol the checkpoint engine commits by.
"""

from deepspeed_tpu_torch.resilience import chaos, manifest
from deepspeed_tpu_torch.resilience.chaos import ChaosInjectedError
from deepspeed_tpu_torch.resilience.heartbeat import (Heartbeat,
                                                      HeartbeatInfo,
                                                      install_stack_dump,
                                                      read_heartbeat)

__all__ = ["ChaosInjectedError", "Heartbeat", "HeartbeatInfo", "chaos",
           "install_stack_dump", "manifest", "read_heartbeat"]
