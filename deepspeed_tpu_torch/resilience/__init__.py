"""Fault-tolerant checkpointing, auto-resume and job supervision
(counterpart of ``deepspeed_tpu/resilience/``, with the same exports).

* :mod:`.manifest` — checksummed per-tag manifests, the atomic
  stage -> rename -> publish commit protocol the checkpoint engine commits
  by, and tag verification / fallback enumeration;
* :mod:`.chaos` — deterministic named fault points, armed through the
  environment or in-process, free no-ops until armed;
* :mod:`.loop` — :class:`ResilientTrainLoop`: periodic commits,
  ``auto_resume()``, retention GC, and the NaN / loss-spike sentinel;
* :mod:`.heartbeat` — the worker-side liveness protocol (file-mtime
  beats + SIGUSR1 stack dumps) the supervisor's hang detector reads;
* :mod:`.supervisor` — :class:`JobSupervisor`: the detect -> kill ->
  resize -> resume loop over worker processes, with exponential backoff,
  a sliding-window restart budget, and host blacklisting;
* :mod:`.metrics` — ``resilience/*`` series.
"""

from deepspeed_tpu_torch.resilience import chaos, manifest
from deepspeed_tpu_torch.resilience.chaos import ChaosInjectedError
from deepspeed_tpu_torch.resilience.heartbeat import (Heartbeat,
                                                      HeartbeatInfo,
                                                      install_stack_dump,
                                                      read_heartbeat)
from deepspeed_tpu_torch.resilience.loop import (ResilientTrainLoop,
                                                 apply_retention)
from deepspeed_tpu_torch.resilience.metrics import ResilienceMetrics
from deepspeed_tpu_torch.resilience.supervisor import (BackoffPolicy,
                                                       HostBlacklist,
                                                       JobSupervisor,
                                                       RestartBudget,
                                                       WorkerSpec)

__all__ = ["BackoffPolicy", "ChaosInjectedError", "Heartbeat",
           "HeartbeatInfo", "HostBlacklist", "JobSupervisor",
           "ResilienceMetrics", "ResilientTrainLoop", "RestartBudget",
           "WorkerSpec", "apply_retention", "chaos", "install_stack_dump",
           "manifest", "read_heartbeat"]
