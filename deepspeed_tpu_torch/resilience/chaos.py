"""Deterministic fault-injection harness for the checkpoint path.

Counterpart of ``deepspeed_tpu/resilience/chaos.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

Production code is instrumented with *named fault points* — ``fire(point)``
calls that are free no-ops until a fault is **armed** at that point.  Tests
and the chaos smoke tool arm faults to prove the crash-recovery invariants
(a kill at any point during save leaves ``latest`` pointing at a fully
verified tag; silent corruption is detected at load) instead of asserting
them.

Checkpoint-path fault points (in ``checkpoint/sharded.py`` and
``resilience/manifest.py``):

``slow_io``
    before a shard file's bytes are written (default action: ``sleep``).
``crash_after_shard_write``
    after a shard file is written and fsynced (default: ``crash``).
``corrupt_shard_bytes``
    after a shard's checksum is recorded in its sidecar — firing the
    default ``corrupt`` action here models silent bit-rot *after* a good
    write, exactly what the manifest CRC exists to catch.
``fail_latest_publish``
    after the tag directory is renamed into place but before the
    ``latest`` pointer is republished (default: ``crash``).

Supervision fault points (the failure modes
:class:`~deepspeed_tpu_torch.resilience.supervisor.JobSupervisor` exists to
survive; fired per step by :class:`ResilientTrainLoop`, per beat by
:class:`~deepspeed_tpu_torch.resilience.heartbeat.Heartbeat`):

``worker_crash``
    at a step boundary in the training loop (default: ``crash`` — the
    clean-ish failure mode: nonzero exit the supervisor sees via wait).
``worker_hang``
    at a step boundary (default: ``hang`` — the process stops making
    progress but stays alive: heartbeats go stale, nothing exits).
``heartbeat_stall``
    inside :meth:`Heartbeat.beat` (default: ``drop`` — the beat is
    suppressed while the worker keeps computing, modelling a wedged
    heartbeat thread / stalled NFS mount; the supervisor must treat the
    stale file as a hang).

Fleet defense fault points (the hostile inputs / sick replicas the
quarantine + circuit-breaker + watchdog layer in
the JAX package's ``fleet/defense.py`` exists to survive):

``poison_request``
    fired by :meth:`ContinuousBatchScheduler.step` once per request
    packed into the engine forward, with ``key=str(uid)`` — arm it with
    a matching ``key`` to model a malformed request that
    deterministically crashes the engine whenever it is batched
    (default: ``raise`` in-process; use ``crash`` for subprocess
    workers).
``tick_stall``
    inside the scheduler tick, bracketed by the tick-watchdog timer
    (default: ``sleep`` — a slow-but-returning engine forward the
    watchdog must flag; arm with ``hang`` to model a true wedge only
    the supervisor's heartbeat detector can see).
``spawn_fail``
    in :meth:`ServingFleet._respawn` before the scheduler factory runs
    (default: ``raise`` — a replica whose respawn keeps failing must
    open its circuit breaker instead of eating restart budget).  Also
    fired by the elastic scale-up path (:meth:`ServingFleet.
    set_replica_count`): a failed spawn under load must deepen brownout,
    not crash the fleet.

Elastic-capacity fault points (the scale-event failure modes
:meth:`ServingFleet.set_replica_count` and the autoscaler exist to
survive):

``drain_stall``
    inside the scale-down victim's graceful drain loop, fired per drain
    step with ``key=<replica name>`` (default: ``sleep`` — the victim
    stops finishing work; the fleet must escalate to handoff/replay
    teardown at the drain deadline instead of waiting forever).
``scale_spawn_slow``
    before a scale-up spawn completes — in-process before the factory
    returns, subprocess before the worker's first beat (default:
    ``sleep`` — a slow-arriving replica; the autoscaler must not
    double-spawn while the first spawn is still warming).

Actions: ``crash`` (``os._exit``, for subprocess kill tests), ``raise``
(:class:`ChaosInjectedError`, for in-process tests), ``corrupt`` (flip one
byte of the file at the fault point's ``path``), ``sleep``, ``hang``
(block forever — only a supervisor SIGTERM/SIGKILL ends it), ``drop``
(suppress the instrumented operation: ``fire`` returns True and the call
site skips its work).

Arming: :func:`arm` / :func:`disarm` / the :func:`inject` context manager,
or the ``DS_CHAOS`` environment variable for subprocesses, e.g.::

    DS_CHAOS="crash_after_shard_write:after=1,exit_code=43"
    DS_CHAOS="poison_request:action=crash,key=7,count=0"

``after=N`` skips the first N hits of the point (fire on hit N+1);
``count=M`` fires at most M times (default 1); ``key=K`` restricts the
fault to ``fire`` calls carrying the same key (non-matching calls are
not even counted as hits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

from deepspeed_tpu_torch.utils.logging import logger

#: Every legal fault point name -> its default action.
FAULT_POINTS: Dict[str, str] = {
    "slow_io": "sleep",
    "crash_after_shard_write": "crash",
    "corrupt_shard_bytes": "corrupt",
    "fail_latest_publish": "crash",
    "worker_crash": "crash",
    "worker_hang": "hang",
    "heartbeat_stall": "drop",
    "poison_request": "raise",
    "tick_stall": "sleep",
    "spawn_fail": "raise",
    "drain_stall": "sleep",
    "scale_spawn_slow": "sleep",
}

ENV_VAR = "DS_CHAOS"


class ChaosInjectedError(RuntimeError):
    """Raised by a fault armed with action='raise'."""


@dataclasses.dataclass
class Fault:
    point: str
    action: str
    after: int = 0          # skip the first ``after`` hits
    count: int = 1          # fire at most ``count`` times (0 = unlimited)
    sleep_s: float = 0.05   # action='sleep'
    exit_code: int = 43     # action='crash'
    #: restrict the fault to ``fire`` calls carrying this key (e.g. a
    #: request uid for ``poison_request``); None matches every call
    key: Optional[str] = None
    hits: int = 0
    fires: int = 0


_armed: Dict[str, Fault] = {}
_env_loaded = False


def arm(point: str, action: Optional[str] = None, **kwargs) -> Fault:
    """Arm ``point`` with ``action`` (default: the point's natural action)."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}; "
                         f"known: {sorted(FAULT_POINTS)}")
    action = action or FAULT_POINTS[point]
    if action not in ("crash", "raise", "corrupt", "sleep", "hang", "drop"):
        raise ValueError(f"unknown chaos action {action!r}")
    fault = Fault(point=point, action=action, **kwargs)
    _armed[point] = fault
    return fault


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point, or everything (``point=None``)."""
    if point is None:
        _armed.clear()
    else:
        _armed.pop(point, None)


def armed(point: str) -> Optional[Fault]:
    """The fault armed at ``point`` (or None).  Loads ``DS_CHAOS`` first,
    so call sites may use this as a cheap gate before per-item ``fire``
    loops without missing env-armed subprocess faults."""
    _load_env_once()
    return _armed.get(point)


@contextlib.contextmanager
def inject(point: str, action: Optional[str] = None,
           **kwargs) -> Iterator[Fault]:
    """``with chaos.inject("slow_io", action="raise"): ...`` — armed only
    inside the block."""
    fault = arm(point, action, **kwargs)
    try:
        yield fault
    finally:
        disarm(point)


def _load_env_once() -> None:
    """Arm faults from ``DS_CHAOS`` (subprocess-facing; parsed lazily at
    the first fault-point hit so importing this module stays free)."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, opt_str = part.partition(":")
        opts: Dict[str, object] = {}
        for kv in filter(None, (s.strip() for s in opt_str.split(","))):
            k, _, v = kv.partition("=")
            if k in ("action", "key"):
                opts[k] = v
            elif k == "sleep_s":
                opts[k] = float(v)
            else:
                opts[k] = int(v)
        action = opts.pop("action", None)
        arm(name.strip(), action, **opts)  # type: ignore[arg-type]
        logger.warning(f"chaos: armed from {ENV_VAR}: {part}")


def _flip_byte(path: str) -> None:
    """Flip one byte in the middle of ``path`` (deterministic offset)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def fire(point: str, path: Optional[str] = None,
         key: Optional[str] = None) -> bool:
    """The fault point itself: a no-op unless ``point`` is armed.
    Returns True when a fault fired (the ``drop`` contract: the call site
    skips the instrumented operation on True).  ``key`` identifies the
    specific operation at the point (e.g. the request uid being fed); a
    fault armed with a ``key`` fires only on matching calls."""
    _load_env_once()
    fault = _armed.get(point)
    if fault is None:
        return False
    if fault.key is not None and key != fault.key:
        return False
    fault.hits += 1
    if fault.hits <= fault.after:
        return False
    if fault.count and fault.fires >= fault.count:
        return False
    fault.fires += 1
    if fault.fires == 1 or fault.count != 0:
        logger.warning(f"chaos: firing {point} (action={fault.action}, "
                       f"hit={fault.hits}, path={path})")
    if fault.action == "sleep":
        time.sleep(fault.sleep_s)
    elif fault.action == "corrupt":
        if path is not None and os.path.exists(path):
            _flip_byte(path)
    elif fault.action == "crash":
        # simulate a hard kill: no cleanup handlers, no flushing
        os._exit(fault.exit_code)
    elif fault.action == "hang":
        # a wedged worker: alive (heartbeats may even continue from other
        # threads) but never progressing — only SIGTERM/SIGKILL ends this
        while True:
            time.sleep(3600)
    elif fault.action == "drop":
        return True
    else:
        raise ChaosInjectedError(f"chaos fault injected at {point!r}")
    return True
