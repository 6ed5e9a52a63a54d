"""Worker liveness heartbeats — the signal that lets a supervisor tell a
*hung* worker group from a slow one.

Counterpart of ``deepspeed_tpu/resilience/heartbeat.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

On real clusters hangs (a wedged collective, a stalled host, a dead NFS
mount) dominate over clean crashes, and ``Popen.wait`` alone can never see
them.  The protocol here is deliberately primitive so it survives exactly
the failures it must detect:

* the worker owns one **heartbeat file**; each :meth:`Heartbeat.beat`
  atomically replaces it (write temp + ``os.replace``) with a tiny JSON
  payload (pid, step, wall time).  The supervisor only ever reads the
  file's **mtime** — a torn or unparsable payload still proves liveness;
* no sockets, no threads, no locks: a beat is one small write, cheap
  enough to tick every training step / scheduler tick, and it cannot
  itself deadlock the worker;
* writes are throttled to one per ``interval_s / 4`` so a microsecond
  step loop does not turn the heartbeat into an I/O hot spot.

Wiring: the supervisor exports :data:`ENV_FILE` (path),
:data:`ENV_INTERVAL` (expected beat cadence) and :data:`ENV_DUMP` (stack
dump target) into each worker's environment;
:meth:`Heartbeat.from_env` picks them up — both
:class:`~deepspeed_tpu_torch.resilience.loop.ResilientTrainLoop` and the serving
:class:`~deepspeed_tpu_torch.serving.scheduler.ContinuousBatchScheduler` call it
and then beat automatically, so user code needs no changes to become
supervisable.

``from_env`` also installs a ``faulthandler`` handler on SIGUSR1 writing
all-thread stacks to :data:`ENV_DUMP`: before killing a hung worker the
supervisor triggers the dump, so every hang leaves a post-mortem of where
it was stuck.

The ``heartbeat_stall`` chaos fault point fires inside :meth:`beat` —
arming it (action ``drop``) suppresses beats while the worker keeps
computing, the exact "process alive, progress signal dead" failure the
supervisor's hang detector must catch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import IO, Dict, Optional

from deepspeed_tpu_torch.resilience import chaos
from deepspeed_tpu_torch.utils.logging import logger

#: Environment contract between JobSupervisor and its workers.
ENV_FILE = "DS_HEARTBEAT_FILE"
ENV_INTERVAL = "DS_HEARTBEAT_INTERVAL_S"
ENV_DUMP = "DS_STACKDUMP_FILE"

DEFAULT_INTERVAL_S = 5.0

#: Keep dump files open, keyed by path: faulthandler holds a raw fd (a
#: GC'd file object would close it out from under the signal handler),
#: and re-registering the same path must reuse the handle instead of
#: leaking an fd and truncating an existing dump on every from_env().
_dump_files: Dict[str, IO] = {}

#: The process's current heartbeat (last constructed wins — one worker
#: process has one supervised heartbeat).  Slow-but-progressing I/O paths
#: (checkpoint shard writes, manifest checksums, retention sweeps) call
#: :func:`tick_active` so a long save never reads as a hang, while a
#: single wedged syscall still goes stale and is correctly flagged.
_active: Optional["Heartbeat"] = None


def tick_active() -> None:
    """Beat the process's active heartbeat, if any (throttled as usual).
    Free when no heartbeat exists — safe to sprinkle on I/O paths."""
    if _active is not None:
        _active.beat(_active.last_step)


def install_stack_dump(path: str, signum: int = signal.SIGUSR1) -> None:
    """Register a ``faulthandler`` all-thread stack dump on ``signum``
    (default SIGUSR1), written to ``path``.  The supervisor sends the
    signal to a hung worker before escalating to SIGTERM/SIGKILL, so the
    kill never destroys the evidence of where the worker was stuck."""
    import faulthandler

    key = os.path.abspath(path)
    f = _dump_files.get(key)
    if f is None:
        f = open(path, "w")
        _dump_files[key] = f
    # register() replaces any previous handler for signum, so the newest
    # path wins and exactly one registration is ever live
    faulthandler.register(signum, file=f, all_threads=True)


class Heartbeat:
    """Worker-side liveness ticker (file-mtime based; see module doc)."""

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.path = path
        self.interval_s = float(interval_s)
        #: at most one write per this many seconds (beat() stays free to
        #: call from a hot loop)
        self.min_write_gap_s = self.interval_s / 4.0
        self._last_write = float("-inf")
        self._beats = 0
        self._warned_write_failure = False
        #: last step reported through beat() — reused by tick_active()
        self.last_step: Optional[int] = None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.beat(step=None, force=True)
        global _active
        _active = self

    def beat(self, step: Optional[int] = None, force: bool = False) -> bool:
        """Record liveness (throttled).  Returns True when a beat was
        written, False when throttled or chaos-stalled."""
        if chaos.fire("heartbeat_stall", path=self.path):
            return False
        if step is not None:
            self.last_step = step
        now = time.monotonic()
        if not force and now - self._last_write < self.min_write_gap_s:
            return False
        payload = {"pid": os.getpid(), "step": step, "time": time.time()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError as e:  # a failing beat must never kill the worker
            if not self._warned_write_failure:
                self._warned_write_failure = True
                logger.warning(f"heartbeat: beat failed ({e}); supervisor "
                               "may declare this worker hung")
            return False
        self._last_write = now
        self._beats += 1
        return True

    @classmethod
    def from_env(cls, default_interval_s: float = DEFAULT_INTERVAL_S
                 ) -> Optional["Heartbeat"]:
        """Build from the supervisor's environment contract; None when not
        running under a supervisor.  Also installs the SIGUSR1 stack-dump
        handler when :data:`ENV_DUMP` is set."""
        path = os.environ.get(ENV_FILE)
        if not path:
            return None
        interval = float(os.environ.get(ENV_INTERVAL, default_interval_s))
        hb = cls(path, interval_s=interval)
        dump = os.environ.get(ENV_DUMP)
        if dump:
            try:
                install_stack_dump(dump)
            except Exception as e:  # noqa: BLE001 — e.g. non-main thread
                logger.warning(f"heartbeat: stack-dump handler not "
                               f"installed: {e}")
        return hb


@dataclasses.dataclass
class HeartbeatInfo:
    """Supervisor-side view of one heartbeat file."""

    path: str
    exists: bool
    age_s: Optional[float]       # now - mtime; None when the file is absent
    step: Optional[int] = None   # best-effort from the JSON payload
    pid: Optional[int] = None
    wall_time: Optional[float] = None


def read_heartbeat(path: str, now: Optional[float] = None) -> HeartbeatInfo:
    """Read one heartbeat file.  Liveness (``age_s``) comes from the file
    mtime alone; the JSON payload is best-effort diagnostics — a torn
    write still counts as a beat."""
    now = time.time() if now is None else now
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return HeartbeatInfo(path=path, exists=False, age_s=None)
    info = HeartbeatInfo(path=path, exists=True, age_s=max(now - mtime, 0.0))
    try:
        with open(path) as f:
            payload = json.load(f)
        info.step = payload.get("step")
        info.pid = payload.get("pid")
        info.wall_time = payload.get("time")
    except (OSError, ValueError):
        pass
    return info
