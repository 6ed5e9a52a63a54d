"""Elastic job supervision: the detect → kill → resize → resume loop.

Counterpart of ``deepspeed_tpu/resilience/supervisor.py``, with its names,
events, counters and decisions (the port keeps its own copy: it imports
nothing of the JAX package).

The reference stack splits this across ``launcher/`` (the
``DSElasticAgent._invoke_run`` relaunch loop) and ``elasticity/`` (batch
algebra for resizing the world); :class:`JobSupervisor` is the piece that
closes the loop above both.  It owns the worker processes and a monitor
thread that watches two independent failure signals:

* **crash** — a worker exits nonzero (``Popen.poll``);
* **hang** — a worker's heartbeat file (see
  :mod:`~deepspeed_tpu_torch.resilience.heartbeat`) goes staler than
  ``hang_timeout_s`` while the process is still alive.  This is the
  dominant failure mode of large clusters (wedged collective, stalled
  host) and the one a plain ``wait()`` loop can never see.

On a fault the supervisor:

1. for hangs, first asks the stuck worker for an all-thread stack dump
   (SIGUSR1 → ``faulthandler``) and captures it — the post-mortem must
   exist *before* the kill destroys it;
2. tears the whole group down: SIGTERM to each worker's process group,
   then SIGKILL for anything still alive after ``term_grace_s``;
3. records the failure against the worker's host; a host failing
   ``blacklist_after`` consecutive times is blacklisted out of the pool;
4. checks the sliding-window **restart budget** (``max_restarts`` within
   ``restart_window_s`` — a long-lived job earns back its budget as the
   window slides past old failures);
5. recomputes a smaller-but-compatible world via
   :func:`~deepspeed_tpu_torch.elasticity.compute_elastic_config` when hosts
   were lost (the elastic batch algebra guarantees convergence is
   preserved across the resize);
6. sleeps an exponential backoff (+ jitter, so a fleet's supervisors do not
   relaunch in lockstep) and relaunches.

Workers recover their own state through the checkpoint machinery
(:class:`ResilientTrainLoop.auto_resume` + the verified-manifest loader),
so a restart costs at most ``save_interval`` steps and a mid-step
``kill -9`` yields a bit-exact loss curve — proven end-to-end by
``deepspeed_tpu_torch/tools/supervisor_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import subprocess
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.resilience import heartbeat as hb
from deepspeed_tpu_torch.resilience.metrics import ResilienceMetrics
from deepspeed_tpu_torch.utils.logging import logger


def signal_process_group(proc: subprocess.Popen, sig: int) -> None:
    """Signal a worker's whole process group (workers are spawned
    ``start_new_session=True`` so children die with them); fall back to
    the process itself when the group is gone or inaccessible.  Shared by
    :class:`JobSupervisor` and the launcher's ``wait_all``."""
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, ValueError):
            pass


# --------------------------------------------------------------------- #
# Restart policy pieces (also used by launcher/runner.py's elastic loop)
# --------------------------------------------------------------------- #
class BackoffPolicy:
    """Exponential backoff with jitter: ``base * factor**attempt`` capped
    at ``max_s``, stretched by up to ``jitter`` fraction so a fleet of
    supervisors does not thundering-herd the scheduler.  Seeded, so tests
    are deterministic."""

    def __init__(self, base_s: float = 1.0, factor: float = 2.0,
                 max_s: float = 60.0, jitter: float = 0.1, seed: int = 0):
        if base_s < 0 or factor < 1.0 or max_s < base_s or jitter < 0:
            raise ValueError(
                f"invalid backoff: base_s={base_s} factor={factor} "
                f"max_s={max_s} jitter={jitter}")
        self.base_s = base_s
        self.factor = factor
        self.max_s = max_s
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (0-based)."""
        d = min(self.base_s * self.factor ** max(attempt, 0), self.max_s)
        return d * (1.0 + self._rng.uniform(0.0, self.jitter))


class RestartBudget:
    """Sliding-window restart budget: at most ``max_restarts`` restarts
    within any ``window_s``-second window.  Unlike a bare attempt counter,
    a job that runs healthily long enough earns its budget back — only
    *frequent* failure exhausts it."""

    def __init__(self, max_restarts: int = 3, window_s: float = 300.0):
        if max_restarts < 0 or window_s <= 0:
            raise ValueError(
                f"invalid budget: max_restarts={max_restarts} "
                f"window_s={window_s}")
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._times: Deque[float] = deque()

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._times and self._times[0] <= cutoff:
            self._times.popleft()

    def in_window(self, now: Optional[float] = None) -> int:
        self._trim(time.monotonic() if now is None else now)
        return len(self._times)

    def exhausted(self, now: Optional[float] = None) -> bool:
        """True when one MORE restart would exceed the budget."""
        return self.in_window(now) >= self.max_restarts

    def record(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._trim(now)
        self._times.append(now)


class HostBlacklist:
    """Consecutive-failure host blacklist.  A success on a host resets its
    count — only a host that fails ``threshold`` times in a row (likely
    bad hardware, not a transient) is removed from the pool."""

    def __init__(self, threshold: int = 2):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self._failures: Dict[str, int] = {}
        self._blacklisted: set = set()

    def record_failure(self, host: str) -> bool:
        """Returns True when this failure crossed the threshold."""
        n = self._failures.get(host, 0) + 1
        self._failures[host] = n
        if n >= self.threshold and host not in self._blacklisted:
            self._blacklisted.add(host)
            return True
        return False

    def record_success(self, host: str) -> None:
        self._failures.pop(host, None)

    def is_blacklisted(self, host: str) -> bool:
        return host in self._blacklisted

    @property
    def hosts(self) -> set:
        return set(self._blacklisted)


# --------------------------------------------------------------------- #
# Worker plumbing
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class WorkerSpec:
    """How to launch one worker: host label (blacklist/diagnostics key),
    argv, and extra environment on top of the supervisor's heartbeat
    contract."""

    host: str
    cmd: List[str]
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    cwd: Optional[str] = None


class WorkerHandle:
    """One live worker: its process, heartbeat file, and dump target."""

    def __init__(self, spec: WorkerSpec, proc: subprocess.Popen,
                 heartbeat_file: str, dump_file: str):
        self.spec = spec
        self.proc = proc
        self.heartbeat_file = heartbeat_file
        self.dump_file = dump_file
        self.started_at = time.time()
        # liveness is mtime CHANGE detection on the monotonic clock: raw
        # wall-clock-minus-mtime arithmetic would declare a mass hang on
        # an NTP step forward (or mask a real hang on a step back).  The
        # baseline read here also absorbs a stale file from a previous
        # incarnation: until its mtime changes, the worker hasn't beaten.
        self._last_seen_mtime = self._stat_mtime()
        self._last_change_mono = time.monotonic()
        self._beating = False

    @property
    def host(self) -> str:
        return self.spec.host

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _stat_mtime(self) -> Optional[float]:
        try:
            return os.stat(self.heartbeat_file).st_mtime
        except OSError:
            return None

    def beat_age(self, now_mono: Optional[float] = None
                 ) -> Tuple[float, bool]:
        """(monotonic seconds since the heartbeat file last changed,
        has_beaten_this_incarnation).  Before the first observed beat the
        age runs from handle creation and counts against the *startup*
        timeout, not the hang timeout."""
        now = time.monotonic() if now_mono is None else now_mono
        mtime = self._stat_mtime()
        if mtime is not None and mtime != self._last_seen_mtime:
            self._last_seen_mtime = mtime
            self._last_change_mono = now
            self._beating = True
        return max(now - self._last_change_mono, 0.0), self._beating

    def signal_group(self, sig: int) -> None:
        signal_process_group(self.proc, sig)


#: spec_fn(hosts, attempt) -> worker specs for the current world.
#: ``attempt`` is the restart count (0 = first launch) so launch recipes
#: can vary across incarnations (e.g. chaos armed only on attempt 0).
SpecFn = Callable[[List[str], int], List[WorkerSpec]]


class JobSupervisor:
    """Owns the worker ``Popen``s and the detect→kill→resize→resume loop
    (see module doc).  ``start()`` launches workers and the monitor
    thread; ``wait()`` joins it; ``run()`` does both synchronously."""

    def __init__(self, spec_fn: SpecFn, hosts: Sequence[str], *,
                 run_dir: Optional[str] = None,
                 heartbeat_interval_s: float = hb.DEFAULT_INTERVAL_S,
                 hang_timeout_s: Optional[float] = None,
                 startup_timeout_s: float = 120.0,
                 poll_s: Optional[float] = None,
                 term_grace_s: float = 5.0,
                 dump_grace_s: float = 1.0,
                 backoff: Optional[BackoffPolicy] = None,
                 max_restarts: int = 3,
                 restart_window_s: float = 300.0,
                 blacklist_after: int = 2,
                 min_hosts: int = 1,
                 slots_per_host: int = 1,
                 elastic_config: Optional[dict] = None,
                 metrics: Optional[ResilienceMetrics] = None,
                 monitor=None):
        if not hosts:
            raise ValueError("JobSupervisor needs at least one host")
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate hosts: {list(hosts)}")
        self.spec_fn = spec_fn
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        #: hang = heartbeat staler than this; default 4x the beat cadence
        #: (beats are throttled to interval/4, so a healthy worker's file
        #: never ages past ~interval plus one slow step)
        self.hang_timeout_s = (float(hang_timeout_s) if hang_timeout_s
                               is not None else 4.0 * heartbeat_interval_s)
        self.startup_timeout_s = float(startup_timeout_s)
        self.poll_s = (float(poll_s) if poll_s is not None
                       else min(self.hang_timeout_s / 4.0, 1.0))
        self.term_grace_s = float(term_grace_s)
        self.dump_grace_s = float(dump_grace_s)
        self.backoff = backoff or BackoffPolicy()
        self.budget = RestartBudget(max_restarts, restart_window_s)
        self.blacklist = HostBlacklist(blacklist_after)
        self.min_hosts = min_hosts
        self.slots_per_host = slots_per_host
        self.elastic_config = elastic_config
        self.metrics = metrics if metrics is not None \
            else ResilienceMetrics(monitor)
        self._owns_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="ds_supervisor_")
        os.makedirs(self.run_dir, exist_ok=True)

        self.hosts = list(hosts)            # healthy pool (shrinks)
        self.handles: List[WorkerHandle] = []
        self.events: List[dict] = []        # structured, for tests/ops
        self.dumps: Dict[str, List[str]] = {}  # host -> captured stacks
        self.attempt = 0                    # restarts so far
        self.returncode: Optional[int] = None
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- events -------------------------------------------------------- #
    def _event(self, event: str, **fields) -> dict:
        rec = {"event": event, "t": time.time(), **fields}
        self.events.append(rec)
        logger.info(f"supervisor: {event} "
                    f"{ {k: v for k, v in fields.items()} }")
        return rec

    # -- lifecycle ----------------------------------------------------- #
    def start(self) -> None:
        """Launch the worker group and the monitor thread."""
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        world = self._sized_world(self.hosts)
        if world is None or len(world) < self.min_hosts:
            raise ValueError(
                f"no elastic-compatible world within {self.hosts} "
                f"(min_hosts={self.min_hosts})")
        self.hosts = world
        self._launch(self.hosts, attempt=0)
        self._thread = threading.Thread(target=self._supervise,
                                        name="ds-supervisor", daemon=True)
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        """Join the monitor thread; returns the final returncode (0 =
        every worker exited cleanly), or None on timeout."""
        if self._thread is None:
            raise RuntimeError("supervisor not started")
        self._thread.join(timeout)
        return None if self._thread.is_alive() else self.returncode

    def run(self, timeout: Optional[float] = None) -> Optional[int]:
        self.start()
        return self.wait(timeout)

    def stop(self) -> None:
        """Graceful external shutdown: tear down workers, end supervision
        (returncode stays whatever the job had reached, else 0)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self._stop_all()
        if self.returncode is None:
            self.returncode = 0
        self._cleanup_run_dir()

    def _cleanup_run_dir(self) -> None:
        """Remove an auto-created run_dir after a CLEAN end only — on
        failure the heartbeat files and stack dumps are the post-mortem
        and must survive the supervisor."""
        if self._owns_run_dir and self.returncode == 0:
            import shutil

            shutil.rmtree(self.run_dir, ignore_errors=True)

    # -- launch / teardown --------------------------------------------- #
    def _worker_files(self, slot: int, host: str) -> Tuple[str, str]:
        # slot index keeps files unique even when spec_fn returns several
        # workers on one host (or labels collide after sanitization) — two
        # workers sharing a heartbeat file would mask each other's hangs
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in host)
        return (os.path.join(self.run_dir, f"hb_{slot}_{safe}"),
                os.path.join(self.run_dir, f"stack_{slot}_{safe}.txt"))

    def _launch(self, hosts: List[str], attempt: int) -> None:
        self.handles = []
        specs = self.spec_fn(list(hosts), attempt)
        for slot, spec in enumerate(specs):
            hb_file, dump_file = self._worker_files(slot, spec.host)
            # a dump left by a previous incarnation must not read as fresh
            try:
                os.remove(dump_file)
            except OSError:
                pass
            env = dict(os.environ)
            env.update(spec.env)
            env[hb.ENV_FILE] = hb_file
            env[hb.ENV_INTERVAL] = str(self.heartbeat_interval_s)
            env[hb.ENV_DUMP] = dump_file
            proc = subprocess.Popen(spec.cmd, env=env, cwd=spec.cwd,
                                    start_new_session=True)
            self.handles.append(WorkerHandle(spec, proc, hb_file, dump_file))
        self._event("launch", attempt=attempt, hosts=list(hosts),
                    pids=[h.pid for h in self.handles])

    def _stop_all(self) -> None:
        """SIGTERM every worker group, escalate to SIGKILL after
        ``term_grace_s``."""
        live = [h for h in self.handles if h.proc.poll() is None]
        for h in live:
            h.signal_group(signal.SIGTERM)
        deadline = time.monotonic() + self.term_grace_s
        while live and time.monotonic() < deadline:
            live = [h for h in live if h.proc.poll() is None]
            if live:
                time.sleep(min(0.05, self.term_grace_s / 10 or 0.05))
        for h in live:
            self._event("escalate_kill", host=h.host, pid=h.pid)
            self.metrics.record_escalation(h.host)
            h.signal_group(signal.SIGKILL)
        for h in self.handles:
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                logger.error(f"supervisor: worker {h.pid} survived SIGKILL")

    def _capture_dump(self, handle: WorkerHandle) -> Optional[str]:
        """SIGUSR1 the hung worker (faulthandler writes all-thread stacks
        to its dump file) and collect the result before killing it."""
        handle.signal_group(signal.SIGUSR1)
        deadline = time.monotonic() + self.dump_grace_s
        text = ""
        while time.monotonic() < deadline:
            try:
                with open(handle.dump_file) as f:
                    text = f.read()
            except OSError:
                text = ""
            if text.strip():
                # one more grace tick lets a mid-write dump finish
                time.sleep(min(0.05, self.dump_grace_s / 4))
                try:
                    with open(handle.dump_file) as f:
                        text = f.read()
                except OSError:
                    pass
                break
            time.sleep(min(0.05, self.dump_grace_s / 4))
        if text.strip():
            self.dumps.setdefault(handle.host, []).append(text)
            self._event("dump_captured", host=handle.host, chars=len(text))
            return text
        self._event("dump_missing", host=handle.host)
        return None

    # -- elastic sizing ------------------------------------------------- #
    def _sized_world(self, hosts: List[str]) -> Optional[List[str]]:
        """Trim ``hosts`` to the largest elastic-compatible world: probe
        world sizes downward and keep the first one
        :func:`compute_elastic_config` accepts.  Works for both v0.1
        (raises IncompatibleWorldSize for sizes outside the valid set)
        and v0.2 (validates node granularity against the given
        world_size) without re-deriving either version's device algebra
        here.  With no elastic config any non-empty host set is fine."""
        if not hosts:
            return None
        if self.elastic_config is None:
            return list(hosts)
        from deepspeed_tpu_torch.elasticity import (
            ElasticityError, ElasticityIncompatibleWorldSize,
            compute_elastic_config)
        from deepspeed_tpu_torch.version import __version__

        for n in range(len(hosts), 0, -1):
            try:
                compute_elastic_config(
                    self.elastic_config, __version__,
                    world_size=n * self.slots_per_host)
            except ElasticityIncompatibleWorldSize:
                continue
            except ElasticityError as e:
                logger.error(f"supervisor: elastic config rejected: {e}")
                return None
            return list(hosts)[:n]
        return None

    # -- the monitor loop ----------------------------------------------- #
    def _watch(self) -> Optional[Tuple[str, WorkerHandle,
                                       Optional[int], Optional[float]]]:
        """Block until a fault, clean completion (None), or stop().
        Returns (reason, culprit, exit_code, heartbeat_age).  ``reason``
        is ``"crash"`` (nonzero exit), ``"hang"`` (beats went stale), or
        ``"startup"`` — the worker died or stalled before its FIRST
        beat: bad binary/config territory, which circuit breakers and
        operators must tell apart from steady-state bad luck."""
        while not self._stop.is_set():
            now = time.monotonic()
            any_alive = False
            for h in self.handles:
                rc = h.proc.poll()
                if rc is not None:
                    if rc != 0:
                        _, beating = h.beat_age(now)
                        return ("crash" if beating else "startup",
                                h, rc, None)
                    continue
                any_alive = True
                age, beating = h.beat_age(now)
                limit = (self.hang_timeout_s if beating
                         else self.startup_timeout_s)
                if age > limit:
                    return ("hang" if beating else "startup",
                            h, None, age)
            if not any_alive:
                return None
            self._stop.wait(self.poll_s)
        return None

    def _supervise(self) -> None:
        try:
            self._supervise_inner()
        except Exception as e:  # pragma: no cover — monitor must not die
            logger.exception("supervisor: monitor thread crashed")
            self.error = f"monitor thread crashed: {e}"
            self.returncode = 1
            self._stop_all()

    def _supervise_inner(self) -> None:
        while True:
            fault = self._watch()
            if fault is None:
                if not self._stop.is_set():
                    self._event("clean_exit", attempt=self.attempt)
                    self.returncode = 0
                    self._cleanup_run_dir()
                self.metrics.export()
                return
            reason, culprit, rc, age = fault
            if rc is None:
                # still alive but silent: steady-state hang, or a worker
                # that never got through startup — dump its stacks first
                self._event("hang_detected", host=culprit.host,
                            pid=culprit.pid, age_s=round(age, 4),
                            reason=reason)
                self.metrics.record_hang(culprit.host, age)
                self._capture_dump(culprit)
            else:
                self._event("crash_detected", host=culprit.host,
                            pid=culprit.pid, rc=rc, reason=reason)
            # sibling health must be read BEFORE teardown: after
            # _stop_all every survivor reports a signal exit
            sib_healthy = {h: h.proc.poll() in (None, 0)
                           for h in self.handles if h is not culprit}
            self._stop_all()
            fail_rc = rc if (rc is not None and rc != 0) else 1

            # account per HOST, not per handle: a healthy sibling on the
            # culprit's own host (slots_per_host > 1) must not erase the
            # failure recorded for that host this wave
            failed_hosts = {culprit.host} | {
                h.host for h, healthy in sib_healthy.items() if not healthy}
            for host in failed_hosts:
                if self.blacklist.record_failure(host):
                    self._event("blacklist", host=host)
                    self.metrics.record_blacklist(host)
            for h, healthy in sib_healthy.items():
                if healthy and h.host not in failed_hosts:
                    # torn down BY us: not evidence against the host
                    self.blacklist.record_success(h.host)

            now = time.monotonic()
            if self.budget.exhausted(now):
                self.error = (
                    f"restart budget exhausted: {self.budget.in_window(now)}"
                    f"/{self.budget.max_restarts} restarts within "
                    f"{self.budget.window_s}s (last failure: {reason} on "
                    f"{culprit.host})")
                self._event("give_up", reason=reason, rc=fail_rc,
                            restarts=self.attempt)
                self.returncode = fail_rc
                self.metrics.export()
                return

            world_before = len(self.hosts)
            survivors = [h for h in self.hosts
                         if not self.blacklist.is_blacklisted(h)]
            new_hosts = self._sized_world(survivors)
            if new_hosts is None or len(new_hosts) < self.min_hosts:
                self.error = (
                    f"cannot resize: {len(survivors)} healthy host(s) of "
                    f"{world_before} (blacklisted: "
                    f"{sorted(self.blacklist.hosts)}), min_hosts="
                    f"{self.min_hosts}, no compatible elastic world")
                self._event("give_up", reason="no_world", rc=fail_rc,
                            restarts=self.attempt)
                self.returncode = fail_rc
                self.metrics.export()
                return

            self.budget.record(now)
            delay = self.backoff.delay(self.budget.in_window(now) - 1)
            self.attempt += 1
            self._event("restart", reason=reason, attempt=self.attempt,
                        backoff_s=round(delay, 4),
                        world_before=world_before,
                        world_after=len(new_hosts), host=culprit.host)
            self.metrics.record_restart(reason=reason, attempt=self.attempt,
                                        backoff_s=delay,
                                        world_before=world_before,
                                        world_after=len(new_hosts))
            self.metrics.export()
            if self._stop.wait(delay):
                return
            self.hosts = new_hosts
            self._launch(self.hosts, attempt=self.attempt)
