"""Supervisor smoke of the port (counterpart of ``tools/supervisor_smoke.py``):
prove the detect -> kill -> restart -> resume loop end to end with worker
processes training the port's engine.

    python3 deepspeed_tpu_torch/tools/supervisor_smoke.py [--device cpu|cuda]

The worker (``--worker DIR STEPS``) trains :mod:`chaos_smoke`'s Llama
(the bench Llama at 2 layers on the card, a tiny one on the CPU) through
:class:`ResilientTrainLoop` to ``STEPS``, resuming from ``DIR``, and
writes its final masters and Adam moments, its losses and its timings
there.  Its output goes to ``DIR/worker.log``, whose last line is
``LAUNCHES {...}``, the flash kernels' launch counts after the resume.
Under a launcher it drives ``cuda:{LOCAL_RANK}``.

**crash** — a :class:`JobSupervisor` runs one worker on host ``h0``; once
``latest`` names ``global_step4`` the parent SIGKILLs it.  The supervisor
sees the nonzero exit, backs off and relaunches; the worker
``auto_resume()``s and its final state and post-resume losses equal a
straight run's bit for bit.

**hang** — the worker runs with ``DS_CHAOS=heartbeat_stall`` armed at its
first save: its heartbeat goes silent while it keeps training (slowed
from there on by a per-step sleep so that it outlives the detector).  The supervisor must
flag the hang within 2x the heartbeat interval, capture a faulthandler
stack dump naming the loop before the kill, then restart, and the
restarted worker resumes to the same bits.

The last line printed is a JSON summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import signal
import sys
import tempfile
import time
from pathlib import Path

#: when this module was loaded: a worker's interpreter start
_T_MODULE = time.time()
_TOOLS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "chaos_smoke", str(_TOOLS / "chaos_smoke.py"))
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

TOTAL_STEPS = CS.TOTAL_STEPS
SAVE_INTERVAL = CS.SAVE_INTERVAL
#: the worker's per-step sleep from its first save on, read from its
#: environment (a supervisor sets it for the first incarnation only)
ENV_STEP_SLEEP = "DS_SMOKE_STEP_SLEEP_S"


@dataclasses.dataclass
class Timing:
    """The supervisor's clocks and the worker's slow-down for one device."""

    heartbeat_interval_s: float
    hang_timeout_s: float
    poll_s: float
    crash_step_sleep_s: float     # first incarnation of the crash variant
    hang_step_sleep_s: float      # first incarnation of the hang variant


#: CPU: a tiny model saves in milliseconds and a worker starts in seconds
CPU_TIMING = Timing(heartbeat_interval_s=1.0, hang_timeout_s=1.8,
                    poll_s=0.1, crash_step_sleep_s=0.1,
                    hang_step_sleep_s=0.4)
#: the card: a save of the 2-layer bench Llama (~1 GB) is the longest
#: healthy silence (4.09-5.20 s on an H100 with three workers side by
#: side); the hang timeout sits 2.1x above it, and the stalled worker's
#: steps are slowed until it outlives the detector
CARD_TIMING = Timing(heartbeat_interval_s=6.0, hang_timeout_s=11.0,
                     poll_s=0.25, crash_step_sleep_s=0.0,
                     hang_step_sleep_s=1.5)


# --------------------------------------------------------------------- #
# Worker program
# --------------------------------------------------------------------- #
def run_worker(workdir: str, total_steps: int, device: str,
               die_after_tag: str | None = None,
               marker: str | None = None) -> int:
    """Train to ``total_steps`` under the loop, resuming from ``workdir``.
    With ``die_after_tag``, SIGKILL this process at the first step after
    ``latest`` names that tag, once (``marker`` records that it did)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.resilience import ResilientTrainLoop, manifest

    t_start = time.time()           # the imports above done
    os.makedirs(workdir, exist_ok=True)
    log_fd = os.open(os.path.join(workdir, "worker.log"),
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    dev = CS.resolve_device(device)
    ranks = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK",
                                            "WORLD_SIZE")}
    card = dev.type == "cuda"
    incarnation = {"pid": os.getpid(), "t_module": _T_MODULE,
                   "t_start": t_start, "ranks": ranks, "device": str(dev)}
    if card:
        free, total = torch.cuda.mem_get_info(dev)
        # the parent built every library: a worker only loads
        incarnation.update(mem_free=free, mem_total=total,
                           libs_prebuilt=all(_build.library_path(s).exists()
                                             for s in _build.SOURCES))
    incarnation["t_device"] = time.time()
    engine = CS.make_engine(dev)
    incarnation["t_engine"] = time.time()
    sleep_s = float(os.environ.get(ENV_STEP_SLEEP, "0"))
    log = CS.LossLog()

    def batch(step):
        if sleep_s and step >= SAVE_INTERVAL:
            time.sleep(sleep_s)     # outlive a detector or a parent's kill
        return CS.batch_fn(step, dev)

    def step_fn(eng, b):
        if die_after_tag and not os.path.exists(marker) and \
                manifest.read_latest(workdir) == die_after_tag:
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return log(eng, b)

    loop = ResilientTrainLoop(engine, batch, workdir,
                              save_interval=SAVE_INTERVAL, keep_last=2,
                              step_fn=step_fn)
    log.loop = loop
    incarnation["t_loop"] = time.time()         # its first beat
    with open(os.path.join(workdir, "incarnations.jsonl"), "a") as f:
        f.write(json.dumps(incarnation) + "\n")
    t0 = time.time()
    start_step = loop.auto_resume()
    load_s = time.time() - t0
    for k in fa.LAUNCHES:
        fa.LAUNCHES[k] = 0
    loop.run(total_steps, auto_resume=False)
    if card:
        torch.cuda.synchronize(dev)
    np.savez(os.path.join(workdir, "final_state.npz"),
             **CS.engine_state(engine))
    launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump({"start_step": start_step, "pid": os.getpid(),
                   "ranks": ranks, "t_start": t_start,
                   "startup_s": t0 - t_start, "load_s": load_s,
                   "resumed_wall": t0 + load_s,
                   "first_step_wall": log.walls[0] if log.walls else None,
                   "losses": log.losses, "launches": launches,
                   "metrics": loop.metrics.snapshot()}, f)
    print(f"LAUNCHES {json.dumps(launches)}", flush=True)
    return 0


def read_result(workdir: str):
    """(result.json, final state) of a finished worker."""
    import numpy as np

    with open(os.path.join(workdir, "result.json")) as f:
        result = json.load(f)
    result["losses"] = [tuple(x) for x in result["losses"]]
    with np.load(os.path.join(workdir, "final_state.npz")) as z:
        state = {k: z[k] for k in z.files}
    return result, state


def read_incarnations(workdir: str) -> list:
    with open(os.path.join(workdir, "incarnations.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def last_log_line(workdir: str) -> str:
    with open(os.path.join(workdir, "worker.log")) as f:
        lines = [line.strip() for line in f if line.strip()]
    return lines[-1] if lines else ""


def worker_cmd(workdir: str, device: str) -> list:
    return [sys.executable, "-u", os.path.abspath(__file__), "--worker",
            workdir, str(TOTAL_STEPS), "--device", device]


def check_resumed(result, state, reference, label: str) -> None:
    """A worker that auto-resumed finished with the straight run's bits."""
    ref_state, ref_losses = reference
    start = result["start_step"]
    assert start > 0 and start % SAVE_INTERVAL == 0, \
        f"{label}: started at step {start} instead of resuming"
    bad = CS.state_mismatches(ref_state, state)
    assert not bad, f"{label}: {bad[:8]} differ from the straight run"
    assert result["losses"] == ref_losses[start:], \
        f"{label}: post-resume losses diverged"


# --------------------------------------------------------------------- #
# Variants
# --------------------------------------------------------------------- #
def make_supervisor(base: str, variant: str, device: str, timing: Timing,
                    first_env: dict):
    """A supervisor over one worker on host ``h0``; ``first_env`` goes to
    the first incarnation only."""
    from deepspeed_tpu_torch.resilience import (BackoffPolicy, JobSupervisor,
                                                WorkerSpec)

    def spec_fn(current_hosts, attempt):
        specs = []
        for host in current_hosts:
            workdir = os.path.join(base, variant, host)
            env = dict(first_env) if attempt == 0 else {}
            specs.append(WorkerSpec(host=host, cmd=worker_cmd(workdir, device),
                                    env=env))
        return specs

    return JobSupervisor(
        spec_fn, ["h0"],
        run_dir=os.path.join(base, variant, "supervisor"),
        heartbeat_interval_s=timing.heartbeat_interval_s,
        hang_timeout_s=timing.hang_timeout_s, poll_s=timing.poll_s, term_grace_s=5.0, dump_grace_s=2.0,
        backoff=BackoffPolicy(base_s=0.1, jitter=0.0),
        max_restarts=3, blacklist_after=3)


def watch_beats(path: str, stop, times: list, period_s: float = 0.01):
    """Append the wall time of each change of the heartbeat file's mtime
    to ``times`` until ``stop`` is set."""
    last = None
    while not stop.is_set():
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            mtime = None
        if mtime is not None and mtime != last:
            times.append(time.time())
            last = mtime
        stop.wait(period_s)


def beat_gaps(times: list, breaks) -> tuple:
    """(gaps between consecutive beats of one incarnation, the first beat
    after each break): ``breaks`` are the wall times at which one
    incarnation ended (a kill) and the next began."""
    gaps, firsts = [], []
    bounds = sorted(breaks)
    for a, b in zip(times, times[1:]):
        if any(a <= t < b for t in bounds):
            firsts.append(b)
        else:
            gaps.append(b - a)
    return gaps, firsts


def run_crash_variant(base: str, device: str, timing: Timing,
                      reference) -> dict:
    """SIGKILL the worker once ``latest`` names ``global_step4``; exactly
    one restart; the worker resumes to the straight run's bits."""
    import threading

    from deepspeed_tpu_torch.resilience import manifest

    workdir = os.path.join(base, "crash", "h0")
    sup = make_supervisor(base, "crash", device, timing,
                          {ENV_STEP_SLEEP: str(timing.crash_step_sleep_s)})
    t_launch = time.time()
    sup.start()
    victim = sup.handles[0]
    beats = []
    stop = threading.Event()
    watcher = threading.Thread(target=watch_beats, args=(
        victim.heartbeat_file, stop, beats), daemon=True)
    watcher.start()
    want = f"global_step{SAVE_INTERVAL}"
    deadline = time.monotonic() + 600
    try:
        while manifest.read_latest(workdir) != want:
            assert time.monotonic() < deadline and \
                victim.proc.poll() is None, \
                f"worker never committed {want} (rc {victim.proc.poll()})"
            time.sleep(0.01)
        assert victim.proc.poll() is None, \
            "victim finished before the kill — slow its steps down"
        os.kill(victim.pid, signal.SIGKILL)
        t_kill = time.time()
        rc = sup.wait(timeout=900)
    finally:
        stop.set()
        sup.stop()              # ends a supervisor still running
    watcher.join(timeout=5)
    assert rc == 0, (rc, sup.error, sup.events)
    assert sup.metrics.restarts == 1 and sup.metrics.restart_crash == 1, \
        sup.metrics.snapshot()
    restart = [e for e in sup.events if e["event"] == "restart"][0]
    assert restart["reason"] == "crash", restart
    assert (restart["world_before"], restart["world_after"]) == (1, 1), \
        restart
    result, state = read_result(workdir)
    check_resumed(result, state, reference, "crash")
    detect = [e for e in sup.events if e["event"] == "crash_detected"][0]
    relaunch = [e["t"] for e in sup.events if e["event"] == "launch"][1]
    gaps, firsts = beat_gaps(beats, [t_kill])
    return {
        "restarts": sup.metrics.restarts,
        "resume_step": result["start_step"],
        "crash_detect_latency_s": detect["t"] - t_kill,
        "kill_to_first_resumed_step_s": result["first_step_wall"] - t_kill,
        "first_beat_s": [beats[0] - t_launch if beats else None]
        + [t - relaunch for t in firsts],
        "longest_beat_gap_s": max(gaps, default=float("nan")),
        "beats": len(beats),
        "pids": [e["pids"] for e in sup.events if e["event"] == "launch"],
        "load_s": result["load_s"], "launches": result["launches"],
        "mean_save_s": result["metrics"]["mean_save_latency_s"],
        "workdir": workdir, "supervisor": sup,
    }


def run_hang_variant(base: str, device: str, timing: Timing,
                     reference) -> dict:
    """``heartbeat_stall`` from the worker's first save on: detect within
    2x the beat interval, dump the worker's stacks, restart, resume to the
    straight run's bits."""
    # hits of the stall point: the Heartbeat's first beat, then the loop's
    # beats of steps 0-3; the 6th hit is the first save's first tick, and
    # every beat from there on is dropped
    stall = f"heartbeat_stall:after={1 + SAVE_INTERVAL},count=0"
    sup = make_supervisor(base, "hang", device, timing,
                          {"DS_CHAOS": stall,
                           ENV_STEP_SLEEP: str(timing.hang_step_sleep_s)})
    try:
        rc = sup.run(timeout=900)
    finally:
        sup.stop()              # ends a supervisor still running
    assert rc == 0, (rc, sup.error, sup.events)
    assert sup.metrics.restarts == 1 and sup.metrics.restart_hang == 1, \
        sup.metrics.snapshot()
    hang = [e for e in sup.events if e["event"] == "hang_detected"][0]
    assert hang["host"] == "h0", hang
    assert hang["age_s"] <= 2 * timing.heartbeat_interval_s, hang
    dumps = sup.dumps.get("h0", [])
    assert dumps and "loop.py" in dumps[0], \
        f"no stack dump naming the loop before the kill: {sup.events}"
    workdir = os.path.join(base, "hang", "h0")
    result, state = read_result(workdir)
    check_resumed(result, state, reference, "hang")
    return {
        "restarts": sup.metrics.restarts,
        "resume_step": result["start_step"],
        "hang_detect_age_s": hang["age_s"],
        "dump_chars": len(dumps[0]),
        "hang_to_first_resumed_step_s": result["first_step_wall"]
        - hang["t"],
        "pids": [e["pids"] for e in sup.events if e["event"] == "launch"],
        "launches": result["launches"], "workdir": workdir,
        "supervisor": sup,
    }


def run_smoke(tmpdir: str | None = None, device: str = "cpu",
              timing: Timing = CPU_TIMING, reference=None) -> dict:
    dev = CS.resolve_device(device)
    if tmpdir is None:
        tmpdir = tempfile.mkdtemp(prefix="supervisor_smoke_")
    reference = reference or CS.straight_run(dev)
    snap = {}
    for name, variant in (("crash", run_crash_variant),
                          ("hang", run_hang_variant)):
        out = variant(tmpdir, device, timing, reference)
        out.pop("supervisor")
        snap[name] = out
    return snap


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--worker", nargs=2, metavar=("DIR", "STEPS"),
                        help="run one worker")
    parser.add_argument("--die_after_tag", default=None)
    parser.add_argument("--marker", default=None)
    args = parser.parse_args()
    if args.worker:
        return run_worker(args.worker[0], int(args.worker[1]), args.device,
                          args.die_after_tag, args.marker)
    t0 = time.monotonic()
    snap = run_smoke(device=args.device, timing=CARD_TIMING
                     if args.device == "cuda" else CPU_TIMING)
    snap["wall_s"] = time.monotonic() - t0
    print(json.dumps({"supervisor_smoke": "ok", **snap}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(_TOOLS.parents[1]))
    sys.exit(main())
