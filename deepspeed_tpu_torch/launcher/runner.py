"""``deepspeed_torch`` CLI runner (counterpart of
``deepspeed_tpu/launcher/runner.py``; reference: launcher/runner.py:388
``main`` — hostfile parsing :200, include/exclude filters :255-351,
world-info encoding :353).

Process model: one process **per GPU** (a hostfile slot), as the reference
launches, with ``torch.distributed``'s ``env://`` rendezvous at
``MASTER_ADDR`` / ``MASTER_PORT``.  The runner resolves the host pool, then

* single host → exec :mod:`deepspeed_tpu_torch.launcher.launch` locally;
* multi host  → one ssh/pdsh command per host running ``launch`` with the
  master's address and ``--node_rank`` — launch then derives WORLD_SIZE /
  RANK / LOCAL_RANK / NNODES / NODE_RANK for its children.

The port's engine trains at world size 1 (multi-device training is
ROADMAP A6): on one card, one process (``--num_gpus 1``).

Command construction is separated from execution so the multinode path is
testable without ssh.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

from deepspeed_tpu_torch.launcher.constants import (DLTS_HOSTFILE,  # noqa: F401
                                              EXPORT_ENVS)
# imported at module scope: _signal_group runs inside SIGINT/SIGTERM
# handlers, where a first-time package import could itself fail and
# abort the teardown mid-flight
from deepspeed_tpu_torch.resilience.supervisor import signal_process_group


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch launcher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="hostfile: lines of '<host> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="subset hosts/slots: 'h1@h2:0,2' syntax")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="exclude hosts/slots, same syntax as --include")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="cap on number of hosts to use")
    parser.add_argument("--num_gpus", "--num_accelerators", dest="num_gpus",
                        type=int, default=-1,
                        help="processes per host, one a GPU (reference "
                        "--num_gpus)")
    parser.add_argument("--master_port", type=int,
                        default=int(os.environ.get("DS_MASTER_PORT", 29500)))
    parser.add_argument("--master_addr", type=str,
                        default=os.environ.get("DS_MASTER_ADDR", ""))
    parser.add_argument("--launcher", type=str, default="ssh",
                        choices=("ssh", "pdsh", "local", "openmpi", "mpich",
                                 "impi", "mvapich", "slurm"))
    parser.add_argument("--launcher_args", type=str, default="")
    parser.add_argument("--module", action="store_true",
                        help="run user_script as 'python -m <module>'")
    parser.add_argument("--no_python", action="store_true",
                        help="exec user_script directly, no interpreter")
    parser.add_argument("--no_ssh_check", action="store_true")
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("--elastic_training", action="store_true")
    parser.add_argument("--min_elastic_nodes", type=int, default=-1)
    parser.add_argument("--max_elastic_nodes", type=int, default=-1)
    parser.add_argument("--max_restarts", type=int, default=3,
                        help="elastic: relaunch budget after failed worker "
                        "groups, counted over a sliding --restart_window_s "
                        "window (reference DSElasticAgent restarts)")
    parser.add_argument("--restart_backoff_s", type=float, default=1.0,
                        help="elastic: base of the exponential backoff "
                        "between relaunches (grows with the number of "
                        "restarts inside the window, plus jitter)")
    parser.add_argument("--restart_window_s", type=float, default=300.0,
                        help="elastic: sliding window for --max_restarts; "
                        "a long-healthy job earns its budget back")
    parser.add_argument("--save_pid", action="store_true")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args)


# ------------------------------------------------------------------ #
# Host pool resolution
# ------------------------------------------------------------------ #
def fetch_hostfile(path: str) -> Optional[Dict[str, int]]:
    """'<host> slots=<n>' per line → ordered {host: slots}. Comments (#)
    and blank lines ignored; malformed lines raise."""
    if not os.path.isfile(path):
        logger.warning(f"hostfile {path} not found")
        return None
    pool: "OrderedDict[str, int]" = OrderedDict()
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 1:
                host, slots = parts[0], 1
            elif len(parts) == 2 and parts[1].startswith("slots="):
                host, slots = parts[0], int(parts[1][len("slots="):])
            else:
                raise ValueError(f"malformed hostfile line: {line!r}")
            if host in pool:
                raise ValueError(f"duplicate host {host} in hostfile")
            pool[host] = slots
    return pool


def _parse_filter(spec: str) -> Dict[str, Optional[List[int]]]:
    """'h1@h2:0,2' → {h1: None (all slots), h2: [0, 2]}."""
    out: Dict[str, Optional[List[int]]] = OrderedDict()
    if not spec:
        return out
    for part in spec.split("@"):
        if ":" in part:
            host, slots = part.split(":", 1)
            out[host] = sorted({int(s) for s in slots.split(",")})
        else:
            out[part] = None
    return out


def parse_inclusion_exclusion(resource_pool: Dict[str, int],
                              inclusion: str, exclusion: str,
                              ) -> Dict[str, List[int]]:
    """Apply --include/--exclude to the hostfile pool (reference
    parse_resource_filter:255). Returns {host: [slot ids]}."""
    pool: "OrderedDict[str, List[int]]" = OrderedDict(
        (h, list(range(n))) for h, n in resource_pool.items())
    inc, exc = _parse_filter(inclusion), _parse_filter(exclusion)
    if inc and exc:
        raise ValueError("--include and --exclude are mutually exclusive")
    for host in list(inc) + list(exc):
        if host not in pool:
            raise ValueError(f"filtered host {host} not in hostfile")
    if inc:
        picked = OrderedDict()
        for host, slots in inc.items():
            avail = pool[host]
            use = avail if slots is None else slots
            bad = set(use) - set(avail)
            if bad:
                raise ValueError(f"host {host} has no slots {sorted(bad)}")
            picked[host] = sorted(use)
        return picked
    for host, slots in exc.items():
        if slots is None:
            del pool[host]
        else:
            pool[host] = [s for s in pool[host] if s not in slots]
            if not pool[host]:
                del pool[host]
    return pool


def encode_world_info(world_info: Dict[str, List[int]]) -> str:
    return base64.urlsafe_b64encode(
        json.dumps(world_info).encode()).decode()


def decode_world_info(encoded: str) -> Dict[str, List[int]]:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


# ------------------------------------------------------------------ #
# Command construction
# ------------------------------------------------------------------ #
def build_launch_cmd(args, world_info: Dict[str, List[int]],
                     node_rank: int, master_addr: str) -> List[str]:
    """The per-host ``launch`` invocation."""
    return [
        sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
        f"--world_info={encode_world_info(world_info)}",
        f"--node_rank={node_rank}",
        f"--master_addr={master_addr}",
        f"--master_port={args.master_port}",
    ] + (["--save_pid"] if args.save_pid else []) + \
        (["--no_python"] if args.no_python else []) + \
        (["--module"] if args.module else []) + \
        ["--", args.user_script] + args.user_args


def build_multinode_cmds(args, world_info: Dict[str, List[int]],
                         master_addr: str) -> List[List[str]]:
    """One remote command per host (ssh), a single pdsh fan-out, or a
    single scheduler command (openmpi/mpich/impi/mvapich/slurm — reference
    launcher/multinode_runner.py:117-374; rank comes from the scheduler's
    environment)."""
    from deepspeed_tpu_torch.launcher.multinode_runner import RUNNERS

    if args.launcher in RUNNERS:
        runner = RUNNERS[args.launcher](args, world_info, master_addr,
                                        args.master_port)
        if not runner.backend_exists():
            raise RuntimeError(
                f"--launcher={args.launcher}: required binary not found "
                f"on PATH")
        return [runner.get_cmd()]
    env_exports = " ".join(
        f"{k}={shlex.quote(os.environ[k])}" for k in EXPORT_ENVS
        if k in os.environ)
    cmds = []
    hosts = list(world_info)
    if args.launcher == "pdsh":
        launch = build_launch_cmd(args, world_info, -1, master_addr)
        # pdsh exports %n as the host index for the node rank
        remote = f"cd {shlex.quote(os.getcwd())} && {env_exports} " + \
            " ".join(shlex.quote(c) for c in launch)
        remote = remote.replace("--node_rank=-1", "--node_rank=%n")
        return [["pdsh", "-S", "-f", "1024", "-w", ",".join(hosts)] +
                shlex.split(args.launcher_args) + [remote]]
    for rank, host in enumerate(hosts):
        launch = build_launch_cmd(args, world_info, rank, master_addr)
        remote = f"cd {shlex.quote(os.getcwd())} && {env_exports} " + \
            " ".join(shlex.quote(c) for c in launch)
        # -tt: force a tty so that killing the LOCAL ssh client (wait_all
        # sibling teardown, Ctrl-C) hangs up the remote session — sshd
        # then SIGHUPs the remote launch, which tears down its workers.
        # Without a tty the remote tree survives client death until it
        # happens to write to the dead socket, and a new elastic wave
        # could overlap the old one.
        cmds.append(["ssh", "-tt"] + shlex.split(args.launcher_args) +
                    [host, remote])
    return cmds


# ------------------------------------------------------------------ #
# Process-group supervision of the node launchers
# ------------------------------------------------------------------ #
_signal_group = signal_process_group


def wait_all(procs: Optional[List[subprocess.Popen]] = None,
             poll_s: float = 0.1,
             term_grace_s: float = 10.0,
             signal_state: Optional[dict] = None,
             spawn: Optional[List[List[str]]] = None) -> int:
    """Wait on every node launcher *concurrently*.

    The first NONZERO exit terminates the surviving siblings (SIGTERM to
    each process group, SIGKILL after ``term_grace_s``) — a serial
    ``wait()`` would let one hung sibling block the next elastic wave
    forever.  SIGINT/SIGTERM delivered to the runner are forwarded to all
    child process groups, so Ctrl-C never orphans workers; the runner then
    exits ``128 + signum``.  Returns the first failure's exit code (0 when
    every launcher exited cleanly).

    ``signal_state``: optional dict; when the RUNNER itself receives a
    signal, ``signal_state["signum"]`` is set.  This is the only reliable
    operator-stop channel — a remote worker group killed by SIGTERM also
    produces exit code 143 through ssh, and that one SHOULD be restarted
    by the elastic loop.

    ``spawn``: commands to launch (``start_new_session=True``) AFTER the
    signal forwarders are installed — the children live in their own
    sessions, so a Ctrl-C landing mid-spawn would otherwise orphan the
    ones already started (the terminal can no longer reach them)."""
    procs = list(procs) if procs is not None else []
    state = {"rc": 0, "sig_rc": 0, "kill_deadline": None}

    def _teardown(sig: int) -> None:
        for p in procs:
            if p.poll() is None:
                _signal_group(p, sig)
        if state["kill_deadline"] is None:
            state["kill_deadline"] = time.monotonic() + term_grace_s

    def _forward(signum, frame):
        state["sig_rc"] = 128 + signum
        if signal_state is not None:
            signal_state["signum"] = signum
        _teardown(signum)

    # Signal handlers only exist on the main thread; a library caller on a
    # worker thread still gets the concurrent-wait + sibling-teardown
    # semantics, just not signal forwarding.
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGINT, signal.SIGTERM):
            old_handlers[s] = signal.signal(s, _forward)
    try:
        for cmd in spawn or ():
            if state["sig_rc"]:
                break          # signalled mid-spawn: launch no more
            try:
                procs.append(subprocess.Popen(cmd, start_new_session=True))
            except OSError as e:
                # fork/exec failure (EAGAIN, ENOMEM, missing binary):
                # already-started launchers are in their own sessions and
                # would outlive a propagated exception — tear them down
                # and report a failure the elastic loop can retry
                logger.error(f"failed to spawn {' '.join(cmd)}: {e}; "
                             f"terminating {len(procs)} already-started "
                             f"launcher(s)")
                state["rc"] = 1
                _teardown(signal.SIGTERM)
                break
        pending = list(procs)
        while pending:
            for p in list(pending):
                r = p.poll()
                if r is None:
                    continue
                pending.remove(p)
                if r != 0 and state["rc"] == 0 and state["sig_rc"] == 0:
                    state["rc"] = r
                    logger.error(
                        f"node launcher {p.pid} exited rc={r}; "
                        f"terminating {len(pending)} surviving sibling(s)")
                    _teardown(signal.SIGTERM)
            if not pending:
                break
            if state["kill_deadline"] is not None and \
                    time.monotonic() > state["kill_deadline"]:
                for p in pending:
                    logger.error(f"node launcher {p.pid} ignored SIGTERM "
                                 f"for {term_grace_s}s; escalating SIGKILL")
                    _signal_group(p, signal.SIGKILL)
                state["kill_deadline"] = float("inf")
            time.sleep(poll_s)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    return state["sig_rc"] or state["rc"]


# ------------------------------------------------------------------ #
# main
# ------------------------------------------------------------------ #
def _resolve_world(args) -> Dict[str, List[int]]:
    """Hostfile -> filtered {host: slots}, re-read per call so an elastic
    restart picks up membership changes (dead hosts removed from the
    hostfile by the operator/scheduler)."""
    pool = fetch_hostfile(args.hostfile)
    if pool is None:  # local machine only
        n = args.num_gpus if args.num_gpus > 0 else 1
        world_info: Dict[str, List[int]] = OrderedDict(
            [("localhost", list(range(n)))])
    else:
        world_info = parse_inclusion_exclusion(pool, args.include,
                                               args.exclude)
        if args.num_nodes > 0:
            world_info = OrderedDict(
                list(world_info.items())[:args.num_nodes])
        if args.num_gpus > 0:
            # cap per-host slots, keeping the filtered slot IDs
            for h, slots in world_info.items():
                if len(slots) < args.num_gpus:
                    raise ValueError(
                        f"host {h} has only {len(slots)} usable slots, "
                        f"--num_gpus={args.num_gpus} requested")
            world_info = OrderedDict(
                (h, slots[:args.num_gpus])
                for h, slots in world_info.items())
    if not world_info:
        raise ValueError("no hosts left after filtering")
    if args.elastic_training:
        # The batch plan itself comes from the config's 'elasticity' block
        # at engine init; the launcher enforces the node bounds.
        n_nodes = len(world_info)
        lo = args.min_elastic_nodes if args.min_elastic_nodes > 0 else 1
        hi = args.max_elastic_nodes if args.max_elastic_nodes > 0 else n_nodes
        if not (lo <= n_nodes <= hi):
            raise ValueError(
                f"elastic training: {n_nodes} nodes outside "
                f"[{lo}, {hi}] (--min/max_elastic_nodes)")
        os.environ["DS_ELASTIC_NODE_RANGE"] = f"{lo},{hi}"
        logger.info(f"elastic training over {n_nodes} nodes "
                    f"(allowed range [{lo}, {hi}])")
    return world_info


def main(args=None, metrics=None) -> int:
    # DS_ELASTIC_NODE_RANGE is an env channel to the children (read by
    # ElasticityConfig); restore it on exit so an in-process caller (the
    # test suite, a notebook) is not left with a stale node range
    saved_range = os.environ.get("DS_ELASTIC_NODE_RANGE")
    try:
        return _main(parse_args(args), metrics)
    finally:
        if saved_range is None:
            os.environ.pop("DS_ELASTIC_NODE_RANGE", None)
        else:
            os.environ["DS_ELASTIC_NODE_RANGE"] = saved_range


def _main(args, metrics=None) -> int:
    last_world = {"procs": 0}

    def launch_once(world_info: Optional[Dict[str, List[int]]] = None,
                    signal_state: Optional[dict] = None) -> int:
        if world_info is None:
            world_info = _resolve_world(args)
        last_world["procs"] = sum(len(s) for s in world_info.values())
        master_addr = args.master_addr or next(iter(world_info))
        from deepspeed_tpu_torch.launcher.multinode_runner import RUNNERS

        scheduler = args.launcher in RUNNERS
        multi = (len(world_info) > 1 or args.force_multi or scheduler) and \
            args.launcher != "local"
        if not multi:
            cmds = [build_launch_cmd(args, world_info, 0, master_addr or
                                     "localhost")]
        else:
            cmds = build_multinode_cmds(args, world_info, master_addr)
        logger.info("launching: " +
                    " | ".join(" ".join(c) for c in cmds))
        # wait_all spawns them (own session per node launcher, so
        # teardown can killpg the whole remote-command tree) only after
        # its signal forwarders are live, and supervises all at once
        return wait_all(spawn=cmds, signal_state=signal_state)

    if not args.elastic_training:
        return launch_once()

    # Elastic restart loop (reference elasticity/elastic_agent.py:28
    # DSElasticAgent._invoke_run): a failed worker group is relaunched
    # under the supervisor's backoff + sliding-window budget policy;
    # workers resume from their checkpoints (elastic batch algebra keeps
    # convergence intact across restarts).  The launcher only observes
    # exit codes, so every restart here has reason "crash" — hang
    # detection lives in resilience.supervisor.JobSupervisor, which owns
    # worker heartbeats.
    from deepspeed_tpu_torch.resilience.metrics import ResilienceMetrics
    from deepspeed_tpu_torch.resilience.supervisor import (BackoffPolicy,
                                                     RestartBudget)

    metrics = metrics if metrics is not None else ResilienceMetrics()
    base_s = max(args.restart_backoff_s, 0.0)
    backoff = BackoffPolicy(base_s=base_s, max_s=max(60.0, base_s))
    budget = RestartBudget(max(args.max_restarts, 0),
                           args.restart_window_s)
    attempt = 0
    next_world: Optional[Dict[str, List[int]]] = None
    while True:
        sig_state: dict = {}
        rc = launch_once(next_world, signal_state=sig_state)
        next_world = None
        if rc == 0:
            return 0
        if sig_state.get("signum") is not None:
            # the RUNNER itself was signalled (wait_all's signal_state
            # channel — NOT a remote worker group that happened to exit
            # 143, which should be restarted): an operator stop is not a
            # crashed worker group, do not respawn against a Ctrl-C
            logger.warning(
                f"elastic training: stopped by operator signal "
                f"(rc={rc}); not restarting")
            return rc
        now = time.monotonic()
        if budget.exhausted(now):
            logger.error(
                f"elastic training: worker group failed rc={rc}; restart "
                f"budget exhausted ({budget.in_window(now)}/"
                f"{budget.max_restarts} within {budget.window_s}s); "
                f"giving up after {attempt} restart(s)")
            return rc
        world_before = last_world["procs"]
        budget.record(now)
        attempt += 1
        delay = backoff.delay(budget.in_window(now) - 1)
        logger.warning(
            f"elastic training: worker group failed rc={rc}; restart "
            f"{attempt} (budget {budget.in_window(now)}/"
            f"{budget.max_restarts} in window) in {delay:.2f}s")
        time.sleep(delay)
        # resolve the next wave's world ONCE, after the backoff (the
        # window in which an operator drains dead hosts from the
        # hostfile), and launch exactly what the metric reports
        try:
            next_world = _resolve_world(args)
        except ValueError as e:
            logger.error(f"elastic training: no viable world left after "
                         f"failure rc={rc}: {e}")
            return rc
        world_after = sum(len(s) for s in next_world.values())
        metrics.record_restart(reason="crash", attempt=attempt,
                               backoff_s=delay, world_before=world_before,
                               world_after=world_after)
        metrics.export()


if __name__ == "__main__":
    sys.exit(main())
