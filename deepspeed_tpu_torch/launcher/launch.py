"""Per-host process launcher (counterpart of
``deepspeed_tpu/launcher/launch.py``; reference: launcher/launch.py:132
``main`` — env wiring, per-rank spawn, signal handling / process-tree
teardown :118).

Spawns the user script once per local slot with the rendezvous env that
``torch.distributed``'s ``env://`` initialisation reads:

* ``MASTER_ADDR`` / ``MASTER_PORT`` — where rank 0 listens;
* ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` — global/local process ids
  (a worker drives ``cuda:{LOCAL_RANK}``);
* ``NNODES`` / ``NODE_RANK`` — the host count and this host's index.

One process a GPU, as the reference launches.  A child failure tears down
the whole local group (reference terminate_process_tree).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
from typing import List

from deepspeed_tpu_torch.launcher.runner import decode_world_info
from deepspeed_tpu_torch.utils.logging import logger


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="per-host launcher")
    parser.add_argument("--world_info", type=str, required=True)
    parser.add_argument("--node_rank", type=int, required=True)
    parser.add_argument("--master_addr", type=str, required=True)
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--module", action="store_true")
    parser.add_argument("--no_python", action="store_true")
    parser.add_argument("--save_pid", action="store_true")
    parser.add_argument("rest", nargs=argparse.REMAINDER)
    return parser.parse_args(args)


def _child_cmd(args) -> List[str]:
    rest = args.rest[1:] if args.rest and args.rest[0] == "--" else args.rest
    if args.no_python:
        return rest
    cmd = [sys.executable, "-u"]
    if args.module:
        cmd.append("-m")
    return cmd + rest


def main(args=None) -> int:
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    hosts = list(world_info)
    if not (0 <= args.node_rank < len(hosts)):
        raise ValueError(f"node_rank {args.node_rank} out of range for "
                         f"{len(hosts)} hosts")
    local_slots = world_info[hosts[args.node_rank]]
    global_rank_base = sum(len(world_info[h])
                           for h in hosts[:args.node_rank])
    world_size = sum(len(s) for s in world_info.values())

    procs: List[subprocess.Popen] = []

    def _terminate(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    p.terminate()
        if signum is not None:
            sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    # the runner launches remote copies over `ssh -tt`: when the local ssh
    # client dies, sshd hangs up the session — treat it like SIGTERM so a
    # dropped connection can never orphan the worker group
    signal.signal(signal.SIGHUP, _terminate)

    cmd = _child_cmd(args)
    for i, slot in enumerate(local_slots):
        env = dict(os.environ)
        env.update({
            "MASTER_ADDR": args.master_addr,
            "MASTER_PORT": str(args.master_port),
            "WORLD_SIZE": str(world_size),
            "RANK": str(global_rank_base + i),
            "LOCAL_RANK": str(slot),
            "NNODES": str(len(hosts)),
            "NODE_RANK": str(args.node_rank),
        })
        logger.info(f"launch rank {global_rank_base + i}/{world_size} "
                    f"(local {slot}): {' '.join(cmd)}")
        procs.append(subprocess.Popen(cmd, env=env, start_new_session=True))
        if args.save_pid:
            pid_dir = os.path.join(tempfile.gettempdir(),
                                   f"ds_pids_{os.getppid()}")
            os.makedirs(pid_dir, exist_ok=True)
            with open(os.path.join(pid_dir,
                                   f"rank{global_rank_base + i}.pid"),
                      "w") as f:
                f.write(str(procs[-1].pid))

    rc = 0
    try:
        while procs:
            for p in list(procs):
                r = p.poll()
                if r is None:
                    continue
                procs.remove(p)
                # keep the FIRST failure's code: siblings we SIGTERM below
                # exit -15 and must not clobber it
                if r != 0 and rc == 0:
                    logger.error(f"child {p.pid} exited rc={r}; "
                                 f"terminating local group")
                    rc = r
                    _terminate()
            if procs:
                import time

                time.sleep(0.2)
    finally:
        _terminate()
    return rc


if __name__ == "__main__":
    sys.exit(main())
