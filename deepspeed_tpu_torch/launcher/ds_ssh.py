"""``ds_ssh`` console entry (counterpart of
``deepspeed_tpu/launcher/ds_ssh.py``): run a shell command on every host of
a hostfile (reference ``bin/ds_ssh`` — a pdsh wrapper; here ssh/pdsh with
the same hostfile format the launcher consumes)."""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys

from deepspeed_tpu_torch.launcher.runner import fetch_hostfile

DEFAULT_HOSTFILE = "/job/hostfile"


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run a command on every host of a hostfile")
    parser.add_argument("-f", "--hostfile", default=DEFAULT_HOSTFILE,
                        help=f"hostfile path (default {DEFAULT_HOSTFILE})")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run on every host")
    ns = parser.parse_args(args)
    if not ns.command:
        parser.error("no command given")
    resources = fetch_hostfile(ns.hostfile)
    if not resources:
        print(f"Missing or empty hostfile at {ns.hostfile}",
              file=sys.stderr)
        return 1
    hosts = list(resources.keys())
    cmd = " ".join(ns.command)
    if shutil.which("pdsh"):
        return subprocess.run(
            ["pdsh", "-R", "ssh", "-w", ",".join(hosts), cmd]).returncode
    rc = 0
    for h in hosts:
        print(f"--- {h}")
        r = subprocess.run(["ssh", "-o", "StrictHostKeyChecking=no", h,
                            cmd])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
