"""Multinode runners (counterpart of
``deepspeed_tpu/launcher/multinode_runner.py``; reference:
launcher/multinode_runner.py — PDSH ``:51``,
OpenMPI ``:117``, MPICH ``:170``, IMPI ``:241``, SLURM ``:326``,
MVAPICH ``:374``).

Each runner turns (args, resource pool) into the fan-out command(s) that
start one process per slot on every host. Two families:

* **launcher-managed rank** (pdsh/ssh, built in runner.py): every node runs
  :mod:`deepspeed_tpu_torch.launcher.launch`, which sets RANK/LOCAL_RANK
  itself;
* **scheduler-managed rank** (this module): one ``mpirun``/``srun``
  invocation starts the user script everywhere and the scheduler's
  environment (OMPI_COMM_WORLD_RANK / PMI_RANK / SLURM_PROCID) carries the
  rank; the rendezvous goes out as ``MASTER_ADDR`` / ``MASTER_PORT``
  (where the JAX package exports ``COORDINATOR_ADDRESS``).  Translating
  the scheduler's rank variables is the comm layer's (ROADMAP A6).
"""

from __future__ import annotations

import atexit
import os
import shlex
import shutil
import sys
import tempfile
from typing import Dict, List

from deepspeed_tpu_torch.launcher.constants import EXPORT_ENVS


def _user_cmd(args) -> List[str]:
    cmd: List[str] = []
    if not args.no_python:
        cmd += [sys.executable, "-u"]
        if args.module:
            cmd += ["-m"]
    cmd.append(args.user_script)
    cmd += args.user_args
    return cmd


def _exports() -> Dict[str, str]:
    return {k: os.environ[k] for k in EXPORT_ENVS if k in os.environ}


class MultiNodeRunner:
    """reference multinode_runner.py:MultiNodeRunner (ABC)."""

    name = "base"

    def __init__(self, args, world_info: Dict[str, List[int]],
                 master_addr: str, master_port: int):
        self.args = args
        self.world_info = world_info
        self.master_addr = master_addr
        self.master_port = master_port
        self.launcher_args = shlex.split(
            getattr(args, "launcher_args", "") or "")

    @property
    def world_size(self) -> int:
        return sum(len(s) for s in self.world_info.values())

    def backend_exists(self) -> bool:
        raise NotImplementedError

    def get_cmd(self) -> List[str]:
        raise NotImplementedError

    def _require(self, binary: str) -> bool:
        return shutil.which(binary) is not None

    def _filtered_hostfile(self) -> str:
        """Write the FILTERED pool to a temp hostfile — args.hostfile may
        not exist (single node) or may contain hosts the user excluded,
        and mpirun places ranks by hostfile, not by -n."""
        f = tempfile.NamedTemporaryFile(
            "w", prefix="ds_torch_hostfile_", suffix=".txt", delete=False)
        for host, slots in self.world_info.items():
            f.write(f"{host} slots={len(slots)}\n")
        f.close()
        atexit.register(lambda p=f.name: os.path.exists(p) and os.unlink(p))
        return f.name

    def _slots_per_host(self) -> int:
        counts = {len(s) for s in self.world_info.values()}
        if len(counts) != 1:
            raise ValueError(
                f"--launcher={self.name} places a uniform number of ranks "
                f"per host; the filtered pool has heterogeneous slot "
                f"counts {sorted(counts)} — even them out with "
                f"--include/--num_gpus or use the ssh/pdsh launcher")
        return counts.pop()


class OpenMPIRunner(MultiNodeRunner):
    """reference multinode_runner.py:117 — ``mpirun`` with per-env -x."""

    name = "openmpi"

    def backend_exists(self) -> bool:
        return self._require("mpirun")

    def get_cmd(self) -> List[str]:
        cmd = ["mpirun", "-n", str(self.world_size),
               "-hostfile", self._filtered_hostfile(),
               "--mca", "btl", "^openib",
               "--mca", "btl_tcp_if_include", "eth0"]
        for k, v in _exports().items():
            cmd += ["-x", f"{k}={v}"]
        cmd += ["-x", f"MASTER_ADDR={self.master_addr}",
                "-x", f"MASTER_PORT={self.master_port}"]
        return cmd + self.launcher_args + _user_cmd(self.args)


class MPICHRunner(MultiNodeRunner):
    """reference multinode_runner.py:170 — hydra ``mpirun -np/-ppn``."""

    name = "mpich"

    def backend_exists(self) -> bool:
        return self._require("mpirun")

    def get_cmd(self) -> List[str]:
        cmd = ["mpirun", "-np", str(self.world_size),
               "-ppn", str(self._slots_per_host()),
               "-hostfile", self._filtered_hostfile()]
        for k, v in _exports().items():
            cmd += ["-genv", k, v]
        cmd += ["-genv", "MASTER_ADDR", self.master_addr,
                "-genv", "MASTER_PORT", str(self.master_port)]
        return cmd + self.launcher_args + _user_cmd(self.args)


class IMPIRunner(MPICHRunner):
    """reference multinode_runner.py:241 — Intel MPI (hydra-compatible)."""

    name = "impi"


class MVAPICHRunner(MPICHRunner):
    """reference multinode_runner.py:374 — MVAPICH (hydra-compatible,
    plus its affinity default)."""

    name = "mvapich"

    def get_cmd(self) -> List[str]:
        cmd = super().get_cmd()
        # MV2 pins all ranks to one core by default — disable, as the
        # reference does
        i = cmd.index("-hostfile")
        return cmd[:i] + ["-genv", "MV2_ENABLE_AFFINITY", "0"] + cmd[i:]


class SlurmRunner(MultiNodeRunner):
    """reference multinode_runner.py:326 — ``srun`` under an allocation."""

    name = "slurm"

    def backend_exists(self) -> bool:
        return self._require("srun")

    def get_cmd(self) -> List[str]:
        # env vars ride through --export=ALL from srun's OWN environment —
        # an explicit --export K=V list would need comma escaping srun
        # doesn't support (CUDA_VISIBLE_DEVICES=0,1 would be split), so the
        # extras are set on the srun process via an `env` prefix instead
        kv = {**_exports(), "MASTER_ADDR": self.master_addr,
              "MASTER_PORT": str(self.master_port)}
        cmd = ["env"] + [f"{k}={v}" for k, v in kv.items()] + \
            ["srun", "-n", str(self.world_size),
             "--ntasks-per-node", str(self._slots_per_host()),
             "--export=ALL"]
        if self.world_info:
            cmd += ["--nodelist", ",".join(self.world_info)]
        return cmd + self.launcher_args + _user_cmd(self.args)


RUNNERS = {r.name: r for r in (OpenMPIRunner, MPICHRunner, IMPIRunner,
                               MVAPICHRunner, SlurmRunner)}
