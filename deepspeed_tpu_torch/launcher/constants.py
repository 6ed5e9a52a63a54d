"""Launcher constants (counterpart of ``deepspeed_tpu/launcher/constants.py``;
reference: launcher/constants.py)."""

DLTS_HOSTFILE = "/job/hostfile"

#: environment variables forwarded to every launched worker
EXPORT_ENVS = ("PYTHONPATH", "CUDA_VISIBLE_DEVICES", "CUDA_HOME",
               "DS_ACCELERATOR", "DS_ELASTIC_NODE_RANGE")

PDSH_LAUNCHER = "pdsh"
SSH_LAUNCHER = "ssh"
LOCAL_LAUNCHER = "local"
OPENMPI_LAUNCHER = "openmpi"
MPICH_LAUNCHER = "mpich"
IMPI_LAUNCHER = "impi"
MVAPICH_LAUNCHER = "mvapich"
SLURM_LAUNCHER = "slurm"
