"""Build the port's CUDA kernels at first use.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
``build/deepspeed_tpu_torch/lib<name>-<hash>.so`` under the repository root,
and loaded with ``ctypes``.  The file name carries a hash of the source, of
the headers it shares (``csrc/*.cuh``) and of the flags, so an edited
kernel is rebuilt and a stale library is never loaded.  :func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: a machine without ``nvcc`` imports the
package and runs the plain PyTorch paths on the CPU; only a call that needs
a kernel asks for a build, and that call raises if ``nvcc`` is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "deepspeed_tpu_torch"
SOURCES = ("quantized_matmul", "blocked_flash", "flash_attention",
           "grouped_gemm", "quantizer", "evoformer_attn",
           "block_sparse_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source text, shared headers and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(source: Path, library: Path) -> list:
    """The ``nvcc`` command that builds ``source`` into ``library``; the
    shared headers of ``csrc/`` are on its include path, so a copy of a
    source built elsewhere finds them too."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(library),
            str(source)]


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every listed source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the seconds each build
    took (0.0 when the library was already there).  ``nvcc``'s resource
    report (``-Xptxas -v``) is kept beside each library as ``.log``."""
    seconds = {name: 0.0 for name in names}
    missing = [n for n in seconds if not library_path(n).exists()]
    if not missing:
        return seconds
    _nvcc()                       # raise before making anything
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
