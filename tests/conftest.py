"""Test harness: run every test on a virtual 8-device CPU mesh.

The reference spawns real N-process NCCL groups per test
(tests/unit/common.py:107 DistributedExec). On TPU the equivalent story is
better: a single host emulates an N-device mesh in-process via
``--xla_force_host_platform_device_count``, so "distributed" tests are plain
pytest functions running real collectives over 8 XLA CPU devices.
"""

import os

# Must happen before the first JAX backend initialisation.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["DS_ACCELERATOR"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skips where torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _reset_global_mesh():
    """Each test starts with a fresh global topology."""
    from deepspeed_tpu.parallel import groups

    groups.reset()
    yield
    groups.reset()


@pytest.fixture
def devices():
    return jax.devices()


@pytest.fixture
def trace_guard():
    """dslint runtime guard (deepspeed_tpu/analysis/trace_guard.py):
    wrap a warmed-up region to assert it never recompiles or syncs —
    ``with trace_guard(max_compiles=0, max_host_syncs=0): step()``."""
    from deepspeed_tpu.analysis.trace_guard import TraceGuard

    return TraceGuard
