"""Device selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py`` ``get_accelerator``).

The port runs on ``cuda`` unless the caller asks for the CPU.  There is no
fallback: when CUDA is asked for (the default) and no GPU is visible,
:func:`get_accelerator` raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


class Accelerator:
    """One device type: ``cuda`` or ``cpu``."""

    def __init__(self, name: str):
        self._name = name

    def device_name(self) -> str:
        return self._name

    def device(self) -> torch.device:
        if self._name == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU, which
        runs eagerly)."""
        if self._name == "cuda":
            torch.cuda.synchronize()

    def max_memory_allocated(self) -> int:
        """Peak bytes held by the CUDA allocator since the last reset; the
        CPU has no such counter and reports 0."""
        if self._name == "cuda":
            return torch.cuda.max_memory_allocated()
        return 0

    def reset_peak_memory_stats(self) -> None:
        if self._name == "cuda":
            torch.cuda.reset_peak_memory_stats()


def get_accelerator(device: DeviceLike = None) -> Accelerator:
    """``device=None`` means CUDA; ``"cpu"`` must be asked for by name."""
    name = "cuda" if device is None else torch.device(device).type
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: the port runs on 'cuda' or "
                         f"'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default device) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return Accelerator(name)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (see
    :func:`get_accelerator`); an explicit index is kept."""
    acc = get_accelerator(device)
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return acc.device()
