"""Weight-quantized matmul whose weight operand STAYS int8 in device memory
(counterpart of ``deepspeed_tpu/ops/quantized_matmul.py``; reference:
``inference/v2/kernels/cutlass_ops/mixed_gemm/``).

Layout contract (the JAX package's): a record is
``{"q": int8 [K, N] in the weight's shape, "scale": [G] fp32}`` with groups
over leading-dim (K) rows, ``G | K``.

:func:`quantized_matmul` is the wrapper of the hand-written CUDA kernel in
``deepspeed_tpu_torch/csrc/quantized_matmul.cu``: for CUDA tensors it
launches the kernel at every M (the JAX package sends M < 64 to an XLA
composition; that rule was a TPU measurement) or raises; for CPU tensors
it takes the plain version, ``x @ dequant_reference(record, x.dtype)``.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeed_tpu_torch.ops import _build

#: kernel launches (plain CPU calls do not count)
LAUNCHES = {"quantized_matmul": 0}

#: rows the kernel's skinny (decode) path takes, and the columns one of
#: its blocks covers
_SKINNY_MAX_M = 8
_SKINNY_BLOCK_N = 512
_K_ALIGN = 32
_N_ALIGN = 16


def is_quant_record(leaf) -> bool:
    """THE record predicate: key set AND int8 payload, so a model's own
    {'q','scale'} fp32 param subtree is never mistaken for a record."""
    return (isinstance(leaf, dict) and set(leaf) == {"q", "scale"}
            and getattr(leaf["q"], "dtype", None) == torch.int8)


def dequant_reference(record, dtype=torch.bfloat16) -> torch.Tensor:
    """Grouped dequant: split dim 0 into (groups, rows/groups), scale in
    fp32, round to ``dtype`` (the reference's single in-graph
    composition, and the kernel's rounding point)."""
    q, scale = record["q"], record["scale"]
    shape = tuple(q.shape)
    g = scale.shape[0]
    q3 = q.reshape((g, shape[0] // g) + shape[1:])
    exp = scale.reshape((g,) + (1,) * (q3.dim() - 1)).float()
    return (q3.float() * exp).to(dtype).reshape(shape)


def quantized_matmul_plain(x: torch.Tensor, record) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return x @ dequant_reference(record, x.dtype)


def quantized_matmul(x: torch.Tensor, record) -> torch.Tensor:
    """x [M, K] @ dequant(record [K, N]) -> [M, N] in ``x.dtype``, with the
    int8 weight read straight from device memory by the CUDA kernel."""
    if not x.is_cuda:
        return quantized_matmul_plain(x, record)
    q, scale = record["q"], record["scale"]
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
    m, k = x.shape
    kq, n = q.shape
    g = scale.shape[0]
    if q.device != x.device or scale.device != x.device:
        raise ValueError("quantized_matmul: x, q and scale must be on one "
                         "device")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError(f"quantized_matmul: the CUDA kernel takes bf16 x and "
                        f"fp32 scales (got {x.dtype}, {scale.dtype})")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("quantized_matmul: x, q and scale must be "
                         "contiguous")
    if kq != k or k % g or k % _K_ALIGN or n % _N_ALIGN:
        raise ValueError(
            f"quantized_matmul: the CUDA kernel takes K % {_K_ALIGN} == 0, "
            f"N % {_N_ALIGN} == 0 and G | K (got x {tuple(x.shape)}, q "
            f"{tuple(q.shape)}, G={g})")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("quantized_matmul: x and q must be 16-byte aligned "
                         "(the kernel reads them in 16-byte vectors)")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    splits = _k_splits(m, k, n, x.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):      # the launch goes to x's GPU
        rc = _kernel()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                       partial.data_ptr() if partial is not None else None,
                       out.data_ptr(), m, k, n, g, splits,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantized_matmul: CUDA kernel launch failed "
                           f"with error {rc}")
    LAUNCHES["quantized_matmul"] += 1
    return out


def qmm(x: torch.Tensor, leaf, dtype=None,
        use_kernel: bool = True) -> torch.Tensor:
    """Serving matmul entry: ``leaf`` is either a plain ``[K, N]`` weight
    (a dense product, left to ``torch.matmul`` as the JAX package leaves it
    to XLA) or a ``{"q", "scale"}`` record.  ``use_kernel=False`` takes the
    plain version on any device (the on-card comparison path)."""
    if is_quant_record(leaf):
        if use_kernel:
            return quantized_matmul(x, leaf)
        return quantized_matmul_plain(x, leaf)
    return x @ (leaf.to(dtype) if dtype is not None else leaf)


def _k_splits(m: int, k: int, n: int, device) -> int:
    """Blocks along K for the skinny path: as many as keep the grid to one
    wave (one block fits an SM), with at least 64 weight rows a block."""
    if m > _SKINNY_MAX_M:
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    col_blocks = -(-n // _SKINNY_BLOCK_N)
    return max(1, min(sms // col_blocks, k // 64))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("quantized_matmul").dstt_quantized_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
