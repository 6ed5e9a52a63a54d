"""Weight-quantized matmul whose weight operand STAYS int8 in device memory
(counterpart of ``deepspeed_tpu/ops/quantized_matmul.py``; reference:
``inference/v2/kernels/cutlass_ops/mixed_gemm/``).

Layout contract (the JAX package's): a record is
``{"q": int8 [K, N] in the weight's shape, "scale": [G] fp32}`` with groups
over leading-dim (K) rows, ``G | K``.

:func:`quantized_matmul` is the wrapper of the hand-written CUDA kernel in
``deepspeed_tpu_torch/csrc/quantized_matmul.cu``: for CUDA tensors it
launches the kernel at every M (the JAX package sends M < 64 to an XLA
composition; that rule was a TPU measurement) or raises: a skinny path for
M <= 8 (one launch a call: ``mma.sync`` fed by TMA, column tiles of 128 cut
along K over clusters of blocks, :func:`skinny_plan`) and a tiled tensor-core
path (wgmma, TMA) above it; for CPU tensors it takes the plain version,
``x @ dequant_reference(record, x.dtype)``.  ``LAUNCHES`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepspeed_tpu_torch.ops import _build

#: kernel launches (plain CPU calls do not count)
LAUNCHES = {"quantized_matmul": 0}

#: rows the kernel's skinny (decode) path takes, and the weight columns
#: and k rows of one of its units
_SKINNY_MAX_M = 8
_SKINNY_COLS = 128
_SKINNY_K = 256
#: the most blocks a tile's K is cut over (the portable cluster size)
_SKINNY_MAX_CLUSTER = 8
_K_ALIGN = 32
_N_ALIGN = 16
#: the tiled path's block: 128 weight columns against 64, 128 or 256 x
#: rows (tiled_rows), 64 k rows a stage
_TILED_COLS = 128
_TILED_ROWS = (64, 128, 256)
_TILED_K = 64


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):      # the launch goes to x's GPU
        if m <= _SKINNY_MAX_M:
            plan = skinny_plan(k, n, resident_clusters(x.device.index))
            rc = _skinny_kernel()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), m, k, n, g, plan["cluster"],
                                  stream)
        else:
            sms = _sms(x.device)
            splits = k_splits_for(m, k, n, sms)
            partial = (torch.empty((splits, m, n), dtype=torch.float32,
                                   device=x.device) if splits > 1 else None)
            rc = _kernel()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                           partial.data_ptr() if partial is not None
                           else None, out.data_ptr(), m, k, n, g, splits,
                           tiled_rows(m, n, sms), stream)
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


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tiled_rows(m: int, n: int, sms: int) -> int:
    """x rows a block of the tiled (wgmma) path takes, wgmma's N: 64 for a
    medium M (a verify pass, a small SplitFuse tick), 128 up to M = 128;
    above that 256 where the fewer, longer blocks finish sooner on ``sms``
    SMs (a 256-row block takes 1.5 times a 128-row one, measured on the
    H100), else 128."""
    small, medium, large = _TILED_ROWS
    if m <= small:
        return small
    if m <= medium:
        return medium

    def waves(rows):
        return -(-(-(-n // _TILED_COLS) * -(-m // rows)) // sms)

    return large if 3 * waves(large) < 2 * waves(medium) else medium


@functools.lru_cache(maxsize=None)
def skinny_plan(k: int, n: int, resident: tuple) -> dict:
    """The skinny path's launch: column ``tiles`` of 128 weight columns,
    each cut along K (``chunks`` units of 256 rows) over a ``cluster`` of
    c <= 8 blocks whose parts meet in distributed shared memory, c the
    largest for which every cluster of the launch is resident at once (1
    where the tiles alone need more); ``blocks`` = tiles x c; ``run``: the
    fewest and most units a block walks.  ``resident``: (c, clusters of c
    blocks the device holds at once) pairs for c = 2 .. 8, as
    :func:`resident_clusters` reads them (on an H100, 66 / 39 / 30 / 22 /
    17 / 15 / 15: 4096 x 4096's 32 tiles take clusters of 3)."""
    tiles = -(-n // _SKINNY_COLS)
    chunks = -(-k // _SKINNY_K)
    held = dict(resident)
    cluster = next((c for c in range(min(_SKINNY_MAX_CLUSTER, chunks), 1, -1)
                    if tiles <= held.get(c, 0)), 1)
    return {"tiles": tiles, "chunks": chunks, "cluster": cluster,
            "blocks": tiles * cluster,
            "run": (chunks // cluster, -(-chunks // cluster))}


@functools.lru_cache(maxsize=None)
def resident_clusters(index: int) -> tuple:
    """The skinny kernel's clusters of c blocks that CUDA device ``index``
    holds at once, as (c, count) pairs for c = 2 .. 8 (the runtime's
    occupancy query, once a device)."""
    counts = (ctypes.c_int * (_SKINNY_MAX_CLUSTER - 1))()
    with torch.cuda.device(index):
        rc = _build.load(
            "quantized_matmul").dstt_quantized_matmul_skinny_resident(counts)
    if rc != 0:
        raise RuntimeError(f"quantized_matmul: cluster occupancy query "
                           f"failed with error {rc}")
    return tuple(zip(range(2, _SKINNY_MAX_CLUSTER + 1), counts))


def k_splits_for(m: int, k: int, n: int, sms: int) -> int:
    """Blocks along K of the tiled path (M > 8) for ``sms`` SMs: split only
    while the output tiles fill fewer than ``sms`` SMs, at least 4 k-tiles
    of 64 rows a block (the kernel sums the fp32 partials in a second
    pass)."""
    tiles = -(-n // _TILED_COLS) * -(-m // tiled_rows(m, n, sms))
    k_tiles = -(-k // _TILED_K)
    return max(1, min(sms // tiles, k_tiles // 4))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The tiled path's entry (M > 8)."""
    fn = _build.load("quantized_matmul").dstt_quantized_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _skinny_kernel():
    """The skinny path's entry (M <= 8)."""
    fn = _build.load("quantized_matmul").dstt_quantized_matmul_skinny_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
