"""Grouped (ragged) expert GEMM and the dropless MoE FFN built on it
(counterpart of ``deepspeed_tpu/ops/grouped_gemm.py``; reference:
``inference/v2/kernels/cutlass_ops/moe_gemm/`` with
``ragged_ops/moe_scatter`` / ``moe_gather``).

``gmm(lhs, rhs, group_sizes)`` multiplies contiguous row groups of
``lhs [M, K]`` (rows sorted by group) by per-group weights
``rhs [E, K, N]``::

    out[start_e:end_e] = lhs[start_e:end_e] @ rhs[e]

with ``start/end`` the running offsets of ``group_sizes [E]`` (int32, on
the device: token routing decides them at run time).  Rows past
``sum(group_sizes)`` come out as zeros; an empty group contributes nothing.

:func:`gmm` is differentiable (the JAX package's ``custom_vjp``, here a
``torch.autograd.Function``): its backward is ``_gmm_bwd``, ``dlhs[M, K] =
dout @ rhs[g]^T`` per group with zeros past the total, and ``drhs[E, K, N]
= lhs[rows_g]^T @ dout[rows_g]`` per group with zeros for an empty group;
``group_sizes`` takes no gradient.  All three are hand-written CUDA kernels
in ``deepspeed_tpu_torch/csrc/grouped_gemm.cu``, the gradients wrapped by
:func:`gmm_dlhs` and :func:`gmm_drhs`.  One kernel, warp-specialised on
``wgmma`` fed by TMA, runs all three at every M (one block a 128 x 256
output tile: :data:`GRAD_TILES`, :data:`FWD_TILES`), and raises if it
fails.
:func:`gmm_tile_walk` is the wgmma kernel's tile walk in plain Python, which
the ``.cu`` mirrors, and :func:`gmm_fwd_tiled_plain`,
:func:`gmm_dlhs_tiled_plain` and :func:`gmm_drhs_tiled_plain` evaluate it
(for the CPU tests).  For CUDA tensors each is
launched at every M — the JAX package sends an M that is not a multiple of
its tile to the dense ``gmm_reference`` (``_use_kernel``); here the
kernels mask the ragged edge themselves — or raises; for CPU tensors (and
``use_kernel=False``) the plain versions :func:`gmm_plain`,
:func:`gmm_dlhs_plain` and :func:`gmm_drhs_plain` run instead.  The kernels
pick their own tiles: the JAX package's ``_pick_tiles`` is a TPU VMEM
budget and is not ported.  ``LAUNCHES`` counts the kernel launches.

:func:`grouped_moe_ffn` is the dropless top-k MoE FFN over a flat token
buffer: a stable sort of the ``T * k`` (token, expert) pairs by expert,
three grouped GEMMs (gate, up, down; SwiGLU) and an fp32 scatter-add
combine, with the JAX package's cast points.  It differentiates through
``gmm``: the router's gradient flows through ``topw``, the sort's through
the gather and ``index_add_``.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import _build

#: kernel launches (plain calls do not count)
LAUNCHES = {"grouped_gemm": 0, "grouped_gemm_dlhs": 0,
            "grouped_gemm_drhs": 0}

#: the kernels read their operands in 16-byte vectors: K and N multiples
#: of 8
_ALIGN = 8
#: the wgmma forward's tiles (``GmmTiles<kFwd>`` in the ``.cu``): 128-row
#: units (``bm``) by ``bn`` output columns, reduction steps of ``bk``, its
#: (unit, n-tile) pairs in bands of ``band`` units
FWD_TILES = {"bm": 128, "bn": 256, "bk": 64, "band": 8}
#: the gradient kernels' tiles (``GmmTiles`` in the ``.cu``): output rows
#: ``bm`` (two warpgroups of 64) by columns ``bn``, reduction steps of
#: ``bk``; dlhs orders its (unit, n-tile) pairs in bands of ``band`` units;
#: drhs hands out its groups' tiles largest group first (``by_work``), and
#: within a group changes fastest the tile of the shorter of K and N
#: (``n_fast`` 2; 0: the K-tile, 1: the N-tile)
GRAD_TILES = {"bm": 128, "bn": 256, "bk": 64, "band": 16, "by_work": True,
              "n_fast": 2}
#: the keys of :func:`launch_info`
LAUNCH_INFO_KEYS = ("kernel", "grid", "threads", "smem", "tiles", "bm", "bn",
                    "stages", "band", "registers", "spill_bytes", "encode_ns")
#: :func:`launch_info`'s kernel names by the ``.cu``'s codes
LAUNCH_KERNELS = ("gmm_wgmma_kernel<kDlhs>", "gmm_wgmma_kernel<kDrhs>",
                  "gmm_wgmma_kernel<kFwd>")


def traced_kernel(name: str):
    """The :data:`LAUNCH_KERNELS` name of a kernel as a device trace names
    it (the kind as its ``.cu`` code: ``gmm_wgmma_kernel<2>`` is the
    forward), or None for another kernel."""
    flat = re.sub(r"\(int\)|\s", "", name)
    for code, kernel in enumerate(LAUNCH_KERNELS):
        if re.sub(r"<k\w+>", f"<{code}>", kernel) in flat:
            return kernel
    return None


def _group_rows(group_sizes: torch.Tensor, m: int):
    """(group, start, end) of every group that holds a row, clamped to
    ``m`` as the kernels clamp them.  Reads the sizes on the host."""
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            yield e, start, end
        start = end


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch (the JAX package's
    ``gmm_reference``): each group's rows times its weight in fp32, rounded
    to ``lhs.dtype``; rows past the last group are zeros."""
    out = torch.zeros((lhs.shape[0], rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for e, start, end in _group_rows(group_sizes, lhs.shape[0]):
        out[start:end] = lhs[start:end].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def gmm_dlhs_plain(dout: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The dlhs kernel's function (``_gmm_bwd``'s XLA branch):
    ``dout[rows_g] @ rhs[g]^T`` in fp32, rounded to ``dout.dtype``; rows
    past the last group are zeros.  ``[M, K]``."""
    out = torch.zeros((dout.shape[0], rhs.shape[1]), dtype=torch.float32,
                      device=dout.device)
    for e, start, end in _group_rows(group_sizes, dout.shape[0]):
        out[start:end] = dout[start:end].float() @ rhs[e].float().t()
    return out.to(dout.dtype)


def gmm_drhs_plain(lhs: torch.Tensor, dout: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """The drhs kernel's function (``_gmm_bwd``'s XLA branch):
    ``lhs[rows_g]^T @ dout[rows_g]`` per group in fp32, rounded to
    ``lhs.dtype``; an empty group's block is zeros.  ``[E, K, N]``."""
    out = torch.zeros((group_sizes.shape[0], lhs.shape[1], dout.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    for e, start, end in _group_rows(group_sizes, lhs.shape[0]):
        out[e] = lhs[start:end].float().t() @ dout[start:end].float()
    return out.to(lhs.dtype)


class _GroupedMatmul(torch.autograd.Function):
    """``gmm`` with the JAX package's ``_gmm_fwd`` / ``_gmm_bwd``: the
    kernels for CUDA tensors unless ``use_kernel`` is False, the plain
    versions otherwise.  A gradient is computed only where an input asks
    for one."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, use_kernel):
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(lhs, rhs, group_sizes)
        if use_kernel and lhs.is_cuda:
            return _launch(lhs, rhs, group_sizes)
        return gmm_plain(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        # index_add_'s backward can hand over a strided view
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm_dlhs(dout, rhs, group_sizes, ctx.use_kernel)
        if ctx.needs_input_grad[1]:
            drhs = gmm_drhs(lhs, dout, group_sizes,
                            ctx.use_kernel).to(rhs.dtype)
        return dlhs, drhs, None, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        use_kernel: bool = True) -> torch.Tensor:
    """Grouped matmul: ``lhs [M, K]`` rows sorted by group times
    ``rhs [E, K, N]``; ``group_sizes [E]`` int32 sums to <= M.  Returns
    ``[M, N]`` in ``lhs.dtype``, differentiable in ``lhs`` and ``rhs``.  No
    host sync on the kernel path: the group sizes stay on the device."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, use_kernel)


def gmm_dlhs(dout: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor, use_kernel: bool = True):
    """``gmm``'s gradient with respect to ``lhs``: ``[M, K]``, rows past
    the groups zeros.  The dlhs kernel for CUDA tensors, the plain version
    for CPU tensors or ``use_kernel=False``."""
    if use_kernel and dout.is_cuda:
        return _launch_dlhs(dout, rhs, group_sizes)
    return gmm_dlhs_plain(dout, rhs, group_sizes)


def gmm_drhs(lhs: torch.Tensor, dout: torch.Tensor,
             group_sizes: torch.Tensor, use_kernel: bool = True):
    """``gmm``'s gradient with respect to ``rhs``: ``[E, K, N]``, an empty
    group's block zeros.  The drhs kernel for CUDA tensors, the plain
    version for CPU tensors or ``use_kernel=False``."""
    if use_kernel and lhs.is_cuda:
        return _launch_drhs(lhs, dout, group_sizes)
    return gmm_drhs_plain(lhs, dout, group_sizes)


def _check(fn: str, group_sizes: torch.Tensor, **operands) -> None:
    """What every kernel takes: bf16 operands and int32 group sizes, on one
    device, contiguous, 16-byte aligned."""
    dev = group_sizes.device
    for name, t in operands.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, group_sizes "
                             f"on {dev}")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 or any(
            t.dtype != torch.bfloat16 for t in operands.values()):
        raise TypeError(
            f"{fn}: the CUDA kernel takes bf16 operands and int32 "
            f"group_sizes [E] (got "
            + ", ".join(f"{n} {t.dtype}" for n, t in operands.items())
            + f", group_sizes {group_sizes.dtype} "
            f"{tuple(group_sizes.shape)}); use_kernel=False takes the plain "
            f"path")
    if not (group_sizes.is_contiguous()
            and all(t.is_contiguous() for t in operands.values())):
        raise ValueError(f"{fn}: {', '.join(operands)} and group_sizes must "
                         f"be contiguous")
    if any(t.data_ptr() % 16 for t in operands.values()):
        raise ValueError(f"{fn}: {', '.join(operands)} must be 16-byte "
                         f"aligned (the kernel reads them in 16-byte "
                         f"vectors)")


def _check_shapes(fn, ok, **operands):
    if not ok:
        raise ValueError(
            f"{fn}: the CUDA kernel takes lhs / dout [M, K or N], rhs "
            f"[E, K, N] and group_sizes [E] with E >= 1 and K and N "
            f"multiples of {_ALIGN} (got "
            + ", ".join(f"{n} {tuple(t.shape)}" for n, t in operands.items())
            + ")")


def _run(symbol: str, key: str, device, *args) -> None:
    with torch.cuda.device(device):      # the launch goes to the operands' GPU
        rc = _kernel(symbol)(*args, torch.cuda.current_stream(device)
                             .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{key}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[key] += 1


def _launch(lhs, rhs, group_sizes):
    _check("gmm", group_sizes, lhs=lhs, rhs=rhs)
    _check_shapes("gmm", lhs.dim() == 2 and rhs.dim() == 3
                  and rhs.shape[1] == lhs.shape[1]
                  and rhs.shape[0] == group_sizes.shape[0] >= 1
                  and lhs.shape[1] % _ALIGN == 0 and rhs.shape[2] % _ALIGN == 0,
                  lhs=lhs, rhs=rhs, group_sizes=group_sizes)
    (m, k), (e, _, n) = lhs.shape, rhs.shape
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m and n:
        _run("dstt_grouped_gemm_bf16", "grouped_gemm", lhs.device,
             lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
             out.data_ptr(), m, k, n, e)
    return out


def _launch_dlhs(dout, rhs, group_sizes):
    _check("gmm dlhs", group_sizes, dout=dout, rhs=rhs)
    _check_shapes("gmm dlhs", dout.dim() == 2 and rhs.dim() == 3
                  and rhs.shape[2] == dout.shape[1]
                  and rhs.shape[0] == group_sizes.shape[0] >= 1
                  and rhs.shape[1] % _ALIGN == 0
                  and dout.shape[1] % _ALIGN == 0,
                  dout=dout, rhs=rhs, group_sizes=group_sizes)
    (m, n), (e, k, _) = dout.shape, rhs.shape
    out = torch.empty((m, k), dtype=dout.dtype, device=dout.device)
    if m and k:
        _run("dstt_grouped_gemm_dlhs_bf16", "grouped_gemm_dlhs", dout.device,
             dout.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
             out.data_ptr(), m, k, n, e)
    return out


def _launch_drhs(lhs, dout, group_sizes):
    _check("gmm drhs", group_sizes, lhs=lhs, dout=dout)
    _check_shapes("gmm drhs", lhs.dim() == 2 and dout.dim() == 2
                  and dout.shape[0] == lhs.shape[0]
                  and group_sizes.shape[0] >= 1
                  and lhs.shape[1] % _ALIGN == 0
                  and dout.shape[1] % _ALIGN == 0,
                  lhs=lhs, dout=dout, group_sizes=group_sizes)
    (m, k), n, e = lhs.shape, dout.shape[1], group_sizes.shape[0]
    out = torch.empty((e, k, n), dtype=lhs.dtype, device=lhs.device)
    if k and n:
        _run("dstt_grouped_gemm_drhs_bf16", "grouped_gemm_drhs", lhs.device,
             lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
             out.data_ptr(), m, k, n, e)
    return out


@functools.lru_cache(maxsize=None)
def _kernel(symbol: str):
    fn = getattr(_build.load("grouped_gemm"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_info() -> dict:
    """The last launch's kernel and shape (``dstt_gmm_launch_info``): the
    kernel (a name of :data:`LAUNCH_KERNELS`), blocks, threads and shared
    bytes a block, output tiles, rows and columns of a tile, ring stages,
    units a band of the tile order (0 where the kernel walks no units in
    bands), registers a thread at launch, spill bytes, and the host ns
    spent encoding its tensor maps."""
    fn = _build.load("grouped_gemm").dstt_gmm_launch_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(LAUNCH_INFO_KEYS))()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"dstt_gmm_launch_info failed with {rc}")
    info = dict(zip(LAUNCH_INFO_KEYS, out))
    info["kernel"] = LAUNCH_KERNELS[info["kernel"]]
    return info


def _find_unit(sizes, m: int, bm: int, w: int):
    """Unit ``w`` of the static list (``find_unit`` in the ``.cu``):
    (group or -1, m-tile, product rows [lo, hi), zero rows [zlo, zhi))."""
    group, m_tile, lo, hi, zlo, zhi = -1, 0, 0, 0, 0, 0
    start = work = 0
    for e, size in enumerate(sizes):
        end = min(start + max(int(size), 0), m)
        if end > start:
            first = start // bm
            tiles = (end - 1) // bm - first + 1
            if group < 0 and w < work + tiles:
                group, m_tile, lo, hi = e, first + (w - work), start, end
            work += tiles
        start = end
    total = start
    if group >= 0:
        if w == work - 1:                       # the last valid unit
            zlo, zhi = total, min(m, (m_tile + 1) * bm)
    else:                                       # a spare unit: zeros
        m_tile = -(-total // bm) + (w - work)
        zlo = m_tile * bm
        zhi = min(m, zlo + bm)
    return group, m_tile, lo, hi, zlo, zhi


def _unit_tiles(sizes, m: int, cols: int, bm: int, bn: int, band: int):
    """The unit list at ``bm`` rows and its (unit, n-tile) pairs over
    ``cols`` output columns in launch order: bands of ``band`` units, the
    n-tile slowest within a band (``gmm_tile`` in the ``.cu``)."""
    units = [_find_unit(sizes, m, bm, w)
             for w in range(-(-m // bm) + len(sizes) - 1)]
    nt = -(-cols // bn)
    order = []
    for b0 in range(0, len(units), band):
        width = min(band, len(units) - b0)
        order += [(b0 + i % width, i // width) for i in range(width * nt)]
    return units, order


def _halves(units, bm: int, m: int):
    """Per unit, for each half of its m-tile below M (a consumer
    warpgroup's rows), ``(r0, r1, by_tma)``: whether every row is the
    unit's, as product or as zeros (stored whole by TMA), or the half goes
    out from registers, row by row."""
    stores = []
    for group, m_tile, lo, hi, zlo, zhi in units:
        halves = []
        for r0 in range(m_tile * bm, m_tile * bm + bm, bm // 2):
            r1 = min(r0 + bm // 2, m)
            if r1 > r0:
                mine = (max(0, min(r1, hi) - max(r0, lo))
                        + max(0, min(r1, zhi) - max(r0, zlo)))
                halves.append((r0, r1, mine == r1 - r0))
        stores.append(halves)
    return stores


def gmm_tile_walk(group_sizes, m: int, k: int, n: int,
                  tiles: dict = None, fwd_tiles: dict = None) -> dict:
    """The wgmma kernel's walk, in plain Python (``gmm_wgmma_kernel`` in
    ``csrc/grouped_gemm.cu`` mirrors it), for ``lhs [M, K]``, ``rhs [E, K,
    N]``, ``dout [M, N]``, the gradients' tiles ``tiles`` (default
    :data:`GRAD_TILES`) and the forward's ``fwd_tiles`` (default
    :data:`FWD_TILES`).

    The forward (``lhs @ rhs[g]``, ``[M, N]``):

    * ``"fwd_units"``: per unit, as ``"units"`` below at the forward's rows;
    * ``"fwd_order"``: the (unit, n-tile) pairs over N in launch order, in
      bands of ``band`` units, the n-tile slowest within a band;
    * ``"fwd_stores"``: per unit, as ``"dlhs_stores"`` below.

    dlhs (``dout @ rhs[g]^T``, ``[M, K]``):

    * ``"units"``: per unit ``w``, ``(group, m_tile, lo, hi, zlo, zhi)``:
      the rows [lo, hi) it writes with the product of its group (-1: a
      spare unit) and the rows [zlo, zhi) it writes as zeros;
    * ``"dlhs_order"``: the (unit, n-tile) pairs in launch order, in bands
      of ``band`` units, the n-tile slowest within a band;
    * ``"dlhs_stores"``: per unit, for each half of its m-tile below M (a
      consumer warpgroup's rows), ``(r0, r1, by_tma)``: whether every row
      is the unit's (stored whole by TMA) or the half goes out from
      registers, row by row.

    drhs (``lhs[rows_g]^T @ dout[rows_g]``, ``[E, K, N]``):

    * ``"drhs_order"``: the (group, k_tile, n_tile) triples in launch
      order, the largest group first with ``by_work`` (of equal ones the
      lower index), within a group the tile of the shorter of K and N
      fastest (``n_fast``);
    * ``"groups"``: per group ``(start, end, chunks, tail)``: its rows,
      the 64-row chunks ``(r0, r1)`` it loads (r1 = r0 + bk, rows past M
      read as zeros) and the rows [end, r1) of its last chunk that the
      kernel zeroes in lhs (None for an empty group).
    """
    t = dict(GRAD_TILES, **(tiles or {}))
    bm, bn, bk, band = t["bm"], t["bn"], t["bk"], t["band"]
    sizes = [int(s) for s in group_sizes]
    e = len(sizes)
    units, order = _unit_tiles(sizes, m, k, bm, bn, band)
    f = dict(FWD_TILES, **(fwd_tiles or {}))
    fwd_units, fwd_order = _unit_tiles(sizes, m, n, f["bm"], f["bn"],
                                       f["band"])
    groups, start = [], 0
    for size in sizes:
        end = min(start + max(size, 0), m)
        chunks = [(r0, r0 + bk) for r0 in range(start, end, bk)]
        groups.append((start, end, chunks,
                       (end, chunks[-1][1]) if chunks else None))
        start = end
    rank = sorted(range(e), key=lambda g: (-(groups[g][1] - groups[g][0]), g)
                  if t["by_work"] else g)
    kt, ntr = -(-k // bm), -(-n // bn)
    n_fast = t["n_fast"] == 1 or (t["n_fast"] == 2 and n < k)
    drhs_order = [(g, r // ntr, r % ntr) if n_fast else (g, r % kt, r // kt)
                  for g in rank for r in range(kt * ntr)]
    return {"units": units, "dlhs_order": order,
            "dlhs_stores": _halves(units, bm, m),
            "drhs_order": drhs_order, "groups": groups,
            "fwd_units": fwd_units, "fwd_order": fwd_order,
            "fwd_stores": _halves(fwd_units, f["bm"], m)}


def _rows(x: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of ``x`` in fp32, zeros past its end (a TMA box)."""
    out = torch.zeros((r1 - r0,) + tuple(x.shape[1:]), dtype=torch.float32)
    out[:max(0, min(r1, x.shape[0]) - r0)] = x[r0:r1].float()
    return out


def gmm_fwd_tiled_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                        group_sizes: torch.Tensor,
                        tiles: dict = None) -> torch.Tensor:
    """The forward over :func:`gmm_tile_walk`'s tiles, in plain PyTorch
    (fp32, one rounding to ``lhs.dtype``): each (unit, n-tile) multiplies
    its whole m-tile (rows of the next group and past M included, as the
    kernel loads them), and each consumer warpgroup writes its half of the
    rows as the kernel stores them: by TMA every row (the product for the
    unit's group rows, zeros for the rest), from registers only the rows
    the unit owns.  An element no tile writes stays NaN.  For the
    tests: the main path runs the kernel (CUDA) or :func:`gmm_plain`
    (CPU)."""
    (m, k), n = lhs.shape, rhs.shape[2]
    f = dict(FWD_TILES, **(tiles or {}))
    walk = gmm_tile_walk(group_sizes.tolist(), m, k, n, fwd_tiles=tiles)
    out = torch.full((m, n), float("nan"))
    for w, j in walk["fwd_order"]:
        group, m_tile, lo, hi, zlo, zhi = walk["fwd_units"][w]
        row0 = m_tile * f["bm"]
        cols = slice(j * f["bn"], min(j * f["bn"] + f["bn"], n))
        if group >= 0:
            acc = _rows(lhs, row0, row0 + f["bm"]) @ rhs[group, :, cols].float()
        for r0, r1, by_tma in walk["fwd_stores"][w]:
            for r in range(r0, r1):
                if group >= 0 and lo <= r < hi:
                    out[r, cols] = acc[r - row0]
                elif by_tma or zlo <= r < zhi:
                    out[r, cols] = 0.0
    return out.to(lhs.dtype)


def gmm_dlhs_tiled_plain(dout: torch.Tensor, rhs: torch.Tensor,
                         group_sizes: torch.Tensor,
                         tiles: dict = None) -> torch.Tensor:
    """dlhs over :func:`gmm_tile_walk`'s tiles, in plain PyTorch (fp32, one
    rounding to ``dout.dtype``): each (unit, n-tile) multiplies its whole
    m-tile (rows of the next group and past M included, as the kernel
    loads them) and writes only the rows the unit owns.  An element no
    tile writes stays NaN.  For the tests: the main path runs the kernel
    (CUDA) or :func:`gmm_dlhs_plain` (CPU)."""
    t = dict(GRAD_TILES, **(tiles or {}))
    (m, n), k = dout.shape, rhs.shape[1]
    walk = gmm_tile_walk(group_sizes.tolist(), m, k, n, t)
    out = torch.full((m, k), float("nan"))
    for w, j in walk["dlhs_order"]:
        group, m_tile, lo, hi, zlo, zhi = walk["units"][w]
        r0, c0 = m_tile * t["bm"], j * t["bn"]
        cols = slice(c0, min(c0 + t["bn"], k))
        if group >= 0:
            acc = _rows(dout, r0, r0 + t["bm"]) @ rhs[group, cols].float().t()
        for i in range(t["bm"]):
            r = r0 + i
            if lo <= r < hi:
                out[r, cols] = acc[i]
            elif zlo <= r < zhi:
                out[r, cols] = 0.0
    return out.to(dout.dtype)


def gmm_drhs_tiled_plain(lhs: torch.Tensor, dout: torch.Tensor,
                         group_sizes: torch.Tensor,
                         tiles: dict = None) -> torch.Tensor:
    """drhs over :func:`gmm_tile_walk`'s tiles, in plain PyTorch (fp32, one
    rounding to ``lhs.dtype``): each (group, K-tile, N-tile) sums its
    group's 64-row chunks, the last chunk's rows past the group zeroed in
    lhs only (dout's are the next group's, as the kernel loads them).  An
    element no tile writes stays NaN.  For the tests: the main path runs
    the kernel (CUDA) or :func:`gmm_drhs_plain` (CPU)."""
    t = dict(GRAD_TILES, **(tiles or {}))
    (m, k), n = lhs.shape, dout.shape[1]
    walk = gmm_tile_walk(group_sizes.tolist(), m, k, n, t)
    out = torch.full((group_sizes.shape[0], k, n), float("nan"))
    for g, kt, nt in walk["drhs_order"]:
        start, end, chunks, _ = walk["groups"][g]
        ks = slice(kt * t["bm"], min(kt * t["bm"] + t["bm"], k))
        ns = slice(nt * t["bn"], min(nt * t["bn"] + t["bn"], n))
        acc = torch.zeros((ks.stop - ks.start, ns.stop - ns.start))
        for r0, r1 in chunks:
            a = _rows(lhs, r0, r1)[:, ks]
            a[max(0, end - r0):] = 0.0             # the tail: the next group's rows
            acc += a.t() @ _rows(dout, r0, r1)[:, ns]
        out[g, ks, ns] = acc
    return out.to(lhs.dtype)


def exact_topk_routing(logits: torch.Tensor, k: int):
    """Dropless router: softmax in fp32 -> top-k -> renormalised weights
    (HF Mixtral semantics).  Of equal probabilities the lower expert index
    ranks first, as in ``jax.lax.top_k``.  Returns (topi [T, k] int32,
    topw [T, k] fp32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topw = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    return topi.to(torch.int32), topw


def grouped_moe_ffn(x: torch.Tensor, topi: torch.Tensor, topw: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """x: [T, H]; topi/topw: [T, k] routing; w_gate/w_up: [E, H, F],
    w_down: [E, F, H].  Returns [T, H] in ``x.dtype``.  Tokens are sorted
    by expert and each expert multiplies only its own row block, so the
    work scales with k·T, not E·T."""
    t, h = x.shape
    e = w_gate.shape[0]
    k = topi.shape[1]
    flat_e = topi.reshape(-1).long()                      # [T*k]
    # the JAX package's stable counting sort by expert, as one stable sort:
    # order[j] = the (token, choice) pair at sorted row j
    group_sizes = (flat_e[:, None] == torch.arange(
        e, device=x.device)[None, :]).sum(dim=0, dtype=torch.int32)
    order = torch.sort(flat_e, stable=True).indices
    token_of = order // k
    xs = x[token_of]                                      # [T*k, H] sorted
    gate = gmm(xs, w_gate, group_sizes, use_kernel)
    up = gmm(xs, w_up, group_sizes, use_kernel)
    hmid = (F.silu(gate.float()) * up.float()).to(x.dtype)
    down = gmm(hmid, w_down, group_sizes, use_kernel)     # [T*k, H]
    wflat = topw.reshape(-1)[order].float()
    out = torch.zeros((t, h), dtype=torch.float32, device=x.device)
    out.index_add_(0, token_of, down.float() * wflat[:, None])
    return out.to(x.dtype)
