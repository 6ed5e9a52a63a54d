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
:func:`gmm_dlhs` and :func:`gmm_drhs`.  For CUDA tensors each is
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

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import _build

#: kernel launches (plain calls do not count)
LAUNCHES = {"grouped_gemm": 0, "grouped_gemm_dlhs": 0,
            "grouped_gemm_drhs": 0}

#: the kernels read their operands in 16-byte vectors: K and N multiples
#: of 8
_ALIGN = 8
#: rows of an m-tile: 16 for decode-sized M (each of the few work units
#: streams its group's weights once), 64 above
_SMALL_M = 64


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
             out.data_ptr(), m, k, n, e, 16 if m <= _SMALL_M else 64)
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
             out.data_ptr(), m, k, n, e, 16 if m <= _SMALL_M else 64)
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
    ints = 4 if symbol == "dstt_grouped_gemm_drhs_bf16" else 5
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
