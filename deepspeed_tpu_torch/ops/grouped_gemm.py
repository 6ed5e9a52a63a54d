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

:func:`gmm` is the wrapper of the hand-written CUDA kernel in
``deepspeed_tpu_torch/csrc/grouped_gemm.cu`` (forward only: the gradient
kernels come with MoE training, ROADMAP A8).  For CUDA tensors it launches
the kernel at every M — the JAX package sends an M that is not a multiple
of its tile to the dense ``gmm_reference`` (``_use_kernel``); here the
kernel masks the ragged edge itself — or raises; for CPU tensors (and
``use_kernel=False``) it takes the plain version :func:`gmm_plain`.  The
kernel picks its own tiles: the JAX package's ``_pick_tiles`` is a TPU
VMEM budget and is not ported.  ``LAUNCHES`` counts the kernel launches.

:func:`grouped_moe_ffn` is the dropless top-k MoE FFN over a flat token
buffer: a stable sort of the ``T * k`` (token, expert) pairs by expert,
three grouped GEMMs (gate, up, down; SwiGLU) and an fp32 scatter-add
combine, with the JAX package's cast points.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import _build

#: kernel launches (plain calls do not count)
LAUNCHES = {"grouped_gemm": 0}

#: the kernel reads lhs and rhs in 16-byte vectors: K and N multiples of 8
_ALIGN = 8
#: rows of an m-tile: 16 for decode-sized M (each of the few work units
#: streams its group's weights once), 64 above
_SMALL_M = 64


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX package's
    ``gmm_reference``): each group's rows times its weight in fp32, rounded
    to ``lhs.dtype``; rows past the last group are zeros.  Reads the group
    sizes on the host."""
    m = lhs.shape[0]
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + int(size), m)
        if end > start:
            out[start:end] = lhs[start:end].float() @ rhs[e].float()
        start = end
    return out.to(lhs.dtype)


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        use_kernel: bool = True) -> torch.Tensor:
    """Grouped matmul, forward only: ``lhs [M, K]`` rows sorted by group
    times ``rhs [E, K, N]``; ``group_sizes [E]`` int32 sums to <= M.
    Returns ``[M, N]`` in ``lhs.dtype``.  No host sync on the kernel path:
    the group sizes stay on the device."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        raise NotImplementedError(
            "gmm is forward only in deepspeed_tpu_torch: its gradient "
            "kernels (_gmm_dlhs_kernel, _gmm_drhs_kernel) come with MoE "
            "training (ROADMAP A8, kernel B9 backward)")
    if not use_kernel or not lhs.is_cuda:
        return gmm_plain(lhs, rhs, group_sizes)
    return _launch(lhs, rhs, group_sizes)


def _launch(lhs, rhs, group_sizes):
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}")
    m, k = lhs.shape
    e, kr, n = rhs.shape
    for name, t in (("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"gmm: {name} is on {t.device}, lhs on "
                             f"{lhs.device}")
    if lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16 \
            or group_sizes.dtype != torch.int32:
        raise TypeError(
            f"gmm: the CUDA kernel takes bf16 lhs and rhs and int32 "
            f"group_sizes (got {lhs.dtype}, {rhs.dtype}, "
            f"{group_sizes.dtype}); use_kernel=False takes the plain path")
    if not (lhs.is_contiguous() and rhs.is_contiguous()
            and group_sizes.is_contiguous()):
        raise ValueError("gmm: lhs, rhs and group_sizes must be contiguous")
    if kr != k or group_sizes.shape[0] != e or e < 1 or k % _ALIGN \
            or n % _ALIGN:
        raise ValueError(
            f"gmm: the CUDA kernel takes lhs [M, K], rhs [E, K, N] and "
            f"group_sizes [E] with K and N multiples of {_ALIGN} (got lhs "
            f"{tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, group_sizes "
            f"{tuple(group_sizes.shape)})")
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("gmm: lhs and rhs must be 16-byte aligned (the "
                         "kernel reads them in 16-byte vectors)")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    tile_m = 16 if m <= _SMALL_M else 64
    with torch.cuda.device(lhs.device):      # the launch goes to lhs's GPU
        rc = _kernel()(lhs.data_ptr(), rhs.data_ptr(),
                       group_sizes.data_ptr(), out.data_ptr(), m, k, n, e,
                       tile_m, torch.cuda.current_stream(lhs.device)
                       .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gmm: CUDA kernel launch failed with error {rc}")
    LAUNCHES["grouped_gemm"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("grouped_gemm").dstt_grouped_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
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
