"""Flash attention with a hand-written backward (counterpart of the bshd
entry ``flash_attention`` of ``deepspeed_tpu/ops/flash_attention.py``).

:func:`flash_attention` takes q ``[B, Sq, H, D]`` and k / v
``[B, Sk, Hkv, D]`` (GQA when ``Hkv < H``) and returns ``[B, Sq, H, D]``.
It is a ``torch.autograd.Function`` mirroring the JAX package's
``custom_vjp`` (``flash_attention.py:436-458``): the forward pre-scales q
once, rounds it to the input type, and saves ``(q_scaled, k, v, o, lse)``;
the backward runs dQ (which also forms ``delta = rowsum(dO * O)``), then
dK / dV.

On CUDA tensors the three steps are the hand-written kernels of
``deepspeed_tpu_torch/csrc/flash_attention.cu`` (forward, dQ, dK/dV), which
take bf16 or fp16 with a head dim of 64 or 128 and raise on anything else.
On CPU tensors they are the plain versions, :func:`flash_attention_plain_fwd`
and :func:`flash_attention_plain_bwd`: the same masking, pre-scaling and
rounding (P and dS rounded to the input type before their products) in fp32
math.  ``LAUNCHES`` counts the kernel launches.

Masking is end-aligned causal (row ``r`` sees column ``c`` when
``r + Sk - Sq >= c``), optionally limited to the last ``window`` columns.
A row that sees no column (``Sq > Sk``) comes out as zeros with
``lse = -1e30``; the TPU kernels give such a row the mean of v when it
shares a tile with a row that sees something.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import _build

#: kernel launches per kernel (plain CPU calls do not count)
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def flash_attention_usable(q, k, v) -> bool:
    """Whether the kernel path takes these inputs: whole GQA groups, and on
    CUDA a bf16/fp16 head dim of 64 or 128 (the plain version on the CPU
    takes any)."""
    if q.shape[2] % k.shape[2]:
        return False
    if not q.is_cuda:
        return True
    return (q.shape[-1] in _HEAD_DIMS and q.dtype in _DTYPES
            and k.dtype == v.dtype == q.dtype)


def _keep(sq: int, sk: int, causal: bool, window: Optional[int], device):
    """[Sq, Sk] bool: the visible (row, column) pairs."""
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=device)[None, :]
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    keep = rows >= cols
    if window is not None:
        keep &= cols > rows - window
    return keep


def _scores(qs, k, keep):
    """fp32 scores [B, H, Sq, Sk] of pre-scaled q against k (k repeated
    over each GQA group), -inf where not kept."""
    g = qs.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kr)
    return s.masked_fill(~keep, float("-inf"))


def flash_attention_plain_fwd(qs, k, v, *, causal: bool = True,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: ``qs`` is the
    pre-scaled q.  Returns ``o`` [B, Sq, H, D] in ``qs.dtype`` and ``lse``
    fp32 [B, H, Sq]."""
    b, sq, h, d = qs.shape
    sk = k.shape[1]
    keep = _keep(sq, sk, causal, window, qs.device)
    s = _scores(qs, k, keep)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    g = h // k.shape[2]
    vr = v.float().repeat_interleave(g, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(qs.dtype).float(), vr)
    o = o / safe_l.permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l)).squeeze(-1)
    return o.to(qs.dtype), lse


def _bwd_probs(qs, k, v, do, lse, delta, causal, window):
    """p and ds = p (dp - delta), fp32 [B, H, Sq, Sk], and the repeated
    fp32 k."""
    g = qs.shape[2] // k.shape[2]
    keep = _keep(qs.shape[1], k.shape[1], causal, window, qs.device)
    s = _scores(qs, k, keep)
    p = torch.exp(s - lse[..., None])                 # 0 where not kept
    vr = v.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    return p, p * (dp - delta[..., None])


def flash_attention_plain_bwd_dq(qs, k, v, o, do, lse, *, scale: float,
                                 causal: bool = True,
                                 window: Optional[int] = None):
    """The dQ kernel's function in plain PyTorch: ``(dq, delta)``, dS
    rounded to the input type before its product with k; delta =
    rowsum(dO * O) fp32 [B, H, Sq] (the JAX package forms it in XLA,
    flash_attention.py:361)."""
    g = qs.shape[2] // k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds = _bwd_probs(qs, k, v, do, lse, delta, causal, window)
    kr = k.float().repeat_interleave(g, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(qs.dtype).float(), kr)
    return (dq * scale).to(qs.dtype), delta


def flash_attention_plain_bwd_dkv(qs, k, v, do, lse, delta, *,
                                  causal: bool = True,
                                  window: Optional[int] = None):
    """The dK/dV kernel's function in plain PyTorch (P and dS rounded to
    the input type before their products), summed over each GQA group."""
    b, sq, h, d = qs.shape
    sk, hkv = k.shape[1], k.shape[2]
    p, ds = _bwd_probs(qs, k, v, do, lse, delta, causal, window)
    dtype = qs.dtype
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dtype).float(), qs.float())
    return (dk.reshape(b, sk, hkv, h // hkv, d).sum(3).to(k.dtype),
            dv.reshape(b, sk, hkv, h // hkv, d).sum(3).to(v.dtype))


def flash_attention_plain_bwd(qs, k, v, o, lse, do, *, scale: float,
                              causal: bool = True,
                              window: Optional[int] = None):
    """Both backward kernels' functions in plain PyTorch: ``(dq, dk,
    dv)``."""
    dq, delta = flash_attention_plain_bwd_dq(qs, k, v, o, do, lse,
                                             scale=scale, causal=causal,
                                             window=window)
    return (dq,) + flash_attention_plain_bwd_dkv(
        qs, k, v, do, lse, delta, causal=causal, window=window)


def _check(name, tensors, head_dim):
    ref = tensors[0]
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
        if t.data_ptr() % 16 or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                             f"aligned (the kernel reads 16-byte vectors)")
    if head_dim not in _HEAD_DIMS or ref.dtype not in _DTYPES or any(
            t.dtype != ref.dtype for t in tensors[1:4]):
        raise ValueError(
            f"{name}: the CUDA kernel takes bf16 or fp16 q/k/v of one type "
            f"with head_dim in {_HEAD_DIMS} (got {ref.dtype}, head_dim "
            f"{head_dim})")


def flash_attention_fwd(qs, k, v, causal: bool = True,
                        window: Optional[int] = None):
    """Forward kernel wrapper: ``qs`` pre-scaled q [B,Sq,H,D], k/v
    [B,Sk,Hkv,D] contiguous.  Returns ``(o, lse)``."""
    if not qs.is_cuda:
        return flash_attention_plain_fwd(qs, k, v, causal=causal,
                                         window=window)
    b, sq, h, d = qs.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check("flash_attention", (qs, k, v), d)
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    if b * sq == 0:
        return o, lse
    _launch("fwd", "flash_attention forward", _DTYPES[qs.dtype], d, qs, k, v,
            o, lse, b, sq, sk, h, hkv, int(causal), window or 0)
    return o, lse


def _launch(name, label, *args):
    with torch.cuda.device(args[2].device):
        rc = _kernel(name)(*(a.data_ptr() if isinstance(a, torch.Tensor)
                             else a for a in args),
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{label}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[f"flash_attention_{name}"] += 1


def flash_attention_bwd_dq(qs, k, v, o, do, lse, scale: float,
                           causal: bool = True,
                           window: Optional[int] = None):
    """dQ kernel wrapper: the residuals of :func:`flash_attention_fwd` and
    dO -> ``(dq [B,Sq,H,D], delta fp32 [B,H,Sq])``; the kernel forms
    delta = rowsum(dO * O) for its rows and writes it for dK/dV."""
    if not qs.is_cuda:
        return flash_attention_plain_bwd_dq(qs, k, v, o, do, lse,
                                            scale=scale, causal=causal,
                                            window=window)
    b, sq, h, d = qs.shape
    _check("flash_attention dQ", (qs, k, v, o, do, lse), d)
    dq = torch.empty_like(qs)
    delta = torch.empty_like(lse)
    _launch("bwd_dq", "flash_attention dQ", _DTYPES[qs.dtype], d, qs, k, v,
            o, do, lse, delta, dq, b, sq, k.shape[1], h, k.shape[2],
            int(causal), window or 0, scale)
    return dq, delta


def flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal: bool = True,
                            window: Optional[int] = None):
    """dK/dV kernel wrapper: the residuals, dO and the dQ kernel's delta
    -> (dk, dv) [B,Sk,Hkv,D], each KV head's gradient summed over its
    query heads inside the kernel."""
    if not qs.is_cuda:
        return flash_attention_plain_bwd_dkv(qs, k, v, do, lse, delta,
                                             causal=causal, window=window)
    b, sq, h, d = qs.shape
    _check("flash_attention dK/dV", (qs, k, v, do, lse, delta), d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_dkv", "flash_attention dK/dV", _DTYPES[qs.dtype], d, qs, k,
            v, do, lse, delta, dk, dv, b, sq, k.shape[1], h, k.shape[2],
            int(causal), window or 0)
    return dk, dv


def flash_attention_bwd(qs, k, v, o, lse, do, scale: float,
                        causal: bool = True, window: Optional[int] = None):
    """The backward: the dQ kernel (which also forms delta), then the
    dK/dV kernel (their plain versions on the CPU).  Returns ``(dq, dk,
    dv)``."""
    do = do.contiguous()
    dq, delta = flash_attention_bwd_dq(qs, k, v, o, do, lse, scale, causal,
                                       window)
    return (dq,) + flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal,
                                           window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, use_kernel):
        # fold the softmax scale into q once, rounded to the input type
        qs = (q.float() * scale).to(q.dtype).contiguous()
        k, v = k.contiguous(), v.contiguous()
        if use_kernel:
            o, lse = flash_attention_fwd(qs, k, v, causal, window)
        else:
            o, lse = flash_attention_plain_fwd(qs, k, v, causal=causal,
                                               window=window)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.args = (scale, causal, window, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        scale, causal, window, use_kernel = ctx.args
        if use_kernel:
            grads = flash_attention_bwd(qs, k, v, o, lse, do, scale, causal,
                                        window)
        else:
            grads = flash_attention_plain_bwd(qs, k, v, o, lse, do,
                                              scale=scale, causal=causal,
                                              window=window)
        return grads + (None,) * 4


def flash_attention(q, k, v, *, causal: bool = True, mask=None,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Flash attention.  q: [B,Sq,H,D]; k/v: [B,Sk,Hkv,D]; returns
    [B,Sq,H,D].  ``window`` (requires ``causal``) restricts each query to
    the previous ``window`` keys; tiles outside the band are skipped.
    On CUDA the kernels run (or the call raises); on the CPU the plain
    versions.  ``use_kernel=False`` takes the plain versions on any device
    (the on-card comparison path)."""
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports causal/full (+sliding window) only; "
            "use ops.attention.dot_product_attention for custom masks")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"GQA needs H % Hkv == 0, got {q.shape[2]} % "
                         f"{k.shape[2]}")
    if use_kernel and q.is_cuda and not flash_attention_usable(q, k, v):
        raise ValueError(
            f"flash_attention: the CUDA kernel takes bf16 or fp16 q/k/v of "
            f"one type with head_dim in {_HEAD_DIMS} (got {q.dtype} "
            f"{tuple(q.shape)}, {k.dtype} {tuple(k.shape)})")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window) if window is not None else None,
                                 bool(use_kernel))


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("flash_attention"), f"dstt_flash_{name}")
    n_ptr = {"fwd": 5, "bwd_dq": 8, "bwd_dkv": 8}[name]
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * 7
                   + ([ctypes.c_float] if name == "bwd_dq" else [])
                   + [ctypes.c_void_p])    # the stream
    fn.restype = ctypes.c_int
    return fn
