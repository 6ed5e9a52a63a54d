"""Flash attention with a hand-written backward, in the JAX package's three
layouts (counterpart of ``deepspeed_tpu/ops/flash_attention.py``).

:func:`flash_attention` (the ``"bshd"`` entry) takes q ``[B, Sq, H, D]``
and k / v ``[B, Sk, Hkv, D]`` (GQA when ``Hkv < H``) and returns ``[B, Sq,
H, D]``.  :func:`flash_attention_folded` and :func:`flash_attention_paired`
take the projection's own layout, q ``[B, Sq, H*D]`` and k / v ``[B, Sk,
Hkv*D]``, and return ``[B, Sq, H*D]``.  All three are one
``torch.autograd.Function`` mirroring the JAX package's ``custom_vjp``
(``flash_attention.py:436-458``): the forward pre-scales q once, rounds it
to the input type, and saves ``(q_scaled, k, v, o, lse)``; the backward runs
dQ (which also forms ``delta = rowsum(dO * O)``), then dK / dV: two
launches whose sums run in a fixed order, so two runs give the same bits.

On CUDA tensors the three steps are the hand-written Hopper kernels of
``deepspeed_tpu_torch/csrc/flash_attention.cu``: warp-specialised blocks
(one TMA producer warpgroup, one or two wgmma warpgroups of 64 rows; the
tiles are :data:`KERNEL_TILES`), bf16 or fp16 with a head dim of 64 or
128; anything else raises.  Each operand is read through a TMA tensor map
over its own row stride, so q, k and v may be column slices of one fused
projection output (GPT-2's ``c_attn``, Llama's ``qkv_proj``) and are never
copied; each row must start on 16 bytes.  The
folded and paired entries launch the same kernels (on Hopper there are no
lanes to fill by pairing heads: ``csrc/flash_attention.cu`` says why); each
keeps its own eligibility rule and its own launch counters.  On CPU tensors
the steps are the plain versions, :func:`flash_attention_plain_fwd` and
:func:`flash_attention_plain_bwd`: the same masking, pre-scaling and
rounding (P and dS rounded to the input type before their products) in fp32
math.  ``LAUNCHES`` counts the kernel launches by kernel and entry:
``flash_attention_fwd`` for the bshd entry, ``flash_attention_fwd_folded``
and ``flash_attention_fwd_paired`` for the others; :func:`last_launch_info`
reports the last launch's grid, tiles, registers and tensor-map cost.

:func:`flash_tile_walk` is the kernels' tile walk in plain Python (which
tiles each launch visits, which pay the mask, the launch order) and
:func:`flash_attention_tiled_plain` the kernels' arithmetic over it (online
softmax in exp2, P and dS rounded per tile, dK/dV summed over the GQA
group); the tests hold both to the mask and to the JAX kernels.

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

#: the entries, each with its own launch counters
ENTRIES = ("bshd", "folded", "paired")


def launch_key(kernel: str, entry: str = "bshd") -> str:
    """The ``LAUNCHES`` key of ``kernel`` ("fwd", "bwd_dq", "bwd_dkv")
    launched through ``entry``."""
    return f"flash_attention_{kernel}" + ("" if entry == "bshd"
                                          else f"_{entry}")


#: kernel launches per kernel and entry (plain CPU calls do not count)
LAUNCHES = {launch_key(k, e): 0 for e in ENTRIES
            for k in ("fwd", "bwd_dq", "bwd_dkv")}

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}


def _kernel_takes(q, k, v, head_dim) -> bool:
    """What the CUDA kernels take: bf16 or fp16 q/k/v of one type with a
    head dim of 64 or 128."""
    return (head_dim in _HEAD_DIMS and q.dtype in _DTYPES
            and k.dtype == v.dtype == q.dtype)


def _check_kernel_takes(name, q, k, v, head_dim):
    if not _kernel_takes(q, k, v, head_dim):
        raise ValueError(
            f"{name}: the CUDA kernel takes bf16 or fp16 q/k/v of one type "
            f"with head_dim in {_HEAD_DIMS} (got {q.dtype} "
            f"{tuple(q.shape)}, {k.dtype} {tuple(k.shape)})")


def flash_attention_usable(q, k, v) -> bool:
    """Whether the kernel path takes these inputs: whole GQA groups, and on
    CUDA a bf16/fp16 head dim of 64 or 128 (the plain version on the CPU
    takes any)."""
    if q.shape[2] % k.shape[2]:
        return False
    return not q.is_cuda or _kernel_takes(q, k, v, q.shape[-1])


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


#: the kernels' tiles by head dim (csrc/flash_attention.cu ``Tiles``), as
#: :func:`flash_tile_walk`'s ``(block_q, block_k)``: for the forward and
#: dQ, the q rows of a block (one or two warpgroups of 64, each masking
#: its own 64 rows) and the keys a step; for dK/dV, the q rows a step and
#: the keys of a block (one warpgroup)
KERNEL_TILES = {
    64: {"fwd": (64, 128), "bwd_dq": (64, 64), "bwd_dkv": (64, 64)},
    128: {"fwd": (128, 128), "bwd_dq": (128, 64), "bwd_dkv": (32, 64)},
}
#: rows of one warpgroup's tile, the granularity of the mask decision
MASK_ROWS = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _k_tiles(sq, sk, causal, window, r0, r1, bk):
    """The k tiles [begin, end) of ``bk`` keys that rows [r0, r1) see
    (``k_tiles`` in the kernels)."""
    off = sk - sq
    begin, end = 0, _cdiv(sk, bk)
    if not causal:
        return begin, end
    hi = r1 - 1 + off                       # the last key row r1 - 1 sees
    end = 0 if hi < 0 else min(end, hi // bk + 1)
    lo = r0 + off - (window or 0) + 1       # the first key row r0 sees
    if window and lo > 0:
        begin = lo // bk
    return begin, end


def _q_tiles(sq, sk, causal, window, c0, c1, bq):
    """The q tiles [begin, end) of ``bq`` rows whose rows see keys [c0, c1)
    (``q_tiles`` in the kernels)."""
    off = sk - sq
    begin, end = 0, _cdiv(sq, bq)
    if not causal:
        return begin, end
    lo = c0 - off                           # the first row that sees key c0
    if lo > 0:
        begin = min(lo // bq, end)
    if window:
        hi = c1 - 1 - off + window - 1      # the last row that sees key c1 - 1
        end = 0 if hi < 0 else min(end, hi // bq + 1)
    return begin, end


def _whole_tile(sq, sk, causal, window, r0, nr, c0, nc) -> bool:
    """Whether every (row, key) of rows [r0, r0 + nr) x keys [c0, c0 + nc)
    is visible and in range (``whole_tile`` in the kernels): such a tile
    skips the per-score mask."""
    if r0 + nr > sq or c0 + nc > sk:
        return False
    if not causal:
        return True
    off = sk - sq
    return (r0 + off >= c0 + nc - 1
            and (not window or c0 > r0 + nr - 1 + off - window))


def flash_tile_walk(sq: int, sk: int, causal: bool, window: Optional[int],
                    block_q: int, block_k: int) -> dict:
    """The kernels' tile walk, in plain Python (``csrc/flash_attention.cu``
    mirrors it): which tiles a launch visits, which of them pay the mask,
    and in which order the tiles are launched.

    * ``"q"``: for the forward and dQ, one entry per q tile of
      ``block_q`` rows, ``(r0, r1, begin, end, whole)``: its rows [r0, r1)
      (r1 <= Sq), the k tiles [begin, end) of ``block_k`` keys it visits,
      and for each of them whether the tile of rows x keys is whole (no
      mask);
    * ``"k"``: for dK/dV, one entry per k tile of ``block_k`` keys,
      ``(c0, c1, begin, end, whole)``: its keys, the q tiles of
      ``block_q`` rows it visits (for each query head of the GQA group),
      and whether each is whole;
    * ``"q_order"`` / ``"k_order"``: the order in which the blocks are
      launched, the causal tiles that do the most work first (the last q
      tile first; the first k tile first).

    A forward or dQ block of the kernels walks ``"q"`` at its 128 rows
    and decides the mask per 64-row warpgroup, as the walk at
    ``block_q = 64`` gives it (:data:`KERNEL_TILES`, :data:`MASK_ROWS`).
    """
    window = window or None
    q_walk = []
    for r0 in range(0, sq, block_q):
        r1 = min(r0 + block_q, sq)
        begin, end = _k_tiles(sq, sk, causal, window, r0, r1, block_k)
        q_walk.append((r0, r1, begin, end, [
            _whole_tile(sq, sk, causal, window, r0, block_q, j * block_k,
                        block_k) for j in range(begin, end)]))
    k_walk = []
    for c0 in range(0, sk, block_k):
        c1 = min(c0 + block_k, sk)
        begin, end = _q_tiles(sq, sk, causal, window, c0, c1, block_q)
        k_walk.append((c0, c1, begin, end, [
            _whole_tile(sq, sk, causal, window, i * block_q, block_q, c0,
                        block_k) for i in range(begin, end)]))
    return {"q": q_walk, "k": k_walk,
            "q_order": list(range(len(q_walk)))[::-1],
            "k_order": list(range(len(k_walk)))}


def flash_attention_tiled_plain(qs, k, v, do=None, *, causal: bool = True,
                                window: Optional[int] = None,
                                block_q: int = 128, block_k: int = 128):
    """The kernels' arithmetic over :func:`flash_tile_walk`'s tiles, in
    plain PyTorch: the forward's online softmax in fp32 (exp2, the running
    max in log2 units), P rounded to the input type before P V, the mask
    only on tiles that are not whole; with ``do``, dK/dV as the dK/dV
    launch forms them, P^T and dS^T rounded before their products, each KV
    head's gradient summed over its query heads in fp32 and rounded once.
    Returns ``(o, lse)``, or ``(o, lse, dk, dv)`` with ``do`` (delta is
    rowsum(dO * O) of the rounded o).  For the tests: the main path runs
    the kernels (CUDA) or the dense plain versions (CPU)."""
    b, sq, h, d = qs.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dtype = qs.dtype
    log2e = 1.0 / math.log(2.0)
    walk = flash_tile_walk(sq, sk, causal, window, block_q, block_k)
    keep = _keep(sq, sk, causal, window, qs.device)
    qf = qs.float().transpose(1, 2)                     # [B, H, Sq, D]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)

    def rnd(x):
        return x.to(dtype).float()

    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qs.device)
    lse = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                     device=qs.device)
    for r0, r1, begin, end, whole in walk["q"]:
        m = torch.full((b, h, r1 - r0), NEG_INF, device=qs.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, r1 - r0, d), device=qs.device)
        for j, is_whole in zip(range(begin, end), whole):
            c0, c1 = j * block_k, min((j + 1) * block_k, sk)
            s = qf[:, :, r0:r1] @ kf[:, :, c0:c1].transpose(-1, -2)
            if not is_whole:
                s = s.masked_fill(~keep[r0:r1, c0:c1], float("-inf"))
            m_new = torch.maximum(m, s.amax(-1) * log2e)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * log2e - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + rnd(p) @ vf[:, :, c0:c1]
            m = m_new
        safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, r0:r1] = acc / safe[..., None]
        lse[:, :, r0:r1] = torch.where(l == 0, torch.full_like(l, NEG_INF),
                                       m * math.log(2.0) + torch.log(safe))
    o = o.transpose(1, 2).to(dtype)
    if do is None:
        return o, lse
    dof = do.float().transpose(1, 2)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, H, Sq]
    dk = torch.zeros((b, hkv, sk, d), device=qs.device)
    dv = torch.zeros_like(dk)
    for c0, c1, begin, end, whole in walk["k"]:
        for hq in range(g):                 # the group's heads, in order
            heads = slice(hq, h, g)         # head kh * g + hq of each KV head
            for i, is_whole in zip(range(begin, end), whole):
                r0, r1 = i * block_q, min((i + 1) * block_q, sq)
                kk, qq = kf[:, heads, c0:c1], qf[:, heads, r0:r1]
                st = kk @ qq.transpose(-1, -2)                 # [B, Hkv, keys, rows]
                p = torch.exp2(st * log2e
                               - lse[:, heads, None, r0:r1] * log2e)
                if not is_whole:
                    p = p.masked_fill(~keep[r0:r1, c0:c1].T, 0.0)
                dpt = vf[:, heads, c0:c1] @ dof[:, heads, r0:r1].transpose(
                    -1, -2)
                ds = p * (dpt - delta[:, heads, None, r0:r1])
                dv[:, :, c0:c1] += rnd(p) @ dof[:, heads, r0:r1]
                dk[:, :, c0:c1] += rnd(ds) @ qq
    return (o, lse, dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bshd_rows(t) -> bool:
    """Whether ``t`` [B, S, H, D] is laid out as the kernels read it: each
    head's D values contiguous at offset h * D of a row, and the batch
    stride S times the row stride."""
    b, s, h, d = t.shape
    return (t.stride(3) == 1 and (h == 1 or t.stride(2) == d)
            and (b == 1 or t.stride(0) == s * t.stride(1)))


def _rows(t):
    """``t`` itself when the kernels can read it in place (any row
    stride), else a contiguous copy (a transposed view, say)."""
    return t if _bshd_rows(t) else t.contiguous()


def _aligned(t) -> bool:
    """Every row of ``t`` starts on 16 bytes (base pointer and row
    stride), as the kernels' TMA loads need."""
    return (t.data_ptr() % 16 == 0
            and (t.shape[1] == 1 or t.stride(1) * t.element_size() % 16 == 0))


def _check(name, operands, stats, head_dim):
    """``operands`` are [B, S, H, D] (any 16-byte aligned row stride),
    ``stats`` the fp32 [B, H, Sq] lse / delta (contiguous)."""
    ref = operands[0]
    for t in operands + stats:
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and {ref.device}")
    for t in operands:
        if not _bshd_rows(t):
            raise ValueError(
                f"{name}: a [B, S, H, D] operand must hold each head's D "
                f"values contiguous at offset h * D of its row, with the "
                f"batch stride S times the row stride (strides "
                f"{t.stride()})")
        if not _aligned(t):
            raise ValueError(
                f"{name}: every row must start on 16 bytes (base pointer "
                f"{t.data_ptr()} and row stride {t.stride(1)} elements of "
                f"{t.element_size()} bytes): the kernel reads rows by "
                f"TMA")
    for t in stats:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: lse / delta must be contiguous")
    _check_kernel_takes(name, *operands[:3], head_dim)


def _strides(**named):
    """The kernels' row strides (q, k, v, o, dout, dq, dk, dv), 0 for the
    tensors a kernel does not take."""
    order = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")
    return (ctypes.c_longlong * 8)(*(named[n].stride(1) if n in named else 0
                                     for n in order))


def flash_attention_fwd(qs, k, v, causal: bool = True,
                        window: Optional[int] = None, entry: str = "bshd"):
    """Forward kernel wrapper: ``qs`` pre-scaled q [B,Sq,H,D], k/v
    [B,Sk,Hkv,D], each with any 16-byte aligned row stride.  Returns
    ``(o, lse)``, o contiguous.  ``entry`` names the counter the launch
    adds to."""
    if not qs.is_cuda:
        return flash_attention_plain_fwd(qs, k, v, causal=causal,
                                         window=window)
    b, sq, h, d = qs.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check("flash_attention", [qs, k, v], [], d)
    o = torch.empty((b, sq, h, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    if b * sq == 0:
        return o, lse
    _launch("fwd", "flash_attention forward", entry, qs,
            [qs, k, v, o, lse], [b, sq, sk, h, hkv, int(causal), window or 0],
            [], _strides(q=qs, k=k, v=v, o=o))
    return o, lse


def _launch(name, label, entry, ref, ptrs, ints, floats, strides):
    with torch.cuda.device(ref.device):
        rc = _kernel(name)(_DTYPES[ref.dtype], ref.shape[-1],
                           *(t.data_ptr() for t in ptrs), *ints, *floats,
                           strides, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{label}: CUDA kernel launch failed with error "
                           f"{rc}")
    LAUNCHES[launch_key(name, entry)] += 1


def flash_attention_bwd_dq(qs, k, v, o, do, lse, scale: float,
                           causal: bool = True,
                           window: Optional[int] = None, entry: str = "bshd"):
    """dQ kernel wrapper: the residuals of :func:`flash_attention_fwd` and
    dO -> ``(dq [B,Sq,H,D], delta fp32 [B,H,Sq])``; the kernel forms
    delta = rowsum(dO * O) for its rows and writes it for dK/dV."""
    if not qs.is_cuda:
        return flash_attention_plain_bwd_dq(qs, k, v, o, do, lse,
                                            scale=scale, causal=causal,
                                            window=window)
    b, sq, h, d = qs.shape
    _check("flash_attention dQ", [qs, k, v, o, do], [lse], d)
    dq = torch.empty((b, sq, h, d), dtype=qs.dtype, device=qs.device)
    delta = torch.empty_like(lse)
    _launch("bwd_dq", "flash_attention dQ", entry, qs,
            [qs, k, v, o, do, lse, delta, dq],
            [b, sq, k.shape[1], h, k.shape[2], int(causal), window or 0],
            [scale], _strides(q=qs, k=k, v=v, o=o, dout=do, dq=dq))
    return dq, delta


def flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal: bool = True,
                            window: Optional[int] = None,
                            entry: str = "bshd"):
    """dK/dV kernel wrapper: the residuals, dO and the dQ kernel's delta
    -> (dk, dv) [B,Sk,Hkv,D] contiguous, each KV head's gradient summed
    over its query heads in fp32 inside the kernel."""
    if not qs.is_cuda:
        return flash_attention_plain_bwd_dkv(qs, k, v, do, lse, delta,
                                             causal=causal, window=window)
    b, sq, h, d = qs.shape
    _check("flash_attention dK/dV", [qs, k, v, do], [lse, delta], d)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("bwd_dkv", "flash_attention dK/dV", entry, qs,
            [qs, k, v, do, lse, delta, dk, dv],
            [b, sq, k.shape[1], h, k.shape[2], int(causal), window or 0],
            [], _strides(q=qs, k=k, v=v, dout=do, dk=dk, dv=dv))
    return dk, dv


def flash_attention_bwd(qs, k, v, o, lse, do, scale: float,
                        causal: bool = True, window: Optional[int] = None,
                        entry: str = "bshd"):
    """The backward: the dQ kernel (which also forms delta), then the
    dK/dV kernel (their plain versions on the CPU).  Returns ``(dq, dk,
    dv)``."""
    dq, delta = flash_attention_bwd_dq(qs, k, v, o, do, lse, scale, causal,
                                       window, entry)
    return (dq,) + flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal,
                                           window, entry)


class _FlashAttention(torch.autograd.Function):
    """The three entries' one autograd function on [B, S, H, D] operands
    (the folded entries pass views): k and v are kept as they come, in
    place in the projection's output."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, use_kernel, entry):
        # fold the softmax scale into q once, rounded to the input type
        qs = _rows((q.float() * scale).to(q.dtype))
        k, v = _rows(k), _rows(v)
        if use_kernel:
            o, lse = flash_attention_fwd(qs, k, v, causal, window, entry)
        else:
            o, lse = flash_attention_plain_fwd(qs, k, v, causal=causal,
                                               window=window)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.args = (scale, causal, window, use_kernel, entry)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        scale, causal, window, use_kernel, entry = ctx.args
        do = _rows(do)
        if use_kernel:
            grads = flash_attention_bwd(qs, k, v, o, lse, do, scale, causal,
                                        window, entry)
        else:
            grads = flash_attention_plain_bwd(qs, k, v, o, lse, do,
                                              scale=scale, causal=causal,
                                              window=window)
        return grads + (None,) * 5


def _check_mask_window(name, mask, causal, window):
    if mask is not None:
        raise NotImplementedError(
            f"{name} supports causal/full (+sliding window) only; use "
            f"ops.attention.dot_product_attention for custom masks")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


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
    _check_mask_window("flash_attention", mask, causal, window)
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"GQA needs H % Hkv == 0, got {q.shape[2]} % "
                         f"{k.shape[2]}")
    if use_kernel and q.is_cuda:
        _check_kernel_takes("flash_attention", q, k, v, q.shape[-1])
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 int(window) if window is not None else None,
                                 bool(use_kernel), "bshd")


# ===================================================================== #
# The folded and paired entries: q [B, Sq, H*D], k / v [B, Sk, Hkv*D]
# ===================================================================== #
# On the TPU the folded kernels consume the projection's [B, S, H*D] output
# without the BSHD <-> BHSD transposes, in grid steps of ``hb`` heads whose
# lanes form whole 128-lane tiles, and the paired kernels pack 128/d heads
# into one MXU tile at d < 128.  Here both launch the strided kernels above
# on free [B, S, H, D] views; the geometry rules below are the JAX
# package's, verbatim, because they are public and decide the routing.

_FOLDED_MAX_HEADS_PER_BLOCK = 8
_PAIRED_MAX_HEADS_PER_BLOCK = 8


def folded_heads_per_block(num_heads: int, num_kv_heads: int,
                           head_dim: int) -> Optional[int]:
    """Query heads per grid step for the folded layout, or None when the
    geometry has no lane-aligned grouping (``flash_attention.py:521``).

    d % 128 == 0: singleton blocks.  Otherwise a group of ``m =
    128/gcd(d,128)`` heads spans whole lane tiles; the group is widened to
    ``m * g`` so the KV heads it touches also form whole tiles (g = GQA
    group size)."""
    d, h, hkv = head_dim, num_heads, num_kv_heads
    if d % 8 != 0 or h % hkv != 0:
        return None
    if d % 128 == 0:
        return 1
    m = 128 // math.gcd(d, 128)
    hb = m * (h // hkv)
    if hb > _FOLDED_MAX_HEADS_PER_BLOCK or h % hb != 0:
        return None
    return hb


def paired_heads_per_block(num_heads: int, num_kv_heads: int,
                           head_dim: int) -> Optional[int]:
    """Query heads per grid step for the head-paired layout, or None when
    pairing does not apply (``flash_attention.py:1028``): it needs ``d <
    128`` with ``128 % d == 0`` and a head count divisible by ``hb = m *
    g`` (m = 128/d, g = GQA group size)."""
    d, h, hkv = head_dim, num_heads, num_kv_heads
    if d % 8 != 0 or d >= 128 or 128 % d != 0 or h % hkv != 0:
        return None
    g = h // hkv
    m = 128 // d
    hb = m * g
    if hb > _PAIRED_MAX_HEADS_PER_BLOCK or h % hb != 0:
        return None
    return hb


def _layout_usable(rule, q, k, v, num_heads, num_kv_heads, mask) -> bool:
    """The JAX package's shape rules and heads-per-block clause; on CUDA
    also what the kernel takes (bf16 / fp16 of one type, head dim 64 or
    128, 16-byte aligned rows) in place of the TPU's clauses."""
    if mask is not None:
        return False
    if q.dim() != 3 or q.shape[-1] % num_heads or \
            k.shape[-1] % num_kv_heads:
        return False
    d = q.shape[-1] // num_heads
    if k.shape[-1] // num_kv_heads != d:
        return False
    if rule(num_heads, num_kv_heads, d) is None:
        return False
    if not q.is_cuda:
        return True
    return _kernel_takes(q, k, v, d) and all(
        t.is_cuda and t.stride(-1) == 1 and _aligned(t) for t in (q, k, v))


def flash_attention_folded_usable(q, k, v, num_heads, num_kv_heads,
                                  causal, mask) -> bool:
    """Folded-entry eligibility for the auto path
    (``flash_attention.py:545``)."""
    return _layout_usable(folded_heads_per_block, q, k, v, num_heads,
                          num_kv_heads, mask)


def flash_attention_paired_usable(q, k, v, num_heads, num_kv_heads,
                                  causal, mask) -> bool:
    """Paired-entry eligibility for the auto path
    (``flash_attention.py:1051``)."""
    return _layout_usable(paired_heads_per_block, q, k, v, num_heads,
                          num_kv_heads, mask)


def _layout_attention(entry, rule, q, k, v, num_heads, num_kv_heads, causal,
                      mask, scale, window, block_q, block_k, use_kernel):
    name = f"flash_attention_{entry}"
    _check_mask_window(name, mask, causal, window)
    hkv = num_kv_heads if num_kv_heads is not None else num_heads
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{entry} layout expects rank-3 [B, S, H*D] inputs")
    b, sq, hd = q.shape
    _, sk, kvd = k.shape
    if num_heads % hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got {num_heads} % {hkv}")
    if hd % num_heads or kvd % hkv:
        raise ValueError(
            f"{entry} widths ({hd}, {kvd}) must be divisible by their head "
            f"counts ({num_heads}, {hkv})")
    d = hd // num_heads
    if kvd // hkv != d:
        raise ValueError(f"q head_dim {d} != kv head_dim {kvd // hkv}")
    if rule(num_heads, hkv, d) is None:
        what, alt = (("lane-full head pairing",
                      "flash_attention_folded (d >= 128) or ")
                     if entry == "paired"
                     else ("lane-aligned head grouping", ""))
        raise ValueError(f"no {what} for H={num_heads} Hkv={hkv} d={d}; "
                         f"use {alt}the [B,S,H,D] flash_attention path")
    # the TPU's tiles; the CUDA kernels take any S, so only blocks a caller
    # names are checked
    for n, blk in ((sq, block_q), (sk, block_k)):
        if blk is not None and (blk <= 0 or n % blk):
            raise ValueError(
                f"seq lengths ({sq},{sk}) must divide blocks "
                f"({block_q},{block_k})")
    if use_kernel and q.is_cuda:
        _check_kernel_takes(name, q, k, v, d)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = _FlashAttention.apply(
        q.unflatten(-1, (num_heads, d)), k.unflatten(-1, (hkv, d)),
        v.unflatten(-1, (hkv, d)), float(scale), bool(causal),
        int(window) if window is not None else None, bool(use_kernel), entry)
    return out.flatten(2)


def flash_attention_folded(q, k, v, *, num_heads: int,
                           num_kv_heads: Optional[int] = None,
                           causal: bool = True, mask=None,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           block_q: Optional[int] = None,
                           block_k: Optional[int] = None,
                           interpret: Optional[bool] = None,
                           use_kernel: bool = True):
    """Layout-native flash attention (``flash_attention.py:943``).  q:
    [B,Sq,H*D]; k/v: [B,Sk,Hkv*D], each with any 16-byte aligned row
    stride (slices of one fused projection output are read in place);
    returns [B,Sq,H*D].  Semantics (causal / sliding ``window`` / GQA /
    ``scale``) match :func:`flash_attention` exactly.  ``block_q`` /
    ``block_k`` are checked as the JAX package checks them and otherwise
    unused, ``interpret`` unused (the TPU's tiling and interpreter)."""
    del interpret
    return _layout_attention("folded", folded_heads_per_block, q, k, v,
                             num_heads, num_kv_heads, causal, mask, scale,
                             window, block_q, block_k, use_kernel)


def flash_attention_paired(q, k, v, *, num_heads: int,
                           num_kv_heads: Optional[int] = None,
                           causal: bool = True, mask=None,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           block_q: Optional[int] = None,
                           block_k: Optional[int] = None,
                           interpret: Optional[bool] = None,
                           use_kernel: bool = True):
    """Head-paired flash attention (``flash_attention.py:1523``): the
    folded entry's layout and semantics for geometries that
    :func:`paired_heads_per_block` pairs; it launches the same kernels
    and counts them under its own name."""
    del interpret
    return _layout_attention("paired", paired_heads_per_block, q, k, v,
                             num_heads, num_kv_heads, causal, mask, scale,
                             window, block_q, block_k, use_kernel)


_INFO_KEYS = ("blocks", "threads", "smem_bytes", "block_rows", "step_rows",
              "stages", "registers", "local_bytes", "encode_us")


def last_launch_info() -> dict:
    """What the library's last kernel launch was (for reports): its
    blocks, threads a block, dynamic shared memory, the rows of a block's
    tile (q rows, or keys for dK/dV) and of a step's tile (keys, or q rows
    for dK/dV), ring stages, registers a thread at launch, local memory a
    thread (spills), and the host us spent encoding its TMA tensor maps."""
    fn = _build.load("flash_attention").dstt_flash_launch_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_INFO_KEYS))()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch info: CUDA error {rc}")
    info = dict(zip(_INFO_KEYS, out))
    info["encode_us"] = info["encode_us"] / 1e3
    return info


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(_build.load("flash_attention"), f"dstt_flash_{name}")
    n_ptr = {"fwd": 5, "bwd_dq": 8, "bwd_dkv": 8}[name]
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr
                   + [ctypes.c_int] * 7
                   + ([ctypes.c_float] if name == "bwd_dq" else [])
                   + [ctypes.POINTER(ctypes.c_longlong),   # row strides
                      ctypes.c_void_p])                     # the stream
    fn.restype = ctypes.c_int
    return fn
