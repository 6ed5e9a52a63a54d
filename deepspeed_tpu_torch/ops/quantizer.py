"""Groupwise quantization (counterpart of ``deepspeed_tpu/ops/quantizer.py``;
reference: csrc/quantization/{quantize,dequantize,quant_reduce,
swizzled_quantize,quantize_intX,fake_quantizer}.cu, exposed through
deepspeed/ops/quantizer and op_builder/quantizer.py).

The same names, signatures and numbers as the JAX package, on torch tensors:

* **symmetric** int8/int4: per-group scale = max(|x|) / q_range (127 / 7),
  or 1 for an all-zero group, no offset;
* **asymmetric**: per-group scale = (max - min) / (2^bits - 1) and offset =
  min; 8-bit values are stored shifted by -128 in int8;
* :func:`stochastic_quantize` rounds up with probability equal to the
  fractional part; it takes a ``torch.Generator`` where JAX takes a key, so
  its draws are not JAX's;
* :func:`quantized_reduce` (dequant -> mean over ranks -> requant),
  :func:`swizzle_quant` / :func:`unswizzle`, :func:`pack_int4` /
  :func:`unpack_int4`.

Routing.  On a CUDA tensor, 8-bit symmetric :func:`quantize` launches the
hand-written kernel ``csrc/quantizer.cu`` (:func:`quantize_kernel`, the
counterpart of the TPU kernel ``quantize_pallas``); that is the rule the TPU
kernel computes.  Every other mode (asymmetric, int4, stochastic, the
reduce) is torch math on every device, as the JAX package has no kernel for
them either.  On the CPU :func:`quantize_kernel` takes its plain version,
:func:`quantize_plain`.  ``LAUNCHES["quantize"]`` counts the wrapper's calls
on the card; each one is one kernel launch, which reads x once and holds
each value on chip between its group's maximum and its quantization, along
the plan of :func:`quantize_plan` (whole groups a piece, or a group's
pieces over co-resident blocks); :func:`quantize_planned_plain` evaluates that
plan on any device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import _build

__all__ = [
    "quantize", "dequantize", "fake_quantize", "stochastic_quantize",
    "quantized_reduce", "swizzle_quant", "unswizzle", "pack_int4",
    "unpack_int4", "quantize_kernel", "quantize_plain", "quantize_plan",
    "launch_plan", "quantize_planned_plain", "QuantizerBuilder",
]

#: wrapper calls that launched the kernel (plain CPU calls do not count)
LAUNCHES = {"quantize": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: csrc/quantizer.cu's threads that read and quantize x (``kThreads``; a
#: block has one warp more, for the group words)
QUANT_THREADS = 256
#: the bytes of x a piece holds at most: of whole groups, of a group
QUANT_PIECE_BLOCK = 16 * 1024
QUANT_PIECE = 32 * 1024
#: pieces a block holds at once (at most 6): where a piece's group is its
#: own, QUANT_NBUF (the others load while one is quantized); a group of
#: several pieces QUANT_NBUF_GROUP (one quantized, one reduced while its
#: group's other parts arrive, the others loading)
QUANT_NBUF = 2
QUANT_NBUF_GROUP = 3
#: a block's dynamic shared memory at most (the card's 227 KB)
QUANT_SMEM_MAX = 227 * 1024
#: an H100's SMs, and its blocks an SM by the kernel's shared memory (the
#: runtime's occupancy query on the card: 2048 threads, ~1 KB kept by the
#: runtime a block); the wrapper asks the card itself
H100_SMS = 132


def h100_resident(smem: int) -> int:
    """Blocks of the quantizer with ``smem`` bytes of dynamic shared memory
    that one H100 SM holds at once."""
    if smem > QUANT_SMEM_MAX:
        return 0
    return min(2048 // (QUANT_THREADS + 32), (228 * 1024) // (smem + 1024))


def quantize_plan(numel: int, groups: int, elt: int, sms: int = H100_SMS,
                  resident=h100_resident) -> dict:
    """The kernel's launch for ``numel`` values of ``elt`` bytes in
    ``groups`` groups, on a card of ``sms`` SMs holding ``resident(smem)``
    blocks an SM; sizes in vectors (``vec`` values: 16 // elt when a group
    is a whole number of 16-byte vectors, else 1):

    * route ``"block"`` (a group of at most half of QUANT_PIECE_BLOCK):
      ``gpp`` whole groups a piece, ``parts`` 1;
    * route ``"group"``: ``parts`` pieces a group, consecutive, of
      ``piece`` vectors (the last may be shorter; QUANT_PIECE bytes at
      most), whose maxima meet in the group's words; at most one grid of
      parts, every block resident.

    ``nbuf`` pieces a block holds in shared memory: QUANT_NBUF (the next
    ones load while one is quantized), QUANT_NBUF_GROUP for a group of
    several parts (each quantized an iteration after it arrives), 0 (x
    read twice from global memory, the second time from L2: the scalar
    path, and a group of more parts than a grid of staging blocks holds;
    cut into one grid of larger pieces when it has more than any grid
    holds); ``smem`` its bytes, ``n_pieces``, and ``grid`` =
    min(n_pieces, sms x resident(smem)) blocks walking them."""
    n = numel // groups
    vec = 16 // elt if (n * elt) % 16 == 0 else 1
    gl = n // vec
    plan = {"vec": vec, "group_vecs": gl}

    def done(route, piece, gpp, parts, nbuf):
        smem = nbuf * piece * 16 + 12 * gpp
        n_pieces = -(-groups // gpp) if gpp else groups * parts
        return {**plan, "route": route, "piece": piece, "gpp": gpp,
                "parts": parts, "nbuf": nbuf, "smem": smem,
                "n_pieces": n_pieces,
                "grid": min(n_pieces, sms * resident(smem))}

    staged = QUANT_NBUF if vec > 1 else 0
    per = max(1, QUANT_PIECE_BLOCK // (vec * elt))
    if 2 * gl <= per:
        gpp = min(per // gl, groups)
        return done("block", gpp * gl, gpp, 1, staged)
    parts = -(-gl // max(1, QUANT_PIECE // (vec * elt)))
    piece = -(-gl // parts)
    if parts == 1:
        return done("group", piece, 0, 1, staged)
    for nbuf in ((QUANT_NBUF_GROUP,) if vec > 1 else ()) + (0,):
        if parts <= sms * resident(nbuf * piece * 16):
            return done("group", piece, 0, parts, nbuf)
    parts = sms * resident(0)
    return done("group", -(-gl // parts), 0, parts, 0)


def quantize_planned_plain(x: torch.Tensor, num_groups: int, **plan_kw
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_plain` evaluated along :func:`quantize_plan` (its
    keywords ``sms`` and ``resident`` pass through), as the kernel
    reduces: route "block", each group in its piece; route "group", each
    piece of a group reduced on its own, then the pieces' maxima combined;
    scale and q from the group's maximum."""
    g = _group(x, num_groups).float()
    plan = quantize_plan(x.numel(), num_groups, x.element_size(), **plan_kw)
    a = g.abs()
    if plan["route"] == "block":
        absmax = a.amax(dim=1)
    else:
        step = plan["piece"] * plan["vec"]
        absmax = torch.stack([a[:, c:c + step].amax(dim=1)
                              for c in range(0, g.shape[1], step)],
                             dim=1).amax(dim=1)
    scale = _sym_scale(absmax[:, None], 127.0)
    q = torch.clamp(torch.round(g / scale), -127.0, 127.0).to(torch.int8)
    return q, scale[:, 0]


def _q_range(num_bits: int, symmetric: bool) -> Tuple[float, float]:
    if symmetric:
        q = float(2 ** (num_bits - 1) - 1)          # 127 / 7
        return -q, q
    return 0.0, float(2 ** num_bits - 1)            # 0..255 / 0..15


def _group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    n = x.numel()
    if n % num_groups != 0:
        raise ValueError(f"size {n} not divisible by num_groups {num_groups}")
    return x.reshape(num_groups, n // num_groups)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as JAX divides: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal instead, which can be an ulp
    off, so ``b`` goes in as a tensor on ``a``'s device."""
    return a / a.new_full((), b)


def _sym_scale(absmax: torch.Tensor, hi: float) -> torch.Tensor:
    return torch.where(absmax > 0, _div(absmax, hi), torch.ones_like(absmax))


def quantize_plain(x: torch.Tensor, num_groups: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: symmetric int8 per group,
    ``q`` [num_groups, group_size] int8 and fp32 scales [num_groups]."""
    g = _group(x, num_groups).float()
    scale = _sym_scale(g.abs().amax(dim=1, keepdim=True), 127.0)
    q = torch.clamp(torch.round(g / scale), -127.0, 127.0).to(torch.int8)
    return q, scale[:, 0]


def quantize_kernel(x: torch.Tensor, num_groups: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 groupwise quantize (the counterpart of the TPU's
    ``quantize_pallas``): on a CUDA tensor the hand-written kernel, which
    gives the plain version's bits; on the CPU the plain version."""
    if not x.is_cuda:
        return quantize_plain(x, num_groups)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_kernel: the CUDA kernel takes fp32, bf16 "
                        f"or fp16 (got {x.dtype})")
    if not x.is_contiguous():
        raise ValueError("quantize_kernel: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("quantize_kernel: x must be 16-byte aligned")
    n = x.numel()
    if num_groups <= 0 or n % num_groups:
        raise ValueError(f"size {n} not divisible by num_groups {num_groups}")
    gs = n // num_groups
    q = torch.empty((num_groups, gs), dtype=torch.int8, device=x.device)
    scale = torch.empty((num_groups,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scale
    p = launch_plan(x, num_groups)
    words = _words(x.device, num_groups) if p["parts"] > 1 else None
    tag = _TAGS[x.device] = _TAGS.get(x.device, 0) % (2 ** 31 - 1) + 1
    with torch.cuda.device(x.device):
        rc = _kernel()(_DTYPE_CODE[x.dtype], x.data_ptr(), q.data_ptr(),
                       scale.data_ptr(),
                       None if words is None else words.data_ptr(),
                       num_groups, gs, p["vec"], p["piece"], p["n_pieces"],
                       p["gpp"], p["parts"], p["nbuf"], p["grid"], tag,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_kernel: CUDA kernel launch failed with "
                           f"error {rc}")
    LAUNCHES["quantize"] += 1
    return q, scale


def launch_plan(x: torch.Tensor, num_groups: int) -> dict:
    """:func:`quantize_plan` for CUDA tensor ``x`` on its card (its SMs
    and the kernel's occupancy there): the launch :func:`quantize_kernel`
    makes."""
    dev = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    return quantize_plan(x.numel(), num_groups, x.element_size(), _sms(dev),
                         functools.partial(_resident, dev,
                                           _DTYPE_CODE[x.dtype]))


def quantize(x: torch.Tensor, num_groups: int, num_bits: int = 8,
             symmetric: bool = True,
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Groupwise quantize ``x`` -> (q, scale, offset).

    q is int8 [num_groups, group_size] (int4 values occupy the low nibble
    range, use :func:`pack_int4` to halve the wire size). scale/offset are
    fp32 of shape [num_groups]. offset is None for symmetric quantization.
    8-bit symmetric on a CUDA tensor launches the kernel.
    """
    if symmetric and num_bits == 8:
        q, scale = quantize_kernel(x, num_groups)
        return q, scale, None
    g = _group(x, num_groups).float()
    lo, hi = _q_range(num_bits, symmetric)
    if symmetric:
        scale = _sym_scale(g.abs().amax(dim=1, keepdim=True), hi)
        q = torch.clamp(torch.round(g / scale), lo, hi).to(torch.int8)
        return q, scale[:, 0], None
    gmin = g.amin(dim=1, keepdim=True)
    gmax = g.amax(dim=1, keepdim=True)
    scale = torch.where(gmax > gmin, _div(gmax - gmin, hi),
                        torch.ones_like(gmax))
    q = torch.clamp(torch.round((g - gmin) / scale), lo, hi)
    # asymmetric values stored unsigned-in-int8 (uint8 semantics, like the
    # reference's int8 buffer reinterpret)
    q = (q - 128.0).to(torch.int8) if num_bits == 8 else q.to(torch.int8)
    return q, scale[:, 0], gmin[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               offset: Optional[torch.Tensor] = None, num_bits: int = 8,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`; returns shape [num_groups, group_size]."""
    g = q.float()
    if offset is None:                                # symmetric
        out = g * scale[:, None]
    else:
        if num_bits == 8:
            g = g + 128.0
        out = g * scale[:, None] + offset[:, None]
    return out.to(dtype)


def fake_quantize(x: torch.Tensor, num_groups: int, num_bits: int = 8,
                  symmetric: bool = True) -> torch.Tensor:
    """Quantize-dequantize (reference ``ds_quantize`` / fake_quantizer.cu),
    the QAT forward.  Shape- and dtype-preserving."""
    q, s, o = quantize(x, num_groups, num_bits, symmetric)
    return dequantize(q, s, o, num_bits, x.dtype).reshape(x.shape)


def stochastic_quantize(x: torch.Tensor, num_groups: int,
                        generator: Optional[torch.Generator] = None,
                        num_bits: int = 8, symmetric: bool = True,
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """Stochastic-rounding variant (reference ``ds_sr_quantize``): round up
    with probability equal to the fractional part, making the quantizer
    unbiased.  The uniform draws come from ``generator``."""
    g = _group(x, num_groups).float()
    lo, hi = _q_range(num_bits, symmetric)
    if symmetric:
        scale = _sym_scale(g.abs().amax(dim=1, keepdim=True), hi)
        v = g / scale
        off = None
    else:
        gmin = g.amin(dim=1, keepdim=True)
        gmax = g.amax(dim=1, keepdim=True)
        scale = torch.where(gmax > gmin, _div(gmax - gmin, hi),
                            torch.ones_like(gmax))
        v = (g - gmin) / scale
        off = gmin[:, 0]
    floor = torch.floor(v)
    frac = v - floor
    rnd = torch.rand(v.shape, generator=generator, device=v.device)
    q = torch.clamp(floor + (rnd < frac).float(), lo, hi)
    if off is not None and num_bits == 8:
        q = q - 128.0
    return q.to(torch.int8), scale[:, 0], off


def quantized_reduce(q: torch.Tensor, scale: torch.Tensor, num_ranks: int,
                     num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize ``num_ranks`` stacked quantized chunks, average, requantize
    (reference quant_reduce.cu ``launch_dequant_reduce``, the inner op of
    ZeRO++'s quantized gradient reduce).

    q: int8 [num_ranks, num_groups, group], scale: [num_ranks, num_groups].
    Returns (q_out [num_groups, group], scale_out [num_groups]).
    """
    full = q.float() * scale[:, :, None]
    mean = full.mean(dim=0)
    _, hi = _q_range(num_bits, True)
    out_scale = _sym_scale(mean.abs().amax(dim=1, keepdim=True), hi)
    q_out = torch.clamp(torch.round(mean / out_scale), -hi, hi).to(torch.int8)
    return q_out, out_scale[:, 0]


def swizzle_quant(x: torch.Tensor, num_groups: int, pipeline_size: int,
                  num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a node-major swizzle (reference swizzled_quantize.cu):
    element i of every pipeline chunk is made contiguous.  Returns (q
    [num_groups, group], scale [num_groups]) over the swizzled layout;
    :func:`unswizzle` is the reshape-transpose applied after the gather."""
    flat = x.reshape(-1)
    if flat.numel() % pipeline_size != 0:
        raise ValueError("size not divisible by pipeline_size")
    sw = flat.reshape(pipeline_size, -1).t().contiguous().reshape(-1)
    q, s, _ = quantize(sw, num_groups, num_bits, True)
    return q, s


def unswizzle(x: torch.Tensor, pipeline_size: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return flat.reshape(-1, pipeline_size).t().reshape(-1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (stored in int8, range [-8, 7] or [0, 15]) two per
    byte along the last axis (quantize_intX.cu layout)."""
    if q.shape[-1] % 2 != 0:
        raise ValueError("last dim must be even to pack int4")
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = (q[..., 1::2].to(torch.uint8) & 0xF) << 4
    return (lo | hi).view(torch.int8)


def unpack_int4(p: torch.Tensor, signed: bool = True) -> torch.Tensor:
    u = p.view(torch.uint8)
    lo = (u & 0xF).to(torch.int8)
    hi = ((u >> 4) & 0xF).to(torch.int8)
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                p.shape[-1] * 2)
    if signed:  # sign-extend nibble
        out = torch.where(out > 7, out - 16, out)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("quantizer").dstt_quantize_int8
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident(dev: int, code: int, smem: int) -> int:
    """Blocks of the kernel for type ``code`` (the fewer of its 16-byte and
    scalar forms) with ``smem`` bytes of dynamic shared memory that one SM
    of CUDA device ``dev`` holds at once (the runtime's occupancy query,
    once a size)."""
    if smem > QUANT_SMEM_MAX:
        return 0
    fn = _build.load("quantizer").dstt_quantize_resident
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    held = []
    for vec in (16, 1):
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(code, vec, smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"dstt_quantize_resident failed with {rc}")
        held.append(out.value)
    return min(held)


#: the route "group" words of each device: 4 int32 a group (the maximum
#: and the arrivals, zero and left zero by every launch; the published
#: maximum beside the launch's tag), and each device's last launch tag
_WORDS: dict = {}
_TAGS: dict = {}


def _words(device: torch.device, groups: int) -> torch.Tensor:
    """The device's group words, grown (zeroed) to ``groups`` groups; one
    allocation a device unless a launch has more groups than any before."""
    have = _WORDS.get(device)
    if have is None or have.numel() < 4 * groups:
        have = torch.zeros(4 * max(groups, 1024), dtype=torch.int32,
                           device=device)
        _WORDS[device] = have
    return have


class QuantizerBuilder:
    """op_builder surface (reference op_builder/quantizer.py)."""

    NAME = "quantizer"

    def load(self):
        import deepspeed_tpu_torch.ops.quantizer as m
        return m

    def is_compatible(self) -> bool:
        return True
