"""Attention dispatcher (counterpart of ``deepspeed_tpu/ops/attention.py``).

:func:`dot_product_attention` is the bshd entry point, q ``[B,Sq,H,D]`` and
k / v ``[B,Sk,Hkv,D]``.  It sends to the plain composition
(:func:`_xla_attention`, the JAX package's XLA path) exactly what the JAX
package sends to XLA for every shape: a ``mask`` or a ``bias``.  Everything
else goes to :func:`deepspeed_tpu_torch.ops.flash_attention.flash_attention`
— the CUDA kernels on the card (which raise on a head dim they do not take),
the plain flash functions on the CPU.

The layout switch (``attention_layout``) is kept, with the JAX package's
fallback chain: :func:`paired_attention` → :func:`folded_attention` →
:func:`dot_product_attention` on the free ``[B,S,H,D]`` reshape.  The folded
and paired entries take the projection's ``[B,S,H*D]`` output as it is
(column slices of a fused projection included) and launch the strided flash
kernels; on the card every route runs a kernel or raises.
``implementation="plain"`` keeps the routing and runs the plain versions
(the on-card comparison path).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_folded, flash_attention_folded_usable,
    flash_attention_paired, flash_attention_paired_usable)

ATTENTION_LAYOUTS = ("bshd", "folded", "paired")
_DEFAULT_ATTENTION_LAYOUT = "bshd"


def set_default_attention_layout(layout: str) -> None:
    """Process-wide default consulted by models whose config leaves
    ``attention_layout`` unset; the engine sets it from an explicit
    ``attention_layout`` key of the DeepSpeed config."""
    global _DEFAULT_ATTENTION_LAYOUT
    _DEFAULT_ATTENTION_LAYOUT = resolve_attention_layout(layout)


def resolve_attention_layout(layout: Optional[str]) -> str:
    """A model config's ``attention_layout`` (None -> process default)."""
    if layout is None:
        return _DEFAULT_ATTENTION_LAYOUT
    if layout not in ATTENTION_LAYOUTS:
        raise ValueError(f"attention_layout must be one of "
                         f"{ATTENTION_LAYOUTS}, got {layout!r}")
    return layout


def dot_product_attention(q, k, v, *, causal: bool = True,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          bias: Optional[torch.Tensor] = None,
                          implementation: str = "auto"):
    """q: [B,Sq,H,D]; k/v: [B,Sk,Hkv,D] (GQA when Hkv < H).

    ``window``: causal sliding window.  ``mask`` (bool, broadcastable to
    [B,H,Sq,Sk]) and ``bias`` (additive, same broadcast) take the plain
    composition.  ``implementation="plain"`` runs the flash functions'
    plain versions even on CUDA (the on-card comparison path)."""
    _check_implementation(implementation)
    if bias is not None or mask is not None:
        return _xla_attention(q, k, v, causal=causal, mask=mask, scale=scale,
                              window=window, bias=bias)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           window=window,
                           use_kernel=implementation == "auto")


def _check_implementation(implementation: str) -> None:
    if implementation not in ("auto", "plain"):
        raise ValueError(f"implementation must be 'auto' or 'plain', got "
                         f"{implementation!r}")


def folded_attention(q, k, v, *, num_heads: int,
                     num_kv_heads: Optional[int] = None,
                     causal: bool = True,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     implementation: str = "auto"):
    """Layout-native attention on the projection's folded output.

    q: [B,Sq,H*D]; k/v: [B,Sk,Hkv*D]; returns [B,Sq,H*D].  Geometries that
    :func:`flash_attention_folded_usable` takes go to the folded entry;
    the others are *reshaped* (free: the same memory) to [B,S,H,D] and go
    through :func:`dot_product_attention`."""
    _check_implementation(implementation)
    hkv = num_kv_heads if num_kv_heads is not None else num_heads
    if flash_attention_folded_usable(q, k, v, num_heads, hkv, causal, None):
        return flash_attention_folded(
            q, k, v, num_heads=num_heads, num_kv_heads=hkv, causal=causal,
            scale=scale, window=window,
            use_kernel=implementation == "auto")
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    out = dot_product_attention(
        q.reshape(b, sq, num_heads, d), k.reshape(b, sk, hkv, d),
        v.reshape(b, sk, hkv, d), causal=causal, scale=scale, window=window,
        implementation=implementation)
    return out.reshape(b, sq, hd)


def paired_attention(q, k, v, *, num_heads: int,
                     num_kv_heads: Optional[int] = None,
                     causal: bool = True,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     implementation: str = "auto"):
    """Head-paired attention on the projection's folded output.

    q: [B,Sq,H*D]; k/v: [B,Sk,Hkv*D]; returns [B,Sq,H*D].  Geometries that
    :func:`flash_attention_paired_usable` takes (D < 128 dividing 128,
    whole head groups) go to the paired entry; every other one falls
    through to :func:`folded_attention`, which itself falls back to the
    bshd path, so routing never fails."""
    _check_implementation(implementation)
    hkv = num_kv_heads if num_kv_heads is not None else num_heads
    if flash_attention_paired_usable(q, k, v, num_heads, hkv, causal, None):
        return flash_attention_paired(
            q, k, v, num_heads=num_heads, num_kv_heads=hkv, causal=causal,
            scale=scale, window=window,
            use_kernel=implementation == "auto")
    return folded_attention(q, k, v, num_heads=num_heads, num_kv_heads=hkv,
                            causal=causal, scale=scale, window=window,
                            implementation=implementation)


def _xla_attention(q, k, v, *, causal, mask, scale, window=None, bias=None):
    """The plain composition: fp32 logits, -1e30 masking, softmax rounded
    to the input type before the product with v."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        if window is not None:
            keep &= ~torch.ones_like(keep).tril(sk - sq - window)
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
