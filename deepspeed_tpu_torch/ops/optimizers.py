"""Optimizers on fp32 master tensors (counterpart of
``deepspeed_tpu/ops/optimizers.py``; reference: csrc/adam, csrc/lamb,
csrc/lion, csrc/adagrad).

Each optimizer is a pair ``init(master) -> state`` and
``update(grads, state, master, lr, step)``: ``master`` is a list of fp32
tensors, ``state`` a dict of such lists, and the update writes both in
place (the JAX package returns new trees; updating in place saves a copy of
the optimizer state).  The formulas are the JAX package's: bias correction
from the step count, eps outside the square root, decoupled weight decay in
AdamW mode.  Adam, the training path's optimizer, runs as ``torch._foreach_*``
calls (a few launches for a group of tensors; a group holds at most
``_FOREACH_ELEMS`` values, so the update's fp32 temporaries stay a few GB
even when the state is tens of GB); the others loop over tensors.  The
JAX package leaves these to XLA, not Pallas, so no kernel is owed here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

Tensors = List[torch.Tensor]


class OptimizerDef(NamedTuple):
    name: str
    init: Callable[[Tensors], Dict[str, Tensors]]
    update: Callable[..., None]
    hyperparams: Dict[str, Any]


def _zeros_like(master: Tensors) -> Tensors:
    return [torch.zeros_like(p, dtype=torch.float32) for p in master]


def _f32(grads: Tensors) -> Tensors:
    return [g if g.dtype == torch.float32 else g.float() for g in grads]


#: values in one group of tensors that the Adam update takes at a time:
#: each of its two fp32 temporaries (the denominator and the update) holds
#: at most this many (or one larger tensor)
_FOREACH_ELEMS = 1 << 28


def _groups(tensors: Tensors):
    """Slices of consecutive tensors of at most ``_FOREACH_ELEMS`` values
    each (a larger tensor alone)."""
    start, total = 0, 0
    for i, t in enumerate(tensors):
        if i > start and total + t.numel() > _FOREACH_ELEMS:
            yield slice(start, i)
            start, total = i, 0
        total += t.numel()
    if start < len(tensors):
        yield slice(start, len(tensors))


def _bias_corrections(betas, step: int, bias_correction: bool):
    """1 - beta ** step, in float32 as the JAX package computes them."""
    if not bias_correction:
        return 1.0, 1.0
    s = np.float32(step)
    return tuple(float(np.float32(1.0) - np.float32(b) ** s) for b in betas)


# --------------------------------------------------------------------- #
# Adam / AdamW
# --------------------------------------------------------------------- #
def fused_adam(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, **_unused) -> OptimizerDef:
    b1, b2 = betas

    def init(master):
        return {"m": _zeros_like(master), "v": _zeros_like(master)}

    def update(grads, state, master, lr_t, step):
        c1, c2 = _bias_corrections(betas, step, bias_correction)
        for sl in _groups(master):
            update_group(grads[sl], state["m"][sl], state["v"][sl],
                         master[sl], lr_t, c1, c2)

    def update_group(grads, m, v, master, lr_t, c1, c2):
        g = _f32(grads)
        if not adam_w_mode and weight_decay > 0.0:
            g = torch._foreach_add(g, master, alpha=weight_decay)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, c1)
        torch._foreach_div_(upd, denom)
        if adam_w_mode and weight_decay > 0.0:
            torch._foreach_add_(upd, master, alpha=weight_decay)
        torch._foreach_add_(master, upd, alpha=-lr_t)

    return OptimizerDef("adam" if not adam_w_mode else "adamw", init, update,
                        dict(lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay))


# --------------------------------------------------------------------- #
# LAMB: per-tensor trust ratio ||p|| / ||update||
# --------------------------------------------------------------------- #
def fused_lamb(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01, bias_correction: bool = True,
               **_unused) -> OptimizerDef:
    b1, b2 = betas

    def init(master):
        return {"m": _zeros_like(master), "v": _zeros_like(master)}

    def update(grads, state, master, lr_t, step):
        c1, c2 = _bias_corrections(betas, step, bias_correction)
        for g, m, v, p in zip(_f32(grads), state["m"], state["v"], master):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / c1) / ((v / c2).sqrt() + eps)
            if weight_decay > 0.0:
                upd.add_(p, alpha=weight_decay)
            p_norm, u_norm = p.norm(), upd.norm()
            trust = torch.where((p_norm > 0) & (u_norm > 0),
                                (p_norm / u_norm).clamp(min_coeff, max_coeff),
                                torch.ones_like(p_norm))
            p.sub_(lr_t * trust * upd)

    return OptimizerDef("lamb", init, update,
                        dict(lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay))


# --------------------------------------------------------------------- #
# Lion
# --------------------------------------------------------------------- #
def fused_lion(lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0,
               **_unused) -> OptimizerDef:
    b1, b2 = betas

    def init(master):
        return {"m": _zeros_like(master)}

    def update(grads, state, master, lr_t, step):
        del step
        decay = float(np.float32(1.0) - np.float32(lr_t)
                      * np.float32(weight_decay))
        for g, m, p in zip(_f32(grads), state["m"], master):
            c = b1 * m + (1.0 - b1) * g
            p.mul_(decay).sub_(lr_t * torch.sign(c))
            m.mul_(b2).add_(g, alpha=1.0 - b2)

    return OptimizerDef("lion", init, update,
                        dict(lr=lr, betas=betas, weight_decay=weight_decay))


# --------------------------------------------------------------------- #
# SGD (+momentum) and Adagrad
# --------------------------------------------------------------------- #
def sgd(lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False, **_unused) -> OptimizerDef:
    def init(master):
        return {} if momentum == 0.0 else {"m": _zeros_like(master)}

    def update(grads, state, master, lr_t, step):
        del step
        moms = state.get("m", [None] * len(master))
        for g, m, p in zip(_f32(grads), moms, master):
            if weight_decay > 0.0:
                g = g + weight_decay * p
            if m is None:
                p.sub_(lr_t * g)
                continue
            m.mul_(momentum).add_(g)
            p.sub_(lr_t * (g + momentum * m if nesterov else m))

    return OptimizerDef("sgd", init, update, dict(lr=lr, momentum=momentum))


def adagrad(lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0,
            **_unused) -> OptimizerDef:
    def init(master):
        return {"v": _zeros_like(master)}

    def update(grads, state, master, lr_t, step):
        del step
        for g, v, p in zip(_f32(grads), state["v"], master):
            if weight_decay > 0.0:
                g = g + weight_decay * p
            v.addcmul_(g, g)
            p.sub_(lr_t * g / (v.sqrt() + eps))

    return OptimizerDef("adagrad", init, update, dict(lr=lr, eps=eps))


# --------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------- #
_REGISTRY: Dict[str, Callable[..., OptimizerDef]] = {
    "adam": lambda **kw: fused_adam(adam_w_mode=kw.pop("adam_w_mode", False),
                                    **kw),
    "adamw": lambda **kw: fused_adam(adam_w_mode=True, **kw),
    "fusedadam": lambda **kw: fused_adam(**kw),
    "lamb": fused_lamb,
    "fusedlamb": fused_lamb,
    "lion": fused_lion,
    "fusedlion": fused_lion,
    "sgd": sgd,
    "adagrad": adagrad,
}


def get_optimizer(name: str, params: Dict[str, Any]) -> OptimizerDef:
    key = name.lower().replace("_", "")
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown optimizer '{name}'. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**dict(params))


def register_optimizer(name: str,
                       factory: Callable[..., OptimizerDef]) -> None:
    _REGISTRY[name.lower().replace("_", "")] = factory
