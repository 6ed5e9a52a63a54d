"""MoE layer front-end (counterpart of ``deepspeed_tpu/moe/layer.py``;
reference deepspeed/moe/layer.py:16 ``MoE``).

Wraps :class:`MOELayer` with the reference's constructor surface
(num_experts, ep_size, k, capacity factors, residual MoE, dropless).  The
port trains on one device, so ``ep_size`` is validated (``num_experts``
must divide by it) and an ``ep_size`` above 1 raises (ROADMAP A6).
Submodule names follow the Flax tree: ``deepspeed_moe`` and, with
``use_residual``, ``residual_fc1`` / ``residual_fc2`` / ``coefficient``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer


@torch.no_grad()
def reset_parameters(module: nn.Module, seed: int = 0) -> None:
    """Random weights for every parameter of ``module``, drawn on the
    parameters' device from a ``torch.Generator`` seeded with ``seed`` (so a
    full-width model never passes through the host; a seed gives other
    numbers on the CPU than on the GPU): RMSNorm scales 1, biases 0, every
    other weight ~ N(0, 1/fan_in), fan_in the input width (``nn.Linear``
    ``[out, in]``: in; stacked experts ``[E, in, out]``: in; embeddings
    ``[V, H]``: H).  The numbers differ from Flax's initialisers; the
    parity tests carry weights across instead."""
    gen = None
    for name, p in module.named_parameters():
        if gen is None:
            gen = torch.Generator(device=p.device).manual_seed(seed)
        if name.endswith("scale"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p.shape[-2] if p.dim() == 3 else p.shape[-1]
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


class MoE(nn.Module):
    """``MoE(hidden, intermediate, num_experts, ...)(x)`` -> ``(out,
    l_aux)``, x ``[B, S, H]``.  Built on ``device``: CUDA unless
    ``device="cpu"`` is asked for; fp32 parameters from ``seed``.
    ``dropless=True`` routes exactly top-k and runs the experts as grouped
    GEMMs (``ops/grouped_gemm.py``); ``use_kernels=False`` runs those on
    their plain versions even on CUDA."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, dtype=torch.bfloat16,
                 dropless: bool = False, use_kernels: bool = True,
                 seed: int = 0, device=None):
        super().__init__()
        if num_experts % max(1, ep_size) != 0:
            raise ValueError(f"num_experts {num_experts} must be divisible "
                             f"by ep_size {ep_size}")
        if ep_size > 1:
            raise NotImplementedError(
                f"ep_size={ep_size}: expert parallelism (the expert mesh "
                f"axis and its all-to-all) is multi-device training, not "
                f"ported yet (ROADMAP A6)")
        self.dtype = dtype
        self.use_residual = use_residual
        with torch.device(resolve_device(device)):
            self.deepspeed_moe = MOELayer(
                num_experts, hidden_size, intermediate_size, k,
                capacity_factor, eval_capacity_factor, min_capacity,
                noisy_gate_policy, drop_tokens, dtype, dropless, use_kernels)
            if use_residual:
                # reference residual MoE (PR-MoE): dense FFN + learned mix
                self.residual_fc1 = nn.Linear(hidden_size, intermediate_size,
                                              bias=False)
                self.residual_fc2 = nn.Linear(intermediate_size, hidden_size,
                                              bias=False)
                self.coefficient = nn.Linear(hidden_size, 2)
        reset_parameters(self, seed)

    def forward(self, hidden_states, train: Optional[bool] = None,
                rng: Optional[torch.Generator] = None):
        out, l_aux = self.deepspeed_moe(hidden_states, train, rng)
        if self.use_residual:
            dt = self.dtype
            res = F.linear(hidden_states.to(dt),
                           self.residual_fc1.weight.to(dt))
            # flax.linen.gelu is the tanh approximation
            res = F.linear(F.gelu(res, approximate="tanh"),
                           self.residual_fc2.weight.to(dt))
            coef = torch.softmax(F.linear(
                hidden_states.float(), self.coefficient.weight.float(),
                self.coefficient.bias.float()), dim=-1).to(dt)
            out = out * coef[..., 0:1] + res * coef[..., 1:2]
        return out, l_aux
