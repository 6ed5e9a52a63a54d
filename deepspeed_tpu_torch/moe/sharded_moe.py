"""Sharded MoE: gating and expert dispatch (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``; reference deepspeed/moe/
sharded_moe.py — ``top1gating:184``, ``top2gating:282``, ``TopKGate:348``,
``MOELayer:425``).

Two paths, as in the JAX package:

* **capacity** (GShard): the token -> expert permutation is a pair of
  einsums over a ``[tokens, experts, capacity]`` one-hot dispatch tensor;
  tokens past an expert's capacity are dropped.  The einsums and the
  expert FFN's batched products are library calls here, as they are XLA's
  in the JAX package (no Pallas kernel runs on this path).
* **dropless** (Megablocks): exact top-k routing and the expert FFN as three
  grouped GEMMs (``ops/grouped_gemm.py``), forward and backward on the
  hand-written CUDA kernels.

Randomness (``noisy_gate_policy="RSample"``, the second-expert sampling of
top-2) takes its Gumbel noise from an explicit ``torch.Generator`` passed
as ``rng``, where the JAX package takes a ``jax.random`` key: the two give
different numbers from the same seed.  Expert parallelism is one device
here: the JAX package's expert-axis sharding constraint (its all-to-all,
``MOELayer._expert_sharded``) is the identity at world size 1, so there is
none; an expert axis larger than 1 (``MoE(ep_size=...)``) raises
(ROADMAP A6).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.grouped_gemm import (exact_topk_routing,
                                                  grouped_moe_ffn)


def _one_hot(idx: torch.Tensor, num: int,
             dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, num)`` gives a row of
    zeros (``F.one_hot`` would raise)."""
    return (idx.long()[..., None] == torch.arange(
        num, device=idx.device)).to(dtype)


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    # ceil, matching the reference (sharded_moe.py _capacity): truncation
    # would drop extra tokens whenever tokens/experts*factor is fractional.
    cap = math.ceil(num_tokens / num_experts * capacity_factor)
    return max(cap, min_capacity)


def _gumbel(like: torch.Tensor, rng: torch.Generator,
            dtype=None) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``like``, from ``rng`` (on
    ``like``'s device): ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    u = torch.rand(like.shape, generator=rng, device=like.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype or like.dtype)


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None,
               rng: Optional[torch.Generator] = None,
               drop_tokens: bool = True):
    """reference top1gating (sharded_moe.py:184).  Returns
    ``(l_aux, combine [S,E,C], dispatch [S,E,C] bool)``.  With
    ``noisy_gate_policy="RSample"`` and an ``rng`` the expert is the argmax
    of the logits plus Gumbel noise; the gates stay the clean softmax."""
    s, e = logits.shape
    c = _capacity(s, e, capacity_factor, min_capacity)
    gating_logits = logits
    if noisy_gate_policy == "RSample" and rng is not None:
        gating_logits = logits + _gumbel(logits, rng)
    gates = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(gating_logits, dim=-1)              # [S]
    mask1 = _one_hot(expert_idx, e)                               # [S, E]

    # load-balancing aux loss (GShard eq.): E * sum_e(frac_tokens * frac_prob)
    l_aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * e

    # position of each token within its expert's queue (0-based)
    position_in_expert = torch.cumsum(mask1, dim=0) * mask1 - mask1
    if drop_tokens:
        mask1 = mask1 * (position_in_expert < c)
    pos = torch.sum(position_in_expert * mask1, dim=-1)           # [S]

    gate_val = torch.sum(gates * mask1, dim=-1)                   # 0 if dropped
    dispatch = mask1[:, :, None] * _one_hot(pos.to(torch.int32), c)[:, None, :]
    combine = gate_val[:, None, None] * dispatch
    return l_aux, combine, dispatch.bool()


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, rng: Optional[torch.Generator] = None,
               drop_tokens: bool = True,
               top2_2nd_expert_sampling: bool = True):
    """reference top2gating (sharded_moe.py:282).  Returns
    ``(l_aux, combine [S,E,C], dispatch [S,E,C] bool)``; ``l_aux`` is taken
    from the first choice before any drop.  With an ``rng`` (and
    ``top2_2nd_expert_sampling``) the second expert is the argmax of the
    logits plus Gumbel noise, the first excluded."""
    s, e = logits.shape
    c = _capacity(s, e, 2 * capacity_factor, min_capacity)
    gates = torch.softmax(logits.float(), dim=-1)

    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, e)
    logits2 = logits.float()
    if top2_2nd_expert_sampling and rng is not None:
        logits2 = logits2 + _gumbel(logits2, rng)
    logits2 = logits2.masked_fill(mask1.bool(), -math.inf)
    idx2 = torch.argmax(logits2, dim=-1)
    mask2 = _one_hot(idx2, e)

    l_aux = torch.sum(gates.mean(dim=0) * mask1.mean(dim=0)) * e

    pos1 = torch.cumsum(mask1, dim=0) * mask1 - mask1
    pos2 = (torch.cumsum(mask2, dim=0) - 1
            + torch.sum(mask1, dim=0, keepdim=True)) * mask2
    if drop_tokens:
        mask1 = mask1 * (pos1 < c)
        mask2 = mask2 * (pos2 < c)

    g1 = torch.sum(gates * mask1, dim=-1)
    g2 = torch.sum(gates * mask2, dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    p1 = torch.sum(pos1 * mask1, dim=-1).to(torch.int32)
    p2 = torch.sum(pos2 * mask2, dim=-1).to(torch.int32)
    d1 = mask1[:, :, None] * _one_hot(p1, c)[:, None, :]
    d2 = mask2[:, :, None] * _one_hot(p2, c)[:, None, :]
    combine = g1[:, None, None] * d1 + g2[:, None, None] * d2
    dispatch = (d1 + d2) > 0
    return l_aux, combine, dispatch


class TopKGate(nn.Module):
    """reference TopKGate (sharded_moe.py:348): a linear router in fp32
    (``wg``, held ``[E, H]`` as ``nn.Linear``; the Flax kernel is
    ``[H, E]``)."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True):
        super().__init__()
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.wg = nn.Linear(model_dim, num_experts, bias=False)

    def forward(self, x, train: Optional[bool] = None,
                rng: Optional[torch.Generator] = None,
                dropless: bool = False):
        """x: [S, H].  Capacity routing: ``(l_aux, combine, dispatch)``;
        ``dropless``: exact top-k with renormalised weights and no capacity,
        ``(l_aux, topi [S,k], topw [S,k])``.  ``train`` defaults to the
        module's mode; it picks the capacity factor and the noise."""
        train = self.training if train is None else train
        logits = F.linear(x.float(), self.wg.weight.float())
        if dropless:
            topi, topw = exact_topk_routing(logits, self.k)
            probs = torch.softmax(logits, dim=-1)
            ce = _one_hot(topi, self.num_experts).sum(dim=1).mean(dim=0) \
                / self.k
            l_aux = torch.sum(probs.mean(dim=0) * ce) * self.num_experts
            return l_aux, topi, topw
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity,
                              self.noisy_gate_policy if train else None,
                              rng, self.drop_tokens)
        if self.k == 2:
            return top2gating(logits, cf, self.min_capacity, rng,
                              self.drop_tokens)
        raise ValueError(f"k={self.k} not supported (reference supports 1/2)")


class ExpertsFFN(nn.Module):
    """Per-expert SwiGLU FFN, weights stacked on a leading expert dim:
    ``w_gate`` / ``w_up`` ``[E, H, F]``, ``w_down`` ``[E, F, H]``, held in
    any floating type and cast to ``dtype`` for the products (the Flax
    params are fp32)."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 dtype=torch.bfloat16, use_kernels: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        e, h, f = num_experts, hidden, intermediate
        self.w_gate = nn.Parameter(torch.empty(e, h, f))
        self.w_up = nn.Parameter(torch.empty(e, h, f))
        self.w_down = nn.Parameter(torch.empty(e, f, h))

    def forward(self, x, grouped=None):
        """x: [E, C, M] (capacity-dispatched) -> [E, C, M]; or, with
        ``grouped=(topi, topw)``, x: [S, M] flat tokens -> [S, M] through
        the grouped GEMM (dropless: the same params, no capacity)."""
        if grouped is not None:
            topi, topw = grouped
            return grouped_moe_ffn(
                x.to(self.dtype), topi, topw.to(self.dtype),
                self.w_gate.to(self.dtype), self.w_up.to(self.dtype),
                self.w_down.to(self.dtype), use_kernel=self.use_kernels)
        # the weights cast to dtype, then promoted with x as jnp.einsum does
        dt = torch.promote_types(x.dtype, self.dtype)
        w_gate, w_up, w_down = (w.to(self.dtype).to(dt) for w in (
            self.w_gate, self.w_up, self.w_down))
        x = x.to(dt)
        h = F.silu(torch.einsum("ecm,emh->ech", x, w_gate)) \
            * torch.einsum("ecm,emh->ech", x, w_up)
        return torch.einsum("ech,ehm->ecm", h, w_down)


class MOELayer(nn.Module):
    """reference MOELayer (sharded_moe.py:425): gate -> einsum dispatch ->
    experts -> einsum combine; or, ``dropless``, gate -> grouped GEMM FFN.
    Submodules ``gate`` and ``experts`` as in the Flax tree.
    ``use_kernels=False`` runs the grouped GEMM's plain versions even on
    CUDA (the on-card comparison path)."""

    def __init__(self, num_experts: int, hidden: int, intermediate: int,
                 k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, dtype=torch.bfloat16,
                 dropless: bool = False, use_kernels: bool = True):
        super().__init__()
        if dropless and noisy_gate_policy is not None:
            raise ValueError(
                "dropless MoE uses exact top-k routing; noisy_gate_policy is "
                "not supported with dropless=True")
        self.dtype = dtype
        self.dropless = dropless
        self.gate = TopKGate(hidden, num_experts, k, capacity_factor,
                             eval_capacity_factor, min_capacity,
                             noisy_gate_policy, drop_tokens)
        self.experts = ExpertsFFN(num_experts, hidden, intermediate, dtype,
                                  use_kernels)

    def forward(self, x, train: Optional[bool] = None,
                rng: Optional[torch.Generator] = None):
        """x: [B, S, M] -> (out [B, S, M], l_aux fp32)."""
        b, s, m = x.shape
        tokens = x.reshape(b * s, m)
        if self.dropless:
            l_aux, topi, topw = self.gate(tokens, train, dropless=True)
            out = self.experts(tokens.to(self.dtype), grouped=(topi, topw))
            return out.reshape(b, s, m), l_aux.float()
        l_aux, combine, dispatch = self.gate(tokens, train, rng)
        # dispatch: [S,E,C] x [S,M] -> [E,C,M]; the one-hots cast to dtype,
        # then promoted with the other operand as jnp.einsum does
        dt = torch.promote_types(tokens.dtype, self.dtype)
        expert_in = torch.einsum("sec,sm->ecm", dispatch.to(dt),
                                 tokens.to(dt))
        expert_out = self.experts(expert_in)
        out = torch.einsum("sec,ecm->sm",
                           combine.to(self.dtype).to(expert_out.dtype),
                           expert_out)
        return out.reshape(b, s, m), l_aux.float()
