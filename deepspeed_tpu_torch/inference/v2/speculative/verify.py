"""Acceptance rule + configuration for speculative decoding (counterpart
of ``deepspeed_tpu/inference/v2/speculative/verify.py``, copied with its
behaviour; pure host Python).

The acceptance rule is EXACT-MATCH against the existing
(seed, uid, position)-keyed sampler — not the rejection-sampling ratio
test: for each candidate slot ``k`` the sampler draws the token the
sequential decode would draw at generation position ``pos0 + k`` from
slot ``k``'s logits; a draft is accepted iff it equals that draw.  The
drawn token at the first mismatch (or after the last accepted draft) is
emitted as the bonus/correction token.  Because the sampler is a pure
function of (logits, params, seed, uid, position) and slot ``k``'s
logits condition only on already-accepted tokens, the emitted stream is
the SAME stream a non-speculative run produces — greedy and stochastic
alike (bit-exact wherever the forward paths agree bitwise, e.g. the f32
CPU path; on low-precision kernels the usual near-tie caveat applies,
exactly as for preempt/recompute resume).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.inference.v2.speculative.drafter import (Drafter,
                                                            NgramDrafter)


@dataclasses.dataclass
class SpeculativeConfig:
    """Scheduler-level speculative decoding knobs.

    ``draft_k`` is the number of DRAFT tokens per verify pass; the pass
    feeds ``draft_k + 1`` tokens (input + drafts) and emits between 1
    and ``draft_k + 1`` tokens.  ``drafter`` defaults to the n-gram
    self-drafter; pass :func:`make_self_drafter`'s result to key drafts
    off the radix prefix cache, or a :class:`SmallModelDrafter` for a
    draft model.

    **Acceptance-aware K autotuning** (``autotune_k=True``): the
    scheduler keeps a per-request EWMA of the accept RATE (accepted /
    drafted per verify pass, smoothing ``accept_ewma_alpha``) and walks
    that request's effective K one step per pass — below
    ``shrink_threshold`` toward ``min_draft_k`` (a low-acceptance
    request stops paying K-token verify flops it never cashes), above
    ``grow_threshold`` back toward ``draft_k``.  ``draft_k`` stays the
    CAP, so the verify program shapes remain the bounded per-K set the
    engine already compiles.
    """

    draft_k: int = 4
    drafter: Optional[Drafter] = None
    autotune_k: bool = False
    min_draft_k: int = 1
    accept_ewma_alpha: float = 0.3
    shrink_threshold: float = 0.35
    grow_threshold: float = 0.65

    def __post_init__(self):
        if self.draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        if not 1 <= self.min_draft_k <= self.draft_k:
            raise ValueError(
                f"min_draft_k must be in [1, draft_k={self.draft_k}], "
                f"got {self.min_draft_k}")
        if not 0.0 < self.accept_ewma_alpha <= 1.0:
            raise ValueError("accept_ewma_alpha must be in (0, 1]")
        if not 0.0 <= self.shrink_threshold <= self.grow_threshold <= 1.0:
            raise ValueError(
                "need 0 <= shrink_threshold <= grow_threshold <= 1, got "
                f"({self.shrink_threshold}, {self.grow_threshold})")
        if self.drafter is None:
            self.drafter = NgramDrafter()


@dataclasses.dataclass
class SpeculativeStats:
    """Per-scheduler speculative telemetry (exported as serving/spec_*)."""

    ticks: int = 0            # verify passes run
    fallback_ticks: int = 0   # decode ticks where speculation opted out
    drafted: int = 0          # draft tokens proposed into verify passes
    accepted: int = 0         # draft tokens accepted
    emitted: int = 0          # tokens emitted by verify passes
    k_sum: int = 0            # per-request effective-K targets, summed
    k_requests: int = 0       # request slots the targets were summed over

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def tokens_per_pass(self) -> float:
        """Mean tokens emitted per verify weight pass (>= 1)."""
        return self.emitted / max(self.ticks, 1)

    @property
    def k_effective(self) -> float:
        """Mean per-request draft-K target across verify passes — with
        ``autotune_k`` this decays below ``draft_k`` exactly as far as
        acceptance decays (``serving/spec_k_effective``)."""
        return self.k_sum / max(self.k_requests, 1)

    def as_dict(self) -> Dict[str, float]:
        return {
            "ticks": float(self.ticks),
            "fallback_ticks": float(self.fallback_ticks),
            "drafted": float(self.drafted),
            "accepted": float(self.accepted),
            "emitted": float(self.emitted),
            "accept_rate": self.accept_rate,
            "tokens_per_pass": self.tokens_per_pass,
            "k_effective": self.k_effective,
        }


def accept_drafts(candidates: Sequence[int],
                  drafts: Sequence[int]) -> Tuple[List[int], int]:
    """Walk sampler draws ``candidates`` (slot-ordered) against
    ``drafts``; returns ``(emitted_tokens, n_accepted_drafts)``.

    ``candidates[k]`` is the sampler's draw from slot ``k``'s logits
    (``len(candidates) == len(drafts) + 1``).  Accepted drafts are the
    longest prefix with ``candidates[k] == drafts[k]``; the draw at the
    first mismatch — or the bonus draw after a fully accepted run — is
    the final emitted token.
    """
    out: List[int] = []
    acc = 0
    for k, t in enumerate(candidates):
        out.append(int(t))
        if k < len(drafts) and int(t) == int(drafts[k]):
            acc += 1
        else:
            break
    return out, acc
