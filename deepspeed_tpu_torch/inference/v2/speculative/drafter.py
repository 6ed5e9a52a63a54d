"""Draft-token proposers for speculative decoding (counterpart of
``deepspeed_tpu/inference/v2/speculative/drafter.py``, copied with its
behaviour; pure host Python).

The drafter's contract is deliberately tiny: ``draft(history, k)``
returns up to ``k`` guesses for the NEXT tokens of ``history``.  Drafts
are free to be wrong — the verify pass scores them against the target
model and the (seed, uid, position)-keyed sampler accepts exactly the
prefix a sequential decode would have produced, so a bad drafter costs
throughput, never correctness.

Self-speculative drafters (no extra model):

* :class:`NgramDrafter` — prompt-lookup decoding: find the most recent
  earlier occurrence of the history's trailing n-gram and propose the
  tokens that followed it.  Strong on retrieval/summarisation shapes
  (the continuation often appears verbatim in the prompt) and on the
  repetitive tails greedy decoding settles into.
* :class:`PrefixCacheDrafter` — keys drafts off the radix prefix cache:
  when a previous request already generated through this exact token
  history (shared system prompt + same question), the tree's stored
  token content IS the continuation; propose it.  Falls back to a
  chained drafter (typically n-gram) on a miss.

Pluggable small-model drafting:

* :class:`SmallModelDrafter` — wraps any ``propose(history, k)``
  callable (e.g. a greedy loop over a distilled model on its own
  engine).  The subsystem stays agnostic about what produces the
  guesses.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence


class Drafter:
    """Base interface: propose up to ``k`` next-token guesses."""

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram self-drafter.

    Matches the longest trailing n-gram of ``history`` (lengths
    ``max_ngram`` down to ``min_ngram``) against the most recent earlier
    occurrence inside the last ``max_history`` tokens and proposes the
    tokens that followed that occurrence.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_history: int = 1024):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_history = max_history

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        if k <= 0 or len(history) < self.min_ngram + 1:
            return []
        import numpy as np

        # vectorised lookup: this runs inside the scheduler's decode
        # tick for every live request, so no per-position python slices
        hist = np.asarray(history[-self.max_history:], np.int64)
        top = min(self.max_ngram, len(hist) - 1)
        for n in range(top, self.min_ngram - 1, -1):
            # candidate starts 0..len-n-1 (exclude the suffix itself)
            wins = np.lib.stride_tricks.sliding_window_view(
                hist, n)[:len(hist) - n]
            matches = np.nonzero((wins == hist[-n:]).all(axis=1))[0]
            if matches.size:
                # most recent earlier occurrence (the freshest context
                # is likeliest to predict the continuation)
                i = int(matches[-1])
                return [int(t) for t in hist[i + n:i + n + k]]
        return []


class PrefixCacheDrafter(Drafter):
    """Drafts from the radix prefix cache's stored token content.

    The tree caches full KV blocks keyed by their token tuples; if a
    request's ENTIRE history lies on a cached path that extends further
    (a previous request with the same prompt already generated past this
    point), the deeper edge labels are a verbatim prediction of what the
    model will produce — propose them.  The probe never touches LRU
    stamps (a draft probe is not a use).
    """

    def __init__(self, state_manager, fallback: Optional[Drafter] = None):
        self.state_manager = state_manager
        self.fallback = fallback if fallback is not None else NgramDrafter()

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        cache = getattr(self.state_manager, "prefix_cache", None)
        if cache is None or k <= 0:
            return self.fallback.draft(history, k)
        out = cache.lookup_continuation(history, k)
        if out:
            return out
        return self.fallback.draft(history, k)


class SmallModelDrafter(Drafter):
    """Pluggable draft-model interface: any ``propose(history, k)``
    callable — e.g. a greedy :meth:`decode_loop` over a distilled model
    on its own engine — becomes a drafter."""

    def __init__(self, propose: Callable[[List[int], int], Sequence[int]]):
        self._propose = propose

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        return [int(t) for t in self._propose(list(history), int(k))][:k]


def make_self_drafter(engine) -> Drafter:
    """The default self-speculative drafter for an engine: radix-cache
    drafts when the prefix cache is on, n-gram prompt lookup otherwise
    (and as the cache drafter's fallback)."""
    sm = getattr(engine, "state_manager", None)
    if sm is not None and getattr(sm, "prefix_cache", None) is not None:
        return PrefixCacheDrafter(sm)
    return NgramDrafter()
