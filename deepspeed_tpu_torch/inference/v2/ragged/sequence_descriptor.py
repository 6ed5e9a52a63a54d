"""Sequence bookkeeping (counterpart of
``deepspeed_tpu/inference/v2/ragged/sequence_descriptor.py``; reference:
inference/v2/ragged/sequence_descriptor.py ``DSSequenceDescriptor``)."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0            # tokens whose KV is already cached
    blocks: List[int] = dataclasses.field(default_factory=list)
    pending: List[int] = dataclasses.field(default_factory=list)
    # tokens awaiting scheduling (prompt remainder under SplitFuse)

    # -- prefix-cache bookkeeping (all zero when caching is off) ------- #
    #: token VALUES whose KV this sequence holds, positions [0, len);
    #: kept in lockstep with ``seen_tokens`` so full blocks can be
    #: registered in the radix tree.  Falls behind (and registration
    #: stops) only when tokens are fed as device arrays whose values the
    #: host never sees (``decode_step`` with device feedback).
    tokens: List[int] = dataclasses.field(default_factory=list)
    #: leading blocks reachable through the radix tree (attached from the
    #: cache or registered into it) — shared region: other sequences may
    #: legitimately hold the same block ids, and no KV write may land
    #: there (``shared_blocks * block_size <= seen_tokens`` always)
    shared_blocks: int = 0
    #: tree registration stopped permanently (content divergence with a
    #: concurrently registered twin, or token values lost to the device)
    register_stopped: bool = False

    def tokens_needed_capacity(self, new_tokens: int, block_size: int) -> int:
        """Blocks that must be allocated to hold ``new_tokens`` more."""
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)  # ceil
        return max(0, needed - len(self.blocks))
