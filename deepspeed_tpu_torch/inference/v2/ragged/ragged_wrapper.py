"""Ragged batch metadata (counterpart of
``deepspeed_tpu/inference/v2/ragged/ragged_wrapper.py``; reference:
inference/v2/ragged/ragged_wrapper.py ``RaggedBatchWrapper`` — token/sequence
metadata staged through a pinned host buffer ★fast_host_buffer.cu; here
plain numpy arrays, packed into one int32 vector and uploaded once per
forward).

A ragged batch is a fixed-size token buffer (the Dynamic SplitFuse token
budget) packing tokens from up to ``max_seqs`` sequences::

    token_ids  [T] int32   padded with 0
    token_slot [T] int32   which batch slot each token belongs to (pad -> 0,
                           but pads scatter KV to the trash block)
    token_pos  [T] int32   absolute position in its sequence
    block_tables [max_seqs, max_blocks] int32  KV block ids (trash-padded)
    context_lens [max_seqs] int32  tokens valid after this forward
    logits_idx   [max_seqs] int32  index in [T] of each slot's last token
    kv_dest      [T] int32  flat pool index for each token's KV write
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import (
    DSSequenceDescriptor,
)

TRASH = BlockedAllocator.TRASH_BLOCK

#: The paged kernel masks table slots past a sequence's length BY POSITION
#: only — corrupted sequence metadata would silently read another
#: sequence's KV. These host-side invariant checks are cheap (O(T + S*B))
#: and on by default; set DEEPSPEED_TPU_RAGGED_DEBUG=0 to skip them on a
#: hot serving path.
RAGGED_DEBUG = os.environ.get("DEEPSPEED_TPU_RAGGED_DEBUG", "1") != "0"


class RaggedMetadataError(RuntimeError):
    """A ragged batch's sequence metadata violates the paged-KV invariants."""


def validate_ragged_metadata(seqs: List[DSSequenceDescriptor],
                             chunks: List[np.ndarray],
                             block_size: int) -> None:
    """Assert the invariants the paged kernel relies on (debug mode):

    1. no two sequences own the same KV block — EXCEPT a block inside
       BOTH sequences' shared prefix region (radix prefix cache: the
       leading ``seq.shared_blocks`` blocks are read-only and
       legitimately multi-referenced);
    2. every sequence's block table covers seen_tokens + chunk (a write
       past capacity would land in another sequence's block);
    3. no KV write may target a shared block (writes start at
       ``seen_tokens``, which must clear the shared region — the state
       manager copy-on-write forks before ever violating this);
    4. no sequence owns the trash block (pad writes target it).
    """
    owned = {}
    for seq, chunk in zip(seqs, chunks):
        if seq.seen_tokens < 0:
            raise RaggedMetadataError(
                f"sequence {seq.uid}: negative seen_tokens "
                f"{seq.seen_tokens}")
        need = seq.seen_tokens + len(chunk)
        if len(seq.blocks) * block_size < need:
            raise RaggedMetadataError(
                f"sequence {seq.uid}: block table covers "
                f"{len(seq.blocks) * block_size} positions but "
                f"{need} are live — a KV write would spill into another "
                f"sequence's block")
        shared_n = getattr(seq, "shared_blocks", 0)
        if len(chunk) and seq.seen_tokens < shared_n * block_size:
            raise RaggedMetadataError(
                f"sequence {seq.uid}: write position {seq.seen_tokens} "
                f"falls inside its shared prefix "
                f"({shared_n} blocks) — a copy-on-write fork was skipped")
        for j, b in enumerate(seq.blocks):
            if b == TRASH:
                raise RaggedMetadataError(
                    f"sequence {seq.uid} owns the trash block {TRASH}")
            shared = j < shared_n
            if b in owned:
                prev_uid, prev_shared = owned[b]
                if prev_uid == seq.uid:
                    raise RaggedMetadataError(
                        f"KV block {b} listed twice in sequence "
                        f"{seq.uid}'s table — later positions would "
                        f"overwrite earlier tokens' KV")
                if not (shared and prev_shared):
                    raise RaggedMetadataError(
                        f"KV block {b} owned by both sequence {prev_uid} "
                        f"and sequence {seq.uid} outside their shared "
                        f"prefix regions — attention would read aliased "
                        f"KV")
                continue
            owned[b] = (seq.uid, shared)


class RaggedBatchWrapper:
    def __init__(self, token_budget: int, max_seqs: int, max_blocks: int,
                 block_size: int):
        self.token_budget = token_budget
        self.max_seqs = max_seqs
        self.max_blocks = max_blocks
        self.block_size = block_size
        self.clear()

    def clear(self):
        self._seqs: List[DSSequenceDescriptor] = []
        self._chunks: List[np.ndarray] = []
        self._starts: List[int] = []
        self._tokens_used = 0
        self._align = 0

    def set_alignment(self, align: int) -> None:
        """Tile-align chunk starts (the prefill kernel's contract: every
        [align]-row stripe of the token buffer is single-sequence; pad
        rows carry position -1). Call right after clear(); alignment
        padding counts against the token budget."""
        if self._seqs:
            raise RuntimeError("set_alignment before inserting sequences")
        self._align = int(align)

    @property
    def current_tokens(self) -> int:
        return self._tokens_used

    @property
    def current_sequences(self) -> int:
        return len(self._seqs)

    def _next_start(self) -> int:
        if self._align <= 1:
            return self._tokens_used
        a = self._align
        return ((self._tokens_used + a - 1) // a) * a

    def can_fit(self, n_tokens: int) -> bool:
        return (self._next_start() + n_tokens <= self.token_budget
                and len(self._seqs) < self.max_seqs)

    def insert_sequence(self, seq: DSSequenceDescriptor,
                        tokens: np.ndarray) -> None:
        """reference ``insert_sequence``: add one sequence's chunk."""
        if not self.can_fit(len(tokens)):
            raise RuntimeError("ragged batch full")
        start = self._next_start()
        self._seqs.append(seq)
        self._chunks.append(np.asarray(tokens, np.int32))
        self._starts.append(start)
        self._tokens_used = start + len(tokens)

    def finalize(self, token_capacity: int = None):
        """Build the device metadata (reference ``finalize``: host->device
        copy of the packed descriptors).

        ``token_capacity`` sizes the token-dim arrays (defaults to the full
        budget) — the engine passes the active BUCKET so a decode step
        compiles to a small program instead of the prefill-sized one.
        """
        T = token_capacity if token_capacity is not None else self.token_budget
        if self._tokens_used > T:
            raise ValueError(
                f"finalize: {self._tokens_used} scheduled tokens exceed "
                f"token capacity {T}")
        if RAGGED_DEBUG:
            validate_ragged_metadata(self._seqs, self._chunks,
                                     self.block_size)
        S, B = self.max_seqs, self.max_blocks
        bs = self.block_size
        token_ids = np.zeros((T,), np.int32)
        token_slot = np.zeros((T,), np.int32)
        # aligned mode: pads carry position -1 so both kernels and the XLA
        # path mask them to zero rows
        token_pos = np.full((T,), -1 if self._align > 1 else 0, np.int32)
        kv_dest = np.full((T,), TRASH * bs, np.int32)  # pads -> trash block
        block_tables = np.full((S, B), TRASH, np.int32)
        context_lens = np.zeros((S,), np.int32)
        logits_idx = np.zeros((S,), np.int32)
        n_valid = len(self._seqs)

        for slot, (seq, chunk, cursor) in enumerate(
                zip(self._seqs, self._chunks, self._starts)):
            n = len(chunk)
            pos = np.arange(seq.seen_tokens, seq.seen_tokens + n, dtype=np.int32)
            token_ids[cursor:cursor + n] = chunk
            token_slot[cursor:cursor + n] = slot
            token_pos[cursor:cursor + n] = pos
            blocks = np.asarray(seq.blocks, np.int32)
            if len(blocks) > B:
                raise RuntimeError(
                    f"sequence {seq.uid} exceeds max_blocks {B}")
            block_tables[slot, :len(blocks)] = blocks
            kv_dest[cursor:cursor + n] = blocks[pos // bs] * bs + pos % bs
            context_lens[slot] = seq.seen_tokens + n
            logits_idx[slot] = cursor + n - 1

        return {
            "token_ids": token_ids, "token_slot": token_slot,
            "token_pos": token_pos, "kv_dest": kv_dest,
            "block_tables": block_tables, "context_lens": context_lens,
            "logits_idx": logits_idx, "n_valid": np.int32(n_valid),
        }

    @property
    def sequences(self) -> List[DSSequenceDescriptor]:
        return list(self._seqs)

    @property
    def chunk_sizes(self) -> List[int]:
        return [len(c) for c in self._chunks]


# --------------------------------------------------------------------- #
# Metadata packing: ONE int32 host->device transfer per forward instead of
# seven (the reference stages through one pinned fast_host_buffer for the
# same reason)
# --------------------------------------------------------------------- #
_META_FIELDS = ("token_ids", "token_slot", "token_pos", "kv_dest",
                "block_tables", "context_lens", "logits_idx")


def pack_metadata(meta) -> np.ndarray:
    """Flatten the finalize() dict into one int32 vector (host side)."""
    return np.concatenate(
        [np.asarray(meta[k], np.int32).ravel() for k in _META_FIELDS])


def unpack_metadata(packed, token_capacity: int, max_seqs: int,
                    max_blocks: int):
    """Rebuild the batch dict from the packed (device) tensor: each field
    is a view of ``packed``."""
    T, S, B = token_capacity, max_seqs, max_blocks
    sizes = {"token_ids": (T, (T,)), "token_slot": (T, (T,)),
             "token_pos": (T, (T,)), "kv_dest": (T, (T,)),
             "block_tables": (S * B, (S, B)),
             "context_lens": (S, (S,)), "logits_idx": (S, (S,))}
    out = {}
    o = 0
    for k in _META_FIELDS:
        n, shape = sizes[k]
        out[k] = packed[o:o + n].reshape(shape)
        o += n
    return out
