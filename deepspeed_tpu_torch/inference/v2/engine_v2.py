"""FastGen continuous-batching engine (counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py``; reference:
inference/v2/engine_v2.py ``InferenceEngineV2`` — ``put:107`` /
``query:153`` / ``can_schedule:181`` / ``flush:210``).

Scheduling is host-side Python, as in the JAX package; each ragged forward
runs eagerly on the device.  The JAX package's ``jax.jit`` step programs
become plain calls and its ``lax.scan`` decode loop a Python loop, but the
batch shapes are kept: the same token buckets, the same tile-aligned
packing, the same decode-chunk decomposition, so both engines schedule the
same batches.  The KV pool is updated in place (the JAX engine donates and
replaces it).

``put`` runs forwards over whatever chunks fit the token budget and returns
the next-token logits per *fully scheduled* sequence; prompts longer than
the remaining budget are chunked (SplitFuse) and continue on the next round
via the sequence's ``pending`` queue.

Speculative decoding: ``verify_step`` scores K fed tokens per sequence (the
next input and K-1 drafts) in one forward and returns all K logits rows;
``commit_verified`` advances a sequence past the accepted prefix and frees
the lookahead blocks it no longer needs.  ``RaggedLlama`` scores the rows
with the paged verify kernel, ``RaggedMixtral`` (which has no verify
route, as in the JAX package) as ragged rows through its generic path.
``kv_cache.dtype="int8"`` keeps the pool block-quantized (fp32 scale per
row and KV head).
``flush_to_host(include_kv=True)`` / ``resume(kv_state=...)`` carry a
sequence's KV rows (scales included) from one engine to another.

``from_hf`` loads a HuggingFace checkpoint directory, with int8
weight-only quantization on the device (``quantize_bits=8``).

``occupancy()`` reads the live KV-pool and weight-byte gauges the serving
scheduler's registry provider scrapes.

Not ported yet (each raises ``NotImplementedError``): ``serialize`` and the
memory ledger (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged import (DSStateManager,
                                                     RaggedBatchWrapper)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import (
    BlockedAllocator)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (
    RAGGED_DEBUG, pack_metadata, unpack_metadata, validate_ragged_metadata)
from deepspeed_tpu_torch.utils.logging import log_dist


def _device_decode_batch(tables, pos, tok, block_size: int, max_blocks: int):
    """Ragged batch dict for a one-token-per-slot decode round, with the KV
    write target derived ON DEVICE from the block tables (shared by
    ``decode_loop`` and ``decode_step``)."""
    S = tables.shape[0]
    slot = torch.arange(S, dtype=torch.int32, device=tables.device)
    blk = torch.gather(
        tables, 1,
        torch.clamp(pos // block_size, 0, max_blocks - 1)[:, None].long()
    )[:, 0]
    return {
        "token_ids": tok,
        "token_slot": slot,
        "token_pos": pos,
        "kv_dest": blk * block_size + pos % block_size,
        "block_tables": tables,
        "context_lens": pos + 1,
        "logits_idx": slot,
    }


def _device_verify_batch(tables, pos, tok, block_size: int, max_blocks: int,
                         k_tokens: int):
    """Ragged batch dict for a speculative verify round: ``k_tokens``
    consecutive-position tokens per slot (the fed token plus the drafted
    lookahead), rows slot-major, with ``logits_idx`` selecting every row so
    the forward returns all K candidate logits per sequence."""
    S = tables.shape[0]
    dev = tables.device
    slot = torch.arange(S, dtype=torch.int32,
                        device=dev).repeat_interleave(k_tokens)
    p2 = pos[:, None] + torch.arange(k_tokens, dtype=torch.int32,
                                     device=dev)[None, :]
    blk = torch.gather(tables, 1,
                       torch.clamp(p2 // block_size, 0, max_blocks - 1).long())
    p = p2.reshape(-1)
    return {
        "token_ids": tok.reshape(-1),
        "token_slot": slot,
        "token_pos": p,
        "kv_dest": blk.reshape(-1) * block_size + p % block_size,
        "block_tables": tables,
        "context_lens": pos + k_tokens,
        "logits_idx": torch.arange(S * k_tokens, dtype=torch.int32,
                                   device=dev),
    }


def _pack_tables_positions(seqs, max_seqs: int, max_blocks: int):
    """Host-side [S, B] block table + [S] position arrays for live decode
    sequences (trash-padded)."""
    tables = np.full((max_seqs, max_blocks), BlockedAllocator.TRASH_BLOCK,
                     np.int32)
    pos = np.zeros((max_seqs,), np.int32)
    for i, seq in enumerate(seqs):
        tables[i, :len(seq.blocks)] = seq.blocks
        pos[i] = seq.seen_tokens
    return tables, pos


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceEngineV2:
    """reference engine_v2.py:30.  ``model``: a :class:`RaggedLlama` or
    :class:`RaggedMixtral`.  ``device=None`` runs on CUDA (and raises
    without a GPU); pass ``device="cpu"`` for the plain PyTorch paths."""

    #: q-tile of the tiled prefill kernel: chunks pack tile-aligned when
    #: every scheduled chunk is at least this long (both engines build the
    #: same batches)
    PREFILL_TILE = 128
    #: decode_loop chunk sizes (the JAX package's scan-length buckets)
    DECODE_CHUNKS = (64, 16, 4, 1)

    def __init__(self, model: Any, params: Any,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 device=None):
        self.config = config or RaggedInferenceEngineConfig()
        self.device = resolve_device(device)
        sm_cfg = self.config.state_manager
        kv_cfg = self.config.kv_cache
        self.model = model
        self.params = _tree_to(params, self.device)
        self.state_manager = DSStateManager(
            sm_cfg, kv_cfg, num_layers=model.num_layers,
            num_kv_heads=model.num_kv_heads, head_dim=model.head_dim,
            dtype=getattr(model.config, "dtype", None), device=self.device)
        if self.state_manager.kv_cache.quantized:
            if not getattr(model, "supports_quantized_kv", False):
                raise ValueError(
                    f"kv_cache.dtype=int8 needs a model whose attention "
                    f"path quantizes on insert and fuses the dequant "
                    f"(RaggedLlama family); {type(model).__name__} would "
                    f"silently write float KV into an int8 pool")
            if getattr(model, "tp", 1) > 1:
                raise ValueError(
                    "int8 KV does not compose with tensor parallelism "
                    "yet — the scale records need their own kv-head "
                    "partition spec")
        self._max_blocks = -(-sm_cfg.max_context // kv_cfg.block_size)
        self._batch = RaggedBatchWrapper(
            token_budget=sm_cfg.max_ragged_batch_size,
            max_seqs=sm_cfg.max_ragged_sequence_count,
            max_blocks=self._max_blocks,
            block_size=kv_cfg.block_size)
        # Token-dim buckets (the JAX package's compile buckets): a decode
        # step runs a small batch instead of the prefill-sized one
        budget = sm_cfg.max_ragged_batch_size
        self._buckets = sorted({b for b in (16, 64, 256, 1024)
                                if b < budget} | {budget})
        #: device-resident decode metadata (block tables + positions),
        #: re-uploaded only when the host scheduler changes a table
        self._dev_decode_state: Optional[Dict[str, Any]] = None
        log_dist(
            f"InferenceEngineV2: device={self.device} "
            f"token_budget={sm_cfg.max_ragged_batch_size} "
            f"max_seqs={sm_cfg.max_ragged_sequence_count} "
            f"kv_blocks={self.state_manager.allocator.num_blocks} "
            f"block_size={kv_cfg.block_size}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Scheduling predicates (reference can_schedule:181 / query:153)
    # ------------------------------------------------------------------ #
    def query(self, uid: int) -> Dict[str, int]:
        """Per-sequence status (reference ``query`` returns max lengths)."""
        seq = self.state_manager.get_sequence(uid)
        sm = self.state_manager
        committed = (seq.seen_tokens + len(seq.pending)) if seq else 0
        slack = (len(seq.blocks) * sm.block_size - committed) if seq else 0
        headroom = min(sm.free_blocks * sm.block_size + max(slack, 0),
                       self.config.state_manager.max_context - committed)
        return {
            "tracked": seq is not None,
            "seen_tokens": seq.seen_tokens if seq else 0,
            "pending_tokens": len(seq.pending) if seq else 0,
            "free_blocks": sm.free_blocks,
            "max_new_tokens": max(headroom, 0),
        }

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> bool:
        """Would scheduling `lengths[i]` new tokens for `uids[i]` fit the
        token budget, sequence slots, and free KV blocks right now?"""
        if len(uids) > self._batch.max_seqs:
            return False
        if sum(lengths) > self._batch.token_budget:
            return False
        max_context = self.config.state_manager.max_context
        blocks = 0
        for uid, n in zip(uids, lengths):
            seq = self.state_manager.get_sequence(uid)
            have = (seq.seen_tokens + len(seq.pending)) if seq else 0
            if have + n > max_context:
                return False
            if seq is None:
                blocks += -(-n // self.state_manager.block_size)
            else:
                blocks += self.state_manager.blocks_needed(seq, n)
        return blocks <= self.state_manager.free_blocks

    def attach_prefix(self, uid: int, tokens: Sequence[int]) -> int:
        """Create sequence ``uid`` (it must not be live) attached to the
        warm KV blocks covering the longest cached prefix of ``tokens``.
        Returns the number of prefill tokens skipped (0 when the prefix
        cache is disabled or misses) — the caller feeds only
        ``tokens[cached:]`` through :meth:`put`."""
        seq = self.state_manager.get_or_create_sequence(uid)
        return self.state_manager.attach_prefix(
            seq, [int(t) for t in tokens])

    @property
    def prefix_cache_stats(self):
        """Live :class:`PrefixCacheStats` (None when caching is off)."""
        pc = self.state_manager.prefix_cache
        return pc.stats if pc is not None else None

    # ------------------------------------------------------------------ #
    # put (reference engine_v2.py:107)
    # ------------------------------------------------------------------ #
    def put(self, uids: Sequence[int],
            tokens: Sequence[Sequence[int]],
            sync: bool = True) -> Dict[int, Any]:
        """Schedule new tokens for the given sequences and run forwards until
        every scheduled chunk has been consumed.

        Returns ``{uid: logits[vocab]}`` (float32 numpy) for every uid —
        chunked prompts loop internally until drained.  With ``sync=False``
        the values are device rows (no host copy).
        """
        max_context = self.config.state_manager.max_context
        for uid, toks in zip(uids, tokens):
            if len(toks) == 0:
                raise ValueError(f"put: empty token list for uid {uid}")
            fresh = self.state_manager.get_sequence(uid) is None
            seq = self.state_manager.get_or_create_sequence(uid)
            if fresh:
                # new sequence: skip the prefill of any cached prefix
                # (sequences pre-created via attach_prefix already did)
                cached = self.state_manager.attach_prefix(seq, toks)
                if cached:
                    toks = toks[cached:]
            if seq.seen_tokens + len(seq.pending) + len(toks) > max_context:
                raise RuntimeError(
                    f"sequence {uid} would exceed max_context {max_context} "
                    f"({seq.seen_tokens} seen + {len(seq.pending)} pending "
                    f"+ {len(toks)} new); check can_schedule()/query() first")
            seq.pending.extend(int(t) for t in toks)
        results: Dict[int, Any] = {}
        while self._has_pending(uids):
            results.update(self._run_one_batch(uids, sync=sync))
        return results

    def _has_pending(self, uids) -> bool:
        return any(self.state_manager.get_sequence(u) is not None
                   and self.state_manager.get_sequence(u).pending
                   for u in uids)

    def _run_one_batch(self, uids, sync: bool = True) -> Dict[int, Any]:
        """Build one ragged batch under the token budget (SplitFuse
        chunking), run the forward, and return logits for slots whose
        pending queue drained."""
        sm = self.state_manager
        self._batch.clear()
        # tile-aligned packing when every live chunk is long enough that
        # aligning each to a PREFILL_TILE boundary wastes < half the budget
        # (pads then carry position -1); the model gets the tile, and one
        # that forwards it (Mixtral) takes the tiled prefill kernel
        tile = self.PREFILL_TILE
        pend = [len(sm.get_sequence(u).pending) for u in uids
                if sm.get_sequence(u) is not None
                and sm.get_sequence(u).pending]
        use_tiles = (bool(pend) and min(pend) >= tile
                     and self._batch.token_budget >= tile
                     and self._batch.token_budget % tile == 0)
        if use_tiles:
            self._batch.set_alignment(tile)
        scheduled: List[int] = []
        drained: List[bool] = []
        for uid in uids:
            seq = sm.get_sequence(uid)
            if seq is None or not seq.pending:
                continue
            room = self._batch.token_budget - self._batch._next_start()
            if room <= 0 or self._batch.current_sequences >= \
                    self._batch.max_seqs:
                break
            chunk = seq.pending[:room]               # Dynamic SplitFuse
            sm.maybe_allocate_kv(seq, len(chunk))
            self._batch.insert_sequence(seq, np.asarray(chunk, np.int32))
            scheduled.append(uid)
            drained.append(len(chunk) == len(seq.pending))
        if not scheduled:
            return {}

        if use_tiles:
            cands = [b for b in self._buckets if b % tile == 0] + [tile]
            bucket = min(b for b in cands
                         if b >= self._batch.current_tokens)
        else:
            bucket = min(b for b in self._buckets
                         if b >= self._batch.current_tokens)
        meta = self._batch.finalize(bucket)
        packed = torch.from_numpy(pack_metadata(meta)).to(self.device)
        batch = unpack_metadata(packed, bucket, self._batch.max_seqs,
                                self._max_blocks)
        logits, new_cache = self.model(
            self.params, sm.kv_cache.cache, batch,
            prefill_tile=tile if use_tiles else None)
        sm.kv_cache.update(new_cache)

        out: Dict[int, Any] = {}
        logits_host = None
        for slot, (uid, done) in enumerate(zip(scheduled, drained)):
            seq = sm.get_sequence(uid)
            n = self._batch.chunk_sizes[slot]
            sm.record_fed_tokens(seq, seq.pending[:n])
            seq.seen_tokens += n
            del seq.pending[:n]
            sm.register_prefix(seq)
            if done:
                if not sync:
                    out[uid] = logits[slot]        # lazy device row
                    continue
                if logits_host is None:
                    logits_host = logits.float().cpu().numpy()
                out[uid] = logits_host[slot]
        return out

    # ------------------------------------------------------------------ #
    # Pipelined per-step decode: the host schedules every step (KV
    # allocation, block tables) but token feedback stays on the device.
    # ------------------------------------------------------------------ #
    def decode_step(self, uids: Sequence[int], tokens, greedy: bool = False):
        """One continuous-batching decode step with device-resident token
        feedback.

        ``tokens`` is each sequence's next input token: a host list of ints
        OR a tensor of shape ``[len(uids)]`` / ``[max_seqs]`` — typically
        the greedy tokens the previous call returned.  Every ``uids[i]``
        must be live with no pending prompt tokens (run :meth:`put` first).

        Returns logits ``[max_seqs, vocab]`` as a device tensor without a
        host sync; rows ``>= len(uids)`` are padding.  With ``greedy=True``
        returns ``(logits, next_tokens [max_seqs] int32)``.
        """
        sm = self.state_manager
        S = self._batch.max_seqs
        n = len(uids)
        if n > S:
            raise ValueError(f"decode_step: {n} sequences exceed max_seqs {S}")
        max_context = self.config.state_manager.max_context
        seqs = []
        tables_changed = False
        for uid in uids:
            seq = sm.get_sequence(uid)
            if seq is None or seq.pending:
                raise RuntimeError(
                    f"decode_step: sequence {uid} missing or has pending "
                    f"prompt tokens — run put() first")
            if seq.seen_tokens + 1 > max_context:
                raise RuntimeError(
                    f"decode_step: sequence {uid} would exceed max_context")
            before = len(seq.blocks)
            sm.maybe_allocate_kv(seq, 1)
            tables_changed |= len(seq.blocks) != before
            seqs.append(seq)
        if RAGGED_DEBUG:
            validate_ragged_metadata(seqs, [np.empty(1)] * n, sm.block_size)
        state = self._dev_decode_state
        key = (tuple(uids), tuple(s.seen_tokens for s in seqs))
        if state is None or tables_changed or state["key"] != key:
            tables, pos = _pack_tables_positions(seqs, S, self._max_blocks)
            state = {"tables": torch.from_numpy(tables).to(self.device),
                     "pos": torch.from_numpy(pos).to(self.device)}
        batch = _device_decode_batch(state["tables"], state["pos"],
                                     self._as_token_array(tokens, n, S),
                                     sm.block_size, self._max_blocks)
        logits, new_cache = self.model(self.params, sm.kv_cache.cache, batch,
                                       decode=True)
        sm.kv_cache.update(new_cache)
        host_toks = (None if isinstance(tokens, torch.Tensor)
                     else [int(t) for t in tokens])
        for i, seq in enumerate(seqs):
            if host_toks is not None:
                sm.record_fed_tokens(seq, host_toks[i:i + 1])
            seq.seen_tokens += 1
            sm.register_prefix(seq)
        # device positions advanced in lockstep with seen_tokens
        self._dev_decode_state = {
            "tables": state["tables"], "pos": state["pos"] + 1,
            "key": (tuple(uids), tuple(s.seen_tokens for s in seqs))}
        if greedy:
            return logits, torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    def _as_token_array(self, tokens, n: int, S: int) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            tok = tokens.to(device=self.device, dtype=torch.int32)
            if tok.shape != (S,):
                padded = torch.zeros((S,), dtype=torch.int32,
                                     device=self.device)
                padded[:n] = tok[:n]
                tok = padded
            return tok
        return torch.from_numpy(
            np.pad(np.asarray(tokens, np.int32), (0, S - n))).to(self.device)

    # ------------------------------------------------------------------ #
    # Speculative decoding: one forward scores K candidate positions per
    # sequence — the fed token plus K-1 drafted lookahead tokens — and
    # returns all K logits rows, so the caller accepts the longest matching
    # draft prefix plus one bonus/correction token.  KV for every fed token
    # is written at its position; a rejected lookahead row is overwritten by
    # the next real feed at that position (the causal mask never lets a
    # row see it before then), and a lookahead block past what the accepted
    # tokens need is freed by commit_verified.
    # ------------------------------------------------------------------ #
    def verify_step(self, uids: Sequence[int],
                    tokens: Sequence[Sequence[int]], greedy: bool = False):
        """Score ``tokens[i]`` (K fed tokens for ``uids[i]``: its next input
        token followed by K-1 drafts) in one forward.

        Every row must have the same length K.  Each sequence must be live
        with no pending prompt tokens.  Neither ``seen_tokens`` nor the host
        token record advances here — the caller decides acceptance from the
        returned logits and then calls :meth:`commit_verified` with the
        accepted feed prefix.

        Returns logits ``[max_seqs, K, vocab]`` as a device tensor without a
        host sync (rows ``>= len(uids)`` are padding): row ``[i, k]`` is the
        distribution after consuming ``tokens[i][:k+1]`` — what K sequential
        :meth:`decode_step` calls would return while the drafts match.
        ``greedy=True`` returns ``(logits, next_tokens [max_seqs, K] int32)``
        with the argmax taken on the device.
        """
        sm = self.state_manager
        S, B = self._batch.max_seqs, self._max_blocks
        n = len(uids)
        if n == 0 or n != len(tokens):
            raise ValueError(
                f"verify_step: {n} uids but {len(tokens)} token rows")
        K = len(tokens[0])
        if K < 1 or any(len(t) != K for t in tokens):
            raise ValueError(
                "verify_step: all rows must share one draft length K >= 1")
        if n > S:
            raise ValueError(f"verify_step: {n} sequences exceed "
                             f"max_seqs {S}")
        max_context = self.config.state_manager.max_context
        seqs = []
        for uid in uids:
            seq = sm.get_sequence(uid)
            if seq is None or seq.pending:
                raise RuntimeError(
                    f"verify_step: sequence {uid} missing or has pending "
                    f"prompt tokens — run put() first")
            if seq.seen_tokens + K > max_context:
                raise RuntimeError(
                    f"verify_step: sequence {uid} would exceed "
                    f"max_context {max_context} with {K} lookahead slots")
            sm.maybe_allocate_kv(seq, K)      # K lookahead KV slots
            seqs.append(seq)

        tables, pos = _pack_tables_positions(seqs, S, B)
        tok = np.zeros((S, K), np.int32)
        tok[:n] = np.asarray([[int(t) for t in row] for row in tokens],
                             np.int32)
        packed = torch.from_numpy(np.concatenate(
            [tables.ravel(), pos, tok.ravel()])).to(self.device)  # one upload
        batch = _device_verify_batch(
            packed[:S * B].reshape(S, B), packed[S * B:S * B + S],
            packed[S * B + S:].reshape(S, K), sm.block_size, B, K)
        logits, new_cache = self.model(self.params, sm.kv_cache.cache, batch,
                                       verify_k=K)
        sm.kv_cache.update(new_cache)
        logits = logits.reshape(S, K, -1)
        # lookahead positions moved under any cached decode tables
        self._dev_decode_state = None
        if greedy:
            return logits, torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    def commit_verified(self, uid: int,
                        accepted_tokens: Sequence[int]) -> None:
        """Advance ``uid`` past the accepted prefix of its last
        :meth:`verify_step` feed (KV for those tokens is already written),
        and roll back the rejected lookahead: blocks allocated past what
        ``seen_tokens`` now needs are freed, so the allocator and refcounts
        end exactly where a never-drafted run would.  Accepted tokens are
        recorded host-side and full blocks register into the radix prefix
        cache, as for any other fed token."""
        sm = self.state_manager
        seq = sm.get_sequence(uid)
        if seq is None:
            raise ValueError(f"commit_verified: unknown sequence {uid}")
        a = len(accepted_tokens)
        if a < 1:
            raise ValueError(
                "commit_verified: at least the fed input token is always "
                "accepted (verify emits >= 1 token)")
        sm.record_fed_tokens(seq, accepted_tokens)
        seq.seen_tokens += a
        need = -(-seq.seen_tokens // sm.block_size)
        if len(seq.blocks) > need:
            sm.allocator.free(seq.blocks[need:])
            del seq.blocks[need:]
        sm.register_prefix(seq)
        self._dev_decode_state = None

    # ------------------------------------------------------------------ #
    # Device-resident greedy decode: the JAX package runs each chunk as
    # one lax.scan program; here a chunk is a Python loop whose argmax
    # feedback and position advance stay on the device, with one host
    # sync per chunk.
    # ------------------------------------------------------------------ #
    def decode_loop(self, uids: Sequence[int], tokens: Sequence[int],
                    steps: int) -> np.ndarray:
        """Greedy-decode ``steps`` tokens for live sequences.

        ``tokens[i]`` is sequence ``uids[i]``'s next input token (e.g. the
        argmax of the logits ``put`` just returned). Returns the generated
        tokens ``[len(uids), steps]`` (the first column is the token AFTER
        consuming ``tokens``). Bookkeeping (seen_tokens) is advanced.
        """
        if len(tokens) != len(uids):
            raise ValueError(
                f"decode_loop: {len(uids)} uids but {len(tokens)} tokens")
        if len(uids) > self._batch.max_seqs:
            raise ValueError(
                f"decode_loop: {len(uids)} sequences exceed max_seqs "
                f"{self._batch.max_seqs}")
        max_context = self.config.state_manager.max_context
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is None or seq.pending:
                raise RuntimeError(
                    f"decode_loop: sequence {uid} missing or has pending "
                    f"prompt tokens — run put() first")
            if seq.seen_tokens + steps > max_context:
                raise RuntimeError(
                    f"decode_loop: sequence {uid} would exceed max_context")
        outs = []
        cur = list(tokens)
        remaining = steps
        while remaining:
            k = next(c for c in self.DECODE_CHUNKS if c <= remaining)
            toks = self._decode_chunk(uids, cur, k)    # [n, k]
            outs.append(toks)
            cur = [int(t) for t in toks[:, -1]]
            remaining -= k
        return np.concatenate(outs, axis=1)

    def _decode_chunk(self, uids, tokens, steps: int) -> np.ndarray:
        sm = self.state_manager
        S, B = self._batch.max_seqs, self._max_blocks
        seqs = []
        for uid in uids:
            seq = sm.get_sequence(uid)
            sm.maybe_allocate_kv(seq, steps)
            seqs.append(seq)
        if RAGGED_DEBUG:
            validate_ragged_metadata(
                seqs, [np.empty(steps)] * len(seqs), sm.block_size)
        tables, pos0 = _pack_tables_positions(seqs, S, B)
        tok0 = np.zeros((S,), np.int32)
        tok0[:len(tokens)] = np.asarray([int(t) for t in tokens], np.int32)
        packed = torch.from_numpy(
            np.concatenate([tables.ravel(), pos0, tok0])).to(self.device)
        tables_d = packed[:S * B].reshape(S, B)
        pos = packed[S * B:S * B + S]
        tok = packed[S * B + S:]
        out_tokens = []
        for _ in range(steps):
            batch = _device_decode_batch(tables_d, pos, tok, sm.block_size, B)
            logits, new_cache = self.model(self.params, sm.kv_cache.cache,
                                           batch, decode=True)
            sm.kv_cache.update(new_cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out_tokens.append(tok)
            pos = pos + 1
        result = torch.stack(out_tokens).cpu().numpy().T[:len(uids)]
        for i, seq in enumerate(seqs):
            # KV was written for the fed token plus all but the last
            # generated one
            sm.record_fed_tokens(
                seq, [int(tokens[i])] + result[i][:-1].tolist())
            seq.seen_tokens += steps
            sm.register_prefix(seq)
        return result

    # ------------------------------------------------------------------ #
    # flush (reference engine_v2.py:210)
    # ------------------------------------------------------------------ #
    def flush(self, uids: Sequence[int]) -> None:
        self.state_manager.flush(uids)
        # freed blocks may be re-allocated: device-resident decode tables
        # are stale the moment a sequence is flushed
        self._dev_decode_state = None

    # ------------------------------------------------------------------ #
    # Preemption support: flush_to_host releases a sequence's device
    # blocks and hands back a host snapshot; resume() re-admits by
    # RECOMPUTE — re-prefilling the full token history the caller kept —
    # or, given a snapshot with the KV rows, by scattering them back.
    # ------------------------------------------------------------------ #
    def flush_to_host(self, uids: Sequence[int],
                      include_kv: bool = False) -> Dict[int, Dict[str, Any]]:
        """Release device KV for ``uids`` (preemption).  Returns per-uid
        host snapshots ``{"seen_tokens", "pending_tokens"}`` — the caller
        owns the token history and re-admits via :meth:`resume`.

        ``include_kv=True`` also copies each sequence's KV rows to the host
        (``"kv"``: a per-layer tree of ``[blocks * block_size, ...]`` CPU
        tensors in block-table order, int8 scales included) so another
        engine over the same model can :meth:`resume` without the
        recompute — the disaggregated prefill → decode handoff."""
        out: Dict[int, Dict[str, Any]] = {}
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is None:
                raise ValueError(f"flush_to_host: unknown sequence {uid}")
            snap: Dict[str, Any] = {"seen_tokens": seq.seen_tokens,
                                    "pending_tokens": len(seq.pending)}
            if include_kv and seq.blocks:
                snap["kv"] = self.state_manager.kv_cache.gather_blocks(
                    seq.blocks)
                snap["block_size"] = self.state_manager.block_size
            out[uid] = snap
        self.flush(uids)
        return out

    def resume(self, uid: int, tokens: Sequence[int], sync: bool = True,
               kv_state: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
        """Re-admit a flushed sequence (it must not be live).

        Without ``kv_state``: recompute — re-prefill the full token history
        (prompt + tokens generated before preemption) and return the last
        token's logits, exactly as :meth:`put` would.

        With ``kv_state`` (a :meth:`flush_to_host` ``include_kv=True``
        snapshot, possibly from another engine of identical geometry):
        allocate fresh blocks, scatter the carried KV rows in, and mark
        ``tokens[:seen_tokens]`` as already seen — no recompute.  Only the
        tail ``tokens[seen_tokens:]`` (if any) runs through :meth:`put`;
        when the tail is empty the return is ``{}`` and the next
        :meth:`decode_step` / ``put`` feeds from position ``seen_tokens``.
        """
        sm = self.state_manager
        if sm.get_sequence(uid) is not None:
            raise RuntimeError(
                f"resume: sequence {uid} is still live — it was never "
                f"flushed, or the uid was reused")
        if kv_state is None or "kv" not in kv_state:
            return self.put([uid], [tokens], sync=sync)
        seen = int(kv_state["seen_tokens"])
        if not 0 < seen <= len(tokens):
            raise ValueError(
                f"resume: kv_state covers {seen} tokens but {len(tokens)} "
                f"token values were supplied")
        if kv_state.get("block_size", sm.block_size) != sm.block_size:
            raise ValueError(
                f"resume: kv_state block_size "
                f"{kv_state.get('block_size')} != {sm.block_size}")
        n_blocks = -(-seen // sm.block_size)
        seq = sm.get_or_create_sequence(uid)
        try:
            seq.blocks = sm._allocate(n_blocks)
            need_rows = n_blocks * sm.block_size
            payload = {lname: {leaf: h[:need_rows] for leaf, h in lv.items()}
                       for lname, lv in kv_state["kv"].items()}
            sm.kv_cache.scatter_blocks(seq.blocks, payload)
        except Exception:
            if seq.blocks:
                sm.allocator.free(seq.blocks)
            del sm._seqs[uid]
            raise
        seq.seen_tokens = seen
        sm.record_fed_tokens(seq, tokens[:seen])
        sm.register_prefix(seq)
        # freshly scattered blocks invalidate any cached decode tables
        self._dev_decode_state = None
        if len(tokens) > seen:
            return self.put([uid], [list(tokens)[seen:]], sync=sync)
        return {}

    def serialize(self, save_path: str) -> None:
        raise NotImplementedError(
            "serialize is not ported to deepspeed_tpu_torch yet")

    @classmethod
    def from_hf(cls, model_path: str,
                config: Optional[RaggedInferenceEngineConfig] = None,
                mesh=None, dtype=None, quantize_bits: Optional[int] = None,
                quantize_groups: int = 64, device=None):
        """Serve a HuggingFace checkpoint directory (Llama / Mistral /
        InternLM or Mixtral; ``checkpoint/hf_loader.py``), every tensor
        landing on ``device`` (default CUDA) as it is read.

        ``quantize_bits=8``: weight-only quantized serving, Llama family
        only.  The projection weights are quantized on the device by
        ``WeightQuantization(...).model_quantize(params,
        exclude=("embed",))`` (on the card the int8 quantizer kernel, one
        call a matrix) and REST as int8 ``{"q", "scale"}`` records, which
        every projection reads through the int8 matmul kernel.  ``mesh``
        (tensor parallelism) raises naming ROADMAP A6.
        """
        from deepspeed_tpu_torch.checkpoint.hf_loader import (
            config_from_hf, load_hf_checkpoint)
        from deepspeed_tpu_torch.inference.v2.model_implementations import (
            RaggedLlama, RaggedMixtral)

        if mesh is not None:
            raise NotImplementedError(
                "from_hf(mesh=...): tensor-parallel serving is not ported "
                "to deepspeed_tpu_torch yet (ROADMAP A6)")
        cfg = config or RaggedInferenceEngineConfig()
        dtype = dtype or torch.bfloat16
        arch, mcfg = config_from_hf(model_path, dtype)
        llama_family = arch in ("llama", "mistral", "internlm")
        if quantize_bits and not llama_family:
            raise ValueError(
                f"weight-quantized serving covers the Llama-family ragged "
                f"models; {arch!r} still consumes plain kernels")
        block_size = cfg.kv_cache.block_size
        model = (RaggedLlama if llama_family else RaggedMixtral)(mcfg,
                                                                 block_size)
        dev = resolve_device(device)
        params = load_hf_checkpoint(model_path, dtype=dtype, device=dev)
        if quantize_bits:
            from deepspeed_tpu_torch.runtime.weight_quantizer import (
                WeightQuantization)

            wq = WeightQuantization(quantize_bits=quantize_bits,
                                    quantize_groups=quantize_groups)
            params, n = wq.model_quantize(params, exclude=("embed",))
            log_dist(f"InferenceEngineV2: int{quantize_bits} weight-only "
                     f"quantization on {n} matrices", ranks=[0])
        return cls(model, params, cfg, device=dev)

    # ------------------------------------------------------------------ #
    # Observability: live occupancy
    # ------------------------------------------------------------------ #
    def occupancy(self) -> Dict[str, float]:
        """Live ``observability/kv_*`` + ``observability/hbm_*`` gauges
        — host-side bookkeeping only (allocator free lists, refcounts,
        ``seen_tokens``, static geometry arithmetic): safe to scrape
        between steady-state decode ticks without a device sync."""
        from deepspeed_tpu_torch.observability.memory import (hbm_footprint,
                                                              kv_occupancy)

        out = kv_occupancy(self.state_manager)
        # weights only: kv_occupancy already carries the pool bytes —
        # the same quantity must not scrape under two names
        out.update(hbm_footprint(self.params))
        return out

    def capture_memory_ledger(self, ledger=None):
        raise NotImplementedError(
            "the memory ledger is not ported to deepspeed_tpu_torch yet")

    # ------------------------------------------------------------------ #
    # Convenience generation loop (the role MII plays above the reference
    # engine: repeated put() of one token per live sequence)
    # ------------------------------------------------------------------ #
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 uids: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        if uids is None:
            uids = list(range(len(prompts)))
        outs: Dict[int, List[int]] = {u: [] for u in uids}
        live = list(uids)
        logits = self.put(uids, prompts)
        if eos_token_id is None and max_new_tokens > 1:
            # no early exit needed -> device-resident decode, grouped by
            # max_seqs (decode_loop batches one slot per sequence)
            first = {u: int(np.argmax(logits[u])) for u in uids}
            rest: Dict[int, np.ndarray] = {}
            S = self._batch.max_seqs
            for g in range(0, len(uids), S):
                grp = list(uids[g:g + S])
                toks = self.decode_loop(grp, [first[u] for u in grp],
                                        max_new_tokens - 1)
                for i, u in enumerate(grp):
                    rest[u] = toks[i]
            self.flush(uids)
            return [np.asarray([first[u]] + rest[u].tolist(), np.int32)
                    for u in uids]
        for _ in range(max_new_tokens):
            nxt = {u: int(np.argmax(logits[u])) for u in live}
            for u in live:
                outs[u].append(nxt[u])
            live = [u for u in live
                    if not (eos_token_id is not None
                            and nxt[u] == eos_token_id)]
            if not live:
                break
            logits = self.put(live, [[nxt[u]] for u in live])
        self.flush(uids)
        return [np.asarray(outs[u], np.int32) for u in uids]
