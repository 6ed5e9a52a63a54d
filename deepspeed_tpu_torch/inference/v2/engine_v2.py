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

Not ported yet (each raises ``NotImplementedError``): speculative
``verify_step`` / ``commit_verified``, the ``include_kv`` host handoff of
``flush_to_host`` / ``resume``, ``serialize`` / ``from_hf``, and the memory
ledger.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.v2.config_v2 import (
    RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations.ragged_llama import (
    RaggedLlama)
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
    """reference engine_v2.py:30.  ``device=None`` runs on CUDA (and raises
    without a GPU); pass ``device="cpu"`` for the plain PyTorch paths."""

    #: q-tile of the JAX package's tiled prefill kernel: chunks pack
    #: tile-aligned when every scheduled chunk is at least this long (kept
    #: so both engines build the same batches)
    PREFILL_TILE = 128
    #: decode_loop chunk sizes (the JAX package's scan-length buckets)
    DECODE_CHUNKS = (64, 16, 4, 1)

    def __init__(self, model: RaggedLlama, params: Any,
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
        # (pads then carry position -1).  The JAX model never forwards the
        # tile to its tiled prefill kernel, so only the packing is kept.
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
        logits, new_cache = self.model(self.params, sm.kv_cache.cache, batch)
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

    def verify_step(self, uids, tokens, greedy: bool = False):
        raise NotImplementedError(
            "speculative verify_step is not ported to deepspeed_tpu_torch "
            "yet (it needs the paged verify kernel)")

    def commit_verified(self, uid, accepted_tokens):
        raise NotImplementedError(
            "commit_verified belongs to speculative decoding, which is not "
            "ported to deepspeed_tpu_torch yet")

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
    # RECOMPUTE — re-prefilling the full token history the caller kept.
    # ------------------------------------------------------------------ #
    def flush_to_host(self, uids: Sequence[int],
                      include_kv: bool = False) -> Dict[int, Dict[str, Any]]:
        """Release device KV for ``uids`` (preemption).  Returns per-uid
        host snapshots ``{"seen_tokens", "pending_tokens"}`` — the caller
        owns the token history and re-admits via :meth:`resume`."""
        if include_kv:
            raise NotImplementedError(
                "flush_to_host(include_kv=True) (the KV handoff) is not "
                "ported to deepspeed_tpu_torch yet; resume recomputes")
        out: Dict[int, Dict[str, Any]] = {}
        for uid in uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is None:
                raise ValueError(f"flush_to_host: unknown sequence {uid}")
            out[uid] = {"seen_tokens": seq.seen_tokens,
                        "pending_tokens": len(seq.pending)}
        self.flush(uids)
        return out

    def resume(self, uid: int, tokens: Sequence[int], sync: bool = True,
               kv_state: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
        """Re-admit a flushed sequence by recompute: re-prefill the full
        token history (prompt + tokens generated before preemption) and
        return the last token's logits, exactly as :meth:`put` would."""
        if self.state_manager.get_sequence(uid) is not None:
            raise RuntimeError(
                f"resume: sequence {uid} is still live — it was never "
                f"flushed, or the uid was reused")
        if kv_state is not None and "kv" in kv_state:
            raise NotImplementedError(
                "resume from a KV snapshot is not ported to "
                "deepspeed_tpu_torch yet; resume without kv_state recomputes")
        return self.put([uid], [tokens], sync=sync)

    def serialize(self, save_path: str) -> None:
        raise NotImplementedError(
            "serialize is not ported to deepspeed_tpu_torch yet")

    @classmethod
    def from_hf(cls, model_path: str, *args, **kwargs):
        raise NotImplementedError(
            "from_hf is not ported to deepspeed_tpu_torch yet; build the "
            "params with deepspeed_tpu_torch.checkpoint.jax_params")

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
