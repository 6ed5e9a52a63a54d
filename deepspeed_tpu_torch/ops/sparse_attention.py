"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention.py``; reference:
deepspeed/ops/sparse_attention/ — ``SparsityConfig`` family
sparsity_config.py, ``SparseSelfAttention`` sparse_self_attention.py, Triton
block-sparse matmul/softmax kernels in trsrc/; built by
op_builder/sparse_attn.py).

Layouts are block-granular boolean masks [heads, nblocks, nblocks] built on
host numpy, as in the JAX package: Fixed, Variable, BigBird and BSLongformer
patterns, with the same ``np.random.default_rng(seed)`` call sequence, so a
layout here is bit-equal to the JAX package's.  :func:`sparse_self_attention`
is the dense-masked fp32 composition (O(S^2) work, the correctness
reference); :class:`SparseSelfAttention` routes to the block-skipping
kernels of :mod:`deepspeed_tpu_torch.ops.block_sparse_attention`.

Routing (``implementation``): "pallas" = the hand-written kernels (on CPU
tensors their plain version); "xla" = the dense composition; "auto" = the
kernels (the JAX package takes them only on a TPU).  A key-padding mask
goes into the kernels as a key bias (:func:`key_padding_bias`), so on the
card "auto" and "pallas" run the kernels with a mask too; on CPU tensors
"auto" with a mask takes the dense composition, the JAX package's rule.
``LAUNCHES["sparse_self_attention_dense"]`` counts the calls that take the
dense composition.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.block_sparse_attention import (
    BlockSparseLayout, block_sparse_attention)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "SparseSelfAttention",
    "sparse_self_attention", "SparseAttnBuilder", "expand_layout",
    "key_padding_bias",
]

#: calls of SparseSelfAttention that took the dense composition
LAUNCHES = {"sparse_self_attention_dense": 0}


class SparsityConfig:
    """Base: block size + heads (reference sparsity_config.py:10)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[...] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Windows of ``num_local_blocks``; the last ``num_global_blocks`` of
    each window attend/are attended globally (reference :95)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention type {attention!r}")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional")
        self.num_different_global_patterns = num_different_global_patterns
        if num_different_global_patterns > 1 and \
                not different_layout_per_head:
            raise ValueError("multiple global patterns need "
                             "different_layout_per_head=True")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_heads):
            # local windows
            for start in range(0, n, self.num_local_blocks):
                end = min(start + self.num_local_blocks, n)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" \
                        else end
                    layout[h, r, start:hi] = True
            # global pattern: head picks which sub-slot of the window
            pat = h % self.num_different_global_patterns
            blocks_per_pat = max(
                1, self.num_local_blocks //
                max(1, self.num_different_global_patterns))
            first = (pat + 1) * blocks_per_pat - self.num_global_blocks
            for start in range(0, n, self.num_local_blocks):
                g0 = start + max(0, first)
                g1 = min(g0 + self.num_global_blocks, n)
                if self.attention == "unidirectional":
                    # later rows attend back to this window's global blocks
                    layout[h, start + self.num_local_blocks:, g0:g1] = True
                else:
                    layout[h, :, g0:g1] = True
                    if self.horizontal_global_attention:
                        layout[h, g0:g1, :] = True
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Random + custom-width local windows + global first blocks
    (reference :239)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_heads):
            # local windows of varying width, repeating the last width
            r = 0
            widths = list(self.local_window_blocks)
            while r < n:
                w = widths.pop(0) if widths else self.local_window_blocks[-1]
                end = min(r + w, n)
                for row in range(r, end):
                    hi = (row + 1) if self.attention == "unidirectional" \
                        else end
                    layout[h, row, r:hi] = True
                r = end
            # random blocks
            for row in range(n):
                if self.num_random_blocks:
                    lim = row + 1 if self.attention == "unidirectional" else n
                    cols = self.rng.choice(
                        lim, size=min(self.num_random_blocks, lim),
                        replace=False)
                    layout[h, row, cols] = True
            # global columns/rows
            ends = self.global_block_end_indices
            for i, g in enumerate(self.global_block_indices):
                g1 = ends[i] if ends else g + 1
                layout[h, :, g:g1] = True
                if self.horizontal_global_attention:
                    layout[h, g:g1, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding-window + global first/last blocks (reference
    :411)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for row in range(n):
                layout[h, row, max(0, row - w):min(n, row + w + 1)] = True
                lim = row + 1 if self.attention == "unidirectional" else n
                cols = self.rng.choice(
                    lim, size=min(self.num_random_blocks, lim),
                    replace=False)
                layout[h, row, cols] = True
            g = self.num_global_blocks
            layout[h, :, :g] = True
            layout[h, :g, :] = True
            if self.attention == "bidirectional":
                layout[h, :, n - g:] = True
                layout[h, n - g:, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """sliding window + designated global blocks (reference :519)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for row in range(n):
                layout[h, row, max(0, row - w):min(n, row + w + 1)] = True
            ends = self.global_block_end_indices
            for i, g in enumerate(self.global_block_indices):
                g1 = ends[i] if ends else g + 1
                layout[h, :, g:g1] = True
                layout[h, g:g1, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self.check_and_propagate_first_head_layout(layout)


# ------------------------------------------------------------------ #
def expand_layout(layout: np.ndarray, block: int, device=None
                  ) -> torch.Tensor:
    """[h, nb, nb] block layout -> [h, s, s] bool element mask on ``device``
    (cache the result, as :class:`SparseSelfAttention` does, rather than
    rebuilding it a call)."""
    m = torch.from_numpy(np.asarray(layout, bool)).to(device)
    return m.repeat_interleave(block, 1).repeat_interleave(block, 2)


def key_padding_bias(key_padding_mask: torch.Tensor, mode: str = "mul"
                     ) -> torch.Tensor:
    """A ``[batch, seq]`` key-padding mask as the kernels' fp32 key bias:
    mode "mul" (a keep mask) gives 0 where it keeps a key and -inf where it
    is 0; mode "add" (an additive mask) is the bias itself."""
    if mode == "mul":
        return torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                           device=key_padding_mask.device).masked_fill_(
                               key_padding_mask == 0, float("-inf"))
    if mode == "add":
        return key_padding_mask.float()
    raise ValueError(f"unknown key_padding_mask_mode {mode!r}")


def sparse_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          layout: np.ndarray, block: int,
                          scale: Optional[float] = None,
                          key_padding_mask: Optional[torch.Tensor] = None,
                          key_padding_mask_mode: str = "mul",
                          expanded_mask: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """Attention under a block layout. q/k/v: [batch, heads, seq, dim];
    layout: [heads, nb, nb] bool (reference SparseSelfAttention.forward via
    Triton block-sparse sdd/softmax/dsd matmuls).

    ``key_padding_mask``: [batch, seq]; mode "mul" = boolean/0-1 keep
    mask, "add" = additive float mask (0 keep, large-negative drop) --
    the reference's two mask modes.
    """
    b, h, s, d = q.shape
    nb = layout.shape[1]
    if nb * block != s:
        raise ValueError(f"layout {nb}x{block} != seq {s}")
    scale = scale if scale is not None else 1.0 / float(np.sqrt(d))
    mask = expanded_mask if expanded_mask is not None \
        else expand_layout(layout, block, q.device)
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[None], -1e30)
    if key_padding_mask is not None:
        kp = key_padding_mask[:, None, None, :]
        if key_padding_mask_mode == "mul":
            scores = scores.masked_fill(kp == 0, -1e30)
        elif key_padding_mask_mode == "add":
            scores = scores + kp.float()
        else:
            raise ValueError(
                f"unknown key_padding_mask_mode {key_padding_mask_mode!r}")
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(q.dtype)


class SparseSelfAttention:
    """Module-style wrapper (reference sparse_self_attention.py:28).

    ``implementation``: 'pallas' = the block-SKIPPING kernels
    (:mod:`deepspeed_tpu_torch.ops.block_sparse_attention`, the Triton
    sdd/softmax/dsd analog -- empty tiles do no work; on CPU tensors their
    plain version), a key-padding mask going in as their key bias; 'xla' =
    the dense-masked composition (correctness reference; O(S^2)); 'auto' =
    the kernels, except on CPU tensors with a key-padding mask (the dense
    composition there, the JAX package's rule).
    """

    def __init__(self, sparsity_config: SparsityConfig,
                 key_padding_mask_mode: str = "mul",
                 attn_mask_mode: str = "mul",
                 implementation: str = "auto"):
        if key_padding_mask_mode not in ("mul", "add"):
            raise ValueError(
                f"unknown key_padding_mask_mode {key_padding_mask_mode!r}")
        if implementation not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown implementation {implementation!r}")
        self.config = sparsity_config
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.implementation = implementation
        #: seq_len -> (layout, {device: expanded mask})
        self._layouts = {}
        #: seq_len -> BlockSparseLayout (its device tables cached inside)
        self._bs_layouts = {}

    def _use_kernel(self, query, key_padding_mask) -> bool:
        if self.implementation == "xla":
            return False
        return (key_padding_mask is None or self.implementation == "pallas"
                or query.is_cuda)

    def __call__(self, query, key, value, key_padding_mask=None):
        s = query.shape[2]
        if self._use_kernel(query, key_padding_mask):
            if s not in self._bs_layouts:
                self._bs_layouts[s] = BlockSparseLayout(
                    self.config.make_layout(s), self.config.block, s)
            bias = None if key_padding_mask is None else key_padding_bias(
                key_padding_mask, self.key_padding_mask_mode)
            return block_sparse_attention(query, key, value,
                                          self._bs_layouts[s],
                                          key_bias=bias)
        if s not in self._layouts:
            self._layouts[s] = (self.config.make_layout(s), {})
        layout, masks = self._layouts[s]
        if query.device not in masks:
            masks[query.device] = expand_layout(layout, self.config.block,
                                                query.device)
        LAUNCHES["sparse_self_attention_dense"] += 1
        return sparse_self_attention(
            query, key, value, layout, self.config.block,
            key_padding_mask=key_padding_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            expanded_mask=masks[query.device])


class SparseAttnBuilder:
    NAME = "sparse_attn"

    def load(self):
        import deepspeed_tpu_torch.ops.sparse_attention as m
        return m

    def is_compatible(self) -> bool:
        return True
