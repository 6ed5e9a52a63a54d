"""Post-training weight quantization for inference checkpoints (counterpart
of ``deepspeed_tpu/runtime/weight_quantizer.py``; reference:
runtime/weight_quantizer.py ``WeightQuantization``, groupwise int8/int4 of
transformer weights before module injection).

Built on :mod:`deepspeed_tpu_torch.ops.quantizer`: each leaf is quantized
groupwise (on a CUDA tensor at 8 bits, by the hand-written kernel);
``model_quantize`` walks a param tree of nested dicts and replaces selected
2D+ leaves with ``{"q": int8 tensor in the weight's shape, "scale":
[groups] fp32}`` records, the records ``ops/quantized_matmul.py`` reads, and
``dequantize_tree`` restores compute-precision weights.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from deepspeed_tpu_torch.ops.quantized_matmul import (dequant_reference,
                                                      is_quant_record)
from deepspeed_tpu_torch.ops.quantizer import quantize


class WeightQuantization:
    def __init__(self, mlp_extra_grouping: bool = False,
                 quantize_bits: int = 8, quantize_groups: int = 1):
        self.mlp_extra_grouping = mlp_extra_grouping
        self.quantize_bits = quantize_bits
        self.quantize_groups = quantize_groups

    MIN_SIZE_DEFAULT = 1024

    @staticmethod
    def leaf_name(path) -> str:
        """'/'-joined tree-path name (the format group matching uses)."""
        return "/".join(str(k) for k in path)

    @staticmethod
    def should_quantize(leaf, min_size: int = MIN_SIZE_DEFAULT) -> bool:
        """The single eligibility rule: matrices of >= min_size elements."""
        return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 \
            and leaf.numel() >= min_size

    def groups_for(self, name: str) -> int:
        g = self.quantize_groups
        if self.mlp_extra_grouping and ("mlp" in name or "ffn" in name):
            g *= 2  # reference doubles groups for MLP weights
        return g

    def quantize_leaf(self, w: torch.Tensor, groups: int, align: int = 1
                      ) -> Dict[str, torch.Tensor]:
        """Record = {q: int8 in the WEIGHT'S shape, scale: [groups]}.

        Groups are blocks of LEADING-dim rows (groups | dim0), so a record
        is TP-sliceable: a dim-0 (row-parallel) shard of ``q`` owns whole
        groups when ``groups`` is a multiple of the shard count (pass it as
        ``align``), and a dim-1 shard never splits a group at all.
        """
        rows = int(w.shape[0])
        groups = max(1, min(groups, rows))
        align = max(1, align)
        if rows % align == 0:
            # largest multiple of `align` that divides rows, <= wanted size
            g = (groups // align) * align
            while g >= align and rows % g != 0:
                g -= align
            groups = g if g >= align else align
        else:  # cannot align (leaf not actually dim-0 sharded)
            while rows % groups != 0:
                groups -= 1
        q, scale, _ = quantize(w, groups, self.quantize_bits, True)
        return {"q": q.reshape(w.shape), "scale": scale}

    def model_quantize(self, params: Any,
                       min_size: int = MIN_SIZE_DEFAULT,
                       exclude: Tuple[str, ...] = ()
                       ) -> Tuple[Any, int]:
        """Quantize every matrix leaf with >= min_size elements.  Returns
        (tree with {q, scale} records, count quantized).  Leaves whose
        '/'-joined path contains any ``exclude`` substring stay
        full-precision (serving excludes embedding tables: a lookup
        touches a handful of rows)."""
        count = 0

        def walk(node, path):
            nonlocal count
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            name = self.leaf_name(path)
            if not self.should_quantize(node, min_size) or \
                    any(e in name for e in exclude):
                return node
            count += 1
            return self.quantize_leaf(node.contiguous(),
                                      self.groups_for(name))

        return walk(params, ()), count

    @staticmethod
    def is_quantized_record(leaf) -> bool:
        return is_quant_record(leaf)

    def dequantize_tree(self, tree: Any, dtype=torch.bfloat16) -> Any:
        """Restore compute-precision weights (dim 0 split into groups, the
        scale broadcast over the rest)."""
        if self.is_quantized_record(tree):
            return dequant_reference(tree, dtype)
        if isinstance(tree, dict):
            return {k: self.dequantize_tree(v, dtype) for k, v in tree.items()}
        return tree
