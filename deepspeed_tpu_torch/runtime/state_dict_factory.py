"""Tensor-parallel state-dict merge / split (counterpart of
``deepspeed_tpu/runtime/state_dict_factory.py``; reference:
runtime/state_dict_factory.py ``SDLoaderFactory`` / ``MegatronSDLoader`` —
merge N tensor-parallel checkpoint shards into M, splitting or
concatenating each weight along its TP dim).

Checkpoints are nested dicts of numpy arrays.  A merge / split plan is a
tree of per-leaf entries — ``None`` (replicated, validated identical
across shards), an ``axis`` int, or ``("qkv", axis)`` for fused QKV
projections whose shards interleave three blocks (merging those naively
along the axis would produce ``[q0 k0 v0 q1 k1 v1]`` instead of
``[q0 q1 | k0 k1 | v0 v1]``; the reference categorizes exactly this case,
state_dict_factory.py:427 ``merge_query_key_value``).

The plan comes from names alone: :func:`axes_from_policy` matches each
leaf's '/'-joined path against an architecture's rules, ``(regex, spec)``
with ``spec`` a tuple naming each dimension's mesh axis (``"model"`` or
None) as the JAX package's ``PartitionSpec`` rules do; the position of
``"model"`` is the leaf's merge / split axis.  No mesh is involved.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.tensors import _items

# Fused attention projections that pack [q-block|k-block|v-block] along
# their TP axis (Megatron / GPT-2 convention) need the interleaved merge.
# ``query_key_value`` (BLOOM / GPT-NeoX / Falcon) is deliberately not here:
# that family fuses per head ``[h, 3, d]``, where heads are contiguous along
# the axis and a plain contiguous slice is the correct TP split.
QKV_FUSED_PATTERN = re.compile(r"(c_attn|qkv_proj|w_qkv)")

COL, ROW, REP = (None, "model"), ("model", None), ()

#: the JAX package's TP rules by architecture (``models/llama.py``
#: ``LLAMA_PARTITION_RULES``, ``models/gpt2.py`` ``GPT2_PARTITION_RULES``
#: and ``module_inject/replace_policy.py``), as name -> spec tuples
_LLAMA = [
    (r"embed_tokens/embedding", ROW),
    (r"(q_proj|k_proj|v_proj|qkv_proj)/kernel", COL),
    (r"o_proj/kernel", ROW),
    (r"(gate_proj|up_proj|gate_up_proj)/kernel", COL),
    (r"down_proj/kernel", ROW),
    (r"lm_head/kernel", COL),
    (r".*norm.*", REP),
]
_GPT2 = [
    (r"wte/embedding", ROW),
    (r"wpe/embedding", REP),
    (r"c_attn/kernel", COL),
    (r"attn_out/kernel", ROW),
    (r"c_fc/kernel", COL),
    (r"c_proj/kernel", ROW),
    (r".*(ln_1|ln_2|ln_f).*", REP),
]
_BLOOM = [
    (r"word_embeddings/embedding", ROW),
    (r"query_key_value/kernel", COL),
    (r"attention/dense/kernel", ROW),
    (r"dense_h_to_4h/kernel", COL),
    (r"dense_4h_to_h/kernel", ROW),
    (r".*layernorm.*", REP),
]
_GPTJ = [
    (r"wte/embedding", ROW),
    (r"(q_proj|k_proj|v_proj)/kernel", COL),
    (r"out_proj/kernel", ROW),
    (r"fc_in/kernel", COL),
    (r"fc_out/kernel", ROW),
    (r".*ln.*", REP),
]
_BERT = [
    (r"word_embeddings/embedding", ROW),
    (r"(query|key|value)/kernel", COL),
    (r"attention/output/dense/kernel", ROW),
    (r"intermediate/dense/kernel", COL),
    (r"(?<!attention/)output/dense/kernel", ROW),
    (r".*layer_?norm.*", REP),
    (r"pooler/dense/kernel", REP),
]
POLICY_REGISTRY: Dict[str, List[Tuple[str, tuple]]] = {
    "llama": _LLAMA, "llama2": _LLAMA, "mistral": _LLAMA,
    "internlm": _LLAMA,
    "mixtral": _LLAMA + [(r"experts.*(w1|w3)/kernel", COL),
                         (r"experts.*w2/kernel", ROW),
                         (r"gate/kernel", REP)],
    "gpt2": _GPT2, "megatron": _GPT2,
    "bloom": _BLOOM,
    "gptneox": _BLOOM + [(r"embed_in/embedding", ROW),
                         (r"embed_out/kernel", COL)],
    "gptj": _GPTJ, "gptneo": _GPTJ,
    "bert": _BERT, "distilbert": _BERT,
}
POLICY_REGISTRY["gpt_neox"] = POLICY_REGISTRY["gptneox"]


def policy_for(architecture: str) -> Optional[List[Tuple[str, tuple]]]:
    """Rules for an architecture name (case-insensitive; accepts HF-style
    class names like 'LlamaForCausalLM')."""
    key = architecture.lower()
    if key in POLICY_REGISTRY:
        return POLICY_REGISTRY[key]
    for name in sorted(POLICY_REGISTRY, key=len, reverse=True):
        if name in key:
            return POLICY_REGISTRY[name]
    return None


def _model_axis(spec: Any) -> Optional[int]:
    """Position of the 'model' axis in a spec (the TP merge / split dim),
    or None when the leaf is replicated over TP."""
    for i, entry in enumerate(tuple(spec)):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in [n for n in names if n]:
            return i
    return None


def axes_from_policy(policy: Any, tree: Any) -> Any:
    """A merge / split plan for ``tree`` from a TP policy: an architecture
    name (:func:`policy_for`) or a rules list ``[(regex, spec), ...]``.
    Each leaf's '/'-joined path is matched against the rules: the matched
    spec's 'model' position becomes the merge axis; fused-QKV names get
    the ``("qkv", axis)`` interleave category; unmatched or replicated
    leaves get ``None``."""
    if isinstance(policy, str):
        rules = policy_for(policy)
        if rules is None:
            raise ValueError(f"no TP policy registered for {policy!r}")
    else:
        rules = policy
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    entries = []           # (parts, leaf, entry)
    kernel_entry = {}      # parent path -> (kernel entry, kernel ndim)
    for parts, leaf in _items(tree):
        name = "/".join(parts)
        axis = None
        for pat, spec in compiled:
            if pat.search(name):
                axis = _model_axis(spec)
                break
        entry: Any = axis
        if axis is not None and QKV_FUSED_PATTERN.search(name):
            entry = ("qkv", axis)
        entries.append((parts, leaf, entry))
        if parts[-1] == "kernel":
            kernel_entry[tuple(parts[:-1])] = (entry, np.ndim(leaf))

    plan: dict = {}
    for parts, leaf, entry in entries:
        # Rules carry */kernel entries only: a column-parallel layer's bias
        # is sliced with its kernel's output dim (Megatron), a
        # row-parallel layer's bias is replicated
        if entry is None and parts[-1] == "bias" and np.ndim(leaf) == 1:
            sib = kernel_entry.get(tuple(parts[:-1]))
            if sib is not None:
                k_entry, k_ndim = sib
                k_axis = k_entry[1] if isinstance(k_entry, tuple) \
                    else k_entry
                if k_axis is not None and k_axis == k_ndim - 1:
                    entry = ("qkv", 0) if isinstance(k_entry, tuple) \
                        else 0
        node = plan
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = entry
    return plan


def _map(fn: Callable, plan: Any, *trees: Any) -> Any:
    """``fn(entry, *leaves)`` over the plan's leaves, the trees walked in
    step with it."""
    if isinstance(plan, dict):
        return {k: _map(fn, v, *(t[k] for t in trees))
                for k, v in plan.items()}
    return fn(plan, *trees)


class SDLoaderFactory:
    @staticmethod
    def get_sd_loader_json(trees: List[Any], merge_axes: Any
                           ) -> "MegatronSDLoader":
        return MegatronSDLoader(trees, merge_axes)

    @staticmethod
    def get_sd_loader(trees: List[Any], architecture: str
                      ) -> "MegatronSDLoader":
        """Auto mode: the plan from the registered TP policy for
        ``architecture`` (reference state_dict_factory.py:427)."""
        return MegatronSDLoader(
            trees, axes_from_policy(architecture, trees[0]))


class MegatronSDLoader:
    """Merge / split TP checkpoint shards (reference state_dict_factory.py
    ``MegatronSDLoader.merge_state_dict/split_state_dict``)."""

    def __init__(self, trees: List[Any], merge_axes: Any):
        if not trees:
            raise ValueError("need at least one checkpoint shard")
        self.trees = trees
        self.merge_axes = merge_axes

    def merge_state_dict(self) -> Any:
        """N shards -> 1 full tree: concat along each leaf's TP axis.
        ``("qkv", axis)`` leaves de-interleave: every shard carries
        ``[q_r|k_r|v_r]`` along the axis, so each third is concatenated
        across shards first, then the thirds re-joined."""
        def one(entry, *leaves):
            if entry is None:
                first = np.asarray(leaves[0])
                for other in leaves[1:]:
                    if not np.array_equal(first, np.asarray(other)):
                        raise ValueError(
                            "replicated leaf differs across shards")
                return leaves[0]
            if isinstance(entry, tuple):
                _, axis = entry
                chunks = [np.split(np.asarray(l), 3, axis=axis)
                          for l in leaves]
                return np.concatenate(
                    [np.concatenate([c[i] for c in chunks], axis=axis)
                     for i in range(3)], axis=axis)
            return np.concatenate([np.asarray(l) for l in leaves],
                                  axis=entry)

        return _map(one, self.merge_axes, *self.trees)

    def split_state_dict(self, num_shards: int) -> List[Any]:
        """1 (merged) tree -> M shards along the same axes.  ``("qkv",
        axis)`` leaves re-interleave so each shard gets its own
        ``[q_r|k_r|v_r]`` block (reference ``split_query_key_value``)."""
        full = self.merge_state_dict() if len(self.trees) > 1 \
            else self.trees[0]

        def split_leaf(entry, leaf):
            if entry is None:
                return [leaf] * num_shards
            axis = entry[1] if isinstance(entry, tuple) else entry
            if leaf.shape[axis] % num_shards != 0:
                raise ValueError(
                    f"dim {axis} of {leaf.shape} not divisible by "
                    f"{num_shards}")
            if isinstance(entry, tuple):
                if leaf.shape[axis] % (3 * num_shards) != 0:
                    raise ValueError(
                        f"fused qkv dim {axis} of {leaf.shape} not "
                        f"divisible by 3*{num_shards}")
                thirds = [np.split(t, num_shards, axis=axis)
                          for t in np.split(np.asarray(leaf), 3,
                                            axis=axis)]
                return [np.concatenate([t[r] for t in thirds], axis=axis)
                        for r in range(num_shards)]
            return np.split(np.asarray(leaf), num_shards, axis=axis)

        pieces = _map(split_leaf, self.merge_axes, full)
        return [_map(lambda _e, p, r=r: p[r], self.merge_axes, pieces)
                for r in range(num_shards)]
