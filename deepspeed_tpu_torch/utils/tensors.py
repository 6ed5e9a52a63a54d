"""Nested-dict <-> flat-dict utilities (counterpart of
``deepspeed_tpu/utils/tensors.py``, which walks JAX pytrees; reference: the
flatten / unflatten utils csrc/utils/flatten_unflatten.cpp + runtime/utils.py
tensor helpers).

A tree here is nested dicts (lists and tuples too) of tensors or arrays.
Dict keys are visited in sorted order, as ``jax.tree_util`` visits them, so
a tree flattens to the same names in the same order in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np


def _items(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            yield from _items(node, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_to_flat_dict(tree: Any, sep: str = "/") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` for every leaf of ``tree``."""
    return {sep.join(path): leaf for path, leaf in _items(tree)}


def flat_dict_to_tree(flat: Dict[str, Any], template: Any,
                      sep: str = "/") -> Any:
    """Rebuild a tree with ``template``'s structure from a flat dict."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        key = sep.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing key '{key}'")
        return flat[key]

    return build(template, ())


def _numel(leaf: Any) -> int:
    if hasattr(leaf, "numel"):
        return int(leaf.numel())
    return int(np.prod(getattr(leaf, "shape", ())))


def tree_size_bytes(tree: Any) -> int:
    total = 0
    for _, leaf in _items(tree):
        if hasattr(leaf, "element_size"):
            total += _numel(leaf) * leaf.element_size()
        elif hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
            total += _numel(leaf) * np.dtype(leaf.dtype).itemsize
    return total


def tree_num_params(tree: Any) -> int:
    return sum(_numel(leaf) for _, leaf in _items(tree)
               if hasattr(leaf, "shape"))
