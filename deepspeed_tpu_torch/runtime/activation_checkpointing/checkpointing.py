"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``;
reference ``configure:1070``, ``checkpoint:989``).

``checkpoint(fn, *args)`` runs ``fn`` without keeping its activations and
recomputes them in the backward pass, through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``.  The JAX
package saves the matmul outputs of a remat'd block
(``dots_with_no_batch_dims_saveable``); here the whole block is recomputed.
The values and gradients are the same either way.  RNG state is restored
for the recomputation by PyTorch (``preserve_rng_state``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch.utils.checkpoint

_config = None


def configure(mpu_=None, deepspeed_config=None) -> None:
    """Accepts the engine config's ``activation_checkpointing`` block
    (partitioned and CPU checkpointing are not ported: the config parser
    raises on them)."""
    global _config
    del mpu_
    _config = getattr(deepspeed_config, "activation_checkpointing",
                      deepspeed_config)


def is_configured() -> bool:
    return _config is not None


def checkpoint(function: Callable, *args) -> Any:
    """Recomputed call: the activations of ``function`` are rebuilt in the
    backward pass instead of stored."""
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False)

