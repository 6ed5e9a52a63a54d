"""Elastic training batch algebra (counterpart of
``deepspeed_tpu/elasticity/elasticity.py``, with its names, results and
exceptions; pure host arithmetic.  Reference: elasticity/elasticity.py —
``compute_elastic_config:233``, v0.1 ``_get_compatible_gpus_v01:83``, v0.2
``:126``; config schema elasticity/config.py, constants.py).

Given the user's acceptable micro-batch sizes and a ceiling on the global
batch, pick a global batch size that divides evenly for as many device
counts as possible, so the job can be restarted on a different number of
devices without changing convergence behaviour.  Candidate batches are
micro-batch bases scaled by highly composite numbers — numbers with record
divisor counts — which is exactly what maximises the set of compatible
device counts.

v0.2 works at *node* (host) granularity: device counts must be whole
multiples of the per-node dp degree (devices_per_node / model_parallel).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

LATEST_ELASTICITY_VERSION = 0.2
# the package has supported elasticity since 0.1.0 (the reference's
# analogous floor is its own 0.3.8)
MINIMUM_DEEPSPEED_VERSION = "0.1.0"
ELASTICITY = "elasticity"
DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"


class ElasticityError(Exception):
    """Base error for elasticity problems."""


class ElasticityConfigError(ElasticityError):
    """Invalid elasticity config block."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """Current world size is not in the valid set."""


class ElasticityConfig:
    """Typed view of the ``"elasticity"`` config block (reference
    elasticity/config.py ElasticityConfig)."""

    def __init__(self, param_dict: Dict):
        self.enabled = bool(param_dict.get("enabled", False))
        if "max_train_batch_size" in param_dict:
            self.max_acceptable_batch_size = int(
                param_dict["max_train_batch_size"])
        elif self.enabled:
            raise ElasticityConfigError(
                "elasticity requires 'max_train_batch_size'")
        else:
            self.max_acceptable_batch_size = 2000
        if "micro_batch_sizes" in param_dict:
            self.micro_batches = list(param_dict["micro_batch_sizes"])
        elif self.enabled:
            raise ElasticityConfigError(
                "elasticity requires 'micro_batch_sizes'")
        else:
            self.micro_batches = [2, 4, 6]
        if not all(isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"micro_batch_sizes must be positive ints: "
                f"{self.micro_batches}")
        self.min_gpus = int(param_dict.get("min_gpus", 1))
        self.max_gpus = int(param_dict.get("max_gpus", 10000))
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"invalid min_gpus/max_gpus: {self.min_gpus}/{self.max_gpus}")
        self.model_parallel_size = int(param_dict.get("model_parallel_size", 1))
        self.num_gpus_per_node = int(param_dict.get("num_gpus_per_node", 1))
        # Node bounds from the launcher (--min/max_elastic_nodes, exported
        # by runner.py as DS_ELASTIC_NODE_RANGE) tighten the device range.
        import os as _os

        node_range = _os.environ.get("DS_ELASTIC_NODE_RANGE")
        if node_range:
            lo, hi = (int(v) for v in node_range.split(","))
            self.min_gpus = max(self.min_gpus, lo * self.num_gpus_per_node)
            self.max_gpus = min(self.max_gpus, hi * self.num_gpus_per_node)
            if self.max_gpus < self.min_gpus:
                raise ElasticityConfigError(
                    f"launcher node range {node_range} is incompatible with "
                    f"min_gpus/max_gpus {self.min_gpus}/{self.max_gpus}")
        self.min_time = int(param_dict.get("min_time", 0))
        self.version = float(param_dict.get("version",
                                            LATEST_ELASTICITY_VERSION))
        self.prefer_larger_batch_size = bool(
            param_dict.get("prefer_larger_batch", True))
        self.ignore_non_elastic_batch_info = bool(
            param_dict.get("ignore_non_elastic_batch_info", False))

    def repr(self) -> Dict:
        return self.__dict__


# ------------------------------------------------------------------ #
# Highly composite numbers, generated (not tabulated): record-divisor-count
# integers. Matches the reference's HCN_LIST on its whole range.
# ------------------------------------------------------------------ #
_HCN_CACHE: List[int] = [1, 2, 4, 6, 12, 24, 36, 48, 60, 120]
_HCN_LIMIT = 128


def highly_composite_numbers(up_to: int) -> List[int]:
    """All HCNs <= up_to plus the first one above it."""
    global _HCN_CACHE, _HCN_LIMIT
    if _HCN_LIMIT <= up_to:
        limit = max(up_to * 2, 1024)
        counts = np.zeros(limit + 1, dtype=np.int32)
        for i in range(1, limit + 1):
            counts[i::i] += 1
        best = 0
        out = []
        for n in range(1, limit + 1):
            if counts[n] > best:
                out.append(n)
                best = counts[n]
        _HCN_CACHE, _HCN_LIMIT = out, limit
    return [h for h in _HCN_CACHE if h <= up_to] + \
        [h for h in _HCN_CACHE if h > up_to][:1]


def _scale_to_hcn(base: int, ceiling: int) -> int:
    """base × (largest HCN with base×HCN <= ceiling)."""
    if base >= ceiling:
        return base
    hcns = highly_composite_numbers(ceiling // base)
    mult = max(h for h in hcns if h <= ceiling // base)
    return base * mult


def _candidate_batch_sizes(micro_batches: Sequence[int],
                           ceiling: int) -> List[int]:
    bases = list(micro_batches) + [int(np.lcm.reduce(micro_batches))]
    return sorted({_scale_to_hcn(b, ceiling) for b in bases})


def _valid_device_counts(batch_size: int, micro_batches: Sequence[int],
                         lo: int, hi: int) -> List[int]:
    """Device counts w such that batch_size == micro * w for some micro, or
    w divides that maximal count (each device then runs gradient
    accumulation)."""
    valid = set()
    for micro in micro_batches:
        if batch_size % micro:
            continue
        top = batch_size // micro
        for w in range(1, top + 1):
            if top % w == 0 and lo <= w <= hi:
                valid.add(w)
    return sorted(valid)


def _get_compatible_gpus_v01(micro_batches: Sequence[int],
                             max_acceptable_batch_size: int,
                             min_gpus: Optional[int] = None,
                             max_gpus: Optional[int] = None,
                             prefer_larger: bool = True,
                             ) -> Tuple[int, List[int]]:
    """Pick the candidate batch with the most compatible device counts
    (ties broken toward larger/smaller batch per ``prefer_larger``)."""
    lo = min_gpus or 1
    hi = max_gpus or max_acceptable_batch_size // min(micro_batches)
    bad = [m for m in micro_batches if m > max_acceptable_batch_size]
    if bad:
        raise ElasticityError(
            f"micro batches {bad} exceed max_acceptable_batch_size "
            f"{max_acceptable_batch_size}")

    best_batch, best_valid = min(micro_batches), None
    for cand in _candidate_batch_sizes(micro_batches,
                                       max_acceptable_batch_size):
        valid = _valid_device_counts(cand, micro_batches, lo, hi)
        better = best_valid is None or len(valid) > len(best_valid) or (
            len(valid) == len(best_valid) and
            (cand > best_batch if prefer_larger else cand < best_batch))
        if better:
            best_batch, best_valid = cand, valid
    return best_batch, best_valid or []


def _get_compatible_gpus_v02(micro_batches: Sequence[int],
                             max_acceptable_batch_size: int,
                             current_num_gpus: int,
                             min_gpus: Optional[int] = None,
                             max_gpus: Optional[int] = None,
                             prefer_larger: bool = True,
                             num_gpus_per_node: int = 1,
                             model_parallel_size: int = 1,
                             ) -> Tuple[int, List[int], Optional[int]]:
    """Node-granular variant: device counts come in whole nodes and model
    parallelism divides each node (reference v0.2 semantics)."""
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityError(
            f"devices per node {num_gpus_per_node} must be divisible by "
            f"model_parallel_size {model_parallel_size}")
    dp_per_node = num_gpus_per_node // model_parallel_size

    def micro_for(batch: int) -> Optional[int]:
        fit = [m for m in micro_batches
               if (batch // current_num_gpus) % m == 0]
        if not fit:
            return None
        return max(fit) if prefer_larger else min(fit)

    node_batch, node_counts = _get_compatible_gpus_v01(
        micro_batches,
        max_acceptable_batch_size // dp_per_node,
        (min_gpus or 1) // num_gpus_per_node or 1,
        (max_gpus or max_acceptable_batch_size) // num_gpus_per_node or 1,
        prefer_larger=prefer_larger)
    batch = node_batch * dp_per_node
    dp_counts = [n * dp_per_node for n in node_counts]
    if current_num_gpus // model_parallel_size in dp_counts:
        return batch, dp_counts, micro_for(batch)

    # Current world size not covered: fall back to the largest batch the
    # current dp degree supports under the ceiling.
    if current_num_gpus < num_gpus_per_node:
        raise ElasticityIncompatibleWorldSize(
            f"elasticity v0.2 is node-granular: world size "
            f"{current_num_gpus} is smaller than one node "
            f"({num_gpus_per_node} devices)")
    dp_now = (current_num_gpus // num_gpus_per_node) * dp_per_node
    per_micro = [m * dp_now * (max_acceptable_batch_size // (m * dp_now))
                 for m in micro_batches if m * dp_now <=
                 max_acceptable_batch_size]
    if not per_micro:
        raise ElasticityIncompatibleWorldSize(
            f"no batch size fits {current_num_gpus} devices under "
            f"{max_acceptable_batch_size}")
    batch = max(per_micro) if prefer_larger else min(per_micro)
    return batch, [dp_now], micro_for(batch)


# ------------------------------------------------------------------ #
# Public API (reference names)
# ------------------------------------------------------------------ #
def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get(ELASTICITY, {}).get("enabled", False))


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """Elastic config is fixed by the scheduler at job-submission time; a
    runtime change would silently desynchronise restarts (reference
    ensure_immutable_elastic_config:208)."""
    import json
    import os

    scheduler_cfg = os.environ.get(DEEPSPEED_ELASTICITY_CONFIG)
    if scheduler_cfg is None:
        return
    scheduler = ElasticityConfig(json.loads(scheduler_cfg))
    runtime = ElasticityConfig(runtime_elastic_config_dict)
    for key in ("max_acceptable_batch_size", "micro_batches", "min_gpus",
                "max_gpus", "version"):
        if getattr(scheduler, key) != getattr(runtime, key):
            raise ElasticityConfigError(
                f"elastic config '{key}' changed after scheduling: "
                f"{getattr(scheduler, key)} -> {getattr(runtime, key)}")


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str,
                           world_size: int = 0,
                           return_microbatch: bool = False):
    """Resolve the elastic batch plan (reference compute_elastic_config:233).

    Returns (final_batch_size, valid_gpus) — plus the chosen micro-batch
    when ``return_microbatch`` (v0.2) — and raises
    ElasticityIncompatibleWorldSize when ``world_size`` is given but not in
    the valid set.
    """
    if ELASTICITY not in ds_config:
        raise ElasticityConfigError(
            f"no '{ELASTICITY}' block in config: {sorted(ds_config)}")
    cfg = ElasticityConfig(ds_config[ELASTICITY])
    if not cfg.enabled:
        raise ElasticityConfigError("elasticity is not enabled")
    _check_version_compat(target_deepspeed_version)

    micro = None
    if cfg.version == 0.1:
        final_batch, valid = _get_compatible_gpus_v01(
            cfg.micro_batches, cfg.max_acceptable_batch_size, cfg.min_gpus,
            cfg.max_gpus, prefer_larger=cfg.prefer_larger_batch_size)
    elif cfg.version == 0.2:
        if world_size == 0:
            import os

            world_size = int(os.environ.get("WORLD_SIZE", 0))
        if world_size == 0:
            raise ElasticityConfigError(
                "elasticity v0.2 needs the current world size (arg or "
                "WORLD_SIZE env)")
        final_batch, valid, micro = _get_compatible_gpus_v02(
            cfg.micro_batches, cfg.max_acceptable_batch_size, world_size,
            cfg.min_gpus, cfg.max_gpus,
            prefer_larger=cfg.prefer_larger_batch_size,
            num_gpus_per_node=cfg.num_gpus_per_node,
            model_parallel_size=cfg.model_parallel_size)
    else:
        raise ElasticityConfigError(
            f"unknown elasticity version {cfg.version}")
    logger.info(f"elasticity: batch={final_batch} valid device counts="
                f"{valid}")
    if world_size > 0 and cfg.version == 0.1 and world_size not in valid:
        raise ElasticityIncompatibleWorldSize(
            f"world size {world_size} not in valid set {valid}")
    if return_microbatch:
        if micro is None:  # v0.1 callers
            fits = [m for m in cfg.micro_batches
                    if world_size and final_batch // world_size % m == 0]
            micro = (max(fits) if cfg.prefer_larger_batch_size else
                     min(fits)) if fits else None
        return final_batch, valid, micro
    return final_batch, valid


def _check_version_compat(target_version: str) -> None:
    def parse(v: str) -> Tuple[int, ...]:
        return tuple(int(x) for x in v.split(".")[:3] if x.isdigit())

    if parse(target_version) < parse(MINIMUM_DEEPSPEED_VERSION):
        raise ElasticityError(
            f"target version {target_version} older than minimum "
            f"{MINIMUM_DEEPSPEED_VERSION} supporting elasticity")
