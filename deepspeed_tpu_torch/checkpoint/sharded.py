"""Per-process checkpoint pieces (counterpart of
``deepspeed_tpu/checkpoint/sharded.py`` at one process; reference: per-rank
ZeRO shard files ``zero_pp_rank_X_mp_rank_XX_optim_states.pt``,
runtime/engine.py:3423).

The port trains on one device, so its one process owns every leaf whole:
each leaf is one piece starting at the origin.  The file layout is the JAX
package's, so either package loads the other's checkpoints::

    <tag>/zero_pp_rank_0_mp_rank_00_states.npz   # pieces, + __index__ JSON
    index entry: {"key", "leaf", "start": [...], "shape": [...],
                  "gshape": [...], "dtype"}

and a checkpoint that several JAX processes wrote reassembles here leaf by
leaf from all their files (:func:`read_index` merges them,
:func:`assemble_leaf` fills a leaf from its pieces).  Leaves are stored as
numpy arrays on the host: fp32 and integer dtypes (the engine's master
weights, optimizer state, gradient accumulators and scalars).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.resilience import chaos, heartbeat
from deepspeed_tpu_torch.utils.tensors import (flat_dict_to_tree,
                                               tree_to_flat_dict)

SHARD_FILE = "zero_pp_rank_{proc}_mp_rank_00_states.npz"


def npz_path(path: str) -> str:
    """``np.savez`` silently appends ``.npz`` when the suffix is absent;
    normalising both save and load through this keeps the two sides
    agreeing on the on-disk path."""
    return path if path.endswith(".npz") else path + ".npz"


def write_npz(path: str, payload: Dict[str, np.ndarray]) -> str:
    """The one write primitive for checkpoint pieces: explicit ``.npz``
    suffix, fsync before returning, and the chaos fault points the
    resilience tests drive.  Returns the actual on-disk path."""
    path = npz_path(path)
    chaos.fire("slow_io", path=path)
    np.savez(path, **payload)
    with open(path, "rb") as f:
        os.fsync(f.fileno())
    chaos.fire("crash_after_shard_write", path=path)
    # a completed write is real progress: keep a supervisor's hang
    # detector fed through long saves
    heartbeat.tick_active()
    return path


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf (tensor or array) as a host numpy array."""
    if hasattr(leaf, "detach"):                      # a torch tensor
        if str(leaf.dtype) == "torch.bfloat16":
            raise TypeError("checkpoint leaves are fp32 or integer; a "
                            "bf16 tensor has no numpy dtype to store it")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def collect_local_pieces(tree) -> Dict[str, Any]:
    """Pieces of ``tree`` owned by this process: every leaf, whole.
    Returns {"arrays": {key: np.ndarray}, "index": [entry, ...]}."""
    arrays: Dict[str, np.ndarray] = {}
    index: List[Dict[str, Any]] = []
    for leaf_name, leaf in tree_to_flat_dict(tree).items():
        data = _host_array(leaf)
        key = f"{leaf_name}::0"
        arrays[key] = data
        index.append({
            "key": key, "leaf": leaf_name, "start": [0] * data.ndim,
            "shape": list(data.shape), "gshape": list(data.shape),
            "dtype": str(data.dtype),
        })
    return {"arrays": arrays, "index": index}


def save_process_shards(tree, dirpath: str, scalars: Optional[Dict] = None,
                        checkpoint_engine=None) -> str:
    """Write this process's pieces and the scalar entries."""
    pieces = collect_local_pieces(tree)
    payload = dict(pieces["arrays"])
    payload["__index__"] = np.frombuffer(
        json.dumps(pieces["index"]).encode(), dtype=np.uint8)
    for k, v in (scalars or {}).items():
        payload[f"__scalar__{k}"] = np.asarray(v)
    path = os.path.join(dirpath, SHARD_FILE.format(proc=0))
    if checkpoint_engine is not None:
        checkpoint_engine.save(payload, path)
    else:
        write_npz(path, payload)
    return path


def _iter_shard_files(dirpath: str) -> List[str]:
    files = [f for f in os.listdir(dirpath)
             if f.startswith("zero_pp_rank_") and f.endswith("_states.npz")]
    if not files:
        raise FileNotFoundError(f"no shard files under {dirpath}")
    return sorted(os.path.join(dirpath, f) for f in files)


def read_index(dirpath: str) -> Dict[str, Any]:
    """Merged piece index across all processes' files.

    Returns {"leaves": {leaf: {"gshape", "dtype", "pieces":
    [(file, key, start, shape)]}}, "scalars": {name: np.ndarray}}.
    """
    leaves: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, np.ndarray] = {}
    for path in _iter_shard_files(dirpath):
        with np.load(path, allow_pickle=False) as z:
            index = json.loads(bytes(z["__index__"]).decode())
            for name in z.files:
                if name.startswith("__scalar__"):
                    scalars[name[len("__scalar__"):]] = np.asarray(z[name])
        for e in index:
            rec = leaves.setdefault(e["leaf"], {
                "gshape": tuple(e["gshape"]), "dtype": e["dtype"],
                "pieces": []})
            rec["pieces"].append((path, e["key"], tuple(e["start"]),
                                  tuple(e["shape"])))
    return {"leaves": leaves, "scalars": scalars}


def assemble_leaf(dirpath: str, rec: Dict[str, Any],
                  region: Optional[tuple] = None) -> np.ndarray:
    """Reassemble one leaf's global array (or a sub-``region`` of it: a
    tuple of slices) from its pieces."""
    gshape = rec["gshape"]
    if region is None:
        region = tuple(slice(0, s) for s in gshape)
    out_shape = tuple(s.stop - s.start for s in region)
    out = np.empty(out_shape, dtype=np.dtype(rec["dtype"]))
    filled = 0
    by_file: Dict[str, List] = {}
    for path, key, start, shape in rec["pieces"]:
        by_file.setdefault(path, []).append((key, start, shape))
    for path, entries in by_file.items():
        with np.load(path, allow_pickle=False) as z:
            for key, start, shape in entries:
                # intersect piece [start, start+shape) with region
                dst, src = [], []
                skip = False
                for r, st, sz in zip(region, start, shape):
                    lo = max(r.start, st)
                    hi = min(r.stop, st + sz)
                    if lo >= hi:
                        skip = True
                        break
                    dst.append(slice(lo - r.start, hi - r.start))
                    src.append(slice(lo - st, hi - st))
                if skip:
                    continue
                out[tuple(dst)] = z[key][tuple(src)]
                filled += int(np.prod([s.stop - s.start for s in dst]))
    if filled < int(np.prod(out_shape)):
        raise ValueError(
            f"incomplete checkpoint coverage for a leaf of shape {gshape}: "
            f"filled {filled} of {np.prod(out_shape)} elements "
            f"(missing shard files?)")
    return out


def load_tree(dirpath: str, target_tree) -> Any:
    """The leaves of ``target_tree`` (a tree of tensors or arrays, read for
    their names and shapes) reassembled at their global shapes as host
    numpy arrays, and the scalars: ``(tree, scalars)``.  Peak host memory
    beyond the result is one piece; the caller places the leaves."""
    info = read_index(dirpath)
    out: Dict[str, Any] = {}
    for name, leaf in tree_to_flat_dict(target_tree).items():
        rec = info["leaves"].get(name)
        if rec is None:
            raise KeyError(f"checkpoint is missing leaf {name!r}")
        if tuple(rec["gshape"]) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name!r}: checkpoint {rec['gshape']} "
                f"vs engine {tuple(leaf.shape)}")
        out[name] = assemble_leaf(dirpath, rec)
    return flat_dict_to_tree(out, target_tree), info["scalars"]
