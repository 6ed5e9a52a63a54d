"""Checkpoint save / load of the training engine (counterpart of
``deepspeed_tpu/checkpoint/engine.py`` at one process; reference:
runtime/checkpoint_engine/checkpoint_engine.py:9 pluggable engines +
runtime/engine.py:3021 ``save_checkpoint`` / :2672 ``load_checkpoint``).

Directory layout (the JAX package's, so either package loads the other's
checkpoints)::

    <save_dir>/<tag>/zero_pp_rank_0_mp_rank_00_states.npz
    <save_dir>/<tag>/client_state.json
    <save_dir>/<tag>/manifest.json                           # sizes + CRC32s
    <save_dir>/latest                                        # tag pointer

The state is three trees and five scalars, under the JAX engine's names:
``master``, ``opt`` (one tree per optimizer moment, e.g. ``opt/m`` and
``opt/v`` for Adam) and ``acc_grads``, each in the Flax layout of the
model's parameters (``model/layers_0/self_attn/q_proj/kernel``, a Dense
kernel ``[in, out]``), and ``step``, ``opt_step``, ``loss_scale``,
``good_steps``, ``hysteresis``.  The port holds its parameters in
``nn.Linear``'s ``[out, in]`` layout under ``state_dict`` names;
:func:`engine_state_layout` maps each to its Flax name and transpose with
``checkpoint/jax_params.py``'s rules, and the optimizer's moments follow
the same mapping (``ops/optimizers.py`` keeps one moment tensor per
master tensor, in the same order).

Fault tolerance (:mod:`deepspeed_tpu_torch.resilience.manifest`): pieces
stream to ``<tag>.tmp/``, each file's size and CRC32 go into the tag's
``manifest.json``, and only then is the staging dir renamed into place and
``latest`` republished through write-temp + ``os.replace`` + fsync, so a
crash at any instant leaves ``latest`` pointing at a whole, verified tag.
``load_engine_state`` validates the manifest and walks back to the newest
verified tag instead of loading corrupt state.  A load writes into the
engine's own tensors, on the engine's device.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import types
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import sharded
from deepspeed_tpu_torch.resilience import manifest as rz_manifest
from deepspeed_tpu_torch.utils.logging import log_dist, logger

#: the engine's scalars, as the JAX engine stores them
SCALAR_DTYPES = {"step": np.int32, "opt_step": np.int32,
                 "loss_scale": np.float32, "good_steps": np.int32,
                 "hysteresis": np.int32}


class CheckpointEngine:
    """reference: runtime/checkpoint_engine/checkpoint_engine.py:9."""

    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str) -> None:
        log_dist(f"Saving checkpoint tag={tag}", ranks=[0])

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        sharded.write_npz(path, state_dict)

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        with np.load(sharded.npz_path(path), allow_pickle=False) as data:
            return {k: data[k] for k in data.files}

    def commit(self, tag: str) -> bool:
        return True


class _PendingWrite:
    __slots__ = ("path", "done", "error")

    def __init__(self, path: str):
        self.path = path
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class AsyncCheckpointEngine(CheckpointEngine):
    """Bounded background writer pool (reference: the async Nebula engine,
    runtime/checkpoint_engine/nebula_checkpoint_engine.py:20).

    ``save`` returns as soon as the host copy is queued — at most
    ``max_workers`` writer threads ever exist; ``commit`` blocks until every
    pending write is durable (and surfaces the first error), so the
    ``latest`` tag is never published ahead of the data.  The workers are
    daemon threads fed from a queue: ``commit()`` is the only place that
    waits on them, so a write wedged on a dead mount cannot block
    interpreter exit."""

    def __init__(self, config_params=None, max_workers: int = 2):
        super().__init__(config_params)
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self._max_workers = max_workers
        self._queue: "queue.Queue[Tuple[_PendingWrite, Dict]]" = queue.Queue()
        self._workers: List[threading.Thread] = []
        self._pending: List[_PendingWrite] = []
        self._lock = threading.Lock()

    def _worker(self) -> None:
        while True:
            pw, payload = self._queue.get()
            try:
                sharded.write_npz(pw.path, payload)
            except BaseException as e:  # noqa: BLE001 — surfaced by commit
                pw.error = e
            finally:
                pw.done.set()

    def _ensure_workers(self) -> None:
        with self._lock:
            while len(self._workers) < self._max_workers:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"ckpt-writer-{len(self._workers)}")
                t.start()
                self._workers.append(t)

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        self._ensure_workers()
        pw = _PendingWrite(path)
        with self._lock:
            self._pending.append(pw)
        self._queue.put((pw, state_dict))

    def commit(self, tag: str) -> bool:
        with self._lock:
            pending, self._pending = self._pending, []
        errors = []
        for pw in pending:
            pw.done.wait()
            if pw.error is not None:
                errors.append((pw.path, pw.error))
        if errors:
            path, exc = errors[0]
            raise RuntimeError(
                f"async checkpoint write failed for {path} "
                f"(+{len(errors) - 1} more)") from exc
        return True


# --------------------------------------------------------------------- #
# The engine's state under the JAX engine's names
# --------------------------------------------------------------------- #
def flax_layout(module, names) -> List[Tuple[str, bool]]:
    """For each parameter name of ``module`` (a ``state_dict`` name), its
    '/'-joined Flax path and whether the tensor is stored transposed (a
    Dense ``kernel``), by ``checkpoint/jax_params.py``'s mapping:
    GPT-2's for ``GPT2LMHeadModel``, Llama's (which also covers Mixtral
    and a lone MoE) otherwise."""
    from deepspeed_tpu_torch.checkpoint.jax_params import (
        flax_params_from_gpt2_state_dict, flax_params_from_llama_state_dict)
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel
    from deepspeed_tpu_torch.utils.tensors import tree_to_flat_dict

    to_flax = (flax_params_from_gpt2_state_dict
               if isinstance(module, GPT2LMHeadModel)
               else flax_params_from_llama_state_dict)
    probe = torch.zeros(1, 1)
    out = []
    for name in names:
        (path, _), = tree_to_flat_dict(to_flax({name: probe})).items()
        out.append((path, path.rsplit("/", 1)[-1] == "kernel"))
    return out


def engine_state_layout(engine) -> List[Tuple[str, bool]]:
    """:func:`flax_layout` of the engine's trained parameters."""
    return flax_layout(engine.module, engine._names)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *mods, last = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[last] = leaf
    return tree


def _to_host(t: torch.Tensor, transpose: bool) -> np.ndarray:
    return (t.t() if transpose else t).detach().contiguous().cpu().numpy()


def engine_state_trees(engine, fn=_to_host) -> Dict[str, Any]:
    """``{"master", "opt": {moment: ...}, "acc_grads"}`` as nested dicts in
    the Flax layout, each leaf ``fn(tensor, transpose)`` (by default a
    host numpy copy in the Flax orientation)."""
    layout = engine_state_layout(engine)

    def tree(tensors):
        return _nest({path: fn(t, tr)
                      for (path, tr), t in zip(layout, tensors)})

    return {"master": tree(engine.master),
            "opt": {k: tree(v) for k, v in engine.opt_state.items()},
            "acc_grads": tree(engine.acc_grads)}


def engine_scalars(engine) -> Dict[str, np.ndarray]:
    values = {"step": engine.global_steps, "opt_step": engine.opt_step,
              "loss_scale": engine.loss_scale,
              "good_steps": engine.good_steps,
              "hysteresis": engine.hysteresis}
    return {k: np.asarray(v, SCALAR_DTYPES[k]) for k, v in values.items()}


def set_engine_scalars(engine, scalars: Dict[str, Any]) -> None:
    if "opt_step" in scalars:
        engine.opt_step = int(scalars["opt_step"])
    if "loss_scale" in scalars:
        engine.loss_scale = float(scalars["loss_scale"])
    if "good_steps" in scalars:
        engine.good_steps = int(scalars["good_steps"])
    if "hysteresis" in scalars:
        engine.hysteresis = int(scalars["hysteresis"])
    if "step" in scalars:
        engine.global_steps = int(scalars["step"])


def checked_flat(engine, tensors, flat: Dict[str, np.ndarray],
                 prefix: str = "") -> List[np.ndarray]:
    """The host arrays ``flat[prefix + path]`` for ``tensors``, in order,
    each checked to be present with the engine's shape (Flax layout)."""
    arrays = []
    for (path, tr), t in zip(engine_state_layout(engine), tensors):
        key = prefix + path
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = np.asarray(flat[key])
        want = tuple(t.t().shape) if tr else tuple(t.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(arr.shape)} vs engine {want}")
        arrays.append(arr)
    return arrays


@torch.no_grad()
def write_flat(engine, tensors, arrays: List[np.ndarray]) -> None:
    """Copy :func:`checked_flat`'s arrays into the engine's ``tensors``, in
    place on the engine's device."""
    for (_, tr), t, arr in zip(engine_state_layout(engine), tensors, arrays):
        src = torch.from_numpy(np.ascontiguousarray(arr)).to(t.device)
        t.copy_(src.t() if tr else src)


def place_flat(engine, tensors, flat: Dict[str, np.ndarray],
               prefix: str = "") -> None:
    """Check every array of ``flat`` for ``tensors``, then copy them in."""
    write_flat(engine, tensors, checked_flat(engine, tensors, flat, prefix))


@torch.no_grad()
def refresh_params(engine) -> None:
    """The compute-precision parameters from the masters (after a load)."""
    torch._foreach_copy_(engine._params, engine.master)


# --------------------------------------------------------------------- #
# Save / load
# --------------------------------------------------------------------- #
#: What a damaged or mismatched checkpoint raises while it is read and
#: checked (a missing file or leaf, a bad archive or JSON, a wrong shape);
#: :func:`load_engine_state` falls back past these and no other error.
CHECKPOINT_ERRORS = (OSError, EOFError, KeyError, ValueError,
                     zipfile.BadZipFile)
def save_engine_state(engine, save_dir: str, tag: str,
                      client_state: Dict[str, Any],
                      save_latest: bool = True,
                      checkpoint_engine: Optional[CheckpointEngine] = None
                      ) -> str:
    """Atomic checkpoint commit: stage -> checksum -> rename -> publish.

    The pieces stream into ``<tag>.tmp/`` with a size + CRC32 sidecar for
    each file; after ``ce.commit()`` proves them durable the sidecars merge
    into ``manifest.json``, the staging dir is renamed to ``<tag>/`` (the
    commit point) and ``latest`` is republished atomically.  A crash
    before the rename leaves only a ``.tmp`` dir the next save sweeps; a
    crash after it at worst leaves ``latest`` one tag behind."""
    ce = checkpoint_engine or getattr(engine, "checkpoint_engine", None) \
        or CheckpointEngine()
    final_path = os.path.join(save_dir, str(tag))
    tmp_path = final_path + rz_manifest.TMP_SUFFIX
    if os.path.isdir(tmp_path):
        logger.warning(f"removing stale staging dir {tmp_path} "
                       "(crashed earlier save)")
        shutil.rmtree(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    ce.create(tag)

    scalars = engine_scalars(engine)
    local_files = [sharded.save_process_shards(
        engine_state_trees(engine), tmp_path, scalars=scalars,
        checkpoint_engine=ce)]
    cs_path = os.path.join(tmp_path, "client_state.json")
    with open(cs_path, "w") as f:
        json.dump(client_state, f, indent=2, default=str)
    local_files.append(cs_path)

    # drain the writes first (async engine included) so the bytes being
    # checksummed are the bytes on disk
    ce.commit(tag)
    rz_manifest.write_sidecars(tmp_path, local_files)
    rz_manifest.finalize_tag(tmp_path, final_path, str(tag),
                             step=int(scalars["step"]))
    if save_latest:
        rz_manifest.publish_latest(save_dir, str(tag))
    return final_path


def load_engine_state(engine, load_dir: str, tag: Optional[str] = None,
                      load_optimizer_states: bool = True,
                      checkpoint_engine: Optional[CheckpointEngine] = None,
                      verify: str = "full", fallback: bool = True,
                      metrics=None) -> Tuple[Optional[str], Dict[str, Any]]:
    """Verified load with fallback.

    ``verify``: ``"full"`` (size + CRC32 against the manifest), ``"size"``
    (cheap, catches truncation only), or ``"off"``.  When the requested /
    ``latest`` tag fails verification (or its directory is gone — a stale
    ``latest``), ``fallback=True`` walks back to the newest verified tag at
    or below the requested step instead of failing, logging what was wrong
    with each rejected tag.  A tag without a manifest loads (unverified,
    with a warning) only when no manifested tag exists.

    ``metrics``: an optional object with ``record_verify_failure(tag,
    problems)`` and ``record_fallback(wanted, loaded)``.
    """
    if verify not in ("full", "size", "off"):
        raise ValueError(f"verify must be 'full', 'size' or 'off', "
                         f"got {verify!r}")
    ce = checkpoint_engine or CheckpointEngine()
    latest = rz_manifest.read_latest(load_dir)
    infos = rz_manifest.candidate_tags(load_dir)
    by_tag = {t.tag: t for t in infos}

    def tag_step(name: str) -> Optional[int]:
        info = by_tag.get(name)
        if info is not None and info.step is not None:
            return info.step
        m = re.search(r"(\d+)$", name)  # "global_step123" convention
        return int(m.group(1)) if m else None

    candidates: List[str] = []
    if tag is not None:
        requested = str(tag)
        candidates.append(requested)
        if fallback:
            # never fall back forward past an explicitly asked-for step
            req_step = tag_step(requested)
            if req_step is not None:
                for t in infos:
                    t_step = tag_step(t.tag)
                    if t.tag == requested or t_step is None \
                            or t_step > req_step:
                        continue
                    candidates.append(t.tag)
    else:
        if latest is not None:
            candidates.append(latest)
        if fallback:
            candidates.extend(t.tag for t in infos if t.tag != latest)
        if not candidates:
            logger.warning(f"no 'latest' file or checkpoint tags in "
                           f"{load_dir}; nothing loaded")
            return None, {}

    any_manifested = any(t.has_manifest for t in infos)
    requested = str(tag) if tag is not None else None
    primary = candidates[0]

    def verified_candidates():
        for t in candidates:
            path = os.path.join(load_dir, t)
            if not os.path.isdir(path):
                logger.warning(
                    f"checkpoint tag {t!r}: directory {path} missing"
                    + (" — STALE 'latest' pointer" if t == latest else ""))
                if metrics is not None:
                    metrics.record_verify_failure(t, ["directory missing"])
                continue
            if verify != "off":
                info = by_tag.get(t)
                if info is not None and not info.has_manifest \
                        and (not any_manifested or t == requested):
                    logger.warning(
                        f"checkpoint tag {t!r} has no manifest.json "
                        "(pre-manifest checkpoint) — loading UNVERIFIED")
                else:
                    ok, problems = rz_manifest.verify_tag(path, mode=verify)
                    if not ok:
                        logger.warning(
                            f"checkpoint tag {t!r} failed verification "
                            f"({verify}): " + "; ".join(problems))
                        if metrics is not None:
                            metrics.record_verify_failure(t, problems)
                        continue
            yield t, path

    for t, path in verified_candidates():
        try:
            result = _load_tag(engine, path, load_optimizer_states)
        except CHECKPOINT_ERRORS as e:  # fall back to an older tag
            logger.warning(f"loading checkpoint tag {t!r} failed: {e}")
            if metrics is not None:
                metrics.record_verify_failure(t, [str(e)])
            continue
        if t != primary:
            logger.warning(
                f"checkpoint fallback: wanted {primary!r}, loaded the "
                f"newest verified tag {t!r}")
            if metrics is not None:
                metrics.record_fallback(primary, t)
        return result
    logger.warning(f"no loadable checkpoint in {load_dir} "
                   f"(tried {candidates})")
    return None, {}


def _target(engine, tensors) -> Dict[str, Any]:
    """Shape holders of ``tensors`` in the Flax layout (what a load checks
    the checkpoint's global shapes against)."""
    return _nest({path: types.SimpleNamespace(
                      shape=tuple(t.t().shape) if tr else tuple(t.shape))
                  for (path, tr), t in zip(engine_state_layout(engine),
                                           tensors)})


def _load_tag(engine, path: str, load_optimizer_states: bool
              ) -> Tuple[str, Dict[str, Any]]:
    """Load one verified tag directory into the engine.  A problem of the
    checkpoint raises one of :data:`CHECKPOINT_ERRORS`, so the caller can
    fall back, and it raises before anything is written: every file is
    read and every leaf checked first.  A device error while copying in
    propagates."""
    from deepspeed_tpu_torch.utils.tensors import tree_to_flat_dict

    groups = [("master/", engine.master)]
    target = {"master": _target(engine, engine.master)}
    if load_optimizer_states:
        groups += [(f"opt/{k}/", v) for k, v in engine.opt_state.items()]
        groups.append(("acc_grads/", engine.acc_grads))
        target["opt"] = {k: _target(engine, v)
                         for k, v in engine.opt_state.items()}
        target["acc_grads"] = _target(engine, engine.acc_grads)
    loaded, scalars = sharded.load_tree(path, target)
    flat = tree_to_flat_dict(loaded)
    staged = [(tensors, checked_flat(engine, tensors, flat, prefix))
              for prefix, tensors in groups]
    client_state: Dict[str, Any] = {}
    cs_file = os.path.join(path, "client_state.json")
    if os.path.exists(cs_file):
        with open(cs_file) as f:
            client_state = json.load(f)

    for tensors, arrays in staged:
        write_flat(engine, tensors, arrays)
    if load_optimizer_states:
        set_engine_scalars(engine, scalars)
    refresh_params(engine)
    log_dist(f"Loaded checkpoint from {path}", ranks=[0])
    return path, client_state
