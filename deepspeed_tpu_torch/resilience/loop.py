"""Auto-resuming training loop: periodic commits, retention GC, and a
NaN/loss-spike sentinel with rollback.

Counterpart of ``deepspeed_tpu/resilience/loop.py``, with its names and
decisions.  The default ``step_fn`` calls the port engine's
``train_micro_batch``; the sentinel reads the loss with ``float(loss)``,
one host synchronisation a step, as the JAX loop does.

:class:`ResilientTrainLoop` wraps any engine exposing the reference
checkpoint surface (``save_checkpoint`` / ``load_checkpoint``) and turns
the atomic-commit + verified-load machinery into the operational contract
large runs rely on: a preemption or host failure at any instant costs at
most ``save_interval`` steps, never the run.

* ``auto_resume()`` on start: load the newest *verified* tag (the loader
  walks back past corrupt ones) and fast-forward the data stream to the
  saved step.
* Periodic checkpoints every ``save_interval`` steps, timed into
  ``resilience/save_latency_s``.
* Retention GC after every save: keep the last ``keep_last`` tags plus
  every ``keep_every``-th step's tag (and whatever ``latest`` points at);
  stale ``<tag>.tmp`` staging dirs from crashed saves are swept too.
* Sentinel: a non-finite or spiking loss rolls the engine back to the
  last good tag and marks the offending step as skipped, so the replay
  does not re-train the poisoned window.  ``max_rollbacks`` consecutive
  rollbacks without a single good step aborts the run instead of looping.

The data source is either a callable ``batch_fn(step) -> batch``
(fast-forward is then exact and free) or a plain iterable (fast-forward
consumes and discards ``start_step`` batches).
"""

from __future__ import annotations

import inspect
import math
import os
import shutil
import statistics
import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional, Set, Union

from deepspeed_tpu_torch.resilience import chaos, heartbeat, manifest
from deepspeed_tpu_torch.resilience.heartbeat import Heartbeat
from deepspeed_tpu_torch.resilience.metrics import ResilienceMetrics
from deepspeed_tpu_torch.utils.logging import logger


def apply_retention(save_dir: str, keep_last: int = 3, keep_every: int = 0,
                    metrics: Optional[ResilienceMetrics] = None) -> List[str]:
    """Delete old tags, keeping the newest ``keep_last``, every
    ``keep_every``-th step's tag (0 = off), and the ``latest`` target.
    Also sweeps ``<tag>.tmp`` staging dirs left by crashed saves.
    Returns the deleted tag names."""
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    infos = manifest.candidate_tags(save_dir)
    latest = manifest.read_latest(save_dir)
    keep = {t.tag for t in infos[:keep_last]}
    if latest:
        keep.add(latest)
    if keep_every:
        keep.update(t.tag for t in infos
                    if t.step is not None and t.step % keep_every == 0)
    deleted = []
    for info in infos:
        if info.tag not in keep:
            shutil.rmtree(info.path, ignore_errors=True)
            deleted.append(info.tag)
            heartbeat.tick_active()   # a slow sweep is progress, not a hang
    if os.path.isdir(save_dir):
        for name in os.listdir(save_dir):
            if name.endswith(manifest.TMP_SUFFIX):
                path = os.path.join(save_dir, name)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
    if deleted and metrics is not None:
        metrics.record_gc(len(deleted))
    if deleted:
        logger.info(f"retention: deleted tags {deleted} (kept {sorted(keep)})")
    return deleted


class ResilientTrainLoop:
    """Periodic-checkpoint + auto-resume + sentinel wrapper around an
    engine with the reference ``save_checkpoint``/``load_checkpoint``
    surface."""

    def __init__(self, engine, data: Union[Callable[[int], Any], Iterable],
                 save_dir: str, *,
                 save_interval: int = 100,
                 keep_last: int = 3,
                 keep_every: int = 0,
                 tag_prefix: str = "global_step",
                 step_fn: Optional[Callable[[Any, Any], float]] = None,
                 verify: str = "full",
                 spike_factor: float = 0.0,
                 spike_window: int = 32,
                 max_rollbacks: int = 2,
                 monitor=None,
                 metrics: Optional[ResilienceMetrics] = None,
                 export_every: int = 0,
                 heartbeat: Optional[Heartbeat] = None):
        if save_interval < 1:
            raise ValueError("save_interval must be >= 1")
        self.engine = engine
        self.save_dir = save_dir
        self.save_interval = save_interval
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.tag_prefix = tag_prefix
        self.verify = verify
        self.spike_factor = spike_factor
        self.max_rollbacks = max_rollbacks
        self.metrics = metrics if metrics is not None \
            else ResilienceMetrics(monitor)
        self.export_every = export_every
        self.step = 0
        self._batch_fn, self._iter = (data, None) if callable(data) \
            else (None, iter(data))
        self._iter_pos = 0
        self._step_fn = step_fn or self._default_step_fn
        self._loss_window: deque = deque(maxlen=max(spike_window, 2))
        #: samples needed before the spike test arms (capped by the
        #: window, else a small spike_window would never trigger it)
        self._min_history = min(8, self._loss_window.maxlen)
        self._skipped: Set[int] = set()
        #: rollbacks since the last successfully TRAINED step — a save
        #: alone must not reset this (a boundary can land on pure-skip
        #: ground), or a fully poisoned tail would never trip the abort
        self._consecutive_rollbacks = 0
        self._last_good_tag: Optional[str] = None
        #: liveness ticker for the job supervisor's hang detector; picked
        #: up from the supervisor's env contract when not given explicitly
        self.heartbeat = heartbeat if heartbeat is not None \
            else Heartbeat.from_env()

    @staticmethod
    def _default_step_fn(engine, batch) -> float:
        if isinstance(batch, tuple):
            return engine.train_micro_batch(*batch)
        return engine.train_micro_batch(batch)

    # ------------------------------------------------------------------ #
    # Data stream
    # ------------------------------------------------------------------ #
    def _fast_forward(self, step: int) -> None:
        """Advance the data stream to ``step`` (exact for a ``batch_fn``;
        consume-and-discard for a plain iterator)."""
        if self._batch_fn is not None:
            return
        while self._iter_pos < step:
            next(self._iter)
            self._iter_pos += 1

    def _next_batch(self, step: int):
        if self._batch_fn is not None:
            return self._batch_fn(step)
        batch = next(self._iter)
        self._iter_pos += 1
        return batch

    # ------------------------------------------------------------------ #
    # Checkpoint plumbing
    # ------------------------------------------------------------------ #
    def _ckpt_kwargs(self, fn) -> dict:
        """Forward verify/metrics only to engines whose checkpoint surface
        accepts them (duck-typed engines may predate those kwargs)."""
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return {}
        out = {}
        if "verify" in params:
            out["verify"] = self.verify
        if "metrics" in params:
            out["metrics"] = self.metrics
        return out

    def auto_resume(self) -> int:
        """Load the newest verified checkpoint (if any) and fast-forward
        the data stream; returns the resumed step (0 = fresh start)."""
        load = self.engine.load_checkpoint
        path, client_state = load(self.save_dir, **self._ckpt_kwargs(load))
        if path is None:
            logger.info(f"auto_resume: no checkpoint under {self.save_dir}; "
                        "starting fresh")
            self.step = 0
            return 0
        # loop state lives under its own client_state key: engines (the
        # port's DeepSpeedEngine included) merge their own top-level keys
        # into client_state and must not clobber ours
        rz = client_state.get("resilience") or {}
        self.step = int(rz.get(
            "loop_step", getattr(self.engine, "global_steps", 0)))
        self._skipped = set(rz.get("skipped_steps", []))
        self._last_good_tag = os.path.basename(path)
        self._fast_forward(self.step)
        self.metrics.record_resume(self._last_good_tag, self.step)
        logger.info(f"auto_resume: resumed {path} at step {self.step}")
        return self.step

    def _save(self) -> None:
        tag = f"{self.tag_prefix}{self.step}"
        client_state = {"resilience": {
            "loop_step": self.step,
            "skipped_steps": sorted(self._skipped)}}
        t0 = time.monotonic()
        try:
            self.engine.save_checkpoint(self.save_dir, tag=tag,
                                        client_state=client_state)
        except Exception:
            self.metrics.record_save_failure()
            raise
        self.metrics.record_save(time.monotonic() - t0)
        self._last_good_tag = tag
        apply_retention(self.save_dir, keep_last=self.keep_last,
                        keep_every=self.keep_every, metrics=self.metrics)

    def _rollback(self) -> None:
        """Loss went bad at ``self.step``: mark the step skipped and
        restore the last good tag (the loader falls back past corrupt
        tags on its own)."""
        bad_step = self.step
        self._skipped.add(bad_step)
        self.metrics.record_rollback(bad_step)
        self._consecutive_rollbacks += 1
        if self._consecutive_rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"sentinel: {self._consecutive_rollbacks} rollbacks without "
                f"a single good step (step {bad_step}) — aborting instead "
                "of looping on a poisoned window")
        self._loss_window.clear()
        load = self.engine.load_checkpoint
        path, client_state = load(self.save_dir, **self._ckpt_kwargs(load))
        if path is None:
            logger.warning(
                f"sentinel: loss went bad at step {bad_step} but no "
                "checkpoint exists to roll back to; skipping the step "
                "with the current (suspect) weights")
            return
        rz = client_state.get("resilience") or {}
        self.step = int(rz.get(
            "loop_step", getattr(self.engine, "global_steps", 0)))
        logger.warning(
            f"sentinel: rolled back from step {bad_step} to "
            f"{os.path.basename(path)} (step {self.step}); step {bad_step} "
            "will be skipped on replay")

    def _loss_is_bad(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if self.spike_factor > 0 and len(self._loss_window) >= self._min_history:
            baseline = statistics.median(self._loss_window)
            if baseline > 0 and loss > self.spike_factor * baseline:
                return True
        return False

    # ------------------------------------------------------------------ #
    # The loop
    # ------------------------------------------------------------------ #
    def run(self, until_step: int, auto_resume: bool = True) -> int:
        """Train to ``until_step`` (absolute), resuming, checkpointing,
        and rolling back as needed.  Returns the final step."""
        if auto_resume:
            self.auto_resume()
        while self.step < until_step:
            # per-step liveness + the supervision fault points (free
            # no-ops unless a chaos test armed them)
            if self.heartbeat is not None:
                self.heartbeat.beat(self.step)
            chaos.fire("worker_crash")
            chaos.fire("worker_hang")
            batch = self._next_batch(self.step)
            if self.step in self._skipped:
                self.metrics.record_skip(self.step)
            else:
                loss = float(self._step_fn(self.engine, batch))
                if self._loss_is_bad(loss):
                    self._rollback()
                    # replay (or continue) from the restored step; the
                    # data stream is re-keyed by step for a batch_fn,
                    # while a plain iterator cannot rewind — it
                    # continues forward
                    continue
                self._loss_window.append(loss)
                self._consecutive_rollbacks = 0
            # the save boundary applies on BOTH paths: a skip landing on
            # it must not stretch the checkpoint gap to 2x save_interval
            self.step += 1
            if self.step % self.save_interval == 0:
                self._save()
            if self.export_every and self.step % self.export_every == 0:
                self.metrics.export()
        self.metrics.export()
        return self.step
