"""The port's ResilientTrainLoop and retention against the JAX package's, on
the CPU.

* ``apply_retention`` deletes the same tags (and sweeps the same ``.tmp``
  staging dirs) in both packages over one directory of tags;
* the sentinel cases of ``tests/unit/test_resilience.py`` (NaN, spike, a
  small spike window, ``max_rollbacks``, a skip on a save boundary, NaN
  before any checkpoint, rolling back through a corrupt tag) run through
  both packages' loops over a duck-typed engine with scripted losses: the
  same steps trained, the same skipped set and the same counters;
* both loops drive their real engines on a tiny Llama (2 layers, hidden
  64, 2 x 32 tokens, f32) with the same weights through the bridge and a
  NaN planted after one step: losses within 2e-5, the same rollback,
  skip and resume events;
* the port's ``chaos_smoke`` (a crash in the middle of the second save,
  then a resume to the straight run's bits) passes on the CPU.
"""

import importlib.util
import math
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import resilience as jres
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.parallel import groups
from deepspeed_tpu_torch import resilience as tres
from deepspeed_tpu_torch.checkpoint import llama_state_dict_from_flax
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from torch_port_common import single_process_env  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 2e-5
#: the counters that time nothing
TIMED = ("save_latency_s", "mean_save_latency_s")


@pytest.fixture(autouse=True)
def _disarm_chaos():
    jres.chaos.disarm()
    tres.chaos.disarm()
    yield
    jres.chaos.disarm()
    tres.chaos.disarm()


def _counters(metrics):
    return {k: v for k, v in metrics.snapshot().items() if k not in TIMED}


# --------------------------------------------------------------------- #
# Retention
# --------------------------------------------------------------------- #
#: (tag, manifest step or None, mtime) of each tag directory; tags without
#: a manifest hold a bare .npz and sort by mtime
TAGS = (("global_step2", 2, 100), ("global_step4", 4, 200),
        ("global_step6", 6, 300), ("global_step8", 8, 400),
        ("global_step10", 10, 500), ("global_step12", 12, 600),
        ("legacy_a", None, 50), ("legacy_b", None, 700))


def _make_tags(root: Path, latest):
    root.mkdir()
    for tag, step, mtime in TAGS:
        d = root / tag
        d.mkdir()
        (d / "zero_pp_rank_0_mp_rank_00_states.npz").write_bytes(b"x")
        if step is not None:
            (d / "manifest.json").write_text(f'{{"step": {step}}}')
        os.utime(d, (mtime, mtime))
    for stale in ("global_step14.tmp", "global_step7.tmp"):
        (root / stale).mkdir()
        (root / stale / "piece.npz").write_bytes(b"y")
    (root / "empty_dir").mkdir()          # no files: not a tag, kept
    if latest:
        (root / "latest").write_text(latest)


@pytest.mark.parametrize("keep_last,keep_every,latest", [
    (1, 0, None), (2, 0, "global_step12"), (3, 4, "global_step12"),
    (2, 6, "global_step4"), (1, 3, "legacy_a"), (8, 0, "global_step2")])
def test_apply_retention_matches_jax(tmp_path, keep_last, keep_every,
                                     latest):
    out = {}
    for name, pkg in (("jax", jres), ("port", tres)):
        root = tmp_path / name
        _make_tags(root, latest)
        metrics = pkg.ResilienceMetrics()
        deleted = pkg.apply_retention(str(root), keep_last=keep_last,
                                      keep_every=keep_every,
                                      metrics=metrics)
        out[name] = (deleted, sorted(os.listdir(root)), _counters(metrics))
    assert out["port"] == out["jax"]
    assert not any(n.endswith(".tmp") for n in out["port"][1])
    with pytest.raises(ValueError):
        tres.apply_retention(str(tmp_path / "port"), keep_last=0)


# --------------------------------------------------------------------- #
# Sentinel cases over a duck-typed engine
# --------------------------------------------------------------------- #
class FakeEngine:
    """'weights' accumulate the batch value and the loss IS the batch
    value; checkpoints are in memory.  A tag marked corrupt fails its
    verification at load and the load falls back to the newest good tag,
    reporting both to ``metrics`` as the verified loaders do."""

    def __init__(self, corrupt_at=()):
        self.weights = 0.0
        self.trained = []
        self.global_steps = 0
        self._store = {}
        self._corrupt_at = set(corrupt_at)

    def train_micro_batch(self, step, value):
        self.weights += value
        self.trained.append(step)
        self.global_steps += 1
        return value

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        client_state = dict(client_state or {})
        # the engines merge their own top-level keys into client_state
        client_state.update({"global_steps": self.global_steps,
                             "skipped_steps": 0})
        loop_step = client_state["resilience"]["loop_step"]
        self._store[tag] = (self.weights, self.global_steps, client_state,
                            loop_step in self._corrupt_at)
        return True

    def load_checkpoint(self, load_dir, tag=None, verify="full",
                        fallback=True, metrics=None):
        order = sorted(self._store, key=lambda t: self._store[t][2][
            "resilience"]["loop_step"], reverse=True)
        wanted = None
        for t in order:
            wanted = wanted or t
            if self._store[t][3]:
                if metrics is not None:
                    metrics.record_verify_failure(t, ["corrupt"])
                continue
            if t != wanted and metrics is not None:
                metrics.record_fallback(wanted, t)
            self.weights, self.global_steps, client_state, _ = self._store[t]
            return t, client_state
        return None, {}


def _scripted(values):
    return lambda step: (step, values(step))


NAN = float("nan")
#: name: (loss at each step, until, loop kwargs, corrupt tags' steps)
SENTINEL_CASES = {
    "nan_rolls_back": (lambda s: NAN if s == 7 else 1.0, 10,
                       dict(save_interval=3), ()),
    "spike_rolls_back": (lambda s: 100.0 if s == 10 else 1.0, 12,
                         dict(save_interval=4, spike_factor=4.0), ()),
    "small_spike_window": (lambda s: 100.0 if s == 5 else 1.0, 8,
                           dict(save_interval=4, spike_factor=4.0,
                                spike_window=4), ()),
    "max_rollbacks": (lambda s: NAN if s >= 4 else 1.0, 10,
                      dict(save_interval=2, max_rollbacks=2), ()),
    "skip_on_save_boundary": (lambda s: NAN if s == 1 else 1.0, 4,
                              dict(save_interval=2), ()),
    "nan_before_any_checkpoint": (lambda s: NAN if s == 1 else 1.0, 4,
                                  dict(save_interval=50), ()),
    "rollback_through_corrupt_tag": (lambda s: NAN if s == 7 else 1.0, 10,
                                     dict(save_interval=2, keep_last=5),
                                     (6,)),
}


def _sentinel_run(pkg, tmp_path, values, until, kwargs, corrupt):
    eng = FakeEngine(corrupt)
    loop = pkg.ResilientTrainLoop(eng, _scripted(values), str(tmp_path),
                                  **kwargs)
    try:
        final, error = loop.run(until), None
    except RuntimeError as e:
        final, error = None, str(e)
    return {"final": final, "error": error, "trained": eng.trained,
            "weights": repr(eng.weights), "skipped": sorted(loop._skipped),
            "stored": sorted(eng._store),
            "counters": _counters(loop.metrics)}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinel_decides_as_jax(tmp_path, case):
    values, until, kwargs, corrupt = SENTINEL_CASES[case]
    want = _sentinel_run(jres, tmp_path / "jax", values, until, kwargs,
                         corrupt)
    got = _sentinel_run(tres, tmp_path / "port", values, until, kwargs,
                        corrupt)
    assert got == want
    # the cases do what their names say
    c = got["counters"]
    if case == "max_rollbacks":
        assert "rollbacks without" in got["error"]
    else:
        assert got["final"] == until and c["rollbacks"] == 1
    if case == "rollback_through_corrupt_tag":
        assert c["verify_failures"] >= 1 and c["fallbacks"] == 1


# --------------------------------------------------------------------- #
# Real engines on a tiny Llama
# --------------------------------------------------------------------- #
GEOM = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
CFG = {"train_micro_batch_size_per_gpu": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
       "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
       "attention_layout": "bshd"}
NAN_STEP = 5


@pytest.fixture(scope="module")
def flax_params():
    jmodel = JLlama(JLlamaConfig(**GEOM, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.key(0),
                                        np.zeros((1, 8), np.int32)))["params"]
    return jmodel, params


def _batch(step):
    ids = np.random.default_rng(100 + step).integers(
        0, GEOM["vocab_size"], size=(2, 32)).astype(np.int32)
    return ids, ids


def _engines(flax_params):
    jmodel, params = flax_params
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=CFG, model_parameters=params,
        topology=groups.initialize_mesh(devices=jax.devices()[:1]))
    model = LlamaForCausalLM(LlamaConfig(**GEOM, dtype=torch.float32),
                             device="cpu")
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=CFG, device="cpu",
        model_parameters=llama_state_dict_from_flax(params, device="cpu"))
    return {"jax": (jres, jeng), "port": (tres, teng)}


class PlantedNaN:
    """Takes the real step, then reports NaN once at ``NAN_STEP``; logs
    (loop step, loss) of every call."""

    def __init__(self, pkg):
        self.default = pkg.ResilientTrainLoop._default_step_fn
        self.log, self.fired, self.loop = [], False, None

    def __call__(self, engine, batch):
        loss = float(self.default(engine, batch))
        self.log.append((self.loop.step, loss))
        if self.loop.step == NAN_STEP and not self.fired:
            self.fired = True
            return float("nan")
        return loss


def test_real_engines_roll_back_and_resume_as_jax(flax_params, tmp_path):
    """8 steps with a save every 2 and NaN reported after step 5's real
    step: one rollback to global_step4, step 5 skipped on replay; then a
    fresh loop over the same engine resumes from global_step8 and trains
    to 10.  Losses within 2e-5 of JAX's, the same events."""
    runs = {}
    for name, (pkg, eng) in _engines(flax_params).items():
        step_fn = PlantedNaN(pkg)
        save_dir = str(tmp_path / name)
        loop = pkg.ResilientTrainLoop(eng, _batch, save_dir,
                                      save_interval=2, keep_last=3,
                                      step_fn=step_fn)
        step_fn.loop = loop
        assert loop.run(8) == 8
        first = (_counters(loop.metrics), sorted(loop._skipped))
        resumed = pkg.ResilientTrainLoop(eng, _batch, save_dir,
                                         save_interval=2, keep_last=3,
                                         step_fn=step_fn)
        step_fn.loop = resumed
        assert resumed.run(10) == 10
        runs[name] = {"log": step_fn.log, "first": first,
                      "second": (_counters(resumed.metrics),
                                 sorted(resumed._skipped)),
                      "tags": sorted(os.listdir(save_dir))}
    want, got = runs["jax"], runs["port"]
    assert [s for s, _ in got["log"]] == [s for s, _ in want["log"]]
    for (_, a), (_, b) in zip(got["log"], want["log"]):
        assert math.isclose(a, b, rel_tol=LOSS_TOL, abs_tol=LOSS_TOL), \
            (got["log"], want["log"])
    assert (got["first"], got["second"], got["tags"]) == \
        (want["first"], want["second"], want["tags"])
    counters, skipped = got["first"]
    assert counters["rollbacks"] == 1 and counters["skipped_steps"] == 1
    assert skipped == [NAN_STEP]
    assert got["second"][0]["resumes"] == 1


# --------------------------------------------------------------------- #
# The port's chaos smoke
# --------------------------------------------------------------------- #
def test_chaos_smoke_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "port_chaos_smoke", ROOT / "deepspeed_tpu_torch" / "tools" /
        "chaos_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    snap = cs.run_smoke(str(tmp_path), device="cpu")
    assert snap["resumed_from"] == "global_step4"
    assert snap["crash_exit_code"] == cs.CRASH_EXIT_CODE
    assert snap["resumes"] == 1 and snap["saves"] == 2
    assert snap["resumed_final_loss"] == snap["ref_final_loss"]
    shutil.rmtree(tmp_path, ignore_errors=True)
