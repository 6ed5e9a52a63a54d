"""The port's observability and resilience modules against the JAX package's,
on the CPU: the metrics registry (declarations, snapshot, unknown names,
Prometheus text), the tracer (span and instant events, their fields, the
Chrome trace file round trip, merging, ring wrap), the chaos fault points
(in-process and from ``DS_CHAOS``), the heartbeat (``from_env``, beats,
``read_heartbeat``), the engine's ``occupancy()`` gauges and the prefix
cache's attach snapshot / restore, ``hit_rate`` and ``as_dict``, each with
the same inputs on both sides.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.models import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from deepspeed_tpu.observability import registry as jreg
from deepspeed_tpu.observability import tracer as jtr
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.resilience import heartbeat as jhb
from deepspeed_tpu_torch.checkpoint import params_from_jax
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.models import LlamaConfig as TLlamaConfig
from deepspeed_tpu_torch.observability import memory as tmem
from deepspeed_tpu_torch.observability import registry as treg
from deepspeed_tpu_torch.observability import tracer as ttr
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience import heartbeat as thb

from torch_port_common import single_process_env  # noqa: F401 (autouse)

BS = 8


# --------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------- #
def _registry_run(mod):
    reg = mod.MetricsRegistry(isolated=True)
    reg.counter("serving/finished", help="done")
    reg.gauge("serving/goodput_tokens_per_s")
    reg.histogram("serving/p50_*", help="pct")
    reg.gauge("fleet/deaths_*")
    with pytest.raises(ValueError):
        reg.declare("serving/finished", "gauge")
    with pytest.raises(ValueError):
        reg.declare("x", "meter")
    reg.register_provider("a", lambda: {"serving/finished": 3,
                                        "serving/p50_ttft_s": 0.25,
                                        "fleet/deaths_r1": 1,
                                        "serving/typo": 2})
    reg.register_provider("b", lambda: 1 / 0)
    reg.register_provider("c", lambda: {"serving/goodput_tokens_per_s": 9.5})
    reg.unregister_provider("c")
    snap = reg.snapshot()
    return (snap, sorted(reg.unknown_names), reg.to_prometheus(snap),
            reg.providers, [s.name for s in reg.declared()],
            reg.lookup("fleet/deaths_r7").name,
            [(e[0], e[1]) for e in reg.export(now=5.0)])


def test_registry_matches_jax():
    assert _registry_run(treg) == _registry_run(jreg)
    assert treg.default_registry() is treg.MetricsRegistry.default()


# --------------------------------------------------------------------- #
# Tracer
# --------------------------------------------------------------------- #
def _tracer_run(mod, tmp_path, capacity=64):
    tr = mod.Tracer(capacity=capacity, tid="r0")
    tid = mod.mint_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0
    root = tr.start("tick", trace_id=tid, attrs={"tick": 0})
    with tr.span("pack", trace_id=tid, parent=root.span_id):
        pass
    tr.instant("emit", trace_id=tid, parent=root.span_id,
               attrs={"tokens": 3})
    tr.finish(root, attrs={"outcome": "ok"})
    tr.start("request/decode", trace_id=tid, tid="r1")     # left open
    tr.enabled = False
    tr.instant("ignored", trace_id=tid)
    tr.enabled = True
    events = tr.export_events()
    other = mod.Tracer(tid="r2")
    other.instant("request/submit", trace_id=tid)
    merged = mod.merge_events(events, other.export_events())
    path = mod.write_chrome_trace(str(tmp_path / f"{mod.__name__}.json"),
                                  merged)
    loaded = mod.load_chrome_trace(path)

    def shape(evs):
        return [(e["name"], e["ph"], e["tid"], sorted(e),
                 sorted(k for k in e.get("args", {})
                        if k not in ("trace_id", "span_id", "parent")))
                for e in evs]

    small = mod.Tracer(capacity=2)
    for i in range(5):
        small.instant(f"i{i}")
    return (shape(events), shape(loaded), len(loaded) - len(merged),
            sorted(json.load(open(path))), tr.telemetry(),
            [e["name"] for e in small.export_events()], small.telemetry(),
            [h.name for h in tr.open_spans()])


def test_tracer_matches_jax(tmp_path):
    got = _tracer_run(ttr, tmp_path)
    assert got == _tracer_run(jtr, tmp_path)
    # the ids that tie one request's spans together
    tr = ttr.Tracer()
    h = tr.start("a", trace_id="t1")
    tr.instant("b", trace_id="t1", parent=h.span_id)
    tr.finish(h)
    ev = {e["name"]: e for e in tr.export_events()}
    a, b = ev["a"], ev["b"]
    assert b["args"]["parent"] == a["args"]["span_id"]
    assert a["args"]["trace_id"] == b["args"]["trace_id"] == "t1"


def test_device_annotations_are_a_shared_noop_until_enabled():
    assert not ttr.device_annotations_enabled()
    assert ttr.annotate("x") is ttr.step_annotation(3)       # one no-op
    ttr.enable_device_annotations(True)
    try:
        with ttr.step_annotation(3), ttr.annotate("decode"):
            torch.ones(2).sum()
    finally:
        ttr.enable_device_annotations(False)
    assert not ttr.device_annotations_enabled()


# --------------------------------------------------------------------- #
# Chaos and heartbeat
# --------------------------------------------------------------------- #
def _chaos_run(mod, monkeypatch):
    mod.disarm()
    monkeypatch.delenv(mod.ENV_VAR, raising=False)
    monkeypatch.setattr(mod, "_env_loaded", False)
    out = [mod.fire("tick_stall"), mod.armed("tick_stall")]
    with mod.inject("poison_request", key="7"):
        out.append(mod.fire("poison_request", key="3"))
        with pytest.raises(mod.ChaosInjectedError):
            mod.fire("poison_request", key="7")
    out.append(mod.armed("poison_request"))
    f = mod.arm("heartbeat_stall", after=1, count=2)
    out += [mod.fire("heartbeat_stall") for _ in range(4)]
    out.append((f.hits, f.fires))
    with pytest.raises(ValueError, match="unknown fault point"):
        mod.arm("nope")
    with pytest.raises(ValueError, match="unknown chaos action"):
        mod.arm("tick_stall", action="explode")
    mod.disarm()
    monkeypatch.setenv(mod.ENV_VAR, "tick_stall:action=drop,count=0;"
                       "poison_request:key=5")
    monkeypatch.setattr(mod, "_env_loaded", False)
    out += [mod.fire("tick_stall"), mod.fire("tick_stall"),
            mod.armed("poison_request").key]
    mod.disarm()
    return out


def test_chaos_matches_jax(monkeypatch):
    assert _chaos_run(tchaos, monkeypatch) == _chaos_run(jchaos, monkeypatch)
    assert tchaos.FAULT_POINTS == jchaos.FAULT_POINTS


def test_heartbeat_matches_jax(tmp_path, monkeypatch):
    got = []
    for mod in (jhb, thb):
        monkeypatch.delenv(mod.ENV_FILE, raising=False)
        assert mod.Heartbeat.from_env() is None
        path = tmp_path / f"{mod.__name__}.hb"
        monkeypatch.setenv(mod.ENV_FILE, str(path))
        monkeypatch.setenv(mod.ENV_INTERVAL, "8")
        hb = mod.Heartbeat.from_env()
        wrote = [hb.beat(step=1), hb.beat(step=2), hb.beat(step=3,
                                                             force=True)]
        info = mod.read_heartbeat(str(path))
        missing = mod.read_heartbeat(str(tmp_path / "none"))
        got.append((wrote, info.exists, info.step, info.age_s < 60,
                    hb.interval_s, missing.exists, missing.age_s))
    assert got[1] == got[0]
    assert (thb.ENV_FILE, thb.ENV_INTERVAL, thb.ENV_DUMP) == (
        jhb.ENV_FILE, jhb.ENV_INTERVAL, jhb.ENV_DUMP)


# --------------------------------------------------------------------- #
# Engine occupancy and the prefix cache
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engines():
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, JLlamaForCausalLM(
        jcfg).init(jax.random.key(0), np.zeros((1, 4), np.int32))["params"])
    cfg = {"state_manager": {"max_ragged_batch_size": 32,
                             "max_ragged_sequence_count": 4,
                             "max_context": 64},
           "kv_cache": {"block_size": BS, "num_blocks": 17,
                        "enable_prefix_cache": True}}
    return (lambda: JEngine(JRaggedLlama(jcfg, BS), jparams,
                            JConfig.from_dict(cfg)),
            lambda: TEngine(TRaggedLlama(TLlamaConfig.tiny(
                dtype=torch.float32), BS), params_from_jax(jparams, "cpu"),
                TConfig.from_dict(cfg), device="cpu"))


def _cache_run(eng):
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 256, size=(16,)).tolist()
    eng.put([1], [shared + [5, 6, 7]])
    eng.put([2], [shared + [9]])              # attaches two cached blocks
    occ = eng.occupancy()
    pc = eng.state_manager.prefix_cache
    st = pc.stats
    snap = st.attach_snapshot()
    eng.attach_prefix(3, shared + [1])
    after = st.as_dict()
    st.restore_attach(snap)
    restored = (st.as_dict(), st.hit_rate)
    eng.flush([3])
    eng.flush([1, 2])
    return (occ, snap, after, restored, pc.cached_blocks,
            eng.state_manager.free_blocks,
            eng.occupancy()["observability/kv_blocks_warm"])


def test_occupancy_and_prefix_cache_match_jax(engines):
    jmake, tmake = engines
    got, want = _cache_run(tmake()), _cache_run(jmake())
    assert got == want
    assert got[0]["observability/hbm_weights_bytes"] > 0
    assert got[-3] > 0 and got[-1] == float(got[-3])  # warm cached blocks


def test_occupancy_provider_adds_tenant_gauges(engines):
    eng = engines[1]()

    class Sched:
        _queued = [type("R", (), {"tenant": "a", "history": [1, 2, 3]})()]
        _running = {1: type("R", (), {"tenant": None, "history": [4]})()}
        _preempted = []

    out = tmem.make_occupancy_provider(eng, Sched())()
    assert out["observability/tenant_tokens_a"] == 3.0
    assert out["observability/tenant_tokens_default"] == 1.0
    assert out["observability/kv_blocks_total"] == 16.0
    assert tmem.tree_bytes({"w": torch.zeros(3, 4, dtype=torch.bfloat16),
                            "l": [torch.zeros(5)]}) == 44.0
