"""The port's checkpoints against the JAX package's, on the CPU.

Training (``save_checkpoint`` / ``load_checkpoint``, the bench ds_config in
f32 at ``tiny_geometry``, the JAX engine on a one-device mesh):

* a port save / load round trip is bit-exact (masters, Adam moments,
  accumulators, scalars, ``client_state``), through ``CheckpointEngine``
  and ``AsyncCheckpointEngine``, and the resumed run equals the straight
  run bitwise;
* a checkpoint the JAX engine wrote loads into the port, and 2 more steps
  match the JAX engine's own continuation within 1e-4
  (``test_torch_engine.py``'s ``TOL``); one the port wrote loads into the
  JAX engine, with the same files, index and names;
* the manifest's fallback past a corrupted tag and a stale ``latest``;
* ``zero_to_fp32``, ``ds_to_universal`` and ``state_dict_factory`` give
  JAX's outputs on the same checkpoint.

Serving: ``serialize`` of ``params_from_jax(jparams)`` writes a
``model.bin`` byte-identical to the JAX engine's, with the same
``metadata.json`` tensor list, and each package's ``load_serialized`` reads
the other's output.
"""

import inspect
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import ds_to_universal as jd2u
from deepspeed_tpu.checkpoint import zero_to_fp32 as jz2f
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JServe
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JSConfig
from deepspeed_tpu.inference.v2.model_implementations import (
    RaggedLlama as JRaggedLlama)
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.parallel import groups
from deepspeed_tpu.runtime import engine as jengine_mod
from deepspeed_tpu.runtime import state_dict_factory as jsdf
from deepspeed_tpu_torch.checkpoint import (AsyncCheckpointEngine,
                                            CheckpointEngine,
                                            flax_params_from_llama_state_dict,
                                            llama_state_dict_from_flax,
                                            params_from_jax)
from deepspeed_tpu_torch.checkpoint import ds_to_universal as td2u
from deepspeed_tpu_torch.checkpoint import engine as tckpt_engine
from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as tz2f
from deepspeed_tpu_torch.checkpoint.engine import flax_layout
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TServe
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TSConfig)
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama as TRaggedLlama)
from deepspeed_tpu_torch.models import (GPT2Config, GPT2LMHeadModel,
                                        LlamaConfig, LlamaForCausalLM)
from deepspeed_tpu_torch.runtime import engine as tengine_mod
from deepspeed_tpu_torch.runtime import state_dict_factory as tsdf
from torch_port_common import single_process_env  # noqa: F401 (autouse)
from torch_port_common import llama_params, tiny_geometry

TOL = 1e-4
CFG = {"train_micro_batch_size_per_gpu": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
       "scheduler": {"type": "WarmupLR",
                     "params": {"warmup_num_steps": 4}},
       "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0,
       "attention_layout": "bshd"}
SHARD = "zero_pp_rank_0_mp_rank_00_states.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The test workers share the CPU: one torch thread each keeps these
    small-tensor tests from spinning up a thread pool per operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_init():
    geom = tiny_geometry()
    jmodel = JLlama(JLlamaConfig(**geom, dtype=jnp.float32))
    params = jax.device_get(jmodel.init(jax.random.key(0),
                                        np.zeros((1, 8), np.int32)))["params"]
    return geom, jmodel, params


def _jax_engine(flax_init, params=None):
    _, jmodel, p = flax_init
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=CFG, model_parameters=p if params is None
        else params, topology=groups.initialize_mesh(
            devices=jax.devices()[:1]))
    return eng


def _port_engine(flax_init, params=True):
    geom, _, p = flax_init
    model = LlamaForCausalLM(LlamaConfig(**geom, dtype=torch.float32),
                             device="cpu")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=CFG, device="cpu",
        model_parameters=llama_state_dict_from_flax(p, device="cpu")
        if params else None)
    return eng


def _ids(seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(2, 32)).astype(np.int32)


def _steps(eng, seeds):
    losses = []
    for s in seeds:
        ids = _ids(s)
        loss = eng(ids, ids)
        eng.backward(loss)
        eng.step()
        losses.append(float(np.asarray(loss.detach() if isinstance(
            loss, torch.Tensor) else loss)))
    return losses


def _port_state(eng):
    return ([m.clone() for m in eng.master],
            {k: [t.clone() for t in v] for k, v in eng.opt_state.items()},
            [a.clone() for a in eng.acc_grads],
            (eng.global_steps, eng.opt_step, eng.loss_scale, eng.good_steps,
             eng.hysteresis, eng.global_samples, eng.micro_steps,
             eng.lr_scheduler.state_dict()))


def _assert_state_equal(a, b):
    for x, y in zip(a[0] + a[2], b[0] + b[2]):
        assert torch.equal(x, y)
    for k in a[1]:
        for x, y in zip(a[1][k], b[1][k]):
            assert torch.equal(x, y)
    assert a[3] == b[3]


def _assert_masters_close(jeng, teng, tol=TOL):
    want = jax.device_get(jeng.state["master"])
    got = flax_params_from_llama_state_dict(teng.module_state_dict())
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------- #
# Training checkpoints
# --------------------------------------------------------------------- #
def test_engine_checkpoint_signatures_match_jax():
    for name in ("save_checkpoint", "load_checkpoint", "train_micro_batch"):
        want = inspect.signature(getattr(jengine_mod.DeepSpeedEngine, name))
        got = inspect.signature(getattr(tengine_mod.DeepSpeedEngine, name))
        assert list(got.parameters) == list(want.parameters), name
        assert [p.default for p in got.parameters.values()] == \
            [p.default for p in want.parameters.values()], name


@pytest.mark.parametrize("engine_cls", [CheckpointEngine,
                                        AsyncCheckpointEngine])
def test_port_round_trip_is_bit_exact(flax_init, tmp_path, engine_cls):
    """2 steps, save (with a client key), a fresh engine loads: every
    tensor, scalar and counter equal; 2 more steps on each equal."""
    a = _port_engine(flax_init)
    a.checkpoint_engine = engine_cls()
    _steps(a, (1, 2))
    a.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    b = _port_engine(flax_init, params=False)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step2")
    assert client["epoch"] == 3 and client["global_steps"] == 2
    _assert_state_equal(_port_state(b), _port_state(a))
    for p, q in zip(a._params, b._params):
        assert torch.equal(p, q)
    assert _steps(b, (3, 4)) == _steps(a, (3, 4))
    _assert_state_equal(_port_state(b), _port_state(a))


def test_load_module_only(flax_init, tmp_path):
    a = _port_engine(flax_init)
    _steps(a, (1,))
    a.save_checkpoint(str(tmp_path))
    b = _port_engine(flax_init, params=False)
    b.load_checkpoint(str(tmp_path), load_module_only=True)
    for x, y in zip(a.master, b.master):
        assert torch.equal(x, y)
    assert b.opt_step == 0 and all(
        not t.any() for t in b.opt_state["m"])


def test_jax_checkpoint_loads_into_port(flax_init, tmp_path):
    """The JAX engine trains 2 steps and saves; the port loads it, and 2
    more steps on each match within TOL."""
    jeng = _jax_engine(flax_init)
    _steps(jeng, (1, 2))
    jeng.save_checkpoint(str(tmp_path))
    teng = _port_engine(flax_init, params=False)
    path, client = teng.load_checkpoint(str(tmp_path))
    assert path is not None and teng.global_steps == 2
    assert teng.opt_step == 2
    _assert_masters_close(jeng, teng, tol=0.0)
    lj, lt = _steps(jeng, (3, 4)), _steps(teng, (3, 4))
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    _assert_masters_close(jeng, teng)


def test_port_checkpoint_loads_into_jax(flax_init, tmp_path):
    """The port trains 2 steps and saves; the files, index and names are
    the JAX engine's, and the JAX engine loads them and continues like
    the port."""
    teng = _port_engine(flax_init)
    jeng = _jax_engine(flax_init)
    _steps(teng, (1, 2))
    _steps(jeng, (1, 2))
    teng.save_checkpoint(str(tmp_path / "t"))
    jeng.save_checkpoint(str(tmp_path / "j"))
    tdir, jdir = tmp_path / "t" / "global_step2", tmp_path / "j" / \
        "global_step2"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    with np.load(tdir / SHARD) as zt, np.load(jdir / SHARD) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert json.loads(bytes(zt["__index__"]).decode()) == \
            json.loads(bytes(zj["__index__"]).decode())
        for k in zj.files:
            if k.startswith("__scalar__"):
                assert zt[k].dtype == zj[k].dtype and zt[k] == zj[k], k
    fresh = _jax_engine(flax_init, params=jax.tree.map(
        lambda a: a * 0, flax_init[2]))
    path, client = fresh.load_checkpoint(str(tmp_path / "t"))
    assert path is not None and fresh.global_steps == 2
    _assert_masters_close(fresh, teng, tol=0.0)
    lj, lt = _steps(fresh, (3, 4)), _steps(teng, (3, 4))
    np.testing.assert_allclose(lt, lj, rtol=TOL, atol=TOL)
    _assert_masters_close(fresh, teng)


def _two_tags(flax_init, root):
    eng = _port_engine(flax_init)
    _steps(eng, (1,))
    eng.save_checkpoint(str(root))
    first = _port_state(eng)
    _steps(eng, (2,))
    eng.save_checkpoint(str(root))
    return first


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("fault", ["corrupt", "truncate", "stale_latest",
                                   "explicit_corrupt"])
def test_manifest_fallback(flax_init, tmp_path, fault):
    """A damaged newest tag (or a ``latest`` naming a tag that is gone)
    falls back to the previous verified tag, in the port as in the JAX
    engine; ``verify="size"`` misses a flipped byte that the load then
    catches through the archive's own CRC."""
    first = _two_tags(flax_init, tmp_path)
    shard = tmp_path / "global_step2" / SHARD
    tag = None
    if fault == "corrupt" or fault == "explicit_corrupt":
        _flip_byte(shard)
        tag = "global_step2" if fault == "explicit_corrupt" else None
    elif fault == "truncate":
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 7)
    else:
        shutil.rmtree(tmp_path / "global_step2")
    got = []
    for eng in (_port_engine(flax_init, params=False),
                _jax_engine(flax_init)):
        path, _ = eng.load_checkpoint(str(tmp_path), tag=tag)
        got.append(os.path.basename(path))
        if isinstance(eng, tengine_mod.DeepSpeedEngine):
            _assert_state_equal(_port_state(eng), first)
    assert got == ["global_step1", "global_step1"]
    if fault == "corrupt":
        # a flipped byte passes the size check; the archive's own CRC then
        # refuses the load, which falls back or loads nothing
        eng = _port_engine(flax_init, params=False)
        assert eng.load_checkpoint(str(tmp_path), verify="size",
                                   fallback=False) == (None, {})
        path, _ = eng.load_checkpoint(str(tmp_path), verify="size")
        assert os.path.basename(path) == "global_step1"


@pytest.mark.parametrize("fault", ["bad_client_state", "device_error"])
def test_failed_load_leaves_engine_unchanged(flax_init, tmp_path,
                                             monkeypatch, fault):
    """A damaged checkpoint is refused before any tensor of the engine is
    written (the client state is read last of all files, after the shards
    and their checks); an error while copying in is not taken for a
    damaged checkpoint: it propagates instead of falling back."""
    eng = _port_engine(flax_init)
    _steps(eng, (1,))
    eng.save_checkpoint(str(tmp_path))
    target = _port_engine(flax_init)
    _steps(target, (3,))
    before = _port_state(target)
    if fault == "bad_client_state":
        with open(tmp_path / "global_step1" / "client_state.json", "w") as f:
            f.write("{")
        assert target.load_checkpoint(str(tmp_path), verify="off",
                                      fallback=False) == (None, {})
    else:
        def device_error(*args):
            raise RuntimeError("CUDA error: out of memory")
        monkeypatch.setattr(tckpt_engine, "write_flat", device_error)
        with pytest.raises(RuntimeError, match="out of memory"):
            target.load_checkpoint(str(tmp_path))
    _assert_state_equal(_port_state(target), before)


def test_offline_tools_match_jax(flax_init, tmp_path):
    """On one JAX-written checkpoint: ``zero_to_fp32`` and
    ``ds_to_universal`` give JAX's arrays and files; the universal tree
    loads into the port's engine like the checkpoint itself;
    ``load_state_dict_from_zero_checkpoint`` fills a port model."""
    jeng = _jax_engine(flax_init)
    _steps(jeng, (1, 2))
    jeng.save_checkpoint(str(tmp_path / "ck"))
    want = jz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path /
                                                             "ck"))
    got = tz2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ck"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tz2f.main([str(tmp_path / "ck"), str(tmp_path / "t.npz")])
    jz2f.main([str(tmp_path / "ck"), str(tmp_path / "j.npz")])
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)

    td2u.main(["--input_folder", str(tmp_path / "ck"),
               "--output_folder", str(tmp_path / "tu")])
    jd2u.convert(str(tmp_path / "ck"), str(tmp_path / "ju"))
    tfiles = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "tu")
                    for d, _, fs in os.walk(tmp_path / "tu") for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ju")
                    for d, _, fs in os.walk(tmp_path / "ju") for f in fs)
    assert tfiles == jfiles
    for f in tfiles:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "tu" / f),
                                          np.load(tmp_path / "ju" / f))
    a = _port_engine(flax_init, params=False)
    td2u.load_universal_into_engine(a, str(tmp_path / "tu"))
    b = _port_engine(flax_init, params=False)
    b.load_checkpoint(str(tmp_path / "ck"))
    st_a, st_b = _port_state(a), _port_state(b)
    # masters, moments and the five scalars (not the accumulators nor the
    # client state, which the universal tree leaves out)
    _assert_state_equal((st_a[0], st_a[1], [], st_a[3][:5]),
                        (st_b[0], st_b[1], [], st_b[3][:5]))

    geom = flax_init[0]
    model = LlamaForCausalLM(LlamaConfig(**geom, dtype=torch.float32),
                             device="cpu")
    tz2f.load_state_dict_from_zero_checkpoint(model, str(tmp_path / "ck"))
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(zip(b._names, b.master))[name])


@pytest.mark.parametrize("arch,shards", [("llama", 2), ("gpt2", 2),
                                         ("gpt2", 4), ("bloom", 2),
                                         ("mixtral", 2)])
def test_state_dict_factory_matches_jax(arch, shards):
    """The plan from names, the split and the merge back equal JAX's:
    a Llama tree from a checkpoint's layout, GPT-2 with its fused qkv
    interleave, BLOOM's per-head fused qkv and Mixtral's experts."""
    rng = np.random.default_rng(3)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if arch == "llama":
        tree = {k: v for k, v in llama_params(tiny_geometry()).items()}
    elif arch == "gpt2":
        tree = {"h_0": {"c_attn": {"kernel": arr(16, 48), "bias": arr(48)},
                        "attn_out": {"kernel": arr(16, 16)},
                        "c_fc": {"kernel": arr(16, 64), "bias": arr(64)},
                        "ln_1": {"scale": arr(16), "bias": arr(16)}},
                "wte": {"embedding": arr(32, 16)},
                "wpe": {"embedding": arr(8, 16)}}
    elif arch == "bloom":
        tree = {"h_0": {"self_attention": {"query_key_value": {
            "kernel": arr(8, 24), "bias": arr(24)}}}}
    else:
        tree = {"layers_0": {"block_sparse_moe": {
            "experts": {"w1": {"kernel": arr(2, 8, 16)},
                        "w2": {"kernel": arr(2, 16, 8)}},
            "gate": {"kernel": arr(8, 2)}},
            "self_attn": {"q_proj": {"kernel": arr(8, 8)}}}}
    assert tsdf.axes_from_policy(arch, tree) == jsdf.axes_from_policy(
        arch, tree)
    jsplit = jsdf.SDLoaderFactory.get_sd_loader([tree], arch) \
        .split_state_dict(shards)
    tsplit = tsdf.SDLoaderFactory.get_sd_loader([tree], arch) \
        .split_state_dict(shards)
    for a, b in zip(jax.tree_util.tree_leaves(tsplit),
                    jax.tree_util.tree_leaves(jsplit)):
        np.testing.assert_array_equal(a, np.asarray(b))
    merged = tsdf.SDLoaderFactory.get_sd_loader(tsplit, arch) \
        .merge_state_dict()
    for a, b in zip(jax.tree_util.tree_leaves(merged),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    axes = {"w": 1, "n": None}
    two = {"w": arr(4, 12), "n": arr(4)}
    t = tsdf.SDLoaderFactory.get_sd_loader_json([two], axes) \
        .split_state_dict(3)
    j = jsdf.SDLoaderFactory.get_sd_loader_json([two], axes) \
        .split_state_dict(3)
    assert all(np.array_equal(a["w"], b["w"]) for a, b in zip(t, j))


def test_gpt2_layout_names_match_jax_master():
    """The GPT-2 mapping names every parameter by the JAX master's flat
    path, transposing exactly the Dense kernels."""
    jmodel = JGPT2(JGPT2Config.tiny(hidden_size=64, num_attention_heads=2,
                                    dtype=jnp.float32))
    params = jax.device_get(jmodel.init(
        jax.random.key(0), np.zeros((1, 8), np.int32)))["params"]
    want = {"/".join(str(k.key) for k in path): np.shape(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    model = GPT2LMHeadModel(GPT2Config.tiny(hidden_size=64,
                                            num_attention_heads=2,
                                            dtype=torch.float32),
                            device="cpu")
    named = dict(model.named_parameters())
    layout = flax_layout(model, list(named))
    got = {path: tuple(named[n].t().shape) if tr else tuple(named[n].shape)
           for n, (path, tr) in zip(named, layout)}
    assert got == want


# --------------------------------------------------------------------- #
# Serving checkpoints
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_serialize_matches_jax_and_cross_loads(tmp_path, int8):
    geom = tiny_geometry()
    jparams = llama_params(geom, seed=4, int8=int8)
    scfg = {"state_manager": {"max_ragged_batch_size": 32,
                              "max_ragged_sequence_count": 2,
                              "max_context": 64},
            "kv_cache": {"block_size": 8}}
    jcfg = JLlamaConfig(**geom, dtype=jnp.float32)
    tcfg = LlamaConfig(**geom, dtype=torch.float32)
    jeng = JServe(JRaggedLlama(jcfg, 8), jparams, JSConfig.from_dict(scfg))
    teng = TServe(TRaggedLlama(tcfg, 8), params_from_jax(jparams, "cpu"),
                  TSConfig.from_dict(scfg), device="cpu")
    jeng.serialize(str(tmp_path / "j"))
    teng.serialize(str(tmp_path / "t"))
    assert (tmp_path / "t" / "model.bin").read_bytes() == \
        (tmp_path / "j" / "model.bin").read_bytes()
    meta = [json.loads((tmp_path / d / "metadata.json").read_text())
            for d in ("t", "j")]
    assert meta[0]["tensors"] == meta[1]["tensors"]
    assert meta[0]["format_version"] == meta[1]["format_version"]
    prompt = np.random.default_rng(5).integers(0, 256, 12).tolist()
    want = np.asarray(teng.put([1], [prompt])[1])
    from_jax = TServe.load_serialized(str(tmp_path / "j"),
                                      TRaggedLlama(tcfg, 8),
                                      TSConfig.from_dict(scfg), device="cpu")
    np.testing.assert_array_equal(np.asarray(from_jax.put([1], [prompt])[1]),
                                  want)
    from_port = JServe.load_serialized(str(tmp_path / "t"),
                                       JRaggedLlama(jcfg, 8),
                                       JSConfig.from_dict(scfg))
    np.testing.assert_array_equal(
        np.asarray(from_port.put([1], [prompt])[1]),
        np.asarray(jeng.put([1], [prompt])[1]))
    flat = TServe.deserialize_params(str(tmp_path / "t"))
    assert sorted(flat) == sorted(t["name"] for t in meta[0]["tensors"])
