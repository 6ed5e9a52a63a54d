"""The port's HuggingFace loading (``checkpoint/hf_loader.py``,
``InferenceEngineV2.from_hf``) against the JAX package's on the same
checkpoint directories, on the CPU in f32.

The checkpoints are tiny Llama and Mixtral models in HF's names and
``[out, in]`` layouts, written here from numpy draws: one
``model.safetensors`` (f32), a sharded ``model.safetensors.index.json``
whose shards hold bf16 tensors, and a ``pytorch_model.bin``.  The JAX side
reads them through the ``safetensors`` package; the port through its own
reader.  Every param leaf (with ``quantize_bits=8`` every int8 record) is
bit-equal, and the ``put`` logits of the two engines agree within 2e-5.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu_torch.checkpoint import hf_loader
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2 as TEngine
from deepspeed_tpu_torch.inference.v2 import (
    RaggedInferenceEngineConfig as TConfig)
from deepspeed_tpu_torch.ops import quantizer as TQ
from torch_port_common import engine_config_dict, tiny_geometry

TOL = 2e-5
BS = 16

_NP_ST = {np.dtype(np.float32): "F32", np.dtype(ml_dtypes.bfloat16): "BF16"}


def _write_safetensors(tensors, path):
    """The safetensors format from numpy alone: an 8-byte little-endian
    header length, the JSON header, the raw bytes."""
    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        raw = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": _NP_ST[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        f.write(b"".join(blobs))


def _hf_tensors(arch, rng):
    """HF names and [out, in] layouts; f32 draws."""
    g = tiny_geometry()
    H, I, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    kv = g["num_key_value_heads"] * H // g["num_attention_heads"]

    def w(out, inp):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    t = {"model.embed_tokens.weight":
         (0.5 * rng.standard_normal((V, H))).astype(np.float32)}
    for i in range(g["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for n, o in (("q", H), ("k", kv), ("v", kv), ("o", H)):
            t[p + f"self_attn.{n}_proj.weight"] = w(o, H)
        if arch == "mixtral":
            t[p + "block_sparse_moe.gate.weight"] = w(4, H)
            for e in range(4):
                q = p + f"block_sparse_moe.experts.{e}."
                t[q + "w1.weight"], t[q + "w3.weight"] = w(I, H), w(I, H)
                t[q + "w2.weight"] = w(H, I)
        else:
            t[p + "mlp.gate_proj.weight"] = w(I, H)
            t[p + "mlp.up_proj.weight"] = w(I, H)
            t[p + "mlp.down_proj.weight"] = w(H, I)
        t[p + "input_layernorm.weight"] = norm()
        t[p + "post_attention_layernorm.weight"] = norm()
    t["model.norm.weight"] = norm()
    t["lm_head.weight"] = w(V, H)
    return g, t


def _checkpoint(tmp_path, arch, layout):
    g, tensors = _hf_tensors(arch, np.random.default_rng(
        {"llama": 0, "mixtral": 1}[arch]))
    cfg = dict(model_type=arch, vocab_size=g["vocab_size"],
               hidden_size=g["hidden_size"],
               intermediate_size=g["intermediate_size"],
               num_hidden_layers=g["num_hidden_layers"],
               num_attention_heads=g["num_attention_heads"],
               num_key_value_heads=g["num_key_value_heads"],
               max_position_embeddings=g["max_position_embeddings"],
               rms_norm_eps=1e-5, rope_theta=10000.0)
    if arch == "mixtral":
        cfg.update(num_local_experts=4, num_experts_per_tok=2)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    if layout == "single":
        _write_safetensors(tensors, tmp_path / "model.safetensors")
    elif layout == "sharded":
        names = list(tensors)
        shards = {"model-00001-of-00002.safetensors": names[::2],
                  "model-00002-of-00002.safetensors": names[1::2]}
        for fn, part in shards.items():
            _write_safetensors({n: tensors[n].astype(ml_dtypes.bfloat16)
                                for n in part}, tmp_path / fn)
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {n: fn for fn, part in shards.items()
                            for n in part}}))
    else:
        torch.save({n: torch.from_numpy(a) for n, a in tensors.items()},
                   tmp_path / "pytorch_model.bin")
    return str(tmp_path)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            yield from _leaves(v, prefix + (k,))
        elif isinstance(v, dict):
            yield prefix + (k, "q"), v["q"]
            yield prefix + (k, "scale"), v["scale"]
        else:
            yield prefix + (k,), v


def _engines(path, **kw):
    cfg = engine_config_dict(block_size=BS, max_context=128)
    teng = TEngine.from_hf(path, TConfig.from_dict(cfg), dtype=torch.float32,
                           device="cpu", **kw)
    jeng = JEngine.from_hf(path, JConfig.from_dict(cfg), dtype=jnp.float32,
                           **kw)
    return teng, jeng


@pytest.mark.parametrize("arch,layout,bits", [
    ("llama", "single", 8), ("llama", "sharded", 8), ("llama", "bin", None),
    ("mixtral", "sharded", None)])
def test_from_hf_matches_jax(tmp_path, arch, layout, bits):
    path = _checkpoint(tmp_path, arch, layout)
    teng, jeng = _engines(path, quantize_bits=bits)
    tl, jl = dict(_leaves(teng.params)), dict(_leaves(jeng.params))
    assert tl.keys() == jl.keys()
    for name, j in jl.items():
        t, j = tl[name], np.asarray(j)
        assert t.dtype == torch.from_numpy(j).dtype, name
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      j.view(np.uint8), err_msg=str(name))
    n_records = sum(name[-1] == "q" for name in tl)
    assert n_records == (15 if bits else 0)        # 2 x 7 + lm_head
    if arch == "mixtral":
        experts = teng.params["layers_0"]["block_sparse_moe"][
            "deepspeed_moe"]["experts"]
        assert experts["w_gate"].shape == (4, 256, 384)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 17)]
    got, want = teng.put([0, 1, 2], prompts), jeng.put([0, 1, 2], prompts)
    for u in (0, 1, 2):
        assert np.abs(got[u] - np.asarray(want[u])).max() <= TOL


def test_from_hf_quantizes_through_the_quantizer(tmp_path, monkeypatch):
    """``quantize_bits=8`` calls the groupwise quantizer once a matrix (on
    the card, the kernel), 64 groups by default, embeddings excluded."""
    path = _checkpoint(tmp_path, "llama", "single")
    calls = []
    real = TQ.quantize_kernel

    def spy(x, groups):
        calls.append((tuple(x.shape), groups))
        return real(x, groups)

    monkeypatch.setattr(TQ, "quantize_kernel", spy)
    eng = TEngine.from_hf(path, TConfig.from_dict(engine_config_dict()),
                          quantize_bits=8, device="cpu")
    assert len(calls) == 15 and all(g == 64 for _, g in calls)
    assert (256, 256) in {s for s, _ in calls}
    m = eng.params["model"]
    assert m["embed_tokens"]["embedding"].dtype == torch.bfloat16
    assert m["layers_1"]["mlp"]["down_proj"]["kernel"]["q"].shape == (384,
                                                                      256)


def test_safetensors_reader_and_writer(tmp_path):
    """The port's reader against the ``safetensors`` package's on a file
    of this test's writer, and its writer read back by that package."""
    from safetensors import safe_open

    rng = np.random.default_rng(3)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)}
    _write_safetensors(arrays, tmp_path / "x.safetensors")
    got = dict(hf_loader.read_safetensors(str(tmp_path / "x.safetensors")))
    assert got["b"].dtype == torch.bfloat16
    for n, a in arrays.items():
        np.testing.assert_array_equal(
            got[n].view(torch.uint16 if n == "b" else torch.float32).numpy(),
            a.view(np.uint16) if n == "b" else a)
    hf_loader.save_safetensors(got, str(tmp_path / "y.safetensors"))
    with safe_open(str(tmp_path / "y.safetensors"), framework="pt") as f:
        for n in arrays:
            assert torch.equal(f.get_tensor(n), got[n])


def test_unported_families_and_options_raise(tmp_path):
    path = _checkpoint(tmp_path, "mixtral", "bin")
    with pytest.raises(ValueError, match="Llama-family"):
        TEngine.from_hf(path, quantize_bits=8, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        TEngine.from_hf(path, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        hf_loader.load_hf_checkpoint(path, mesh=object(), device="cpu")
    cfg = json.loads((tmp_path / "config.json").read_text())
    for arch in ("gpt2", "falcon"):
        (tmp_path / "config.json").write_text(json.dumps(
            dict(cfg, model_type=arch)))
        with pytest.raises(NotImplementedError, match="A9"):
            TEngine.from_hf(path, device="cpu")
    with pytest.raises(hf_loader.HFLoadError, match="unmapped"):
        hf_loader.load_hf_checkpoint(path, architecture="llama",
                                     device="cpu")
    with pytest.raises(hf_loader.HFLoadError, match="no model.safetensors"):
        hf_loader.load_hf_checkpoint(str(tmp_path / "nowhere"),
                                     architecture="llama", device="cpu")
