"""Shared fixtures of the port's parity tests (``tests/test_torch_*.py``).

Weights and inputs are made with numpy from a seed and handed to both the
JAX package and the port (through ``params_from_jax``), so the two sides
see bit-identical inputs.
"""

from __future__ import annotations

import numpy as np
import pytest


def tiny_geometry(**kw):
    """A small Llama geometry with GQA (4 query heads over 2 KV heads) and
    head_dim 64."""
    base = dict(vocab_size=256, hidden_size=256, intermediate_size=384,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512)
    base.update(kw)
    return base


def int8_record(rng, k, n, groups):
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (rng.random(groups) * 0.5 + 0.75).astype(np.float32) \
        / np.float32(73.3 * np.sqrt(k))
    return {"q": q, "scale": scale}


def llama_params(geom, seed=0, int8=False, groups=4):
    """The ragged-Llama param tree as nested dicts of numpy arrays: f32
    ``[K, N]`` kernels, or int8 records when ``int8``."""
    rng = np.random.default_rng(seed)
    H, I, V = (geom["hidden_size"], geom["intermediate_size"],
               geom["vocab_size"])
    kv = geom["num_key_value_heads"] * (H // geom["num_attention_heads"])

    def w(k, n):
        if int8:
            return {"kernel": int8_record(rng, k, n, groups)}
        return {"kernel": (rng.standard_normal((k, n))
                           / np.sqrt(k)).astype(np.float32)}

    def norm():
        return {"scale": (1.0 + 0.1 * rng.standard_normal(H)).astype(
            np.float32)}

    model = {"embed_tokens": {"embedding": (
        0.5 * rng.standard_normal((V, H))).astype(np.float32)}}
    for i in range(geom["num_hidden_layers"]):
        model[f"layers_{i}"] = {
            "self_attn": {"q_proj": w(H, H), "k_proj": w(H, kv),
                          "v_proj": w(H, kv), "o_proj": w(H, H)},
            "mlp": {"gate_proj": w(H, I), "up_proj": w(H, I),
                    "down_proj": w(I, H)},
            "input_layernorm": norm(),
            "post_attention_layernorm": norm(),
        }
    model["norm"] = norm()
    return {"model": model, "lm_head": w(H, V)}


def engine_config_dict(token_budget=64, max_seqs=4, max_context=96,
                       block_size=16, prefix_cache=False):
    return {
        "state_manager": {"max_ragged_batch_size": token_budget,
                          "max_ragged_sequence_count": max_seqs,
                          "max_context": max_context},
        "kv_cache": {"block_size": block_size,
                     "enable_prefix_cache": prefix_cache},
    }


#: what a launcher sets for each process it starts, and what both packages'
#: ``initialize`` read: a world of ``WORLD_SIZE`` processes, this one's
#: ``RANK``, where to meet
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def single_process_env(monkeypatch):
    """Run each test of a module that imports this fixture as one process
    that no launcher started: a test elsewhere in the same pytest process
    can leave launcher variables behind (the JAX package's ``mpi_discovery``
    writes them into ``os.environ``; ``tests/unit/test_launcher_elasticity
    .py::test_mpi_discovery_from_slurm_env`` leaves ``WORLD_SIZE=8``), and
    an engine built after it would take them for a multi-process launch.
    They are put back after the test."""
    for key in LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked ``cuda``; decided when the test
    runs (never at import or collection), skipping where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); the kernels are checked by chip_smoke.py")
    return torch.device("cuda", 0)
