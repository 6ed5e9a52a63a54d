"""The port stands alone and never runs on the CPU by accident.

* ``deepspeed_tpu_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``deepspeed_tpu`` (checked on the source with ``ast``, and by
  importing every module in a fresh interpreter);
* importing the package builds nothing;
* an entry point called without ``device="cpu"`` on a machine without a
  GPU raises instead of running on the CPU (the serving engine, the
  training ``initialize``, the Llama and Mixtral models, ``MoE``, the
  weight bridges), and a kernel build without ``nvcc`` raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_port_common import single_process_env  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deepspeed_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "deepspeed_tpu" or name.startswith("deepspeed_tpu."))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_importing_every_module_loads_no_jax_and_builds_nothing(tmp_path):
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from deepspeed_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deepspeed_tpu' or m.startswith('deepspeed_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.checkpoint import (params_from_jax,
                                                random_int8_llama_params,
                                                random_mixtral_params)
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama, RaggedMixtral)
    from deepspeed_tpu_torch.models import LlamaConfig, MixtralConfig

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    params = random_int8_llama_params(cfg, groups=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(RaggedLlama(cfg, 8), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_int8_llama_params(cfg)
    mcfg = MixtralConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngineV2(RaggedMixtral(mcfg, 8),
                          random_mixtral_params(mcfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        random_mixtral_params(mcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError, match="CUDA"):
        get_accelerator()
    cpu = get_accelerator("cpu")
    assert cpu.device() == torch.device("cpu")
    cpu.synchronize()
    cpu.reset_peak_memory_stats()
    assert cpu.max_memory_allocated() == 0

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import llama_state_dict_from_flax
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cpu"),
            config={"train_micro_batch_size_per_gpu": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        llama_state_dict_from_flax({"lm_head": {"kernel": [[1.0]]}})

    from deepspeed_tpu_torch.models import MixtralForCausalLM
    from deepspeed_tpu_torch.moe import MoE

    with pytest.raises(RuntimeError, match="CUDA"):
        MixtralForCausalLM(mcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        MoE(8, 16, num_experts=2, dropless=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(
            model=MixtralForCausalLM(mcfg, device="cpu", dropless=True),
            config={"train_micro_batch_size_per_gpu": 1})


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
    # the library name follows the source text: an edit forces a rebuild
    assert _build.library_path("blocked_flash").name.startswith(
        "libblocked_flash-")
    assert set(_build.SOURCES) == {p.stem for p in (PORT / "csrc").glob(
        "*.cu")}


def _jax_initialize_params():
    """The parameter names of ``deepspeed_tpu.initialize``, read from its
    source (this file imports nothing of the JAX package)."""
    tree = ast.parse((ROOT / "deepspeed_tpu" / "__init__.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "initialize")
    return [a.arg for a in fn.args.args]


def _tiny_llama():
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                            device="cpu")


def test_initialize_keeps_the_jax_signature(tmp_path):
    """The JAX parameters in the JAX order (``device`` after them);
    ``initialize(args, model)`` positional reads ``args.deepspeed_config``
    (a JSON file), ``config_params=`` is a config, and ``config=`` wins
    over both."""
    import argparse
    import inspect
    import json

    import deepspeed_tpu_torch

    names = list(inspect.signature(deepspeed_tpu_torch.initialize).parameters)
    assert names == _jax_initialize_params() + ["device"]

    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps({"train_micro_batch_size_per_gpu": 3}))
    parser = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed", "--deepspeed_config", str(path)])
    assert args.deepspeed and args.deepspeed_config == str(path)
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        args, _tiny_llama(), device="cpu")
    assert engine.train_micro_batch_size_per_gpu() == 3
    assert opt is engine and loader is None and sched is None
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_tiny_llama(), device="cpu",
        config_params={"train_micro_batch_size_per_gpu": 5})
    assert engine.train_micro_batch_size_per_gpu() == 5
    engine, *_ = deepspeed_tpu_torch.initialize(
        args, _tiny_llama(), device="cpu",
        config={"train_micro_batch_size_per_gpu": 7})
    assert engine.train_micro_batch_size_per_gpu() == 7
    with pytest.raises(ValueError, match="config required"):
        deepspeed_tpu_torch.initialize(model=_tiny_llama(), device="cpu")


@pytest.mark.parametrize("kw", ["optimizer", "mpu", "topology"])
def test_initialize_raises_on_what_needs_more_than_one_device(kw):
    from types import SimpleNamespace

    import deepspeed_tpu_torch

    value = {"optimizer": object(), "mpu": object(),
             "topology": SimpleNamespace(world_size=4)}[kw]
    with pytest.raises(NotImplementedError, match="A6"):
        deepspeed_tpu_torch.initialize(
            model=_tiny_llama(), config={"train_micro_batch_size_per_gpu": 1},
            device="cpu", **{kw: value})


def test_top_level_reexports_and_init_distributed(monkeypatch):
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.utils.logging import logger

    assert (ds.DeepSpeedEngine, ds.DeepSpeedConfig, ds.DeepSpeedDataLoader,
            ds.RepeatingLoader, ds.get_accelerator, ds.logger) == (
        DeepSpeedEngine, DeepSpeedConfig, DeepSpeedDataLoader,
        RepeatingLoader, get_accelerator, logger)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ds.init_distributed()                       # world size 1: nothing to do
    ds.init_distributed(world_size=1)
    with pytest.raises(NotImplementedError, match="A6"):
        ds.init_distributed(world_size=2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="A6"):
        ds.init_distributed()
