"""HuggingFace checkpoint ingestion for the families the port's FastGen
serves (counterpart of ``deepspeed_tpu/checkpoint/hf_loader.py``).

A NAME MAP per architecture rewrites each HF tensor name to a path in the
JAX package's param tree plus a layout transform: torch ``nn.Linear``
stores ``[out, in]`` and the serving tree holds ``[K, N]`` (``[in, out]``,
the layout ``checkpoint.params_from_jax`` documents and the int8 matmul
reads), so projections are transposed; Mixtral's per-expert tensors are
STACKED onto a leading expert axis (``[E, K, N]``, the grouped GEMM's
layout), one layer's experts at a time.

Families: llama / mistral / internlm (``_llama_rules``) and mixtral
(``_mixtral_rules``).  The others of the JAX package (gpt2, opt, falcon,
bloom, gptj, gpt_neox, bert) raise ``NotImplementedError`` naming ROADMAP
A9; tensor-parallel landing (``mesh``) raises naming A6.

Layouts: ``model.safetensors``, sharded ``model.safetensors.index.json``,
and ``pytorch_model.bin`` (``torch.load(weights_only=True)``, one file or a
``pytorch_model.bin.index.json``).  The safetensors format is read by this
module's own code, since the port may not rely on the ``safetensors``
package: an 8-byte little-endian header length, a JSON header of ``{name:
{"dtype", "shape", "data_offsets"}}``, then the raw little-endian bytes,
memory-mapped; BF16 is read as uint16 and viewed as ``torch.bfloat16``.
:func:`save_safetensors` writes the same format.  Each tensor goes to the
device as it is read, is cast to ``dtype`` there and is transposed there.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device

__all__ = ["load_hf_checkpoint", "config_from_hf", "hf_config",
           "iter_checkpoint_tensors", "read_safetensors", "save_safetensors",
           "HFLoadError"]


class HFLoadError(RuntimeError):
    pass


# --------------------------------------------------------------------- #
# The safetensors format
# --------------------------------------------------------------------- #
#: safetensors dtype name -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_ST_NAMES = {t: n for n, (_, t) in _ST_DTYPES.items()}


def _st_header(path: str) -> Tuple[Dict[str, Any], int]:
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(name, CPU tensor)`` for every tensor of a ``.safetensors``
    file, in file order; each tensor is a view of the memory-mapped file
    (read-only: copy it before writing)."""
    header, start = _st_header(path)
    if not header:
        return
    data = np.memmap(path, dtype=np.uint8, mode="r")
    for name, meta in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        if meta["dtype"] not in _ST_DTYPES:
            raise HFLoadError(f"{path}: tensor {name} has dtype "
                              f"{meta['dtype']}, which is not read here")
        np_dt, t_dt = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        arr = data[start + lo:start + hi].view(np_dt).reshape(meta["shape"])
        with warnings.catch_warnings():
            # a read-only map: the loader copies each tensor off it
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
        yield name, (t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t)


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device) as one ``.safetensors`` file."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        if t.dtype not in _ST_NAMES:
            raise HFLoadError(f"cannot write {name} of dtype {t.dtype}")
        raw = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
               ).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)          # the data starts on 8 bytes
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _read_torch_bin(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    yield from sd.items()


def iter_checkpoint_tensors(model_path: str
                            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(hf_name, CPU tensor)`` over every tensor in the checkpoint
    directory, resolving sharded indexes."""
    st = os.path.join(model_path, "model.safetensors")
    idx = os.path.join(model_path, "model.safetensors.index.json")
    bin_ = os.path.join(model_path, "pytorch_model.bin")
    bin_idx = os.path.join(model_path, "pytorch_model.bin.index.json")
    if os.path.exists(idx) or os.path.exists(bin_idx):
        index = idx if os.path.exists(idx) else bin_idx
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        read = read_safetensors if index == idx else _read_torch_bin
        for fn in sorted(set(weight_map.values())):
            yield from read(os.path.join(model_path, fn))
    elif os.path.exists(st):
        yield from read_safetensors(st)
    elif os.path.exists(bin_):
        yield from _read_torch_bin(bin_)
    else:
        raise HFLoadError(
            f"no model.safetensors(.index.json) or pytorch_model.bin "
            f"under {model_path}")


# --------------------------------------------------------------------- #
# Architecture name maps: (regex, function) where the function receives the
# match and returns (path_tuple, transform) -- "t" = transpose, None = as
# is, ("stack", expert) = stack onto the leading expert axis.
# --------------------------------------------------------------------- #
Rule = Tuple[str, Callable[[re.Match], Tuple[Any, Any]]]


def _llama_rules() -> List[Rule]:
    return [
        (r"^model\.embed_tokens\.weight$",
         lambda m: (("model", "embed_tokens", "embedding"), None)),
        (r"^model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight$",
         lambda m: (("model", f"layers_{m.group(1)}", "self_attn",
                     f"{m.group(2)}_proj", "kernel"), "t")),
        (r"^model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight$",
         lambda m: (("model", f"layers_{m.group(1)}", "mlp",
                     f"{m.group(2)}_proj", "kernel"), "t")),
        (r"^model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)"
         r"\.weight$",
         lambda m: (("model", f"layers_{m.group(1)}", m.group(2), "scale"),
                    None)),
        (r"^model\.norm\.weight$", lambda m: (("model", "norm", "scale"),
                                              None)),
        (r"^lm_head\.weight$", lambda m: (("lm_head", "kernel"), "t")),
        (r".*rotary_emb\.inv_freq$", lambda m: (None, None)),  # recomputed
    ]


def _mixtral_rules() -> List[Rule]:
    # the Mixtral tree is flat (no "model" level) and the MoE block is
    # moe/layer.py MoE -> deepspeed_moe -> {gate/wg, experts/w_*}
    hf2us = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}
    return [
        (r"^model\.embed_tokens\.weight$",
         lambda m: (("embed_tokens", "embedding"), None)),
        (r"^model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight$",
         lambda m: ((f"layers_{m.group(1)}", "self_attn",
                     f"{m.group(2)}_proj", "kernel"), "t")),
        (r"^model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight$",
         lambda m: ((f"layers_{m.group(1)}", "block_sparse_moe",
                     "deepspeed_moe", "gate", "wg", "kernel"), "t")),
        (r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\."
         r"(w1|w2|w3)\.weight$",
         lambda m: ((f"layers_{m.group(1)}", "block_sparse_moe",
                     "deepspeed_moe", "experts", hf2us[m.group(3)]),
                    ("stack", int(m.group(2))))),
        (r"^model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)"
         r"\.weight$",
         lambda m: ((f"layers_{m.group(1)}", m.group(2), "scale"), None)),
        (r"^model\.norm\.weight$", lambda m: (("norm", "scale"), None)),
        (r"^lm_head\.weight$", lambda m: (("lm_head", "kernel"), "t")),
    ]


_ARCH_RULES: Dict[str, Callable[[], List[Rule]]] = {
    "llama": _llama_rules,
    "mistral": _llama_rules,     # same architecture/serialization
    "internlm": _llama_rules,
    "mixtral": _mixtral_rules,
}
#: families the JAX package loads that the port's FastGen does not serve
_UNPORTED = ("gpt2", "opt", "falcon", "bloom", "gptj", "gpt_neox", "gptneox",
             "bert")


def _check_arch(arch: str) -> None:
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"loading {arch!r} checkpoints is not ported to "
            f"deepspeed_tpu_torch yet (ROADMAP A9); the port serves "
            f"{sorted(_ARCH_RULES)}")
    if arch not in _ARCH_RULES:
        raise HFLoadError(f"no HF name map for architecture {arch!r} "
                          f"(have: {sorted(_ARCH_RULES)})")


# --------------------------------------------------------------------- #
# Config translation
# --------------------------------------------------------------------- #
def hf_config(model_path: str) -> Dict[str, Any]:
    with open(os.path.join(model_path, "config.json")) as f:
        return json.load(f)


def config_from_hf(model_path: str, dtype: Any = None):
    """Build the matching port model config from a HF ``config.json``.
    Returns ``(architecture, config)``."""
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    cfg = hf_config(model_path)
    arch = cfg.get("model_type", "").lower()
    _check_arch(arch)
    common = dict(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        max_position_embeddings=cfg["max_position_embeddings"],
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        dtype=dtype if dtype is not None else torch.bfloat16)
    if arch == "mixtral":
        return arch, MixtralConfig(
            **common, num_local_experts=cfg.get("num_local_experts", 8),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2))
    return arch, LlamaConfig(
        **common, tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=cfg.get("sliding_window"))


# --------------------------------------------------------------------- #
# Loader
# --------------------------------------------------------------------- #
def load_hf_checkpoint(model_path: str, architecture: Optional[str] = None,
                       dtype: Any = None, mesh: Any = None,
                       strict: bool = True, device=None) -> Dict[str, Any]:
    """Load a HF checkpoint directory into the JAX package's param tree of
    torch tensors on ``device`` (default CUDA).

    ``architecture`` defaults to config.json's ``model_type``.  ``dtype``
    casts every tensor (e.g. ``torch.bfloat16`` for serving); None keeps
    the stored dtype.  ``strict`` raises on unmapped tensor names instead
    of skipping them.
    """
    if mesh is not None:
        raise NotImplementedError(
            "pre-sharded landing (mesh=) needs tensor parallelism, which is "
            "not ported to deepspeed_tpu_torch yet (ROADMAP A6)")
    dev = resolve_device(device)
    try:
        file_cfg = hf_config(model_path)
    except FileNotFoundError:
        # config.json is optional when architecture= is given explicitly
        file_cfg = {}
    if architecture is None:
        architecture = file_cfg.get("model_type", "")
    arch = architecture.lower()
    _check_arch(arch)
    rule_list = [(re.compile(p), fn) for p, fn in _ARCH_RULES[arch]()]

    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    # a leaf's expert stack is flushed the moment its last expert arrives,
    # so at most one layer's expert set waits on the device
    n_experts = file_cfg.get("num_local_experts") or \
        file_cfg.get("num_experts")

    def land(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        # always a copy: nothing keeps a view of the file's memory map
        t = t.to(dev, dtype=dtype or t.dtype, copy=True)
        return t.t().contiguous() if transpose else t

    def place(path, t):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t

    def flush_stack(path):
        parts = stacks.pop(path)
        n = max(parts) + 1
        if set(parts) != set(range(n)):
            raise HFLoadError(
                f"missing expert shards for {'/'.join(path)}: "
                f"have {sorted(parts)}")
        place(path, torch.stack([parts[i] for i in range(n)]))

    unmapped = []
    for name, tensor in iter_checkpoint_tensors(model_path):
        for pat, fn in rule_list:
            m = pat.match(name)
            if m is None:
                continue
            path, tf = fn(m)
            if path is None:            # deliberately skipped tensor
                break
            if isinstance(tf, tuple) and tf[0] == "stack":
                stacks.setdefault(path, {})[tf[1]] = land(tensor, True)
                if n_experts and len(stacks[path]) == n_experts:
                    flush_stack(path)
            else:
                place(path, land(tensor, tf == "t"))
            break
        else:
            unmapped.append(name)
    if unmapped and strict:
        raise HFLoadError(
            f"unmapped tensors for {arch}: {unmapped[:8]}"
            + (f" (+{len(unmapped) - 8} more)" if len(unmapped) > 8 else ""))
    for path in list(stacks):
        flush_stack(path)
    return tree
