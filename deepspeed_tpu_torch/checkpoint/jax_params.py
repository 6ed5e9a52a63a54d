"""Weights carried across from the JAX package, and random int8 weights.

:func:`params_from_jax` takes a JAX param tree (ragged Llama, Mixtral) —
nested dicts of numpy arrays (``np.asarray`` of a JAX array is one) — and
returns the same tree of torch tensors.  Every weight keeps the JAX
package's ``[K, N]`` (``[in, out]``) layout: an int8 record
``{"q": int8 [K, N], "scale": fp32 [G]}`` is exactly what the int8 matmul
kernel reads, and a plain projection kernel is stored ``[K, N]`` too, NOT
transposed to ``nn.Linear``'s ``[out, in]`` (the forward computes
``x @ w``).

:func:`random_int8_llama_params` is the counterpart of
``bench_serving.py:_random_int8_llama_params``: the same tree with every
matmul weight an int8 record, drawn on the device from a seeded
``torch.Generator`` (its numbers differ from ``jax.random``'s).

:func:`random_llama_params` makes the same tree with bf16 (``cfg.dtype``)
weights, the checkpoint that ``WeightQuantization.model_quantize`` turns
into int8 records.

:func:`random_mixtral_params` makes the flat ``MixtralForCausalLM`` tree
of ``ragged_mixtral.py`` with bf16 (``cfg.dtype``) weights and an fp32
router, one tensor at a time on the device from a ``torch.Generator``: a
full-width Mixtral-8x7B layer holds 2.8 GB of experts, and no weight ever
passes through the host.

:func:`llama_state_dict_from_flax` turns the Flax *training* param tree of
``LlamaForCausalLM`` (fp32 ``[in, out]`` Dense kernels,
``embed_tokens/embedding``, norm ``scale``) into the ``state_dict`` of the
port's ``LlamaForCausalLM``: each Dense kernel is transposed to
``nn.Linear``'s ``[out, in]`` (the transform ``checkpoint/hf_loader.py:9``
documents), ``layers_{i}`` becomes ``layers.{i}``.
:func:`flax_params_from_llama_state_dict` is its inverse.  The same mapping
serves the training ``MixtralForCausalLM``
(:func:`mixtral_state_dict_from_flax`: ``layers_{i}/block_sparse_moe/
deepspeed_moe/gate/wg/kernel`` becomes ``layers.{i}.block_sparse_moe.
deepspeed_moe.gate.wg.weight``, transposed; the stacked expert weights
``experts/w_gate|w_up|w_down`` keep their ``[E, K, N]`` layout, which the
grouped GEMM reads) and a lone ``MoE`` subtree
(:func:`moe_state_dict_from_flax`, with the residual MoE's Dense kernels
and ``coefficient/bias``), each with its inverse.

:func:`gpt2_state_dict_from_flax` does the same for ``GPT2LMHeadModel``
(``h_{i}`` becomes ``h.{i}``, Dense kernels are transposed, ``wte`` /
``wpe`` ``embedding`` becomes ``weight``, a LayerNorm's ``scale`` becomes
its ``weight``, biases stay), with :func:`flax_params_from_gpt2_state_dict`
its inverse.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.mixtral import MixtralConfig


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":         # ml_dtypes bf16: no torch twin
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """The JAX param tree as torch tensors on ``device`` (default CUDA),
    same nesting, same dtypes, same ``[K, N]`` layouts."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


def random_int8_llama_params(cfg: LlamaConfig, groups: int = 16,
                             seed: int = 0, device=None) -> Any:
    """Random Llama params with every matmul weight an int8 ``{"q",
    "scale"}`` record, made directly on ``device`` — the full-precision
    tree never exists.  Scales target the usual 1/sqrt(fan_in) weight
    magnitude so logits stay finite."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    kv = cfg.num_key_value_heads * cfg.head_dim

    def rec(k_dim, n_dim):
        q = torch.randint(-127, 128, (k_dim, n_dim), generator=gen,
                          dtype=torch.int8, device=dev)
        # int8 uniform(-127,127) std ~73.3; scale for weight std 1/sqrt(K)
        scale = torch.full((groups,), 1.0 / (73.3 * math.sqrt(k_dim)),
                           dtype=torch.float32, device=dev)
        return {"kernel": {"q": q, "scale": scale}}

    def ones():
        return {"scale": torch.ones((H,), dtype=torch.float32, device=dev)}

    model = {}
    for i in range(L):
        model[f"layers_{i}"] = {
            "self_attn": {"q_proj": rec(H, H), "k_proj": rec(H, kv),
                          "v_proj": rec(H, kv), "o_proj": rec(H, H)},
            "mlp": {"gate_proj": rec(H, I), "up_proj": rec(H, I),
                    "down_proj": rec(I, H)},
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
        }
    emb = torch.randn((V, H), generator=gen, dtype=cfg.dtype,
                      device=dev) * 0.02
    model["embed_tokens"] = {"embedding": emb}
    model["norm"] = ones()
    return {"model": model, "lm_head": rec(H, V)}


def random_llama_params(cfg: LlamaConfig, device=None,
                        generator: Optional[torch.Generator] = None) -> Any:
    """Random Llama params in the JAX package's ragged tree, made directly
    on ``device`` (default CUDA) from ``generator`` (default: seeded with 0
    on that device): every projection ``[K, N]`` in ``cfg.dtype`` with std
    1/sqrt(K), the embedding with std 0.02, RMSNorm scales of ones in fp32.
    The full-precision tree a checkpoint holds, before any quantization."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    kv = cfg.num_key_value_heads * cfg.head_dim

    def w(k_dim, n_dim, std=None):
        t = torch.randn((k_dim, n_dim), generator=gen, dtype=cfg.dtype,
                        device=dev)
        return t.mul_(std if std is not None else 1.0 / math.sqrt(k_dim))

    def ones():
        return {"scale": torch.ones((H,), dtype=torch.float32, device=dev)}

    model = {"embed_tokens": {"embedding": w(V, H, std=0.02)}}
    for i in range(L):
        model[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(H, H)},
                          "k_proj": {"kernel": w(H, kv)},
                          "v_proj": {"kernel": w(H, kv)},
                          "o_proj": {"kernel": w(H, H)}},
            "mlp": {"gate_proj": {"kernel": w(H, I)},
                    "up_proj": {"kernel": w(H, I)},
                    "down_proj": {"kernel": w(I, H)}},
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
        }
    model["norm"] = ones()
    return {"model": model, "lm_head": {"kernel": w(H, V)}}


def random_mixtral_params(cfg: MixtralConfig, device=None,
                          generator: Optional[torch.Generator] = None) -> Any:
    """Random Mixtral params in the JAX package's flat tree, made directly
    on ``device`` (default CUDA) from ``generator`` (default: seeded with
    0 on that device): every projection and expert weight ``[K, N]`` (or
    ``[E, K, N]``) in ``cfg.dtype`` with std 1/sqrt(K), the router ``wg``
    ``[H, E]`` in fp32, RMSNorm scales of ones."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    H, I, V, L, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                     cfg.num_hidden_layers, cfg.num_local_experts)
    kv = cfg.num_key_value_heads * cfg.head_dim

    def w(*shape, dtype=cfg.dtype, std=None):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        return t.mul_(std if std is not None else 1.0 / math.sqrt(shape[-2]))

    def ones():
        return {"scale": torch.ones((H,), dtype=torch.float32, device=dev)}

    params = {"embed_tokens": {"embedding": w(V, H, std=0.02)}}
    for i in range(L):
        params[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(H, H)},
                          "k_proj": {"kernel": w(H, kv)},
                          "v_proj": {"kernel": w(H, kv)},
                          "o_proj": {"kernel": w(H, H)}},
            "block_sparse_moe": {"deepspeed_moe": {
                "gate": {"wg": {"kernel": w(H, E, dtype=torch.float32)}},
                "experts": {"w_gate": w(E, H, I), "w_up": w(E, H, I),
                            "w_down": w(E, I, H)}}},
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
        }
    params["norm"] = ones()
    params["lm_head"] = {"kernel": w(H, V)}
    return params


def _flat(tree, prefix=()):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _flat(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def llama_state_dict_from_flax(params: Any,
                               device=None) -> Dict[str, torch.Tensor]:
    """The Flax params of ``LlamaForCausalLM``, ``MixtralForCausalLM`` or a
    lone ``MoE`` (``{"params": ...}`` or the bare tree, numpy leaves) as
    the port's ``state_dict`` on ``device`` (default CUDA): Dense
    ``kernel`` -> ``weight`` transposed, ``embedding`` -> ``weight``, every
    other leaf (norm ``scale``, ``bias``, stacked expert weights) as it
    is."""
    dev = resolve_device(device)
    params = params.get("params", params)
    out = {}
    for path, leaf in _flat(params):
        *mods, leaf_name = path
        name = ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", m)
                        for m in mods)
        t = _to_tensor(leaf, dev)
        if leaf_name == "kernel":
            out[f"{name}.weight"] = t.t().contiguous()
        elif leaf_name == "embedding":
            out[f"{name}.weight"] = t
        else:
            out[f"{name}.{leaf_name}"] = t
    return out


def flax_params_from_llama_state_dict(state_dict) -> Dict[str, Any]:
    """The inverse of :func:`llama_state_dict_from_flax` (for each of its
    models): a nested dict of fp32 numpy arrays in the Flax layout."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        *mods, leaf_name = name.split(".")
        mods = re.sub(r"layers\.(\d+)", r"layers_\1",
                      ".".join(mods)).split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf_name == "weight" and mods[-1] == "embed_tokens":
            leaf_name = "embedding"
        elif leaf_name == "weight":
            leaf_name, arr = "kernel", arr.T.copy()
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf_name] = arr
    return tree


#: the Flax <-> ``state_dict`` mapping is one rule for every model
mixtral_state_dict_from_flax = moe_state_dict_from_flax = \
    llama_state_dict_from_flax
flax_params_from_mixtral_state_dict = flax_params_from_moe_state_dict = \
    flax_params_from_llama_state_dict


def gpt2_state_dict_from_flax(params: Any,
                              device=None) -> Dict[str, torch.Tensor]:
    """The Flax params of ``GPT2LMHeadModel`` (``{"params": ...}`` or the
    bare tree, numpy leaves) as the port's ``state_dict`` on ``device``
    (default CUDA): Dense ``kernel`` -> ``weight`` transposed,
    ``embedding`` and LayerNorm ``scale`` -> ``weight``, ``bias`` as it
    is."""
    dev = resolve_device(device)
    params = params.get("params", params)
    out = {}
    for path, leaf in _flat(params):
        *mods, leaf_name = path
        name = ".".join(re.sub(r"^h_(\d+)$", r"h.\1", m) for m in mods)
        t = _to_tensor(leaf, dev)
        if leaf_name == "kernel":
            t = t.t().contiguous()
        out[f"{name}.{'bias' if leaf_name == 'bias' else 'weight'}"] = t
    return out


def flax_params_from_gpt2_state_dict(state_dict) -> Dict[str, Any]:
    """The inverse of :func:`gpt2_state_dict_from_flax`: a nested dict of
    fp32 numpy arrays in the Flax layout."""
    tree: Dict[str, Any] = {}
    for name, t in state_dict.items():
        *mods, leaf_name = name.split(".")
        mods = re.sub(r"(^|\.)h\.(\d+)", r"\1h_\2", ".".join(mods)).split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf_name == "weight" and mods[-1] in ("wte", "wpe"):
            leaf_name = "embedding"
        elif leaf_name == "weight" and mods[-1].startswith("ln_"):
            leaf_name = "scale"
        elif leaf_name == "weight":
            leaf_name, arr = "kernel", arr.T.copy()
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf_name] = arr
    return tree
