"""Consolidate a sharded checkpoint into full fp32 weights (counterpart of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``; reference:
deepspeed/utils/zero_to_fp32.py — the offline tool users run to get a plain
state dict out of ZeRO shard files).

No engine or device needed: reads the per-process shard files and
reassembles each master weight at its global shape, one leaf at a time.
The names are the checkpoint's Flax paths; ``load_state_dict_from_zero_
checkpoint`` turns them into a port model's ``state_dict``.

Run as ``python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 CKPT_DIR
OUT.npz [--tag TAG]``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from deepspeed_tpu_torch.checkpoint import sharded
from deepspeed_tpu_torch.checkpoint.ds_to_universal import _resolve_tag_dir
from deepspeed_tpu_torch.utils.logging import logger


def get_fp32_state_dict_from_zero_checkpoint(
        ckpt_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """reference zero_to_fp32.py:get_fp32_state_dict_from_zero_checkpoint:
    ``{flax path: fp32 array}`` of the master weights."""
    src = _resolve_tag_dir(ckpt_dir, tag)
    info = sharded.read_index(src)
    out: Dict[str, np.ndarray] = {}
    for leaf, rec in info["leaves"].items():
        if not leaf.startswith("master/"):
            continue
        out[leaf[len("master/"):]] = sharded.assemble_leaf(src, rec)
    if not out:
        raise ValueError(f"no master weights found under {src}")
    return out


def convert_zero_checkpoint_to_fp32_state_dict(
        ckpt_dir: str, output_file: str, tag: Optional[str] = None) -> str:
    """reference zero_to_fp32.py:convert_zero_checkpoint_to_fp32_state_dict
    — writes a single consolidated ``.npz``."""
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    np.savez(output_file, **sd)
    total = sum(int(np.prod(v.shape)) for v in sd.values())
    logger.info(f"zero_to_fp32: wrote {len(sd)} tensors "
                f"({total/1e6:.2f}M params) to {output_file}")
    return output_file


def load_state_dict_from_zero_checkpoint(model, ckpt_dir,
                                         tag: Optional[str] = None):
    """reference zero_to_fp32.py:load_state_dict_from_zero_checkpoint:
    load the checkpoint's fp32 master weights into the port ``model``
    (through ``checkpoint/jax_params.py``'s mapping, onto the model's
    device and dtype) and return it."""
    import torch

    from deepspeed_tpu_torch.checkpoint.engine import flax_layout

    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    names = [n for n, _ in model.named_parameters()]
    current = dict(model.named_parameters())
    state = {}
    for name, (path, tr) in zip(names, flax_layout(model, names)):
        t = torch.from_numpy(np.ascontiguousarray(sd[path]))
        state[name] = (t.t() if tr else t).to(current[name].device,
                                               current[name].dtype)
    model.load_state_dict(state, strict=False)
    return model


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Extract consolidated fp32 weights from a ZeRO "
                    "checkpoint")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, args.tag)


if __name__ == "__main__":
    main()
