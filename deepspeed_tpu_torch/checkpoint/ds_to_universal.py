"""Universal checkpoint converter (counterpart of
``deepspeed_tpu/checkpoint/ds_to_universal.py``; reference:
checkpoint/ds_to_universal.py:286 ``main`` — zero shards -> per-parameter
fp32 arrays -> reload under any topology; loader universal_checkpoint.py:12
``load_hp_checkpoint_state``).

The universal layout is a materialised per-parameter view of a sharded
checkpoint, the reference's ``<out>/zero/<param>/fp32.*`` tree::

    <out>/zero/<param_path>/fp32.npy          # full fp32 master weight
    <out>/zero/<param_path>/<moment>.npy      # optimizer moments (m, v, ...)
    <out>/universal_meta.json                 # scalars + source tag

``param_path`` is the Flax path (``model/layers_0/mlp/up_proj/kernel``), so
the JAX package's converter and this one write the same tree from the same
checkpoint, and ``load_universal_into_engine`` places it into the port's
engine through the same name mapping as a checkpoint load.

Run as ``python -m deepspeed_tpu_torch.checkpoint.ds_to_universal
--input_folder CKPT --output_folder OUT [--tag TAG]``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.checkpoint import sharded
from deepspeed_tpu_torch.utils.logging import logger


def _resolve_tag_dir(ckpt_dir: str, tag: Optional[str]) -> str:
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest")
        if not os.path.exists(latest):
            raise FileNotFoundError(f"no 'latest' file in {ckpt_dir}")
        with open(latest) as f:
            tag = f.read().strip()
    path = os.path.join(ckpt_dir, str(tag))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint dir {path} not found")
    return path


def convert(ckpt_dir: str, out_dir: str, tag: Optional[str] = None) -> str:
    """Sharded checkpoint -> universal per-param directory tree."""
    src = _resolve_tag_dir(ckpt_dir, tag)
    info = sharded.read_index(src)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for leaf, rec in info["leaves"].items():
        # leaf paths look like master/<param>, opt/<moment>/<param>,
        # acc_grads/<param>
        parts = leaf.split("/")
        if parts[0] == "master":
            param, fname = "/".join(parts[1:]), "fp32"
        elif parts[0] == "opt":
            param, fname = "/".join(parts[2:]), parts[1]
        else:
            continue  # grads are transient; universal keeps weights+moments
        d = os.path.join(out_dir, "zero", param)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{fname}.npy"),
                sharded.assemble_leaf(src, rec))
        n += 1
    meta = {"source": src,
            "scalars": {k: v.tolist() for k, v in info["scalars"].items()}}
    with open(os.path.join(out_dir, "universal_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logger.info(f"ds_to_universal: wrote {n} arrays to {out_dir}")
    return out_dir


def load_universal_into_engine(engine, universal_dir: str,
                               load_optimizer_states: bool = True) -> None:
    """Load a universal checkpoint into the port's engine, in place on its
    device: the masters, the optimizer moments and the scalars."""
    from deepspeed_tpu_torch.checkpoint.engine import (engine_state_layout,
                                                       place_flat,
                                                       refresh_params,
                                                       set_engine_scalars)

    zero_dir = os.path.join(universal_dir, "zero")

    def read(fname):
        return {path: np.load(os.path.join(zero_dir, path, f"{fname}.npy"))
                for path, _ in engine_state_layout(engine)}

    place_flat(engine, engine.master, read("fp32"))
    if load_optimizer_states:
        for k, v in engine.opt_state.items():
            place_flat(engine, v, read(k))
    meta_file = os.path.join(universal_dir, "universal_meta.json")
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            set_engine_scalars(engine, json.load(f).get("scalars", {}))
    refresh_params(engine)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a sharded checkpoint to the universal "
                    "per-parameter format")
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert(args.input_folder, args.output_folder, args.tag)


if __name__ == "__main__":
    main()
