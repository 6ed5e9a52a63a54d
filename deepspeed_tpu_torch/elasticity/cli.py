"""``ds_elastic_torch`` console entry (counterpart of
``deepspeed_tpu/elasticity/cli.py``; reference ``bin/ds_elastic``): inspect
a config's elasticity block and, given a world size, the resolved batch
configuration."""

from __future__ import annotations

import argparse
import json
import sys


def main(args=None) -> int:
    parser = argparse.ArgumentParser(
        description="Analyze a DeepSpeed elasticity config")
    parser.add_argument("-c", "--config", required=True,
                        help="DeepSpeed config json")
    parser.add_argument("-w", "--world-size", type=int, default=0,
                        help="Intended/current world size")
    ns = parser.parse_args(args)

    from deepspeed_tpu_torch.elasticity import compute_elastic_config
    from deepspeed_tpu_torch.version import __version__

    with open(ns.config) as f:
        ds_config = json.load(f)
    if "elasticity" not in ds_config:
        print("no 'elasticity' block in config", file=sys.stderr)
        return 1
    print("-" * 42)
    print("Elasticity config:")
    print("-" * 42)
    print(json.dumps(ds_config["elasticity"], indent=4, sort_keys=True))

    version = __version__
    if ns.world_size > 0:
        batch, valid_world_sizes, micro = compute_elastic_config(
            ds_config=ds_config, target_deepspeed_version=version,
            world_size=ns.world_size, return_microbatch=True)
        print(f"\nWith world size {ns.world_size}:")
        print(f"  final batch size ..... {batch}")
        print(f"  micro batch size ..... {micro}")
    else:
        batch, valid_world_sizes = compute_elastic_config(
            ds_config=ds_config, target_deepspeed_version=version)
        print(f"\n  final batch size ..... {batch}")
        print(f"  valid world sizes .... {sorted(valid_world_sizes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
