"""CLI launcher (counterpart of ``deepspeed_tpu/launcher/``; reference:
deepspeed/launcher/)."""

from deepspeed_tpu_torch.launcher.runner import (
    build_launch_cmd,
    build_multinode_cmds,
    decode_world_info,
    encode_world_info,
    fetch_hostfile,
    parse_inclusion_exclusion,
)

__all__ = [
    "build_launch_cmd", "build_multinode_cmds", "decode_world_info",
    "encode_world_info", "fetch_hostfile", "parse_inclusion_exclusion",
]
