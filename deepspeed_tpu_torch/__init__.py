"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The port mirrors the JAX package's paths and names
(``deepspeed_tpu_torch/inference/v2/ragged/kv_cache.py`` is the counterpart
of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``).  It imports torch
and numpy only: never JAX and nothing of ``deepspeed_tpu``.  Every TPU
kernel on a ported path is a CUDA kernel under ``csrc/``, built with
``nvcc`` at first use; each has a plain PyTorch version beside it, which
runs only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
