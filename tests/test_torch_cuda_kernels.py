"""The port's CUDA kernels against their plain PyTorch versions on a GPU, in
bf16 (bar 3e-2, the reference's on-chip tolerance).  Every test here is
marked ``cuda`` and skips where ``torch.cuda.is_available()`` is false.
The file imports neither JAX nor ``deepspeed_tpu``, so on a GPU machine
without the JAX package's dependencies it runs as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama)
from deepspeed_tpu_torch.models import LlamaConfig
from deepspeed_tpu_torch.ops import quantized_matmul as tqm
from torch_port_common import cuda_device  # noqa: F401  (fixture)

TOL = 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 512, 4096), (8, 4096, 11008),
                                   (5, 1024, 4112), (70, 1024, 4112),
                                   (512, 4096, 4096)])
def test_quantized_matmul_kernel(cuda_device, m, k, n):
    """Skinny path (M <= 8) and tiled path, ragged N and M edges."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    rec = {"q": torch.randint(-127, 128, (k, n), generator=gen,
                              device=cuda_device, dtype=torch.int8),
           "scale": torch.full((16,), 1.0 / (73.3 * k ** 0.5),
                               device=cuda_device)}
    before = tqm.LAUNCHES["quantized_matmul"]
    got = tqm.quantized_matmul(x, rec)
    assert tqm.LAUNCHES["quantized_matmul"] == before + 1
    want = tqm.quantized_matmul_plain(x, rec)
    assert (got.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attention_kernels(cuda_device, head_dim, window):
    """Both kernels with GQA (4 query heads over 2 KV heads), a block edge,
    a pad row (position -1 -> zeros) and two slots sharing a block."""
    bs, h, hkv, slots, width = 128, 4, 2, 5, 4
    rng = np.random.default_rng(head_dim)
    nb = slots * width + 1

    def dev(a, dtype=torch.bfloat16):
        return torch.from_numpy(np.asarray(a)).to(cuda_device, dtype)

    kp = dev(rng.standard_normal((nb * bs, hkv, head_dim)))
    vp = dev(rng.standard_normal((nb * bs, hkv, head_dim)))
    tables = (rng.permutation(slots * width) + 1).reshape(slots, width)
    tables[1, 0] = tables[0, 0]
    tb = dev(tables, torch.int32)
    for name, slot, pos in (
            ("paged_decode_attention", [0, 1, 2, 3, 4],
             [bs - 1, bs, -1, 2 * bs + 5, 450]),
            ("paged_attention", [0, 0, 1, 3, 0], [0, 200, 130, 300, -1])):
        q = dev(rng.standard_normal((len(pos), h, head_dim)))
        ts, tp = dev(slot, torch.int32), dev(pos, torch.int32)
        before = tbf.LAUNCHES[name]
        got = getattr(tbf, name)(q, kp, vp, tb, ts, tp, block_size=bs,
                                 window=window)
        assert tbf.LAUNCHES[name] == before + 1
        want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp,
                                         block_size=bs, window=window)
        assert (got.float() - want.float()).abs().max().item() <= TOL
        pad = pos.index(-1)
        assert got[pad].abs().max().item() == 0.0


@pytest.mark.cuda
def test_engine_kernels_match_plain_paths(cuda_device):
    """A small int8 Llama (head_dim 64, GQA) served in bf16 through the
    kernels and through the plain paths on the same card."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=384,
                           num_attention_heads=4, num_key_value_heads=2,
                           dtype=torch.bfloat16)
    params = random_int8_llama_params(cfg, groups=4, seed=1,
                                      device=cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 40)]
    logits = {}
    for use_kernels in (True, False):
        eng = InferenceEngineV2(
            RaggedLlama(cfg, 16, use_kernels=use_kernels), params,
            RaggedInferenceEngineConfig.from_dict({
                "state_manager": {"max_ragged_batch_size": 64,
                                  "max_ragged_sequence_count": 4,
                                  "max_context": 96},
                "kv_cache": {"block_size": 16}}))
        before = dict(tbf.LAUNCHES)
        first = eng.put([0, 1], prompts)
        eng.decode_loop([0, 1], [int(first[u].argmax()) for u in (0, 1)], 4)
        launched = {k: tbf.LAUNCHES[k] - before[k] for k in before}
        assert all(launched.values()) == use_kernels
        logits[use_kernels] = np.stack([first[0], first[1]])
    scale = np.abs(logits[False]).max()
    assert np.abs(logits[True] - logits[False]).max() / scale <= TOL
