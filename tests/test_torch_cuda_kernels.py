"""The port's CUDA kernels against their plain PyTorch versions on a GPU, in
bf16 (bar 3e-2 of the largest magnitude, the reference's on-chip
tolerance; flash attention, the int8, verify and tiled prefill paged
kernels, the grouped expert GEMM and the training path also 1e-2 in norm,
|got - want|_2 / |want|_2; the int8 quantizer bit for bit; Evoformer
attention 3e-2 / 1e-2 forward and 5e-2 in norm for its gradients;
block-sparse attention the same, and fp32 within 1e-4, its gradients
1e-4 of max(1, max |plain|)).  Every test here is
marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor ``deepspeed_tpu``, so on a GPU machine without the JAX package's
dependencies it runs as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as tbf
from deepspeed_tpu_torch.inference.v2.model_implementations import (
    RaggedLlama, RaggedMixtral)
from deepspeed_tpu_torch.models import LlamaConfig, MixtralConfig
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import evoformer_attn as tevo
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import grouped_gemm as tgg
from deepspeed_tpu_torch.ops import quantized_matmul as tqm
from deepspeed_tpu_torch.ops import quantizer as tqz
from torch_port_common import cuda_device  # noqa: F401  (fixture)
from torch_port_common import single_process_env  # noqa: F401 (autouse)

TOL = 3e-2
NORM_TOL = 1e-2
# the training path, kernels vs plain (chip_smoke.py phase 7 says why the
# gradients get a wider bar)
LOSS_TOL = 1e-3
LOGITS_TOL = 3e-2
GRAD_TOL = 5e-2
FP32_RATIO = 1.05


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


#: decode / verify layouts of long contexts, 5 units of 2 KV heads over a
#: 4096-key table (block size, query heads, table width): block 16
#: (cp.async gathers) and block 64 (TMA boxes, G = 8); contexts of ~2000
#: and ~4000 tokens, a one-tile context and a pad
_LONG_LAYOUTS = {"long-b16": (16, 4, 256), "long-b64-g8": (64, 16, 64)}
_LONG_POS = [2001, 10, -1, 4090, 3999]


def _check_long_decode(dev, head_dim, window, layout, int8):
    """The decode kernel at a long layout against the plain version: both
    bars, the pad unit exact zeros, one launch."""
    bs, h, width = _LONG_LAYOUTS[layout]
    rng = np.random.default_rng(head_dim + bs + int8)
    (kp, vp), scales, tb = _paged_inputs(rng, dev, bs, h, 2, head_dim, 5,
                                         width, int8)
    q = torch.from_numpy(rng.standard_normal((5, h, head_dim))).to(
        dev, torch.bfloat16)
    ts = torch.arange(5, dtype=torch.int32, device=dev)
    tp = torch.tensor(_LONG_POS, dtype=torch.int32, device=dev)
    key = "paged_decode_attention" + ("_int8" if int8 else "")
    before = tbf.LAUNCHES[key]
    got = tbf.paged_decode_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                                     window=window, **scales)
    torch.cuda.synchronize()
    assert tbf.LAUNCHES[key] == before + 1
    want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp, block_size=bs,
                                     window=window, **scales)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL
    assert got[_LONG_POS.index(-1)].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["served", *_LONG_LAYOUTS])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attention_kernels(cuda_device, head_dim, window, layout):
    """Both kernels with GQA (4 query heads over 2 KV heads), a block edge,
    a pad row (position -1 -> zeros) and two slots sharing a block; the
    decode kernel also at the long layouts."""
    if layout != "served":
        _check_long_decode(cuda_device, head_dim, window, layout, False)
        return
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


def _rel(got, want):
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)


def _norm_rel(got, want):
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


_BSHD = tuple(tfa.launch_key(k) for k in ("fwd", "bwd_dq", "bwd_dkv"))


def _launched_since(before):
    """The flash launches since ``before`` (a copy of LAUNCHES), by key,
    leaving out the keys that did not move."""
    return {n: c - before[n] for n, c in tfa.LAUNCHES.items()
            if c != before[n]}


def _flash_errors(b, sq, sk, h, hkv, d, causal, window, dtype):
    """The three kernels and their plain versions on the same random
    inputs: ``{output: (max-relative error, norm-relative error)}`` for
    o, lse, delta, dq, dk, dv."""
    gen = torch.Generator(device="cuda").manual_seed(sq + h + d)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    q, k, v, do = (randn(b, sq, h, d), randn(b, sk, hkv, d),
                   randn(b, sk, hkv, d), randn(b, sq, h, d))
    scale = d ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_attention_fwd(qs, k, v, causal, window)
    dq, delta = tfa.flash_attention_bwd_dq(qs, k, v, o, do, lse, scale,
                                           causal, window)
    dk, dv = tfa.flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal,
                                         window)
    assert _launched_since(before) == {n: 1 for n in _BSHD}
    po, plse = tfa.flash_attention_plain_fwd(qs, k, v, causal=causal,
                                             window=window)
    pdq, pdelta = tfa.flash_attention_plain_bwd_dq(
        qs, k, v, po, do, plse, scale=scale, causal=causal, window=window)
    pdk, pdv = tfa.flash_attention_plain_bwd_dkv(
        qs, k, v, do, plse, pdelta, causal=causal, window=window)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("o", "lse", "delta", "dq", "dk", "dv"),
                               (o, lse, delta, dq, dk, dv),
                               (po, plse, pdelta, pdq, pdk, pdv)):
        assert torch.isfinite(got.float()).all(), name
        errs[name] = (_rel(got, want), _norm_rel(got, want))
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window,dtype", [
    (8, 1024, 1024, 12, 12, 64, True, None, "bf16"),    # the bench model
    (2, 2048, 2048, 64, 8, 128, True, None, "bf16"),    # Llama-2-70B heads
    (2, 2048, 2048, 8, 8, 64, True, 256, "bf16"),       # sliding window
    (2, 512, 1024, 8, 8, 64, True, None, "bf16"),       # rectangular
    (1, 200, 200, 4, 2, 64, True, None, "bf16"),        # S % 64 != 0
    (1, 130, 300, 4, 2, 128, False, None, "bf16"),      # non-causal, ragged
    (2, 333, 333, 4, 1, 128, True, 77, "bf16"),         # window, GQA 4
    (8, 1024, 1024, 12, 12, 64, True, None, "fp16"),    # fp16 (fp16.enabled)
    (1, 200, 200, 4, 2, 64, True, None, "fp16"),
    (2, 333, 333, 4, 1, 128, True, 77, "fp16"),
    (1, 130, 300, 4, 2, 128, False, None, "fp16"),
    (2, 4096, 4096, 12, 12, 64, True, None, "bf16"),    # bench width, S 4096
    (3, 200, 200, 4, 2, 128, True, None, "bf16"),       # B > 1, TMA box past S
    (2, 1, 300, 4, 2, 128, True, None, "bf16"),         # Sq = 1
])
def test_flash_attention_kernels(cuda_device, b, sq, sk, h, hkv, d, causal,
                                 window, dtype):
    """Forward, dQ and dK/dV kernels against their plain versions on the
    same bf16 or fp16 inputs: o, lse, delta, dq, dk, dv each within 3e-2
    of the plain version's largest magnitude and within 1e-2 in norm."""
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[dtype]
    errs = _flash_errors(b, sq, sk, h, hkv, d, causal, window, dtype)
    for name, (rel, norm_rel) in errs.items():
        assert rel <= TOL and norm_rel <= NORM_TOL, (name, rel, norm_rel)


# Three faults planted in a copy of csrc/flash_attention.cu, each at the shape
# where it shows: (text, replacement, shape as _flash_errors takes it).
_PLANTED = {
    # one key too many at the window's edge (row_keys() serves the forward
    # and dQ): 257 keys a row where 256 are right
    "window_edge": (
        "if (sh.window > 0) lo = r + off - sh.window + 1;",
        "if (sh.window > 0) lo = r + off - sh.window;",
        (2, 2048, 2048, 8, 8, 64, True, 256)),
    # the forward's last q tile skips its last k tile (the diagonal one):
    # 64 rows of 1024 lose their nearest 64-128 keys
    "dropped_tile": (
        "int begin, end;                                 // the k tiles the "
        "block's rows see\n"
        "  k_tiles(sh, q0, min(q0 + kBlock, sh.sq), BK, begin, end);\n",
        "int begin, end;\n"
        "  k_tiles(sh, q0, min(q0 + kBlock, sh.sq), BK, begin, end);\n"
        "  if (q0 + kBlock >= sh.sq && end > begin) --end;\n",
        (8, 1024, 1024, 12, 12, 64, True, None)),
    # the dK/dV launch drops the last query head of each GQA group: at
    # Llama-2-70B's heads (groups of 8) dK and dV lose an eighth of their sum
    "dropped_group_head": (
        "  const int n = group * per_head;\n",
        "  const int n = (group - 1) * per_head;\n",
        (2, 2048, 2048, 64, 8, 128, True, None)),
}


@pytest.mark.cuda
def test_flash_norm_bar_catches_planted_faults(cuda_device, tmp_path,
                                               monkeypatch):
    """The norm bar of test_flash_attention_kernels sees faults that touch
    only some rows or some heads: each planted fault, built from a copy of
    the source in a temporary directory, puts some output above it."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    builds = {}
    for name, (old, new, _) in _PLANTED.items():
        assert src.count(old) == 1, name
        cu, so = tmp_path / f"{name}.cu", tmp_path / f"lib{name}.so"
        cu.write_text(src.replace(old, new))
        builds[name] = (subprocess.Popen(
            _build.nvcc_command(cu, so),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    for name, (proc, so) in builds.items():
        log = proc.communicate()[0].decode()
        assert proc.returncode == 0, log[-2000:]
        monkeypatch.setitem(_build._LIBS, "flash_attention",
                            ctypes.CDLL(str(so)))
        tfa._kernel.cache_clear()
        try:
            errs = _flash_errors(*_PLANTED[name][2], torch.bfloat16)
        finally:
            tfa._kernel.cache_clear()
        print(f"planted {name}: " + ", ".join(
            f"{k} max-rel {r:.3g} norm-rel {n:.3g}"
            for k, (r, n) in errs.items()))
        assert max(n for _, n in errs.values()) > NORM_TOL, (name, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (2, 2048, 64, 8, 128, None),        # Llama-2-70B heads, GQA 8
    (3, 333, 4, 2, 64, 77),             # window, tails, B > 1
])
def test_flash_kernels_are_bit_reproducible(cuda_device, b, s, h, hkv, d,
                                            window):
    """Two runs of the forward, dQ and dK/dV launches on the same inputs
    give the same bits: every sum runs in a fixed order (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + h)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda_device,
                               dtype=torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                                 (b, s, h, d)))
    scale = d ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    runs = []
    for _ in range(2):
        o, lse = tfa.flash_attention_fwd(qs, k, v, True, window)
        dq, delta = tfa.flash_attention_bwd_dq(qs, k, v, o, do, lse, scale,
                                               True, window)
        dk, dv = tfa.flash_attention_bwd_dkv(qs, k, v, do, lse, delta, True,
                                             window)
        runs.append((o, lse, delta, dq, dk, dv))
    torch.cuda.synchronize()
    for name, a, c in zip(("o", "lse", "delta", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, c), name


@pytest.mark.cuda
def test_flash_attention_autograd_launches_kernels(cuda_device):
    """``flash_attention`` on CUDA tensors: one launch of each kernel per
    forward + backward, gradients of every input; an unsupported head dim
    raises instead of taking the plain path."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((2, 96, h, 64), generator=gen, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for h in (4, 2, 2))
    before = dict(tfa.LAUNCHES)
    tfa.flash_attention(q, k, v).float().square().sum().backward()
    assert _launched_since(before) == {n: 1 for n in _BSHD}
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (q, k, v))
    bad = torch.zeros((1, 8, 2, 80), device=cuda_device,
                      dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(bad, bad, bad)


def _strided_flash_errors(b, s, h, hkv, d, window=None):
    """The three kernels on q, k and v as column views of one fused
    ``[B, S, (H + 2 Hkv) D]`` bf16 buffer (q pre-scaled, a copy as on the
    training path), against their plain versions on the same views and
    against the contiguous-mode kernels on ``.contiguous()`` copies:
    ``({output: (max-rel, norm-rel)}, {output: bit-equal})``."""
    gen = torch.Generator(device="cuda").manual_seed(s + h + d)
    buf = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (-1, d))
               for t in buf.split([h * d, hkv * d, hkv * d], dim=-1))
    do = torch.randn((b, s, h, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    scale = d ** -0.5
    qs = (q.float() * scale).to(q.dtype)

    def run(k_, v_, plain=False):
        if plain:
            o, lse = tfa.flash_attention_plain_fwd(qs, k_, v_, window=window)
            dq, delta = tfa.flash_attention_plain_bwd_dq(
                qs, k_, v_, o, do, lse, scale=scale, window=window)
            dk, dv = tfa.flash_attention_plain_bwd_dkv(
                qs, k_, v_, do, lse, delta, window=window)
        else:
            o, lse = tfa.flash_attention_fwd(qs, k_, v_, True, window,
                                             "folded")
            dq, delta = tfa.flash_attention_bwd_dq(qs, k_, v_, o, do, lse,
                                                   scale, True, window,
                                                   "folded")
            dk, dv = tfa.flash_attention_bwd_dkv(qs, k_, v_, do, lse, delta,
                                                 True, window, "folded")
        return dict(zip(("o", "lse", "delta", "dq", "dk", "dv"),
                        (o, lse, delta, dq, dk, dv)))

    assert not k.is_contiguous() and k.stride(1) == buf.shape[-1]
    before = dict(tfa.LAUNCHES)
    got = run(k, v)
    assert _launched_since(before) == {
        tfa.launch_key(n, "folded"): 1 for n in ("fwd", "bwd_dq", "bwd_dkv")}
    contiguous = run(k.contiguous(), v.contiguous())
    want = run(k, v, plain=True)
    torch.cuda.synchronize()
    errs = {n: (_rel(got[n], want[n]), _norm_rel(got[n], want[n]))
            for n in want}
    same = {n: torch.equal(got[n], contiguous[n]) for n in got}
    return errs, same


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (8, 1024, 12, 12, 64, None),    # GPT-2-125M: views of [8, 1024, 2304]
    (1, 1024, 64, 8, 128, None),    # Llama-2-70B heads, fused qkv_proj
    (1, 1024, 8, 8, 64, 256),       # sliding window
])
def test_strided_flash_kernels(cuda_device, b, s, h, hkv, d, window):
    """The strided mode (column views of one fused projection output)
    against the plain versions at phase 16's bars, and bit for bit equal
    to the contiguous mode on copies of the same views."""
    errs, same = _strided_flash_errors(b, s, h, hkv, d, window)
    for name, (rel, norm_rel) in errs.items():
        assert rel <= TOL and norm_rel <= NORM_TOL, (name, rel, norm_rel)
    assert all(same.values()), same


@pytest.mark.cuda
def test_flash_wrapper_raises_on_misaligned_rows(cuda_device):
    """A view whose offset is not a multiple of 8 elements, or whose row
    stride is not, cannot be read with 16-byte loads: the wrappers raise
    (and launch nothing)."""
    buf = torch.zeros((2, 64, 3 * 256 + 8), device=cuda_device,
                      dtype=torch.bfloat16)
    good = buf[..., :256].unflatten(-1, (4, 64))
    shifted = buf[..., 4:260].unflatten(-1, (4, 64))        # +8 bytes
    odd = torch.zeros((2, 64, 260), device=cuda_device,
                      dtype=torch.bfloat16)[..., :256].unflatten(-1, (4, 64))
    before = dict(tfa.LAUNCHES)
    for bad in (shifted, odd):
        with pytest.raises(ValueError, match="16 bytes"):
            tfa.flash_attention_fwd(good, bad, good)
        with pytest.raises(ValueError, match="16 bytes"):
            tfa.flash_attention_folded(good.flatten(2), bad.flatten(2),
                                       good.flatten(2), num_heads=4)
    assert _launched_since(before) == {}
    assert not tfa.flash_attention_folded_usable(
        good.flatten(2), shifted.flatten(2), good.flatten(2), 4, 4, True,
        None)


@pytest.mark.cuda
def test_strided_norm_bar_catches_planted_k_stride(cuda_device, tmp_path,
                                                   monkeypatch):
    """A copy of csrc/flash_attention.cu that reads k with q's row stride
    (the pre-scaled q is contiguous, k a view of the fused buffer) misses
    the norm bar of test_strided_flash_kernels."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    old = "Rows{strides[0], strides[1],"
    assert src.count(old) == 1
    cu, so = tmp_path / "k_stride.cu", tmp_path / "libk_stride.so"
    cu.write_text(src.replace(old, "Rows{strides[0], strides[0],"))
    proc = subprocess.run(_build.nvcc_command(cu, so), capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    monkeypatch.setitem(_build._LIBS, "flash_attention",
                        ctypes.CDLL(str(so)))
    tfa._kernel.cache_clear()
    try:
        errs, _ = _strided_flash_errors(8, 1024, 12, 12, 64)
    finally:
        tfa._kernel.cache_clear()
    print("planted k stride: " + ", ".join(
        f"{k} max-rel {r:.3g} norm-rel {n:.3g}" for k, (r, n) in errs.items()))
    assert max(n for _, n in errs.values()) > NORM_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["folded", "paired"])
def test_gpt2_layouts_launch_the_strided_kernels(cuda_device, layout):
    """GPT-2 at d = 64 under the folded and paired layouts: one launch of
    each flash kernel a layer, counted under the layout's own entry, and
    the same loss and c_attn gradient as the bshd layout bit for bit (one
    kernel family reads the same views)."""
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel

    ids = torch.randint(0, 256, (2, 128), device=cuda_device,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(3))
    out = {}
    for lay in ("bshd", layout):
        model = GPT2LMHeadModel(GPT2Config.tiny(
            hidden_size=256, num_attention_heads=4, attention_layout=lay),
            seed=2).to(torch.bfloat16)
        before = dict(tfa.LAUNCHES)
        loss = model(ids, ids)
        loss.backward()
        out[lay] = (loss.detach(), model.h[0].c_attn.weight.grad,
                    _launched_since(before))
    assert out[layout][2] == {tfa.launch_key(k, layout): 2
                              for k in ("fwd", "bwd_dq", "bwd_dkv")}
    assert out["bshd"][2] == {n: 2 for n in _BSHD}
    assert torch.equal(out["bshd"][0], out[layout][0])
    assert torch.equal(out["bshd"][1], out[layout][1])


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
        launched = {k: tbf.LAUNCHES[k] - before[k]
                    for k in ("paged_attention", "paged_decode_attention")}
        assert all(launched.values()) == use_kernels
        logits[use_kernels] = np.stack([first[0], first[1]])
    scale = np.abs(logits[False]).max()
    assert np.abs(logits[True] - logits[False]).max() / scale <= TOL


@pytest.mark.cuda
def test_training_engine_kernels_match_plain_path(cuda_device):
    """A 2-layer Llama (head_dim 64, GQA) trained 3 steps in bf16 through
    ``initialize`` on the card: the kernel path's losses, its logits
    before the first step and its first step's gradients of the q/k/v
    projections match the plain path's; set against the same model in
    fp32, they are no farther off than the plain path's; only the kernel
    path launches the flash kernels."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    geom = dict(hidden_size=256, intermediate_size=384,
                num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=512)
    ds = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "bf16": {"enabled": True}, "gradient_clipping": 1.0}
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(2, 200)).astype(np.int32))
    losses, logits, grads = {}, {}, {}
    for mode in ("kernel", "plain", "fp32"):
        fp32 = mode == "fp32"
        model = LlamaForCausalLM(
            LlamaConfig.tiny(**geom, dtype=torch.float32 if fp32
                             else torch.bfloat16),
            seed=1, use_kernels=mode == "kernel")
        names = [n for n, _ in model.named_parameters()]
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config={**ds, "bf16": {"enabled": not fp32}})
        with torch.no_grad():
            logits[mode] = engine.module(ids.cuda())
        before = dict(tfa.LAUNCHES)
        out = []
        for step in range(1 if fp32 else 3):
            loss = engine(ids, ids)
            engine.backward(loss)
            if step == 0:
                grads[mode] = {
                    n: g.clone() for n, g in zip(names, engine.acc_grads)
                    if n.split(".")[-2] in ("q_proj", "k_proj", "v_proj")}
            engine.step()
            out.append(float(loss.detach()))
        launched = {k: tfa.LAUNCHES[k] - before[k] for k in before}
        assert launched == {k: (6 if mode == "kernel" and k in _BSHD else 0)
                            for k in before}
        losses[mode] = np.array(out)
    assert np.isfinite(losses["kernel"]).all()
    loss_rel = (np.abs(losses["kernel"] - losses["plain"])
                / np.abs(losses["plain"])).max()
    assert loss_rel <= LOSS_TOL
    assert _norm_rel(logits["kernel"], logits["plain"]) <= LOGITS_TOL
    assert len(grads["plain"]) == 6
    for n, want in grads["plain"].items():
        assert _norm_rel(grads["kernel"][n], want) <= GRAD_TOL, n
    against_fp32 = [("logits", logits["kernel"], logits["plain"],
                     logits["fp32"])] + [
        (n, grads["kernel"][n], grads["plain"][n], ref)
        for n, ref in grads["fp32"].items()]
    for name, k, p, ref in against_fp32:
        print(f"{name} against fp32: kernel path {_norm_rel(k, ref):.4g}, "
              f"plain path {_norm_rel(p, ref):.4g}")
        assert _norm_rel(k, ref) <= FP32_RATIO * _norm_rel(p, ref), name


@pytest.mark.cuda
def test_llama_seed_gives_the_same_weights_on_every_device(cuda_device):
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    on_cpu = LlamaForCausalLM(cfg, seed=4, device="cpu").state_dict()
    on_gpu = LlamaForCausalLM(cfg, seed=4).state_dict()
    assert on_cpu.keys() == on_gpu.keys()
    for name, w in on_gpu.items():
        assert w.is_cuda, name
        assert torch.equal(w.cpu(), on_cpu[name]), name


def _paged_inputs(rng, dev, bs, h, hkv, d, slots, width, int8):
    """bf16 queries' pools (or int8 pools with their scales) over ``slots``
    tables of ``width`` scattered blocks; slots 0 and 1 share a block."""
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import quantize_kv

    nb = slots * width + 1
    pools = [torch.from_numpy(rng.standard_normal((nb * bs, hkv, d)).astype(
        np.float32)).to(dev) for _ in range(2)]
    scales = {}
    if int8:
        (kq, ks), (vq, vs) = (quantize_kv(p) for p in pools)
        pools, scales = [kq, vq], {"k_scale": ks, "v_scale": vs}
    else:
        pools = [p.to(torch.bfloat16) for p in pools]
    tables = (rng.permutation(slots * width) + 1).reshape(slots, width)
    tables[1, 0] = tables[0, 0]
    return pools, scales, torch.from_numpy(tables.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["served", *_LONG_LAYOUTS])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_paged_attention_int8_kernels(cuda_device, head_dim, window, layout):
    """The decode and generic kernels over an int8 pool with its scales:
    GQA, a block edge, a pad row (position -1 -> zeros), a shared block;
    the decode kernel also at the long layouts."""
    if layout != "served":
        _check_long_decode(cuda_device, head_dim, window, layout, True)
        return
    bs, h, hkv = 128, 4, 2
    rng = np.random.default_rng(head_dim + 1)
    (kp, vp), scales, tb = _paged_inputs(rng, cuda_device, bs, h, hkv,
                                         head_dim, 5, 4, True)
    for name, slot, pos in (
            ("paged_decode_attention", [0, 1, 2, 3, 4],
             [bs - 1, bs, -1, 2 * bs + 5, 450]),
            ("paged_attention", [0, 0, 1, 3, 0], [0, 200, 130, 300, -1])):
        q = torch.from_numpy(rng.standard_normal(
            (len(pos), h, head_dim))).to(cuda_device, torch.bfloat16)
        ts, tp = (torch.tensor(a, dtype=torch.int32, device=cuda_device)
                  for a in (slot, pos))
        before = dict(tbf.LAUNCHES)
        got = getattr(tbf, name)(q, kp, vp, tb, ts, tp, block_size=bs,
                                 window=window, **scales)
        assert tbf.LAUNCHES[name + "_int8"] == before[name + "_int8"] + 1
        assert tbf.LAUNCHES[name] == before[name]
        want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp,
                                         block_size=bs, window=window,
                                         **scales)
        assert (got.float() - want.float()).abs().max().item() <= TOL
        assert _norm_rel(got, want) <= NORM_TOL
        assert got[pos.index(-1)].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["served", "long-b16", "long-b64"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("head_dim,h,hkv,k_tokens", [
    (128, 4, 4, 5), (64, 8, 2, 4), (128, 8, 2, 3)])
def test_paged_verify_kernel(cuda_device, head_dim, h, hkv, k_tokens,
                             window, int8, layout):
    """K rows per slot against the plain version (the generic function):
    two slots share a block, one is a pad slot (position 0 over trash
    tables, which must come out finite), contexts cross block edges; the
    long layouts (block 16: cp.async gathers, block 64: TMA boxes) put
    contexts of ~2000 and ~4000 tokens and a one-tile context."""
    bs, width = {"served": (16, 6), "long-b16": (16, 256),
                 "long-b64": (64, 64)}[layout]
    rng = np.random.default_rng(head_dim + k_tokens)
    (kp, vp), scales, tb = _paged_inputs(rng, cuda_device, bs, h, hkv,
                                         head_dim, 4, width, int8)
    tb[3] = 0                                    # the pad slot: all trash
    pos0 = (np.asarray([37, 5, 61 + 16 - k_tokens, 0]) if layout == "served"
            else np.asarray([2001, 10, 4096 - k_tokens, 0]))
    ts = torch.from_numpy(np.repeat(np.arange(4), k_tokens).astype(
        np.int32)).to(cuda_device)
    tp = torch.from_numpy((pos0[:, None] + np.arange(k_tokens)).reshape(
        -1).astype(np.int32)).to(cuda_device)
    q = torch.from_numpy(rng.standard_normal(
        (4 * k_tokens, h, head_dim))).to(cuda_device, torch.bfloat16)
    key = "paged_verify_attention" + ("_int8" if int8 else "")
    before = tbf.LAUNCHES[key]
    got = tbf.paged_verify_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                                     k_tokens=k_tokens, window=window,
                                     **scales)
    torch.cuda.synchronize()
    assert tbf.LAUNCHES[key] == before + 1
    want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp, block_size=bs,
                                     window=window, **scales)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL
    assert torch.isfinite(got.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_verify_bit_equal_over_two_runs(cuda_device, int8):
    """The decode and verify kernel merges its warps' softmax states in a
    fixed order: two runs at long contexts give bit-equal outputs."""
    bs, h, width = _LONG_LAYOUTS["long-b16"]
    rng = np.random.default_rng(5)
    (kp, vp), scales, tb = _paged_inputs(rng, cuda_device, bs, h, 2, 128, 5,
                                         width, int8)
    ts = torch.arange(5, dtype=torch.int32, device=cuda_device)
    tp = torch.tensor(_LONG_POS, dtype=torch.int32, device=cuda_device)
    q = torch.from_numpy(rng.standard_normal((5, h, 128))).to(
        cuda_device, torch.bfloat16)
    vts = torch.from_numpy(np.repeat(np.arange(5), 4).astype(np.int32)).to(
        cuda_device)
    vtp = torch.from_numpy((np.asarray([2001, 10, 0, 4000, 3990])[:, None]
                            + np.arange(4)).reshape(-1).astype(np.int32)).to(
        cuda_device)
    vq = torch.from_numpy(rng.standard_normal((20, h, 128))).to(
        cuda_device, torch.bfloat16)
    runs = [(tbf.paged_decode_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                                        **scales),
             tbf.paged_verify_attention(vq, kp, vp, tb, vts, vtp,
                                        block_size=bs, k_tokens=4, **scales))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# A fault planted in a copy of csrc/blocked_flash.cu: each decode and
# verify row's causal frontier one key too far, so row k also sees row k +
# 1's key (the generic kernel's rows stay right).
_VERIFY_FRONTIER = ("r_pos[h] = r < rows ? pos0 + r / group : -1;",
                    "r_pos[h] = r < rows ? pos0 + r / group + 1 : -1;")
# ... and one in the merge of the block's warps: the last warp's softmax
# state (a quarter of every tile's keys) dropped.
_WARP_MERGE = ("for (int w = 0; w < kWarps; ++w) {",
               "for (int w = 0; w < kWarps - 1; ++w) {")


def _phase3_verify_cases(dev):
    """chip_smoke.py's phase-3 verify shape (S=8, K=5, contexts 257-330,
    32 heads, D=128, block 128), bf16 and int8 pools: a function giving
    each mode's (max-abs, norm-rel) error against the plain version
    through the library loaded at the time of the call."""
    bs, k_tokens, slots = 128, 5, 8
    rng = np.random.default_rng(17)
    pos0 = rng.integers(257, 327, size=slots)
    ts = torch.from_numpy(np.repeat(np.arange(slots), k_tokens).astype(
        np.int32)).to(dev)
    tp = torch.from_numpy((pos0[:, None] + np.arange(k_tokens)).reshape(
        -1).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal(
        (slots * k_tokens, 32, 128))).to(dev, torch.bfloat16)
    cases = {}
    for int8 in (False, True):
        (kp, vp), scales, tb = _paged_inputs(rng, dev, bs, 32, 32, 128,
                                             slots, 3, int8)
        want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp,
                                         block_size=bs, **scales)
        cases["int8" if int8 else "bf16"] = (kp, vp, scales, tb, want)

    def errors():
        out = {}
        for mode, (kp, vp, scales, tb, want) in cases.items():
            got = tbf.paged_verify_attention(q, kp, vp, tb, ts, tp,
                                             block_size=bs,
                                             k_tokens=k_tokens, **scales)
            out[mode] = ((got.float() - want.float()).abs().max().item(),
                         _norm_rel(got, want))
        return out

    return errors


def _planted_verify_bars(tmp_path, monkeypatch, dev, fault, label):
    """The phase-3 verify errors of the built kernel and of one built from
    a copy of its source with ``fault`` planted: the first pass both bars,
    the second reads above the norm bar."""
    errors = _phase3_verify_cases(dev)
    built = errors()
    monkeypatch.setitem(_build._LIBS, "blocked_flash",
                        _planted(tmp_path, "blocked_flash", [fault]))
    tbf._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tbf._kernel.cache_clear()
    for name, errs in (("built", built), (label, planted)):
        print(f"verify {name}: " + ", ".join(
            f"{m} max-abs {a:.3g} norm-rel {n:.3g}"
            for m, (a, n) in errs.items()))
    assert all(a <= TOL and n <= NORM_TOL for a, n in built.values()), built
    assert all(n > NORM_TOL for _, n in planted.values()), planted


@pytest.mark.cuda
def test_paged_norm_bar_catches_planted_verify_frontier(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    """At chip_smoke.py's phase-3 verify shape, bf16 and int8 pools: the
    kernel as built passes both bars, and the planted frontier fault,
    built from a copy of the source in a temporary directory, reads above
    the norm bar."""
    _planted_verify_bars(tmp_path, monkeypatch, cuda_device,
                         _VERIFY_FRONTIER, "planted frontier")


@pytest.mark.cuda
def test_paged_norm_bar_catches_planted_warp_merge(cuda_device, tmp_path,
                                                   monkeypatch):
    """At phase 3's verify shape: a merge of the block's warps that drops
    the last warp's state reads above the norm bar."""
    _planted_verify_bars(tmp_path, monkeypatch, cuda_device, _WARP_MERGE,
                         "planted merge")


@pytest.mark.cuda
def test_paged_kernel_refusals_raise(cuda_device, monkeypatch):
    """Shapes a kernel does not take raise in the wrapper, and a launch the
    kernel refuses raises too (no fall-back to the plain version): past
    MAX_VERIFY_ROWS query rows per KV head, with the wrapper's own check
    lifted, the C entry point returns cudaErrorInvalidValue."""
    rng = np.random.default_rng(9)
    (kp, vp), scales, tb = _paged_inputs(rng, cuda_device, 16, 8, 2, 64, 2,
                                         2, True)
    q = torch.zeros((2 * 5, 8, 64), device=cuda_device, dtype=torch.bfloat16)
    idx = torch.zeros((10,), dtype=torch.int32, device=cuda_device)
    kw = dict(block_size=16, k_tokens=5, **scales)   # 5 x 4 = 20 rows
    with pytest.raises(ValueError, match="MAX_VERIFY_ROWS"):
        tbf.paged_verify_attention(q, kp, vp, tb, idx, idx, **kw)
    monkeypatch.setattr(tbf, "MAX_VERIFY_ROWS", 64)
    before = dict(tbf.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        tbf.paged_verify_attention(q, kp, vp, tb, idx, idx, **kw)
    assert tbf.LAUNCHES == before
    with pytest.raises(ValueError, match="int8 pools with k_scale"):
        tbf.paged_decode_attention(q[:2], kp, vp, tb, idx[:2], idx[:2],
                                   block_size=16)


@pytest.mark.cuda
def test_int8_engine_kernels_match_plain_paths(cuda_device):
    """A small int8-weight Llama (head_dim 64, GQA) served over an int8 KV
    pool: put, decode_step and verify_step through the kernels and through
    the plain paths on the same card.  The kernel path launches each int8
    kernel and no bf16 attention kernel; the plain path launches none."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=384,
                           num_attention_heads=4, num_key_value_heads=2,
                           dtype=torch.bfloat16)
    params = random_int8_llama_params(cfg, groups=4, seed=1,
                                      device=cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 40)]
    out = {}
    start = None
    for use_kernels in (False, True):
        eng = InferenceEngineV2(
            RaggedLlama(cfg, 16, use_kernels=use_kernels), params,
            RaggedInferenceEngineConfig.from_dict({
                "state_manager": {"max_ragged_batch_size": 64,
                                  "max_ragged_sequence_count": 4,
                                  "max_context": 96},
                "kv_cache": {"block_size": 16, "dtype": "int8"}}))
        before = dict(tbf.LAUNCHES)
        first = eng.put([0, 1], prompts)
        if start is None:
            # the plain path's greedy tokens feed both paths' decode and
            # verify, so that a near-tie of this random model's logits
            # cannot hand the two paths different inputs
            start = [int(first[u].argmax()) for u in (0, 1)]
        dec = eng.decode_step([0, 1], start)
        ver = eng.verify_step([0, 1], [[5, 6, 7], [8, 9, 10]])
        torch.cuda.synchronize()
        launched = {k: tbf.LAUNCHES[k] - before[k] for k in before}
        if use_kernels:
            assert all(launched[k] > 0 for k in launched if "int8" in k)
            assert not any(launched[k] for k in launched if "int8" not in k)
        else:
            assert not any(launched.values())
        out[use_kernels] = [np.stack([first[0], first[1]]),
                            dec[:2].float().cpu().numpy(),
                            ver[:2].float().cpu().numpy()]
    for got, want in zip(out[True], out[False]):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL


def _prefill_inputs(rng, dev, h, hkv, d, window_case=False, bs=128):
    """A tile-aligned 512-row buffer over a bf16 pool (tables of 384
    positions in scattered blocks of ``bs``): four 128-row stripes of slots
    3, 3, 5 and 6 with pad rows (position -1; the pads of slot 5's stripe
    carry slot 0) and prompts that start mid-context."""
    (kp, vp), _, tb = _paged_inputs(rng, dev, bs, h, hkv, d, 8, 384 // bs,
                                    False)
    slot = np.zeros(512, np.int32)
    pos = np.full(512, -1, np.int32)
    slot[:256], pos[:200] = 3, np.arange(40, 240)
    slot[256:300], pos[256:300] = 5, np.arange(0, 44)
    slot[384:], pos[384:] = 6, np.arange(100 if window_case else 0, 228
                                         if window_case else 128)
    q = torch.from_numpy(rng.standard_normal((512, h, d))).to(
        dev, torch.bfloat16)
    ts, tp = (torch.from_numpy(a).to(dev) for a in (slot, pos))
    return q, kp, vp, tb, ts, tp


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,h,hkv,window,bs,tile", [
    (128, 32, 8, None, 128, 128), (128, 32, 8, 100, 128, 128),
    (64, 8, 2, None, 128, 128), (64, 4, 4, 40, 128, 128),
    (64, 4, 2, None, 16, 64), (128, 8, 2, 30, 32, 64)])
def test_paged_prefill_kernel(cuda_device, head_dim, h, hkv, window, bs,
                              tile):
    """The tiled prefill (the generic tiled kernel over the stripes'
    slots) against its plain version: Mixtral's G = 4 at D = 128, G = 4 at
    D = 64, MHA with a window, blocks smaller than a 64-key tile and 64-row
    stripes; pad rows exact zeros, those that carry another slot than
    their stripe's included."""
    rng = np.random.default_rng(head_dim + h + (window or 0) + bs)
    q, kp, vp, tb, ts, tp = _prefill_inputs(rng, cuda_device, h, hkv,
                                            head_dim, window is not None, bs)
    before = dict(tbf.LAUNCHES)
    got = tbf.paged_prefill_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                                      tile_q=tile, window=window)
    # one launch of the generic tiled kernel, counted under the prefill
    assert {k: v - before[k] for k, v in tbf.LAUNCHES.items()
            if v != before[k]} == {"paged_prefill_attention": 1}
    want = tbf.paged_prefill_attention_plain(q, kp, vp, tb, ts, tp,
                                             block_size=bs, tile_q=tile,
                                             window=window)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL
    assert got[tp < 0].abs().max().item() == 0.0
    with pytest.raises(ValueError, match="multiple of 64"):
        tbf.paged_prefill_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                                    tile_q=32)


def _b5_inputs(rng, dev, slot_pos, h, hkv, d, bs, int8, order=None):
    """A ragged batch for the generic kernel: ``slot_pos`` lists each slot's
    positions (-1: a pad row), rows slot by slot or in ``order``; pools of
    384 positions a slot in scattered blocks of ``bs``."""
    slots = len(slot_pos)
    (kp, vp), scales, tb = _paged_inputs(rng, dev, bs, h, hkv, d, slots,
                                         384 // bs, int8)
    slot = np.asarray([s for s in range(slots) for _ in slot_pos[s]],
                      np.int32)
    pos = np.asarray([p for s in range(slots) for p in slot_pos[s]],
                     np.int32)
    if order is not None:
        slot, pos = slot[order], pos[order]
    q = torch.from_numpy(rng.standard_normal((len(pos), h, d))).to(
        dev, torch.bfloat16)
    ts, tp = (torch.from_numpy(a).to(dev) for a in (slot, pos))
    return q, kp, vp, scales, tb, ts, tp


_R = lambda a, b: list(range(a, b))  # noqa: E731
# chip_smoke.py phase 3's B5 cases at test size: (slot positions, h, hkv,
# d, block size, window, row order)
_B5_CASES = {
    "2x256 prefill": ([_R(0, 256)] * 2, 32, 32, 128, 128, None, None),
    "8x256 ctx": ([_R(192, 256)] * 8, 32, 32, 128, 128, None, None),
    "SplitFuse tick": ([_R(64, 256)] + [[p] for p in (300, 257, 330, 281,
                                                      299, 264, 312)],
                       32, 32, 128, 128, None, None),
    "block 16": ([_R(0, 256), _R(0, 77)], 8, 8, 128, 16, None, None),
    "block 64": ([_R(0, 256), _R(0, 77)], 8, 8, 128, 64, None, None),
    "window 100": ([_R(0, 256)] * 2, 8, 8, 128, 128, 100, None),
    "window 100, block 16, gaps": ([_R(0, 20) + _R(300, 330), _R(5, 9)], 8,
                                   8, 128, 16, 100, None),
    "G=4": ([_R(0, 256)] * 2, 32, 8, 128, 128, None, None),
    "G=8": ([_R(0, 256)] * 2, 32, 4, 128, 128, None, None),
    "G=3, D=64": ([_R(0, 100), _R(0, 50)], 6, 2, 64, 16, None, None),
    "D=64, G=4, window": ([_R(0, 150), _R(10, 90)], 16, 4, 64, 64, 37,
                          None),
    "pads, split runs": ([_R(0, 150), _R(0, 60), [-1] * 20], 8, 8, 128,
                         128, None,
                         _R(0, 100) + _R(210, 220) + _R(150, 210)
                         + _R(100, 150) + _R(220, 230)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", list(_B5_CASES))
def test_paged_attention_tiled_kernel(cuda_device, case, int8):
    """The generic kernel (a tiled tensor-core walk per 64-row stripe and
    distinct slot) against its plain version, bf16 and int8 pools: block
    sizes 16 / 64 / 128 (cp.async gathers and TMA boxes), windows with
    gaps between a slot's rows, G = 1, 3, 4, 8, D = 64 and 128, pad rows
    (exact zeros) and one slot's tokens in two runs of the batch."""
    slot_pos, h, hkv, d, bs, window, order = _B5_CASES[case]
    rng = np.random.default_rng(len(case) + 7 * int8)
    q, kp, vp, scales, tb, ts, tp = _b5_inputs(
        rng, cuda_device, slot_pos, h, hkv, d, bs, int8, order)
    key = "paged_attention" + ("_int8" if int8 else "")
    before = dict(tbf.LAUNCHES)
    got = tbf.paged_attention(q, kp, vp, tb, ts, tp, block_size=bs,
                              window=window, **scales)
    torch.cuda.synchronize()
    assert tbf.LAUNCHES[key] == before[key] + 1
    assert sum(tbf.LAUNCHES.values()) == sum(before.values()) + 1
    want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp, block_size=bs,
                                     window=window, **scales)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL
    if (tp < 0).any():
        assert got[tp < 0].abs().max().item() == 0.0


# A fault planted in a copy of csrc/blocked_flash.cu: the tiled kernel's
# causal frontier one key too far where a tile is masked (a tile that a
# row sees whole is not), so each row on the diagonal sees the next key.
_TILED_FRONTIER = ("(act[h] && c <= r_pos[h] && c < c_len",
                   "(act[h] && c <= r_pos[h] + 1 && c < c_len")


@pytest.mark.cuda
def test_tiled_norm_bar_catches_planted_frontier(cuda_device, tmp_path,
                                                 monkeypatch):
    """At the served 2 x 256 prefill (32 heads, D = 128, block 128), bf16
    and int8 pools: the generic kernel as built passes both bars; the
    planted frontier fault reads above the norm bar."""
    cases = {}
    for int8 in (False, True):
        rng = np.random.default_rng(23 + int8)
        q, kp, vp, scales, tb, ts, tp = _b5_inputs(
            rng, cuda_device, [_R(0, 256)] * 2, 32, 32, 128, 128, int8)
        want = tbf.paged_attention_plain(q, kp, vp, tb, ts, tp,
                                         block_size=128, **scales)
        cases["int8" if int8 else "bf16"] = (q, kp, vp, scales, tb, ts, tp,
                                             want)

    def errors():
        out = {}
        for mode, (q, kp, vp, scales, tb, ts, tp, want) in cases.items():
            got = tbf.paged_attention(q, kp, vp, tb, ts, tp, block_size=128,
                                      **scales)
            out[mode] = ((got.float() - want.float()).abs().max().item(),
                         _norm_rel(got, want))
        return out

    built = errors()
    monkeypatch.setitem(_build._LIBS, "blocked_flash", _planted(
        tmp_path, "blocked_flash", [_TILED_FRONTIER]))
    tbf._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tbf._kernel.cache_clear()
    for label, errs in (("built", built), ("planted frontier", planted)):
        print(f"tiled {label}: " + ", ".join(
            f"{m} max-abs {a:.3g} norm-rel {n:.3g}"
            for m, (a, n) in errs.items()))
    assert all(a <= TOL and n <= NORM_TOL for a, n in built.values()), built
    assert all(n > NORM_TOL for _, n in planted.values()), planted


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,groups", [
    (16, 4096, 4096, 16), (40, 4096, 4096, 16), (64, 4096, 4096, 16),
    (65, 4096, 4096, 16), (512, 4096, 4096, 16), (1024, 4096, 4096, 16),
    (40, 11008, 4096, 64), (512, 11008, 4096, 64), (40, 4096, 4112, 16),
    (512, 4096, 32000, 16), (40, 4096, 32000, 16), (9, 96, 48, 3),
    (129, 1024, 4112, 16)])
def test_quantized_matmul_tiled_kernel(cuda_device, m, k, n, groups):
    """The tiled (wgmma) path above M = 8 against its plain version at both
    bars: 64-row tiles with split-K at medium M, 128-row tiles to M = 128
    and 256-row tiles above (split-K at M = 512), from_hf's 64 groups at
    K = 11008 (a group boundary inside a k-tile), ragged N (4112, 32000)
    and M, and a K shorter than one split."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    rec = {"q": torch.randint(-127, 128, (k, n), generator=gen,
                              device=cuda_device, dtype=torch.int8),
           "scale": torch.rand((groups,), generator=gen, device=cuda_device)
           / (73.3 * k ** 0.5)}
    before = tqm.LAUNCHES["quantized_matmul"]
    got = tqm.quantized_matmul(x, rec)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quantized_matmul"] == before + 1
    want = tqm.quantized_matmul_plain(x, rec)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL


#: the skinny path's cases (M <= 8): Llama-2-7B's four projection shapes
#: at M = 1, 2, 5 and 8, from_hf's 64 groups at K = 11008, a ragged N of
#: 4112 and K shorter than one 128-row unit: m, k, n, groups
_SKINNY_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
_SKINNY_CASES = ([(m, k, n, 16) for m in (1, 2, 5, 8)
                  for k, n in _SKINNY_SHAPES]
                 + [(8, 11008, 4096, 64), (2, 11008, 4096, 64),
                    (8, 4096, 4112, 16), (3, 1024, 4112, 16),
                    (8, 64, 4096, 1), (1, 96, 256, 3)])


def _qmm_inputs(dev, m, k, n, groups, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16)
    rec = {"q": torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8),
           "scale": torch.rand((groups,), generator=gen, device=dev)
           / (73.3 * k ** 0.5)}
    return x, rec


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,groups", _SKINNY_CASES)
def test_quantized_matmul_skinny_kernel(cuda_device, m, k, n, groups):
    """The skinny path (M <= 8, tiles cut over clusters on mma.sync)
    against its plain version at both bars, one launch a call."""
    x, rec = _qmm_inputs(cuda_device, m, k, n, groups, m + k + n + groups)
    before = tqm.LAUNCHES["quantized_matmul"]
    got = tqm.quantized_matmul(x, rec)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quantized_matmul"] == before + 1
    want = tqm.quantized_matmul_plain(x, rec)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,groups", [(8, 11008, 4096, 64),
                                          (2, 4096, 32000, 16),
                                          (1, 4096, 4096, 16)])
def test_quantized_matmul_skinny_bit_equal(cuda_device, m, k, n, groups):
    """Three runs of the skinny path give the same bits: a tile cut over a
    cluster of blocks is summed in rank order."""
    x, rec = _qmm_inputs(cuda_device, m, k, n, groups, 7)
    runs = [tqm.quantized_matmul(x, rec) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_skinny_resident_clusters_fit_the_card(cuda_device):
    """The card's resident clusters, as the wrapper reads them: no more
    blocks than SMs at any size, fewer clusters as they grow, and a launch
    plan at each 7B shape whose clusters are all resident."""
    counts = dict(tqm.resident_clusters(cuda_device.index))
    sms = tqm._sms(cuda_device)
    assert sorted(counts) == list(range(2, 9))
    assert all(0 < c * n <= sms for c, n in counts.items()), counts
    assert all(counts[c] >= counts[c + 1] for c in range(2, 8)), counts
    for k, n in _SKINNY_SHAPES:
        plan = tqm.skinny_plan(k, n, tqm.resident_clusters(cuda_device.index))
        assert plan["cluster"] == 1 or plan["tiles"] <= counts[
            plan["cluster"]], plan


@pytest.mark.cuda
def test_quantized_matmul_skinny_is_one_cuda_kernel(cuda_device):
    """A skinny call runs one CUDA kernel (no second pass summing the
    split partials), counted by torch.profiler over 4 calls at the 7B
    shapes whose tiles are cut over clusters of blocks."""
    from torch.profiler import ProfilerActivity, profile

    calls = [_qmm_inputs(cuda_device, m, k, n, 16, k + n)
             for m, k, n in ((8, 4096, 4096), (2, 11008, 4096))]
    for x, rec in calls:                      # the build
        tqm.quantized_matmul(x, rec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, rec in calls + calls:
            tqm.quantized_matmul(x, rec)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    assert len(kernels) == 4 and all("qmm_skinny_kernel" in k
                                     for k in kernels), kernels


# A fault planted in a copy of csrc/quantized_matmul.cu: each k-tile's
# scales taken from the group of its first row, as a per-tile lookup would.
_QMM_TILE_SCALE = (("return k < K ? __ldg(scale + k / rows_per_group) : 0.f;",
                    "return k < K ? __ldg(scale + (k & ~(kBK - 1)) "
                    "/ rows_per_group) : 0.f;"),)


@pytest.mark.cuda
def test_qmm_norm_bar_catches_planted_tile_scale(cuda_device, tmp_path,
                                                 monkeypatch):
    """At K = 11008 with from_hf's 64 groups (172 rows a group, so 63 of the
    172 k-tiles straddle a boundary), M = 40 and 512: the kernel as built
    passes both bars, the planted per-tile scale misses the norm bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rec = {"q": torch.randint(-127, 128, (11008, 4096), generator=gen,
                              device=cuda_device, dtype=torch.int8),
           "scale": torch.rand((64,), generator=gen, device=cuda_device)
           / (73.3 * 11008 ** 0.5)}
    xs = [torch.randn((m, 11008), generator=gen, device=cuda_device,
                      dtype=torch.bfloat16) for m in (40, 512)]
    wants = [tqm.quantized_matmul_plain(x, rec) for x in xs]

    def errors():
        return [((got.float() - w.float()).abs().max().item(),
                 _norm_rel(got, w))
                for got, w in ((tqm.quantized_matmul(x, rec), w)
                               for x, w in zip(xs, wants))]

    built = errors()
    monkeypatch.setitem(_build._LIBS, "quantized_matmul", _planted(
        tmp_path, "quantized_matmul", _QMM_TILE_SCALE))
    tqm._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tqm._kernel.cache_clear()
    print(f"qmm built {built}; planted tile scale {planted}")
    assert all(a <= TOL and n <= NORM_TOL for a, n in built), built
    assert all(n > NORM_TOL for _, n in planted), planted


# Faults planted in copies of the skinny kernel: the first block's part of
# every tile cut over a cluster left out of the sum, or each unit's scales
# taken from the group of its first row, as a per-unit lookup would.
_QMM_SKINNY_FAULTS = {
    "dropped part": (("    float4 tot = p4[0];",
                      "    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);"),),
    "unit scale": (("k < K ? __ldg(&scale[k / rows_per_group]) : 0.f;",
                    "k < K ? __ldg(&scale[(k & ~(kSkBK - 1)) / "
                    "rows_per_group]) : 0.f;"),),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(_QMM_SKINNY_FAULTS))
def test_qmm_norm_bar_catches_planted_skinny_fault(cuda_device, tmp_path,
                                                   monkeypatch, fault):
    """At K = 11008 with from_hf's 64 groups (172 rows a group, so every
    256-row unit of a column straddles a boundary) and M = 8, where every
    tile is cut over a cluster of blocks: the kernel as built passes both
    bars, each planted fault misses the norm bar."""
    x, rec = _qmm_inputs(cuda_device, 8, 11008, 4096, 64, 11)
    want = tqm.quantized_matmul_plain(x, rec)

    def errors():
        got = tqm.quantized_matmul(x, rec)
        return (got.float() - want.float()).abs().max().item(), _norm_rel(
            got, want)

    built = errors()
    monkeypatch.setitem(_build._LIBS, "quantized_matmul", _planted(
        tmp_path, "quantized_matmul", _QMM_SKINNY_FAULTS[fault]))
    tqm._skinny_kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tqm._skinny_kernel.cache_clear()
    print(f"qmm skinny built {built}; planted {fault} {planted}")
    assert built[0] <= TOL and built[1] <= NORM_TOL, built
    assert planted[1] > NORM_TOL, planted


def _gmm_inputs(gen, dev, m, k, n, sizes):
    lhs = torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16)
    rhs = (torch.randn((len(sizes), k, n), generator=gen, device=dev)
           / k ** 0.5).to(torch.bfloat16)
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


_GMM_CASES = [
    (16, 4096, 14336, [2, 3, 0, 1, 4, 2, 2, 2]),      # a decode step
    (16, 14336, 4096, [0, 5, 0, 0, 4, 2, 2, 1]),      # 2 rows past the sum
    (100, 256, 136, [10, 0, 33, 40, 0, 0, 7, 0]),     # ragged M, N edge
    (1024, 512, 1024, [200, 130, 0, 180, 100, 150, 120, 144]),
    (70, 64, 64, [0, 0, 0, 0]),                       # no rows: zeros
    (200, 64, 256, [64, 1, 0, 60]),                   # 75 rows past
    # around the kernel's row blocks: M = 64 one consumer warpgroup's rows,
    # 65 one row past them, 129 one row past a 128-row unit
    (64, 256, 136, [20, 0, 30, 10]),                  # 4 rows past
    (65, 256, 136, [20, 0, 30, 15]),                  # every row in a group
    (129, 4096, 1024, [40, 0, 50, 30]),               # 9 rows past
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,sizes", _GMM_CASES)
def test_grouped_gemm_kernel(cuda_device, m, k, n, sizes):
    """The grouped GEMM against its plain version: empty groups, boundary
    m-tiles shared by two groups, M = 16, an M that is no multiple of the
    tile, rows past the groups exact zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, m, k, n, sizes)
    before = tgg.LAUNCHES["grouped_gemm"]
    got = tgg.gmm(lhs, rhs, gs)
    assert tgg.LAUNCHES["grouped_gemm"] == before + 1
    want = tgg.gmm_plain(lhs, rhs, gs)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    if sum(sizes):
        assert _norm_rel(got, want) <= NORM_TOL
    if sum(sizes) < m:
        assert got[sum(sizes):].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,sizes", _GMM_CASES + [
    (100, 136, 200, [10, 0, 33, 40, 0, 0, 7, 0]),     # K and N edges
    (0, 64, 64, [0, 0]),                              # no rows at all
])
def test_grouped_gemm_backward_kernels(cuda_device, m, k, n, sizes):
    """gmm under autograd launches the dlhs and drhs kernels once each,
    fed a non-contiguous upstream gradient: each within 3e-2 of its plain
    version's largest magnitude and 1e-2 in norm; dlhs rows past the groups
    and an empty group's drhs
    block exact zeros (the outputs are torch.empty: an unwritten element
    would show)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n + 1)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, m, k, n, sizes)
    lhs.requires_grad_()
    rhs.requires_grad_()
    dout = torch.randn((n, m), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16).t()      # a strided view
    before = dict(tgg.LAUNCHES)
    tgg.gmm(lhs, rhs, gs).backward(dout)
    assert {key: tgg.LAUNCHES[key] - before[key] for key in before} == {
        "grouped_gemm": int(m > 0), "grouped_gemm_dlhs": int(m > 0),
        "grouped_gemm_drhs": 1}
    total = sum(sizes)
    for got, want in ((lhs.grad, tgg.gmm_dlhs_plain(dout, rhs.detach(), gs)),
                      (rhs.grad, tgg.gmm_drhs_plain(lhs.detach(), dout, gs))):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        if total:           # drhs sums a group's rows: 3e-2 of the largest
            err = (got.float() - want.float()).abs().max()
            assert (err / want.float().abs().max()).item() <= TOL
        if total:
            assert _norm_rel(got, want) <= NORM_TOL
    if total < m:
        assert lhs.grad[total:].abs().max().item() == 0.0
    for e, size in enumerate(sizes):
        if size == 0:
            assert rhs.grad[e].abs().max().item() == 0.0


# A fault planted in a copy of csrc/grouped_gemm.cu: drhs takes the next
# group's first row into each group's sum (each group's end one row late).
_DRHS_BOUNDARY = (
    ("ends[e] = start;                            // the group's end",
     "ends[e] = min(start + 1, p.m);"),)

# A fault planted in a copy of csrc/grouped_gemm.cu: the dlhs kernel writes
# the first row of a group that starts inside an m-tile from the previous
# group's unit, with the previous group's weights.
_DLHS_BOUNDARY = (
    ("lo = tl.lo, hi = tl.hi;",
     "lo = tl.lo + (tl.lo % kGradBM != 0), "
     "hi = tl.hi + (tl.hi % kGradBM != 0 && tl.hi < p.m);"),)

# A fault planted in a copy of csrc/grouped_gemm.cu: the drhs kernel leaves
# the first row past a group's end in its last chunk (the next group's first
# row) unzeroed, so it enters the group's sum.
_DRHS_TAIL = (
    ("for (int x = valid * 8 + ct;", "for (int x = (valid + 1) * 8 + ct;"),)


# A fault planted in a copy of csrc/grouped_gemm.cu, in `find_unit` (the
# forward's work units; dlhs walks the same list): the first row of a group
# that starts inside an m-tile is written by the previous group's unit,
# with the previous group's weights.
_GMM_BOUNDARY = (("u.lo = start;", "u.lo = start + (start % BM != 0);"),
                 ("u.hi = end;", "u.hi = end + (end % BM != 0 && end < m);"))


def _planted(tmp_path, source, fault):
    """The library of ``csrc/<source>.cu`` built from a copy of its source
    with ``fault`` (pairs of text and replacement, each found once)
    planted, in a temporary directory."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in fault:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    cu, so = tmp_path / f"{source}_planted.cu", tmp_path / f"lib{source}.so"
    cu.write_text(src)
    proc = subprocess.run(
        _build.nvcc_command(cu, so),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout.decode()[-2000:]
    return ctypes.CDLL(str(so))


def _planted_gmm_boundary(tmp_path, fault=_GMM_BOUNDARY):
    """The grouped GEMM library built from a copy of its source with a
    boundary-row fault planted (the forward's by default), in a temporary
    directory."""
    return _planted(tmp_path, "grouped_gemm", fault)


@pytest.mark.cuda
def test_gmm_norm_bar_catches_planted_boundary_row(cuda_device, tmp_path,
                                                   monkeypatch):
    """At chip_smoke.py's phase-3 prefill shape (M = 1024 routed rows,
    4096 -> 14336, 8 experts, one empty): the kernel as built passes both
    bars, and the planted boundary-row fault, built from a copy of the
    source in a temporary directory, reads above the norm bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, 1024, 4096, 14336,
                               [200, 130, 0, 180, 100, 150, 120, 144])
    want = tgg.gmm_plain(lhs, rhs, gs)

    def errors():
        got = tgg.gmm(lhs, rhs, gs)
        return ((got.float() - want.float()).abs().max().item(),
                _norm_rel(got, want))

    built = errors()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm",
                        _planted_gmm_boundary(tmp_path))
    tgg._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tgg._kernel.cache_clear()
    for label, (a, n) in (("built", built), ("planted boundary row",
                                             planted)):
        print(f"gmm {label}: max-abs {a:.3g} norm-rel {n:.3g}")
    assert built[0] <= TOL and built[1] <= NORM_TOL, built
    assert planted[1] > NORM_TOL, planted


@pytest.mark.cuda
def test_drhs_norm_bar_catches_planted_boundary_row(cuda_device, tmp_path,
                                                    monkeypatch):
    """At chip_smoke.py's phase-3 training shape (M = 8192 routed rows,
    4096 x 14336, 8 experts): drhs as built passes both bars, and the
    planted boundary-row fault (each group's sum takes the next group's
    first row), built from a copy of the source in a temporary directory,
    reads above the norm bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    sizes = [1100, 980, 1010, 1050, 990, 1020, 1000, 1042]
    lhs, _, gs = _gmm_inputs(gen, cuda_device, 8192, 4096, 8, sizes)
    dout = torch.randn((8192, 14336), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16)
    want = tgg.gmm_drhs_plain(lhs, dout, gs)

    def errors():
        got = tgg.gmm_drhs(lhs, dout, gs)
        return ((got.float() - want.float()).abs().max().item(),
                _norm_rel(got, want))

    built = errors()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm", _planted_gmm_boundary(
        tmp_path, _DRHS_BOUNDARY))
    tgg._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tgg._kernel.cache_clear()
    for label, (a, n) in (("built", built), ("planted boundary row",
                                             planted)):
        print(f"drhs {label}: max-abs {a:.3g} norm-rel {n:.3g}")
    assert built[1] <= NORM_TOL, built
    assert planted[1] > NORM_TOL, planted


#: chip_smoke.py's phase-3 training routing: 8192 rows over 8 experts, each
#: group starting inside a 128-row m-tile
_TRAIN_SIZES = [1100, 980, 1010, 1050, 990, 1020, 1000, 1042]


@pytest.mark.cuda
def test_dlhs_norm_bar_catches_planted_boundary_row(cuda_device, tmp_path,
                                                    monkeypatch):
    """At chip_smoke.py's phase-3 training shape (M = 8192 routed rows,
    14336 -> 4096, 8 experts): dlhs as built passes both bars and writes
    zeros past the groups, and the planted boundary-row fault (a group's
    first row from the previous group's unit), built from a copy of the
    source in a temporary directory, reads above the norm bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    gs = torch.tensor(_TRAIN_SIZES, dtype=torch.int32, device=cuda_device)
    dout = torch.randn((8192, 14336), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16)
    # scaled as phase 3 scales it: outputs ~N(0, 1/4), so one bf16 ulp of
    # the largest sits under the 3e-2 max bar
    rhs = (torch.randn((8, 4096, 14336), generator=gen, device=cuda_device)
           * (0.5 / 14336 ** 0.5)).to(torch.bfloat16)
    want = tgg.gmm_dlhs_plain(dout, rhs, gs)

    def errors():
        got = tgg.gmm_dlhs(dout, rhs, gs)
        return ((got.float() - want.float()).abs().max().item(),
                _norm_rel(got, want))

    built = errors()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm", _planted_gmm_boundary(
        tmp_path, _DLHS_BOUNDARY))
    tgg._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tgg._kernel.cache_clear()
    for label, (a, n) in (("built", built), ("planted boundary row",
                                             planted)):
        print(f"dlhs {label}: max-abs {a:.3g} norm-rel {n:.3g}")
    assert built[0] <= TOL and built[1] <= NORM_TOL, built
    assert planted[1] > NORM_TOL, planted


@pytest.mark.cuda
def test_drhs_norm_bar_catches_planted_tail_row(cuda_device, tmp_path,
                                                monkeypatch):
    """At chip_smoke.py's phase-3 training shape (M = 8192 routed rows,
    4096 x 14336, 8 experts): the planted fault that leaves one row of a
    group's last chunk past its end unzeroed, built from a copy of the
    source in a temporary directory, reads above the norm bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    lhs, _, gs = _gmm_inputs(gen, cuda_device, 8192, 4096, 8, _TRAIN_SIZES)
    dout = torch.randn((8192, 14336), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16)
    want = tgg.gmm_drhs_plain(lhs, dout, gs)

    def errors():
        got = tgg.gmm_drhs(lhs, dout, gs)
        return ((got.float() - want.float()).abs().max().item(),
                _norm_rel(got, want))

    built = errors()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm", _planted_gmm_boundary(
        tmp_path, _DRHS_TAIL))
    tgg._kernel.cache_clear()
    try:
        planted = errors()
    finally:
        tgg._kernel.cache_clear()
    for label, (a, n) in (("built", built), ("planted tail row", planted)):
        print(f"drhs {label}: max-abs {a:.3g} norm-rel {n:.3g}")
    assert built[1] <= NORM_TOL, built
    assert planted[1] > NORM_TOL, planted


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,sizes", [
    (8192, 4096, 1024, _TRAIN_SIZES),
    (1000, 136, 200, [10, 0, 330, 400, 0, 0, 70, 0]),  # edges, rows past
])
def test_grouped_gemm_gradients_bit_equal(cuda_device, m, k, n, sizes):
    """Two runs of the dlhs and of the drhs kernel on the same inputs give
    the same bits (each element is summed in a fixed order by one block,
    without atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, m, k, n, sizes)
    dout = torch.randn((m, n), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16)
    for run in (lambda: tgg.gmm_dlhs(dout, rhs, gs),
                lambda: tgg.gmm_drhs(lhs, dout, gs)):
        first, again = run(), run()
        assert torch.equal(first, again)


#: forward cases at prefill and training sizes: m, k, n, sizes
_GMM_FWD_CASES = [
    (1024, 4096, 1024, [200, 130, 0, 180, 100, 150, 120, 144]),
    (8192, 1024, 2048, _TRAIN_SIZES),
    (1000, 136, 200, [10, 0, 330, 400, 0, 0, 70, 0]),  # edges, rows past
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,sizes", _GMM_FWD_CASES)
def test_grouped_gemm_forward_wgmma(cuda_device, m, k, n, sizes):
    """The wgmma forward against its plain version: 3e-2 max, 1e-2 in norm,
    rows past the groups exact zeros, and its launch described as that
    kernel, in its bands of :data:`FWD_TILES` units, with no spills.  The
    weights are scaled so that outputs are ~N(0, 1/4), as phase 3 scales
    its training cases: one bf16 ulp of outputs above 4 (3.1e-2) would sit
    above the max bar."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, m, k, n, sizes)
    rhs.mul_(0.5)
    got = tgg.gmm(lhs, rhs, gs)
    info = tgg.launch_info()
    want = tgg.gmm_plain(lhs, rhs, gs)
    assert info["kernel"] == "gmm_wgmma_kernel<kFwd>"
    assert (info["bm"], info["band"], info["spill_bytes"]) == (
        128, tgg.FWD_TILES["band"], 0)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert _norm_rel(got, want) <= NORM_TOL
    if sum(sizes) < m:
        assert got[sum(sizes):].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,sizes", [(16, 4096, 1024, [2, 3, 0, 1, 4, 2,
                                                          2, 2])]
                         + _GMM_FWD_CASES)
def test_grouped_gemm_forward_bit_equal(cuda_device, m, k, n, sizes):
    """Two runs of the forward on the same inputs give the same bits (each
    element is summed in a fixed order by one block, without atomics), and
    the wgmma kernel is the one launched, at every M."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n)
    lhs, rhs, gs = _gmm_inputs(gen, cuda_device, m, k, n, sizes)
    first = tgg.gmm(lhs, rhs, gs)
    info = tgg.launch_info()
    again = tgg.gmm(lhs, rhs, gs)
    assert torch.equal(first, again)
    assert (info["kernel"], info["bm"]) == ("gmm_wgmma_kernel<kFwd>", 128)


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
def test_moe_training_bars_catch_planted_drhs_fault(cuda_device, tmp_path,
                                                    monkeypatch):
    """chip_smoke.py's phase 13 as it runs there (a dropless MoE layer and
    2 layers of the dropless Mixtral at full width, random weights from its
    seed) held to its bars: the kernels as built pass every bar, and the
    planted drhs boundary-row fault, built from a copy of the source in a
    temporary directory, misses some."""
    smoke = _load_chip_smoke()

    def phase13():
        tgg._kernel.cache_clear()
        try:
            layer = smoke.moe_layer_kernel_vs_plain(torch, cuda_device)
            model = smoke.moe_model_kernel_vs_plain(torch, np, cuda_device)
        finally:
            tgg._kernel.cache_clear()
            torch.cuda.empty_cache()
        return layer, model, smoke.moe_training_failures(layer, model)

    built = phase13()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm", _planted_gmm_boundary(
        tmp_path, _DRHS_BOUNDARY))
    planted = phase13()
    for label, (layer, model, missed) in (("built", built),
                                          ("planted drhs boundary row",
                                           planted)):
        print(f"moe training {label}: layer {layer['norm_rel_err']}, vs "
              f"fp32 {layer['norm_rel_err_vs_fp32']}; model loss "
              f"{model['loss_rel_err']:.3g} logits "
              f"{model['logits_norm_rel_err']:.3g} vs fp32 "
              f"{model['logits_vs_fp32']}; missed {missed}")
    assert built[1]["kernel_launches"]["grouped_gemm_drhs"] > 0
    assert not built[2], built[2]
    assert planted[2]


@pytest.mark.cuda
def test_mixtral_engine_kernels_match_plain_paths(cuda_device):
    """A small bf16 Mixtral (head_dim 64, 4 query heads over 2 KV heads, 4
    experts, top-2) served through the kernels and through the plain paths
    on the same card, with a 64-row prefill tile so that put() takes the
    tiled prefill kernel.  The kernel path launches the tiled prefill, the
    decode kernel and the grouped GEMM; the plain path launches nothing;
    verify_step scores its rows through the generic paged kernel."""
    from deepspeed_tpu_torch.checkpoint import random_mixtral_params

    cfg = MixtralConfig.tiny(hidden_size=256, intermediate_size=384,
                             num_attention_heads=4, num_key_value_heads=2,
                             dtype=torch.bfloat16)
    params = random_mixtral_params(
        cfg, cuda_device, torch.Generator(device=cuda_device).manual_seed(1))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (70, 90)]
    out = {}
    for use_kernels in (True, False):
        eng = InferenceEngineV2(
            RaggedMixtral(cfg, 16, use_kernels=use_kernels), params,
            RaggedInferenceEngineConfig.from_dict({
                "state_manager": {"max_ragged_batch_size": 256,
                                  "max_ragged_sequence_count": 4,
                                  "max_context": 128},
                "kv_cache": {"block_size": 16}}))
        eng.PREFILL_TILE = 64
        before = {**tbf.LAUNCHES, **tgg.LAUNCHES}
        first = eng.put([0, 1], prompts)
        start = [int(first[u].argmax()) for u in (0, 1)]
        dec = eng.decode_step([0, 1], start)
        torch.cuda.synchronize()
        launched = {k: v - before[k]
                    for k, v in {**tbf.LAUNCHES, **tgg.LAUNCHES}.items()}
        if use_kernels:
            assert launched["paged_prefill_attention"] == cfg.num_hidden_layers
            assert launched["paged_decode_attention"] == cfg.num_hidden_layers
            assert launched["grouped_gemm"] == 6 * cfg.num_hidden_layers
            assert launched["paged_attention"] == 0
        else:
            assert not any(launched.values())
        before = dict(tbf.LAUNCHES)
        ver = eng.verify_step([0, 1], [[1, 2], [3, 4]])[:2].float()
        torch.cuda.synchronize()
        assert ver.shape == (2, 2, cfg.vocab_size)
        assert torch.isfinite(ver).all()
        # verify rows take the generic paged kernel (no Mixtral verify route)
        assert tbf.LAUNCHES["paged_attention"] - before["paged_attention"] \
            == (cfg.num_hidden_layers if use_kernels else 0)
        out[use_kernels] = [np.stack([first[0], first[1]]),
                            dec[:2].float().cpu().numpy()]
    for got, want in zip(out[True], out[False]):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() / np.abs(want).max() <= TOL


@pytest.mark.cuda
def test_mixtral_slice_bars_catch_planted_gmm_fault(cuda_device, tmp_path,
                                                    monkeypatch):
    """chip_smoke.py's phase 11 as it runs there (2 layers of Mixtral-8x7B
    at full width, random bf16 weights and prompts from its seed), held to
    its bars: the kernels as built pass every bar, and the planted
    boundary-row fault of the grouped GEMM, built from a copy of its source
    in a temporary directory, misses some.  The phase's shape, not a
    narrower model: its bars were set from readings at that shape, and at
    hidden 512 with 8 experts one flipped top-2 route puts the own-KV
    decode 0.34 of the largest logit off as built."""
    smoke = _load_chip_smoke()
    rng = np.random.default_rng(smoke.SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]

    def phase11():
        tgg._kernel.cache_clear()
        try:
            mix = smoke.mixtral_kernel_vs_plain(torch, np, prompts)
        finally:
            tgg._kernel.cache_clear()
            torch.cuda.empty_cache()
        return mix, smoke.mixtral_slice_failures(mix)

    built, built_missed = phase11()
    monkeypatch.setitem(_build._LIBS, "grouped_gemm",
                        _planted_gmm_boundary(tmp_path))
    planted, planted_missed = phase11()
    for label, mix, missed in (("built", built, built_missed),
                               ("planted boundary row", planted,
                                planted_missed)):
        print(f"mixtral slice {label}: max {mix['logits_rel_err']}, "
              f"norm {mix['logits_norm_rel_err']}, vs fp32 "
              f"{mix['norm_rel_err_vs_fp32']}; missed {missed}")
    assert built["kernel_launches"]["grouped_gemm"] > 0
    assert not built_missed, built_missed
    assert planted_missed


# ----------------------------------------------------------------------------
# B10: the int8 quantizer, bit for bit
# ----------------------------------------------------------------------------
_QUANT_CASES = [
    ((4096, 4096), 64, torch.bfloat16), ((4096, 11008), 16, torch.bfloat16),
    ((11008, 4096), 64, torch.bfloat16), ((4096, 32000), 16, torch.bfloat16),
    ((4096, 4096), 4096 * 4096 // 128, torch.bfloat16),     # group 128
    ((512, 1024), 8, torch.float16), ((512, 1024), 8, torch.float32),
    ((1000, 3), 3, torch.bfloat16),   # 2000-byte groups: the scalar path
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype", _QUANT_CASES)
def test_quantizer_kernel_bit_equal(cuda_device, shape, groups, dtype):
    """chip_smoke.py phase 19's shapes and more types: q and the scales bit
    for bit the plain version's, an all-zero group's scale 1 and q 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + groups)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    x.view(groups, -1)[0] = 0
    before = tqz.LAUNCHES["quantize"]
    q, s = tqz.quantize_kernel(x, groups)
    assert tqz.LAUNCHES["quantize"] == before + 1
    want_q, want_s = tqz.quantize_plain(x, groups)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert s[0].item() == 1.0 and not q[0].any().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizer_kernel_rounds_ties_to_even(cuda_device, dtype):
    """Every value but a group's absmax on an exact .5 tie (scale 1/8)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randint(-126, 126, (4096, 4096), generator=gen,
                       device=cuda_device).float() + 0.5) / 8
    x.view(64, -1)[:, 0] = 127 / 8
    x = x.to(dtype)
    q, s = tqz.quantize_kernel(x, 64)
    assert torch.all(s == 0.125)
    assert torch.equal(q, torch.round(x.float() * 8).to(torch.int8)
                       .view(64, -1))
    assert torch.equal(q, tqz.quantize_plain(x, 64)[0])


#: (shape, groups, type, route, staged pieces): each of the kernel's paths
#: by quantize_plan -- whole groups a piece (16-byte vectors, staged
#: twice: groups within a warp and larger ones; one value a vector, read
#: twice), a group of one piece (staged twice), a group in parts whose
#: maxima meet in the group's words (staged three times, each piece
#: quantized an iteration after it arrives; read twice: lm_head's 16 MB
#: groups, groups larger than the card's shared memory, the scalar path)
_QUANT_ROUTES = [
    ((4096, 4096), 4096 * 4096 // 128, torch.bfloat16, "block", 2),
    ((1000, 3), 3, torch.bfloat16, "block", 2),
    ((20, 35), 4, torch.float32, "block", 0),
    ((64, 12000), 64, torch.float16, "group", 2),
    ((512, 1000), 16, torch.float16, "group", 3),
    ((40, 2000), 4, torch.float32, "group", 3),
    ((4096, 4096), 64, torch.bfloat16, "group", 3),
    ((4096, 32000), 16, torch.bfloat16, "group", 0),
    ((70, 1 << 20), 1, torch.bfloat16, "group", 0),
    ((1, 100003), 1, torch.bfloat16, "group", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,dtype,route,nbuf", _QUANT_ROUTES)
def test_quantizer_kernel_routes(cuda_device, shape, groups, dtype, route,
                                 nbuf):
    """Each route of quantize_plan on the card: q and the scales bit for
    bit the plain version's and the same over two runs (the group words'
    maxima and counters are left zero for the next launch), an all-zero
    group's scale 1 and q 0, one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + groups)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    p = tqz.launch_plan(x, groups)
    assert (p["route"], p["nbuf"]) == (route, nbuf)
    x.view(groups, -1)[0] = 0
    if groups > 1:
        x.view(groups, -1)[1, 7] = 30.0            # one large value a group
    before = tqz.LAUNCHES["quantize"]
    runs = [tqz.quantize_kernel(x, groups) for _ in range(2)]
    torch.cuda.synchronize()
    assert tqz.LAUNCHES["quantize"] == before + 2
    want_q, want_s = tqz.quantize_plain(x, groups)
    for q, s in runs:
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert runs[0][1][0].item() == 1.0 and not runs[0][0][0].any().item()
    words = tqz._WORDS.get(x.device)
    assert words is None or not words.view(-1, 4)[:, :2].any().item()


@pytest.mark.cuda
def test_quantize_routes_and_refusals(cuda_device):
    """8-bit symmetric quantize launches the kernel on a CUDA tensor; the
    other modes are torch math; what the kernel does not take raises."""
    x = torch.randn((64, 128), device=cuda_device)
    before = tqz.LAUNCHES["quantize"]
    tqz.quantize(x, 4)
    tqz.quantize(x, 4, 4)
    tqz.quantize(x, 4, 8, False)
    assert tqz.LAUNCHES["quantize"] == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        tqz.quantize_kernel(x.t(), 4)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        tqz.quantize_kernel(x.double(), 4)
    with pytest.raises(ValueError, match="16-byte"):
        tqz.quantize_kernel(x.view(-1)[1:4097], 4)


@pytest.mark.cuda
def test_quantizer_bit_equality_catches_planted_reciprocal(cuda_device,
                                                           tmp_path,
                                                           monkeypatch):
    """A copy of csrc/quantizer.cu that multiplies by the scale's
    reciprocal instead of dividing misses the bit-equality bar at a
    phase-19 shape; the kernel as built meets it."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((4096, 4096), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    want_q, want_s = tqz.quantize_plain(x, 64)
    built_q, built_s = tqz.quantize_kernel(x, 64)
    monkeypatch.setitem(_build._LIBS, "quantizer", _planted(
        tmp_path, "quantizer", (("rintf(__fdiv_rn(x, scale))",
                                 "rintf(x * (1.f / scale))"),)))
    tqz._kernel.cache_clear()
    try:
        planted_q, _ = tqz.quantize_kernel(x, 64)
    finally:
        tqz._kernel.cache_clear()
    flips = int((planted_q != want_q).sum().item())
    print(f"planted reciprocal: {flips} of {x.numel()} values differ")
    assert torch.equal(built_q, want_q) and torch.equal(built_s, want_s)
    assert flips > 0


# ----------------------------------------------------------------------------
# B12: Evoformer attention
# ----------------------------------------------------------------------------
EVO_GRAD_NORM_TOL = 5e-2
#: the general kernel in fp32 against the dense version in fp32
EVO_FP32_TOL = 1e-4
_EVO_CASES = [
    ((1, 256), 256, 4, 32, "both", torch.bfloat16, "mma"),  # triangle, 256
    ((1, 512), 256, 8, 8, "both", torch.bfloat16, "mma"),
    ((1, 128), 256, 8, 32, "both", torch.bfloat16, "mma"),  # MSA row
    ((1, 64), 250, 4, 32, "both", torch.bfloat16, "mma"),   # ragged S
    ((1, 256), 256, 4, 32, "none", torch.bfloat16, "mma"),
    ((1, 256), 256, 4, 32, "masked", torch.bfloat16, "mma"),
    ((2, 3), 70, 2, 24, "both", torch.float16, "mma"),      # d 24 -> 32
    ((1, 4), 130, 2, 128, "both", torch.bfloat16, "mma"),
    ((3,), 64, 4, 16, "pair", torch.bfloat16, "mma"),       # [H, S, S] bias
    ((1, 8), 96, 4, 32, "fp32_mask", torch.bfloat16, "mma"),
    ((1, 64), 256, 4, 32, "masked", torch.float32, "simt"),
    ((2, 3), 70, 2, 24, "three", torch.bfloat16, "mma"),
    ((1, 4), 100, 2, 12, "both", torch.bfloat16, "simt"),
    ((1, 4), 66, 2, 160, "both", torch.float16, "simt"),
    # chip_smoke.py phase 22's cases since the tensor-core kernel's redesign
    ((1, 384), 384, 4, 32, "both", torch.bfloat16, "mma"),  # triangle, 384
    ((1, 128), 256, 8, 32, "eight", torch.bfloat16, "mma"),
    ((1, 256), 256, 4, 32, "fp32_mask", torch.bfloat16, "mma"),
    ((1, 256), 256, 4, 32, "both", torch.float16, "mma"),
    ((1, 128), 256, 8, 64, "both", torch.bfloat16, "mma"),
    ((1, 64), 256, 4, 128, "both", torch.bfloat16, "mma"),
    ((1, 8), 96, 2, 32, "views", torch.bfloat16, "mma"),  # the lanes' fp32 sums
]


def _evo_inputs(gen, dev, lead, s, h, d, biases, dtype):
    """Q/K/V and biases: "both" the mask bias (-1e9 on masked keys; "masked":
    every key of 16 rows masked; "fp32_mask": the mask in fp32) and the pair
    bias, "three" both and a per-row bias, "eight" those three and a scalar
    (fp32), a per-head value, a per-head key bias (fp16), a tile full in the
    last lead dim and a pair bias in fp32, "pair" a [H, S, S] bias alone,
    "views" a mask 2 bytes off 4-byte alignment and a pair bias read through
    transposed keys (neither cp.async nor TMA can copy them: the producer's
    lanes read and sum them in fp32)."""
    q, k, v = (torch.randn(lead + (s, h, d), generator=gen, device=dev,
                           dtype=dtype) for _ in range(3))
    if biases == "none":
        return q, k, v, []
    pair = torch.randn(lead[:-1] + (1, h, s, s), generator=gen, device=dev,
                       dtype=dtype)
    if biases == "pair":
        return q, k, v, [pair[0]]
    if biases == "views":
        keys = torch.randn(lead + (s + 1,), generator=gen, device=dev,
                           dtype=dtype)[..., 1:]
        pair_t = torch.randn(lead[:-1] + (1, h, s, s), generator=gen,
                             device=dev, dtype=dtype).transpose(-1, -2)
        return q, k, v, [keys[..., None, None, :], pair_t]
    keep = torch.randint(0, 2, lead + (s,), generator=gen, device=dev)
    if biases == "masked":
        keep[..., :16, :] = 0                    # every key of 16 rows
    mask = (1e9 * (keep - 1)).to(
        torch.float32 if biases == "fp32_mask" else dtype)[..., None, None, :]
    if biases in ("three", "eight"):
        row = torch.randn(lead + (h, s, 1), generator=gen, device=dev,
                          dtype=dtype)
        if biases == "three":
            return q, k, v, [mask, pair, row]

        def rand(shape, t=dtype):
            return torch.randn(shape, generator=gen, device=dev, dtype=t)

        return q, k, v, [mask, pair, row, rand((1,), torch.float32),
                         rand((h, 1, 1)),
                         rand(lead[:-1] + (1, h, 1, s), torch.float16),
                         rand(lead + (1, s, s)),
                         rand(lead[:-1] + (1, h, s, s), torch.float32)]
    return q, k, v, [mask, pair]


def _evo_errors(dev, lead, s, h, d, biases, dtype, seed=0):
    """The kernel route against the plain version on the same inputs:
    forward (max abs, norm), the last bias's and Q/K/V's gradients in norm,
    and the launches of the forward call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, bs = _evo_inputs(gen, dev, lead, s, h, d, biases, dtype)
    before = dict(tevo.LAUNCHES)
    with torch.no_grad():
        got = tevo.DS4Sci_EvoformerAttention(q, k, v, bs)
    fwd_launches = {n: c - before[n] for n, c in tevo.LAUNCHES.items()}
    want = tevo.evoformer_attention_dense(q, k, v, bs)
    out = {"max": (got.float() - want.float()).abs().max().item(),
           "norm": _norm_rel(got, want), "fwd_launches": fwd_launches}
    w = torch.randn(q.shape, generator=gen, device=dev)
    grads = []
    for fn in (tevo.DS4Sci_EvoformerAttention,
               tevo.evoformer_attention_dense):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, *bs[-1:])]
        args = list(bs[:-1]) + leaves[3:]
        (fn(*leaves[:3], args).float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    out["grads"] = [_norm_rel(a, b) for a, b in zip(*grads)]
    return out


_EVO_KEY = {"mma": "evoformer_attention", "simt": "evoformer_attention_simt"}


@pytest.mark.cuda
@pytest.mark.parametrize("lead,s,h,d,biases,dtype,route", _EVO_CASES)
def test_evoformer_kernel(cuda_device, lead, s, h, d, biases, dtype, route):
    """chip_smoke.py phase 22's shapes and bars, more head dims, fp32, three
    and eight biases and an fp32 mask on bf16 inputs: one launch of the
    routed kernel a forward call, none of the other (fp32: within
    EVO_FP32_TOL)."""
    e = _evo_errors(cuda_device, lead, s, h, d, biases, dtype)
    assert e["fwd_launches"] == {key: int(r == route)
                                 for r, key in _EVO_KEY.items()}
    tol = EVO_FP32_TOL if dtype == torch.float32 else TOL
    assert e["max"] <= tol and e["norm"] <= NORM_TOL, e
    assert all(g <= EVO_GRAD_NORM_TOL for g in e["grads"]), e


@pytest.mark.cuda
def test_evoformer_refusals_and_fp16_masked_rows(cuda_device):
    """What neither kernel takes raises NotImplementedError (nothing runs
    the dense version on the card); a mixed-device call raises ValueError.
    An fp16 mask bias of -1e9 is -inf: a row with every key masked comes
    out as zeros from both kernels, where the dense softmax gives NaN."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, bs = _evo_inputs(gen, cuda_device, (1, 2), 64, 2, 16, "both",
                              torch.float16)
    before = dict(tevo.LAUNCHES)
    for args in ((q, k.float(), v, []), (q, k, v, [bs[1]] * 9),
                 (q.double(), k.double(), v.double(), [])):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            tevo.DS4Sci_EvoformerAttention(*args[:3], args[3])
    wide = torch.zeros((1, 2, 8, 2, 264), device=cuda_device)
    with pytest.raises(NotImplementedError, match="D <= 256"):
        tevo.DS4Sci_EvoformerAttention(wide, wide, wide)
    with pytest.raises(ValueError, match="CUDA"):
        tevo.DS4Sci_EvoformerAttention(q, k, v, [bs[0].cpu()])
    assert tevo.LAUNCHES == before
    mask = torch.full_like(bs[0], -1e9, dtype=torch.float32).half()  # -inf
    assert torch.isinf(mask).all()
    for d, route in ((16, "mma"), (12, "simt")):
        args = (q[..., :d], k[..., :d], v[..., :d], [mask, bs[1]])
        got = tevo.DS4Sci_EvoformerAttention(*args[:3], args[3])
        assert tevo.kernel_route(*args[:3], args[3]) == route
        assert torch.equal(got, torch.zeros_like(got))
        assert torch.isnan(tevo.evoformer_attention_dense(
            *args[:3], args[3])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("biases", ["both", "eight", "none"])
def test_evoformer_kernel_is_bit_reproducible(cuda_device, biases):
    """Two runs of the tensor-core kernel on the same inputs give the same
    bits: every sum runs in a fixed order, without atomics."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, bs = _evo_inputs(gen, cuda_device, (1, 64), 250, 4, 32, biases,
                              torch.bfloat16)
    assert tevo.kernel_route(q, k, v, bs) == "mma"
    runs = [tevo.evoformer_attention_kernel(q, k, v, bs) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_evoformer_no_keys_gives_zeros(cuda_device):
    """Sk = 0: every row sees no key and comes out as zeros (the kernels'
    rule for a row with nothing to attend to), with no launch."""
    q = torch.randn((1, 2, 16, 2, 32), device=cuda_device,
                    dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 0, 2, 32), device=cuda_device,
                     dtype=torch.bfloat16)
    before = dict(tevo.LAUNCHES)
    got = tevo.DS4Sci_EvoformerAttention(q, kv, kv)
    assert torch.equal(got, torch.zeros_like(q))
    assert tevo.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape,loop", [
    ("mma", ((1, 256), 256, 4, 32, "both", torch.bfloat16),
     ("const int valid = a.sk - c0;",
      "const int valid = c0 + BK >= a.sk ? 0 : a.sk - c0;")),
    ("simt", ((1, 64), 256, 4, 32, "both", torch.float32),
     ("const int steps = cdiv(a.sk, BK);",
      "const int steps = cdiv(a.sk, BK) - 1;")),
])
def test_evoformer_norm_bar_catches_planted_dropped_tile(
        cuda_device, tmp_path, monkeypatch, route, shape, loop):
    """A copy of csrc/evoformer_attn.cu whose blocks drop the last k tile
    (the softmax step both kernels share: its scores set to -inf; the
    general kernel: its step loop stops short) misses the norm bar at the
    triangle shape; as built it meets it."""
    built = _evo_errors(cuda_device, *shape)
    monkeypatch.setitem(_build._LIBS, "evoformer_attn", _planted(
        tmp_path, "evoformer_attn", (loop,)))
    tevo._kernel.cache_clear()
    try:
        planted = _evo_errors(cuda_device, *shape)
    finally:
        tevo._kernel.cache_clear()
    print(f"evoformer {route} built: max {built['max']:.3g} norm "
          f"{built['norm']:.3g}; planted dropped tile: max "
          f"{planted['max']:.3g} norm {planted['norm']:.3g}")
    assert built["fwd_launches"][_EVO_KEY[route]] == 1
    assert built["norm"] <= NORM_TOL
    assert planted["norm"] > NORM_TOL


#: the general kernel (3xTF32 on mma.sync): chip_smoke.py phase 22's fp32
#: triangle and MSA row, bf16 at D = 12 and D = 160, fp32 with 0, 1, 3 and
#: 8 biases and with the views cp.async cannot copy
_EVO_GENERAL = [
    ((1, 256), 256, 4, 32, "both", torch.float32),
    ((1, 128), 256, 8, 32, "both", torch.float32),
    ((1, 16), 100, 2, 12, "both", torch.bfloat16),
    ((1, 8), 70, 2, 160, "both", torch.bfloat16),
    ((2, 3), 70, 2, 40, "none", torch.float32),
    ((2, 3), 70, 2, 24, "pair", torch.float32),
    ((2, 3), 70, 2, 24, "three", torch.float32),
    ((1, 8), 96, 4, 32, "eight", torch.float32),
    ((1, 8), 96, 2, 32, "views", torch.float32),
    ((1, 4), 66, 2, 256, "three", torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lead,s,h,d,biases,dtype", _EVO_GENERAL)
def test_evoformer_general_kernel(cuda_device, lead, s, h, d, biases, dtype):
    """The general kernel against the dense version (fp32 within
    EVO_FP32_TOL, bf16 within 3e-2 max and 1e-2 in norm), one launch of
    it and none of the tensor-core kernel, two runs bit-equal (every sum
    in a fixed order), and its launch shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v, bs = _evo_inputs(gen, cuda_device, lead, s, h, d, biases, dtype)
    assert tevo.kernel_route(q, k, v, bs) == "simt"
    before = dict(tevo.LAUNCHES)
    runs = [tevo.evoformer_attention_kernel(q, k, v, bs) for _ in range(2)]
    info = tevo.launch_info()
    assert {n: c - before[n] for n, c in tevo.LAUNCHES.items()} == {
        "evoformer_attention": 0, "evoformer_attention_simt": 2}
    want = tevo.evoformer_attention_dense(q, k, v, bs)
    err = (runs[0].float() - want.float()).abs().max().item()
    print(f"evoformer general {lead} {s} {h} {d} {biases} {dtype}: max "
          f"{err:.3g} norm {_norm_rel(runs[0], want):.3g}; {info}")
    assert torch.equal(runs[0], runs[1])
    assert err <= (EVO_FP32_TOL if dtype == torch.float32 else TOL)
    assert _norm_rel(runs[0], want) <= NORM_TOL
    assert info["block_rows"] == tevo.general_walk(d, dtype)[0]
    assert info["spill_bytes"] == 0


# --------------------------------------------------------------------- #
# Block-sparse attention (B11)
# --------------------------------------------------------------------- #
#: (layout, heads, S, D, block, type, per-head layouts): the CPU parity
#: tests' shapes (h 2, s 256, d 32, block 16; S = 1040: a tail tile), one
#: BERT-width shape, fp32 (the split-TF32 kernels), D = 128, blocks 32 / 64
#: / 128
_BSA_CASES = [
    ("bigbird", 2, 256, 32, 16, torch.bfloat16, False),
    ("fixed_uni", 2, 1040, 32, 16, torch.bfloat16, False),
    ("bslongformer", 12, 4096, 64, 16, torch.bfloat16, False),
    ("bigbird", 12, 1024, 64, 16, torch.float16, True),
    ("fixed", 2, 1040, 64, 16, torch.float32, False),
    ("variable", 2, 512, 128, 32, torch.bfloat16, True),
    ("dense", 4, 512, 40, 64, torch.bfloat16, False),
    ("bslongformer", 2, 1024, 128, 128, torch.float32, False),
]


def _bsa_layout(name, h, s, block, per_head):
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    kw = {"fixed": ("FixedSparsityConfig", {}),
          "fixed_uni": ("FixedSparsityConfig",
                        {"attention": "unidirectional"}),
          "bigbird": ("BigBirdSparsityConfig", {}),
          "bslongformer": ("BSLongformerSparsityConfig", {}),
          "variable": ("VariableSparsityConfig", {"num_random_blocks": 1}),
          "dense": ("DenseSparsityConfig", {})}[name]
    cfg = getattr(tsa, kw[0])(h, block, different_layout_per_head=per_head,
                              **kw[1])
    return cfg.make_layout(s)


def _bsa_run(fn, q, k, v, do, bsl):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, bsl)
    out.backward(do)
    torch.cuda.synchronize()
    return out.detach(), [t.grad for t in leaves]


def _bsa_errors(got, want):
    (o, gs), (ro, rgs) = got, want
    return ((o.float() - ro.float()).abs().max().item(),
            [_norm_rel(a, b) for a, b in zip([o] + gs, [ro] + rgs)])


def _fp32_grad_bar(got, want):
    """chip_smoke.py's fp32 gradient bar (``BSA_FP32_GRAD_TOL`` on max |got
    - plain| / max(1, max |plain|) of dq, dk and dv): (its readings,
    whether every one meets it)."""
    smoke = _load_chip_smoke()
    errs = smoke.fp32_grad_errs(got, want)
    return errs, max(errs.values()) <= smoke.BSA_FP32_GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("layout,h,s,d,block,dtype,per_head", _BSA_CASES)
def test_block_sparse_attention_kernels(cuda_device, layout, h, s, d, block,
                                        dtype, per_head):
    """Forward, dQ and dK/dV against the plain versions: bf16 / fp16 within
    3e-2 max and 1e-2 in norm forward, 5e-2 in norm for the gradients; fp32
    (the split-TF32 kernels) within 1e-4 forward and 1e-4 of the fp32
    gradient bar on dq, dk and dv; one launch of each a call."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa

    bsl = tbsa.BlockSparseLayout(_bsa_layout(layout, h, s, block, per_head),
                                 block, s)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + block)
    q, k, v, do = (torch.randn((2, h, s, d), generator=gen,
                               device=cuda_device, dtype=dtype)
                   for _ in range(4))
    before = dict(tbsa.LAUNCHES)
    got = _bsa_run(tbsa.block_sparse_attention, q, k, v, do, bsl)
    assert {key: tbsa.LAUNCHES[key] - before[key] for key in before} == \
        dict.fromkeys(before, 1)
    want = _bsa_run(tbsa.block_sparse_attention_reference, q, k, v, do, bsl)
    assert tbsa.LAUNCHES["block_sparse_attention_fwd"] == \
        before["block_sparse_attention_fwd"] + 1
    max_err, norms = _bsa_errors(got, want)
    if dtype == torch.float32:
        gerr, ok = _fp32_grad_bar(got[1], want[1])
        assert max_err <= 1e-4, (max_err, norms)
        assert ok, gerr
    else:
        assert max_err <= TOL and norms[0] <= NORM_TOL, (max_err, norms)
        assert all(n <= 5e-2 for n in norms[1:]), norms


@pytest.mark.cuda
@pytest.mark.parametrize("layout,s,d,dtype,mode", [
    ("bigbird", 1040, 64, torch.bfloat16, "mul"),
    ("bslongformer", 4096, 64, torch.bfloat16, "add"),
    ("fixed", 512, 128, torch.float16, "mul"),
    ("fixed", 1040, 64, torch.float32, "mul"),
    ("bigbird", 512, 48, torch.float32, "add"),
])
def test_block_sparse_key_padding(cuda_device, layout, s, d, dtype, mode):
    """A key-padding mask through the kernels (the key bias): forward, dQ
    and dK/dV against the plain versions under the same bias, at the bars
    of test_block_sparse_attention_kernels; the forward also against the
    dense composition under the mask; one launch of each a call."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    h, block = 4, 16
    lay = _bsa_layout(layout, h, s, block, False)
    bsl = tbsa.BlockSparseLayout(lay, block, s)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v, do = (torch.randn((3, h, s, d), generator=gen,
                               device=cuda_device, dtype=dtype)
                   for _ in range(4))
    valid = torch.arange(s, device=cuda_device)[None] < torch.tensor(
        [[s], [s * 3 // 4 - 7], [s // 4 + 1]], device=cuda_device)
    kpm = valid.float() if mode == "mul" else torch.where(valid, 0.0,
                                                          -10000.0)
    bias = tsa.key_padding_bias(kpm, mode)
    before = dict(tbsa.LAUNCHES)
    got = _bsa_run(lambda *a: tbsa.block_sparse_attention(*a, key_bias=bias),
                   q, k, v, do, bsl)
    assert {key: tbsa.LAUNCHES[key] - before[key] for key in before} == \
        dict.fromkeys(before, 1)
    want = _bsa_run(lambda *a: tbsa.block_sparse_attention_reference(
        *a, key_bias=bias), q, k, v, do, bsl)
    with torch.no_grad():
        dense = tsa.sparse_self_attention(q, k, v, lay, block,
                                          key_padding_mask=kpm,
                                          key_padding_mask_mode=mode)
    max_err, norms = _bsa_errors(got, want)
    dense_err = (got[0].float() - dense.float()).abs().max().item()
    if dtype == torch.float32:
        assert max_err <= 1e-4 and dense_err <= 1e-4, (max_err, dense_err)
    else:
        assert max_err <= TOL and norms[0] <= NORM_TOL, (max_err, norms)
        assert dense_err <= TOL and _norm_rel(got[0], dense) <= NORM_TOL
        assert all(n <= 5e-2 for n in norms[1:]), norms
    # padded keys get no gradient
    assert not got[1][2][1, :, s * 3 // 4 - 7:].any()


@pytest.mark.cuda
def test_block_sparse_empty_rows_and_refusals(cuda_device):
    """A row that keeps no key gives zeros (and lse -1e30) on the card; what
    the kernels do not take raises, and a CUDA tensor never reaches the
    plain version."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa

    layout = np.ones((2, 16, 16), bool)
    layout[1, 3] = False                          # rows 48..63 of head 1
    bsl = tbsa.BlockSparseLayout(layout, 16, 256)
    q, k, v = (torch.randn((1, 2, 256, 64), device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    o, lse = tbsa.block_sparse_attention_fwd(q, k, v, bsl)
    assert not o[0, 1, 48:64].any() and (lse[0, 1, 48:64] == -1e30).all()
    assert o[0, 0, 48:64].abs().sum() > 0
    for bad in (q.to(torch.float64), q[..., :12].contiguous()):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            tbsa.block_sparse_attention(bad, bad, bad, bsl)
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        tbsa.block_sparse_attention(q, k, v, tbsa.BlockSparseLayout(
            np.ones((2, 32, 32), bool), 8, 256))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbsa.block_sparse_attention_fwd(q, k.cpu(), v, bsl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_bars_catch_planted_dropped_tile(cuda_device, dtype):
    """chip_smoke.py phase 23's planted faults: query-major lists that drop
    the last live key tile of every query tile must miss the forward's
    bars; key-major lists that drop the last live query tile of every key
    tile must leave the forward and dQ whole and put dK and dV past the
    5e-2 gradient bar.  The kernels walk only the listed tiles."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa

    s = 1024
    bsl = tbsa.BlockSparseLayout(_bsa_layout("bigbird", 4, s, 16, True), 16,
                                 s)
    smoke = _load_chip_smoke()
    bad, bad_k = (smoke.bsa_planted_fault(np, bsl, side)
                  for side in ("q", "k"))
    q, k, v, do = (torch.randn((2, 4, s, 64), device=cuda_device,
                               dtype=dtype) for _ in range(4))
    want = _bsa_run(tbsa.block_sparse_attention_reference, q, k, v, do, bsl)
    good = _bsa_run(tbsa.block_sparse_attention, q, k, v, do, bsl)
    assert all(n <= 5e-2 for n in _bsa_errors(good, want)[1])
    with torch.no_grad():
        got = tbsa.block_sparse_attention(q, k, v, bad)
    err = (got.float() - want[0].float()).abs().max().item()
    print(f"block-sparse planted dropped tile ({dtype}): max {err:.3g} "
          f"norm {_norm_rel(got, want[0]):.3g}")
    assert err > TOL and _norm_rel(got, want[0]) > NORM_TOL
    _, norms = _bsa_errors(_bsa_run(tbsa.block_sparse_attention, q, k, v, do,
                                    bad_k), want)
    print(f"block-sparse planted key-major drop ({dtype}): o, dq, dk, dv "
          f"norm {[float(f'{n:.3g}') for n in norms]}")
    assert norms[0] <= NORM_TOL and norms[1] <= 5e-2
    assert norms[2] > 5e-2 and norms[3] > 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s,d,dtype,mode", [
    # one 64-long global-column list a head against lists of ~3 stages:
    # the split rule cuts it into parts whose partials combine
    ("variable", 2, 2, 4096, 64, torch.bfloat16, None),
    ("bigbird", 1, 6, 4096, 128, torch.bfloat16, "mul"),
    ("fixed", 3, 4, 1040, 64, torch.float16, "add"),
])
def test_block_sparse_backward_walk_on_the_card(cuda_device, layout, b, h, s,
                                                d, dtype, mode):
    """The wgmma dQ and dK/dV kernels against the plain versions within the
    5e-2 gradient bar, two runs bit-equal, at a split global-column list,
    at D = 128 (dK/dV 32 query rows a step) and under key biases; each
    launch reports its walk (``launch_info``)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    bsl = tbsa.BlockSparseLayout(_bsa_layout(layout, h, s, 16, False), 16, s)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + b)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                               device=cuda_device, dtype=dtype)
                   for _ in range(4))
    bias = None
    if mode is not None:
        kpm = (torch.arange(s, device=cuda_device)[None]
               < torch.tensor([[s - 40 * i - 3] for i in range(b)],
                              device=cuda_device))
        bias = tsa.key_padding_bias(
            kpm.float() if mode == "mul" else torch.where(kpm, 0.0, -1e4),
            mode)
    scale = d ** -0.5
    qs = (q.float() * scale).to(dtype)
    o, lse = tbsa.block_sparse_attention_fwd(qs, k, v, bsl, bias)
    runs, infos = [], []
    for _ in range(2):
        dq, delta = tbsa.block_sparse_attention_bwd_dq(qs, k, v, o, lse, do,
                                                       bsl, scale, bias)
        infos.append(tbsa.launch_info())
        runs.append((dq, delta) + tbsa.block_sparse_attention_bwd_dkv(
            qs, k, v, do, lse, delta, bsl, bias))
        infos.append(tbsa.launch_info())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    keep = bsl.element_mask(cuda_device)
    rdq, rdelta = tbsa.block_sparse_plain_bwd_dq(qs, k, v, o, lse, do, keep,
                                                 scale, bias)
    rdk, rdv = tbsa.block_sparse_plain_bwd_dkv(qs, k, v, do, lse, rdelta,
                                               keep, bias)
    norms = [_norm_rel(x, y) for x, y in zip(
        (runs[0][0], runs[0][2], runs[0][3]), (rdq, rdk, rdv))]
    print(f"block-sparse walk {layout} D{d}: dq, dk, dv norm "
          f"{[float(f'{n:.3g}') for n in norms]}; dQ {infos[0]}; "
          f"dK/dV {infos[1]}")
    assert all(n <= 5e-2 for n in norms), norms
    assert (runs[0][1] - rdelta).abs().max() <= 1e-3
    assert [i["kernel"] for i in infos[:2]] == ["dq", "dkv"]
    assert infos[1]["step_rows"] == (32 if d > 64 else 64)
    assert all(i["spill_bytes"] <= 128 for i in infos)
    if layout == "variable":
        # the global column's list is cut into parts of a few stages
        assert infos[1]["split_groups"] == h
        assert infos[1]["max_stages"] < 64 // 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s,d,dtype,mode", [
    ("fixed", 2, 4, 4096, 64, torch.bfloat16, None),
    ("bigbird", 1, 6, 1024, 128, torch.bfloat16, "mul"),
    ("variable", 3, 2, 1040, 32, torch.float16, "add"),
    ("dense", 1, 2, 512, 16, torch.bfloat16, None),
])
def test_block_sparse_forward_walk_on_the_card(cuda_device, monkeypatch,
                                               layout, b, h, s, d, dtype,
                                               mode):
    """The wgmma forward against the plain version within the forward's
    bars, two runs bit-equal, under the split rule and with every list
    split into parts of two stages (``SPLIT_MIN`` / ``WAVE`` set so, the
    tables built afresh): the parts' partials merge to the same bars and
    the same bits twice; lse within 1e-3 of the plain version's."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    lay = _bsa_layout(layout, h, s, 16, False)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + b)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device,
                           dtype=dtype) for _ in range(3))
    bias = None
    if mode is not None:
        kpm = (torch.arange(s, device=cuda_device)[None]
               < torch.tensor([[s - 37 * i - 5] for i in range(b)],
                              device=cuda_device))
        bias = tsa.key_padding_bias(
            kpm.float() if mode == "mul" else torch.where(kpm, 0.0, -1e4),
            mode)
    qs = (q.float() * d ** -0.5).to(dtype)
    ro, rlse = tbsa.block_sparse_plain_fwd(
        qs, k, v, tbsa.BlockSparseLayout(lay, 16, s).element_mask(
            cuda_device), bias)
    for split in (False, True):
        if split:
            monkeypatch.setattr(tbsa, "SPLIT_MIN", 2)
            monkeypatch.setattr(tbsa, "WAVE", 1 << 40)
        bsl = tbsa.BlockSparseLayout(lay, 16, s)
        before = tbsa.LAUNCHES["block_sparse_attention_fwd"]
        runs = [tbsa.block_sparse_attention_fwd(qs, k, v, bsl, bias)
                for _ in range(2)]
        info = tbsa.launch_info()
        torch.cuda.synchronize()
        assert tbsa.LAUNCHES["block_sparse_attention_fwd"] == before + 2
        err = (runs[0][0].float() - ro.float()).abs().max().item()
        print(f"block-sparse fwd {layout} D{d} split {split}: max {err:.3g} "
              f"norm {_norm_rel(runs[0][0], ro):.3g}; {info}")
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        assert err <= TOL and _norm_rel(runs[0][0], ro) <= NORM_TOL
        assert (runs[0][1] - rlse).abs().max() <= 1e-3
        assert info["kernel"] == "fwd" and info["spill_bytes"] <= 128
        if split:
            assert info["split_groups"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s,d,mode", [
    ("bslongformer", 4, 12, 4096, 64, None),
    ("fixed", 4, 12, 1040, 64, "mul"),
    ("bslongformer", 2, 12, 1040, 20, None),
    ("bigbird", 1, 6, 1024, 128, "add"),
    ("fixed_uni", 2, 4, 512, 37, None),
    ("dense", 1, 2, 512, 16, "mul"),
])
def test_block_sparse_fp32_forward_on_the_card(cuda_device, monkeypatch,
                                               layout, b, h, s, d, mode):
    """The fp32 forward (split TF32 on the slice walk) against the plain
    fp32 forward within 1e-4 (o and lse), two runs bit-equal, under the
    split rule and with every list split into parts of two stages; one
    launch a call, at most 128 bytes of spill."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    lay = _bsa_layout(layout, h, s, 16, False)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + b + 1)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device)
               for _ in range(3))
    bias = None
    if mode is not None:
        kpm = (torch.arange(s, device=cuda_device)[None]
               < torch.tensor([[s - 37 * i - 5] for i in range(b)],
                              device=cuda_device))
        bias = tsa.key_padding_bias(
            kpm.float() if mode == "mul" else torch.where(kpm, 0.0, -1e4),
            mode)
    qs = q * d ** -0.5
    ro, rlse = tbsa.block_sparse_plain_fwd(
        qs, k, v, tbsa.BlockSparseLayout(lay, 16, s).element_mask(
            cuda_device), bias)
    for split in (False, True):
        if split:
            monkeypatch.setattr(tbsa, "SPLIT_MIN", 2)
            monkeypatch.setattr(tbsa, "WAVE", 1 << 40)
        bsl = tbsa.BlockSparseLayout(lay, 16, s)
        before = tbsa.LAUNCHES["block_sparse_attention_fwd"]
        runs = [tbsa.block_sparse_attention_fwd(qs, k, v, bsl, bias)
                for _ in range(2)]
        info = tbsa.launch_info()
        torch.cuda.synchronize()
        assert tbsa.LAUNCHES["block_sparse_attention_fwd"] == before + 2
        err = (runs[0][0] - ro).abs().max().item()
        lse_err = (runs[0][1] - rlse).abs().max().item()
        print(f"block-sparse fp32 fwd {layout} D{d} split {split}: max "
              f"{err:.3g}, lse {lse_err:.3g}; {info}")
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        assert err <= 1e-4 and lse_err <= 1e-4
        assert info["kernel"] == "fwd" and info["spill_bytes"] <= 128
        if split:
            assert info["split_groups"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout,b,h,s,d,mode", [
    ("bslongformer", 4, 12, 4096, 64, None),
    ("fixed", 4, 12, 1040, 64, "mul"),
    ("bslongformer", 2, 12, 1040, 20, None),
    ("bigbird", 1, 6, 1024, 128, "add"),
    ("variable", 2, 2, 4096, 64, None),
    ("fixed_uni", 2, 4, 512, 37, "mul"),
    ("dense", 1, 2, 512, 16, None),
])
def test_block_sparse_fp32_backward_on_the_card(cuda_device, monkeypatch,
                                                layout, b, h, s, d, mode):
    """The fp32 dQ and dK/dV (split TF32 on the fp32 walks) against the
    plain fp32 backward within the fp32 gradient bar (1e-4 of max(1, max
    |plain|)) and delta within 1e-5, two runs bit-equal, under the split
    rule and with every list split into parts of two stages; one launch of
    each a call, no spill."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    lay = _bsa_layout(layout, h, s, 16, False)
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + b + 2)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                               device=cuda_device) for _ in range(4))
    bias = None
    if mode is not None:
        kpm = (torch.arange(s, device=cuda_device)[None]
               < torch.tensor([[s - 37 * i - 5] for i in range(b)],
                              device=cuda_device))
        bias = tsa.key_padding_bias(
            kpm.float() if mode == "mul" else torch.where(kpm, 0.0, -1e4),
            mode)
    scale = d ** -0.5
    qs = q * scale
    keep = tbsa.BlockSparseLayout(lay, 16, s).element_mask(cuda_device)
    o, lse = tbsa.block_sparse_plain_fwd(qs, k, v, keep, bias)
    rdq, rdelta = tbsa.block_sparse_plain_bwd_dq(qs, k, v, o, lse, do, keep,
                                                 scale, bias)
    want = (rdq,) + tbsa.block_sparse_plain_bwd_dkv(qs, k, v, do, lse, rdelta,
                                                    keep, bias)
    for split in (False, True):
        if split:
            monkeypatch.setattr(tbsa, "SPLIT_MIN", 2)
            monkeypatch.setattr(tbsa, "WAVE", 1 << 40)
        bsl = tbsa.BlockSparseLayout(lay, 16, s)
        before = dict(tbsa.LAUNCHES)
        runs, infos = [], []
        for _ in range(2):
            dq, delta = tbsa.block_sparse_attention_bwd_dq(
                qs, k, v, o, lse, do, bsl, scale, bias)
            infos.append(tbsa.launch_info())
            runs.append((dq, delta) + tbsa.block_sparse_attention_bwd_dkv(
                qs, k, v, do, lse, delta, bsl, bias))
            infos.append(tbsa.launch_info())
        torch.cuda.synchronize()
        assert {key: tbsa.LAUNCHES[key] - before[key] for key in before} \
            == {"block_sparse_attention_fwd": 0,
                "block_sparse_attention_bwd_dq": 2,
                "block_sparse_attention_bwd_dkv": 2}
        gerr, ok = _fp32_grad_bar((runs[0][0], runs[0][2], runs[0][3]),
                                  want)
        derr = (runs[0][1] - rdelta).abs().max().item()
        print(f"block-sparse fp32 bwd {layout} D{d} split {split}: {gerr} "
              f"delta {derr:.3g}; dQ {infos[0]}; dK/dV {infos[1]}")
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        assert ok, gerr
        assert derr <= 1e-5
        assert [i["kernel"] for i in infos[:2]] == ["dq", "dkv"]
        assert all(i["spill_bytes"] == 0 for i in infos), infos
        if split:
            assert infos[0]["split_groups"] > 0
            assert infos[1]["split_groups"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_block_sparse_backward_first_on_the_autograd_thread(cuda_device,
                                                            dtype):
    """In a fresh process whose first CUDA work on PyTorch's autograd thread
    is the block-sparse backward, dQ runs there: bf16 encodes its tensor
    maps on that thread before any runtime call there (the encode binds the
    context itself; it once failed there with error 1), fp32 launches the
    split-TF32 kernels there."""
    import sys
    from pathlib import Path

    code = (
        "import numpy as np, torch\n"
        "from deepspeed_tpu_torch.ops import block_sparse_attention as b\n"
        "bsl = b.BlockSparseLayout(np.ones((2, 16, 16), bool), 16, 256)\n"
        "q, k, v = (torch.randn((2, 2, 256, 32), device='cuda', "
        f"dtype={dtype}, requires_grad=True) for _ in range(3))\n"
        "out = b.block_sparse_attention(q, k, v, bsl)\n"
        "out.backward(torch.randn_like(out))\n"
        "torch.cuda.synchronize()\n"
        "assert q.grad.isfinite().all()\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1])
    assert run.returncode == 0 and "ok" in run.stdout, run.stderr[-3000:]


@pytest.mark.cuda
def test_sparse_self_attention_routes_on_the_card(cuda_device):
    """"auto" and "pallas" launch the kernels, with a key-padding mask too
    (its key bias); only "xla" takes the counted dense composition."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as tbsa
    from deepspeed_tpu_torch.ops import sparse_attention as tsa

    cfg = tsa.FixedSparsityConfig(12, 16)
    q, k, v = (torch.randn((2, 12, 512, 64), device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    kpm = torch.ones((2, 512), device=cuda_device)
    kpm[1, 300:] = 0
    launches = tbsa.LAUNCHES["block_sparse_attention_fwd"]
    dense = tsa.LAUNCHES["sparse_self_attention_dense"]
    auto = tsa.SparseSelfAttention(cfg)
    auto(q, k, v)
    masked = auto(q, k, v, key_padding_mask=kpm)
    pallas = tsa.SparseSelfAttention(cfg, implementation="pallas")(
        q, k, v, key_padding_mask=kpm)
    assert tbsa.LAUNCHES["block_sparse_attention_fwd"] == launches + 3
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense
    xla = tsa.SparseSelfAttention(cfg, implementation="xla")(
        q, k, v, key_padding_mask=kpm)
    assert tsa.LAUNCHES["sparse_self_attention_dense"] == dense + 1
    assert torch.equal(masked, pallas)
    assert _norm_rel(masked, xla) <= NORM_TOL
