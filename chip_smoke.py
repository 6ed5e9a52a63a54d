#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the serving path, from the sources in this
   checkout, one ``nvcc`` per source, all at once;
3. kernels against their plain PyTorch versions on the card, in bf16 at the
   serving path's shapes (max abs error <= 3e-2), each timed with CUDA
   events beside its plain version, one PyTorch library call computing the
   same function (a yardstick only; the port never calls it) and its bound
   (the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s);
4. the serving slice end to end at full Llama-2-7B width and 2 layers,
   through the kernels and through the plain paths on the card: first-step
   logits must agree within 3e-2 of their largest magnitude;
5. the served run: the 32-layer Llama-2-7B geometry with random int8 weights
   and a bf16 KV cache (block 128, token budget 512) answers 8 requests of
   256-token prompts: ``put`` → ``decode_loop`` of 48 tokens → ``flush``.
   Every kernel's launch count is set to 0 just before and must be > 0
   just after.

The second-to-last lines are the ``kernels`` JSON record and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
Without a GPU, or run outside a checkout of the repository, it exits non-zero
and prints no result.  Details of every kernel case go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 3e-2                   # the reference's on-chip kernel tolerance
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12          # H100 SXM dense bf16, NVIDIA data sheet
SEED = 0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


COLD_BYTES = 100e6          # operand sets span twice the 50 MB L2


def n_sets(call_bytes: float) -> int:
    """Operand sets to rotate through so that each call finds its own cold
    in L2 (at most 8)."""
    return max(1, min(8, math.ceil(COLD_BYTES / call_bytes)))


def time_ms(fn, sets: int, iters: int) -> float:
    """Mean device time in ms of ``fn(i)``, which runs one call on operand
    set ``i % sets``.  With the sets spanning more than twice the L2, each
    call reads its operands from device memory, as a served step does (it
    streams 6.6 GB of weights).  A device-side sleep first lets the host
    queue every call ahead of the device, and one pair of CUDA events
    brackets them all, so neither host overhead nor event cost counts."""
    import torch

    for i in range(sets):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)           # ~30 ms of device-side wait
    start.record()
    for i in range(iters):
        fn(i % sets)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------------- #
# Phase 3 cases
# --------------------------------------------------------------------- #
def qmm_cases(torch, gen, dev):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    out = []
    for m in (8, 512):
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                     (4096, 32000)):
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            sets = n_sets(k * n)
            recs = [{"q": torch.randint(-127, 128, (k, n), generator=gen,
                                        device=dev, dtype=torch.int8),
                     "scale": torch.rand((16,), generator=gen, device=dev)
                     / (73.3 * math.sqrt(k))} for _ in range(sets)]
            got = qm.quantized_matmul(x, recs[0])
            want = qm.quantized_matmul_plain(x, recs[0])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            iters = 48 if m == 8 else 16
            nbytes = m * k * 2 + k * n + 16 * 4 + m * n * 2
            b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
            case = {
                "name": f"quantized_matmul[M={m},K={k},N={n}]",
                "kernel": "quantized_matmul",
                "max_abs_err": err,
                "ms": time_ms(lambda i: qm.quantized_matmul(x, recs[i]),
                              sets, iters),
                "plain_ms": time_ms(
                    lambda i: qm.quantized_matmul_plain(x, recs[i]), sets,
                    sets),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            w_bf16 = [qm.dequant_reference(r, torch.bfloat16) for r in recs]
            case["library_ms"] = time_ms(lambda i: torch.matmul(x, w_bf16[i]),
                                         sets, iters)
            out.append(case)
            del x, recs, got, want, w_bf16
    return out


def _attention_inputs(torch, gen, dev, slots, q_pos):
    """Pools of ``slots`` sequences at the served table width (3 blocks of
    128, 7B KV heads, tables scattered over the pool) — as many pool
    copies as keep each call cold in L2 — and query rows at the positions
    ``q_pos[s]`` (a list per slot)."""
    bs, hkv, d = 128, 32, 128
    width = 3                                    # the served table width
    nb = slots * width + 1
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * width]
    tables = (perm + 1).to(torch.int32).reshape(slots, width)
    live = sum(max(p) + 1 for p in q_pos if p)
    pools = [tuple(torch.randn((nb * bs, hkv, d), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(2))
             for _ in range(n_sets(2 * live * hkv * d * 2))]
    slot_ids = [s for s in range(slots) for _ in q_pos[s]]
    pos = [p for s in range(slots) for p in q_pos[s]]
    token_slot = torch.tensor(slot_ids, dtype=torch.int32, device=dev)
    token_pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn((len(pos), 32, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, pools, tables, token_slot, token_pos


def attention_case(torch, name, fn, q, pools, tables, token_slot, token_pos,
                   iters):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.inference.v2.kernels.blocked_flash import (
        paged_attention_plain)

    bs = 128
    sets = len(pools)
    k_pool, v_pool = pools[0]
    got = fn(q, k_pool, v_pool, tables, token_slot, token_pos, block_size=bs)
    want = paged_attention_plain(q, k_pool, v_pool, tables, token_slot,
                                 token_pos, block_size=bs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    t, h, d = q.shape
    hkv = k_pool.shape[1]
    pos = token_pos.tolist()
    slots = token_slot.tolist()
    # bytes: q and out once, each slot's visible K/V rows once
    ctx = {}
    for s, p in zip(slots, pos):
        ctx[s] = max(ctx.get(s, -1), p)
    kv_rows = sum(p + 1 for p in ctx.values())
    nbytes = 2 * t * h * d * 2 + 2 * kv_rows * hkv * d * 2
    flops = sum(4.0 * (p + 1) * h * d for p in pos)
    b_ms, b_by = bound(nbytes, flops)

    # yardstick: SDPA over the gathered per-slot context with a position
    # mask (the gather is outside the timed call)
    width = tables.shape[1]
    c_len = width * bs
    rows = (tables.long()[:, :, None] * bs
            + torch.arange(bs, device=q.device)).reshape(-1, c_len)
    uniq = sorted(ctx)
    per_slot = max(slots.count(s) for s in uniq)
    qs = torch.zeros((len(uniq), h, per_slot, d), dtype=q.dtype,
                     device=q.device)
    mask = torch.zeros((len(uniq), 1, per_slot, c_len), dtype=torch.bool,
                       device=q.device)
    key = torch.arange(c_len, device=q.device)
    for i, s in enumerate(uniq):
        idx = [j for j, ss in enumerate(slots) if ss == s]
        qs[i, :, :len(idx)] = q[idx].transpose(0, 1)
        mask[i, 0, :len(idx)] = key[None, :] <= token_pos[idx].long()[:, None]
        mask[i, 0, len(idx):, 0] = True           # pad rows: see key 0
    gathered = [tuple(p[rows[uniq]].permute(0, 2, 1, 3).contiguous()
                      for p in pair) for pair in pools]
    return {
        "name": name,
        "kernel": fn.__name__,
        "max_abs_err": err,
        "ms": time_ms(lambda i: fn(q, *pools[i], tables, token_slot,
                                   token_pos, block_size=bs), sets, iters),
        "plain_ms": time_ms(lambda i: paged_attention_plain(
            q, *pools[i], tables, token_slot, token_pos, block_size=bs),
            1, 3),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(
            qs, *gathered[i], attn_mask=mask), sets, iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def attention_cases(torch, gen, dev):
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    out = []
    # the served prefill batch: 2 prompts x 256 tokens in the 512 bucket
    args = _attention_inputs(torch, gen, dev, 8,
                             [list(range(256))] * 2 + [[]] * 6)
    out.append(attention_case(torch, "paged_attention[T=512, 2x256 prefill]",
                              bf.paged_attention, *args, iters=16))
    # T = 512 over 8 x 256-token contexts (the last 64 tokens of each)
    args = _attention_inputs(torch, gen, dev, 8,
                             [list(range(192, 256))] * 8)
    out.append(attention_case(torch, "paged_attention[T=512, 8x256 ctx]",
                              bf.paged_attention, *args, iters=16))
    # decode: S = 8 slots, contexts of 257..330 tokens
    dpos = torch.randint(257, 331, (8,), generator=gen, device=dev).tolist()
    args = _attention_inputs(torch, gen, dev, 8, [[p] for p in dpos])
    out.append(attention_case(torch, "paged_decode_attention[S=8, ctx~300]",
                              bf.paged_decode_attention, *args, iters=48))
    return out


# --------------------------------------------------------------------- #
# Phases 4 and 5
# --------------------------------------------------------------------- #
def make_engine(torch, cfg, params, max_ctx, use_kernels):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)

    eng_cfg = RaggedInferenceEngineConfig.from_dict({
        "state_manager": {"max_ragged_batch_size": 512,
                          "max_ragged_sequence_count": 8,
                          "max_context": max_ctx},
        "kv_cache": {"block_size": 128},
    })
    return InferenceEngineV2(RaggedLlama(cfg, 128, use_kernels=use_kernels),
                             params, eng_cfg)


def reset_launches():
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    for counts in (qm.LAUNCHES, bf.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    return {**qm.LAUNCHES, **bf.LAUNCHES}


def slice_kernel_vs_plain(torch, np, prompts):
    """2 layers of the 7B geometry, int8 weights from SEED: the same
    requests through the kernels and through the plain paths."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype=torch.bfloat16)
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    max_ctx = 256 + 8 + 8
    uids = list(range(len(prompts)))
    res = {}
    for mode, use_kernels in (("kernel", True), ("plain", False)):
        eng = make_engine(torch, cfg, params, max_ctx, use_kernels)
        reset_launches()
        first = eng.put(uids, prompts)
        logits = torch.from_numpy(np.stack([first[u] for u in uids]))
        start = [int(first[u].argmax()) for u in uids]
        toks = eng.decode_loop(uids, start, 8)
        eng.flush(uids)
        torch.cuda.synchronize()
        res[mode] = (logits, toks, read_launches())
        del eng
    k_logits, k_toks, k_launch = res["kernel"]
    p_logits, p_toks, p_launch = res["plain"]
    scale = p_logits.abs().max().item()
    err = (k_logits - p_logits).abs().max().item() / scale
    agree = float((k_toks == p_toks).mean())
    first_agree = float((k_logits.argmax(-1) == p_logits.argmax(-1))
                        .float().mean())
    return {"logits_rel_err": err, "first_token_agreement": first_agree,
            "decode_token_agreement": agree, "kernel_launches": k_launch,
            "plain_launches": p_launch,
            "finite": bool(torch.isfinite(k_logits).all())}


def served_run(torch, prompts, gen_tokens=48):
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.models import LlamaConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    t0 = time.perf_counter()
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_ctx = 256 + 1 + gen_tokens + 8
    eng = make_engine(torch, cfg, params, max_ctx, True)
    uids = list(range(len(prompts)))
    # warm: one request of the served size through prefill and decode, so
    # the measured puts find the allocator's buffers already made
    eng.put([100, 101], prompts[:2])
    eng.decode_loop([100, 101], [1, 1], 2)
    eng.flush([100, 101])
    torch.cuda.synchronize()

    reset_launches()
    # all 8 requests arrive at t0; the 512-token budget admits two
    # 256-token prompts per forward, so they are put two at a time and a
    # request's TTFT is the end of the put that returned its logits
    ttft_ms = {}
    first = {}
    t0 = time.perf_counter()
    for i in range(0, len(uids), 2):
        got = eng.put(uids[i:i + 2], prompts[i:i + 2])
        now = (time.perf_counter() - t0) * 1e3
        for u in uids[i:i + 2]:
            ttft_ms[u] = now
            first[u] = got[u]
    finite = all(bool(torch.isfinite(torch.from_numpy(first[u])).all())
                 for u in uids)
    start = [int(first[u].argmax()) for u in uids]
    t1 = time.perf_counter()
    toks = eng.decode_loop(uids, start, gen_tokens)
    decode_s = time.perf_counter() - t1
    eng.flush(uids)
    torch.cuda.synchronize()
    launches = read_launches()
    # where the time goes: a traced prefill put (2 prompts) and 4 decode
    # steps; the tracer's own cost inflates the wall times
    trace = {"prefill": profile_window(
        torch, lambda: eng.put([200, 201], prompts[:2]), 1)}
    trace["decode"] = profile_window(
        torch, lambda: eng.decode_loop([200, 201], start[:2], 4), 4)
    eng.flush([200, 201])
    return {
        "layers": cfg.num_hidden_layers, "requests": len(uids),
        "prompt_len": len(prompts[0]), "gen_tokens": gen_tokens,
        "param_init_s": init_s,
        "ttft_ms": [ttft_ms[u] for u in uids],
        "decode_ms_per_step": decode_s / gen_tokens * 1e3,
        "decode_tokens_per_s": len(uids) * gen_tokens / decode_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "finite": finite,
        "tokens_shape": list(toks.shape),
        "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "trace": trace,
    }


def profile_window(torch, fn, steps):
    """Device busy time (sum of kernel durations on the one stream) against
    host wall time over ``fn``, per step, with the kernels that take the
    most device time; None where the tracer records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy_us = sum(by_name.values())
    if busy_us == 0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "top_kernels_ms_per_step": {k[:70]: v / steps / 1e3
                                        for k, v in top}}


# --------------------------------------------------------------------- #
def main() -> int:
    if not (ROOT / "deepspeed_tpu_torch" / "csrc").is_dir():
        return fail("deepspeed_tpu_torch/ not found beside chip_smoke.py: "
                    "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no GPU")

    # 1. environment
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from deepspeed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall; per source "
          f"{ {k: round(v, 1) for k, v in secs.items()} }", flush=True)
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas {src}] {line.strip()}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = qmm_cases(torch, gen, dev) + attention_cases(torch, gen, dev)
    for c in cases:
        print(f"[kernel] {c['name']}: err {c['max_abs_err']:.3g} "
              f"ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
              f"library {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']})", flush=True)
    bad = [c["name"] for c in cases if not c["max_abs_err"] <= TOL]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")

    # 4. slice end to end: kernels vs plain paths, 2 layers at 7B width
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]
    e2e = slice_kernel_vs_plain(torch, np, prompts)
    print(f"[slice] {json.dumps(e2e)}", flush=True)
    if not e2e["logits_rel_err"] <= TOL or not e2e["finite"]:
        return fail(f"kernel path logits differ from the plain path: "
                    f"{e2e['logits_rel_err']}")
    if any(v == 0 for v in e2e["kernel_launches"].values()) or any(
            e2e["plain_launches"].values()):
        return fail(f"launch counts: kernel path {e2e['kernel_launches']}, "
                    f"plain path {e2e['plain_launches']}")

    # 5. the served run (counts reset just before, read just after)
    served = served_run(torch, prompts)
    print(f"[served] {json.dumps(served)}", flush=True)
    launches = served["launches"]
    if any(v == 0 for v in launches.values()):
        return fail(f"a kernel of the serving path never launched: "
                    f"{launches}")
    if not (served["finite"] and served["tokens_in_vocab"]
            and served["tokens_shape"] == [8, 48]):
        return fail(f"served output malformed: {served}")

    sources = {"quantized_matmul": "deepspeed_tpu_torch/csrc/quantized_matmul.cu",
               "paged_attention": "deepspeed_tpu_torch/csrc/blocked_flash.cu",
               "paged_decode_attention":
                   "deepspeed_tpu_torch/csrc/blocked_flash.cu"}
    replaces = {"quantized_matmul":
                    "deepspeed_tpu/ops/quantized_matmul.py:47",
                "paged_attention":
                    "deepspeed_tpu/inference/v2/kernels/blocked_flash.py:35",
                "paged_decode_attention":
                    "deepspeed_tpu/inference/v2/kernels/blocked_flash.py:118"}
    record = {"kernels": [{
        "name": c["name"], "route": "cuda", "source": sources[c["kernel"]],
        "replaces": replaces[c["kernel"]],
        "launches": launches[c["kernel"]], "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    } for c in cases]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "build_s": secs,
         "cases": cases, "slice": e2e, "served": served}, indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
