"""Serving walls of two checkouts on one card, in alternating pairs.

    python3 deepspeed_tpu_torch/tools/ab_walls.py --parent DIR [--pairs 10]

Runs phase 5's served decode and phase 10's speculative serving of
``chip_smoke.py`` (the 32-layer Llama-2-7B int8 geometry, random weights
from its seed) once in a fresh process for each of two checkouts: the one
this file belongs to ("change") and ``DIR`` ("parent"), ``--pairs``
times, the parent first in even pairs and second in odd ones.  Each
process builds its checkout's kernels (into that checkout's ``build/``),
imports that checkout's ``chip_smoke.py`` and package, and reports the
walls (ms a decode step; ms a verify pass and its ``decode_loop``'s ms a
step) beside the traced device time of one step, and the host time of
one call of the decode and the verify wrapper at those phases' shapes
(no sync inside the timed calls).  Every run goes to
``chiprun_out/ab_walls.json``; the last line printed is a JSON summary:
per metric and side the runs, their median and quartiles, and the pairs
the change read lower.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: (metric, the run it comes from, its key there)
METRICS = (("decode_ms_per_step", "phase5", "decode_ms_per_step"),
           ("ms_per_verify_pass", "phase10", "ms_per_verify_pass"),
           ("decode_loop_ms_per_step", "phase10", "decode_loop_ms_per_step"),
           ("decode_device_ms", "phase5", "device_busy_ms_per_step"),
           ("verify_device_ms", "phase10", "device_busy_ms_per_step"),
           ("decode_call_host_us", "host", "decode_call_host_us"),
           ("verify_call_host_us", "host", "verify_call_host_us"))


def host_us(torch, cs, calls=100, reads=20):
    """Host microseconds a call of the decode wrapper (phase 5: 8 slots,
    bf16 KV) and of the verify wrapper (phase 10: K = 5, int8 KV), at
    contexts of 257-330 tokens of Llama-2-7B's 32 KV heads: the median of
    ``reads`` timings of ``calls`` calls each, launched back to back."""
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    out = {}
    for name, k_tokens, int8 in (("decode", 1, False), ("verify", 5, True)):
        pos = torch.randint(257, 330, (8,), generator=gen,
                            device=dev).tolist()
        q, pools, tables, ts, tp = cs._attention_inputs(
            torch, gen, dev, 8, [list(range(p, p + k_tokens)) for p in pos],
            int8=int8)
        kp, vp, scales = pools[0]
        fn = bf.paged_verify_attention if k_tokens > 1 else (
            bf.paged_decode_attention)
        kw = {"k_tokens": k_tokens} if k_tokens > 1 else {}
        fn(q, kp, vp, tables, ts, tp, block_size=128, **scales, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(reads):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(q, kp, vp, tables, ts, tp, block_size=128, **scales,
                   **kw)
            times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[f"{name}_call_host_us"] = statistics.median(times)
    return out


def one(root: Path) -> int:
    """Phases 5 and 10 of ``root``'s ``chip_smoke.py`` and the wrappers'
    host time (:func:`host_us`), one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build

    assert Path(cs.__file__).resolve().parent == root.resolve()
    _build.build()
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]
    served = cs.served_run(torch, prompts)
    spec = cs.speculative_served_run(torch, np)
    out = {"host": host_us(torch, cs)}
    for name, run in (("phase5", served), ("phase10", spec)):
        trace = run["trace"].get("decode", run["trace"])
        out[name] = {k: run[k] for k in ("decode_ms_per_step",
                                         "ms_per_verify_pass",
                                         "decode_loop_ms_per_step",
                                         "verify_passes") if k in run}
        out[name]["device_busy_ms_per_step"] = trace[
            "device_busy_ms_per_step"]
        out[name]["device_idle_share"] = trace["device_idle_share"]
    print(json.dumps(out), flush=True)
    return 0


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent's checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.one)
    if args.parent is None or not (args.parent / "chip_smoke.py").exists():
        ap.error("--parent must name a checkout holding chip_smoke.py")
    roots = {"parent": args.parent.resolve(), "change": ROOT}
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        for side in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, __file__, "--one", str(roots[side])],
                cwd=roots[side], stdout=subprocess.PIPE, text=True,
                timeout=600)
            if proc.returncode != 0:
                print(f"[ab] pair {i} {side}: exit {proc.returncode}",
                      flush=True)
                return 1
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["seconds"] = time.perf_counter() - t0
            runs[side].append(run)
            print(f"[ab] pair {i} {side}: {json.dumps(run)}", flush=True)
    summary = {}
    for metric, phase, key in METRICS:
        vals = {s: [r[phase][key] for r in runs[s]] for s in runs}
        summary[metric] = {
            **{s: {"runs": v, **_quartiles(v)} for s, v in vals.items()},
            "change_lower_pairs": sum(c < p for p, c in zip(
                vals["parent"], vals["change"])),
            "pairs": args.pairs}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_walls.json").write_text(json.dumps(
        {"roots": {s: str(r) for s, r in roots.items()}, "runs": runs,
         "summary": summary}, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
