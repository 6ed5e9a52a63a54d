"""Host-tier spool and restore times of two checkouts on one card.

    python3 deepspeed_tpu_torch/tools/tier_transfer.py --parent DIR [--pairs 2]

Builds a ``DSStateManager`` with the host KV tier at Llama-2-7B's KV
geometry (32 layers, 32 KV heads, head_dim 128, block 16, int8 payload and
fp32 scales; no model) in a fresh process for each of two checkouts: the
one this file belongs to ("change") and ``DIR`` ("parent"), ``--pairs``
times, the parent first in even pairs and second in odd ones.  In each
process, for each batch size N of ``--blocks``: a sequence of N random
blocks is registered in the prefix cache and flushed, ``evict(N)`` spools
it (the tier's ``_spool_nodes``), and a fresh sequence's
``attach_prefix`` restores it (``_restore_blocks``); the restored blocks
must equal the pre-eviction gather bit for bit.  The first spool and
restore of a process come first, on a fresh manager (cold: any host
buffer is allocated then), then ``--repeats`` warm ones a size.  The
times are the walls of the ``evict`` and ``attach_prefix`` calls, the
stream drained before each and synchronized after: the whole of the
spool hook and of the restore, whatever part of it the tier's own
``spool_s`` / ``restore_s`` cover (also kept, as ``*_stat_ms``).  The cold and one warm transfer of the largest N are
also traced with ``torch.profiler``: the host calls that took the most
time.  Every run goes to ``chiprun_out/tier_transfer.json``; the last line
printed is a JSON summary: per size and side the median spool and restore
ms (walls and the tier's own) and the bytes moved a second, in MB.
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
LAYERS, KV_HEADS, HEAD_DIM, BLOCK = 32, 32, 128, 16


def top_host_calls(prof, n=8):
    """The ``n`` host events with the most self CPU time, in ms."""
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:n]
    return [{"name": e.key, "calls": e.count,
             "self_ms": e.self_cpu_time_total / 1e3} for e in rows]


def one(root: Path, sizes, repeats: int, device: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2.config_v2 import (
        DSStateManagerConfig, KVCacheConfig)
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import (
        DSStateManager)

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    need = max(sizes)

    def manager():
        return DSStateManager(
            DSStateManagerConfig(max_context=(need + 1) * BLOCK),
            KVCacheConfig(block_size=BLOCK, num_blocks=2 * need + 2,
                          dtype="int8", enable_prefix_cache=True,
                          host_tier=True, host_tier_bytes=1 << 40),
            LAYERS, KV_HEADS, HEAD_DIM, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def round_trip(sm, n, uid, prof=None):
        tokens = rng.integers(0, 32000, size=(n * BLOCK + 1,)).tolist()
        seq = sm.get_or_create_sequence(uid)
        sm.maybe_allocate_kv(seq, n * BLOCK)
        kv = sm.kv_cache
        idx = torch.as_tensor(seq.blocks, device=dev)
        for layer in kv.cache.values():
            for leaf, pool in layer.items():
                rows = pool.view((-1, BLOCK) + tuple(pool.shape[1:]))
                if pool.dtype == torch.int8:
                    rows[idx] = torch.randint(
                        -127, 128, rows[idx].shape, dtype=torch.int8,
                        device=dev)
                else:
                    rows[idx] = torch.rand(rows[idx].shape, device=dev)
        seq.seen_tokens = n * BLOCK
        sm.record_fed_tokens(seq, tokens[:n * BLOCK])
        sm.register_prefix(seq)
        pre = kv.gather_blocks(list(seq.blocks))
        sm.flush_sequence(uid)
        tier = sm.host_tier
        trace, wall = {}, {}

        def timed(name, fn):
            ctx = prof() if prof else None
            sync()
            t0 = time.perf_counter()
            if ctx:
                with ctx as p:
                    got = fn()
                    sync()
                trace[name] = top_host_calls(p)
            else:
                got = fn()
                sync()
            wall[name] = 1e3 * (time.perf_counter() - t0)
            return got

        evicted = timed("spool", lambda: sm.prefix_cache.evict(n))
        seq2 = sm.get_or_create_sequence(uid + 1)
        attached = timed("restore", lambda: sm.attach_prefix(seq2, tokens))
        post = kv.gather_blocks(list(seq2.blocks))
        exact = all(torch.equal(pre[l][k], post[l][k])
                    for l in pre for k in pre[l])
        sm.flush_sequence(uid + 1)
        sm.prefix_cache.clear()
        tier.clear()
        if evicted != n or attached != n * BLOCK or not exact:
            raise RuntimeError(f"round trip of {n} blocks: evicted "
                               f"{evicted}, attached {attached} tokens, "
                               f"bit-exact {exact}")
        return {"spool_ms": wall["spool"], "restore_ms": wall["restore"],
                "spool_stat_ms": 1e3 * tier.stats.spool_s[-1],
                "restore_stat_ms": 1e3 * tier.stats.restore_s[-1],
                "trace": trace}

    def profiler():
        acts = [torch.profiler.ProfilerActivity.CPU]
        return torch.profiler.profile(activities=acts)

    sm = manager()
    out = {"root": str(root), "cold": round_trip(sm, need, 10, profiler),
           "sizes": {}}
    uid = 100
    for n in sizes:
        runs = []
        for _ in range(repeats):
            runs.append(round_trip(sm, n, uid))
            uid += 2
        out["sizes"][str(n)] = {k: [r[k] for r in runs] for k in runs[0]
                                if k != "trace"}
    out["warm_trace"] = round_trip(sm, need, uid, profiler)["trace"]
    payload = sm.kv_cache.gather_blocks([0])
    out["block_bytes"] = int(sum(t.numel() * t.element_size()
                                 for layer in payload.values()
                                 for t in layer.values()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent's checkout")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--blocks", default="1,5,8",
                    help="spool / restore batch sizes, in blocks")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a check of the tool, no timing "
                         "that means anything)")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sizes = [int(x) for x in args.blocks.split(",")]
    device = "cpu" if args.cpu else "cuda"
    if args.one:
        print(json.dumps(one(args.one, sizes, args.repeats, device)))
        return 0
    if args.parent is None or not (args.parent / "deepspeed_tpu_torch").is_dir():
        ap.error("--parent must name a checkout holding deepspeed_tpu_torch/")
    roots = {"parent": args.parent.resolve(), "change": ROOT}
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        for side in (("parent", "change") if i % 2 == 0
                     else ("change", "parent")):
            t0 = time.perf_counter()
            cmd = [sys.executable, __file__, "--one", str(roots[side]),
                   "--blocks", args.blocks, "--repeats", str(args.repeats)]
            if args.cpu:
                cmd.append("--cpu")
            proc = subprocess.run(cmd, cwd=roots[side],
                                  stdout=subprocess.PIPE, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                print(f"[tier] pair {i} {side}: exit {proc.returncode}",
                      flush=True)
                return 1
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["seconds"] = time.perf_counter() - t0
            runs[side].append(run)
            print(f"[tier] pair {i} {side}: {json.dumps(run)}", flush=True)
    summary = {"block_bytes": runs["change"][0]["block_bytes"], "sizes": {}}
    for n in sizes:
        row = {}
        for side in runs:
            for kind in ("spool_ms", "restore_ms", "spool_stat_ms",
                         "restore_stat_ms"):
                vals = [v for r in runs[side] for v in r["sizes"][str(n)][kind]]
                row[f"{side}_{kind}"] = statistics.median(vals)
            for kind in ("spool", "restore"):
                row[f"{side}_{kind}_MB_per_s"] = (
                    n * summary["block_bytes"] / 1e6
                    / (row[f"{side}_{kind}_ms"] / 1e3))
        summary["sizes"][str(n)] = row
    summary["cold"] = {side: [(r["cold"]["spool_ms"], r["cold"]["restore_ms"])
                              for r in runs[side]] for side in runs}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tier_transfer.json").write_text(json.dumps(runs, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
