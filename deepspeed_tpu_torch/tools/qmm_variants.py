"""Variants of the int8 matmul's skinny path (M <= 8, ``qmm_skinny_kernel``
in ``csrc/quantized_matmul.cu``) against each other on one card, and
against a parent commit's kernel.

Builds ``csrc/quantized_matmul.cu`` as it stands and copies of it with the
edits of each named variant, checks every library but the timing-only ones
(``t_`` names) against the plain version (3e-2 of the largest magnitude,
1e-2 in norm, two runs bit-equal) on small cases, then times each library
with ``chip_smoke.time_ms`` in ``--rounds`` turns (the libraries in order,
then in reverse, and so on) at M = 1, 2 and 8 and Llama-2-7B's four
projection shapes, beside ``torch.matmul`` on the bf16 weight (the
yardstick) and the byte bound.  Variants:

* ``s2`` ... ``s6``: 2 to 6 ring stages;
* ``nopdl``: launched without programmatic dependent launch (the launch
  waits for the kernel before it to end);
* ``spw1``: units of 128 x 128, one k step a consumer warp instead of two;
* ``intround``: the dequant's bf16 rounding on the integer pipes (add,
  mask, byte permute) instead of ``cvt.rn.bf16x2.f32``;
* ``t_nomath``: timing only, the consumers skip the dequant and the
  products (the ring's streaming rate alone);
* ``t_noscale``: timing only, a constant scale instead of each row's;
* ``t_cvt``: timing only, the bf16x2 pack replaced by one integer op;
* ``t_nomma``: timing only, the products replaced by one add a fragment;
* ``t_noq``: timing only, no weight is loaded (x alone): what the launch,
  the ring's hand-overs and the cluster's sum cost without the bytes.

Names joined by "+" combine variants (``spw1+s3``, ``s3+t_nomath``).

    python3 deepspeed_tpu_torch/tools/qmm_variants.py \\
        [--variants s4,s8,intround,t_nomath] [--parent DIR] [--rounds 2]
        [--iters 48] [--decode] [--decode-turns 8] [--host]

``--parent DIR`` also builds ``DIR/quantized_matmul.cu`` (a parent commit's
source, from ``git archive <commit> deepspeed_tpu_torch/csrc``; headers
from DIR first, then ``csrc/``) as the library "parent", called through the
parent's C interface with the parent's skinny k-split rule, and times it in
the same turns.  ``--decode`` (with ``--parent``) runs ``chip_smoke.py``'s
phase 5 (Llama-2-7B at int8, 32 layers, 8 requests served)
``--decode-turns`` times, with the parent's int8 matmul, the tree's, the
tree's, the parent's and so on, and reports each run's untraced decode ms
a step and the int8 matmul's device ms by kernel in its traced decode step
(2 requests, M = 2).  ``--host`` (with ``--parent``) times the host's cost
of one call at M = 2 and each shape, the parent's and the tree's in
alternating turns: batches of 16 calls with no wait between them, timed
from the first call to the return of the last (the queue never fills, so
the kernels' own time is not in it).  A summary JSON object is the last line of stdout; every timing is also
written to ``chiprun_out/qmm_variants.json``.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: the consumers' dequant and products, from the first marker to the
#: second (the timing-only ``t_nomath`` replaces them)
_MATH = ("      unsigned v[4][4];\n",
         "        mma16816(acc[j], a, b0[h], b1[h]);\n      }\n")

def _set(**fields):
    """Edits that give the skinny kernel's constants these values."""
    return [("set", field, value) for field, value in fields.items()]


#: name -> (edits: (old text, new text), (start, end, new text) spans or
#: constants set by _set; extra nvcc flags; the wrapper's unit constants)
VARIANTS = {
    "s2": (_set(kSkStages=2), [], {}),
    "s3": (_set(kSkStages=3), [], {}),
    "s4": (_set(kSkStages=4), [], {}),
    "s5": (_set(kSkStages=5), [], {}),
    "s6": (_set(kSkStages=6), [], {}),
    "nopdl": ([(r'  asm volatile("griddepcontrol.wait;\n" ::: "memory");', ""),
               (r'  asm volatile("griddepcontrol.launch_dependents;\n" '
                r'::: "memory");', ""),
               ("  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")], [], {}),
    "spw1": (_set(kSkQBytes=16384, kSkStepsPerWarp=1), [], {"_SKINNY_K": 128}),
    "intround": ([("  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);\n"
                   "  return *reinterpret_cast<const uint32_t*>(&v);",
                   "  const unsigned ua = __float_as_uint(a), "
                   "ub = __float_as_uint(b);\n"
                   "  return __byte_perm(ua + 0x7FFFu + ((ua >> 16) & 1u), "
                   "ub + 0x7FFFu + ((ub >> 16) & 1u), 0x7632);")], [], {}),
    "t_nomath": ([_MATH + ("      acc[0][0] += __uint_as_float("
                           "(w[h][0].x ^ w[h][1].y ^ w[h][2].z ^ w[h][3].w ^ "
                           "b0[h] ^ b1[h]) & 0x3f000000u) * sk[h][0];\n",)],
                 [], {}),
    "t_noscale": ([("k < K ? __ldg(&scale[k / rows_per_group]) : 0.f;",
                    "k < K ? 1e-3f : 0.f;")], [], {}),
    "t_cvt": ([("  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);\n"
                "  return *reinterpret_cast<const uint32_t*>(&v);",
                "  return __float_as_uint(a) ^ __float_as_uint(b);")], [], {}),
    "t_nomma": ([("        mma16816(acc[j], a, b0[h], b1[h]);",
                  "        acc[j][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ "
                  "a[3] ^ b0[h] ^ b1[h]) & 0x3f000000u);")], [], {}),
    "t_noq": ([("mbar_arrive_expect_tx(&full[s], kSkQBytes + kSkXBytes);",
                "mbar_arrive_expect_tx(&full[s], kSkXBytes);"),
               ("        tma_load_2d(qs + s * kSkQBytes, &q_map, &full[s], "
                "tile * kSkBN, kc * kSkBK);\n", "")],
              [], {}),
}


def variant_spec(name: str):
    """Edits, nvcc flags and wrapper constants of a variant name (parts
    joined by "+")."""
    edits, flags, consts = [], [], {}
    for part in name.split("+"):
        e, f, c = VARIANTS[part]
        edits, flags, consts = edits + e, flags + f, {**consts, **c}
    return edits, flags, consts

#: small cases for the correctness check: m, k, n, groups
CHECK_CASES = [(1, 96, 256, 3), (8, 64, 4096, 1), (5, 1024, 4112, 16),
               (8, 11008, 4096, 64), (2, 4096, 32000, 16)]
#: the timed shapes: Llama-2-7B's q/k/v/o, gate/up, down and lm_head
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))


def variant_source(text: str, name: str) -> str:
    """The kernel source with one variant's edits."""
    for edit in variant_spec(name)[0]:
        if edit[0] == "set":
            text, n = re.subn(rf"(constexpr \w+ {edit[1]} = )[^;]+;",
                              rf"\g<1>{edit[2]};", text)
            assert n == 1, (name, edit)
        elif len(edit) == 2:
            assert text.count(edit[0]) == 1, (name, edit[0])
            text = text.replace(*edit)
        else:
            start = text.index(edit[0])
            end = text.index(edit[1], start) + len(edit[1])
            text = text[:start] + edit[2] + text[end:]
    return text


def build_all(build_dir: Path, names, parent):
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "quantized_matmul.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build_dir / f"{name}.cu"
        cu.write_text(src if name == "current" else variant_source(src, name))
        cmd = _build.nvcc_command(cu, build_dir / f"lib{name}.so")
        flags = variant_spec(name)[1] if name != "current" else []
        jobs[name] = (cmd[:1] + flags + cmd[1:], build_dir / f"lib{name}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "quantized_matmul.cu", lib)
        jobs["parent"] = (cmd[:1] + ["-I", str(parent)] + cmd[1:], lib)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n, (cmd, _) in jobs.items()}
    libs, logs = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        regs, fn = [], "?"
        for line in log.splitlines():      # each entry function, then its usage
            entry = re.search(r"entry function '(\S+)'", line)
            fn = entry.group(1) if entry else fn
            if "registers" in line and "skinny" in fn:
                regs.append(line.split(":")[-1].strip())
        warn = sorted({line.strip() for line in log.splitlines()
                       if "arning" in line or "C75" in line
                       or ("spill" in line
                           and " 0 bytes spill stores" not in line)})
        logs[name] = {"registers": regs, "warnings": warn}
        print(f"[build] {name}: ok; skinny kernel {regs}; warnings / "
              f"spills: {warn or 'none'}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    return libs, logs


class Parent:
    """The parent's int8 matmul through its C interface, with its skinny
    k-split rule (one block an SM over 512-column blocks, at least 64 k
    rows a block); above M = 8 it takes the tree's tile rows and splits."""

    def __init__(self, lib):
        self.fn = lib.dstt_quantized_matmul_bf16
        self.fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, x, record):
        import torch

        from deepspeed_tpu_torch.ops import quantized_matmul as qm

        if not x.is_cuda:
            return qm.quantized_matmul_plain(x, record)
        q, scale = record["q"], record["scale"]
        m, k = x.shape
        n = q.shape[1]
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        if m == 0:
            return out
        sms = qm._sms(x.device)
        if m <= 8:
            splits = max(1, min(sms // -(-n // 512), k // 64))
            rows = 0
        else:
            splits, rows = qm.k_splits_for(m, k, n, sms), qm.tiled_rows(m, n,
                                                                        sms)
        partial = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device) if splits > 1 else None)
        rc = self.fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                     partial.data_ptr() if partial is not None else None,
                     out.data_ptr(), m, k, n, scale.shape[0], splits, rows,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel failed with {rc}")
        qm.LAUNCHES["quantized_matmul"] += 1
        return out


def inputs(torch, gen, dev, m, k, n, groups, sets=1):
    x = torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16)
    recs = [{"q": torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8),
             "scale": torch.rand((groups,), generator=gen, device=dev)
             / (73.3 * math.sqrt(k))} for _ in range(sets)]
    return x, recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--decode-turns", type=int, default=8)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["current"] + [v for v in args.variants.split(",") if v]
    t0 = time.perf_counter()
    libs, logs = build_all(ROOT / "build" / "qmm_variants", names,
                           args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    parent = Parent(libs["parent"]) if args.parent else None
    tree_qmm = qm.quantized_matmul

    units = {key: getattr(qm, key) for key in ("_SKINNY_COLS", "_SKINNY_K")}

    def use(name):
        qm.quantized_matmul = parent if name == "parent" else tree_qmm
        if name != "parent":
            _build._LIBS["quantized_matmul"] = libs[name]
            qm._kernel.cache_clear()
            qm._skinny_kernel.cache_clear()
            consts = variant_spec(name)[2] if name != "current" else {}
            for key, value in {**units, **consts}.items():
                setattr(qm, key, value)
            qm.skinny_plan.cache_clear()
            qm.resident_clusters.cache_clear()

    def turns(libraries):
        """The libraries in order, then in reverse, ``--rounds`` times."""
        for r in range(args.rounds):
            yield from (libraries if r % 2 == 0 else libraries[::-1])

    # the clusters of c blocks the card holds at once, by c
    use("current")
    resident = dict(qm.resident_clusters(dev.index))
    print(f"[plan] resident clusters by size: {resident}", flush=True)

    failed = []
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    checked = [n for n in names
               if not any(p.startswith("t_") for p in n.split("+"))] + (
        ["parent"] if parent else [])
    for m, k, n, groups in CHECK_CASES:
        x, (rec,) = inputs(torch, gen, dev, m, k, n, groups)
        want = qm.quantized_matmul_plain(x, rec)
        for name in checked:
            use(name)
            got, again = (qm.quantized_matmul(x, rec) for _ in range(2))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            norm = cs.rel_norm(got, want)
            if not (err <= cs.TOL and norm <= cs.NORM_TOL
                    and torch.equal(got, again)):
                failed.append((name, m, k, n, groups, err, norm))
    print(f"[check] {len(checked)} libraries x {len(CHECK_CASES)} cases: "
          f"{'ok' if not failed else failed}", flush=True)

    timed = names + (["parent"] if parent else [])
    rows = []
    for k, n in SHAPES:
        sets = cs.n_sets(k * n)
        for m in (1, 2, 8):
            x, recs = inputs(torch, gen, dev, m, k, n, 16, sets)
            times = {}
            for name in turns(timed):
                use(name)
                times.setdefault(name, []).append(cs.time_ms(
                    lambda i: qm.quantized_matmul(x, recs[i]), sets,
                    args.iters))
            use("current")
            w = [qm.dequant_reference(r) for r in recs]
            lib = cs.time_ms(lambda i: torch.matmul(x, w[i]), sets,
                             args.iters)
            b_ms, _ = cs.bound(m * k * 2 + k * n + 64 + m * n * 2,
                               2.0 * m * k * n)
            plan = qm.skinny_plan(k, n, qm.resident_clusters(dev.index))
            row = {"case": f"M={m} K={k} N={n}", "bound_ms": b_ms,
                   "torch_matmul_ms": lib,
                   "ms": {key: {"best": min(ts), "turns": ts}
                          for key, ts in times.items()},
                   "launch": plan}
            rows.append(row)
            print(f"[time] {row['case']} bound {b_ms:.4f} torch.matmul "
                  f"{lib:.4f} | " + " | ".join(
                      f"{key} {min(ts):.4f} ({' '.join(f'{t:.4f}' for t in ts)})"
                      for key, ts in times.items()), flush=True)
            del x, recs, w
    use("current")

    host = []
    for k, n in SHAPES if args.host and parent else ():
        x, (rec,) = inputs(torch, gen, dev, 2, k, n, 16)
        us = {}
        for name in turns(["parent", "current"]):
            use(name)
            for _ in range(16):                 # warm: caches and plans
                qm.quantized_matmul(x, rec)
            torch.cuda.synchronize()
            spans = []
            for _ in range(200):
                t0 = time.perf_counter()
                for _ in range(16):
                    qm.quantized_matmul(x, rec)
                spans.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
            spans.sort()
            us.setdefault(name, []).append(
                {"median": spans[len(spans) // 2] / 16 * 1e6,
                 "best": spans[0] / 16 * 1e6})
        use("current")
        host.append({"case": f"M=2 K={k} N={n}", "us_per_call": us})
        print(f"[host] M=2 K={k} N={n} us a call (median / best of 200 "
              f"batches of 16, each turn): " + " | ".join(
                  f"{key} " + " ".join(f"{u['median']:.2f}/{u['best']:.2f}"
                                       for u in ts)
                  for key, ts in us.items()), flush=True)
        del x, rec

    decode = []
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]
    order = [("parent", "current")[(i + i // 2) % 2]
             for i in range(args.decode_turns)]    # P C C P P C C P ...
    for name in order if args.decode and parent else ():
        use(name)
        try:
            run = cs.served_run(torch, prompts)
        finally:
            use("current")
        trace = run["trace"]["decode"] or {}
        decode.append({
            "kernel": name,
            "decode_ms_per_step": run["decode_ms_per_step"],
            "decode_device_busy_ms": trace.get("device_busy_ms_per_step"),
            "decode_idle_share": trace.get("device_idle_share"),
            "decode_kind_ms": trace.get("kind_ms_per_step"),
            "decode_qmm_ms": trace.get("quantized_matmul_ms_per_step"),
            "launches": run["launches"].get("quantized_matmul")})
        print(f"[decode] {json.dumps(decode[-1])}", flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    (out / "qmm_variants.json").write_text(json.dumps(
        {"device": smi, "variants": {n: variant_spec(n) for n in names
                                     if n != "current"},
         "builds": logs, "resident_clusters": resident,
         "failed": [list(map(str, f)) for f in failed],
         "cases": rows, "host": host, "decode": decode}, indent=1,
        default=str))
    print(smi)
    print(json.dumps({"ok": not failed, "device": smi, "libraries": timed,
                      "cases": len(rows), "decode": len(decode),
                      "host_us_median": {h["case"]: {
                          k: [u["median"] for u in v]
                          for k, v in h["us_per_call"].items()}
                          for h in host},
                      "decode_ms_per_step": [
                          (d["kernel"], d["decode_ms_per_step"])
                          for d in decode],
                      "best_ms": {r["case"]: {k: v["best"] for k, v in
                                              r["ms"].items()}
                                  for r in rows}}))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
