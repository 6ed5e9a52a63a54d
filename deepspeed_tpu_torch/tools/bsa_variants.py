"""Variants of the block-sparse attention kernels (the bf16 / fp16
forward, dQ and dK/dV on wgmma, the fp32 split-TF32 forward,
``csrc/block_sparse_attention.cu``) against each other on one card, and
against a parent commit's kernels.

Builds ``csrc/block_sparse_attention.cu`` as it stands and copies of it
with the edits of each named library variant (``SliceTiles`` /
``SplitTiles``: other ring stages), checks every library against the plain
versions on small cases (the forward 3e-2 max and 1e-2 in norm, fp32
1e-4, the gradients 5e-2 in norm, two runs bit-equal), then times phase
23's cases (``chip_smoke.BSA_CASES``: BERT width, S = 4096 and 1040, six
layouts, padded batches, fp32), forward, dQ and dK/dV, with
``chip_smoke.time_ms`` in ``--rounds`` turns: the libraries in order, then
in reverse, and so on.  Walk variants run on the tree's library with other
host tables (``bsa_tile_walk``'s split rule, set through the module's
``WAVE``, ``SPLIT_MIN`` and ``FP32_SPLIT``): ``nosplit`` never splits a
list, ``split_half`` and ``split_double`` halve or double the rule's part
length, ``fp32split1`` / ``fp32split16`` split the fp32 forward's lists as
the bf16 ones / 16 times finer.  SDPA over the expanded mask, its forward
and its backward alone, is timed once a case as the yardstick.

    python3 deepspeed_tpu_torch/tools/bsa_variants.py \\
        [--variants f3,s2,s4,nosplit,split_half] [--parent DIR]
        [--rounds 2] [--cases 0,5,6] [--iters 10]

``--parent DIR`` also builds ``DIR/block_sparse_attention.cu`` (a parent
commit's source, from ``git archive <commit> deepspeed_tpu_torch/csrc``;
headers from DIR first, then ``csrc/``) as the library "parent", called
through the tree's wrappers (a parent whose C interface differs from the
tree's, one whose forward took no walk tables, is not taken); a parent's
fp32 forward may be the general kernel on the tile lists.  A summary JSON object is the last line of stdout;
every timing is also written to ``chiprun_out/bsa_variants.json``.  Needs
a CUDA device and ``nvcc``.
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

#: library variants: edits (old text, new text); the fp32 forward's "x3"
#: (a 3-stage ring up to DP = 64); the wgmma kernels' "f2" / "f3" (the forward's ring
#: at DP <= 64), "s2" / "s4" (the backward's)
LIB_VARIANTS = {
    "x3": [("kStages = DP <= 16 ? 3 : 2", "kStages = DP <= 64 ? 3 : 2")],
    "f2": [("kFwdStages = DP == 128 ? 2 : 4", "kFwdStages = DP == 128 ? 2 : 2")],
    "f3": [("kFwdStages = DP == 128 ? 2 : 4", "kFwdStages = DP == 128 ? 2 : 3")],
    "s2": [("kDqStages = DP == 128 ? 2 : 3", "kDqStages = DP == 128 ? 2 : 2"),
           ("kDkvStages = DP == 128 ? 2 : 3",
            "kDkvStages = DP == 128 ? 2 : 2")],
    "s4": [("kDqStages = DP == 128 ? 2 : 3", "kDqStages = DP == 128 ? 2 : 4"),
           ("kDkvStages = DP == 128 ? 2 : 3",
            "kDkvStages = DP == 128 ? 2 : 4")],
}
#: walk variants: the tree's library with other host tables, by other
#: values of the split rule's constants (``bsa_tile_walk``: parts of
#: max(SPLIT_MIN, ceil(2 stages / WAVE)) stages)
WALK_VARIANTS = {"nosplit": {"SPLIT_MIN": 1 << 30},
                 "split_half": {"WAVE": 528, "SPLIT_MIN": 4},
                 "split_double": {"WAVE": 132, "SPLIT_MIN": 16},
                 "fp32split1": {"FP32_SPLIT": 1},
                 "fp32split16": {"FP32_SPLIT": 16}}

#: small cases for the correctness check: layout, B, H, S, D, block, type,
#: key-padding mode
CHECK_CASES = [
    ("bigbird", 2, 2, 256, 32, 16, "bf16", None),
    ("fixed_uni", 2, 2, 1040, 64, 16, "fp16", "mul"),
    ("variable", 2, 2, 512, 128, 32, "bf16", "add"),
    ("dense", 1, 4, 512, 40, 64, "bf16", None),
    ("bslongformer", 2, 2, 1040, 20, 16, "fp32", "mul"),
    ("fixed", 1, 2, 512, 64, 16, "fp32", None),
]


def variant_source(text: str, name: str) -> str:
    """The kernel source with one library variant's edits."""
    for old, new in LIB_VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text


def build_all(build_dir: Path, names, parent):
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "block_sparse_attention.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build_dir / f"{name}.cu"
        cu.write_text(src if name == "current" else variant_source(src, name))
        jobs[name] = (_build.nvcc_command(cu, build_dir / f"lib{name}.so"),
                      build_dir / f"lib{name}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "block_sparse_attention.cu", lib)
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
            if "registers" in line and ("wgmma" in fn or "split" in fn):
                kernel = re.search(r"(bsa_\w+?_(?:wgmma|split)_kernel)I(\w+?)EEEv",
                                   fn)
                regs.append(f"{kernel.group(1)}<{kernel.group(2)}>: "
                            f"{line.split(':')[-1].strip()}" if kernel
                            else line)
        warn = sorted({line.strip() for line in log.splitlines()
                       if "arning" in line or "C75" in line
                       or ("spill" in line and " 0 bytes spill stores"
                           not in line)})
        logs[name] = {"registers": regs, "warnings": warn}
        print(f"[build] {name}: ok; {len(regs)} slice-walk kernels, the "
              f"fp32 forward's {[r for r in regs if 'split' in r]}; "
              f"warnings / spills: {warn or 'none'}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    return libs, logs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(
        list(LIB_VARIANTS) + list(WALK_VARIANTS)))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=None,
                    help="indices into chip_smoke.BSA_CASES (default: every "
                         "case)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    chosen = [v for v in args.variants.split(",") if v]
    lib_names = ["current"] + [v for v in chosen if v in LIB_VARIANTS]
    walk_names = [v for v in chosen if v in WALK_VARIANTS]
    unknown = set(chosen) - set(LIB_VARIANTS) - set(WALK_VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    libs, logs = build_all(ROOT / "build" / "bsa_variants", lib_names,
                           args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    names = lib_names + walk_names + (["parent"] if args.parent else [])

    rule = {"WAVE": bsa.WAVE, "SPLIT_MIN": bsa.SPLIT_MIN,
            "FP32_SPLIT": bsa.FP32_SPLIT}

    def use(name, bsl=None):
        """Library variant ``name`` (or the tree's); with ``bsl``, also its
        walk variant's split rule, its tables rebuilt."""
        _build._LIBS["block_sparse_attention"] = libs[
            name if name in libs else "current"]
        bsa._kernel.cache_clear()
        if bsl is not None:
            for key, value in {**rule, **WALK_VARIANTS.get(name, {})}.items():
                setattr(bsa, key, value)
            bsl._lists.clear()

    def forward(name, qs, k, v, bsl, bias):
        """o, lse through library / walk variant ``name``."""
        use(name, bsl)
        return bsa.block_sparse_attention_fwd(qs, k, v, bsl, bias)

    def backward(name, qs, k, v, o, lse, do, bsl, scale, bias):
        """dq, delta, dk, dv through library / walk variant ``name``."""
        use(name, bsl)
        dq, delta = bsa.block_sparse_attention_bwd_dq(
            qs, k, v, o, lse, do, bsl, scale, bias)
        return (dq, delta) + bsa.block_sparse_attention_bwd_dkv(
            qs, k, v, do, lse, delta, bsl, bias)

    def inputs(layout, b, h, s, d, block, dtype, padding, seed, extra=None):
        cls, kw = cs.BSA_LAYOUTS[layout]
        bsl = bsa.BlockSparseLayout(getattr(sa, cls)(
            h, block, **kw, **(extra or {})).make_layout(s), block, s)
        dt = getattr(torch, cs.BSA_DTYPES[dtype])
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev,
                                   dtype=dt) for _ in range(4))
        bias = None if padding is None else sa.key_padding_bias(
            cs.bsa_padding_mask(torch, dev, b, s, padding), padding)
        scale = 1.0 / math.sqrt(d)
        qs = (q.float() * scale).to(dt)
        use("current", bsl)
        o, lse = bsa.block_sparse_attention_fwd(qs, k, v, bsl, bias)
        return bsl, q, k, v, do, qs, o, lse, bias, scale

    failed = []
    for c in CHECK_CASES:
        bsl, q, k, v, do, qs, o, lse, bias, scale = inputs(*c, seed=7)
        keep = bsl.element_mask(dev)
        rdq, rdelta = bsa.block_sparse_plain_bwd_dq(qs, k, v, o, lse, do,
                                                    keep, scale, bias)
        rdk, rdv = bsa.block_sparse_plain_bwd_dkv(qs, k, v, do, lse, rdelta,
                                                  keep, bias)
        ro = bsa.block_sparse_plain_fwd(qs, k, v, keep, bias)[0]
        for name in names:
            got = backward(name, qs, k, v, o, lse, do, bsl, scale, bias)
            again = backward(name, qs, k, v, o, lse, do, bsl, scale, bias)
            fo = [forward(name, qs, k, v, bsl, bias) for _ in range(2)]
            torch.cuda.synchronize()
            errs = [cs.rel_norm(g, w) for g, w in
                    zip((got[0], got[2], got[3]), (rdq, rdk, rdv))]
            fwd_err = ((fo[0][0].float() - ro.float()).abs().max().item(),
                       cs.rel_norm(fo[0][0], ro))
            bit = all(torch.equal(a, b_) for a, b_ in zip(got, again)) \
                and all(torch.equal(a, b_) for a, b_ in zip(*fo))
            fwd_bad = fwd_err[0] > cs.BSA_FP32_TOL if c[6] == "fp32" else \
                fwd_err[0] > cs.TOL or fwd_err[1] > cs.NORM_TOL
            if not bit or max(errs) > cs.BSA_GRAD_NORM_TOL or fwd_bad:
                failed.append(f"{name} {c}: norms {errs} forward "
                              f"{fwd_err} bit-equal {bit}")
    print(f"[check] {len(CHECK_CASES)} cases x {len(names)}: "
          f"{failed or 'all within the bars and bit-equal'}", flush=True)

    picked = list(range(len(cs.BSA_CASES))) if args.cases is None else \
        [int(i) for i in args.cases.split(",")]
    results = []
    for ci in picked:
        c = cs.BSA_CASES[ci]
        name_c, layout, b, h, s, d, block, dtype, extra, padding = c
        bsl, q, k, v, do, qs, o, lse, bias, scale = inputs(
            layout, b, h, s, d, block, dtype, padding, seed=ci, extra=extra)
        delta = bsa.block_sparse_attention_bwd_dq(qs, k, v, o, lse, do, bsl,
                                                  scale, bias)[1]
        times = {n: {"fwd": [], "dq": [], "dkv": [], "sum": []}
                 for n in names}
        info = {}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                use(name, bsl)
                f_fwd = lambda i: bsa.block_sparse_attention_fwd(
                    qs, k, v, bsl, bias)
                f_dq = lambda i: bsa.block_sparse_attention_bwd_dq(
                    qs, k, v, o, lse, do, bsl, scale, bias)
                f_dkv = lambda i: bsa.block_sparse_attention_bwd_dkv(
                    qs, k, v, do, lse, delta, bsl, bias)
                ms = {}
                for kname, fn in (("fwd", f_fwd), ("dq", f_dq),
                                  ("dkv", f_dkv)):
                    ms[kname] = cs.time_ms(fn, 1, args.iters)
                    if r == 0 and (dtype != "fp32" or kname == "fwd") \
                            and not (name == "parent" and dtype == "fp32"):
                        info.setdefault(name, {})[kname] = bsa.launch_info()
                ms["sum"] = ms["dq"] + ms["dkv"]
                for key, x in ms.items():
                    times[name][key].append(x)
        mask = bsl.element_mask(dev)[None]
        if bias is not None:
            mask = mask & (bias > -1e3)[:, None, None, :]
        sdpa_fwd = cs.time_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 1, 3)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        sdpa = cs.time_ms(lambda i: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 1, 3)
        del out, leaves, mask
        row = {"case": name_c, "index": ci, "sdpa_fwd_ms": sdpa_fwd,
               "sdpa_bwd_ms": sdpa,
               "best": {n: {k_: min(x) for k_, x in t.items()}
                        for n, t in times.items()},
               "turns": times, "launch": info}
        results.append(row)
        best = row["best"]
        print(f"[time] {name_c}: " + "; ".join(
            f"{n} fwd {best[n]['fwd']:.4f}, bwd {best[n]['dq']:.4f} + "
            f"{best[n]['dkv']:.4f} = {best[n]['sum']:.4f}" for n in names)
            + f"; SDPA fwd {sdpa_fwd:.4f} bwd {sdpa:.4f}", flush=True)
        bsl._elem.clear()
        del q, k, v, do, qs, o, lse, delta
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "libraries": names, "builds": logs, "check_failed": failed,
              "cases": results}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bsa_variants.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"device": smi, "check_failed": len(failed),
                      "fwd_ms": {r["case"]: {n: round(x["fwd"], 4)
                                             for n, x in r["best"].items()}
                                 for r in results},
                      "sum_ms": {r["case"]: {n: round(x["sum"], 4)
                                             for n, x in r["best"].items()}
                                 for r in results},
                      "sdpa_ms": {r["case"]: [round(r["sdpa_fwd_ms"], 4),
                                              round(r["sdpa_bwd_ms"], 4)]
                                  for r in results}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
