"""Launch-shape variants of the grouped-GEMM wgmma kernel (the forward, dlhs
and drhs) against each other on one card, and against a parent commit's
kernels.

Builds ``csrc/grouped_gemm.cu`` as it stands and copies of it with the
edits of each named variant (other ``GmmTiles`` choices: tile width, ring
stages, persistent or not, tile order), checks each library against the
plain versions (3e-2 of the largest magnitude, 1e-2 in norm, exact zeros
past the groups and in empty groups, two runs bit-equal) on small cases and
at the training shape, then times every library with
``chip_smoke.time_ms`` in ``--rounds`` turns: the libraries in order, then
in reverse, and so on; each case reports every turn's reading and the
best.  The forward is timed at M = 16 (a decode step), M = 1024 (a
512-token prefill, one expert empty), M = 2048 and 4096, and M = 8192
(training: 4096 <-> 14336, ragged, skewed); the gradients at M = 8192.

    python3 deepspeed_tpu_torch/tools/gmm_variants.py \\
        [--variants fs3,fband16] [--kinds fwd,dlhs,drhs] [--rounds 2]
        [--parent DIR] [--iters 10] [--step] [--decode]

``--parent DIR`` also builds ``DIR/grouped_gemm.cu`` (a parent commit's
source, from ``git archive <commit> deepspeed_tpu_torch/csrc``; headers from
DIR first, then ``csrc/``) as the library "parent", called through the
parent's C interface (its forward takes 16- or 64-row units by M, its
gradients no unit rows).  ``--step`` then runs ``chip_smoke.py``'s phase 14
(2 full-width dropless Mixtral layers trained through the engine) once with
the parent's forward and once with the tree's (the tree's gradients both
times), in that order, and reports each run's ms a step and its traced
grouped-GEMM device ms by kernel.  ``--decode`` (with ``--parent``) runs
phase 12 (Mixtral served at full width, 16 layers) four times, with the
parent's forward, the tree's, the tree's and the parent's, and reports
each run's decode ms a step and the grouped-GEMM device ms by kernel of
its traced decode step (M = 16) and 2 x 256 prefill (M = 1024).  A summary
JSON object is the last line of stdout; every timing is also written to
``chiprun_out/gmm_variants.json``.  Needs a CUDA device and ``nvcc``.
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

#: name -> {kind ("fwd" / "dlhs" / "drhs"): {GmmTiles field: value}}
_BOTH = ("dlhs", "drhs")
VARIANTS = {
    "fs3": {"fwd": {"kStages": 3}},
    "fbn128": {"fwd": {"kBN": 128, "kStages": 6}},
    "fpersist": {"fwd": {"kPersistent": 1}},
    "fband4": {"fwd": {"kBand": 4}},
    "fband16": {"fwd": {"kBand": 16}},
    "s3": {kind: {"kStages": 3} for kind in _BOTH},
    "bn128": {kind: {"kBN": 128, "kStages": 6} for kind in _BOTH},
    "persist": {kind: {"kPersistent": 1} for kind in _BOTH},
    "band4": {"dlhs": {"kBand": 4}},
    "band64": {"dlhs": {"kBand": 64}},
    "index": {"drhs": {"kByWork": 0}},
    "kfast": {"drhs": {"kNFast": 0}},
    "nfast": {"drhs": {"kNFast": 1}},
}

_KIND = {"dlhs": "kDlhs", "drhs": "kDrhs", "fwd": "kFwd"}

#: small cases for the correctness check: m, k, n, group sizes
CHECK_CASES = [
    (16, 4096, 1024, [2, 3, 0, 1, 4, 2, 2, 2]),
    (100, 136, 200, [10, 0, 33, 40, 0, 0, 7, 0]),
    (1024, 512, 1024, [200, 130, 0, 180, 100, 150, 120, 144]),
    (200, 64, 256, [64, 1, 0, 60]),
    (0, 64, 64, [0, 0]),
    (8192, 4096, 2048, [1100, 980, 1010, 1050, 990, 1020, 1000, 1042]),
]


def variant_source(text: str, spec) -> str:
    """The kernel source with one variant's edits (a name joined by "+":
    each part's edits in turn)."""
    if isinstance(spec, str):
        for part in spec.split("+"):
            text = variant_source(text, VARIANTS[part])
        return text
    for kind, fields in spec.items():
        start = text.index(f"struct GmmTiles<{_KIND[kind]}> {{")
        end = text.index("};", start)
        block = text[start:end]
        for field, value in fields.items():
            block, n = re.subn(rf"\b{field} = \d+", f"{field} = {value}", block)
            assert n == 1, (kind, field)
        text = text[:start] + block + text[end:]
    return text


def build_all(build_dir: Path, names, parent):
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "grouped_gemm.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build_dir / f"{name}.cu"
        cu.write_text(src if name == "current" else variant_source(src, name))
        jobs[name] = (_build.nvcc_command(cu, build_dir / f"lib{name}.so"),
                      build_dir / f"lib{name}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "grouped_gemm.cu", lib)
        jobs["parent"] = (cmd[:1] + ["-I", str(parent)] + cmd[1:], lib)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n, (cmd, _) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        regs, fn = [], "?"
        for line in lines:           # each entry function, then its usage
            entry = re.search(r"entry function '(\S+)'", line)
            fn = entry.group(1) if entry else fn
            if "registers" in line:
                regs.append(f"{fn}: {line.split(':')[-1].strip()}")
        warn = sorted({line.strip() for line in lines
                       if "warning" in line or ("spill" in line and
                                                " 0 bytes spill stores"
                                                not in line)})
        print(f"[build] {name}: ok; {regs}; warnings / spills: "
              f"{warn or 'none'}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    return libs


def parent_label(name: str) -> str:
    """A traced kernel name, as the parent's forward where it is one
    (``gmm_kernel<64>`` above M = 64, ``gmm_kernel<16>`` at M <= 64)."""
    tile = re.search(r"gmm_kernel<(?:\(int\))?(\d+)>", name)
    return f"parent gmm_kernel<{tile.group(1)}>" if tile else name


class Parent:
    """The parent's three kernels through its C interface (the forward
    takes the unit rows, 16 or 64; the gradients none)."""

    def __init__(self, lib):
        self.fwd, self.dl, self.dr = (lib.dstt_grouped_gemm_bf16,
                                      lib.dstt_grouped_gemm_dlhs_bf16,
                                      lib.dstt_grouped_gemm_drhs_bf16)
        for fn, ints in ((self.fwd, 5), (self.dl, 4), (self.dr, 4)):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

    @staticmethod
    def _call(fn, *args):
        import torch

        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel failed with {rc}")

    def gmm(self, lhs, rhs, gs):
        import torch

        (m, k), (e, _, n) = lhs.shape, rhs.shape
        out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
        if m:
            self._call(self.fwd, lhs.data_ptr(), rhs.data_ptr(),
                       gs.data_ptr(), out.data_ptr(), m, k, n, e,
                       16 if m <= 64 else 64)
        return out

    def dlhs(self, dout, rhs, gs):
        import torch

        (m, n), (e, k, _) = dout.shape, rhs.shape
        out = torch.empty((m, k), dtype=dout.dtype, device=dout.device)
        if m:
            self._call(self.dl, dout.data_ptr(), rhs.data_ptr(), gs.data_ptr(),
                       out.data_ptr(), m, k, n, e)
        return out

    def drhs(self, lhs, dout, gs):
        import torch

        (m, k), n, e = lhs.shape, dout.shape[1], gs.shape[0]
        out = torch.empty((e, k, n), dtype=lhs.dtype, device=lhs.device)
        self._call(self.dr, lhs.data_ptr(), dout.data_ptr(), gs.data_ptr(),
                   out.data_ptr(), m, k, n, e)
        return out


def _ok(torch, cs, got, again, want, total):
    ok = torch.equal(got, again) and bool(torch.isfinite(got.float()).all())
    if total:
        err = (got.float() - want.float()).abs().max()
        ok &= bool(err <= cs.TOL * want.float().abs().max())
        ok &= cs.rel_norm(got, want) <= cs.NORM_TOL
    return ok


def check(torch, cs, gg, fns, dev):
    """The failed (kind, case) pairs of one library on CHECK_CASES: the
    forward, dlhs and drhs."""
    failed = []
    for i, (m, k, n, sizes) in enumerate(CHECK_CASES):
        gen = torch.Generator(device=dev).manual_seed(i + 7)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        dout = torch.randn((m, n), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        rhs = (torch.randn((len(sizes), k, n), generator=gen, device=dev)
               * (0.5 / math.sqrt(n))).to(torch.bfloat16)
        lhs = (torch.randn((m, k), generator=gen, device=dev)
               * (0.5 / math.sqrt(max(1, max(sizes))))).to(torch.bfloat16)
        x = (torch.randn((m, k), generator=gen, device=dev)
             * (0.5 / math.sqrt(k))).to(torch.bfloat16)
        total = sum(sizes)
        runs = [("dlhs", lambda: fns["dlhs"](dout, rhs, gs),
                 lambda: gg.gmm_dlhs_plain(dout, rhs, gs)),
                ("drhs", lambda: fns["drhs"](lhs, dout, gs),
                 lambda: gg.gmm_drhs_plain(lhs, dout, gs))]
        if m:
            runs.append(("fwd", lambda: fns["fwd"](x, rhs, gs),
                         lambda: gg.gmm_plain(x, rhs, gs)))
        for kind, run, plain in runs:
            try:
                got, again, want = run(), run(), plain()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                failed.append((kind, m, k, n, str(exc)[:200]))
                continue
            ok = _ok(torch, cs, got, again, want, total)
            if kind != "drhs" and total < m:
                ok &= got[total:].abs().max().item() == 0.0
            if kind == "drhs":
                ok &= all(got[e].abs().max().item() == 0.0
                          for e, size in enumerate(sizes) if size == 0)
            if not ok:
                failed.append((kind, m, k, n))
    return failed


def forward_cases(torch, cs, gen, dev):
    """(label, group sizes, k, n) of the forward's timed cases, drawn as
    chip_smoke.py's phase 3 draws them."""
    m = 8192
    full = cs._routed_sizes(torch, gen, dev, m // 2)
    ragged = cs._routed_sizes(torch, gen, dev, 4000, empty=2)
    skewed = cs._routed_sizes(torch, gen, dev, m // 2, boost=(0, 1.4))
    prefill = cs._routed_sizes(torch, gen, dev, 512, empty=2)
    decode = cs._routed_sizes(torch, gen, dev, 8)
    mid = {t: cs._routed_sizes(torch, gen, dev, t) for t in (1024, 2048)}
    return [("M=16 4096->14336", decode, 4096, 14336),
            ("M=16 14336->4096", decode, 14336, 4096),
            ("M=1024 4096->14336", prefill, 4096, 14336),
            ("M=1024 14336->4096", prefill, 14336, 4096),
            ("M=2048 4096->14336", mid[1024], 4096, 14336),
            ("M=2048 14336->4096", mid[1024], 14336, 4096),
            ("M=4096 4096->14336", mid[2048], 4096, 14336),
            ("M=4096 14336->4096", mid[2048], 14336, 4096),
            ("M=8192 4096->14336", full, 4096, 14336),
            ("M=8192 14336->4096", full, 14336, 4096),
            ("M=8192 ragged", ragged, 4096, 14336),
            ("M=8192 skewed", skewed, 4096, 14336)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kinds", default="fwd,dlhs,drhs")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--decode", action="store_true")
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build

    # a trace books the parent's forward (gmm_kernel<16 / 64>) as grouped
    # GEMM too
    assert cs.KERNEL_KINDS[0][0] == "grouped_gemm"
    cs.KERNEL_KINDS = ((("grouped_gemm", cs.KERNEL_KINDS[0][1]
                         + ("gmm_kernel",)),) + cs.KERNEL_KINDS[1:])
    from deepspeed_tpu_torch.ops import grouped_gemm as gg

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["current"] + [v for v in args.variants.split(",") if v]
    t0 = time.perf_counter()
    libs = build_all(ROOT / "build" / "gmm_variants", names, args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    parent = Parent(libs["parent"]) if args.parent else None

    def use(name):
        _build._LIBS["grouped_gemm"] = libs[name]
        gg._kernel.cache_clear()

    def fns(name):
        if name == "parent":
            return {"fwd": parent.gmm, "dlhs": parent.dlhs,
                    "drhs": parent.drhs}
        return {"fwd": gg._launch, "dlhs": gg.gmm_dlhs, "drhs": gg.gmm_drhs}

    def turns():
        """The libraries in order, then in reverse, ``--rounds`` times."""
        for r in range(args.rounds):
            yield from (names if r % 2 == 0 else names[::-1])

    def summary(times):
        """Per key the best reading and every turn's."""
        return {key: {"best": min(ts), "turns": ts}
                for key, ts in times.items()}

    failed = []
    for name in names + (["parent"] if parent else []):
        if name != "parent":
            use(name)
        bad = check(torch, cs, gg, fns(name), dev)
        failed += [(name,) + b for b in bad]
    print(f"[check] {len(names)} libraries x {len(CHECK_CASES)} cases: "
          f"{'ok' if not failed else failed}", flush=True)

    if parent:
        names.append("parent")
    use("current")
    rows = []
    if "fwd" in kinds:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 15)
        for label, sizes, k, n in forward_cases(torch, cs, gen, dev):
            m = int(label.split()[0][2:])
            total = int(sizes.sum())
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            w = torch.randn((8, k, n), generator=gen, device=dev,
                            dtype=torch.bfloat16).mul_(0.5 / math.sqrt(k))
            offs = torch.cumsum(sizes, 0, dtype=torch.int32)
            flops = 2.0 * total * k * n
            times, info = {}, {}
            for name in turns():
                if name != "parent":
                    use(name)
                fwd, key = fns(name)["fwd"], f"fwd {name}"
                times.setdefault(key, []).append(cs.time_ms(
                    lambda i: fwd(x, w, sizes), 1, args.iters))
                if name != "parent":
                    fwd(x, w, sizes)
                    info[key] = gg.launch_info()
            lib = getattr(torch, "_grouped_mm", None)
            if lib is not None:
                times["torch._grouped_mm"] = [cs.time_ms(
                    lambda i: lib(x, w, offs=offs), 1, args.iters)]
            del x, w
            torch.cuda.empty_cache()
            print(f"[time] forward {label} sizes {sizes.tolist()}: "
                  + " | ".join(f"{key} {min(ts):.4f} ({flops / min(ts) / 1e9:.0f} "
                               f"TFLOP/s; turns {' '.join(f'{t:.4f}' for t in ts)})"
                               for key, ts in times.items()),
                  flush=True)
            rows.append({"case": f"forward {label}",
                         "group_sizes": sizes.tolist(), "flops": flops,
                         "ms": summary(times), "launch": info})

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    m = 8192
    full = cs._routed_sizes(torch, gen, dev, m // 2)
    ragged = cs._routed_sizes(torch, gen, dev, 4000, empty=2)
    skewed = cs._routed_sizes(torch, gen, dev, m // 2, boost=(0, 1.4))
    grads = [kind for kind in ("dlhs", "drhs") if kind in kinds]
    for label, sizes, k, n in ((("4096->14336", full, 4096, 14336),
                                ("14336->4096", full, 14336, 4096),
                                ("ragged", ragged, 4096, 14336),
                                ("skewed", skewed, 4096, 14336))
                               if grads else ()):
        total = int(sizes.sum())
        dout = torch.randn((m, n), generator=gen, device=dev,
                           dtype=torch.bfloat16)
        rhs = torch.randn((8, k, n), generator=gen, device=dev,
                          dtype=torch.bfloat16).mul_(0.5 / math.sqrt(n))
        lhs = torch.randn((m, k), generator=gen, device=dev,
                          dtype=torch.bfloat16).mul_(0.5 / math.sqrt(total / 8))
        flops = 2.0 * total * k * n
        times, info = {}, {}
        for name in turns():
            if name != "parent":
                use(name)
            f = fns(name)
            for kind, run in (("dlhs", lambda: f["dlhs"](dout, rhs, sizes)),
                              ("drhs", lambda: f["drhs"](lhs, dout, sizes))):
                if kind not in grads:
                    continue
                key = f"{kind} {name}"
                times.setdefault(key, []).append(
                    cs.time_ms(lambda i: run(), 1, args.iters))
                if name != "parent":
                    run()
                    info[key] = gg.launch_info()
        del dout, rhs, lhs
        torch.cuda.empty_cache()
        print(f"[time] {label} sizes {sizes.tolist()}: " + " | ".join(
            f"{key} {min(ts):.4f} ({flops / min(ts) / 1e9:.0f} TFLOP/s; "
            f"turns {' '.join(f'{t:.4f}' for t in ts)})"
            for key, ts in times.items()), flush=True)
        rows.append({"case": label, "group_sizes": sizes.tolist(),
                     "flops": flops, "ms": summary(times), "launch": info})

    def with_forward(name, fn):
        """``fn()`` with the parent's forward (``name`` "parent") or the
        tree's, the tree's gradients both times."""
        use("current")
        saved = gg._launch
        if name == "parent":
            gg._launch = parent.gmm
        try:
            return fn()
        finally:
            gg._launch = saved

    def gmm_ms(trace):
        return {parent_label(key): ms for key, ms in
                ((trace or {}).get("grouped_gemm_ms_per_step") or {}).items()}

    steps = {}
    for name in (("parent", "current") if args.step and parent else ()):
        run = with_forward(name, lambda: cs.moe_trained_run(torch, np, dev,
                                                            True))
        steps[name] = {k: run[k] for k in ("ms_per_step", "tokens_per_s",
                                           "mfu", "first_loss", "last_loss")}
        trace = run["trace"] or {}
        steps[name]["traced_wall_ms"] = trace.get("wall_ms_per_step")
        steps[name]["device_busy_ms"] = trace.get("device_busy_ms_per_step")
        steps[name]["kind_ms"] = trace.get("kind_ms_per_step")
        steps[name]["grouped_gemm_ms"] = gmm_ms(trace)
        print(f"[step] {name}: {json.dumps(steps[name])}", flush=True)

    decode = []
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]
    for name in (("parent", "current", "current", "parent")
                 if args.decode and parent else ()):
        run = with_forward(name, lambda: cs.mixtral_served_run(torch, np,
                                                               prompts))
        trace = run["trace"] or {}
        decode.append({
            "forward": name,
            "decode_ms_per_step": run["decode_ms_per_step"],
            "ttft_ms_per_pair": run["ttft_ms_per_pair"],
            "decode_device_busy_ms": trace.get("device_busy_ms_per_step"),
            "decode_grouped_gemm_ms": gmm_ms(trace),
            "prefill_grouped_gemm_ms": gmm_ms(run["prefill_trace"]),
            "launches": run["launches"].get("grouped_gemm")})
        print(f"[decode] {json.dumps(decode[-1])}", flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    (out / "gmm_variants.json").write_text(json.dumps(
        {"device": smi, "variants": {n: VARIANTS.get(n) for n in names},
         "failed": [list(map(str, f)) for f in failed], "cases": rows,
         "step": steps, "decode": decode}, indent=1, default=str))
    print(smi)
    print(json.dumps({"ok": not failed, "device": smi, "libraries": names,
                      "cases": len(rows), "step": sorted(steps),
                      "decode": len(decode)}))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
