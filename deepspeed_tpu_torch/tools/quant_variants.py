"""Variants of the int8 quantizer (``csrc/quantizer.cu``) against each
other on one card, and against a parent commit's kernel.

Builds ``csrc/quantizer.cu`` as it stands and copies of it with the edits
of each named source variant, checks every variant bit for bit against the
plain version (``quantize_plain``) and over two runs on every case, then
times each with ``chip_smoke.time_ms`` (operand sets cold in L2) in
``--rounds`` turns (the variants in order, then in reverse, and so on) at
``chip_smoke.py`` phase 19's cases, beside the byte bound.  Variants:

* plan variants (the wrapper's constants, the same library): ``p8`` /
  ``p16`` / ``p64`` (a group's pieces of 8 / 16 / 64 KB instead of 32),
  ``b32`` (pieces of whole groups of 32 KB instead of 16), ``bnb0``
  (pieces of whole groups read from global memory, not staged), ``gnb0`` (a
  group of several pieces read twice from global memory, the second time
  from L2, not staged), ``nb3`` (three pieces a
  block where a piece holds whole groups, two loading ahead), ``nb4`` /
  ``nb6`` (4 / 6 pieces a block everywhere);
* source variants (rebuilt): ``t128`` / ``t512`` (128 / 512 threads a
  block), ``div`` (every value divided, no product path), ``u8`` (the
  reduce and quantize loops unrolled 8 times, not 4), ``bu4`` (the loop
  over a piece of groups within a warp unrolled 4 times);
* timing-only source variants (``t_``, not checked): ``t_nosync`` (a
  group's parts do not meet: each piece of a group of several quantized
  by its own maximum),
  ``t_nomath`` (q from the values' bits, no arithmetic), ``t_copy``
  (neither the group reduction nor the arithmetic: the pieces' data
  movement alone).

Names joined by "+" combine variants (``t512+p64``).  Each library's
device kernels and memsets in one call are counted from ``torch.profiler``
(the parent's two-pass kernel shows 2 and 1).

    python3 deepspeed_tpu_torch/tools/quant_variants.py \\
        [--variants p16,p64,t512] [--parent DIR] [--rounds 2]
        [--iters 24]

``--parent DIR`` also builds ``DIR/quantizer.cu`` (a parent commit's
source, from ``git archive <commit> deepspeed_tpu_torch/csrc``: the
two-pass kernel, a memset and two launches) as the variant "parent",
called through its C interface with the absmax scratch allocated a call as
its wrapper did, and times it in the same turns.  A summary JSON object is
the last line of stdout; every timing is also written to
``chiprun_out/quant_variants.json``.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: name -> (source constants set, wrapper constants set)
VARIANTS = {
    "p16": ({}, {"QUANT_PIECE": 16 * 1024}),
    "p64": ({}, {"QUANT_PIECE": 64 * 1024}),
    "p8": ({}, {"QUANT_PIECE": 8 * 1024}),
    "b32": ({}, {"QUANT_PIECE_BLOCK": 32 * 1024}),
    "gnb0": ({}, {"QUANT_NBUF_GROUP": 0}),
    "t128": ({"kThreads": 128}, {"QUANT_THREADS": 128}),
    "t512": ({"kThreads": 512}, {"QUANT_THREADS": 512}),
    "nb3": ({}, {"QUANT_NBUF": 3}),
    "nb4": ({}, {"QUANT_NBUF": 4, "QUANT_NBUF_GROUP": 4}),
    "nb6": ({}, {"QUANT_NBUF": 6, "QUANT_NBUF_GROUP": 6}),
    "div": ({"edit": [("bool near = r == 0.f;", "bool near = true;")]}, {}),
    "bnb0": ({}, {"QUANT_NBUF": 0}),
    "bu4": ({"edit": [
        ("      for (long long b = 0; b < nv; b += kThreads) {\n        const long long i = b + tid;\n"
         "        const L v",
         "#pragma unroll 4\n      for (long long b = 0; b < nv; b += kThreads) {\n"
         "        const long long i = b + tid;\n        const L v")]}, {}),
    "u8": ({"edit": [
        ("#pragma unroll 4\n    for (long long i = tid; i < nv; i += kThreads) IO::quant(",
         "#pragma unroll 8\n    for (long long i = tid; i < nv; i += kThreads) IO::quant("),
        ("#pragma unroll 4\n        for (long long i = tid; i < nv; i += kThreads) m = ",
         "#pragma unroll 8\n        for (long long i = tid; i < nv; i += kThreads) m = ")]},
        {}),
    "t_copy": ({"edit": [
        ("const int t = __float_as_int(fmaf(to_f(e[i]), r, kFrac)) + (kHalf - kFracBits);",
         "const int t = __float_as_int(to_f(e[i])) << 14;"),
        ("      near |= static_cast<unsigned>(((t + 1) & (2 * kHalf - 1))) <= 2u;\n", ""),
        ("        for (long long i = tid; i < nv; i += kThreads) m = fmaxf(m, IO::amax(src[i]));",
         "        for (long long i = tid; i < 0; i += kThreads) m = fmaxf(m, IO::amax(src[i]));"),
        ("      } else if (data && k > 0) {\n        quantize_group(k - 1, group_s);",
         "      } else if (data && k > 0) {\n        quantize_group(k - 1, mine);"),
        ("        group_s = await_group(words + 4 * (piece_of(k - 1) / p.parts), p.tag);\n"
         "      }\n      __syncthreads();", "      }\n      __syncthreads();"),
        ("    if (tid == kSync) group_s = await_group(words + 4 * (piece_of(k - 1) / "
         "p.parts), p.tag);\n", "")]}, {}),
    "t_nosync": ({"edit": [
        ("      } else if (data && k > 0) {\n        quantize_group(k - 1, group_s);",
         "      } else if (data && k > 0) {\n        quantize_group(k - 1, mine);"),
        ("        group_s = await_group(words + 4 * (piece_of(k - 1) / p.parts), p.tag);\n"
         "      }\n      __syncthreads();", "      }\n      __syncthreads();"),
        ("    if (tid == kSync) group_s = await_group(words + 4 * (piece_of(k - 1) / "
         "p.parts), p.tag);\n", "")]}, {}),
    "t_nomath": ({"edit": [
        ("const int t = __float_as_int(fmaf(to_f(e[i]), r, kFrac)) + (kHalf - kFracBits);",
         "const int t = __float_as_int(to_f(e[i])) << 14;"),
        ("      near |= static_cast<unsigned>(((t + 1) & (2 * kHalf - 1))) <= 2u;\n", "")]},
        {}),
}

#: chip_smoke.py phase 19's cases: (shape, groups, dtype name)
CASES = [((k, n), g, "bfloat16") for k, n in
         ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
         for g in (64, 16)] + [((4096, 4096), 4096 * 4096 // 128,
                                "bfloat16"),
                               ((4096, 4096), 64, "float32")]


def spec(name: str):
    """Source and wrapper constants of a variant name (parts joined by
    "+")."""
    src, wrap = {}, {}
    for part in name.split("+"):
        s, w = VARIANTS[part]
        src, wrap = {**src, **s}, {**wrap, **w}
    return src, wrap


def variant_source(text: str, consts: dict) -> str:
    """The source with constants set (``edit``: a text replaced once)."""
    for field, value in consts.items():
        if field == "edit":
            for old, new in value:
                assert text.count(old) == 1, old
                text = text.replace(old, new)
            continue
        text, n = re.subn(rf"(constexpr int {field} = )[^;]+;",
                          rf"\g<1>{value};", text)
        assert n == 1, field
    return text


def lib_key(consts: dict) -> str:
    """A library's name by its source constants."""
    if not consts:
        return "current"
    return "lib" + hashlib.sha256(repr(sorted(consts.items())).encode()
                                  ).hexdigest()[:10]


def build_all(build_dir: Path, names, parent):
    """One library a distinct source (the tree's, each source variant's,
    the parent's), all ``nvcc`` runs together."""
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "quantizer.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        consts = spec(name)[0] if name != "current" else {}
        key = lib_key(consts)
        if key in jobs:
            continue
        cu = build_dir / f"{key}.cu"
        cu.write_text(variant_source(src, consts))
        jobs[key] = (_build.nvcc_command(cu, build_dir / f"lib{key}.so"),
                     build_dir / f"lib{key}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "quantizer.cu", lib)
        jobs["parent"] = (cmd[:1] + ["-I", str(parent)] + cmd[1:], lib)
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, (cmd, _) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log[-4000:]}")
        usage, fn = [], "?"
        for line in log.splitlines():
            entry = re.search(r"entry function '(\S+)'", line)
            fn = entry.group(1) if entry else fn
            if ("registers" in line or "spill" in line) and "quant" in fn:
                usage.append(f"{fn[:48]}: {line.split(':')[-1].strip()}")
        print(f"[build] {key}: {usage}", flush=True)
        libs[key] = ctypes.CDLL(str(jobs[key][1]))
    return libs


class Parent:
    """The parent's two-pass kernel through its C interface (x, q, scale,
    absmax scratch, groups, n, stream), the scratch allocated a call."""

    def __init__(self, lib):
        self.fn = lib.dstt_quantize_int8
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, x, groups):
        import torch

        from deepspeed_tpu_torch.ops import quantizer as tq

        n = x.numel() // groups
        q = torch.empty((groups, n), dtype=torch.int8, device=x.device)
        scale = torch.empty((groups,), dtype=torch.float32, device=x.device)
        absmax = torch.empty((groups,), dtype=torch.float32, device=x.device)
        rc = self.fn(tq._DTYPE_CODE[x.dtype], x.data_ptr(), q.data_ptr(),
                     scale.data_ptr(), absmax.data_ptr(), groups, n,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel failed with {rc}")
        return q, scale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import quantizer as tq

    names = ["current"] + [v for v in args.variants.split(",") if v]
    t0 = time.perf_counter()
    libs = build_all(ROOT / "build" / "quant_variants", names, args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    parent = Parent(libs["parent"]) if args.parent else None
    defaults = {k: getattr(tq, k) for k in (
        "QUANT_THREADS", "QUANT_PIECE", "QUANT_PIECE_BLOCK", "QUANT_NBUF",
        "QUANT_NBUF_GROUP")}

    def use(name):
        """The quantize call of a variant (x, groups) -> (q, scale)."""
        if name == "parent":
            return parent
        src, wrap = spec(name) if name != "current" else ({}, {})
        _build._LIBS["quantizer"] = libs[lib_key(src)]
        tq._kernel.cache_clear()
        tq._resident.cache_clear()
        for k, v in {**defaults, **wrap}.items():
            setattr(tq, k, v)
        return tq.quantize_kernel

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    timed = names + (["parent"] if parent else [])
    rows, failed = [], []
    for shape, groups, dtype in CASES:
        dt = getattr(torch, dtype)
        elt = torch.tensor([], dtype=dt).element_size()
        sets = cs.n_sets(math.prod(shape) * (elt + 1))
        xs = [(torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)
              for _ in range(sets)]
        xs[0].view(groups, -1)[0] = 0
        want_q, want_s = tq.quantize_plain(xs[0], groups)
        for name in timed:
            if any(part.startswith("t_") for part in name.split("+")):
                continue                      # timing only
            fn = use(name)
            runs = [fn(xs[0], groups) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(q, want_q) and torch.equal(s, want_s)
                       for q, s in runs):
                failed.append((name, shape, groups, dtype))
        big = xs[0].numel() * elt > 100e6
        times = {}
        for r in range(args.rounds):
            for name in (timed if r % 2 == 0 else timed[::-1]):
                fn = use(name)
                times.setdefault(name, []).append(cs.time_ms(
                    lambda i: fn(xs[i], groups), sets,
                    args.iters // 3 if big else args.iters))
        plans, a_call = {}, {}
        for name in timed:
            fn = use(name)
            a_call[name] = cs.launches_a_call(torch, lambda: fn(xs[0],
                                                                groups))
            if name != "parent":
                p = tq.launch_plan(xs[0], groups)
                plans[name] = {k: p[k] for k in (
                    "route", "piece", "gpp", "parts", "nbuf", "smem",
                    "grid")}
        use("current")
        b_ms, b_by = cs.quantizer_bound(xs[0].numel(), groups, elt)
        row = {"shape": list(shape), "groups": groups, "dtype": dtype,
               "ms": times, "best_ms": {k: min(v) for k, v in times.items()},
               "bound_ms": b_ms, "bound_by": b_by, "plans": plans,
               "a_call": a_call}
        rows.append(row)
        print(f"[time] {shape} G={groups} {dtype}: " + ", ".join(
            f"{k} {min(v):.4f}" for k, v in times.items())
            + f" (bound {b_ms:.4f}); a call: "
            + ", ".join(f"{k} {v['kernels']}k/{v['memsets']}m"
                        for k, v in a_call.items() if v), flush=True)
        del xs
    print(f"[check] {len(timed)} variants x {len(CASES)} cases: "
          f"{'ok' if not failed else failed}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    out = {"card": card, "rows": rows, "failed": failed}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "quant_variants.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({"card": card, "failed": len(failed), "best_ms": {
        f"{r['shape'][0]}x{r['shape'][1]} G{r['groups']} {r['dtype']}":
        r["best_ms"] for r in rows}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
