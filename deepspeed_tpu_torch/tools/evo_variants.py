"""Launch-shape variants of the Evoformer tensor-core kernel against each
other on one card, and against a parent commit's kernels.

Builds ``csrc/evoformer_attn.cu`` as it stands and copies of it with the
edits of each named variant (other ``EvoTiles`` choices: consumer
warpgroups a block and blocks an SM), checks each library against the
dense version on small cases (3e-2 max, 1e-2 in norm, two runs bit-equal),
then times every library on the cases of ``chip_smoke.py`` phase 22 with
its ``time_ms`` (operand sets that miss L2, a device-side sleep first), in
turns: the libraries in order, then in reverse, each case's best of the
two.

    python3 deepspeed_tpu_torch/tools/evo_variants.py \\
        [--variants c4,c2x1] [--parent DIR] [--iters 20] [--cases 0,4]

``--parent DIR`` also builds ``DIR/evoformer_attn.cu`` (a parent commit's
source, from ``git show <commit>:deepspeed_tpu_torch/csrc/evoformer_attn.cu``;
headers from DIR first, then ``csrc/``) as the library "parent", called
through the parent's C interface and route (its tensor-core kernel for at
most two biases of Q's type, else its general kernel).  A summary JSON
object is the last line of stdout; every timing is also written to
``chiprun_out/evo_variants.json``.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: name -> {padded head dim: {EvoTiles field: value}}, or a list of (text,
#: replacement) edits of the source
VARIANTS = {
    "c4": {16: {"kC": 4, "kPerSm": 1}, 32: {"kC": 4, "kPerSm": 1}},
    "c2x1": {16: {"kC": 2, "kPerSm": 1}, 32: {"kC": 2, "kPerSm": 1}},
    "c1x2": {16: {"kC": 1, "kPerSm": 2}, 32: {"kC": 1, "kPerSm": 2}},
    "c1x3": {16: {"kC": 1, "kPerSm": 3}, 32: {"kC": 1, "kPerSm": 3}},
    "c1x2k128": {dp: {"kC": 1, "kPerSm": 2, "kKeys": 128} for dp in (16, 32, 64)},
    "c2x1k128": {dp: {"kC": 2, "kPerSm": 1, "kKeys": 128} for dp in (16, 32, 64)},
    "d64x2": {64: {"kPerSm": 2}},
    "d64c1x2k128": {64: {"kC": 1, "kPerSm": 2, "kKeys": 128}},
    "stages2": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;")],
    "stages8": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 8;")],
    # cp.async tiles streamed a step instead of resident a block
    "noresident": [("for (int resident = 1; resident >= 0; --resident) {",
                    "for (int resident = 0; resident >= 0; --resident) {")],
    # timing only (wrong results): what the exponentials and the whole
    # softmax cost, and where a block's time goes
    "t_noexp": [("s[j] = exp2_ftz(s[j] - base[hr]);", "s[j] = s[j] - base[hr];")],
    "t_prof": "prof",
    "t_nosoftmax": [("auto softmax = [&](int i, int step, float (&corr)[2]) {\n",
                     "auto softmax = [&](int i, int step, float (&corr)[2]) {\n"
                     "      corr[0] = corr[1] = 1.f;\n      return;\n")],
}

#: small cases for the correctness check: lead, S, heads, d, biases, type
CHECK_CASES = [
    ((1, 16), 256, 4, 32, "both", "bf16"),
    ((1, 8), 250, 4, 32, "three", "bf16"),
    ((1, 8), 256, 8, 8, "eight", "fp16"),
    ((2, 3), 70, 2, 64, "masked", "bf16"),
]


#: the profiling variant's counters (clock64 cycles summed over blocks):
#: the first consumer thread's waits and phases, the producer's first
#: thread and first lane
PROF_SLOTS = ("c_full_wait", "c_q_wait", "c_qk_wait", "c_softmax",
              "c_pv_wait", "c_epilogue", "c_total", "c_steps",
              "p0_empty_wait", "p0_total", "p1_empty_wait", "p1_copies",
              "p1_total")

PROF_EDITS = [
    ("  __shared__ TileBias sb[kMaxBiases];",
     "  __shared__ TileBias sb[kMaxBiases];\n  unsigned long long pf[16] = {0};\n"
     "  const unsigned long long pf_t0 = clock64();"),
    ("        if (g >= ns) mbar_wait(&empty[st], ((g / ns) & 1) ^ 1);",
     "        { const auto t = clock64(); if (g >= ns) mbar_wait(&empty[st], "
     "((g / ns) & 1) ^ 1); pf[pt == 0 ? 8 : 10] += clock64() - t; }\n"
     "        const auto pf_c = clock64();"),
    ("          mbar_arrive(&full[st]);\n          cp_async_arrive(&full[st]);",
     "          mbar_arrive(&full[st]);\n          cp_async_arrive(&full[st]);\n"
     "          pf[11] += clock64() - pf_c;"),
    ("      mbar_wait(&q_full[qb], (k >> 1) & 1);",
     "      { const auto t = clock64(); mbar_wait(&q_full[qb], (k >> 1) & 1); "
     "pf[1] += clock64() - t; }"),
    ("        mbar_wait(&full[g % ns], (g / ns) & 1);",
     "        { const auto t = clock64(); mbar_wait(&full[g % ns], (g / ns) & 1); "
     "pf[0] += clock64() - t; pf[7] += 1; }"),
    ("          mbar_wait(&full[step % ns], (step / ns) & 1);",
     "          { const auto t = clock64(); mbar_wait(&full[step % ns], "
     "(step / ns) & 1); pf[0] += clock64() - t; pf[7] += 1; }"),
    ("          wgmma_wait<1>();",
     "          { const auto t = clock64(); wgmma_wait<1>(); pf[2] += clock64() - t; }"),
    ("          softmax(i, step, corr);",
     "          { const auto t = clock64(); softmax(i, step, corr); pf[3] += clock64() - t; }"),
    ("          wgmma_wait<0>();\n          fence_all(acc);",
     "          { const auto t = clock64(); wgmma_wait<0>(); pf[4] += clock64() - t; }\n"
     "          fence_all(acc);"),
    ("      // normalise, stage the rows (rounded) in this warpgroup's rows of the",
     "      const auto pf_e = clock64();\n"
     "      // normalise, stage the rows (rounded) in this warpgroup's rows of the"),
    ("      release(&q_empty[qb]);\n    }\n  }\n}\n",
     "      release(&q_empty[qb]);\n      pf[5] += clock64() - pf_e;\n    }\n"
     "    if (threadIdx.x == 128) {\n      pf[6] = clock64() - pf_t0;\n"
     "      for (int x = 0; x < 8; ++x) atomicAdd(&g_prof[x], pf[x]);\n    }\n"
     "  }\n}\n"),
    ("          cp_async_arrive(&full[st]);\n          pf[11] += clock64() - pf_c;\n"
     "        }\n      }\n    }\n  } else {",
     "          cp_async_arrive(&full[st]);\n          pf[11] += clock64() - pf_c;\n"
     "        }\n      }\n    }\n"
     "    if (pt == 0) { atomicAdd(&g_prof[8], pf[8]); "
     "atomicAdd(&g_prof[9], clock64() - pf_t0); }\n"
     "    if (pt == 1) { atomicAdd(&g_prof[10], pf[10]); atomicAdd(&g_prof[11], pf[11]); "
     "atomicAdd(&g_prof[12], clock64() - pf_t0); }\n"
     "  } else {"),
    ("template <typename T, int DP, int C, int PER_SM, int BK>\n__global__",
     "__device__ unsigned long long g_prof[16];\n\n"
     "template <typename T, int DP, int C, int PER_SM, int BK>\n__global__"),
]
PROF_TAIL = """
extern "C" int dstt_evo_prof(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long zero[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
}
"""


def variant_source(text: str, spec) -> str:
    """The kernel source with one variant's edits (a name joined by "+":
    each part's edits in turn)."""
    if isinstance(spec, str) and "+" in spec:
        for part in spec.split("+"):
            text = variant_source(text, VARIANTS[part])
        return text
    if spec == "prof":
        return variant_source(text, PROF_EDITS) + PROF_TAIL
    if isinstance(spec, list):
        for old, new in spec:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        return text
    for dp, fields in spec.items():
        start = text.index(f"struct EvoTiles<{dp}> {{")
        end = text.index("};", start)
        block = text[start:end]
        for field, value in fields.items():
            block, n = re.subn(rf"\b{field} = \d+", f"{field} = {value}", block)
            assert n == 1, (dp, field)
        text = text[:start] + block + text[end:]
    return text


def build_all(build_dir: Path, names, parent):
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "evoformer_attn.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build_dir / f"{name}.cu"
        cu.write_text(src if name == "current" else
                      variant_source(src, VARIANTS.get(name, name)))
        jobs[name] = (_build.nvcc_command(cu, build_dir / f"lib{name}.so"),
                      build_dir / f"lib{name}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "evoformer_attn.cu", lib)
        jobs["parent"] = (cmd[:1] + ["-I", str(parent)] + cmd[1:], lib)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n, (cmd, _) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and " 0 bytes spill stores" not in line})
        print(f"[build] {name}: ok; spills: {spills or 'none'}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    return libs


def parent_call(lib, q, k, v, bs):
    """One forward through the parent's C interface and route."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import evoformer_attn as evo

    fn = lib.dstt_evoformer_fwd
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2
                   + [ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    *lead, sq, h, d = q.shape
    lead = tuple(lead)
    sk = k.shape[-3]
    n = len(lead)
    simt = not (q.dtype != torch.float32 and d % 8 == 0 and d <= 128
                and len(bs) <= 2 and all(b.dtype == q.dtype for b in bs))
    out = torch.empty_like(q)
    ptrs, tables, codes, strides = [], [], [], []
    for b in bs:
        c = evo._canon_bias(b, lead, h, sq, sk)
        st = c.expand(lead + (h, sq, sk)).stride()
        tables.append(evo._lead_table(lead, tuple(c.shape[:n]), st[:n],
                                      q.device).data_ptr())
        ptrs.append(c.data_ptr())
        codes.append(evo._DTYPE_CODE[c.dtype])
        strides.extend(st[n:])
    nb = len(bs)
    rc = fn(evo._DTYPE_CODE[q.dtype], int(simt), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), int(np.prod(lead)), sq, sk, h, d,
            nb, (ctypes.c_void_p * max(nb, 1))(*ptrs),
            (ctypes.c_void_p * max(nb, 1))(*tables),
            (ctypes.c_int * max(nb, 1))(*codes),
            (ctypes.c_longlong * max(3 * nb, 1))(*strides),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent kernel failed with {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default=None,
                    help="indices into chip_smoke.EVO_CASES (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import evoformer_attn as evo

    names = ["current"] + [v for v in args.variants.split(",") if v]
    t0 = time.perf_counter()
    libs = build_all(ROOT / "build" / "evo_variants", names, args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)

    def use(name):
        _build._LIBS["evoformer_attn"] = libs[name]
        evo._kernel.cache_clear()

    def run(name, q, k, v, bs):
        if name == "parent":
            return parent_call(libs["parent"], q, k, v, bs)
        return evo.evoformer_attention_kernel(q, k, v, bs)

    failed = []
    for name in names + (["parent"] if args.parent else []):
        if name.startswith("t_"):
            continue                     # timing-only variants
        if name != "parent":
            use(name)
        for c in CHECK_CASES:
            gen = torch.Generator(device=dev).manual_seed(len(failed) + 7)
            q, k, v, bs = cs.evo_operands(torch, gen, dev, *c)
            got, again = run(name, q, k, v, bs), run(name, q, k, v, bs)
            want = evo.evoformer_attention_dense(q, k, v, bs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (err <= cs.TOL and cs.rel_norm(got, want) <= cs.NORM_TOL
                    and torch.equal(got, again)):
                failed.append((name, c))
    print(f"[check] {len(names)} libraries x {len(CHECK_CASES)} cases: "
          f"{'ok' if not failed else failed}", flush=True)

    if args.parent is not None:
        names.append("parent")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    cases = (cs.EVO_CASES if args.cases is None else
             [cs.EVO_CASES[int(i)] for i in args.cases.split(",")])
    for case in cases:
        label, lead, s, h, d, biases, dtype = case[:7]
        sets = cs.evo_sets(torch, lead, s, h, d, dtype)
        ops = [cs.evo_operands(torch, gen, dev, lead, s, h, d, biases, dtype)
               for _ in range(sets)]
        best, info, prof = {}, {}, {}
        for name in names + names[::-1]:
            if name != "parent":
                use(name)
            t = cs.time_ms(lambda i: run(name, *ops[i][:3], ops[i][3]), sets,
                           args.iters)
            if name.startswith("t_prof") and name not in prof:
                raw = (ctypes.c_ulonglong * 16)()
                prof_fn = libs[name].dstt_evo_prof
                prof_fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
                prof_fn.restype = ctypes.c_int
                prof_fn(raw)                        # reset the sums
                run(name, *ops[0][:3], ops[0][3])
                prof_fn(raw)
                grid = evo.launch_info()["grid"]
                prof[name] = {k: raw[i] / grid for i, k in enumerate(PROF_SLOTS)}
                print(f"[prof] {name} {label}: " + " ".join(
                    f"{k} {v:.0f}" for k, v in prof[name].items()), flush=True)
            if name != "parent" and evo.kernel_route(*ops[0][:3],
                                                     ops[0][3]) == "mma":
                info[name] = evo.launch_info()
            best[name] = min(t, best.get(name, t))
        del ops
        torch.cuda.empty_cache()
        print(f"[time] {label}: " + " | ".join(
            f"{n} {t:.4f}" for n, t in best.items()), flush=True)
        rows.append({"case": label, "ms": best, "launch": info,
                     "prof": prof})

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    (out / "evo_variants.json").write_text(json.dumps(
        {"device": smi, "variants": {n: VARIANTS.get(n) for n in names},
         "failed": [list(map(str, f)) for f in failed], "cases": rows},
        indent=1, default=str))
    print(smi)
    print(json.dumps({"ok": not failed, "device": smi,
                      "libraries": names, "cases": len(rows)}))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
