"""Launch-shape variants of the Evoformer kernels against each other on
one card, and against a parent commit's kernels.

Builds ``csrc/evoformer_attn.cu`` as it stands and copies of it with the
edits of each named variant (other ``EvoTiles`` choices for the
tensor-core kernel: consumer warpgroups a block and blocks an SM; other
``GenTiles`` keys a step for the general kernel), checks each library
against the dense version on small cases (3e-2 max, 1e-2 in norm, fp32
1e-4 max, two runs bit-equal), then times every library on the cases of
``chip_smoke.py`` phase 22 with its ``time_ms`` (operand sets that miss
L2, a device-side sleep first), in turns: the libraries in order, then in
reverse, each case's best of the two.

    python3 deepspeed_tpu_torch/tools/evo_variants.py \\
        [--variants c4,c2x1,g32] [--parent DIR] [--iters 20] [--cases 0,4]

``--parent DIR`` also builds ``DIR/evoformer_attn.cu`` (a parent commit's
source, from ``git archive <commit> deepspeed_tpu_torch/csrc``; headers
from DIR first, then ``csrc/``) as the library "parent", called through
the same C interface and route as the tree's (a parent with another C
interface is not taken).  A summary JSON object is the last line
of stdout; every timing is also written to ``chiprun_out/evo_variants.json``.
Needs a CUDA device and ``nvcc``.
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
    # the general kernel's keys a step: 32 or 64 at every head dim
    "g32": [("static constexpr int kKeys = sizeof(T) == 4 || DP > 32 ? 32 : 64;",
             "static constexpr int kKeys = 32;")],
    "g64": [("static constexpr int kKeys = sizeof(T) == 4 || DP > 32 ? 32 : 64;",
             "static constexpr int kKeys = 64;")],
    "stages2": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;")],
    "stages8": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 8;")],
    # cp.async tiles streamed a step instead of resident a block
    "noresident": [("for (int resident = 1; resident >= 0; --resident) {",
                    "for (int resident = 0; resident >= 0; --resident) {")],
    # timing only (wrong results): what the exponentials and the whole
    # softmax cost, and where a block's time goes
    "t_noexp": [("s[j] = exp2_ftz(s[j] - base[hr]);", "s[j] = s[j] - base[hr];")],
    "t_prof": "prof",
    # the general kernel, timing only: no products (nor their fragment
    # loads and splits), one TF32 product instead of three, no K / V loads
    # after the first step's, no softmax
    # the general kernel's block: 8 warps; one 16-row tile a warp
    "w8": [("constexpr int kGenWarps = 4;", "constexpr int kGenWarps = 8;")],
    "tiles1": [("static constexpr int kRowTiles = DP <= 64 ? 2 : 1;",
                "static constexpr int kRowTiles = 1;")],
    "t_gprof": "gprof",
    "t_gnoproducts": [("        for (int u = 0; u < TL; ++u) mma_parts<kSplit>(quad(s[u], nb), ah[u], al[u], bh, bl);\n", "        {}\n"),
                      ("        for (int u = 0; u < TL; ++u) mma_parts<kSplit>(quad(acc[u], nd), ah[u], al[u], bh, bl);\n", "        {}\n")],
    "t_gone": [("  if constexpr (SPLIT) {   // the split's cross terms",
                "  if constexpr (false) {")],
    "t_gnoload": [("    copy_rows<T, G::kLdk>(reinterpret_cast<T*>(st), kb, pitch, i * BK, BK, a.sk, a.d, vec);\n",
                   "    if (i == 0)\n    copy_rows<T, G::kLdk>(reinterpret_cast<T*>(st), kb, pitch, i * BK, BK, a.sk, a.d, vec);\n"),
                  ("    copy_rows<T, G::kLdv>(reinterpret_cast<T*>(st + G::kKBytes), vb, pitch, i * BK, BK, a.sk,\n",
                   "    if (i == 0)\n    copy_rows<T, G::kLdv>(reinterpret_cast<T*>(st + G::kKBytes), vb, pitch, i * BK, BK, a.sk,\n")],
    "t_gnosoftmax": [("      step_softmax<BK>(s[u], m[u], lsum[u], corr, rowb[u], gb, a, st, nullptr, i, lr[u], t,\n                       kRows);",
                      "      corr[0] = corr[1] = 1.f;")],
    "t_nosoftmax": [("auto softmax = [&](int i, int step, float (&corr)[2]) {\n",
                     "auto softmax = [&](int i, int step, float (&corr)[2]) {\n"
                     "      corr[0] = corr[1] = 1.f;\n      return;\n")],
}

#: small cases for the correctness check: lead, S, heads, d, biases, type
#: (the last three on the general kernel)
CHECK_CASES = [
    ((1, 16), 256, 4, 32, "both", "bf16"),
    ((1, 8), 250, 4, 32, "three", "bf16"),
    ((1, 8), 256, 8, 8, "eight", "fp16"),
    ((2, 3), 70, 2, 64, "masked", "bf16"),
    ((1, 16), 256, 4, 32, "both", "fp32"),
    ((1, 8), 250, 4, 32, "eight", "fp32"),
    ((1, 8), 100, 2, 12, "three", "bf16"),
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
#: the general kernel's profiling counters (clock64 cycles of its thread
#: 0, summed over blocks): the wait for a step's tiles (cp.async and the
#: barrier), issuing the next step's copies, S, the softmax, P V, the
#: epilogue, the prologue (to the first wait) and the whole block
GPROF_SLOTS = ("g_wait", "g_load", "g_s", "g_softmax", "g_pv", "g_epilogue",
               "g_prologue", "g_total")

GPROF_EDITS = [
    ("  __shared__ long long goff[kMaxBiases];",
     "  __shared__ long long goff[kMaxBiases];\n  unsigned long long pf[8] = {0};\n"
     "  const unsigned long long pf_t0 = clock64();"),
    ("    cp_async_wait<0>();\n    __syncthreads();                              // step i landed; step i - 1 read\n"
     "    if (i + 1 < steps) load(i + 1);",
     "    if (i == 0) pf[6] += clock64() - pf_t0;\n"
     "    { const auto tc = clock64(); cp_async_wait<0>();\n    __syncthreads(); pf[0] += clock64() - tc; }\n"
     "    { const auto tc = clock64(); if (i + 1 < steps) load(i + 1); pf[1] += clock64() - tc; }"),
    ("    // S = Q K^T: k step kk takes dims 8 kk .. 8 kk + 7, each K fragment",
     "    const auto pf_s = clock64();\n    // S = Q K^T: k step kk takes dims 8 kk .. 8 kk + 7, each K fragment"),
    ("#pragma unroll\n    for (int u = 0; u < TL; ++u) {\n      float corr[2];",
     "    pf[2] += clock64() - pf_s;\n    const auto pf_m = clock64();\n"
     "#pragma unroll\n    for (int u = 0; u < TL; ++u) {\n      float corr[2];"),
    ("    // O += round(P) V: key block kb",
     "    pf[3] += clock64() - pf_m;\n    const auto pf_p = clock64();\n    // O += round(P) V: key block kb"),
    ("      }\n    }\n  }\n  cp_async_wait<0>();                             // (no step: nothing left in flight)",
     "      }\n    }\n    pf[4] += clock64() - pf_p;\n  }\n  const auto pf_e = clock64();\n"
     "  cp_async_wait<0>();                             // (no step: nothing left in flight)"),
    ("        if (c + 1 < a.d) orow[c + 1] = from_f<T>(acc[u][4 * nd + 2 * hr + 1] * inv);\n      }\n    }\n  }\n}\n",
     "        if (c + 1 < a.d) orow[c + 1] = from_f<T>(acc[u][4 * nd + 2 * hr + 1] * inv);\n      }\n    }\n  }\n"
     "  pf[5] += clock64() - pf_e;\n  pf[7] = clock64() - pf_t0;\n"
     "  if (threadIdx.x == 0)\n    for (int x = 0; x < 8; ++x) atomicAdd(&g_prof[x], pf[x]);\n}\n"),
    ("template <typename T, int DP, int BK>\n__global__ void __launch_bounds__(kGenThreads)",
     "__device__ unsigned long long g_prof[16];\n\n"
     "template <typename T, int DP, int BK>\n__global__ void __launch_bounds__(kGenThreads)"),
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
    if spec in ("prof", "gprof"):
        edits = PROF_EDITS if spec == "prof" else GPROF_EDITS
        return variant_source(text, edits) + PROF_TAIL
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
        return evo.evoformer_attention_kernel(q, k, v, bs)

    failed = []
    for name in names + (["parent"] if args.parent else []):
        if name.startswith("t_"):
            continue                     # timing-only variants
        use(name)
        for c in CHECK_CASES:
            gen = torch.Generator(device=dev).manual_seed(len(failed) + 7)
            q, k, v, bs = cs.evo_operands(torch, gen, dev, *c)
            got, again = run(name, q, k, v, bs), run(name, q, k, v, bs)
            want = evo.evoformer_attention_dense(q, k, v, bs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (cs.evo_bar_met(c[-1], err, cs.rel_norm(got, want))
                    and torch.equal(got, again)):
                failed.append((name, c, err))
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
            use(name)
            t = cs.time_ms(lambda i: run(name, *ops[i][:3], ops[i][3]), sets,
                           args.iters)
            if name in ("t_prof", "t_gprof") and name not in prof:
                raw = (ctypes.c_ulonglong * 16)()
                prof_fn = libs[name].dstt_evo_prof
                prof_fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
                prof_fn.restype = ctypes.c_int
                prof_fn(raw)                        # reset the sums
                run(name, *ops[0][:3], ops[0][3])
                prof_fn(raw)
                grid = evo.launch_info()["grid"]
                slots = PROF_SLOTS if name == "t_prof" else GPROF_SLOTS
                prof[name] = {k: raw[i] / grid for i, k in enumerate(slots)}
                print(f"[prof] {name} {label}: " + " ".join(
                    f"{k} {v:.0f}" for k, v in prof[name].items()), flush=True)
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
