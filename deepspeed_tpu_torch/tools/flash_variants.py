"""Tile variants of the flash-attention kernels against each other on one
card, and against a parent commit's kernels.

Builds ``csrc/flash_attention.cu`` as it stands and copies of it with the
edits of each named variant (other ``Tiles`` choices, the forward's
warpgroup turns taken out), checks each variant's forward, dQ and dK/dV
against the plain versions on small cases (3e-2 of the largest magnitude,
1e-2 in norm, two runs bit-equal), then times every library on the shapes
of ``chip_smoke.py`` phases 6 and 16 with its ``time_ms`` (operand sets
that miss L2, a device-side sleep first), in turns: the libraries in
order, then in reverse, each case's best of the two.

    python3 deepspeed_tpu_torch/tools/flash_variants.py \\
        [--variants c2,noturn] [--parent DIR] [--iters 20]

``--parent DIR`` also builds ``DIR/flash_attention.cu`` (a parent commit's
source, from ``git show <commit>:deepspeed_tpu_torch/csrc/flash_attention.cu``;
headers from DIR first, then ``csrc/``) as the library "parent".  A summary
JSON object is the last line of stdout; every timing is also written to
``chiprun_out/flash_variants.json``.  Needs a CUDA device and ``nvcc``.
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

#: name -> {head dim: {Tiles field: value}}, or "noturn"
VARIANTS = {
    "c2": {64: {"kFwdC": 2, "kDqC": 2, "kDkvC": 2}, 128: {"kDkvC": 2}},
    "c1": {128: {"kFwdC": 1, "kFwdKeys": 64, "kFwdStages": 2, "kDqC": 1,
                 "kDqStages": 2}},
    "stages2": {64: {"kFwdStages": 2, "kDqStages": 2, "kDkvStages": 2},
                128: {"kFwdStages": 2, "kDqStages": 2, "kDkvStages": 2}},
    "fwd_keys64": {64: {"kFwdKeys": 64}, 128: {"kFwdKeys": 64}},
    "dq_keys128": {64: {"kDqKeys": 128}},
    "noturn": "noturn",
}

#: small cases for the correctness check: b, sq, sk, h, hkv, d, window, fused
CHECK_CASES = [
    (1, 200, 200, 4, 2, 64, None, None),
    (2, 333, 333, 4, 1, 128, 77, None),
    (2, 1, 300, 4, 2, 128, None, None),
    (3, 200, 200, 4, 2, 64, None, None),
    (2, 512, 512, 8, 2, 128, None, "qkv"),
]
#: timed cases: chip_smoke.py phases 6 and 16
TIME_CASES = [
    ("bench B8 S1024 H12 D64", (8, 1024, 1024, 12, 12, 64, None, None)),
    ("70B heads B2 S2048 H64/8 D128", (2, 2048, 2048, 64, 8, 128, None, None)),
    ("window 256 B2 S2048 H8 D64", (2, 2048, 2048, 8, 8, 64, 256, None)),
    ("rect Sq512 Sk1024 B2 H8 D64", (2, 512, 1024, 8, 8, 64, None, None)),
    ("bench width B2 S4096 H12 D64", (2, 4096, 4096, 12, 12, 64, None, None)),
    ("gpt2 c_attn views", (8, 1024, 1024, 12, 12, 64, None, "qkv")),
    ("B16 S1024 H6 D128", (16, 1024, 1024, 6, 6, 128, None, None)),
    ("70B heads qkv_proj views", (2, 2048, 2048, 64, 8, 128, None, "qkv")),
]


def variant_source(text: str, spec) -> str:
    """The kernel source with one variant's edits."""
    if spec == "noturn":
        out = re.sub(r"\n\s*if constexpr \(C == 2\) named_barrier(_arrive)?\([^;]*;",
                     "", text)
        assert out != text, "no warpgroup turns found"
        return out
    for d, fields in spec.items():
        start = text.index(f"struct Tiles<{d}> {{")
        end = text.index("};", start)
        block = text[start:end]
        for field, value in fields.items():
            block, n = re.subn(rf"\b{field} = \d+", f"{field} = {value}", block)
            assert n == 1, (d, field)
        text = text[:start] + block + text[end:]
    return text


def build_all(build_dir: Path, names, parent):
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build_dir / f"{name}.cu"
        cu.write_text(src if name == "current" else
                      variant_source(src, VARIANTS[name]))
        jobs[name] = (_build.nvcc_command(cu, build_dir / f"lib{name}.so"),
                      build_dir / f"lib{name}.so")
    if parent is not None:
        lib = build_dir / "libparent.so"
        cmd = _build.nvcc_command(parent / "flash_attention.cu", lib)
        jobs["parent"] = (cmd[:1] + ["-I", str(parent)] + cmd[1:], lib)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n, (cmd, _) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        notes = sorted({line.split(")")[0] + ")" for line in log.splitlines()
                        if "(C75" in line})
        print(f"[build] {name}: ok {notes or ''}", flush=True)
        libs[name] = ctypes.CDLL(str(jobs[name][1]))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))        # chip_smoke.py and the package

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa

    names = ["current"] + [v for v in args.variants.split(",") if v]
    t0 = time.perf_counter()
    libs = build_all(ROOT / "build" / "flash_variants", names, args.parent)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)

    def use(name):
        _build._LIBS["flash_attention"] = libs[name]
        fa._kernel.cache_clear()

    def inputs(b, sq, sk, h, hkv, d, fused, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)

        if fused == "qkv":
            q, k, v = (t.unflatten(-1, (-1, d)) for t in rand(
                b, sq, (h + 2 * hkv) * d).split([h * d, hkv * d, hkv * d], -1))
        else:
            q, k, v = rand(b, sq, h, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d)
        return (q.float() * d ** -0.5).to(q.dtype), k, v, rand(b, sq, h, d)

    def run(qs, k, v, do, window, plain=False):
        scale = qs.shape[-1] ** -0.5
        if plain:
            o, lse = fa.flash_attention_plain_fwd(qs, k, v, window=window)
            dq, delta = fa.flash_attention_plain_bwd_dq(
                qs, k, v, o, do, lse, scale=scale, window=window)
            dk, dv = fa.flash_attention_plain_bwd_dkv(qs, k, v, do, lse, delta,
                                                      window=window)
        else:
            o, lse = fa.flash_attention_fwd(qs, k, v, True, window)
            dq, delta = fa.flash_attention_bwd_dq(qs, k, v, o, do, lse, scale,
                                                  True, window)
            dk, dv = fa.flash_attention_bwd_dkv(qs, k, v, do, lse, delta, True,
                                                window)
        return {"o": o, "lse": lse, "delta": delta, "dq": dq, "dk": dk, "dv": dv}

    failed = []
    for name in names:
        use(name)
        for c in CHECK_CASES:
            b, sq, sk, h, hkv, d, window, fused = c
            x = inputs(b, sq, sk, h, hkv, d, fused, seed=sq + h)
            got, again, want = (run(*x, window), run(*x, window),
                                run(*x, window, plain=True))
            torch.cuda.synchronize()
            for key, w in want.items():
                g, w = got[key].float(), w.float()
                rel = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                if not (rel <= cs.TOL and cs.rel_norm(g, w) <= cs.NORM_TOL
                        and torch.equal(got[key], again[key])):
                    failed.append((name, c, key))
    print(f"[check] {len(names)} libraries x {len(CHECK_CASES)} cases: "
          f"{'ok' if not failed else failed}", flush=True)

    if args.parent is not None:
        names.append("parent")
    rows = []
    for label, (b, sq, sk, h, hkv, d, window, fused) in TIME_CASES:
        sets = cs.n_sets(2 * (2 * b * sq * h * d + 2 * b * sk * hkv * d))
        scale = d ** -0.5
        ops = []
        for i in range(sets):
            qs, k, v, do = inputs(b, sq, sk, h, hkv, d, fused, seed=i)
            o, lse = fa.flash_attention_plain_fwd(qs, k, v, window=window)
            o = o.contiguous()
            _, delta = fa.flash_attention_plain_bwd_dq(
                qs, k, v, o, do, lse, scale=scale, window=window)
            ops.append((qs, k, v, do, o, lse, delta))
        best = {}
        for name in names + names[::-1]:
            use(name)
            t = {"fwd": cs.time_ms(lambda i: fa.flash_attention_fwd(
                     *ops[i][:3], True, window), sets, args.iters),
                 "bwd_dq": cs.time_ms(lambda i: fa.flash_attention_bwd_dq(
                     *ops[i][:3], ops[i][4], ops[i][3], ops[i][5], scale,
                     True, window), sets, args.iters),
                 "bwd_dkv": cs.time_ms(lambda i: fa.flash_attention_bwd_dkv(
                     *ops[i][:3], ops[i][3], ops[i][5], ops[i][6], True,
                     window), sets, args.iters)}
            prev = best.get(name)
            best[name] = t if prev is None else {
                k: min(t[k], prev[k]) for k in t}
        del ops
        torch.cuda.empty_cache()
        print(f"[time] {label}: " + " | ".join(
            f"{n} " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
            for n, t in best.items()), flush=True)
        rows.append({"case": label, "ms": best})

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    (out / "flash_variants.json").write_text(json.dumps(
        {"device": smi, "variants": {n: VARIANTS.get(n) for n in names},
         "failed": [list(map(str, f)) for f in failed], "cases": rows},
        indent=1, default=str))
    print(smi)
    print(json.dumps({"ok": not failed, "device": smi,
                      "libraries": names, "cases": len(rows)}))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
