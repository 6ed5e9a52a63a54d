"""Crash-recovery smoke of the port (counterpart of ``tools/chaos_smoke.py``):
train, get KILLED mid-save by an injected fault, restart, auto-resume, and
prove bit-exact continuation.

    python3 deepspeed_tpu_torch/tools/chaos_smoke.py [--device cpu|cuda]

The trainer is the port's own engine: ``deepspeed_tpu_torch.initialize`` on
a Llama whose weights come from a seed, fed ``batch_fn(step)`` (token ids
drawn with numpy from ``SEED + step``).  On the card (``--device cuda``,
the default) it is the bench Llama (``bench.py:84-100``: hidden 768, 12
heads, vocab 32000, 8 x 1024 tokens, the bench ds_config in bf16) at 2
layers; on the CPU a tiny Llama (hidden 64, 2 layers, 2 x 32 tokens) in
fp32.  The worker raises when ``cuda`` is asked for and no GPU is visible.

The flow:

1. a straight run of ``TOTAL_STEPS`` engine steps (no loop, no saves) is
   the oracle;
2. a subprocess runs :class:`ResilientTrainLoop` (a checkpoint every
   ``SAVE_INTERVAL`` steps) with
   ``DS_CHAOS="crash_after_shard_write:after=1,exit_code=43"`` — the
   process hard-kills itself (``os._exit``) in the middle of its SECOND
   save;
3. the parent asserts that ``latest`` names the previous, fully verified
   tag and that the torn save exists only as its ``.tmp`` staging dir;
4. a fresh loop in the same directory ``auto_resume()``s and trains to
   the end; master weights, Adam moments and the post-resume losses must
   equal the straight run's bit for bit.

The last line printed is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TOTAL_STEPS = 12
SAVE_INTERVAL = 4
CRASH_EXIT_CODE = 43
SEED = 0

#: the bench Llama (bench.py:84-87) at 2 layers, and its ds_config
#: (bench.py:88-100)
CARD_MODEL = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                  num_hidden_layers=2, num_attention_heads=12,
                  num_key_value_heads=12, max_position_embeddings=2048)
CARD_BATCH = (8, 1024)
CARD_DS_CONFIG = {
    "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "zero_optimization": {"stage": 1},
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "attention_layout": "bshd",
}
#: a tiny Llama in fp32 for the CPU
CPU_MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64)
CPU_BATCH = (2, 32)
CPU_DS_CONFIG = {**{k: v for k, v in CARD_DS_CONFIG.items() if k != "bf16"},
                 "train_micro_batch_size_per_gpu": 2}


def resolve_device(device: str):
    """``"cpu"``, or ``"cuda"`` as ``cuda:{LOCAL_RANK}`` (a launcher's
    worker drives its own card); raises when no GPU is visible."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False: no GPU")
    # fp32 products in IEEE fp32 on every process, as chip_smoke.py sets
    # them: the resumed and the straight runs must take the same paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_engine(dev):
    """The port's training engine through ``initialize``, on a Llama with
    weights from ``SEED``."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    card = dev.type == "cuda"
    cfg = LlamaConfig(**(CARD_MODEL if card else CPU_MODEL),
                      dtype=torch.bfloat16 if card else torch.float32)
    model = LlamaForCausalLM(cfg, seed=SEED, device=dev)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=CARD_DS_CONFIG if card else CPU_DS_CONFIG,
        device=dev)
    return engine


def batch_fn(step: int, dev):
    """Deterministic per-step batch (the exact-fast-forward contract):
    ``(ids, ids)`` drawn with numpy from ``SEED + step``."""
    import numpy as np
    import torch

    card = dev.type == "cuda"
    vocab = (CARD_MODEL if card else CPU_MODEL)["vocab_size"]
    ids = np.random.default_rng(SEED + step).integers(
        0, vocab, size=CARD_BATCH if card else CPU_BATCH).astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    return ids, ids


class LossLog:
    """A ``step_fn`` for :class:`ResilientTrainLoop`: the default step
    (``engine.train_micro_batch``), its loss read once on the host (the
    sentinel's one synchronisation a step) and kept by step."""

    def __init__(self):
        self.losses = []          # [(step, loss)] in the order trained
        self.walls = []           # wall time at the end of each step
        self.loop = None

    def __call__(self, engine, batch) -> float:
        from deepspeed_tpu_torch.resilience import ResilientTrainLoop

        loss = float(ResilientTrainLoop._default_step_fn(engine, batch))
        self.losses.append((self.loop.step, loss))
        self.walls.append(time.time())
        return loss


def run_training(workdir: str, dev):
    """Train through :class:`ResilientTrainLoop` to ``TOTAL_STEPS``,
    resuming from ``workdir``.  Returns (engine, loop, log, seconds the
    resume took)."""
    from deepspeed_tpu_torch.resilience import ResilientTrainLoop

    engine = make_engine(dev)
    log = LossLog()
    loop = ResilientTrainLoop(engine, lambda step: batch_fn(step, dev),
                              workdir, save_interval=SAVE_INTERVAL,
                              keep_last=2, step_fn=log)
    log.loop = loop
    t0 = time.perf_counter()
    loop.auto_resume()
    load_s = time.perf_counter() - t0
    loop.run(TOTAL_STEPS, auto_resume=False)
    return engine, loop, log, load_s


def straight_run(dev, steps=range(TOTAL_STEPS)):
    """The oracle: ``train_micro_batch`` over ``steps`` with no loop and no
    saves.  Returns (state, [(step, loss)])."""
    engine = make_engine(dev)
    losses = [(s, float(engine.train_micro_batch(*batch_fn(s, dev))))
              for s in steps]
    return engine_state(engine), losses


def engine_state(engine) -> dict:
    """Master weights and Adam moments as host numpy arrays, by name."""
    out = {f"master/{n}": m.detach().cpu().numpy()
           for n, m in zip(engine._names, engine.master)}
    for key, tensors in engine.opt_state.items():
        for n, t in zip(engine._names, tensors):
            out[f"opt/{key}/{n}"] = t.detach().cpu().numpy()
    return out


def state_mismatches(want: dict, got) -> list:
    """Names whose arrays differ in any bit (or are missing)."""
    import numpy as np

    names = set(want) | set(got)
    return sorted(n for n in names if n not in want or n not in got
                  or not np.array_equal(want[n], got[n]))


def start_crash_child(crash_dir: str, device: str):
    """Step 2: the loop in a subprocess, killed by ``DS_CHAOS`` in the
    middle of its second save.  Returns (the ``Popen``, its start time);
    its output goes to ``crash_dir``'s ``child.log``."""
    os.makedirs(crash_dir, exist_ok=True)
    env = dict(os.environ)
    env["DS_CHAOS"] = f"crash_after_shard_write:after=1," \
                      f"exit_code={CRASH_EXIT_CODE}"
    with open(os.path.join(crash_dir, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             crash_dir, "--device", device], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def resume_after_crash(crash_dir: str, dev, reference, child) -> dict:
    """Steps 3-4 once the child of :func:`start_crash_child` ran."""
    from deepspeed_tpu_torch.resilience import manifest

    proc, t_start = child
    rc = proc.wait(timeout=600)
    child_s = time.perf_counter() - t_start
    with open(os.path.join(crash_dir, "child.log")) as f:
        tail = f.read()[-4000:]
    assert rc == CRASH_EXIT_CODE, (
        f"child should have been chaos-killed with exit code "
        f"{CRASH_EXIT_CODE}, got {rc}\n{tail}")

    # the atomic-commit invariant: latest names the previous, fully
    # verified tag; the torn save exists only as a .tmp dir
    latest = manifest.read_latest(crash_dir)
    assert latest == f"global_step{SAVE_INTERVAL}", latest
    ok, problems = manifest.verify_tag(os.path.join(crash_dir, latest))
    assert ok, problems
    torn = f"global_step{2 * SAVE_INTERVAL}"
    assert os.path.isdir(os.path.join(crash_dir, torn + ".tmp")), \
        "expected the torn save's staging dir"
    assert not os.path.isdir(os.path.join(crash_dir, torn)), \
        "torn tag must NOT have been committed"

    ref_state, ref_losses = reference
    t0 = time.perf_counter()
    engine, loop, log, load_s = run_training(crash_dir, dev)
    resume_s = time.perf_counter() - t0
    assert loop.metrics.resumes == 1, loop.metrics.snapshot()
    assert loop.step == TOTAL_STEPS, loop.step
    bad = state_mismatches(ref_state, engine_state(engine))
    assert not bad, f"resumed state differs from the straight run: {bad[:8]}"
    # loss-curve continuation: the resumed run's losses equal the straight
    # run's at the same steps
    assert log.losses == ref_losses[SAVE_INTERVAL:], \
        f"loss curve diverged: {log.losses} vs {ref_losses[SAVE_INTERVAL:]}"
    return {
        "device": str(dev), "resumed_from": latest,
        "crash_exit_code": rc, "child_s": child_s,
        "resume_run_s": resume_s, "load_s": load_s,
        "resumes": loop.metrics.resumes,
        "saves": loop.metrics.saves,
        "mean_save_s": loop.metrics.mean_save_latency_s(),
        "ref_final_loss": ref_losses[-1][1],
        "resumed_final_loss": log.losses[-1][1],
    }


def run_smoke(tmpdir: str | None = None, device: str = "cpu") -> dict:
    """Steps 1-4 of the module doc."""
    dev = resolve_device(device)
    if tmpdir is None:
        tmpdir = tempfile.mkdtemp(prefix="chaos_smoke_")
    crash_dir = os.path.join(tmpdir, "crash")
    reference = straight_run(dev)
    return resume_after_crash(crash_dir, dev, reference,
                              start_crash_child(crash_dir, device))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--child", metavar="DIR",
                        help="run the loop into DIR (DS_CHAOS kills it)")
    args = parser.parse_args()
    if args.child:
        run_training(args.child, resolve_device(args.device))
        return 0  # only reached if chaos failed to fire — parent asserts
    t0 = time.monotonic()
    snap = run_smoke(device=args.device)
    snap["wall_s"] = time.monotonic() - t0
    print(json.dumps({"chaos_smoke": "ok", **snap}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
