#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the serving path, from the sources in this
   checkout, one ``nvcc`` per source, all at once;
3. kernels against their plain PyTorch versions on the card, in bf16 at the
   serving path's shapes (max abs error <= 3e-2 and, over the whole
   output, |got - want|_2 / |want|_2 <= 1e-2), each timed with CUDA
   events beside its plain version, one PyTorch library call computing the
   same function (a yardstick only; the port never calls it) and its bound
   (the larger of bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s); the paged
   kernels over bf16 and over int8 KV pools (with their fp32 scales):
   generic attention at a 2 x 256 prefill, decode at S=8 and contexts of
   257-330, verify at S=8, K=5 and contexts ~300; at Mixtral-8x7B's
   geometry (32 query heads over 8 KV heads) the tiled prefill at the
   served 2 x 256 prefill, with pad rows (exact zeros) and with a window,
   each also timed beside the generic kernel, and decode at G = 4; the
   grouped expert GEMM at 4096 -> 14336 and 14336 -> 4096 over 8 experts,
   M = 1024 (a prefill, one expert empty) and M = 16 (a decode step), both
   on the wgmma forward, beside ``torch._grouped_mm`` where
   the installed PyTorch has it, each also two runs bit-equal, exact zeros
   past the groups and its launch's kernel and shape; its
   gradient kernels dlhs and drhs at Mixtral training shapes (4 x 1024
   tokens routed top-2, M = 8192; the gate / up and the down projection)
   and a ragged case (an empty expert, 192 rows past the groups), whose
   zero rows and blocks must be exact zeros; the redesigned kernels
   (PR 10) at more shapes: the int8 matmul's tiled path (wgmma) at M =
   16, 40, 64, 65 and 1024, at M = 40 on every projection shape, with 64
   groups at K = 11008 and at N = 4112, each beside its k-split; the
   generic paged kernel (a tiled wgmma walk per 64-row stripe) at 8 x 256
   contexts in int8, a SplitFuse tick (a 192-token chunk and 7 decode
   tokens), block sizes 16 and 64, a window of 100, G = 4 and 8, D = 64,
   and pad rows with one slot's tokens in two runs (pads exact zeros);
   the decode and verify kernel at Llama-2-7B width in bf16 and int8:
   decode and verify (K = 5) at S = 8 over contexts of ~2000 and ~4000
   tokens and at S = 64 over ~300 (4 decode pads, exact zeros), each read
   twice for bit-equality; every decode and verify case prints its grid;
4. the serving slice end to end at full Llama-2-7B width and 2 layers,
   through the kernels and through the plain paths on the card: first-step
   logits must agree within 3e-2 of their largest magnitude;
5. the served run: the 32-layer Llama-2-7B geometry with random int8 weights
   and a bf16 KV cache (block 128, token budget 512) answers 8 requests of
   256-token prompts: ``put`` → ``decode_loop`` of 48 tokens → one
   speculative round (n-gram drafts, ``verify_step``, ``commit_verified``)
   → ``flush``.
   Every serving kernel's launch count is set to 0 just before and must be
   > 0 just after;
6. the flash-attention kernels (forward, dQ, dK/dV) against their plain
   versions in bf16 at five shapes — the bench model's, Llama-2-70B's head
   geometry, a sliding window, a rectangular end-aligned case, the bench
   width at S = 4096 — o, lse, delta, dq, dk, dv each within 3e-2 of the
   plain version's largest magnitude and within 1e-2 in norm (|got -
   want|_2 / |want|_2), two runs bit-equal, timed beside the plain
   versions, ``F.scaled_dot_product_attention`` (forward, forward and
   backward, and its backward alone: a yardstick only) and the bound, with
   each launch's grid, tiles, registers, spills and tensor-map host time;
7. the training slice: the bench Llama (hidden 768, 12 heads, vocab 32000)
   at 2 layers, batch 8 x 1024, 3 engine steps through the kernels and 3
   through the plain versions from the same init and ids: losses within
   1e-3; logits before the first step and the first step's q/k/v
   projection gradients within 3e-2 and 5e-2 in norm, and set against
   the same model in fp32 no more than 5% farther off than the plain
   path's; only the kernel path launching the flash kernels;
8. the trained run: the bench model at 12 layers with the bench ds_config
   (ZeRO-1, bf16, AdamW 1e-4, clip 1.0) through
   ``deepspeed_tpu_torch.initialize``: 3 warm-up and 20 timed steps of
   ``engine(ids, ids)`` / ``backward`` / ``step`` on one batch from SEED;
   finite, falling loss and exactly 12 launches a step of each flash
   kernel (counts set to 0 just before the timed steps);
9. the speculative slice at 7B width and 2 layers, int8 weights and an int8
   KV cache: ``put`` of 8 x 256-token prompts, then 3 ``verify_step``
   passes at K=5 fed the plain path's own sequential greedy tokens,
   through the kernels and through the plain paths: kernel-path verify
   logits within 3e-2 of the plain path's largest magnitude and of the
   kernel path's sequential ``decode_step`` rows; a pass of wrong drafts
   committed as its fed token alone leaves ``free_blocks`` where a
   never-drafted engine is; the plain path launches no kernel;
10. the speculative served run: the 32-layer Llama-2-7B geometry, int8
   weights, int8 KV (block 128, budget 512), 8 requests whose prompts are
   a 32-token seeded phrase repeated 8 times; 48 greedy tokens a request by
   rounds of ``NgramDrafter`` (4 drafts) → ``verify_step(greedy=True)`` →
   ``accept_drafts`` → ``commit_verified``, and the same prompts through
   ``decode_loop`` on a fresh int8-KV engine as the yardstick.  Finite
   logits, tokens in the vocabulary, every block free after ``flush``;
   counts set to 0 just before each run and read just after it: the
   speculative run launches the int8 prefill and verify kernels, the
   ``decode_loop`` run the int8 prefill and decode kernels;
11. Mixtral-8x7B at full width and 2 layers, random bf16 weights from SEED
   made on the card, bf16 KV (block 128, budget 512), through the kernels
   and through the plain paths: ``put`` of the 8 prompts, two a forward,
   one ``decode_step`` from each engine's own prompt KV, then, from the
   plain path's KV handed to both engines (``flush_to_host`` /
   ``resume``), 4 ``decode_step`` rounds fed the plain path's greedy
   tokens: put, own-KV and shared-KV decode logits each within 3e-2 of the
   plain path's largest magnitude, the put's within 1e-2 in norm and the
   shared-KV decode's within 1.5e-2 (the two bf16 paths' decode logits sit
   ~1.1% apart in norm, each ~1% from fp32), and, set against the same
   model in fp32, the kernel path's put and decode logits no more than 5%
   farther off in norm than the plain path's; the kernel path launches the
   tiled prefill, decode and grouped GEMM kernels and nothing else, the
   plain path nothing; then one ``verify_step`` of 3 fed tokens a request on
   the kernel path (Mixtral has no verify route: the rows take the generic
   paged kernel), each row within 3e-2 of the kernel path's sequential
   ``decode_step`` rows;
12. Mixtral served: full width, 16 of its 32 layers (the bf16 weights of
   all 32, ~93.5 GB, do not fit the card's 80 GB), engine as in phase 11:
   8 requests of 256-token prompts, 48 greedy tokens through ``put`` and
   ``decode_loop``: TTFT per pair of prompts, decode ms/step and tokens/s
   beside the bounds from the script's own weight-byte count, peak memory,
   one traced decode step by kernel kind; counts set to 0 just before and
   read just after: tiled prefill 4 x 16, decode 47 x 16, grouped GEMM
   3 x 16 x (4 + 47), and no other kernel; then, outside the count, one
   traced 2 x 256 prefill ``put``: its grouped-GEMM device ms by kernel
   beside the forward's bound;
13. MoE training, kernels vs plain versions: one dropless ``MoE`` layer at
   full width on the same bf16 input and upstream gradient (4 x 1024
   tokens) through the kernels, the plain versions and fp32 (the same
   values, so every path routes alike): output, dx, the router's and each
   expert weight's gradient within 1e-2 in norm of the plain path and no
   more than 5% farther from fp32; then the dropless Mixtral at full width
   and 2 layers, one forward and backward: first-step loss within 1e-3,
   logits no more than 5% farther from fp32 than the plain path's (route
   flips of the random router part the two bf16 paths by ~7% in norm, so
   their direct distance is recorded, not barred); only the kernel path
   launching the flash and grouped GEMM kernels;
14. the dropless Mixtral trained at full width and 2 layers through
   ``deepspeed_tpu_torch.initialize`` (the bench ds_config at micro-batch
   4: ZeRO-1, bf16, AdamW 1e-4, clip 1.0): 3 warm-up and 10 timed steps
   on 4 x 1024 tokens: ms/step, tokens/s, MFU (useful FLOPs: the dense
   projections, 2 of 8 experts a token, causal attention), peak memory,
   one traced step; falling loss; launches exact (counts set to 0 just
   before the timed steps): each step forward gmm, dlhs and drhs 3 a layer,
   flash forward, dQ and dK/dV 1 a layer, and no other kernel;
15. the same for ``MixtralForCausalLM`` as the JAX package builds it
   (capacity top-2, the dispatch and expert products library calls):
   flash 1 a layer a step, no grouped GEMM;
16. the flash kernels' strided mode (the folded and paired entries) against
   the plain versions in bf16, with phase 6's bars: GPT-2-125M's shape (12
   heads, d = 64, 8 x 1024, q / k / v views of one [8, 1024, 2304]
   ``c_attn`` output), the bench model's TPU geometry (6 heads, d = 128,
   16 x 1024), Llama-2-70B's heads as views of a fused ``qkv_proj`` output,
   a sliding window, a rectangular end-aligned case (k / v views); the
   contiguous mode on ``.contiguous()`` copies must give the same bits, as
   must two runs; each timed beside the contiguous mode plus its copies,
   the plain versions, SDPA (a yardstick) and the bound;
17. GPT-2-125M at full width and 12 layers, random fp32 weights drawn on
   the card from SEED, batch 8 x 1024, the bench ds_config with
   ``attention_layout`` "paired": 3 engine steps through the kernels and 3
   through the plain versions (losses within 1e-3, logits before the first
   step within 3e-2 and the first step's ``c_attn`` gradients within 5e-2
   in norm, each no more than 5% farther from the fp32 model's than the
   plain path's); "folded" and "bshd" from the same init must give the
   paired path's losses, logits and gradients bit for bit; only the
   kernel path launches, every launch counted under its layout's entry;
18. the trained runs through ``initialize``, 3 warm-up and 20 timed steps
   each: GPT-2-125M under "bshd", "folded" and "paired" (micro-batch 8),
   the 12-layer bench model under "folded" and "paired" at 12 heads
   (micro-batch 8) and "folded" at 6 heads (d = 128, micro-batch 16, where
   paired falls back to folded): ms/step, tokens/s, MFU, peak memory, a
   finite falling loss, and exactly 12 launches a step of each flash
   kernel under the entry the layout implies and none under the others
   (counts set to 0 just before the timed steps); one traced GPT-2 paired
   step;
19. the int8 quantizer kernel (``ops/quantizer.py`` ``quantize_kernel``)
   against its plain version at the Llama-2-7B matrices in bf16 ([4096,
   4096], [4096, 11008], [11008, 4096], lm_head [4096, 32000]) at 64 and 16
   groups, at 128 values a group, with an all-zero group (scale 1, q 0) and
   with exact .5 ties (fp32): q and scales bit for bit, one kernel launch
   and no memset a call (``torch.profiler``), each timed beside the plain
   version and the bound (no one PyTorch call computes it);
20. ``InferenceEngineV2.from_hf`` of a 2-layer Llama-2-7B checkpoint this
   script writes (``config.json`` and a 1.3 GB bf16 ``model.safetensors``
   from SEED) with ``quantize_bits=8`` and without: the 15 int8 records bit
   for bit the plain quantizer on the bf16 engine's tensors, 64 groups each;
   the 8 prompts through ``put`` and 16 greedy tokens on each engine, the
   int8 engine's first logits within 1e-1 in norm of the bf16 engine's
   (int8 rounding of 15 matrices puts them ~5% apart);
   launches counted from 0 around each load and each served run: 15 quantize
   launches loading int8, none loading bf16, the int8 matmul 15 a forward
   serving int8 and never serving bf16;
21. Llama-2-7B's 32 layers drawn in bf16 on the card from SEED and
   quantized by ``WeightQuantization.model_quantize`` (64 groups, the
   embedding excluded): 225 matrices, exactly 225 quantize launches, device
   and wall time beside the bound; then phase 5's workload with 16 decode
   tokens and 16 more: TTFT and ms/step beside phase 5's, the int8 matmul
   225 launches a forward; then a traced quantization of a second draw, 16
   more decode tokens after it, a traced decode window, and phase 5's own
   tree served by the same code in the same process, with a probe of the
   host's cost of one launch before each (what tells a slower tree from a
   slower process);
22. Evoformer attention (``DS4Sci_EvoformerAttention``) against the plain
   version, in bf16 / fp16 through the tensor-core kernel (wgmma fed by a
   TMA ring, every bias it is given) at upstream DeepSpeed's test shapes
   [1, 256, 256, 4, 32] (triangle attention at crop 256, OpenFold's 4 pair
   heads of 32) and [1, 512, 256, 8, 8], AlphaFold's crop 384 triangle
   [1, 384, 384, 4, 32], OpenFold's MSA row attention [1, 128, 256, 8, 32],
   a ragged S = 250, no biases, rows whose keys are all masked (-1e9: the
   mean of v), three and eight biases, an fp32 mask with bf16 Q/K/V and
   pair bias (autocast), fp16, D = 64 and D = 128, with the mask bias
   [B, N, 1, 1, S] and the pair bias [B, 1, H, S, S]; and through the
   general kernel (3xTF32 on mma.sync) in fp32 at the triangle and MSA row
   shapes and in bf16 at D = 12: the forward within 3e-2 max (fp32: 1e-4)
   and 1e-2 in norm, dQ, dK, dV and d(pair bias) of the autograd Function
   within 5e-2 in norm of dense autograd; exactly one launch of the routed
   kernel and none of the other a forward (counts set to 0 just before
   each call); every bf16 / fp16 case with D a multiple of 8 on the
   tensor-core kernel and the rest on the general one; two runs of either
   kernel bit-equal; each case's route, bias kinds and launch shape, timed
   beside its time before its kernel's redesign (PERF.md row 22), the plain
   version, SDPA over the summed biases as one float mask (a yardstick),
   the bound and the exponentials' floor, with each forward's peak memory;
   and three faults planted in copies of the kernel's source (the last key
   step dropped, the bias tiles staged only at the first step, in bf16; the
   split products' cross terms dropped, in fp32), each of which must miss
   its type's bar at the triangle shape;
23. block-sparse attention (B11) at BERT width (12 heads of 64, S = 4096,
   batch 4, block 16) through ``SparseSelfAttention`` (implementation
   "auto": the kernels), forward and backward, under Fixed (upstream's
   defaults, bidirectional and unidirectional), BigBird, BSLongformer,
   Variable and Dense layouts in bf16; and fixed in fp16, BSLongformer in
   fp32 (the split-TF32 forward, the general dQ and dK/dV; also at S =
   1040, D = 20), BigBird at D = 128 (6 heads), BSLongformer at
   block 32, Variable at block 64, BigBird with a layout per head, Fixed at
   S = 1040 (a tail tile), and BigBird at S = 16384, batch 1, forward only
   (a timing case): the forward within 3e-2 max and 1e-2 in norm of
   ``block_sparse_attention_reference`` (fp32: 1e-4 max), dQ, dK and dV
   within 5e-2 in norm; exactly one launch of each kernel a call and no
   dense call (counts set to 0 just before each call and read just after);
   tables that drop the last live key tile of every query tile must miss
   the bars; two runs of the forward, and of dQ and dK/dV, on the same
   inputs bit-equal, and the forward with every list split into parts of
   two stages bit-equal over two runs and within the bars; a fault planted
   in a copy of the kernels' source (the fp32 forward's split products
   without their cross terms) must miss the fp32 bar at BSLongformer;
   each slice-walk launch's shape and walk (``launch_info``: grid, stages,
   registers, spills, split lists, slot fill); each kernel timed beside
   its plain version, SDPA over the expanded boolean mask (a yardstick:
   forward, forward + backward, the backward alone) and its bound (bytes,
   or the FLOPs of the layout's live cells; the FLOPs of the live 64 x 64
   tiles beside them), and its TFLOP/s on both; time against density at the
   Fixed / BSLongformer / Dense layouts; with a key-padding mask, "auto"
   takes the dense composition, counted under its own key;
24. the continuous-batching scheduler (``ContinuousBatchScheduler``)
   serving ``bench_serving.py`` ``measure_scheduler``'s traffic on the
   32-layer Llama-2-7B geometry with phase 5's int8 tree: 32 requests,
   Poisson arrivals at 16 req/s, 192-token prompts, 48 new tokens each,
   half greedy and half seeded top-k, 8 sequences, budget 512, block 128,
   a KV pool of 0.7 of the worst-case demand: every request finishes with
   48 tokens; that traffic does not preempt at block 128 (a prompt takes
   its 2 blocks at admission and 240 tokens never need a third), so 16
   requests of 104-token prompts at once on the same engine must preempt
   at least once, and every preempted request finish with 48 tokens; the
   pool's free blocks back to its size after each run, the int8 matmul,
   paged prefill and paged decode kernels launched (counts set to 0 just
   before the run and read just after), the registry snapshot holding the
   JAX package's ``serving/*`` and occupancy keys; goodput, TTFT p50 / p99,
   ms per tick, the device idle share over a traced window of decode
   ticks, and the share of greedy tokens equal to an unscheduled ``put`` /
   ``decode_loop`` run of the same prompts (reported, not barred: bf16
   near-ties flip across batch shapes);
25. the cache-aware router (``CacheAwareRouter``) over two schedulers
   sharing phase 5's int8 tree on the 32-layer Llama-2-7B geometry,
   serving ``bench_serving.py`` ``measure_shared_prefix``'s traffic: 4
   tenants, shared-prefix ratio 0.9, 256-token prompts, 16 greedy tokens,
   8 clients, block 32, 64 requests: cold and warm TTFT, the cache-hit
   rate, prefill tokens saved and requests by replica; every request
   whose tenant's prefix is warm goes to a replica holding at least 224
   cached tokens of it (probed just before placement), every generated
   token meets phase 24's teacher-forced bar on its replica, uids are
   unique across replicas, B2, B5 and B3 launch, and a planted router
   that ignores the cache (``cache_weight=0``) misses the placement bar;
26. the host KV tier under ``measure_session_mix``'s two arms at the same
   width: bf16 KV without the tier against int8 KV with it, the same
   device byte budget (56 bf16 blocks of 16 tokens), ``max_sessions`` 36
   as in the bench: resident sessions per arm, spooled, restored and
   dropped blocks, spool and restore ms p50 / p95 (and how much of a
   spool waited for device work queued before it), bytes a block; the
   mix restores from the tier, one ``gather_blocks`` call a spool and one
   ``scatter_blocks`` call a restore, every restored block equal to its
   spooled payload, and a
   session evicted and restored on one engine continuing bit for bit as
   on an engine that never evicted it;
27. checkpoints: the 12-layer bench Llama 4 steps, ``save_checkpoint``
   (``CheckpointEngine`` and ``AsyncCheckpointEngine``), fresh engines
   through ``initialize`` that ``load_checkpoint`` and take 4 more steps
   against 8 straight steps (bit-equal where two straight runs are), a
   corrupted tag falling back to the newest verified one; and a 2-layer
   7B-width int8 serving engine through ``serialize`` ->
   ``load_serialized`` with bit-equal next-token logits.  Each of these
   phases prints its own launch counts by kernel.

The second-to-last lines are the ``kernels`` JSON record and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
Without a GPU, or run outside a checkout of the repository, it exits non-zero
and prints no result.  Details of every kernel case go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 3e-2                   # the reference's on-chip kernel tolerance
# |got - want|_2 / |want|_2 over a whole flash-attention output: its
# largest magnitude sits on the first rows (row 0 sees one key), so a bar
# relative to that alone is loose for the late rows; the same holds for a
# paged kernel whose fault touches a few keys of some rows (phase 3)
NORM_TOL = 1e-2
# phase 7, kernel path vs plain path (bars ~3x the noise the card shows):
# each loss, relative; the logits before the first step and the first
# step's q/k/v projection gradients, in norm.  A bf16 model rounds a dozen
# times a layer, and once the two paths differ by an ulp their later
# roundings part ways; the gradients more so, since dS = P (dP - delta)
# cancels.
LOSS_TOL = 1e-3
LOGITS_TOL = 3e-2
GRAD_TOL = 5e-2
# the sharper check: set against the same model in fp32, the kernel path's
# logits and gradients may be at most 5% farther off than the plain
# path's (on the card the two distances agree to 0.1%)
FP32_RATIO = 1.05
# phase 11, Mixtral's decode logits from shared KV, kernel path vs plain
# path in norm: the two bf16 paths sit 1.09% apart there (the plain decode
# path rounds P to bf16, the kernel does not, and the random router carries
# it into the logits), so the bar sits ~1.4x above that reading
MIXTRAL_DECODE_NORM_TOL = 1.5e-2
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12          # H100 SXM dense bf16, NVIDIA data sheet
SEED = 0


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def rel_norm(got, want) -> float:
    """|got - want|_2 / |want|_2 in fp32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def bound(nbytes: float, flops: float, flops_per_s: float = None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_per_s or BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


COLD_BYTES = 100e6          # operand sets span twice the 50 MB L2


def n_sets(call_bytes: float) -> int:
    """Operand sets to rotate through so that each call finds its own cold
    in L2 (at most 8)."""
    return max(1, min(8, math.ceil(COLD_BYTES / call_bytes)))


def time_ms(fn, sets: int, iters: int) -> float:
    """Mean device time in ms of ``fn(i)``, which runs one call on operand
    set ``i % sets``.  With the sets spanning more than twice the L2, each
    call reads its operands from device memory, as a served step does (it
    streams 6.6 GB of weights).  A device-side sleep first lets the host
    queue every call ahead of the device, and one pair of CUDA events
    brackets them all, so neither host overhead nor event cost counts."""
    import torch

    for i in range(sets):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)           # ~30 ms of device-side wait
    start.record()
    for i in range(iters):
        fn(i % sets)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# --------------------------------------------------------------------- #
# Phase 3 cases
# --------------------------------------------------------------------- #
#: phase 3's int8 matmul cases (M, K, N, groups): the skinny path (M = 8,
#: a decode step) and the tiled path at the four Llama-2-7B projection
#: shapes at M = 512 (the prefill bucket); medium M (16 to 65: a verify
#: pass is 8 x 5 = 40 rows) at 4096 x 4096 and at M = 40 on the other
#: shapes; M = 1024; from_hf's 64 groups at K = 11008 (a group boundary
#: inside a k-tile); a ragged N = 4112; the skinny path at M = 1 (one
#: request) and M = 2 (phase 5's traced decode step) and at from_hf's 64
#: groups
QMM_CASES = ([(8, 4096, 4096, 16), (8, 4096, 11008, 16), (8, 11008, 4096, 16),
              (8, 4096, 32000, 16)]
             + [(512, 4096, 4096, 16), (512, 4096, 11008, 16),
                (512, 11008, 4096, 16), (512, 4096, 32000, 16)]
             + [(m, 4096, 4096, 16) for m in (16, 40, 64, 65, 1024)]
             + [(40, 4096, 11008, 16), (40, 11008, 4096, 16),
                (40, 4096, 32000, 16)]
             + [(40, 11008, 4096, 64), (512, 11008, 4096, 64),
                (70, 1024, 4112, 16), (512, 1024, 4112, 16)]
             + [(1, 4096, 4096, 16), (2, 4096, 4096, 16), (2, 4096, 11008, 16),
                (2, 11008, 4096, 16), (2, 4096, 32000, 16),
                (8, 11008, 4096, 64)])
#: phase 3's goals for the skinny path (M <= 8): under torch.matmul on the
#: bf16 weight in every case, and 4096 x 4096 at M = 8 within twice its
#: byte bound
QMM_SKINNY_GOAL_MS = 0.0100


def qmm_cases(torch, gen, dev, shapes):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    out = []
    for m, k, n, groups in shapes:
        x = torch.randn((m, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        sets = n_sets(k * n)
        recs = [{"q": torch.randint(-127, 128, (k, n), generator=gen,
                                    device=dev, dtype=torch.int8),
                 "scale": torch.rand((groups,), generator=gen, device=dev)
                 / (73.3 * math.sqrt(k))} for _ in range(sets)]
        got = qm.quantized_matmul(x, recs[0])
        again = qm.quantized_matmul(x, recs[0]) if m <= 8 else got
        want = qm.quantized_matmul_plain(x, recs[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        norm_err = rel_norm(got, want)
        iters = 48 if m <= 64 else 16
        nbytes = m * k * 2 + k * n + groups * 4 + m * n * 2
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
        g_tag = f",G={groups}" if groups != 16 else ""
        case = {
            "name": f"quantized_matmul[M={m},K={k},N={n}{g_tag}]",
            "kernel": "quantized_matmul",
            "max_abs_err": err, "norm_rel_err": norm_err,
            "ms": time_ms(lambda i: qm.quantized_matmul(x, recs[i]),
                          sets, iters),
            "plain_ms": time_ms(
                lambda i: qm.quantized_matmul_plain(x, recs[i]), sets,
                sets),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if m <= 8:                # the skinny path: tiles over clusters
            case["bit_equal"] = bool(torch.equal(got, again))
            case["launch"] = qm.skinny_plan(
                k, n, qm.resident_clusters(dev.index))
        else:                     # the tiled path: rows a block, K splits
            case["k_splits"] = qm.k_splits_for(m, k, n, qm._sms(dev))
            case["tile_rows"] = qm.tiled_rows(m, n, qm._sms(dev))
        w_bf16 = [qm.dequant_reference(r, torch.bfloat16) for r in recs]
        case["library_ms"] = time_ms(lambda i: torch.matmul(x, w_bf16[i]),
                                     sets, iters)
        out.append(case)
        del x, recs, got, again, want, w_bf16
    return out


def qmm_skinny_goals(cases) -> dict:
    """Phase 3's readings of the skinny path's goals (recorded, not
    gated): each skinny case's time against torch.matmul's on the bf16
    weight, and 4096 x 4096 at M = 8 against QMM_SKINNY_GOAL_MS."""
    skinny = [c for c in cases if c["kernel"] == "quantized_matmul"
              and int(c["name"].split("M=")[1].split(",")[0]) <= 8]
    over = [c["name"] for c in skinny if not c["ms"] < c["library_ms"]]
    at_8 = next(c for c in skinny
                if c["name"] == "quantized_matmul[M=8,K=4096,N=4096]")
    return {"cases": len(skinny), "under_library": len(skinny) - len(over),
            "over_library": over,
            "m8_4096_ms": at_8["ms"], "m8_4096_bound_ms": at_8["bound_ms"],
            "m8_4096_goal_ms": QMM_SKINNY_GOAL_MS,
            "m8_4096_goal_met": at_8["ms"] <= QMM_SKINNY_GOAL_MS}


def _attention_inputs(torch, gen, dev, slots, q_pos, int8=False, hkv=32,
                      h=32, d=128, bs=128, order=None, width=384):
    """Pools of ``slots`` sequences at a table width of ``width`` tokens
    (by default the served 384: 3 blocks of 128, or as many of ``bs``; 7B
    KV heads or ``hkv``, tables scattered over the pool) — as many pool
    copies as keep each call cold in L2, each ``(k, v, scales)``: bf16, or
    int8 with its ``k_scale`` / ``v_scale`` — and ``h`` query heads of rows
    at the positions ``q_pos[s]`` (a list per slot; -1 for a pad row), slot
    by slot, or in the row order ``order`` (indices into that slot-major
    list)."""
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import quantize_kv

    width = -(-width // bs)                      # table blocks a slot
    nb = slots * width + 1
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[:slots * width]
    tables = (perm + 1).to(torch.int32).reshape(slots, width)
    live = sum(max(p) + 1 for p in q_pos if p)

    def pool_set():
        k, v = (torch.randn((nb * bs, hkv, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        if not int8:
            return k, v, {}
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return kq, vq, {"k_scale": ks, "v_scale": vs}

    pools = [pool_set() for _ in range(n_sets(2 * live * hkv * d
                                              * (1 if int8 else 2)))]
    slot_ids = [s for s in range(slots) for _ in q_pos[s]]
    pos = [p for s in range(slots) for p in q_pos[s]]
    if order is not None:
        slot_ids, pos = [slot_ids[i] for i in order], [pos[i] for i in order]
    token_slot = torch.tensor(slot_ids, dtype=torch.int32, device=dev)
    token_pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn((len(pos), h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, pools, tables, token_slot, token_pos


def attention_case(torch, name, fn, q, pools, tables, token_slot, token_pos,
                   iters, window=None, plain=None, plain_kw=None, bs=128,
                   **kw):
    """One phase-3 case: the wrapper ``fn`` (``kw``: its own arguments, such
    as verify's ``k_tokens``) against the plain version (``plain`` with
    ``plain_kw``: by default ``paged_attention_plain``) on the first pool
    set, then timed over all of them (``bs``: the pools' block size)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.inference.v2.kernels.blocked_flash import (
        paged_attention_plain)
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (
        dequantize_kv)

    sets = len(pools)
    plain = plain or paged_attention_plain
    plain_kw = dict(plain_kw or {}, window=window)
    kw["window"] = window
    k_pool, v_pool, scales = pools[0]
    got = fn(q, k_pool, v_pool, tables, token_slot, token_pos, block_size=bs,
             **scales, **kw)
    want = plain(q, k_pool, v_pool, tables, token_slot, token_pos,
                 block_size=bs, **scales, **plain_kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    norm_err = rel_norm(got, want)
    t, h, d = q.shape
    hkv = k_pool.shape[1]
    pos = token_pos.tolist()
    slots = token_slot.tolist()
    # bytes: q and out once, each slot's visible K/V rows once (int8: a
    # byte an element plus the fp32 scale of each row and head); pad rows
    # (position -1) see nothing
    span = {}
    for s, p in zip(slots, pos):
        if p >= 0:
            lo = 0 if window is None else max(0, p - window + 1)
            a, b = span.get(s, (lo, p))
            span[s] = (min(a, lo), max(b, p))
    kv_rows = sum(b - a + 1 for a, b in span.values())
    row_bytes = d + 4 if scales else 2 * d
    nbytes = 2 * t * h * d * 2 + 2 * kv_rows * hkv * row_bytes
    flops = sum(4.0 * (p + 1 if window is None else min(p + 1, window))
                * h * d for p in pos if p >= 0)
    b_ms, b_by = bound(nbytes, flops)

    # yardstick: SDPA over the gathered (and dequantized) per-slot context
    # with a position mask (the gather is outside the timed call)
    width = tables.shape[1]
    c_len = width * bs
    rows = (tables.long()[:, :, None] * bs
            + torch.arange(bs, device=q.device)).reshape(-1, c_len)
    uniq = sorted(set(slots))
    per_slot = max(slots.count(s) for s in uniq)
    qs = torch.zeros((len(uniq), h, per_slot, d), dtype=q.dtype,
                     device=q.device)
    mask = torch.zeros((len(uniq), 1, per_slot, c_len), dtype=torch.bool,
                       device=q.device)
    key = torch.arange(c_len, device=q.device)
    for i, s in enumerate(uniq):
        idx = [j for j, ss in enumerate(slots) if ss == s]
        qs[i, :, :len(idx)] = q[idx].transpose(0, 1)
        p_idx = token_pos[idx].long()[:, None]
        vis = key[None, :] <= p_idx
        if window is not None:
            vis &= key[None, :] > p_idx - window
        mask[i, 0, :len(idx)] = vis
        mask[i, 0, :, 0] |= ~mask[i, 0].any(-1)  # pad rows: see key 0
    r = rows[uniq]

    def ctx_of(pool, sc):
        x = pool[r] if sc is None else dequantize_kv(pool[r], sc[r], q.dtype)
        return x.permute(0, 2, 1, 3).contiguous()

    gathered = [(ctx_of(kp, sc.get("k_scale")), ctx_of(vp, sc.get("v_scale")))
                for kp, vp, sc in pools]
    grid = {}
    if fn.__name__ in ("paged_decode_attention", "paged_verify_attention"):
        grid = {"grid": [t // kw.get("k_tokens", 1), hkv]}
    return {
        "name": name,
        "kernel": fn.__name__ + ("_int8" if scales else ""),
        **grid,
        "max_abs_err": err, "norm_rel_err": norm_err,
        "ms": time_ms(lambda i: fn(q, pools[i][0], pools[i][1], tables,
                                   token_slot, token_pos, block_size=bs,
                                   **pools[i][2], **kw), sets, iters),
        "plain_ms": time_ms(lambda i: plain(
            q, pools[i][0], pools[i][1], tables, token_slot, token_pos,
            block_size=bs, **pools[i][2], **plain_kw), 1, 3),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(
            qs, *gathered[i], attn_mask=mask, enable_gqa=h != hkv), sets,
            iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }


#: phase 3's generic paged attention (B5) cases beyond the served 2 x 256
#: prefill: (label, q_pos per slot, int8, keyword arguments of
#: _attention_inputs, window).  A SplitFuse tick (one 192-token chunk and
#: 7 decode tokens), block sizes 16 and 64 (a 64-key tile over several
#: blocks, and exactly one), a window, G = 4 and 8 (Mixtral's and a
#: 70B-style grouping), D = 64, and pad rows with one slot's tokens in two
#: runs of the token buffer.
_TICK = [list(range(64, 256))] + [[p] for p in (300, 257, 330, 281, 299,
                                                264, 312)]
_SPLIT_RUNS = ([list(range(150)), list(range(60)), [-1] * 20],
               list(range(100)) + list(range(210, 220)) + list(range(150, 210))
               + list(range(100, 150)) + list(range(220, 230)))
B5_CASES = [
    ("T=512, 8x256 ctx", [list(range(192, 256))] * 8, True, {}, None),
    ("T=199, SplitFuse tick 192+7", _TICK, False, {}, None),
    ("T=199, SplitFuse tick 192+7", _TICK, True, {}, None),
    ("T=512, 2x256, block 16", [list(range(256))] * 2, False, {"bs": 16},
     None),
    ("T=512, 2x256, block 16", [list(range(256))] * 2, True, {"bs": 16},
     None),
    ("T=512, 2x256, block 64", [list(range(256))] * 2, False, {"bs": 64},
     None),
    ("T=512, 2x256, window 100", [list(range(256))] * 2, False, {}, 100),
    ("T=512, 2x256, window 100", [list(range(256))] * 2, True, {}, 100),
    ("T=512, 2x256, G=4", [list(range(256))] * 2, False, {"hkv": 8}, None),
    ("T=512, 2x256, G=4", [list(range(256))] * 2, True, {"hkv": 8}, None),
    ("T=512, 2x256, G=8", [list(range(256))] * 2, False,
     {"hkv": 4}, None),
    ("T=512, 2x256, D=64", [list(range(256))] * 2, False, {"d": 64}, None),
    ("T=512, 2x256, D=64", [list(range(256))] * 2, True, {"d": 64}, None),
    ("T=230, pads, split runs", _SPLIT_RUNS[0], False,
     {"order": _SPLIT_RUNS[1]}, None),
    ("T=230, pads, split runs", _SPLIT_RUNS[0], True,
     {"order": _SPLIT_RUNS[1]}, None),
]


def attention_cases(torch, gen, dev):
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    out = []
    # the served prefill batch: 2 prompts x 256 tokens in the 512 bucket
    args = _attention_inputs(torch, gen, dev, 8,
                             [list(range(256))] * 2 + [[]] * 6)
    out.append(attention_case(torch, "paged_attention[T=512, 2x256 prefill]",
                              bf.paged_attention, *args, iters=16))
    # T = 512 over 8 x 256-token contexts (the last 64 tokens of each)
    args = _attention_inputs(torch, gen, dev, 8,
                             [list(range(192, 256))] * 8)
    out.append(attention_case(torch, "paged_attention[T=512, 8x256 ctx]",
                              bf.paged_attention, *args, iters=16))
    # decode: S = 8 slots, contexts of 257..330 tokens
    dpos = torch.randint(257, 331, (8,), generator=gen, device=dev).tolist()
    args = _attention_inputs(torch, gen, dev, 8, [[p] for p in dpos])
    out.append(attention_case(torch, "paged_decode_attention[S=8, ctx~300]",
                              bf.paged_decode_attention, *args, iters=48))
    # the int8 KV pool: the served prefill and decode shapes again
    args = _attention_inputs(torch, gen, dev, 8,
                             [list(range(256))] * 2 + [[]] * 6, int8=True)
    out.append(attention_case(
        torch, "paged_attention int8[T=512, 2x256 prefill]",
        bf.paged_attention, *args, iters=16))
    args = _attention_inputs(torch, gen, dev, 8, [[p] for p in dpos],
                             int8=True)
    out.append(attention_case(
        torch, "paged_decode_attention int8[S=8, ctx~300]",
        bf.paged_decode_attention, *args, iters=48))
    # verify: S = 8 slots, K = 5 rows each from positions 257..326
    vpos = torch.randint(257, 327, (8,), generator=gen, device=dev).tolist()
    for int8 in (False, True):
        args = _attention_inputs(torch, gen, dev, 8,
                                 [list(range(p, p + 5)) for p in vpos],
                                 int8=int8)
        out.append(attention_case(
            torch, f"paged_verify_attention{' int8' if int8 else ''}"
                   f"[S=8, K=5, ctx~300]",
            bf.paged_verify_attention, *args, iters=48, k_tokens=5))
    return out


#: phase 3's decode and verify cases beyond the served ones, at
#: Llama-2-7B width: (label, slots, low and high context positions,
#: table width in tokens, decode pad slots); each in decode and in verify
#: (K = 5), over bf16 and int8 pools: 8 slots at long contexts, and a wide
#: batch of 64 slots (the last 4 pads in decode)
LONG_CASES = [("S=8, ctx~2000", 8, 1950, 2050, 2176, 0),
              ("S=8, ctx~4000", 8, 3950, 4050, 4224, 0),
              ("S=64, ctx~300", 64, 257, 330, 384, 4)]


def long_cases(torch, gen, dev):
    """Phase 3's LONG_CASES through the decode and the verify kernel; each
    case also reads that two runs are bit-equal (``bit_equal``) and, with
    pads, their largest magnitude (exact zeros wanted)."""
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    out = []
    for label, slots, lo, hi, width, pads in LONG_CASES:
        pos = torch.randint(lo, hi, (slots,), generator=gen,
                            device=dev).tolist()
        for int8 in (False, True):
            for k_tokens, fn in ((1, bf.paged_decode_attention),
                                 (5, bf.paged_verify_attention)):
                q_pos = [list(range(p, p + k_tokens)) for p in pos]
                if k_tokens == 1 and pads:
                    q_pos[-pads:] = [[-1]] * pads
                args = _attention_inputs(torch, gen, dev, slots, q_pos,
                                         int8=int8, width=width)
                kw = {"k_tokens": k_tokens} if k_tokens > 1 else {}
                tag = f", K={k_tokens}" if k_tokens > 1 else ""
                case = attention_case(
                    torch, f"{fn.__name__}{' int8' if int8 else ''}"
                           f"[{label}{tag}]", fn, *args, iters=24, **kw)
                q, pools, tables, ts, tp = args
                runs = [fn(q, pools[0][0], pools[0][1], tables, ts, tp,
                           block_size=128, **pools[0][2], **kw)
                        for _ in range(2)]
                case["bit_equal"] = bool(torch.equal(*runs))
                if (tp < 0).any():
                    case["pad_max_abs"] = runs[0][tp < 0].abs().max().item()
                out.append(case)
                del args, pools, runs
    return out


def b5_cases(torch, gen, dev):
    """Phase 3's B5_CASES (the generic kernel beyond the served prefill);
    a case with pad rows also reads their largest magnitude (exact zeros
    wanted)."""
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    out = []
    for label, q_pos, int8, kw, window in B5_CASES:
        args = _attention_inputs(torch, gen, dev, len(q_pos), q_pos,
                                 int8=int8, **kw)
        bs = kw.get("bs", 128)
        case = attention_case(
            torch, f"paged_attention{' int8' if int8 else ''}[{label}]",
            bf.paged_attention, *args, iters=16, window=window, bs=bs)
        q, pools, tables, ts, tp = args
        pads = tp < 0
        if pads.any():
            got = bf.paged_attention(q, pools[0][0], pools[0][1], tables, ts,
                                     tp, block_size=bs, window=window,
                                     **pools[0][2])
            case["pad_max_abs"] = got[pads].abs().max().item()
        out.append(case)
    return out


def mixtral_attention_cases(torch, gen, dev):
    """Phase 3 at Mixtral-8x7B's attention geometry (32 query heads over 8
    KV heads, D = 128, block 128): the tiled prefill B4 (a route of B5's
    tiled kernel over the stripes' slots) at the served 2 x 256 prefill
    (tile 128), with pad rows (which must be exact zeros) and with a
    window of 100; decode (B3) at G = 4."""
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf

    out = []
    tile = {"plain": bf.paged_prefill_attention_plain,
            "plain_kw": {"tile_q": 128}, "tile_q": 128}
    for label, q_pos, window in (
            ("T=512, 2x256 prefill", [list(range(256))] * 2 + [[]] * 6,
             None),
            # chunks of 200, 100 and 128 tokens, padded to their stripes
            ("T=512, pads", [list(range(56, 256)) + [-1] * 56,
                             list(range(100)) + [-1] * 28,
                             list(range(128, 256))] + [[]] * 5, None),
            ("T=512, 2x256, window 100",
             [list(range(256))] * 2 + [[]] * 6, 100)):
        args = _attention_inputs(torch, gen, dev, 8, q_pos, hkv=8)
        case = attention_case(torch, f"paged_prefill_attention[{label}]",
                              bf.paged_prefill_attention, *args, iters=16,
                              window=window, **tile)
        q, pools, tables, ts, tp = args
        got = bf.paged_prefill_attention(q, pools[0][0], pools[0][1], tables,
                                         ts, tp, block_size=128, tile_q=128,
                                         window=window)
        pads = tp < 0
        case["pad_rows"] = int(pads.sum())
        case["pad_max_abs"] = (got[pads].abs().max().item() if case["pad_rows"]
                               else 0.0)
        case["path"] = "mixtral"
        out.append(case)
    dpos = torch.randint(257, 331, (8,), generator=gen, device=dev).tolist()
    args = _attention_inputs(torch, gen, dev, 8, [[p] for p in dpos], hkv=8)
    case = attention_case(torch, "paged_decode_attention[S=8, ctx~300, G=4]",
                          bf.paged_decode_attention, *args, iters=48)
    case["path"] = "mixtral"
    out.append(case)
    return out


def gmm_cases(torch, gen, dev):
    """Phase 3's grouped GEMM (B9) cases at Mixtral-8x7B's expert shapes (8
    experts; 4096 -> 14336 and 14336 -> 4096): a 512-token prefill (M =
    1024 routed rows, expert 2 never chosen: an empty group) and a decode
    step (8 tokens, M = 16), routed top-2 from seeded logits.  Each also
    reports two runs bit-equal, the rows past the groups (exact zeros), its
    TFLOP/s and its launch (``launch_info``)."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg

    out = []
    for label, tokens, empty in (("prefill", 512, 2), ("decode", 8, None)):
        sizes = _routed_sizes(torch, gen, dev, tokens, empty)
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        rows = [0] + offs.tolist()
        m = 2 * tokens
        for k, n in ((4096, 14336), (14336, 4096)):
            lhs = torch.randn((m, k), generator=gen, device=dev,
                              dtype=torch.bfloat16)
            rhs = torch.randn((8, k, n), generator=gen, device=dev,
                              dtype=torch.bfloat16).mul_(1.0 / math.sqrt(k))
            got = gg.gmm(lhs, rhs, sizes)
            launch = gg.launch_info()
            again = gg.gmm(lhs, rhs, sizes)
            want = gg.gmm_plain(lhs, rhs, sizes)
            torch.cuda.synchronize()
            total = int(sizes.sum())
            touched = int((sizes > 0).sum())
            # bytes: lhs and out once, the touched experts' weights once
            nbytes = m * k * 2 + touched * k * n * 2 + m * n * 2 + 8 * 4
            b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
            iters = 10 if label == "prefill" else 40
            case = {
                "name": f"grouped_gemm[{label} M={m}, {k}->{n}, E=8]",
                "kernel": "grouped_gemm", "path": "mixtral",
                "group_sizes": sizes.tolist(),
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "norm_rel_err": rel_norm(got, want),
                "bit_equal": torch.equal(got, again),
                "zeros_max_abs": (got[total:].abs().max().item()
                                  if total < m else 0.0),
                "ms": time_ms(lambda i: gg.gmm(lhs, rhs, sizes), 1, iters),
                "plain_ms": time_ms(lambda i: gg.gmm_plain(lhs, rhs, sizes),
                                    1, 2),
                "bound_ms": b_ms, "bound_by": b_by, "launch": launch,
            }
            case["tflops"] = 2.0 * total * k * n / case["ms"] / 1e9
            (case["library"], case["library_ms"],
             case["library_max_abs_err"]) = _yardstick_ms(
                torch, lambda lib: lib(lhs, rhs, offs=offs),
                lambda: [torch.matmul(lhs[a:b], rhs[e])
                         for e, (a, b) in enumerate(zip(rows, rows[1:]))],
                want, iters)
            out.append(case)
            del lhs, rhs, got, again, want
    return out


def _routed_sizes(torch, gen, dev, tokens, empty=None, experts=8,
                  boost=None):
    """Group sizes of ``tokens`` routed top-2 over ``experts`` from seeded
    logits; expert ``empty`` is never chosen; ``boost`` = (expert, c) raises
    that expert's logits by c."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg

    logits = torch.randn((tokens, experts), generator=gen, device=dev)
    if empty is not None:
        logits[:, empty] = -float("inf")
    if boost is not None:
        logits[:, boost[0]] += boost[1]
    topi, _ = gg.exact_topk_routing(logits, 2)
    return torch.bincount(topi.reshape(-1).long(), minlength=experts).to(
        torch.int32)


def _yardstick_ms(torch, lib_call, loop_call, want, iters):
    """(library name, ms, max abs error against ``want`` or None) of one
    PyTorch call computing a kernel's function: ``torch._grouped_mm`` where
    this build has it and takes the operands, else the per-group
    ``torch.matmul`` loop.  A yardstick only: the port never calls it."""
    lib = getattr(torch, "_grouped_mm", None)
    if lib is not None:
        try:
            err = (lib_call(lib).float() - want.float()).abs().max().item()
            return ("torch._grouped_mm",
                    time_ms(lambda i: lib_call(lib), 1, iters), err)
        except (RuntimeError, TypeError, ValueError) as exc:
            refused = str(exc)[:200]
    else:
        refused = "not in this PyTorch build"
    return (f"8 torch.matmul calls, one a group (_grouped_mm: {refused})",
            time_ms(lambda i: loop_call(), 1, iters), None)


def gmm_backward_cases(torch, gen, dev, gen_skew):
    """Phase 3's grouped GEMM gradient cases (B9 backward: dlhs and drhs)
    at Mixtral-8x7B training shapes: T = 4096 tokens (batch 4 x 1024)
    routed top-2 over 8 experts, M = 8192 rows; the gradients of the gate /
    up projection (4096 -> 14336) and of the down projection (14336 ->
    4096); a ragged case with expert 2 empty and 4000 tokens in an
    8192-row buffer (192 rows past the groups), where dlhs's rows past the
    groups and drhs's empty block must be exact zeros; and (drawn from
    ``gen_skew``, so that the other cases keep their inputs) a skewed
    case, expert 0's logits raised by 1.4 so that it takes ~3000 of the
    8192 rows, which shows whether drhs's tiles are balanced.  Operands are
    scaled so that every output is ~N(0, 1/4): the 3e-2 max bar then sits
    above one bf16 ulp of the largest outputs, and the 1e-2 norm bar does
    the finer work.  Each case also reports two runs bit-equal, its
    TFLOP/s and its launch's shape."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg

    out = []
    m = 8192
    full = _routed_sizes(torch, gen, dev, m // 2)
    ragged = _routed_sizes(torch, gen, dev, 4000, empty=2)
    for label, sizes, k, n, g in (
            ("", full, 4096, 14336, gen), ("", full, 14336, 4096, gen),
            ("ragged, expert 2 empty, ", ragged, 4096, 14336, gen),
            ("skewed, expert 0 boosted, ", None, 4096, 14336, gen_skew)):
        if sizes is None:
            sizes = _routed_sizes(torch, g, dev, m // 2, boost=(0, 1.4))
        total = int(sizes.sum())
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        touched = int((sizes > 0).sum())
        rows = [0] + offs.tolist()
        dout = torch.randn((m, n), generator=g, device=dev,
                           dtype=torch.bfloat16)
        # dlhs = dout @ rhs[g]^T sums over n: rhs ~ N(0, 1 / (4 n))
        rhs = torch.randn((8, k, n), generator=g, device=dev,
                          dtype=torch.bfloat16).mul_(0.5 / math.sqrt(n))
        # drhs = lhs[rows_g]^T @ dout[rows_g] sums over a group's rows
        lhs = torch.randn((m, k), generator=g, device=dev,
                          dtype=torch.bfloat16).mul_(
            0.5 / math.sqrt(total / touched))
        flops = 2.0 * total * k * n
        specs = (
            ("grouped_gemm_dlhs", f"dlhs[{label}M={m}, {n}->{k}, E=8]",
             lambda: gg.gmm_dlhs(dout, rhs, sizes),
             lambda: gg.gmm_dlhs_plain(dout, rhs, sizes),
             lambda lib: lib(dout, rhs.transpose(1, 2), offs=offs),
             lambda: [dout[a:b] @ rhs[e].t()
                      for e, (a, b) in enumerate(zip(rows, rows[1:]))],
             # dout and dlhs once, the touched experts' weights once
             m * n * 2 + touched * k * n * 2 + m * k * 2 + 8 * 4),
            ("grouped_gemm_drhs", f"drhs[{label}M={m}, {k}x{n}, E=8]",
             lambda: gg.gmm_drhs(lhs, dout, sizes),
             lambda: gg.gmm_drhs_plain(lhs, dout, sizes),
             lambda lib: lib(lhs.t(), dout, offs=offs),
             lambda: [lhs[a:b].t() @ dout[a:b]
                      for e, (a, b) in enumerate(zip(rows, rows[1:]))],
             # the rows in groups of lhs and dout once, drhs once
             total * (k + n) * 2 + 8 * k * n * 2 + 8 * 4),
        )
        for kernel, name, run, plain, lib_call, loop_call, nbytes in specs:
            got = run()
            launch = gg.launch_info()
            again = run()
            want = plain()
            torch.cuda.synchronize()
            b_ms, b_by = bound(nbytes, flops)
            case = {"name": name, "kernel": kernel, "path": "moe_training",
                    "group_sizes": sizes.tolist(),
                    "max_abs_err": (got.float() - want.float()).abs().max()
                    .item(),
                    "norm_rel_err": rel_norm(got, want),
                    "bit_equal": torch.equal(got, again),
                    "ms": time_ms(lambda i: run(), 1, 5),
                    "plain_ms": time_ms(lambda i: plain(), 1, 2),
                    "bound_ms": b_ms, "bound_by": b_by, "launch": launch}
            case["tflops"] = flops / case["ms"] / 1e9
            if kernel == "grouped_gemm_dlhs":
                # rows past the groups: exact zeros
                case["zeros_max_abs"] = (got[total:].abs().max().item()
                                         if total < m else 0.0)
                # MACs the boundary tiles spend on other units' rows
                units = gg.gmm_tile_walk(sizes.tolist(), m, k, n)["units"]
                valid = [u for u in units if u[0] >= 0]
                case["boundary_mac_waste"] = 1.0 - total / (
                    len(valid) * gg.GRAD_TILES["bm"])
            else:
                # the empty groups' blocks: exact zeros
                empty = (sizes == 0).nonzero().flatten().tolist()
                case["zeros_max_abs"] = max(
                    [got[e].abs().max().item() for e in empty] + [0.0])
            (case["library"], case["library_ms"],
             case["library_max_abs_err"]) = _yardstick_ms(
                torch, lib_call, loop_call, want, 5)
            out.append(case)
            del got, again, want
        del dout, rhs, lhs
    torch.cuda.empty_cache()
    return out


def gmm_training_forward_cases(torch, gen, dev):
    """Phase 3's grouped GEMM forward (B9, row 15) at the MoE training shape:
    M = 8192 rows of 4096 tokens routed top-2 over 8 experts, 4096 -> 14336
    and 14336 -> 4096, then (drawn after them, so that they keep their
    inputs) a ragged case (4000 tokens, expert 2 empty: 192 rows past the
    groups) and a skewed one (expert 0's logits raised by 1.4), as
    ``gmm_backward_cases`` has them; each beside its plain version, its
    library call and its bound, two runs bit-equal, the rows past the
    groups exact zeros, its TFLOP/s and its launch.  The kernel is the one
    phases 13-14 run."""
    from deepspeed_tpu_torch.ops import grouped_gemm as gg

    out = []
    m = 8192
    full = _routed_sizes(torch, gen, dev, m // 2)
    for label, sizes, k, n in (
            ("", full, 4096, 14336), ("", full, 14336, 4096),
            ("ragged, expert 2 empty, ", {"tokens": 4000, "empty": 2}, 4096,
             14336),
            ("skewed, expert 0 boosted, ", {"tokens": m // 2,
                                            "boost": (0, 1.4)}, 4096, 14336)):
        if isinstance(sizes, dict):       # drawn after the cases before it
            sizes = _routed_sizes(torch, gen, dev, **sizes)
        total = int(sizes.sum())
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        rows = [0] + offs.tolist()
        lhs = torch.randn((m, k), generator=gen, device=dev,
                          dtype=torch.bfloat16)
        # outputs ~N(0, 1/4), as the gradient cases scale theirs: one bf16
        # ulp of the largest of 117 M outputs then sits under the 3e-2 bar
        rhs = torch.randn((8, k, n), generator=gen, device=dev,
                          dtype=torch.bfloat16).mul_(0.5 / math.sqrt(k))
        got = gg.gmm(lhs, rhs, sizes)
        launch = gg.launch_info()
        again = gg.gmm(lhs, rhs, sizes)
        want = gg.gmm_plain(lhs, rhs, sizes)
        torch.cuda.synchronize()
        flops = 2.0 * total * k * n
        touched = int((sizes > 0).sum())
        b_ms, b_by = bound(m * k * 2 + touched * k * n * 2 + m * n * 2
                           + 8 * 4, flops)
        case = {
            "name": f"grouped_gemm[training {label}M={m}, {k}->{n}, E=8]",
            "kernel": "grouped_gemm", "path": "moe_training",
            "group_sizes": sizes.tolist(),
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "norm_rel_err": rel_norm(got, want),
            "bit_equal": torch.equal(got, again),
            "zeros_max_abs": (got[total:].abs().max().item()
                              if total < m else 0.0),
            "ms": time_ms(lambda i: gg.gmm(lhs, rhs, sizes), 1, 5),
            "plain_ms": time_ms(lambda i: gg.gmm_plain(lhs, rhs, sizes), 1,
                                2),
            "bound_ms": b_ms, "bound_by": b_by, "launch": launch,
        }
        case["tflops"] = flops / case["ms"] / 1e9
        (case["library"], case["library_ms"],
         case["library_max_abs_err"]) = _yardstick_ms(
            torch, lambda lib: lib(lhs, rhs, offs=offs),
            lambda: [torch.matmul(lhs[a:b], rhs[e])
                     for e, (a, b) in enumerate(zip(rows, rows[1:]))],
            want, 5)
        out.append(case)
        del lhs, rhs, got, again, want
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# Phases 4 and 5
# --------------------------------------------------------------------- #
def make_engine(torch, cfg, params, max_ctx, use_kernels, kv_dtype=None,
                mixtral=False):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama, RaggedMixtral)

    eng_cfg = RaggedInferenceEngineConfig.from_dict({
        "state_manager": {"max_ragged_batch_size": 512,
                          "max_ragged_sequence_count": 8,
                          "max_context": max_ctx},
        "kv_cache": {"block_size": 128, "dtype": kv_dtype},
    })
    model = RaggedMixtral if mixtral else RaggedLlama
    return InferenceEngineV2(model(cfg, 128, use_kernels=use_kernels),
                             params, eng_cfg)


def _launch_counters():
    from deepspeed_tpu_torch.inference.v2.kernels import blocked_flash as bf
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import evoformer_attn as evo
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_gemm as gg
    from deepspeed_tpu_torch.ops import quantized_matmul as qm
    from deepspeed_tpu_torch.ops import quantizer as tq
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return (qm.LAUNCHES, bf.LAUNCHES, fa.LAUNCHES, gg.LAUNCHES, tq.LAUNCHES,
            evo.LAUNCHES, bsa.LAUNCHES, sa.LAUNCHES)


def reset_launches():
    for counts in _launch_counters():
        for k in counts:
            counts[k] = 0


#: the kernels each path launches, by their LAUNCHES keys
BF16_PUT_DECODE = ("quantized_matmul", "paged_attention",
                   "paged_decode_attention")
BF16_SERVING = BF16_PUT_DECODE + ("paged_verify_attention",)
INT8_SPECULATIVE = ("quantized_matmul", "paged_attention_int8",
                    "paged_decode_attention_int8",
                    "paged_verify_attention_int8")
INT8_SPEC_RUN = ("quantized_matmul", "paged_attention_int8",
                 "paged_verify_attention_int8")
INT8_DECODE_RUN = ("quantized_matmul", "paged_attention_int8",
                   "paged_decode_attention_int8")
TRAINING = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
#: the same kernels launched through the folded and the paired entry
FLASH_BY_ENTRY = {"bshd": TRAINING,
                  **{e: tuple(f"{k}_{e}" for k in TRAINING)
                     for e in ("folded", "paired")}}
ALL_FLASH = sum(FLASH_BY_ENTRY.values(), ())
MIXTRAL_SERVING = ("paged_prefill_attention", "paged_decode_attention",
                   "grouped_gemm")
MOE_GMM = ("grouped_gemm", "grouped_gemm_dlhs", "grouped_gemm_drhs")
MOE_TRAINING = TRAINING + MOE_GMM
ALL_KERNELS = tuple(dict.fromkeys(
    BF16_SERVING + INT8_SPECULATIVE + ALL_FLASH + MIXTRAL_SERVING + MOE_GMM
    + ("block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
       "block_sparse_attention_bwd_dkv")))


def read_launches(keys=ALL_KERNELS):
    counts = {k: v for c in _launch_counters() for k, v in c.items()}
    return {k: counts[k] for k in keys}


def slice_kernel_vs_plain(torch, np, prompts):
    """2 layers of the 7B geometry, int8 weights from SEED: the same
    requests through the kernels and through the plain paths."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype=torch.bfloat16)
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    max_ctx = 256 + 8 + 8
    uids = list(range(len(prompts)))
    res = {}
    for mode, use_kernels in (("kernel", True), ("plain", False)):
        eng = make_engine(torch, cfg, params, max_ctx, use_kernels)
        reset_launches()
        first = eng.put(uids, prompts)
        logits = torch.from_numpy(np.stack([first[u] for u in uids]))
        start = [int(first[u].argmax()) for u in uids]
        toks = eng.decode_loop(uids, start, 8)
        eng.flush(uids)
        torch.cuda.synchronize()
        res[mode] = (logits, toks, read_launches(
            BF16_PUT_DECODE if use_kernels else ALL_KERNELS))
        del eng
    k_logits, k_toks, k_launch = res["kernel"]
    p_logits, p_toks, p_launch = res["plain"]
    scale = p_logits.abs().max().item()
    err = (k_logits - p_logits).abs().max().item() / scale
    agree = float((k_toks == p_toks).mean())
    first_agree = float((k_logits.argmax(-1) == p_logits.argmax(-1))
                        .float().mean())
    return {"logits_rel_err": err, "first_token_agreement": first_agree,
            "decode_token_agreement": agree, "kernel_launches": k_launch,
            "plain_launches": p_launch,
            "finite": bool(torch.isfinite(k_logits).all())}


def timed_serving(torch, eng, uids, prompts, gen_tokens):
    """Phase 5's workload on ``eng``: all requests arrive at t0; the
    512-token budget admits two 256-token prompts per forward, so they are
    put two at a time and a request's TTFT is the end of the put that
    returned its logits; then ``decode_loop`` of ``gen_tokens`` greedy
    tokens.  Returns (ttft_ms, first logits, first tokens, tokens,
    decode seconds)."""
    ttft_ms = {}
    first = {}
    t0 = time.perf_counter()
    for i in range(0, len(uids), 2):
        got = eng.put(uids[i:i + 2], prompts[i:i + 2])
        now = (time.perf_counter() - t0) * 1e3
        for u in uids[i:i + 2]:
            ttft_ms[u] = now
            first[u] = got[u]
    start = [int(first[u].argmax()) for u in uids]
    t1 = time.perf_counter()
    toks = eng.decode_loop(uids, start, gen_tokens)
    return ttft_ms, first, start, toks, time.perf_counter() - t1


def served_run(torch, prompts, gen_tokens=48):
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.inference.v2.speculative import NgramDrafter
    from deepspeed_tpu_torch.models import LlamaConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    t0 = time.perf_counter()
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_ctx = 256 + 1 + gen_tokens + 8      # room for one K=5 verify pass
    eng = make_engine(torch, cfg, params, max_ctx, True)
    uids = list(range(len(prompts)))
    # warm: one request of the served size through prefill and decode, so
    # the measured puts find the allocator's buffers already made
    eng.put([100, 101], prompts[:2])
    eng.decode_loop([100, 101], [1, 1], 2)
    eng.flush([100, 101])
    torch.cuda.synchronize()

    launch_us = host_launch_us(torch)
    reset_launches()
    ttft_ms, first, start, toks, decode_s = timed_serving(
        torch, eng, uids, prompts, gen_tokens)
    finite = all(bool(torch.isfinite(torch.from_numpy(first[u])).all())
                 for u in uids)
    # one speculative round over the bf16 pool: n-gram drafts of each
    # request's history, scored in one verify pass, the accepted prefix
    # committed
    hist = [p + [s] + t.tolist() for p, s, t in zip(prompts, start, toks)]
    v_logits, rounds = speculative_round(torch, eng, NgramDrafter(), uids,
                                         hist, 4)
    accepted = [acc for _, acc in rounds]
    finite &= bool(torch.isfinite(v_logits).all())
    eng.flush(uids)
    torch.cuda.synchronize()
    launches = read_launches(BF16_SERVING)
    # where the time goes: a traced prefill put (2 prompts) and 4 decode
    # steps; the tracer's own cost inflates the wall times
    trace = {"prefill": profile_window(
        torch, lambda: eng.put([200, 201], prompts[:2]), 1)}
    trace["decode"] = profile_window(
        torch, lambda: eng.decode_loop([200, 201], start[:2], 4), 4)
    eng.flush([200, 201])
    # the same probe after the process's first traces
    launch_us = {"before_serving": launch_us,
                 "after_trace": host_launch_us(torch)}
    return {
        "layers": cfg.num_hidden_layers, "requests": len(uids),
        "prompt_len": len(prompts[0]), "gen_tokens": gen_tokens,
        "param_init_s": init_s,
        "ttft_ms": [ttft_ms[u] for u in uids],
        "decode_ms_per_step": decode_s / gen_tokens * 1e3,
        "decode_tokens_per_s": len(uids) * gen_tokens / decode_s,
        "host_launch_us": launch_us,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "finite": finite,
        "verify_round_accepted": accepted,
        "tokens_shape": list(toks.shape),
        "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
        "trace": trace,
    }


# --------------------------------------------------------------------- #
# Phases 9 and 10: speculative verify over an int8 KV cache
# --------------------------------------------------------------------- #
def speculative_kernel_vs_plain(torch, np, prompts, k_tokens=5, passes=3):
    """Phase 9: 2 layers of the 7B geometry, int8 weights and int8 KV from
    SEED.  Per path (plain first, then kernels) one engine decodes the
    prompts sequentially with ``decode_step`` — the plain path its own
    greedy tokens, the kernel path the same tokens — and another runs
    ``verify_step`` passes of ``k_tokens`` over those tokens, commits them,
    then one pass of wrong drafts committed as its fed token alone."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype=torch.bfloat16)
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    steps = k_tokens * passes
    max_ctx = len(prompts[0]) + steps + k_tokens + 8
    uids = list(range(len(prompts)))
    n = len(uids)
    chain = None          # the plain path's greedy tokens, [step][uid]
    res = {}
    for mode, use_kernels in (("plain", False), ("kernel", True)):
        seq_eng = make_engine(torch, cfg, params, max_ctx, use_kernels,
                              "int8")
        ver_eng = make_engine(torch, cfg, params, max_ctx, use_kernels,
                              "int8")
        reset_launches()
        first = seq_eng.put(uids, prompts)
        ver_eng.put(uids, prompts)
        if chain is None:
            chain = [[int(first[u].argmax()) for u in uids]]
        seq_rows = []
        for i in range(steps + 1):
            logits = seq_eng.decode_step(uids, chain[i])[:n].float()
            seq_rows.append(logits)
            if len(chain) == i + 1:
                chain.append(logits.argmax(-1).tolist())
        ver_rows = []
        for j in range(passes):
            feeds = [[chain[j * k_tokens + k][s] for k in range(k_tokens)]
                     for s in range(n)]
            ver_rows.append(ver_eng.verify_step(uids, feeds)[:n].float())
            for s, u in enumerate(uids):
                ver_eng.commit_verified(u, feeds[s])
        fed = chain[steps]
        wrong = [[fed[s]] + [(fed[s] + 1 + k) % cfg.vocab_size
                             for k in range(k_tokens - 1)] for s in range(n)]
        ver_eng.verify_step(uids, wrong)
        for s, u in enumerate(uids):
            ver_eng.commit_verified(u, [fed[s]])
        torch.cuda.synchronize()
        res[mode] = {
            "seq": torch.stack(seq_rows[:steps], 1).cpu(),   # [n, steps, V]
            "ver": torch.cat(ver_rows, 1).cpu(),
            "launches": read_launches(INT8_SPECULATIVE if use_kernels
                                      else ALL_KERNELS),
            "free_blocks": [ver_eng.state_manager.free_blocks,
                            seq_eng.state_manager.free_blocks],
        }
        seq_eng.flush(uids)
        ver_eng.flush(uids)
        del seq_eng, ver_eng
    k, p = res["kernel"], res["plain"]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    nxt = torch.tensor(chain[1:steps + 1]).T            # [n, steps]
    return {"layers": 2, "k_tokens": k_tokens, "passes": passes,
            "verify_rel_err": rel(k["ver"], p["ver"]),
            "verify_vs_decode_rel_err": rel(k["ver"], k["seq"]),
            "plain_verify_vs_decode_rel_err": rel(p["ver"], p["seq"]),
            "plain_verify_accept_rate": float(
                (p["ver"].argmax(-1) == nxt).float().mean()),
            "kernel_verify_accept_rate": float(
                (k["ver"].argmax(-1) == nxt).float().mean()),
            "free_blocks_after_reject": {m: res[m]["free_blocks"]
                                         for m in res},
            "kernel_launches": k["launches"],
            "plain_launches": p["launches"],
            "finite": bool(torch.isfinite(k["ver"]).all())}


def speculative_round(torch, eng, drafter, uids, hists, draft_k):
    """One greedy speculative round through the engine's public calls:
    each request's drafts of its history ``hists[i]`` (padded to
    ``draft_k`` with its last token) → ``verify_step(greedy=True)`` →
    ``accept_drafts`` → ``commit_verified``.  Returns the requests' verify
    logits and, for each, its emitted tokens and accepted count."""
    from deepspeed_tpu_torch.inference.v2.speculative import accept_drafts

    drafts = [(drafter.draft(h, draft_k) + [h[-1]] * draft_k)[:draft_k]
              for h in hists]
    feeds = [[h[-1]] + d for h, d in zip(hists, drafts)]
    logits, nxt = eng.verify_step(uids, feeds, greedy=True)
    nxt = nxt[:len(uids)].tolist()                      # the pass's sync
    out = []
    for u, f, d, n in zip(uids, feeds, drafts, nxt):
        emitted, acc = accept_drafts(n, d)
        eng.commit_verified(u, f[:acc + 1])
        out.append((emitted, acc))
    return logits[:len(uids)], out


def speculative_generate(torch, eng, uids, prompts, gen_tokens, draft_k):
    """Greedy speculative decoding: put, then :func:`speculative_round`
    with n-gram drafts until every request has ``gen_tokens`` tokens.
    Returns the tokens, the stats, the rounds' wall time and whether every
    verify pass's logits were finite."""
    from deepspeed_tpu_torch.inference.v2.speculative import (
        NgramDrafter, SpeculativeStats)

    drafter = NgramDrafter()
    stats = SpeculativeStats()
    prompt = dict(zip(uids, prompts))
    first = {}
    for i in range(0, len(uids), 2):          # two prompts fill the budget
        first.update(eng.put(uids[i:i + 2], prompts[i:i + 2]))
    gen = {u: [int(first[u].argmax())] for u in uids}
    finite = torch.ones((), dtype=torch.bool, device=eng.device)
    t0 = time.perf_counter()
    while True:
        live = [u for u in uids if len(gen[u]) < gen_tokens]
        if not live:
            break
        logits, rounds = speculative_round(
            torch, eng, drafter, live, [prompt[u] + gen[u] for u in live],
            draft_k)
        finite &= torch.isfinite(logits).all()
        stats.ticks += 1
        stats.k_sum += draft_k * len(live)
        stats.k_requests += len(live)
        for u, (emitted, acc) in zip(live, rounds):
            stats.drafted += draft_k
            stats.accepted += acc
            stats.emitted += len(emitted)
            gen[u].extend(emitted)
    torch.cuda.synchronize()
    return ({u: gen[u][:gen_tokens] for u in uids}, stats,
            time.perf_counter() - t0, bool(finite.item()))


def speculative_served_run(torch, np, gen_tokens=48, draft_k=4):
    """Phase 10: the 32-layer 7B geometry over an int8 KV cache, served
    speculatively, with ``decode_loop`` on a fresh engine as the
    yardstick."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (
        BlockedKVCache)
    from deepspeed_tpu_torch.models import LlamaConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(0, cfg.vocab_size, 32).tolist() * 8
               for _ in range(8)]
    uids = list(range(len(prompts)))
    max_ctx = len(prompts[0]) + gen_tokens + 2 * (draft_k + 1) + 8
    spec_eng = make_engine(torch, cfg, params, max_ctx, True, "int8")
    ref_eng = make_engine(torch, cfg, params, max_ctx, True, "int8")
    for eng in (spec_eng, ref_eng):       # warm: allocator buffers made
        eng.put([100, 101], prompts[:2])
        eng.verify_step([100, 101], [[1] * (draft_k + 1)] * 2)
        eng.decode_loop([100, 101], [1, 1], 2)
        eng.flush([100, 101])
    torch.cuda.synchronize()

    reset_launches()
    toks, stats, spec_s, finite = speculative_generate(
        torch, spec_eng, uids, prompts, gen_tokens, draft_k)
    spec_launches = read_launches(INT8_SPECULATIVE)
    # where the time goes: one traced verify pass over the 8 live requests
    # (outside both counted runs)
    trace = profile_window(torch, lambda: spec_eng.verify_step(
        uids, [[toks[u][-1]] * (draft_k + 1) for u in uids]), 1)
    spec_eng.flush(uids)
    sm = spec_eng.state_manager
    all_free = sm.free_blocks == sm.allocator.num_blocks - 1
    reset_launches()
    first = {}
    for i in range(0, len(uids), 2):
        first.update(ref_eng.put(uids[i:i + 2], prompts[i:i + 2]))
    start = [int(first[u].argmax()) for u in uids]
    t0 = time.perf_counter()
    ref = ref_eng.decode_loop(uids, start, gen_tokens - 1)
    ref_s = time.perf_counter() - t0
    ref_eng.flush(uids)
    torch.cuda.synchronize()
    ref_launches = read_launches(INT8_SPECULATIVE)
    sm = ref_eng.state_manager
    all_free &= sm.free_blocks == sm.allocator.num_blocks - 1
    got = np.asarray([toks[u] for u in uids])
    want = np.concatenate([np.asarray(start)[:, None], ref], axis=1)
    new = len(uids) * (gen_tokens - 1)     # tokens after the put's first
    bf16_bytes = BlockedKVCache(cfg.num_hidden_layers, 0, 128,
                                cfg.num_key_value_heads, cfg.head_dim,
                                "bf16").per_token_bytes
    return {
        "layers": cfg.num_hidden_layers, "requests": len(uids),
        "prompt_len": len(prompts[0]), "gen_tokens": gen_tokens,
        "draft_k": draft_k, "verify_passes": stats.ticks,
        "ms_per_verify_pass": spec_s / stats.ticks * 1e3,
        "speculative_tokens_per_s": new / spec_s,
        "decode_loop_tokens_per_s": new / ref_s,
        "decode_loop_ms_per_step": ref_s / (gen_tokens - 1) * 1e3,
        "spec_stats": stats.as_dict(),
        # a pass serves every live request: tokens one request gets a pass
        "tokens_per_request_pass": stats.emitted / stats.k_requests,
        "token_agreement_with_decode_loop": float((got == want).mean()),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "per_token_bytes": {"int8": spec_eng.state_manager.kv_cache
                            .per_token_bytes, "bf16": bf16_bytes},
        "spec_launches": spec_launches, "decode_loop_launches": ref_launches,
        "finite": finite, "all_blocks_free": bool(all_free),
        "tokens_in_vocab": bool(((got >= 0) & (got < cfg.vocab_size)).all()),
        "trace": trace,
    }


# --------------------------------------------------------------------- #
# Phases 11 and 12: Mixtral-8x7B served at full width
# --------------------------------------------------------------------- #
def mixtral_params(torch, layers):
    """Mixtral-8x7B at full width and ``layers`` layers, random bf16 weights
    made on the card from SEED."""
    from deepspeed_tpu_torch.checkpoint import random_mixtral_params
    from deepspeed_tpu_torch.models import MixtralConfig

    cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=layers,
                                     dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return cfg, random_mixtral_params(cfg, "cuda", gen)


def mixtral_kernel_vs_plain(torch, np, prompts, steps=4):
    """Phase 11: 2 layers of Mixtral-8x7B at full width, the same requests
    through the kernels, through the plain paths and, as the yardstick,
    through the plain paths in fp32.

    Put: the 8 prompts, two a forward, on each path; their logits are
    compared.  Own-KV decode: one ``decode_step`` from each engine's own
    prompt KV, fed the plain path's greedy tokens.  Shared-KV decode: each
    engine then takes up the bf16 plain path's KV of the prompts and that
    first token (``flush_to_host(include_kv=True)`` ->
    ``resume(kv_state=)``) and runs ``steps`` ``decode_step`` rounds fed
    the plain path's greedy tokens, so that these logits compare the
    decode step itself: two bf16 paths' prompt KV differ by more than any
    kernel's error, because a top-2 router near-tie flips under the least
    change of its input and the flipped token's K/V move every later row.
    Even from shared KV the two bf16 paths' decode logits sit ~1% apart in
    norm, each ~1% from fp32: the plain decode path rounds P to bf16 (the
    JAX package's XLA path), the decode kernel keeps it in fp32, and the
    router carries a 0.1% change of its input into the logits undamped
    (PERF.md, Findings).  :func:`mixtral_slice_failures` holds the result
    to the phase's bars."""
    cfg, params = mixtral_params(torch, 2)
    max_ctx = len(prompts[0]) + steps + 8
    uids = list(range(len(prompts)))
    n = len(uids)
    state = {"snap": None, "chain": None}

    def run(cfg, params, use_kernels):
        eng = make_engine(torch, cfg, params, max_ctx, use_kernels,
                          mixtral=True)
        reset_launches()
        first = {}
        for i in range(0, n, 2):
            first.update(eng.put(uids[i:i + 2], prompts[i:i + 2]))
        put = torch.from_numpy(np.stack([first[u] for u in uids]))
        chain = state["chain"] = (state["chain"]
                                  or [[int(first[u].argmax()) for u in uids]])
        own = eng.decode_step(uids, chain[0])[:n].float().cpu()
        if len(chain) == 1:
            chain.append(own.argmax(-1).tolist())
        kv = eng.flush_to_host(uids, include_kv=state["snap"] is None)
        state["snap"] = state["snap"] or kv
        for u in uids:
            eng.resume(u, prompts[u] + [chain[0][u]],
                       kv_state=state["snap"][u])
        rows = []
        for i in range(1, steps + 1):
            logits = eng.decode_step(uids, chain[i])[:n].float().cpu()
            rows.append(logits)
            if len(chain) == i + 1:
                chain.append(logits.argmax(-1).tolist())
        eng.flush(uids)
        torch.cuda.synchronize()
        return put, own, torch.stack(rows, 1), read_launches(ALL_KERNELS)

    p_put, p_own, p_dec, p_launch = run(cfg, params, False)
    k_put, k_own, k_dec, k_launch = run(cfg, params, True)
    verify = mixtral_verify_vs_decode(torch, cfg, params, prompts, max_ctx)
    params = _tree_map(params, lambda t: t.float())
    f_put, _, f_dec, _ = run(dataclasses.replace(cfg, dtype=torch.float32),
                             params, False)
    del params

    def rel_max(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    return {"layers": cfg.num_hidden_layers, "requests": n,
            "decode_steps": steps,
            "logits_rel_err": {"put": rel_max(k_put, p_put),
                               "decode_own_kv": rel_max(k_own, p_own),
                               "decode": rel_max(k_dec, p_dec)},
            "logits_norm_rel_err": {"put": rel_norm(k_put, p_put),
                                    "decode_own_kv": rel_norm(k_own, p_own),
                                    "decode": rel_norm(k_dec, p_dec)},
            "norm_rel_err_vs_fp32": {
                "put": {"kernel": rel_norm(k_put, f_put),
                        "plain": rel_norm(p_put, f_put)},
                "decode": {"kernel": rel_norm(k_dec, f_dec),
                           "plain": rel_norm(p_dec, f_dec)}},
            "kernel_launches": {k: k_launch[k] for k in MIXTRAL_SERVING},
            "kernel_other_launches": {k: v for k, v in k_launch.items()
                                      if k not in MIXTRAL_SERVING and v},
            "plain_launches": p_launch,
            "verify": verify,
            "finite": bool(torch.isfinite(k_put).all()
                           and torch.isfinite(k_own).all()
                           and torch.isfinite(k_dec).all()
                           and verify["finite"])}


def mixtral_verify_vs_decode(torch, cfg, params, prompts, max_ctx,
                             k_tokens=3):
    """Phase 11, verify part, on the kernel path: one engine decodes the
    prompts' next ``k_tokens`` greedy tokens with sequential
    ``decode_step`` calls, another scores the same fed tokens in one
    ``verify_step`` (Mixtral has no verify route, so its rows go through
    the generic paged kernel, as in the JAX package); each verify row
    against the decode row of the same fed prefix."""
    uids = list(range(len(prompts)))
    n = len(uids)
    seq_eng = make_engine(torch, cfg, params, max_ctx, True, mixtral=True)
    ver_eng = make_engine(torch, cfg, params, max_ctx, True, mixtral=True)
    first = {}
    for i in range(0, n, 2):
        first.update(seq_eng.put(uids[i:i + 2], prompts[i:i + 2]))
        ver_eng.put(uids[i:i + 2], prompts[i:i + 2])
    fed = [[int(first[u].argmax()) for u in uids]]
    rows = []
    for i in range(k_tokens):
        logits = seq_eng.decode_step(uids, fed[i])[:n].float()
        rows.append(logits)
        fed.append(logits.argmax(-1).tolist())
    reset_launches()
    ver = ver_eng.verify_step(
        uids, [[fed[k][s] for k in range(k_tokens)] for s in range(n)])
    ver = ver[:n].float()
    torch.cuda.synchronize()
    launches = read_launches(ALL_KERNELS)
    dec = torch.stack(rows, 1)
    for eng in (seq_eng, ver_eng):
        eng.flush(uids)
    return {"k_tokens": k_tokens,
            "verify_vs_decode_rel_err": (
                (ver - dec).abs().max() / dec.abs().max()).item(),
            "verify_vs_decode_norm_rel_err": rel_norm(ver, dec),
            "verify_launches": {k: v for k, v in launches.items() if v},
            "finite": bool(torch.isfinite(ver).all())}


def mixtral_slice_failures(mix) -> list:
    """The bars of phase 11 that :func:`mixtral_kernel_vs_plain`'s result
    misses (empty when it passes): every logit set within TOL of the plain
    path's largest magnitude; put within NORM_TOL and shared-KV decode
    within MIXTRAL_DECODE_NORM_TOL in norm; against fp32, the kernel path at
    most FP32_RATIO times the plain path's distance; the kernel path's
    verify rows within TOL of its sequential decode rows; finite
    values."""
    missed = [f"{k} max {v:.4g} > {TOL}"
              for k, v in mix["logits_rel_err"].items() if not v <= TOL]
    norm = mix["logits_norm_rel_err"]
    for key, bar in (("put", NORM_TOL), ("decode", MIXTRAL_DECODE_NORM_TOL)):
        if not norm[key] <= bar:
            missed.append(f"{key} norm {norm[key]:.4g} > {bar}")
    for key, d in mix["norm_rel_err_vs_fp32"].items():
        if not d["kernel"] <= FP32_RATIO * d["plain"]:
            missed.append(f"{key} vs fp32 {d['kernel']:.4g} > "
                          f"{FP32_RATIO} x {d['plain']:.4g}")
    ver = mix["verify"]["verify_vs_decode_rel_err"]
    if not ver <= TOL:
        missed.append(f"verify vs sequential decode max {ver:.4g} > {TOL}")
    if not mix["finite"]:
        missed.append("non-finite logits")
    return missed


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def mixtral_bytes(cfg, experts_touched: float) -> float:
    """Weight bytes one served forward reads: every layer's attention
    projections and router, ``experts_touched`` experts a layer, the final
    norm and lm_head (the KV and activations are small beside them)."""
    h, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    attn = (2 * h * h + 2 * h * kv) * 2 + h * cfg.num_local_experts * 4
    expert = 3 * h * cfg.intermediate_size * 2
    return (cfg.num_hidden_layers * (attn + experts_touched * expert)
            + h * cfg.vocab_size * 2)


def mixtral_served_run(torch, np, prompts, gen_tokens=48):
    """Phase 12: Mixtral-8x7B at full width and 16 of its 32 layers (the
    bf16 weights of all 32 do not fit the card), random bf16 weights from
    SEED made on the card, bf16 KV (block 128), token budget 512: 8
    requests of 256-token prompts, 48 greedy tokens each through ``put``
    and ``decode_loop``."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = mixtral_params(torch, 16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_ctx = len(prompts[0]) + gen_tokens + 8
    eng = make_engine(torch, cfg, params, max_ctx, True, mixtral=True)
    uids = list(range(len(prompts)))
    eng.put([100, 101], prompts[:2])      # warm the allocator's buffers
    eng.decode_loop([100, 101], [1, 1], 2)
    eng.flush([100, 101])
    torch.cuda.synchronize()

    reset_launches()
    ttft_ms, first = {}, {}
    t0 = time.perf_counter()
    for i in range(0, len(uids), 2):      # two 256-token prompts a forward
        got = eng.put(uids[i:i + 2], prompts[i:i + 2])
        now = (time.perf_counter() - t0) * 1e3
        for u in uids[i:i + 2]:
            ttft_ms[u] = now
            first[u] = got[u]
    finite = all(bool(np.isfinite(first[u]).all()) for u in uids)
    start = [int(first[u].argmax()) for u in uids]
    t1 = time.perf_counter()
    toks = eng.decode_loop(uids, start, gen_tokens - 1)
    decode_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = read_launches(ALL_KERNELS)
    # where the time goes: one traced decode step (outside the count)
    trace = profile_window(torch, lambda: eng.decode_step(
        uids, [int(t) for t in toks[:, -1]]), 1)
    eng.flush(uids)
    # and one traced 2 x 256 prefill (outside the count): the grouped GEMM
    # forward at M = 1024, 48 launches
    prefill_trace = profile_window(torch, lambda: eng.put([200, 201],
                                                          prompts[:2]), 1,
                                   top=8)
    eng.flush([200, 201])
    sm = eng.state_manager
    all_free = sm.free_blocks == sm.allocator.num_blocks - 1
    # top-2 of 8 experts over 8 uniformly routed tokens leaves an expert
    # untouched with probability (6/8)^8
    touched = 8 * (1 - (6 / 8) ** 8)
    steps = gen_tokens - 1
    decode_b = mixtral_bytes(cfg, touched)
    prefill_b = mixtral_bytes(cfg, 8)
    h, kv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    prefill_flops = 2 * 512 * cfg.num_hidden_layers * (
        2 * h * h + 2 * h * kv
        + cfg.num_experts_per_tok * 3 * h * cfg.intermediate_size)
    # the prefill's grouped GEMMs alone: 3 a layer at M = 1024 routed rows,
    # each reading the 8 experts' weights (512 tokens touch all 8), its rows
    # and its output once
    f = cfg.intermediate_size
    gmm_bound = bound(cfg.num_hidden_layers * 3 * (
        cfg.num_local_experts * h * f * 2 + 1024 * (h + f) * 2),
        cfg.num_hidden_layers * 3 * 2.0 * 1024 * h * f)[0]
    out = {
        "layers": cfg.num_hidden_layers, "requests": len(uids),
        "prompt_len": len(prompts[0]), "gen_tokens": gen_tokens,
        "param_init_s": init_s,
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in _leaves(params)),
        "ttft_ms_per_pair": [ttft_ms[u] for u in uids[::2]],
        "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tokens_per_s": len(uids) * steps / decode_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "expected_launches": {
            "paged_prefill_attention": 4 * cfg.num_hidden_layers,
            "paged_decode_attention": steps * cfg.num_hidden_layers,
            "grouped_gemm": 3 * cfg.num_hidden_layers * (4 + steps)},
        "decode_step_bound_ms": bound(decode_b, 0.0)[0],
        "decode_step_bytes": decode_b, "experts_touched_expected": touched,
        "prefill_forward_bound_ms": bound(prefill_b, prefill_flops)[0],
        "prefill_forward_bytes": prefill_b,
        "prefill_forward_flops": prefill_flops,
        "prefill_gmm_bound_ms": gmm_bound,
        "finite": finite, "all_blocks_free": bool(all_free),
        "tokens_shape": list(toks.shape),
        "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg.vocab_size))
                                .all()),
        "trace": trace, "prefill_trace": prefill_trace,
    }
    if trace is not None:
        kinds = trace["kind_ms_per_step"]
        out["decode_gmm_share"] = (kinds.get("grouped_gemm", 0.0)
                                   / trace["device_busy_ms_per_step"])
    if prefill_trace is not None:
        out["prefill_gmm_ms"] = prefill_trace["kind_ms_per_step"].get(
            "grouped_gemm", 0.0)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --------------------------------------------------------------------- #
# Phases 13-15: MoE training at full Mixtral-8x7B width
# --------------------------------------------------------------------- #
MOE_TOKENS = (4, 1024)       # batch 4 x 1024: T = 4096, M = T * k = 8192


def moe_ids(torch, np, dev, vocab):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, vocab, size=MOE_TOKENS)
                            .astype(np.int32)).to(dev)


def mixtral_training_model(torch, dev, layers, dropless, use_kernels=True,
                           dtype=None):
    """Mixtral-8x7B at full width and ``layers`` layers, fp32 weights drawn
    on the card from SEED (the same numbers for every ``use_kernels`` and
    ``dtype``)."""
    from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig.mixtral_8x7b(num_hidden_layers=layers,
                                     dtype=dtype or torch.bfloat16)
    return MixtralForCausalLM(cfg, seed=SEED, device=dev,
                              use_kernels=use_kernels, dropless=dropless)


def moe_layer_kernel_vs_plain(torch, dev):
    """Phase 13, layer part: one dropless ``MoE`` at full width (4096 ->
    14336, 8 experts, top-2), weights from SEED, on the same bf16 input and
    upstream gradient (4 x 1024 tokens) through the grouped GEMM kernels,
    through their plain versions and, as the yardstick, in fp32 on the same
    (bf16-valued) weights and input.  The router is fp32 on every path and
    sees the same values, so all three route every token alike: what
    differs is the kernels' arithmetic and the bf16 roundings alone."""
    from deepspeed_tpu_torch.models import MixtralConfig
    from deepspeed_tpu_torch.moe import MoE

    cfg = MixtralConfig.mixtral_8x7b()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(MOE_TOKENS + (cfg.hidden_size,), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    res = {}
    for mode in ("kernel", "plain", "fp32"):
        dtype = torch.float32 if mode == "fp32" else torch.bfloat16
        layer = MoE(cfg.hidden_size, cfg.intermediate_size,
                    num_experts=cfg.num_local_experts,
                    k=cfg.num_experts_per_tok, dropless=True, dtype=dtype,
                    use_kernels=mode == "kernel", seed=SEED, device=dev)
        with torch.no_grad():              # every path on the bf16 values
            for p in layer.parameters():
                p.copy_(p.to(torch.bfloat16).to(dtype))
        if mode != "fp32":
            layer.to(torch.bfloat16)       # what the engine does
        xin = x.to(dtype, copy=True).requires_grad_()
        reset_launches()
        out, l_aux = layer(xin)
        (torch.sum(out.float() * dy.float()) + l_aux).backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float() for n, p in layer.named_parameters()}
        res[mode] = ({"out": out.detach().float(), "dx": xin.grad.float(),
                      **grads}, read_launches(ALL_KERNELS))
        del layer, out, xin, grads
        torch.cuda.empty_cache()
    (k_vals, k_launch), (p_vals, p_launch), (f_vals, _) = (
        res["kernel"], res["plain"], res["fp32"])
    short = {n: n.split(".")[-1] if "experts" in n
             else ("router" if n.endswith("wg.weight") else n)
             for n in k_vals}
    return {
        "norm_rel_err": {short[n]: rel_norm(k_vals[n], p_vals[n])
                         for n in k_vals},
        "norm_rel_err_vs_fp32": {
            short[n]: {"kernel": rel_norm(k_vals[n], f_vals[n]),
                       "plain": rel_norm(p_vals[n], f_vals[n])}
            for n in k_vals},
        "kernel_launches": {k: k_launch[k] for k in MOE_GMM},
        "plain_launches": p_launch,
        "finite": all(bool(torch.isfinite(v).all()) for v in k_vals.values()),
    }


def moe_model_kernel_vs_plain(torch, np, dev, layers=2):
    """Phase 13, model part: the dropless Mixtral at full width and 2
    layers, weights from SEED, one step's forward and backward on 4 x 1024
    tokens through the kernels (flash attention and the grouped GEMMs) and
    through their plain versions, both in bf16 as the engine holds the
    weights; and the same model in fp32 (plain) as the yardstick, forward
    only: the logits and the first-step loss.  A random router's top-2
    near-ties flip under the least change of its input, a flipped token's
    hidden state and logits move by much of their size, and it moves its
    experts' gradients by ~1/sqrt(rows) each: the two bf16 paths' logits
    and gradients part by route flips far more than by any kernel's
    error.  So the gradients are held to their bars in
    :func:`moe_layer_kernel_vs_plain`, where the routes agree, and the
    logits only against fp32; here the direct distances are recorded."""
    ids = moe_ids(torch, np, dev, 32000)
    res = {}
    for mode in ("kernel", "plain", "fp32"):
        if mode == "fp32":
            model = mixtral_training_model(torch, dev, layers, True, False,
                                           torch.float32)
        else:
            model = mixtral_training_model(torch, dev, layers, True,
                                           mode == "kernel").to(
                torch.bfloat16)
        with torch.no_grad():
            logits = model(ids).float()
        reset_launches()
        if mode == "fp32":
            with torch.no_grad():
                loss = model(ids, ids)
            grads = {}
        else:
            loss = model(ids, ids)
            loss.backward()
            # the router and expert weight gradients, bf16 as left
            grads = {n: p.grad for n, p in model.named_parameters()
                     if n.split(".")[-1] in ("w_gate", "w_up", "w_down")
                     or n.endswith("gate.wg.weight")}
        torch.cuda.synchronize()
        res[mode] = (loss.item(), logits, grads, read_launches(ALL_KERNELS))
        del model, loss
        torch.cuda.empty_cache()
    k_loss, k_logits, k_grads, k_launch = res.pop("kernel")
    p_loss, p_logits, p_grads, p_launch = res.pop("plain")
    f_loss, f_logits, _, _ = res.pop("fp32")
    return {
        "layers": layers, "tokens": list(MOE_TOKENS),
        "losses": {"kernel": k_loss, "plain": p_loss, "fp32": f_loss},
        "loss_rel_err": abs(k_loss - p_loss) / abs(p_loss),
        "logits_norm_rel_err": rel_norm(k_logits, p_logits),
        "logits_vs_fp32": {"kernel": rel_norm(k_logits, f_logits),
                           "plain": rel_norm(p_logits, f_logits)},
        # recorded, not held to a bar (route flips, above)
        "grad_norm_rel_err": {n: rel_norm(k_grads[n], p_grads[n])
                              for n in k_grads},
        "kernel_launches": {k: k_launch[k] for k in MOE_TRAINING},
        "kernel_other_launches": {k: v for k, v in k_launch.items()
                                  if k not in MOE_TRAINING and v},
        "plain_launches": p_launch,
        "finite": bool(torch.isfinite(k_logits).all()
                       and math.isfinite(k_loss)),
    }


def moe_training_failures(layer, model) -> list:
    """The bars of phase 13 that its two parts miss (empty when they pass):
    at the layer, the output, dx, the router's and every expert weight's
    gradient within NORM_TOL of the plain path in norm and, against fp32,
    at most FP32_RATIO times the plain path's distance; in the model, the
    first-step loss within LOSS_TOL and the logits at most FP32_RATIO
    times the plain path's distance from fp32; finite values.  The model's
    logits and gradients are not held to a bar against the plain path
    directly: there route flips, not the kernels, set the distance (6.8%
    and 9-15% in norm on the card, where the layer's agree to 0.3%)."""
    missed = [f"layer {n} norm {v:.4g} > {NORM_TOL}"
              for n, v in layer["norm_rel_err"].items() if not v <= NORM_TOL]
    missed += [f"layer {n} vs fp32 {d['kernel']:.4g} > {FP32_RATIO} x "
               f"{d['plain']:.4g}"
               for n, d in layer["norm_rel_err_vs_fp32"].items()
               if not d["kernel"] <= FP32_RATIO * d["plain"]]
    if not model["loss_rel_err"] <= LOSS_TOL:
        missed.append(f"loss {model['loss_rel_err']:.4g} > {LOSS_TOL}")
    d = model["logits_vs_fp32"]
    if not d["kernel"] <= FP32_RATIO * d["plain"]:
        missed.append(f"logits vs fp32 {d['kernel']:.4g} > {FP32_RATIO} x "
                      f"{d['plain']:.4g}")
    if not (layer["finite"] and model["finite"]):
        missed.append("non-finite values")
    return missed


def moe_trained_run(torch, np, dev, dropless, layers=2, warmup=3, steps=10):
    """Phases 14 (``dropless``) and 15 (capacity top-2, the JAX package's
    ``MixtralForCausalLM``): Mixtral-8x7B at full width and 2 layers
    through ``deepspeed_tpu_torch.initialize`` with the bench ds_config at
    micro-batch 4 (ZeRO-1, bf16, AdamW 1e-4, clip 1.0): 3 warm-up and 10
    timed steps of ``engine(ids, ids)`` / ``backward`` / ``step`` on one
    4 x 1024 batch from SEED, then one traced step."""
    import gc

    import deepspeed_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ids = moe_ids(torch, np, dev, 32000)
    t0 = time.perf_counter()
    model = mixtral_training_model(torch, dev, layers, dropless)
    cfg = model.config
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device=dev,
        config={**BENCH_DS_CONFIG, "train_micro_batch_size_per_gpu": 4})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = [train_step(engine, ids) for _ in range(warmup)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses += [train_step(engine, ids) for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = read_launches(ALL_KERNELS)
    losses = [float(x) for x in losses]
    trace = profile_window(torch, lambda: train_step(engine, ids), 1,
                           top=12)
    if trace is not None:
        trace["device_idle_share_untraced"] = \
            1.0 - trace["device_busy_ms_per_step"] / (step_s * 1e3)
    tokens = ids.numel()
    h, f, e, k = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_local_experts, cfg.num_experts_per_tok)
    expert_params = 3 * e * h * f * layers
    dense_params = sum(p.numel() for n, p in engine.module.named_parameters()
                       if "embed_tokens" not in n and "experts" not in n)
    hd = cfg.head_dim
    attn = 3.5 * 4.0 * ids.shape[0] * cfg.num_attention_heads * \
        visible_pairs(ids.shape[1], ids.shape[1], None) * hd * layers
    # useful FLOPs: the dense projections, k of E experts a token, causal
    # attention; never capacity padding
    flops = 6.0 * (dense_params + expert_params * k / e) * tokens + attn
    per_layer = {"flash_attention_fwd": layers,
                 "flash_attention_bwd_dq": layers,
                 "flash_attention_bwd_dkv": layers}
    gmm_per_step = 3 * layers if dropless else 0
    per_layer.update({key: gmm_per_step for key in MOE_GMM})
    out = {
        "model": "dropless" if dropless else "capacity top-2",
        "layers": layers, "batch": list(ids.shape),
        "params": sum(m.numel() for m in engine.master),
        "expert_params": expert_params, "dense_matmul_params": dense_params,
        "engine_init_s": init_s,
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": flops / step_s / BF16_FLOPS, "useful_flops_per_step": flops,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "launches": launches,
        "expected_launches": {key: v * steps for key, v in per_layer.items()},
        "finite": all(math.isfinite(x) for x in losses),
        "trace": trace,
    }
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# Phases 6-8: the training path
# --------------------------------------------------------------------- #
FLASH_CASES = (
    # name, B, Sq, Sk, H, Hkv, D, window
    ("bench B8 S1024 H12 D64", 8, 1024, 1024, 12, 12, 64, None),
    ("70B heads B2 S2048 H64/8 D128", 2, 2048, 2048, 64, 8, 128, None),
    ("window 256 B2 S2048 H8 D64", 2, 2048, 2048, 8, 8, 64, 256),
    ("rect Sq512 Sk1024 B2 H8 D64", 2, 512, 1024, 8, 8, 64, None),
    ("bench width B2 S4096 H12 D64", 2, 4096, 4096, 12, 12, 64, None),
)


# phase 16: the strided mode, through the folded entry's counters
STRIDED_CASES = (
    # name, B, Sq, Sk, H, Hkv, D, window, fused
    ("gpt2 B8 S1024 H12 D64 c_attn views", 8, 1024, 1024, 12, 12, 64, None,
     "qkv"),
    ("bench TPU geometry B16 S1024 H6 D128", 16, 1024, 1024, 6, 6, 128, None,
     "none"),
    ("70B heads B2 S2048 H64/8 D128 qkv_proj views", 2, 2048, 2048, 64, 8,
     128, None, "qkv"),
    ("window 256 B2 S2048 H8 D64 qkv views", 2, 2048, 2048, 8, 8, 64, 256,
     "qkv"),
    ("rect Sq512 Sk1024 B2 H8 D64 kv views", 2, 512, 1024, 8, 8, 64, None,
     "kv"),
)


def visible_pairs(sq, sk, window):
    """(row, column) pairs a causal end-aligned mask keeps."""
    off = sk - sq
    total = 0
    for r in range(sq):
        hi = min(sk - 1, r + off)
        lo = 0 if window is None else max(0, r + off - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash_case(torch, gen, dev, name, b, sq, sk, h, hkv, d, window,
               fused=None):
    """One phase-6 case (``fused`` None: q, k and v tensors of their own,
    the bshd entry's counters) or phase-16 case (the strided mode through
    the folded entry's counters; ``fused`` "qkv": q, k and v column views
    of one [B, S, (H + 2 Hkv) D] projection output, "kv": k and v views
    of one [B, Sk, 2 Hkv D], "none": tensors of their own): each kernel
    against its plain version, timed beside it, the SDPA yardstick and the
    bound.  A phase-16 case also runs the contiguous-mode kernels on
    ``.contiguous()`` copies of k and v, which must give the same bits,
    and times them with those copies."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    scale = d ** -0.5
    entry = "bshd" if fused is None else "folded"
    call_bytes = 2 * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
    sets = n_sets(call_bytes)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def views(buf, *widths):
        return [t.unflatten(-1, (-1, d))
                for t in buf.split([w * d for w in widths], dim=-1)]

    def fwd(qs, k, v):
        return fa.flash_attention_fwd(qs, k, v, True, window, entry)

    def bwd(qs, k, v, o, lse, do):
        return fa.flash_attention_bwd(qs, k, v, o, lse, do, scale, True,
                                      window, entry)

    ops = []
    for _ in range(sets):
        if fused == "qkv":
            q, k, v = views(rand(b, sq, (h + 2 * hkv) * d), h, hkv, hkv)
            do = rand(b, sq, h, d)
        elif fused == "kv":
            q = rand(b, sq, h, d)
            k, v = views(rand(b, sk, 2 * hkv * d), hkv, hkv)
            do = rand(b, sq, h, d)
        else:
            q, k, v, do = (rand(b, sq, h, d), rand(b, sk, hkv, d),
                           rand(b, sk, hkv, d), rand(b, sq, h, d))
        qs = (q.float() * scale).to(bf16)
        o, lse = fwd(qs, k, v)
        _, delta = fa.flash_attention_bwd_dq(qs, k, v, o, do, lse, scale,
                                             True, window, entry)
        ops.append(dict(q=q, k=k, v=v, do=do, qs=qs, o=o, lse=lse,
                        delta=delta))
    x = ops[0]
    got = {}
    launch = {}
    got["o"], got["lse"] = fwd(x["qs"], x["k"], x["v"])
    launch["fwd"] = fa.last_launch_info()
    got["dq"], got["delta"] = fa.flash_attention_bwd_dq(
        x["qs"], x["k"], x["v"], x["o"], x["do"], x["lse"], scale, True,
        window, entry)
    launch["bwd_dq"] = fa.last_launch_info()
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(
        x["qs"], x["k"], x["v"], x["do"], x["lse"], x["delta"], True, window,
        entry)
    launch["bwd_dkv"] = fa.last_launch_info()
    # two runs give the same bits (every sum in a fixed order)
    again = dict(zip(("o", "lse"), fwd(x["qs"], x["k"], x["v"])))
    again["dq"], again["delta"] = fa.flash_attention_bwd_dq(
        x["qs"], x["k"], x["v"], x["o"], x["do"], x["lse"], scale, True,
        window, entry)
    again["dk"], again["dv"] = fa.flash_attention_bwd_dkv(
        x["qs"], x["k"], x["v"], x["do"], x["lse"], x["delta"], True, window,
        entry)
    reproducible = all(torch.equal(got[key], again[key]) for key in got) \
        and torch.equal(got["o"], x["o"]) and torch.equal(got["delta"],
                                                          x["delta"])
    del again
    bit_equal = None
    if fused is not None:
        kc, vc = x["k"].contiguous(), x["v"].contiguous()
        co, clse = fwd(x["qs"], kc, vc)
        cdq, cdelta = fa.flash_attention_bwd_dq(x["qs"], kc, vc, co,
                                                x["do"], clse, scale, True,
                                                window, entry)
        cdk, cdv = fa.flash_attention_bwd_dkv(x["qs"], kc, vc, x["do"], clse,
                                              cdelta, True, window, entry)
        contiguous = dict(o=co, lse=clse, delta=cdelta, dq=cdq, dk=cdk,
                          dv=cdv)
        bit_equal = {key: torch.equal(got[key], contiguous[key])
                     for key in got}
    want = {}
    want["o"], want["lse"] = fa.flash_attention_plain_fwd(
        x["qs"], x["k"], x["v"], causal=True, window=window)
    want["dq"], want["delta"] = fa.flash_attention_plain_bwd_dq(
        x["qs"], x["k"], x["v"], want["o"], x["do"], want["lse"],
        scale=scale, causal=True, window=window)
    want["dk"], want["dv"] = fa.flash_attention_plain_bwd_dkv(
        x["qs"], x["k"], x["v"], x["do"], want["lse"], want["delta"],
        causal=True, window=window)
    torch.cuda.synchronize()
    rel, norm_rel, abs_err = {}, {}, {}
    for key in want:
        g, w = got[key].float(), want[key].float()
        diff = (g - w).abs().max().item()
        abs_err[key] = diff
        rel[key] = diff / max(w.abs().max().item(), 1e-30)
        norm_rel[key] = rel_norm(g, w)
        if not torch.isfinite(g).all():
            rel[key] = norm_rel[key] = float("inf")

    n_vis = b * h * visible_pairs(sq, sk, window)
    fwd_flops = 4.0 * n_vis * d
    q_bytes, kv_bytes, row_bytes = b * sq * h * d * 2, b * sk * hkv * d * 2, \
        b * h * sq * 4
    bounds = {
        # q, k, v read; o, lse written: S = qk^T, PV
        "fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, fwd_flops),
        # q, k, v, o, do, lse read; dq, delta written: S, dP, dQ
        "bwd_dq": bound(4 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                        1.5 * fwd_flops),
        # q, k, v, do, lse, delta read; dk, dv written: S, dP, dV, dK
        "bwd_dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                         2.0 * fwd_flops),
        # forward + backward by the usual count (backward 2.5x forward):
        # q, k, v, do read; o, lse, dq, dk, dv written
        "fwd+bwd": bound(4 * q_bytes + 4 * kv_bytes + row_bytes,
                         3.5 * fwd_flops),
    }
    iters = 20
    t = {
        "fwd": time_ms(lambda i: fwd(ops[i]["qs"], ops[i]["k"],
                                     ops[i]["v"]), sets, iters),
        "bwd_dq": time_ms(lambda i: fa.flash_attention_bwd_dq(
            ops[i]["qs"], ops[i]["k"], ops[i]["v"], ops[i]["o"],
            ops[i]["do"], ops[i]["lse"], scale, True, window, entry),
            sets, iters),
        "bwd_dkv": time_ms(lambda i: fa.flash_attention_bwd_dkv(
            ops[i]["qs"], ops[i]["k"], ops[i]["v"], ops[i]["do"],
            ops[i]["lse"], ops[i]["delta"], True, window, entry),
            sets, iters),
    }

    def kernel_fwd_bwd(i, copy=False):
        y = ops[i]
        k, v = ((y["k"].contiguous(), y["v"].contiguous()) if copy
                else (y["k"], y["v"]))
        o, lse = fwd(y["qs"], k, v)
        bwd(y["qs"], k, v, o, lse, y["do"])

    t["fwd+bwd"] = time_ms(kernel_fwd_bwd, sets, iters)
    if fused is not None:
        # what reading in place saves: the contiguous mode needs copies
        # of the k and v views first
        t["fwd+bwd contiguous + copies"] = time_ms(
            lambda i: kernel_fwd_bwd(i, copy=True), sets, iters)
    plain = {
        "fwd": time_ms(lambda i: fa.flash_attention_plain_fwd(
            ops[i]["qs"], ops[i]["k"], ops[i]["v"], causal=True,
            window=window), 1, 3),
        "bwd_dq": time_ms(lambda i: fa.flash_attention_plain_bwd_dq(
            ops[i]["qs"], ops[i]["k"], ops[i]["v"], ops[i]["o"],
            ops[i]["do"], ops[i]["lse"], scale=scale, causal=True,
            window=window), 1, 3),
        "bwd_dkv": time_ms(lambda i: fa.flash_attention_plain_bwd_dkv(
            ops[i]["qs"], ops[i]["k"], ops[i]["v"], ops[i]["do"],
            ops[i]["lse"], ops[i]["delta"], causal=True, window=window),
            1, 3),
    }
    plain["fwd+bwd"] = plain["fwd"] + plain["bwd_dq"] + plain["bwd_dkv"]

    # yardstick: SDPA on the same inputs in its [B, H, S, D] layout (the
    # transposes are outside the timed calls); an explicit end-aligned
    # mask where SDPA's is_causal (top-left aligned) does not fit
    masked = window is not None or sq != sk
    mask = None
    if masked:
        r = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        c = torch.arange(sk, device=dev)[None, :]
        mask = r >= c
        if window is not None:
            mask &= c > r - window
    lib = [tuple(ops[i][n].transpose(1, 2).contiguous().requires_grad_()
                 for n in ("q", "k", "v")) + (
                     ops[i]["do"].transpose(1, 2).contiguous(),)
           for i in range(sets)]

    def sdpa(i):
        qq, kk, vv, _ = lib[i]
        return F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, is_causal=not masked,
            enable_gqa=h != hkv)

    def sdpa_fwd_bwd(i):
        torch.autograd.grad(sdpa(i), lib[i][:3], lib[i][3])

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, sets, iters)
    lib_fwd_bwd = time_ms(sdpa_fwd_bwd, sets, iters)
    # the backward alone: one autograd call over SDPA's saved forward
    # computes dQ, dK and dV together (the yardstick of dQ + dK/dV)
    saved = [sdpa(i) for i in range(sets)]
    lib_bwd = time_ms(lambda i: torch.autograd.grad(
        saved[i], lib[i][:3], lib[i][3], retain_graph=True), sets, iters)
    del saved
    return {
        "name": name, "shape": [b, sq, sk, h, hkv, d, window],
        "fused": fused, "strides": {n: x[n].stride(1) for n in "qkv"},
        "bit_equal_to_contiguous": bit_equal,
        "reproducible": reproducible, "launch": launch,
        "rel_err": rel, "norm_rel_err": norm_rel, "abs_err": abs_err,
        "ms": t, "plain_ms": plain,
        "library_ms": {"fwd": lib_fwd, "fwd+bwd": lib_fwd_bwd,
                       "bwd": lib_bwd},
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
    }


def print_launches(case):
    """Each flash launch of a phase-6 / phase-16 case: its grid, tiles,
    registers, spills and the host us spent encoding its tensor maps."""
    for kname, li in case["launch"].items():
        print(f"    [launch] {kname}: grid {li['blocks']} x {li['threads']} "
              f"threads, tile {li['block_rows']} x {li['step_rows']} "
              f"({li['stages']} stages, {li['smem_bytes']} B shared), "
              f"registers {li['registers']}, spill {li['local_bytes']} B, "
              f"tensor maps {li['encode_us']:.1f} us", flush=True)


BENCH_DS_CONFIG = {
    # bench.py:88-100, the JAX package's headline training config
    "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "zero_optimization": {"stage": 1},
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "attention_layout": "bshd",
}


def bench_llama(torch, layers, dtype=None):
    """The bench model (bench.py:84-87): vocab 32000, hidden 768,
    intermediate 2048, 12 heads, 12 KV heads, max positions 2048, bf16."""
    from deepspeed_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=768,
                       intermediate_size=2048, num_hidden_layers=layers,
                       num_attention_heads=12, num_key_value_heads=12,
                       max_position_embeddings=2048,
                       dtype=dtype or torch.bfloat16)


def bench_ids(torch, np, dev, vocab, batch=8):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, vocab, size=(batch, 1024))
                            .astype(np.int32)).to(dev)


def gpt2_model(torch, dev, layout, use_kernels=True, dtype=None):
    """GPT-2-125M at full width and depth (vocab 50257, hidden 768, 12
    layers of 12 heads, d = 64, 1024 positions), fp32 weights drawn on the
    card from SEED."""
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.gpt2_125m(dtype=dtype or torch.bfloat16,
                               attention_layout=layout)
    return GPT2LMHeadModel(cfg, seed=SEED, device=dev,
                           use_kernels=use_kernels)


def engine_for(model, config, dev):
    """The engine ``deepspeed_tpu_torch.initialize`` builds for ``model``."""
    import deepspeed_tpu_torch

    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config=config,
                                                     device=dev)
    return engine


def train_engine(torch, cfg, dev, use_kernels=True, config=None):
    from deepspeed_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, seed=SEED, device=dev,
                             use_kernels=use_kernels)
    return engine_for(model, config or BENCH_DS_CONFIG, dev)


def train_step(engine, ids, grads=None):
    """One engine step; with ``grads`` (a dict), first the accumulated
    fp32 gradients of the attention projections (Llama's q, k, v; GPT-2's
    fused c_attn), by name."""
    loss = engine(ids, ids)
    engine.backward(loss)
    if grads is not None:
        names = [n for n, p in engine.module.named_parameters()
                 if p.requires_grad]
        grads.update({n: g.clone() for n, g in zip(names, engine.acc_grads)
                      if n.split(".")[-2] in ("q_proj", "k_proj", "v_proj",
                                              "c_attn")})
    engine.step()
    return loss.detach()


def training_kernel_vs_plain(torch, np, dev, steps=3):
    """Phase 7: 2 layers of the bench model, the same init and ids, 3
    engine steps through the kernels and 3 through the plain versions:
    the logits before the first step, each loss, and the first step's
    gradients of the attention projections (which reach the weights only
    through attention's backward).  The same model in fp32 (plain
    attention, one step) is the yardstick both bf16 paths are set
    against."""
    cfg = bench_llama(torch, 2)
    ids = bench_ids(torch, np, dev, cfg.vocab_size)
    res = {}
    for mode in ("kernel", "plain", "fp32"):
        if mode == "fp32":
            engine = train_engine(
                torch, bench_llama(torch, 2, torch.float32), dev, False,
                {**BENCH_DS_CONFIG, "bf16": {"enabled": False}})
        else:
            engine = train_engine(torch, cfg, dev, mode == "kernel")
        with torch.no_grad():
            logits = engine.module(ids)
        reset_launches()
        grads = {}
        losses = [train_step(engine, ids, grads if i == 0 else None)
                  for i in range(1 if mode == "fp32" else steps)]
        torch.cuda.synchronize()
        res[mode] = ([float(x) for x in losses], logits, grads,
                     read_launches(TRAINING))
        del engine
        torch.cuda.empty_cache()
    k_loss, k_logits, k_grads, k_launch = res.pop("kernel")
    p_loss, p_logits, p_grads, p_launch = res.pop("plain")
    _, f_logits, f_grads, _ = res.pop("fp32")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    grad_rel = {n: rel_norm(k_grads[n], p_grads[n]) for n in p_grads}
    return {"layers": 2, "kernel_losses": k_loss, "plain_losses": p_loss,
            "loss_rel_err": rel,
            "logits_norm_rel_err": rel_norm(k_logits, p_logits),
            "attn_grad_norm_rel_err": grad_rel,
            # each bf16 path against fp32: the kernels' path must be no
            # farther from it than the plain path
            "logits_vs_fp32": {"kernel": rel_norm(k_logits, f_logits),
                               "plain": rel_norm(p_logits, f_logits)},
            "attn_grad_vs_fp32": {
                "kernel": max(rel_norm(k_grads[n], f_grads[n])
                              for n in f_grads),
                "plain": max(rel_norm(p_grads[n], f_grads[n])
                             for n in f_grads)},
            "kernel_launches": k_launch, "plain_launches": p_launch}


def gpt2_kernel_vs_plain(torch, np, dev, steps=3):
    """Phase 17: GPT-2-125M at full width and 12 layers, batch 8 x 1024,
    the bench ds_config with ``attention_layout`` "paired": the same init
    and ids, 3 engine steps through the kernels and 3 through the plain
    versions; the same model in fp32 (plain attention, one step) as the
    yardstick; and 3 steps under "folded" and "bshd" through the kernels,
    whose logits and gradients are expected to equal the paired path's
    bit for bit (one kernel family, reading the same c_attn views)."""
    import gc

    ids = bench_ids(torch, np, dev, 50257)
    res = {}
    for mode in ("paired", "plain", "fp32", "folded", "bshd"):
        layout = mode if mode in ("folded", "bshd") else "paired"
        config = {**BENCH_DS_CONFIG, "attention_layout": layout}
        if mode == "fp32":
            config["bf16"] = {"enabled": False}
        model = gpt2_model(torch, dev, layout,
                           use_kernels=mode not in ("plain", "fp32"),
                           dtype=torch.float32 if mode == "fp32" else None)
        engine = engine_for(model, config, dev)
        with torch.no_grad():
            logits = engine.module(ids)
        reset_launches()
        grads = {}
        losses = [train_step(engine, ids, grads if i == 0 else None)
                  for i in range(1 if mode == "fp32" else steps)]
        torch.cuda.synchronize()
        res[mode] = ([float(x) for x in losses], logits, grads,
                     read_launches(ALL_FLASH))
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    k_loss, k_logits, k_grads, k_launch = res["paired"]
    p_loss, p_logits, p_grads, p_launch = res["plain"]
    _, f_logits, f_grads, _ = res["fp32"]
    layouts = {}
    for lay in ("folded", "bshd"):
        loss, logits, grads, launch = res[lay]
        layouts[lay] = {
            "losses_equal": loss == k_loss,
            "logits_equal": torch.equal(logits, k_logits),
            "grads_equal": all(torch.equal(grads[n], k_grads[n])
                               for n in k_grads),
            "logits_max_abs_diff": (logits.float() - k_logits.float())
            .abs().max().item(),
            "grads_max_abs_diff": max((grads[n] - k_grads[n]).abs().max()
                                      .item() for n in k_grads),
            "launches": launch}
    return {"layers": 12, "batch": list(ids.shape),
            "kernel_losses": k_loss, "plain_losses": p_loss,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(k_loss, p_loss)),
            "logits_norm_rel_err": rel_norm(k_logits, p_logits),
            "c_attn_grad_norm_rel_err": {n: rel_norm(k_grads[n], p_grads[n])
                                         for n in p_grads},
            "logits_vs_fp32": {"kernel": rel_norm(k_logits, f_logits),
                               "plain": rel_norm(p_logits, f_logits)},
            "c_attn_grad_vs_fp32": {
                "kernel": max(rel_norm(k_grads[n], f_grads[n])
                              for n in f_grads),
                "plain": max(rel_norm(p_grads[n], f_grads[n])
                             for n in f_grads)},
            "layouts_vs_paired": layouts,
            "kernel_launches": k_launch, "plain_launches": p_launch,
            "finite": all(math.isfinite(x) for x in k_loss)}


#: phase 18: (model, attention_layout, heads, micro-batch)
LAYOUT_RUNS = (("gpt2", "bshd", 12, 8), ("gpt2", "folded", 12, 8),
               ("gpt2", "paired", 12, 8), ("llama", "folded", 12, 8),
               ("llama", "paired", 12, 8), ("llama", "folded", 6, 16))


def trained_run(torch, np, dev, warmup=3, steps=20, kind="llama",
                layout="bshd", heads=12, batch=8, traced=True):
    """Phase 8 (the 12-layer bench model, bshd) and phase 18 (GPT-2-125M
    or the bench model under ``layout``, at ``heads`` heads of the 768
    width and micro-batch ``batch``) through initialize -> engine: 3
    warm-up and 20 timed steps on one batch from SEED, then, when
    ``traced``, two traced steps.  ``expected_launches``: 12 a step of
    each flash kernel, under the entry the layout implies (paired falls
    back to folded where pairing does not apply, d = 128)."""
    import gc

    from deepspeed_tpu_torch.ops.flash_attention import (
        paired_heads_per_block)

    # an engine is its own optimizer (a reference cycle): collect the last
    # run's before the peak is reset, or it counts in this run's peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    config = {**BENCH_DS_CONFIG, "attention_layout": layout,
              "train_micro_batch_size_per_gpu": batch}
    if kind == "gpt2":
        model = gpt2_model(torch, dev, None)
    else:
        from deepspeed_tpu_torch.models import LlamaForCausalLM

        model = LlamaForCausalLM(dataclasses.replace(
            bench_llama(torch, 12), num_attention_heads=heads,
            num_key_value_heads=heads), seed=SEED, device=dev)
    cfg = model.config
    ids = bench_ids(torch, np, dev, cfg.vocab_size, batch)
    engine = engine_for(model, config, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = [train_step(engine, ids) for _ in range(warmup)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses += [train_step(engine, ids) for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = read_launches(ALL_FLASH)
    losses = [float(x) for x in losses]
    trace = None
    if traced:
        trace = profile_window(torch, lambda: [train_step(engine, ids)
                                               for _ in range(2)], 2, top=12)
    if trace is not None:
        # the tracer inflates the wall: the idle share of an untraced step
        # sets the traced device time against the untraced step time
        trace["device_idle_share_untraced"] = \
            1.0 - trace["device_busy_ms_per_step"] / (step_s * 1e3)
    tokens = ids.numel()
    # matmul parameters: lookups only (Llama's embed_tokens, GPT-2's wpe)
    # do not count; GPT-2's tied wte counts once, as the unembedding
    n_matmul = sum(p.numel() for n, p in engine.module.named_parameters()
                   if "embed_tokens" not in n and "wpe" not in n)
    hd = cfg.hidden_size // cfg.num_attention_heads
    entry = layout
    if layout == "paired" and paired_heads_per_block(
            cfg.num_attention_heads, cfg.num_attention_heads, hd) is None:
        entry = "folded"
    # causal attention: 4 B H S^2 D / 2 forward, 2.5x that backward
    attn = 3.5 * 4.0 * ids.shape[0] * cfg.num_attention_heads * \
        visible_pairs(ids.shape[1], ids.shape[1], None) * hd * \
        cfg.num_hidden_layers
    flops = 6.0 * n_matmul * tokens + attn
    out = {
        "model": kind, "attention_layout": layout, "heads": heads,
        "head_dim": hd, "entry": entry,
        "layers": cfg.num_hidden_layers, "batch": list(ids.shape),
        "params": sum(m.numel() for m in engine.master),
        "matmul_params": n_matmul, "engine_init_s": init_s,
        "ms_per_step": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": flops / step_s / BF16_FLOPS, "flops_per_step": flops,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "launches": launches,
        "expected_launches": {
            k: (12 * steps if k in FLASH_BY_ENTRY[entry] else 0)
            for k in ALL_FLASH},
        "launches_per_step": {k: v / steps for k, v in launches.items()
                              if k in FLASH_BY_ENTRY[entry]},
        "finite": all(math.isfinite(x) for x in losses),
        "trace": trace,
    }
    del engine, model
    torch.cuda.empty_cache()
    return out


def profile_window(torch, fn, steps, top=6):
    """Device busy time (sum of kernel durations on the one stream) against
    host wall time over ``fn``, per step, with the ``top`` kernels that take
    the most device time; None where the tracer records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy_us = sum(by_name.values())
    if busy_us == 0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    by_kind, gmm, qmm = {}, {}, {}
    for kname, us in by_name.items():
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in kname.lower() for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / steps / 1e3
        if kind == "grouped_gemm":
            label = gmm_kernel_label(kname)
            gmm[label] = gmm.get(label, 0.0) + us / steps / 1e3
        label = re.search(r"qmm_\w+", kname)   # the int8 matmul's kernels
        if label:
            qmm[label.group(0)] = (qmm.get(label.group(0), 0.0)
                                   + us / steps / 1e3)
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kind_ms_per_step": by_kind,
            "top_kernels_ms_per_step": {k[:70]: v / steps / 1e3
                                        for k, v in top},
            "grouped_gemm_ms_per_step": gmm,
            "quantized_matmul_ms_per_step": qmm}


def gmm_kernel_label(kname: str) -> str:
    """Which grouped-GEMM kernel a traced kernel name is: its
    ``launch_info()`` name (``gmm_wgmma_kernel<kFwd>`` the forward,
    ``<kDlhs>`` / ``<kDrhs>`` the gradients); else the name itself."""
    from deepspeed_tpu_torch.ops import grouped_gemm

    return grouped_gemm.traced_kernel(kname) or kname[:90]


# device kernels by kind, first match wins: the port's own kernels, the
# library GEMMs, then PyTorch's elementwise / reduction / copy kernels
KERNEL_KINDS = (
    ("grouped_gemm", ("gmm_wgmma_kernel",)),
    ("flash_attention", ("flash_fwd", "flash_bwd")),
    ("port_serving", ("qmm", "paged_")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "foreach", "multi_tensor")),
    ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
    ("copy/index", ("copy", "index", "gather", "scatter", "embedding",
                    "cat")),
)


# --------------------------------------------------------------------- #
# Phases 19-21: int8 weight quantization at load time (B10)
# --------------------------------------------------------------------- #
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12          # H100 SXM dense TF32 on the tensor cores
#: the Llama-2-7B matrices (q/k/v/o, gate/up, down, lm_head) as [K, N]
QUANT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
#: phase 20: the int8 engine's logits against the bf16 engine's, in norm.
#: 64 row-block groups of a 4096-row matrix hold 262,144 weights each, whose
#: absmax is ~4.9 sigma: the int8 step is ~0.039 sigma and its rounding
#: noise (step / sqrt(12)) ~0.011 sigma; through the 14 projections of 2
#: layers and the unembedding the logits part by 4.8% in norm (this phase's
#: reading on an H100), so the bar sits ~2x above that
INT8_LOGITS_NORM_TOL = 1e-1


def quantizer_bound(n: int, groups: int, elt: int):
    """The least time for one quantize of n values of ``elt`` bytes: x read
    once, q and the scales written once, or ~4 fp32 operations a value
    (abs, max, divide, round) at the fp32 rate, whichever is larger."""
    t_bytes = (n * elt + n + groups * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * n / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launches_a_call(torch, fn):
    """Kernel launches and memsets on the device in one call of ``fn``
    (after a warm call), from ``torch.profiler``'s device activity; None
    where the tracer records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return None
    memsets = sum("memset" in n.lower() for n in names)
    copies = sum("memcpy" in n.lower() for n in names)
    return {"kernels": len(names) - memsets - copies, "memsets": memsets,
            "names": sorted({n[:60] for n in names})}


#: phase 19's (shape, groups, type) as traced for kernels and memsets a
#: call (the zero-group case shares the first shape's launch)
QUANT_TRACED = tuple(((k, n), g, "bfloat16") for k, n in QUANT_SHAPES
                     for g in (64, 16)) + (
    ((4096, 4096), 4096 * 4096 // 128, "bfloat16"),
    ((4096, 4096), 64, "float32"))


def trace_quantizer() -> int:
    """``chip_smoke.py --trace-quantizer``: phase 19's kernels and memsets
    a call (``launches_a_call``) for each of QUANT_TRACED, as one JSON line
    keyed "shape groups type".  Phase 19 runs it in a fresh process: in
    the long one, after the earlier phases' traces, the tracer recorded no
    device activity for these calls."""
    sys.path.insert(0, str(ROOT))
    import torch

    from deepspeed_tpu_torch.ops import quantizer as tq

    dev = torch.device("cuda", 0)
    out = {}
    for shape, groups, dtype in QUANT_TRACED:
        x = torch.randn(shape, device=dev).to(getattr(torch, dtype))
        out[f"{shape} {groups} {dtype}"] = launches_a_call(
            torch, lambda: tq.quantize_kernel(x, groups))
        del x
    print(json.dumps(out))
    return 0


def quantizer_calls_traced() -> dict:
    """``trace_quantizer``'s result, from a fresh process."""
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--trace-quantizer"], capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"--trace-quantizer failed:\n{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def quantizer_case(torch, name, xs, groups):
    """One phase-19 case: the kernel and its plain version on ``xs[0]``
    (q and scales compared bit for bit, and over two runs), its launch
    plan, each timed over the operand sets ``xs``."""
    from deepspeed_tpu_torch.ops import quantizer as tq

    x = xs[0]
    got_q, got_s = tq.quantize_kernel(x, groups)
    again_q, again_s = tq.quantize_kernel(x, groups)
    want_q, want_s = tq.quantize_plain(x, groups)
    torch.cuda.synchronize()
    plan = tq.launch_plan(x, groups)
    err = max((got_q.int() - want_q.int()).abs().max().item(),
              (got_s - want_s).abs().max().item())
    b_ms, b_by = quantizer_bound(x.numel(), groups, x.element_size())
    big = x.numel() * x.element_size() > 100e6
    case = {
        "name": name, "kernel": "quantize", "groups": groups,
        "group_size": x.numel() // groups,
        "bit_equal": bool(torch.equal(got_q, want_q)
                          and torch.equal(got_s, want_s)),
        "two_runs_bit_equal": bool(torch.equal(got_q, again_q)
                                   and torch.equal(got_s, again_s)),
        "max_abs_err": err,
        "plan": {k: plan[k] for k in ("route", "piece", "gpp", "parts",
                                      "nbuf", "smem", "grid")},
        "ms": time_ms(lambda i: tq.quantize_kernel(xs[i], groups), len(xs),
                      8 if big else 24),
        "plain_ms": time_ms(lambda i: tq.quantize_plain(xs[i], groups),
                            len(xs), len(xs)),
        "bound_ms": b_ms, "bound_by": b_by,
        # no one PyTorch call computes a groupwise int8 quantize
        "library_ms": None,
    }
    if name.startswith("zero group"):
        case["zero_group"] = bool(got_s[0].item() == 1.0
                                  and not got_q[0].any().item())
    return case


def quantizer_cases(torch, gen, dev):
    """Phase 19: the Llama-2-7B matrices in bf16 at 64 and 16 groups, 128
    values a group, an all-zero group, and exact .5 ties everywhere."""
    def sets_of(make, nbytes):
        return [make() for _ in range(n_sets(nbytes))]

    out = []
    for k, n in QUANT_SHAPES:
        xs = sets_of(lambda: torch.randn((k, n), generator=gen, device=dev,
                                         dtype=torch.bfloat16) * 0.02,
                     k * n * 3)
        for groups in (64, 16):
            out.append(quantizer_case(torch, f"[{k},{n}] bf16 G={groups}",
                                      xs, groups))
        del xs
    k = n = 4096
    xs = sets_of(lambda: torch.randn((k, n), generator=gen, device=dev,
                                     dtype=torch.bfloat16), k * n * 3)
    out.append(quantizer_case(torch, "[4096,4096] bf16 group 128", xs,
                              k * n // 128))
    for x in xs:
        x[:64] = 0                               # group 0 of 64
    out.append(quantizer_case(torch, "zero group [4096,4096] bf16 G=64", xs,
                              64))
    # (m + 0.5) / 8 with |m + 0.5| < 127 and one 127 / 8 a group: every value
    # but the absmax lies on a .5 tie of the grid (scale 1/8 exactly)
    ties = []
    for _ in range(len(xs)):
        t = (torch.randint(-126, 126, (k, n), generator=gen, device=dev)
             .float() + 0.5) / 8
        t.view(64, -1)[:, 0] = 127 / 8
        ties.append(t)
    out.append(quantizer_case(torch, "ties [4096,4096] fp32 G=64", ties, 64))
    return out


def _record_paths(tree, prefix=()):
    for key, node in tree.items():
        if isinstance(node, dict) and set(node) == {"q", "scale"}:
            yield prefix + (key,), node
        elif isinstance(node, dict):
            yield from _record_paths(node, prefix + (key,))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def hf_checkpoint(torch, dev, path, layers):
    """A HuggingFace Llama-2-7B checkpoint of ``layers`` layers in ``path``:
    ``config.json`` and one bf16 ``model.safetensors``, the tree
    ``random_llama_params`` draws on the card from SEED under HF's names,
    projections transposed to HF's ``[out, in]`` (the inverse of the
    loader's ``_llama_rules``).  Returns its bytes."""
    from deepspeed_tpu_torch.checkpoint import random_llama_params
    from deepspeed_tpu_torch.checkpoint.hf_loader import save_safetensors
    from deepspeed_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tree = random_llama_params(cfg, device=dev, generator=gen)
    m = tree["model"]
    tensors = {"model.embed_tokens.weight": m["embed_tokens"]["embedding"]}
    for i in range(layers):
        blk, p = m[f"layers_{i}"], f"model.layers.{i}."
        for part in ("self_attn", "mlp"):
            for proj, leaf in blk[part].items():
                tensors[f"{p}{part}.{proj}.weight"] = leaf["kernel"].t()
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{p}{norm}.weight"] = blk[norm]["scale"]
    tensors["model.norm.weight"] = m["norm"]["scale"]
    tensors["lm_head.weight"] = tree["lm_head"]["kernel"].t()
    tensors = {k: t.to(torch.bfloat16) for k, t in tensors.items()}
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    path.mkdir(parents=True, exist_ok=True)
    save_safetensors(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": V, "hidden_size": H,
        "intermediate_size": I, "num_hidden_layers": layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "torch_dtype": "bfloat16"}))
    return sum(t.numel() * 2 for t in tensors.values())


def serving_engine_config(max_ctx):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig

    return RaggedInferenceEngineConfig.from_dict({
        "state_manager": {"max_ragged_batch_size": 512,
                          "max_ragged_sequence_count": 8,
                          "max_context": max_ctx},
        "kv_cache": {"block_size": 128}})


def from_hf_run(torch, np, dev, prompts, gen_tokens=16, layers=2):
    """Phase 20: ``from_hf`` of a 2-layer Llama-2-7B checkpoint written by
    this script, with ``quantize_bits=8`` and without: every int8 record
    bit for bit the plain quantizer on the bf16 engine's tensor, then the 8
    prompts through ``put`` and ``gen_tokens`` greedy tokens on each engine,
    launches counted from 0 around each load and each served run."""
    import shutil

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.ops import quantizer as tq

    path = ROOT / "build" / "chip_smoke_hf"
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    nbytes = hf_checkpoint(torch, dev, path, layers)
    write_s = time.perf_counter() - t0
    max_ctx = 256 + gen_tokens + 8
    engines, out = {}, {"checkpoint_gb": nbytes / 1e9,
                        "write_s": write_s}
    try:
        for mode, bits in (("int8", 8), ("bf16", None)):
            reset_launches()
            t0 = time.perf_counter()
            eng = InferenceEngineV2.from_hf(
                str(path), serving_engine_config(max_ctx),
                quantize_bits=bits, device=dev)
            torch.cuda.synchronize()
            out[f"{mode}_load_s"] = time.perf_counter() - t0
            out[f"{mode}_load_quantize_launches"] = tq.LAUNCHES["quantize"]
            engines[mode] = eng
    finally:
        shutil.rmtree(path, ignore_errors=True)
    records = list(_record_paths(engines["int8"].params))
    bad = []
    for rpath, rec in records:
        w = _leaf(engines["bf16"].params, rpath)
        q, s = tq.quantize_plain(w, rec["scale"].numel())
        if not (torch.equal(rec["q"], q.reshape(w.shape))
                and torch.equal(rec["scale"], s)
                and rec["scale"].numel() == 64):
            bad.append("/".join(rpath))
    out.update(records=len(records), records_not_bit_equal=bad)
    uids = list(range(len(prompts)))
    logits, toks = {}, {}
    for mode, eng in engines.items():
        reset_launches()
        first = eng.put(uids, prompts)
        logits[mode] = torch.from_numpy(np.stack([first[u] for u in uids]))
        start = [int(first[u].argmax()) for u in uids]
        toks[mode] = eng.decode_loop(uids, start, gen_tokens)
        eng.flush(uids)
        torch.cuda.synchronize()
        out[f"{mode}_serve_launches"] = read_launches(
            ("quantized_matmul", "paged_attention", "paged_decode_attention",
             "quantize"))
    forwards = len(prompts) // 2 + gen_tokens    # two prompts a put forward
    out["expected_int8_serve_quantized_matmul"] = \
        (7 * layers + 1) * forwards
    out["logits_norm_rel_err"] = rel_norm(logits["int8"], logits["bf16"])
    scale = logits["bf16"].abs().max().item()
    out["logits_max_rel_err"] = (logits["int8"] - logits["bf16"]).abs() \
        .max().item() / scale
    out["first_token_agreement"] = float(
        (logits["int8"].argmax(-1) == logits["bf16"].argmax(-1))
        .float().mean())
    out["decode_token_agreement"] = float((toks["int8"] == toks["bf16"])
                                          .mean())
    out["finite"] = all(bool(torch.isfinite(v).all())
                        for v in logits.values())
    out["tokens_in_vocab"] = all(bool(((t >= 0) & (t < 32000)).all())
                                 for t in toks.values())
    return out


def host_launch_us(torch, n=2000):
    """Host time of one small launch (an in-place add on one value), the
    mean over ``n``: a probe of what each launch costs on the host, which
    a host-bound decode step pays some 700 times."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def quantized_served_run(torch, np, dev, prompts, gen_tokens=16):
    """Phase 21: Llama-2-7B's 32 layers drawn in bf16 on the card and
    quantized by ``model_quantize`` (64 groups, embeddings excluded; counts
    set to 0 just before, read just after), then phase 5's workload on a
    shorter decode (counts set to 0 just before the timed puts).  Then,
    to tell the tree from the process's state: the same quantization of a
    second draw under the tracer and the same sequences decoding on after
    it, and phase 5's tree (random int8 records) served by the same code in
    the same process."""
    from deepspeed_tpu_torch.checkpoint import (random_int8_llama_params,
                                                random_llama_params)
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.ops import quantizer as tq
    from deepspeed_tpu_torch.runtime.weight_quantizer import (
        WeightQuantization)

    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = random_llama_params(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    wq = WeightQuantization(quantize_bits=8, quantize_groups=64)
    start_ev = torch.cuda.Event(enable_timing=True)
    stop_ev = torch.cuda.Event(enable_timing=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_ev.record()
    qparams, count = wq.model_quantize(params, exclude=("embed",))
    stop_ev.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    quantize_launches = tq.LAUNCHES["quantize"]
    bound_ms = sum(quantizer_bound(r["q"].numel(), r["scale"].numel(), 2)[0]
                   for _, r in _record_paths(qparams))
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    max_ctx = 256 + 3 * gen_tokens + 8
    eng = make_engine(torch, cfg, qparams, max_ctx, True)
    eng.put([100, 101], prompts[:2])               # warm, as phase 5
    eng.decode_loop([100, 101], [1, 1], 2)
    eng.flush([100, 101])
    torch.cuda.synchronize()
    uids = list(range(len(prompts)))
    probe = {"before_serving": host_launch_us(torch)}
    reset_launches()
    ttft_ms, first, _, toks, decode_s = timed_serving(
        torch, eng, uids, prompts, gen_tokens)
    # the same sequences decode on: a second decode_loop of as many tokens
    t1 = time.perf_counter()
    more = eng.decode_loop(uids, toks[:, -1].tolist(), gen_tokens)
    again_s = time.perf_counter() - t1
    launches = read_launches(BF16_PUT_DECODE + ("quantize",))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # where the load's time goes: the same quantization of a second draw,
    # traced; then the same sequences decode on once more
    params = random_llama_params(cfg, device=dev, generator=gen)
    trace = {"quantize_again": profile_window(
        torch, lambda: wq.model_quantize(params, exclude=("embed",)), 1)}
    del params
    torch.cuda.empty_cache()
    probe["after_quantize_trace"] = host_launch_us(torch)
    t1 = time.perf_counter()
    eng.decode_loop(uids, more[:, -1].tolist(), gen_tokens)
    after_trace_s = time.perf_counter() - t1
    eng.flush(uids)
    torch.cuda.synchronize()
    eng.put([200, 201], prompts[:2])
    trace["decode"] = profile_window(
        torch, lambda: eng.decode_loop([200, 201], [1, 1], 4), 4)
    eng.flush([200, 201])
    del eng, qparams
    torch.cuda.empty_cache()
    # phase 5's tree (16 groups of random int8) through the same code, here
    eng = make_engine(torch, cfg, random_int8_llama_params(cfg, groups=16,
                                                           seed=SEED),
                      max_ctx, True)
    eng.put([100, 101], prompts[:2])
    eng.decode_loop([100, 101], [1, 1], 2)
    eng.flush([100, 101])
    torch.cuda.synchronize()
    probe["before_phase5_tree"] = host_launch_us(torch)
    p5_ttft, _, _, _, p5_decode_s = timed_serving(torch, eng, uids, prompts,
                                                  gen_tokens)
    eng.flush(uids)
    del eng
    torch.cuda.empty_cache()
    forwards = len(prompts) // 2 + 2 * gen_tokens
    return {
        "layers": cfg.num_hidden_layers, "param_draw_s": draw_s,
        "matrices_quantized": count, "quantize_launches": quantize_launches,
        "quantize_device_ms": start_ev.elapsed_time(stop_ev),
        "quantize_wall_ms": wall_ms, "quantize_bound_ms": bound_ms,
        "ttft_ms": [ttft_ms[u] for u in uids],
        "decode_ms_per_step": decode_s / gen_tokens * 1e3,
        "decode_again_ms_per_step": again_s / gen_tokens * 1e3,
        "decode_after_quantize_trace_ms_per_step":
            after_trace_s / gen_tokens * 1e3,
        "phase5_tree_ttft_ms": [p5_ttft[u] for u in uids],
        "phase5_tree_decode_ms_per_step": p5_decode_s / gen_tokens * 1e3,
        "host_launch_us": probe,
        "decode_tokens_per_s": len(uids) * gen_tokens / decode_s,
        "gen_tokens": gen_tokens,
        "peak_memory_gb": peak_gb,
        "launches": launches,
        "expected_quantized_matmul": (7 * cfg.num_hidden_layers + 1)
        * forwards,
        "finite": all(bool(torch.isfinite(torch.from_numpy(first[u])).all())
                      for u in uids),
        "tokens_shape": list(toks.shape) if more.shape == toks.shape
        else [],
        "tokens_in_vocab": bool(((toks >= 0) & (toks < 32000)).all()
                                and ((more >= 0) & (more < 32000)).all()),
        "trace": trace,
    }


# --------------------------------------------------------------------- #
# Phase 22: Evoformer attention (B12)
# --------------------------------------------------------------------- #
#: (name, lead dims, S, heads, d, biases, type, old ms): Q/K/V [*lead, S,
#: H, d] and the biases of ``evo_operands``.  Every bf16 / fp16 case with d
#: a multiple of 8 takes the tensor-core kernel (mixed bias types, three
#: and eight biases included); fp32 and bf16 at d = 12 the general one.
#: "old ms" is the case's time before its kernel's redesign (PERF.md row
#: 22, on an NVIDIA H100 80GB HBM3 at 700 W: the tensor-core kernel's
#: before it ran on wgmma, the general kernel's before it ran on the tensor
#: cores, the last two cases' from ``tools/evo_variants.py --parent``; None
#: for the cases added after a redesign), printed beside this run's time;
#: ``deepspeed_tpu_torch/tools/evo_variants.py --parent`` times the
#: parent's kernels in the same run
EVO_CASES = (
    ("triangle crop 256 (1,256,256,4,32)", (1, 256), 256, 4, 32, "both",
     "bf16", 0.3143),
    ("DS4Sci test (1,512,256,8,8)", (1, 512), 256, 8, 8, "both", "bf16",
     0.9001),
    ("MSA row (1,128,256,8,32)", (1, 128), 256, 8, 32, "both", "bf16",
     0.3223),
    ("ragged S=250 (1,64,250,4,32)", (1, 64), 250, 4, 32, "both", "bf16",
     0.0951),
    ("no biases (1,256,256,4,32)", (1, 256), 256, 4, 32, "none", "bf16",
     0.2535),
    ("masked rows (1,256,256,4,32)", (1, 256), 256, 4, 32, "masked",
     "bf16", None),
    ("fp32 triangle crop 256 (1,256,256,4,32)", (1, 256), 256, 4, 32,
     "both", "fp32", 1.2433),
    ("three biases MSA row (1,128,256,8,32)", (1, 128), 256, 8, 32, "three",
     "bf16", 1.3379),
    ("triangle crop 384 (1,384,384,4,32)", (1, 384), 384, 4, 32, "both",
     "bf16", None),
    ("eight biases MSA row (1,128,256,8,32)", (1, 128), 256, 8, 32, "eight",
     "bf16", None),
    ("fp32 mask, bf16 pair (1,256,256,4,32)", (1, 256), 256, 4, 32,
     "fp32_mask", "bf16", None),
    ("fp16 triangle crop 256 (1,256,256,4,32)", (1, 256), 256, 4, 32, "both",
     "fp16", None),
    ("D=64 (1,128,256,8,64)", (1, 128), 256, 8, 64, "both", "bf16", None),
    ("D=128 (1,64,256,4,128)", (1, 64), 256, 4, 128, "both", "bf16", None),
    ("fp32 MSA row (1,128,256,8,32)", (1, 128), 256, 8, 32, "both", "fp32",
     1.2467),
    ("bf16 D=12 general (1,128,256,4,12)", (1, 128), 256, 4, 12, "both",
     "bf16", 0.5182),
)
EVO_GRAD_NORM_TOL = 5e-2
#: the general kernel in fp32 against the dense version in fp32
EVO_FP32_TOL = 1e-4
EVO_KEYS = {"mma": "evoformer_attention", "simt": "evoformer_attention_simt"}
EVO_TYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
#: the faults planted in copies of csrc/evoformer_attn.cu, each with the
#: triangle case's type it runs at (each must miss that type's bar: bf16
#: the norm bar, fp32 EVO_FP32_TOL): the last key step dropped (its scores
#: -inf), the bias tiles staged by TMA only at the first step (every later
#: step reads a ring stage no load wrote), and the general kernel's split
#: products without their hi.lo and lo.hi terms (one TF32 product)
EVO_PLANTED = {
    "dropped last key tile": ("const int valid = a.sk - c0;",
                              "const int valid = c0 + BK >= a.sk ? 0 : a.sk - c0;",
                              "bf16"),
    "bias tile never staged": ("const bool stage_bias = true;",
                               "const bool stage_bias = i == 0;", "bf16"),
    "split cross terms dropped": ("  if constexpr (SPLIT) {   // the split's cross terms",
                                  "  if constexpr (false) {", "fp32"),
}


def evo_operands(torch, gen, dev, lead, s, h, d, biases, dtype):
    """Q/K/V [*lead, S, H, d] of ``dtype`` ("bf16", "fp16", "fp32") and the
    biases: "both" the mask bias [B, N, 1, 1, S] (-1e9 on masked keys) and
    the pair bias [B, 1, H, S, S] in Q's type; "masked" the same with every
    key of 16 rows masked; "fp32_mask" the mask in fp32 (autocast's mixed
    types); "three" both and a per-row bias [B, N, H, S, 1]; "eight" those
    three and a scalar (fp32), a per-head value [H, 1, 1], a per-head key
    bias [B, 1, H, 1, S] (fp16), a tile full in N [B, N, 1, S, S] and a pair
    bias in fp32."""
    dt = getattr(torch, EVO_TYPES[dtype])
    b, n = lead

    def rand(shape, t=dt):
        return torch.randn(shape, generator=gen, device=dev, dtype=t)

    q, k, v = (rand(lead + (s, h, d)) for _ in range(3))
    if biases == "none":
        return q, k, v, []
    keep = torch.randint(0, 2, (b, n, s), generator=gen, device=dev)
    if biases == "masked":
        keep[:, :16] = 0                         # every key of 16 rows
    mask = (1e9 * (keep - 1)).to(torch.float32 if biases == "fp32_mask"
                                 else dt)[:, :, None, None, :]
    bs = [mask, rand((b, 1, h, s, s))]
    if biases in ("three", "eight"):
        bs.append(rand((b, n, h, s, 1)))
    if biases == "eight":
        bs += [rand((1,), torch.float32), rand((h, 1, 1)),
               rand((b, 1, h, 1, s), torch.float16),
               rand((b, n, 1, s, s)), rand((b, 1, h, s, s), torch.float32)]
    return q, k, v, bs


def evo_sets(torch, lead, s, h, d, dtype) -> int:
    """Operand sets for a phase-22 case's timing (each call cold in L2)."""
    elt = torch.tensor([], dtype=getattr(torch, EVO_TYPES[dtype])).element_size()
    return n_sets(4 * math.prod(lead) * s * h * d * elt + h * s * s * elt)


def evoformer_case(torch, gen, dev, name, lead, s, h, d, biases, dtype,
                   old_ms):
    """One phase-22 case: the forward through ``DS4Sci_EvoformerAttention``
    (one launch of the kernel ``kernel_route`` names, none of the other)
    against the plain version, two runs of the kernel bit-equal, the
    gradients of the autograd Function against dense autograd, times beside
    the plain version, SDPA over the summed biases (a yardstick) and the
    bound, peak memory of each forward, and the tensor-core launch's
    shape."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import evoformer_attn as evo

    L = math.prod(lead)
    dt = getattr(torch, EVO_TYPES[dtype])
    elt = torch.tensor([], dtype=dt).element_size()
    qkv_bytes = L * s * h * d * elt
    sets = evo_sets(torch, lead, s, h, d, dtype)

    def operands():
        return evo_operands(torch, gen, dev, lead, s, h, d, biases, dtype)

    ops = [operands() for _ in range(sets)]
    q, k, v, bs = ops[0]
    route = evo.kernel_route(q, k, v, bs)
    key = EVO_KEYS[route]
    case = {"name": name, "kernel": key, "route": route, "dtype": dtype,
            "shape": list(lead) + [s, h, d], "biases": biases,
            "bias_kinds": [p["kind"] for p in evo.bias_plan(
                bs, tuple(lead), h, s, s)],
            "old_ms": old_ms}
    reset_launches()
    with torch.no_grad():
        got = evo.DS4Sci_EvoformerAttention(q, k, v, bs)
    torch.cuda.synchronize()
    case["fwd_launches"] = dict(evo.LAUNCHES)
    case["launch"] = evo.launch_info()
    with torch.no_grad():
        again = evo.evoformer_attention_kernel(q, k, v, bs)
    torch.cuda.synchronize()
    case["bit_equal"] = bool(torch.equal(got, again))
    del again
    want = evo.evoformer_attention_dense(q, k, v, bs)
    case["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    case["norm_rel_err"] = rel_norm(got, want)
    if biases == "masked":                       # uniform: the mean of v
        mean_v = v[:, :16].float().mean(dim=2, keepdim=True)
        case["masked_rows_vs_mean_v"] = (got[:, :16].float() - mean_v) \
            .abs().max().item()
    # gradients: the kernel route's Function against dense autograd
    w = torch.randn(q.shape, generator=gen, device=dev)
    grads = {}
    for route in ("kernel", "dense"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        pair = [bs[1].detach().clone().requires_grad_()] if bs else []
        args = bs[:1] + pair + bs[2:]
        reset_launches()
        fn = (evo.DS4Sci_EvoformerAttention if route == "kernel"
              else evo.evoformer_attention_dense)
        (fn(*leaves, args).float() * w).sum().backward()
        torch.cuda.synchronize()
        if route == "kernel":
            case["grad_launches"] = dict(evo.LAUNCHES)
        grads[route] = [t.grad for t in leaves + pair]
    case["grad_norm_rel_err"] = dict(zip(
        ("dq", "dk", "dv", "dpair"),
        (rel_norm(a, b_) for a, b_ in zip(grads["kernel"], grads["dense"]))))
    del grads

    def fwd(i):
        with torch.no_grad():
            evo.evoformer_attention_kernel(*ops[i][:3], ops[i][3])

    def plain(i):
        with torch.no_grad():
            evo.evoformer_attention_dense(*ops[i][:3], ops[i][3])

    case["ms"] = time_ms(fwd, sets, 20)
    case["plain_ms"] = time_ms(plain, sets, sets)
    # SDPA over [L, H, S, d] with the biases summed into one float mask
    # [L, H, S, S], made outside the timing: a yardstick only
    sd = []
    for qi, ki, vi, bi in ops:
        lay = [t.reshape(L, s, h, d).transpose(1, 2).contiguous()
               for t in (qi, ki, vi)]
        mask = None
        if bi:
            mask = sum(bi[1:], bi[0]).expand(lead + (h, s, s)).reshape(
                L, h, s, s).contiguous()
        sd.append((lay, mask))
    case["library_ms"] = time_ms(
        lambda i: F.scaled_dot_product_attention(*sd[i][0],
                                                 attn_mask=sd[i][1]),
        sets, 20)
    del sd
    bias_bytes = sum(t.numel() * t.element_size() for t in bs)
    case["bound_ms"], case["bound_by"] = bound(
        4 * qkv_bytes + bias_bytes, 4.0 * L * h * s * s * d,
        FP32_FLOPS if dt == torch.float32 else BF16_FLOPS)
    if dt == torch.float32:
        # the general kernel's own work: three TF32 products a product
        case["bound_3xtf32_ms"] = bound(4 * qkv_bytes + bias_bytes,
                                        12.0 * L * h * s * s * d,
                                        TF32_FLOPS)[0]
    # one MUFU exponential a score, 16 a clock an SM (132 SMs at the
    # card's largest SM clock): the floor the exponentials set
    case["exp_floor_ms"] = L * h * s * s / (16 * 132 * max_sm_clock_hz()) * 1e3
    for route, fn in (("kernel", fwd), ("dense", plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(0)
        torch.cuda.synchronize()
        case[f"{route}_fwd_peak_extra_mb"] = (
            torch.cuda.max_memory_allocated() - base) / 1e6
    return case


def start_planted_builds(source="evoformer_attn", faults=None):
    """Start one ``nvcc`` for each fault of ``faults`` (``EVO_PLANTED`` by
    default), on a copy of csrc/<source>.cu under build/ (phases 22 and 23
    load them)."""
    from deepspeed_tpu_torch.ops import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    out = ROOT / "build" / f"{source}_planted"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (fault, (text, planted, _)) in enumerate(
            (faults or EVO_PLANTED).items()):
        assert src.count(text) == 1, text
        cu, lib = out / f"planted{i}.cu", out / f"libplanted{i}.so"
        cu.write_text(src.replace(text, planted))
        procs[fault] = (subprocess.Popen(
            _build.nvcc_command(cu, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), lib)
    return procs


def evo_bar_met(dtype, max_err, norm_err) -> bool:
    """Whether a phase-22 forward meets its type's bar: fp32 within
    EVO_FP32_TOL (and the norm bar), bf16 / fp16 within TOL and NORM_TOL."""
    return max_err <= (EVO_FP32_TOL if dtype == "fp32" else TOL) \
        and norm_err <= NORM_TOL


def evoformer_planted(torch, dev, procs):
    """The triangle case's forward, in each fault's type, through each
    planted library against the dense version: max abs and norm errors by
    fault, and whether they meet the type's bar."""
    import ctypes

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import evoformer_attn as evo

    inputs = {}
    for dtype in {dt for *_, dt in EVO_PLANTED.values()}:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 14)
        q, k, v, bs = evo_operands(torch, gen, dev, (1, 256), 256, 4, 32,
                                   "both", dtype)
        inputs[dtype] = (q, k, v, bs, evo.evoformer_attention_dense(q, k, v,
                                                                    bs))
    built = _build.load("evoformer_attn")
    out = {}
    try:
        for fault, (proc, lib) in procs.items():
            log = proc.communicate()[0].decode()
            if proc.returncode:
                raise RuntimeError(f"planted {fault}: nvcc failed\n{log[-2000:]}")
            _build._LIBS["evoformer_attn"] = ctypes.CDLL(str(lib))
            evo._kernel.cache_clear()
            dtype = EVO_PLANTED[fault][2]
            q, k, v, bs, want = inputs[dtype]
            got = evo.evoformer_attention_kernel(q, k, v, bs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().nan_to_num(
                float("inf")).max().item()
            norm = rel_norm(got.float().nan_to_num(1e30), want)
            out[fault] = {"dtype": dtype, "route": evo.kernel_route(
                q, k, v, bs), "max_abs_err": err, "norm_rel_err": norm,
                "meets_bar": evo_bar_met(dtype, err, norm)}
    finally:
        _build._LIBS["evoformer_attn"] = built
        evo._kernel.cache_clear()
    return out


# --------------------------------------------------------------------- #
# Phase 23: block-sparse attention (B11)
# --------------------------------------------------------------------- #
BSA_KEYS = ("block_sparse_attention_fwd", "block_sparse_attention_bwd_dq",
            "block_sparse_attention_bwd_dkv")
BSA_DENSE = "sparse_self_attention_dense"
#: the layouts at BERT width: upstream's defaults (Fixed 4 local / 1 global,
#: both directions), BigBird (1 random, 3 sliding, 1 global), BSLongformer
#: (3 sliding, global [0]), Variable (1 random, windows [4], global [0]) and
#: Dense (density 1, the worst case)
BSA_LAYOUTS = {
    "fixed": ("FixedSparsityConfig",
              dict(num_local_blocks=4, num_global_blocks=1)),
    "fixed_uni": ("FixedSparsityConfig",
                  dict(num_local_blocks=4, num_global_blocks=1,
                       attention="unidirectional")),
    "bigbird": ("BigBirdSparsityConfig",
                dict(num_random_blocks=1, num_sliding_window_blocks=3,
                     num_global_blocks=1)),
    "bslongformer": ("BSLongformerSparsityConfig",
                     dict(num_sliding_window_blocks=3,
                          global_block_indices=[0])),
    "variable": ("VariableSparsityConfig",
                 dict(num_random_blocks=1, local_window_blocks=[4],
                      global_block_indices=[0])),
    "dense": ("DenseSparsityConfig", {}),
}
#: (name, layout, B, H, S, D, block, type, extra config keywords,
#: key-padding mode): BERT width (models/bert.py: 12 heads of 64),
#: S = 4096, block 16, batch 4; the padded cases' batches hold sequences
#: of S, 3/4, 1/2 and 1/4 of S keys (lengths off the block grid:
#: bsa_padding_mask), "mul" a 0/1 keep mask, "add" BERT's additive -10000
BSA_CASES = tuple((n, n, 4, 12, 4096, 64, 16, "bf16", {}, None)
                  for n in BSA_LAYOUTS) + (
    ("fixed fp16", "fixed", 4, 12, 4096, 64, 16, "fp16", {}, None),
    ("bslongformer fp32", "bslongformer", 4, 12, 4096, 64, 16, "fp32", {},
     None),
    ("bigbird D128", "bigbird", 4, 6, 4096, 128, 16, "bf16", {}, None),
    ("bslongformer block32", "bslongformer", 4, 12, 4096, 64, 32, "bf16", {},
     None),
    ("variable block64", "variable", 4, 12, 4096, 64, 64, "bf16", {}, None),
    ("bigbird per-head", "bigbird", 4, 12, 4096, 64, 16, "bf16",
     {"different_layout_per_head": True}, None),
    ("fixed S1040", "fixed", 4, 12, 1040, 64, 16, "bf16", {}, None),
    ("bigbird padded mul", "bigbird", 4, 12, 4096, 64, 16, "bf16", {}, "mul"),
    ("bslongformer padded add", "bslongformer", 4, 12, 4096, 64, 16, "bf16",
     {}, "add"),
    ("fixed S1040 padded mul fp32", "fixed", 4, 12, 1040, 64, 16, "fp32", {},
     "mul"),
    ("bslongformer S1040 D20 fp32", "bslongformer", 4, 12, 1040, 20, 16,
     "fp32", {}, None),
)
#: the timing case: forward only, held against the plain forward
BSA_LONG = ("bigbird S16384", "bigbird", 1, 12, 16384, 64, 16, "bf16", {},
            None)
BSA_GRAD_NORM_TOL = 5e-2
BSA_FP32_TOL = 1e-4
#: the fp32 cases' gradient bar: max |got - plain| / max(1, max |plain|)
#: for each of dq, dk and dv (beside the norm bar); the split-TF32
#: products keep ~1e-6 there (tests/test_torch_bsa_walk.py), TF32 products
#: alone ~1e-3
BSA_FP32_GRAD_TOL = 1e-4
BSA_DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
#: the fault planted in a copy of csrc/block_sparse_attention.cu, with the
#: case it runs at: the fp32 kernels' split products (forward, dQ and
#: dK/dV share `mma_split`) without their hi.lo and lo.hi terms (one TF32
#: product), which must miss BSA_FP32_TOL forward and BSA_FP32_GRAD_TOL on
#: the gradients
BSA_PLANTED = {
    "split cross terms dropped": (
        "  {  // the split's cross terms", "  if (false) {",
        "bslongformer fp32"),
}


def fp32_grad_errs(got, want) -> dict:
    """max |got - want| / max(1, max |want|) of each of dq, dk and dv (the
    fp32 gradient bar's reading)."""
    return {g: ((a.float() - c.float()).abs().nan_to_num(float("inf")).max()
                / c.float().abs().max().clamp_min(1.0)).item()
            for g, a, c in zip(("dq", "dk", "dv"), got, want)}


def bsa_planted(torch, np, gen, dev, procs):
    """The fp32 forward, dQ and dK/dV of each fault's case (``BSA_CASES``)
    through each planted library against the plain fp32 versions: max abs
    error of o and lse, whether o meets BSA_FP32_TOL, the gradients'
    errors under the fp32 gradient bar (``fp32_grad_errs``) and whether they
    meet it."""
    import ctypes

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    built = _build.load("block_sparse_attention")
    out = {}
    try:
        for fault, (proc, lib) in procs.items():
            log = proc.communicate()[0].decode()
            if proc.returncode:
                raise RuntimeError(f"planted {fault}: nvcc failed\n"
                                   f"{log[-2000:]}")
            name = BSA_PLANTED[fault][2]
            _, layout, b, h, s, d, block, _, extra, _ = next(
                c for c in BSA_CASES if c[0] == name)
            cls, kw = BSA_LAYOUTS[layout]
            bsl = bsa.BlockSparseLayout(np.asarray(getattr(sa, cls)(
                h, block, **kw, **extra).make_layout(s)), block, s)
            q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                                       device=dev) for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            qs = q * scale
            keep = bsl.element_mask(dev)
            want = bsa.block_sparse_plain_fwd(qs, k, v, keep)
            rdq, rdelta = bsa.block_sparse_plain_bwd_dq(
                qs, k, v, *want, do, keep, scale)
            rgrads = (rdq,) + bsa.block_sparse_plain_bwd_dkv(
                qs, k, v, do, want[1], rdelta, keep)
            del rdelta
            _build._LIBS["block_sparse_attention"] = ctypes.CDLL(str(lib))
            bsa._kernel.cache_clear()
            o, lse = bsa.block_sparse_attention_fwd(qs, k, v, bsl)
            # the gradients from the plain forward's o and lse, so that
            # they read the planted backward alone
            dq, delta = bsa.block_sparse_attention_bwd_dq(
                qs, k, v, *want, do, bsl, scale)
            grads = (dq,) + bsa.block_sparse_attention_bwd_dkv(
                qs, k, v, do, want[1], delta, bsl)
            torch.cuda.synchronize()
            err = (o - want[0]).abs().nan_to_num(float("inf")).max().item()
            gerr = fp32_grad_errs(grads, rgrads)
            out[fault] = {"case": name, "max_abs_err": err,
                          "lse_max_abs_err": (lse - want[1]).abs().max()
                          .item(), "meets_bar": err <= BSA_FP32_TOL,
                          "grad_errs": gerr,
                          "grad_meets_bar": max(gerr.values())
                          <= BSA_FP32_GRAD_TOL}
            del grads, rgrads, want
            bsl._elem.clear()
    finally:
        _build._LIBS["block_sparse_attention"] = built
        bsa._kernel.cache_clear()
    return out


def bsa_planted_fault(np, bsl, side="q"):
    """A copy of ``bsl`` whose kernel lists drop a tile (the faults the
    bars must catch): side "q", the last live key tile of every query tile
    from the query-major lists (the forward and dQ); side "k", the last
    live query tile of every key tile from the key-major lists (dK/dV)."""
    import copy

    bad = copy.copy(bsl)
    m = bsl.kernel_masks.copy()
    mt = np.ascontiguousarray(m.transpose(0, 2, 1))
    cut = m if side == "q" else mt
    h, n, _ = cut.shape
    for hh in range(h):
        for i in range(n):
            live = np.nonzero(cut[hh, i])[0]
            if len(live):
                cut[hh, i, live[-1]] = 0
    bad._masks, bad._masks_t, bad._lists, bad._elem = m, mt, {}, {}
    return bad


def bsa_forced_split(torch, bsa, bsl, operands, bias, want):
    """The forward with every list longer than two stages split
    into parts of two (the split rule's constants set so, the tables built
    afresh on a copy of ``bsl``), twice: whether the two runs give the same
    bits, their distance to ``want`` (the forward under the rule's split)
    and the split groups of the walk."""
    import copy

    forced = copy.copy(bsl)
    forced._lists, forced._elem = {}, {}
    rule = (bsa.SPLIT_MIN, bsa.WAVE)
    bsa.SPLIT_MIN, bsa.WAVE = 2, 1 << 40
    try:
        runs = [bsa.block_sparse_attention_fwd(*operands[:3], forced, bias)
                for _ in range(2)]
        info = bsa.launch_info()
    finally:
        bsa.SPLIT_MIN, bsa.WAVE = rule
    torch.cuda.synchronize()
    return {"bit_equal": all(torch.equal(a, c) for a, c in zip(*runs)),
            "max_abs_err": (runs[0][0].float() - want[0].float()).abs()
            .max().item(),
            "norm_rel_err": rel_norm(runs[0][0], want[0]),
            "lse_max_abs_err": (runs[0][1] - want[1]).abs().max().item(),
            "split_groups": info["split_groups"],
            "max_stages": info["max_stages"]}


def bsa_forced_split_bwd(torch, bsa, bsl, operands, res, scale, bias,
                         want):
    """dQ and dK/dV with every list longer than two stages split into
    parts of two (as ``bsa_forced_split``), twice: whether the two runs
    give the same bits, their distance to ``want`` (dq, dk, dv under the
    rule's split; ``fp32_grad_errs``) and the split groups of both walks."""
    import copy

    forced = copy.copy(bsl)
    forced._lists, forced._elem = {}, {}
    rule = (bsa.SPLIT_MIN, bsa.WAVE)
    bsa.SPLIT_MIN, bsa.WAVE = 2, 1 << 40
    runs, groups = [], {}
    try:
        for _ in range(2):
            dq, delta = bsa.block_sparse_attention_bwd_dq(
                *operands[:3], *res, operands[3], forced, scale, bias)
            groups["dq"] = bsa.launch_info()["split_groups"]
            runs.append((dq, delta) + bsa.block_sparse_attention_bwd_dkv(
                *operands[:3], operands[3], res[1], delta, forced, bias))
            groups["dkv"] = bsa.launch_info()["split_groups"]
    finally:
        bsa.SPLIT_MIN, bsa.WAVE = rule
    torch.cuda.synchronize()
    return {"bit_equal": all(torch.equal(a, c) for a, c in zip(*runs)),
            "grad_errs": fp32_grad_errs(
                (runs[0][0], runs[0][2], runs[0][3]), want),
            "split_groups": groups}


def bsa_padding_mask(torch, dev, b, s, mode):
    """A batch of b sequences of S and about 3/4, 1/2 and 1/4 of S valid
    keys (lengths off the block grid) as a [b, S] key-padding mask: mode
    "mul" a 0/1 keep mask, "add" 0 / -10000 (BERT's extended attention
    mask)."""
    lengths = torch.tensor([s] + [s * f // 4 + 5 - 4 * f for f in (3, 2, 1)],
                           device=dev)[:b]
    valid = torch.arange(s, device=dev)[None] < lengths[:, None]
    if mode == "mul":
        return valid.float()
    return torch.where(valid, 0.0, -10000.0)


def bsa_bounds(bsl, b, h, s, d, elt, peak, bias_bytes=0):
    """Per kernel (fwd, bwd_dq, bwd_dkv): the bound from the bytes (each
    operand read once, each output written once; the key bias, when given,
    is ``bias_bytes``) and the FLOPs of the layout's live cells, and the
    FLOPs of its live 64 x 64 tiles."""
    dead, total = bsl.tiles_skipped()
    live = float(bsl.layout.sum()) * bsl.block ** 2 * b
    tiles = float(total - dead) * 64 * 64 * b
    t, row = b * h * s * d * elt, b * h * s * 4
    work = {"fwd": (4 * t + row, 4), "bwd_dq": (6 * t + 2 * row, 6),
            "bwd_dkv": (6 * t + 2 * row, 8)}
    out = {}
    for k, (nbytes, f) in work.items():
        nbytes += bias_bytes
        ms, by = bound(nbytes, f * live * d, peak)
        out[k] = {"bound_ms": ms, "bound_by": by,
                  "cell_flops": f * live * d, "tile_flops": f * tiles * d,
                  "tile_bound_ms": bound(nbytes, f * tiles * d, peak)[0]}
    return out


def block_sparse_case(torch, np, gen, dev, name, layout, b, h, s, d, block,
                      dtype, extra, padding, forward_only=False):
    """One phase-23 case.  The main path, ``SparseSelfAttention`` with
    implementation "auto" (with the key-padding mask of ``padding``, when
    given), forward and backward, counted from 0; then the kernels against
    ``block_sparse_attention_reference`` on the same inputs (a padded case
    also against the dense composition), the two planted faults, and each
    kernel timed beside its plain version, SDPA over the expanded boolean
    mask (a yardstick) and the bound."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    cls, kw = BSA_LAYOUTS[layout]
    cfg = getattr(sa, cls)(h, block, **kw, **extra)
    attn = sa.SparseSelfAttention(cfg, key_padding_mask_mode=padding or "mul")
    dt = getattr(torch, BSA_DTYPES[dtype])
    elt = torch.tensor([], dtype=dt).element_size()
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=dt) for _ in range(4))
    kpm = None if padding is None else bsa_padding_mask(torch, dev, b, s,
                                                        padding)
    bias = None if kpm is None else sa.key_padding_bias(kpm, padding)
    case = {"name": name, "layout": layout, "dtype": dtype,
            "shape": [b, h, s, d], "block": block, "padding": padding}

    def run(fn, *args, **kw):
        leaves = [t.clone().requires_grad_(not forward_only)
                  for t in (q, k, v)]
        out = fn(*leaves, *args, **kw)
        if not forward_only:
            out.backward(do)
        torch.cuda.synchronize()
        return out.detach(), [t.grad for t in leaves]

    def grad_errs(grads, rgrads):
        return dict(zip(("dq", "dk", "dv"), (
            rel_norm(a, c) for a, c in zip(grads, rgrads))))

    reset_launches()
    got, grads = run(attn, key_padding_mask=kpm)
    case["launches"] = read_launches(BSA_KEYS + (BSA_DENSE,))
    bsl = attn._bs_layouts[s]
    want, rgrads = run(bsa.block_sparse_attention_reference, bsl,
                       key_bias=bias)
    case["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    case["norm_rel_err"] = rel_norm(got, want)
    if kpm is not None:
        with torch.no_grad():
            dense = sa.sparse_self_attention(
                q, k, v, bsl.layout, block, key_padding_mask=kpm,
                key_padding_mask_mode=padding)
        case["dense_max_abs_err"] = (got.float()
                                     - dense.float()).abs().max().item()
        case["dense_norm_rel_err"] = rel_norm(got, dense)
        del dense
    if not forward_only:
        case["grad_norm_rel_err"] = grad_errs(grads, rgrads)
        case["grad_max_abs_err"] = dict(zip(("dq", "dk", "dv"), (
            (a.float() - c.float()).abs().max().item()
            for a, c in zip(grads, rgrads))))
        case["grad_fp32_err"] = fp32_grad_errs(grads, rgrads)
        _, kgrads = run(bsa.block_sparse_attention,
                        bsa_planted_fault(np, bsl, "k"), key_bias=bias)
        case["fault_k_grad_norm_rel_err"] = grad_errs(kgrads, rgrads)
        del kgrads
    del grads, rgrads
    with torch.no_grad():
        bad = bsa.block_sparse_attention(q, k, v, bsa_planted_fault(np, bsl),
                                         key_bias=bias)
    case["fault_max_abs_err"] = (bad.float() - want.float()).abs().max().item()
    case["fault_norm_rel_err"] = rel_norm(bad, want)
    del bad, want
    case["density"] = bsl.density
    dead, total = bsl.tiles_skipped()
    case["live_tile_ratio"] = (total - dead) / total

    scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(dt)
    keep = bsl.element_mask(dev)
    sets = n_sets(4 * b * h * s * d * elt)
    ops = [(qs, k, v, do)] + [tuple(torch.randn_like(t) for t in (qs, k, v, do))
                              for _ in range(sets - 1)]
    res = [bsa.block_sparse_attention_fwd(*o[:3], bsl, bias) for o in ops]
    # two runs of the forward on the same inputs give the same bits (no
    # atomics on the outputs; split lists merge in part order), also with
    # every list split into parts of two stages
    again = bsa.block_sparse_attention_fwd(*ops[0][:3], bsl, bias)
    case["launch"] = {"fwd": bsa.launch_info()}
    torch.cuda.synchronize()
    case["fwd_bit_equal"] = all(torch.equal(a, c)
                                for a, c in zip(res[0], again))
    case["fwd_forced_split"] = bsa_forced_split(torch, bsa, bsl, ops[0],
                                                bias, res[0])
    del again
    case["ms"] = {"fwd": time_ms(
        lambda i: bsa.block_sparse_attention_fwd(*ops[i][:3], bsl, bias),
        sets, 20)}
    case["plain_ms"] = {"fwd": time_ms(
        lambda i: bsa.block_sparse_plain_fwd(qs, k, v, keep, bias), 1, 2)}
    # the yardstick's boolean mask: the layout's cells and the valid keys
    mask = keep[None] if bias is None else \
        keep[None] & (bias > -1e3)[:, None, None, :]
    case["library_ms"] = {"fwd": time_ms(
        lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        1, 3)}
    if not forward_only:
        # two runs of dQ and dK/dV on the same inputs must give the same
        # bits (no atomics on the outputs; split lists sum in part order)
        runs = []
        for _ in range(2):
            dq_, delta_ = bsa.block_sparse_attention_bwd_dq(
                *ops[0][:3], *res[0], ops[0][3], bsl, scale, bias)
            case["launch"]["bwd_dq"] = bsa.launch_info()
            runs.append((dq_, delta_) + bsa.block_sparse_attention_bwd_dkv(
                *ops[0][:3], ops[0][3], res[0][1], delta_, bsl, bias))
            case["launch"]["bwd_dkv"] = bsa.launch_info()
        torch.cuda.synchronize()
        case["bwd_bit_equal"] = all(torch.equal(a, c)
                                    for a, c in zip(*runs))
        if dt == torch.float32:
            # the same, every list split into parts of two stages: the
            # parts sum in part order to the rule's gradients within the
            # fp32 bar, with the same bits twice
            case["bwd_forced_split"] = bsa_forced_split_bwd(
                torch, bsa, bsl, ops[0], res[0], scale, bias,
                (runs[0][0], runs[0][2], runs[0][3]))
        del runs, dq_, delta_
        deltas = [bsa.block_sparse_attention_bwd_dq(
            *o[:3], r[0], r[1], o[3], bsl, scale, bias)[1]
            for o, r in zip(ops, res)]
        case["ms"]["bwd_dq"] = time_ms(
            lambda i: bsa.block_sparse_attention_bwd_dq(
                *ops[i][:3], res[i][0], res[i][1], ops[i][3], bsl, scale,
                bias), sets, 10)
        case["ms"]["bwd_dkv"] = time_ms(
            lambda i: bsa.block_sparse_attention_bwd_dkv(
                *ops[i][:3], ops[i][3], res[i][1], deltas[i], bsl, bias),
            sets, 10)
        o, lse = res[0]
        case["plain_ms"]["bwd_dq"] = time_ms(
            lambda i: bsa.block_sparse_plain_bwd_dq(qs, k, v, o, lse, do,
                                                    keep, scale, bias), 1, 2)
        case["plain_ms"]["bwd_dkv"] = time_ms(
            lambda i: bsa.block_sparse_plain_bwd_dkv(qs, k, v, do, lse,
                                                     deltas[0], keep, bias),
            1, 2)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd(i):
            F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(
                do)

        case["library_ms"]["fwd_bwd"] = time_ms(sdpa_fwd_bwd, 1, 3)
        # the backward alone: one autograd call over SDPA's saved forward
        # computes dQ, dK and dV together
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        case["library_ms"]["bwd"] = time_ms(
            lambda i: torch.autograd.grad(out, leaves, do,
                                          retain_graph=True), 1, 3)
        del deltas, leaves, out
    del res, ops, qs
    bounds = bsa_bounds(bsl, b, h, s, d, elt,
                        FP32_FLOPS if dt == torch.float32 else BF16_FLOPS,
                        0 if bias is None else bias.numel() * 4)
    case["bounds"] = {kn: bounds[kn] for kn in case["ms"]}
    # achieved TFLOP/s on the layout's live cells and on its live 64 x 64
    # tiles (the work before 16-wide slices are skipped)
    case["tflops"] = {kn: {"cells": bounds[kn]["cell_flops"] / ms / 1e9,
                           "tiles": bounds[kn]["tile_flops"] / ms / 1e9}
                      for kn, ms in case["ms"].items()}
    bsl._elem.clear()
    return case


def bsa_failures(case) -> list:
    """The bars of phase 23 that ``case`` misses (empty when it passes)."""
    fwd_only = "grad_norm_rel_err" not in case
    def fwd_ok(max_err, norm_err):
        if case["dtype"] == "fp32":
            return max_err <= BSA_FP32_TOL
        return max_err <= TOL and norm_err <= NORM_TOL

    bad = [] if fwd_ok(case["max_abs_err"], case["norm_rel_err"]) \
        else ["forward"]
    if "dense_max_abs_err" in case and not fwd_ok(
            case["dense_max_abs_err"], case["dense_norm_rel_err"]):
        bad.append("forward against the dense composition")
    if not fwd_only and not all(
            x <= BSA_GRAD_NORM_TOL for x in case["grad_norm_rel_err"].values()):
        bad.append("gradients")
    if not fwd_only and case["dtype"] == "fp32" and not all(
            x <= BSA_FP32_GRAD_TOL for x in case["grad_fp32_err"].values()):
        bad.append(f"fp32 gradients {case['grad_fp32_err']}")
    if case["fault_max_abs_err"] <= TOL and \
            case["fault_norm_rel_err"] <= NORM_TOL:
        bad.append("planted fault passes the bars")
    if not fwd_only and any(
            case["fault_k_grad_norm_rel_err"][g] <= BSA_GRAD_NORM_TOL
            for g in ("dk", "dv")):
        bad.append("planted key-major fault passes the gradient bar")
    if not fwd_only and not case["bwd_bit_equal"]:
        bad.append("dQ / dK/dV not bit-equal over two runs")
    if not case["fwd_bit_equal"]:
        bad.append("the forward not bit-equal over two runs")
    forced = case.get("fwd_forced_split")
    if forced is not None and not (
            forced["bit_equal"] and forced["split_groups"] > 0
            and fwd_ok(forced["max_abs_err"], forced["norm_rel_err"])):
        bad.append(f"the forward under a forced split {forced}")
    forced = case.get("bwd_forced_split")
    if forced is not None and not (
            forced["bit_equal"] and min(forced["split_groups"].values()) > 0
            and max(forced["grad_errs"].values()) <= BSA_FP32_GRAD_TOL):
        bad.append(f"dQ / dK/dV under a forced split {forced}")
    want = {BSA_KEYS[0]: 1, BSA_KEYS[1]: int(not fwd_only),
            BSA_KEYS[2]: int(not fwd_only), BSA_DENSE: 0}
    if case["launches"] != want:
        bad.append(f"launches {case['launches']}")
    return bad


# --------------------------------------------------------------------- #
# Phase 24: the continuous-batching scheduler serving Llama-2-7B (A5)
# --------------------------------------------------------------------- #
#: the JAX package's ``ContinuousBatchScheduler(registry=...)`` snapshot keys
#: (``serving/*`` and the engine's occupancy gauges) after a run
SERVING_KEYS = (
    "observability/hbm_weights_bytes", "observability/kv_blocks_evictable",
    "observability/kv_blocks_free", "observability/kv_blocks_live",
    "observability/kv_blocks_total", "observability/kv_blocks_warm",
    "observability/kv_live_bytes", "observability/kv_pool_bytes",
    "observability/kv_sequences_live", "observability/kv_tokens_live",
    "serving/deadline_exceeded", "serving/decode_ticks",
    "serving/decode_tokens_delivered", "serving/failed",
    "serving/fast_decode_ticks", "serving/finished",
    "serving/goodput_tokens_per_s", "serving/handoffs",
    "serving/overall_tokens_per_s", "serving/p50_decode_tick_s",
    "serving/p50_queue_wait_s", "serving/p50_tpot_s", "serving/p50_ttft_s",
    "serving/p95_decode_tick_s", "serving/p95_queue_wait_s",
    "serving/p95_tpot_s", "serving/p95_ttft_s",
    "serving/preempted_requests", "serving/preemption_rate",
    "serving/preemptions", "serving/rejected", "serving/shutdown_failed",
    "serving/submitted", "serving/tokens_per_decode_tick",
    "serving/tokens_per_request_tick", "serving/total_tokens",
    "serving/tpot_delivered_s")
#: the kernels the scheduled 7B path launches: B2 (int8 matmul), B5 (paged
#: prefill, generic) and B3 (paged decode)
SCHEDULER_KERNELS = ("quantized_matmul", "paged_attention",
                     "paged_decode_attention")
#: the teacher-forced bar: each scheduled token's logit in an unscheduled
#: re-score of the same history is at most this far below the re-score's
#: top logit (greedy) or its top_k-th (seeded top-k).  bf16 logits move by
#: a few hundredths between batch shapes (PERF.md section 6), while a
#: token from another request's row sits several logits below the top
TEACHER_FORCED_MARGIN = 0.25


def teacher_forced_gaps(np, eng, reqs, group, uid_base):
    """Re-score each request's history unscheduled, ``group`` requests at a
    time: its prompt by ``put`` (two prompts a call), then each generated
    token fed back by a ``put`` of one token a request.  Returns, for every
    generated token, how far its logit lies below the re-score's top logit
    (greedy) or its top_k-th logit (seeded top-k), clipped at 0."""
    gaps = []
    for g in range(0, len(reqs), group):
        grp = reqs[g:g + group]
        uids = [uid_base + r.uid for r in grp]
        rows = {}
        for i in range(0, len(grp), 2):
            rows.update(eng.put(uids[i:i + 2],
                                [r.prompt for r in grp[i:i + 2]]))
        for pos in range(max(len(r.generated) for r in grp)):
            live = [(r, u) for r, u in zip(grp, uids)
                    if pos < len(r.generated)]
            for r, u in live:
                row = rows[u]
                kth = 1 if r.sampling.greedy else r.sampling.top_k
                top = np.partition(row, -kth)[-kth]
                gaps.append(max(0.0, float(top - row[r.generated[pos]])))
            nxt = [(r, u) for r, u in live if pos + 1 < len(r.generated)]
            if nxt:
                rows = eng.put([u for _, u in nxt],
                               [[r.generated[pos]] for r, _ in nxt])
        eng.flush(uids)
    return np.asarray(gaps)


def gap_stats(np, gaps):
    return {"tokens": int(gaps.size), "max": float(gaps.max()),
            "p99": float(np.percentile(gaps, 99)),
            "nonzero": int((gaps > 0).sum()),
            "over_margin": int((gaps > TEACHER_FORCED_MARGIN).sum())}


def scheduler_served_run(torch, np, n_requests=32, rate_rps=16.0,
                         prompt_len=192, gen_tokens=48, clients=8,
                         block=128, kv_fraction=0.7):
    """``bench_serving.py`` ``measure_scheduler``'s traffic on the 32-layer
    Llama-2-7B geometry with phase 5's int8 tree: Poisson arrivals through
    ``ContinuousBatchScheduler.run_with_arrivals``, a KV pool of 0.7 of the
    worst-case demand, half the requests greedy and half seeded top-k.
    Counts set to 0 just before the run and read just after it.  Then a
    run that preempts (16 requests of 100-token prompts at once), a traced
    window of decode ticks, and the greedy requests' prompts through an
    unscheduled ``put`` / ``decode_loop`` on the same engine.  Every
    scheduled token of the measured and the preempting run is held to the
    teacher-forced bar (:func:`teacher_forced_gaps`), and so is a run
    through a scheduler with a planted slot swap, which must miss it."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.observability import MetricsRegistry
    from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler,
                                             SamplingParams)

    class SwappedSlots(ContinuousBatchScheduler):
        """The planted fault: a tick's first two emitted tokens trade
        requests (a logits row read from the wrong slot)."""

        def _advance_emitted(self, ready, tokens):
            if len(tokens) >= 2:
                tokens = [tokens[1], tokens[0], *tokens[2:]]
            return super()._advance_emitted(ready, tokens)

    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    max_ctx = prompt_len + gen_tokens + 8
    per_seq = -(-max_ctx // block)
    num_blocks = max(int(clients * per_seq * kv_fraction), 2 * per_seq) + 1
    eng = InferenceEngineV2(
        RaggedLlama(cfg, block, use_kernels=True), params,
        RaggedInferenceEngineConfig.from_dict({
            "state_manager": {"max_ragged_batch_size": 512,
                              "max_ragged_sequence_count": clients,
                              "max_context": max_ctx},
            "kv_cache": {"block_size": block, "num_blocks": num_blocks}}))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=(prompt_len,)).tolist()
               for _ in range(n_requests)]
    sampling = [SamplingParams(max_new_tokens=gen_tokens) if i % 2 == 0
                else SamplingParams(greedy=False, temperature=0.8, top_k=50,
                                    seed=SEED, max_new_tokens=gen_tokens)
                for i in range(n_requests)]
    # warm: a burst of the same workload through a throwaway scheduler
    ContinuousBatchScheduler(eng).run_with_arrivals(
        prompts[:clients], [0.0] * clients, sampling=sampling[:clients])
    registry = MetricsRegistry()
    sched = ContinuousBatchScheduler(eng, registry=registry)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_requests))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    reqs = sched.run_with_arrivals(prompts, arrivals, sampling=sampling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = sched.metrics.snapshot()
    scrape = registry.snapshot()
    sm = eng.state_manager
    free_after = sm.free_blocks
    ticks = sched._tick
    ttft = np.asarray([r.ttft for r in reqs if r.ttft is not None] or [0.0],
                      np.float64) * 1e3
    out = {
        "layers": cfg.num_hidden_layers, "requests": n_requests,
        "rate_rps": rate_rps, "prompt_len": prompt_len,
        "gen_tokens": gen_tokens, "kv_blocks": num_blocks,
        "wall_s": wall, "ticks": ticks, "ms_per_tick": wall / ticks * 1e3,
        "goodput_tokens_per_s": snap["total_tokens"] / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "tpot_ms_p50": snap["p50_tpot_s"] * 1e3,
        "preemptions": sched.metrics.preemptions,
        "fast_decode_ticks": sched.fast_ticks,
        "states": sorted({r.state.value for r in reqs}),
        "generated": sorted({len(r.generated) for r in reqs}),
        "preempted_finished": all(r.state.value == "finished"
                                  for r in reqs if r.preemptions),
        "free_blocks_after": free_after, "pool_blocks": num_blocks - 1,
        "launches": launches,
        "missing_keys": [k for k in SERVING_KEYS if k not in scrape],
        "tokens_in_vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.generated),
    }
    # that traffic never preempts at block 128: a 192-token prompt takes
    # its 2 blocks at admission and 192 + 48 tokens never reach a third, so
    # the pool bounds admission (5 requests at a time) instead.  Preemption
    # by flush_to_host and recompute is driven on the same engine by
    # 2 x clients requests at once whose prompts (104 tokens) take 1 block
    # at admission and a second at their 25th new token, half greedy and
    # half seeded
    pre_len = block - gen_tokens // 2
    pre_prompts = [rng.integers(0, cfg.vocab_size, size=(pre_len,)).tolist()
                   for _ in range(2 * clients)]
    s3 = ContinuousBatchScheduler(eng)
    t0 = time.perf_counter()
    pre = s3.run_with_arrivals(pre_prompts, [0.0] * len(pre_prompts),
                               sampling=sampling[:len(pre_prompts)])
    torch.cuda.synchronize()
    out["preemption_run"] = {
        "requests": len(pre), "prompt_len": pre_len,
        "wall_s": time.perf_counter() - t0,
        "preemptions": s3.metrics.preemptions,
        "preempted_requests": sum(int(r.preemptions > 0) for r in pre),
        "states": sorted({r.state.value for r in pre}),
        "generated": sorted({len(r.generated) for r in pre}),
        "preempted_finished": all(r.state.value == "finished"
                                  for r in pre if r.preemptions),
        "preempted_greedy": sum(int(r.preemptions > 0 and r.sampling.greedy)
                                for r in pre),
        "free_blocks_after": sm.free_blocks,
        "tokens_in_vocab": all(0 <= t < cfg.vocab_size
                               for r in pre for t in r.generated)}
    # where the time goes: 8 decode ticks of as many requests as the pool
    # holds whole (5 x 2 blocks of the 11), traced: no preemption inside
    # the window
    fit = min(clients, (num_blocks - 1)
              // -(-(prompt_len + gen_tokens) // block))
    s2 = ContinuousBatchScheduler(eng)
    for p in prompts[:fit]:
        s2.submit(p, sampling=SamplingParams(max_new_tokens=gen_tokens))
    for _ in range(100):
        if len(s2.running_decode_uids) == fit:
            break
        s2.step()
    out["trace"] = profile_window(torch, lambda: [s2.step()
                                                  for _ in range(8)], 8)
    s2.run_until_idle()
    # the greedy requests' prompts unscheduled: put two at a time, then
    # decode_loop, as many requests at a time as the pool holds whole
    greedy = [r for r in reqs if r.sampling.greedy]
    same = full = first_same = 0
    for g in range(0, len(greedy), fit):
        grp = greedy[g:g + fit]
        uids = [1000 + r.uid for r in grp]
        first = {}
        for i in range(0, len(grp), 2):
            first.update(eng.put(uids[i:i + 2],
                                 [r.prompt for r in grp[i:i + 2]]))
        start = [int(np.argmax(first[u])) for u in uids]
        toks = eng.decode_loop(uids, start, gen_tokens - 1)
        eng.flush(uids)
        for r, s0, t in zip(grp, start, toks):
            ref = [s0] + t.tolist()
            same += sum(int(a == c) for a, c in zip(r.generated, ref))
            full += int(r.generated == ref)
            first_same += int(r.generated[0] == s0)
    out["greedy_token_share_equal"] = same / (len(greedy) * gen_tokens)
    out["greedy_requests_equal"] = full
    out["greedy_first_tokens_equal"] = first_same
    out["greedy_requests"] = len(greedy)
    # the teacher-forced bar: the measured run, the preempting run (its
    # resumed requests included) and the planted slot swap
    out["teacher_forced"] = gap_stats(np, teacher_forced_gaps(
        np, eng, reqs, fit, 1000))
    out["preemption_run"]["teacher_forced"] = gap_stats(
        np, teacher_forced_gaps(np, eng, pre, fit, 2000))
    swapped = SwappedSlots(eng).run_with_arrivals(
        prompts[:clients], [0.0] * clients,
        sampling=[SamplingParams(max_new_tokens=16)] * clients)
    out["planted_slot_swap"] = gap_stats(np, teacher_forced_gaps(
        np, eng, swapped, fit, 3000))
    out["free_blocks_end"] = sm.free_blocks
    return out


def scheduler_failures(run) -> list:
    """The bars of phase 24 that ``run`` misses (empty when it passes)."""
    bad = []
    if run["states"] != ["finished"] or run["generated"] != [
            run["gen_tokens"]]:
        bad.append(f"states {run['states']} lengths {run['generated']}")
    pre = run["preemption_run"]
    if pre["preemptions"] < 1 or not pre["preempted_finished"] \
            or pre["states"] != ["finished"] \
            or pre["generated"] != [run["gen_tokens"]] \
            or not pre["tokens_in_vocab"]:
        bad.append(f"preemption run {pre}")
    if not run["preempted_finished"]:
        bad.append("a preempted request of the measured run did not finish")
    if {run["free_blocks_after"], pre["free_blocks_after"],
            run["free_blocks_end"]} != {run["pool_blocks"]}:
        bad.append(f"free blocks {run['free_blocks_after']} / "
                   f"{pre['free_blocks_after']} / {run['free_blocks_end']} "
                   f"of {run['pool_blocks']}")
    if not all(run["launches"][k] > 0 for k in SCHEDULER_KERNELS):
        bad.append(f"launches {run['launches']}")
    if run["missing_keys"]:
        bad.append(f"registry lacks {run['missing_keys']}")
    if not run["tokens_in_vocab"]:
        bad.append("tokens outside the vocabulary")
    for name, tf in (("measured run", run["teacher_forced"]),
                     ("preemption run", pre["teacher_forced"])):
        if tf["over_margin"]:
            bad.append(f"{name}: scheduled tokens off the teacher-forced "
                       f"re-score {tf}")
    if not run["planted_slot_swap"]["over_margin"]:
        bad.append(f"the planted slot swap passes the teacher-forced bar "
                   f"{run['planted_slot_swap']}")
    return bad


# --------------------------------------------------------------------- #
# Phases 25-27: the router, the host tier and checkpoints
# --------------------------------------------------------------------- #
#: phase 25's placement bar: a request whose tenant's prefix is warm
#: somewhere routes to a replica holding at least the prefix's whole blocks
#: (floor(230 / 32) * 32 tokens of the 0.9 x 256-token system prompt)
ROUTER_WARM_TOKENS = (230 // 32) * 32
#: phase 25 and 26 serve through these kernels (B2, B5, B3)
ROUTER_KERNELS = SCHEDULER_KERNELS
TIER_KERNELS = {"bf16": SCHEDULER_KERNELS,
                "int8": ("quantized_matmul", "paged_attention_int8",
                         "paged_decode_attention_int8")}


def router_served_run(torch, np, n_requests=64, tenants=4,
                      shared_prefix_ratio=0.9, prompt_len=256,
                      gen_tokens=16, clients=8, block=32, replicas=2):
    """``bench_serving.py`` ``measure_shared_prefix``'s traffic on the
    32-layer Llama-2-7B geometry with phase 5's int8 tree: ``replicas``
    schedulers sharing one weight tree behind ``CacheAwareRouter``, each
    tenant's system prompt 0.9 of a 256-token prompt.  Cold then warm
    requests one at a time (TTFT), then the rest concurrently (counts set
    to 0 just before, read just after).  Every placement is recorded
    beside the replicas' warm prefixes probed just before it; every
    generated token is re-scored on its replica (the teacher-forced bar);
    and a planted router that ignores the cache (``cache_weight=0``)
    places a second round of the same traffic."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.serving import (CacheAwareRouter,
                                             ContinuousBatchScheduler,
                                             SamplingParams)

    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    max_ctx = prompt_len + gen_tokens + 8
    per_seq = -(-max_ctx // block)
    prefix_blocks = -(-prompt_len // block)
    num_blocks = clients * per_seq + tenants * prefix_blocks + 1
    eng_cfg = RaggedInferenceEngineConfig.from_dict({
        "state_manager": {"max_ragged_batch_size": 512,
                          "max_ragged_sequence_count": clients,
                          "max_context": max_ctx},
        "kv_cache": {"block_size": block, "num_blocks": num_blocks,
                     "enable_prefix_cache": True}})
    engines = [InferenceEngineV2(RaggedLlama(cfg, block, use_kernels=True),
                                 params, eng_cfg) for _ in range(replicas)]
    shared = all(e.params["lm_head"]["kernel"]["q"].data_ptr()
                 == engines[0].params["lm_head"]["kernel"]["q"].data_ptr()
                 for e in engines)
    rng = np.random.default_rng(SEED)
    shared_len = int(shared_prefix_ratio * prompt_len)
    pools = {f"t{i}": rng.integers(0, cfg.vocab_size,
                                   size=(shared_len,)).tolist()
             for i in range(tenants)}

    def make_prompt(tenant):
        tail = rng.integers(0, cfg.vocab_size,
                            size=(prompt_len - shared_len,)).tolist()
        return pools[tenant] + tail

    sampling = SamplingParams(greedy=True, max_new_tokens=gen_tokens)
    router = CacheAwareRouter([ContinuousBatchScheduler(e) for e in engines])
    # warm-up, as measure_shared_prefix: a throwaway prompt, a tail-sized
    # one and the warm path on each replica; their hits are not counted
    for rep in router.replicas:
        w = rep.scheduler.submit(
            rng.integers(0, cfg.vocab_size, size=(prompt_len,)).tolist(),
            sampling=sampling)
        rep.scheduler.run_until_idle()
        rep.scheduler.submit(
            rng.integers(0, cfg.vocab_size,
                         size=(prompt_len - shared_len + block,)).tolist(),
            sampling=sampling)
        rep.scheduler.run_until_idle()
        rep.scheduler.submit(w.prompt, sampling=sampling)
        rep.scheduler.run_until_idle()
        pc = rep.scheduler.engine.state_manager.prefix_cache
        pc.stats = type(pc.stats)()
    placements = []

    def submit(rt, prompt, tenant):
        probes = {rep.name: rep.prefix_match_tokens(prompt)
                  for rep in rt.replicas}
        req = rt.submit(prompt, tenant=tenant, sampling=sampling)
        placements.append((req, probes))
        return req

    # cold vs warm TTFT, one request at a time
    cold, warm, used = [], [], 0
    for tenant in pools:
        for j in range(3):
            req = submit(router, make_prompt(tenant), tenant)
            router.run_until_idle()
            used += 1
            (cold if j == 0 else warm).append(1e3 * req.ttft)
    # the concurrent mix over both replicas
    reqs = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(max(n_requests - used, 0)):
        tenant = f"t{i % tenants}"
        reqs.append(submit(router, make_prompt(tenant), tenant))
        router.step()
    router.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    everything = [r for r, _ in placements]
    agg = {}
    for rep in router.replicas:
        for k, v in rep.scheduler.engine.state_manager.prefix_cache.stats \
                .as_dict().items():
            agg[k] = agg.get(k, 0.0) + v
    all_prompt_tokens = sum(len(r.prompt) for r in everything)

    def placement_misses(placed):
        """Requests whose tenant's prefix was warm somewhere but that went
        to a replica holding less than ROUTER_WARM_TOKENS of it."""
        return [(r.uid, r.replica, probes) for r, probes in placed
                if max(probes.values()) >= ROUTER_WARM_TOKENS
                and probes[r.replica] < ROUTER_WARM_TOKENS]

    warm_placed = sum(int(max(p.values()) >= ROUTER_WARM_TOKENS)
                      for _, p in placements)
    misses = placement_misses(placements)
    # the teacher-forced bar, each request re-scored on its replica
    gaps = []
    for rep in router.replicas:
        mine = [r for r in everything if r.replica == rep.name]
        gaps.append(teacher_forced_gaps(np, rep.scheduler.engine, mine,
                                        clients, 1000))
    teacher = gap_stats(np, np.concatenate(gaps))
    # the planted fault: a router that ignores the cache, on the same warm
    # schedulers, given the tenants warm on one replica (a cache-aware
    # router keeps them there until the backlog outweighs the prefix)
    home = {t: max(router.replicas,
                   key=lambda rep: rep.prefix_match_tokens(pools[t])).name
            for t in pools}
    mine = [t for t in pools if home[t] == home["t0"]]
    planted_from = len(placements)
    blind = CacheAwareRouter([rep.scheduler for rep in router.replicas],
                             cache_weight=0.0)
    for i in range(2 * tenants):                 # one burst
        tenant = mine[i % len(mine)]
        submit(blind, make_prompt(tenant), tenant)
    blind.run_until_idle()
    planted = placements[planted_from:]
    # where a cold and a warm first token's time goes: one request alone on
    # a replica, traced from submission to its first token
    traced = {}
    for kind, tenant in (("cold", None), ("warm", "t0")):
        rep = next(r for r in router.replicas
                   if tenant is None or r.name == home[tenant])
        prompt = (rng.integers(0, cfg.vocab_size, size=(prompt_len,))
                  .tolist() if tenant is None else make_prompt(tenant))

        def first_token(rep=rep, prompt=prompt):
            req = rep.scheduler.submit(prompt, sampling=sampling)
            while not req.generated:
                rep.scheduler.step()
            return req

        traced[kind] = profile_window(torch, first_token, 1)
        rep.scheduler.run_until_idle()
    out = {
        "layers": cfg.num_hidden_layers, "replicas": replicas,
        "weights_shared": shared, "tenants": tenants,
        "shared_prefix_ratio": shared_prefix_ratio,
        "prompt_len": prompt_len, "gen_tokens": gen_tokens,
        "clients": clients, "block": block, "kv_blocks": num_blocks,
        "requests": len(everything),
        "cold_ttft_ms_p50": float(np.percentile(cold, 50)),
        "warm_ttft_ms_p50": float(np.percentile(warm, 50)),
        "cold_ttft_ms": cold, "warm_ttft_ms": warm,
        "cache_hit_rate": agg["hits"] / max(agg["lookups"], 1),
        "prefill_tokens_saved": int(agg["hit_tokens"]),
        "prefill_tokens_saved_pct": 100.0 * agg["hit_tokens"]
        / max(all_prompt_tokens, 1),
        "router": router.snapshot(),
        "requests_by_replica": dict(router.routed),
        "mix_wall_s": wall, "mix_requests": len(reqs),
        "mix_tokens_per_s": gen_tokens * len(reqs) / wall,
        "warm_placements": warm_placed, "placement_misses": misses,
        "uids_unique": len({r.uid for r in everything})
        == len(everything),
        "states": sorted({r.state.value for r in everything}),
        "generated": sorted({len(r.generated) for r in everything}),
        "teacher_forced": teacher, "launches": launches,
        "tenant_homes": home, "first_token_trace": traced,
        "planted_cache_blind": {
            "requests": len(planted), "tenants": mine,
            "warm_placements": sum(int(max(p.values())
                                       >= ROUTER_WARM_TOKENS)
                                   for _, p in planted),
            "placement_misses": len(placement_misses(planted))},
        "free_blocks_end": [rep.scheduler.engine.state_manager
                            .allocator.free_blocks
                            + rep.scheduler.engine.state_manager
                            .prefix_cache.evictable_blocks
                            for rep in router.replicas],
        "pool_blocks": num_blocks - 1,
    }
    del router, blind, engines, params
    torch.cuda.empty_cache()
    return out


def router_failures(run) -> list:
    """The bars of phase 25 that ``run`` misses (empty when it passes)."""
    bad = []
    if run["states"] != ["finished"] or run["generated"] != [
            run["gen_tokens"]]:
        bad.append(f"states {run['states']} lengths {run['generated']}")
    if not run["weights_shared"]:
        bad.append("the replicas do not share one weight tree")
    if run["warm_placements"] == 0 or run["placement_misses"]:
        bad.append(f"placement: {len(run['placement_misses'])} of "
                   f"{run['warm_placements']} warm requests placed off "
                   f"their warm replica: {run['placement_misses'][:4]}")
    if not run["uids_unique"]:
        bad.append("request uids repeat across replicas")
    if run["teacher_forced"]["over_margin"]:
        bad.append(f"tokens off the teacher-forced re-score "
                   f"{run['teacher_forced']}")
    if not all(run["launches"][k] > 0 for k in ROUTER_KERNELS):
        bad.append(f"launches {run['launches']}")
    if not run["planted_cache_blind"]["placement_misses"]:
        bad.append(f"the planted cache-blind router meets the placement "
                   f"bar {run['planted_cache_blind']}")
    if set(run["free_blocks_end"]) != {run["pool_blocks"]}:
        bad.append(f"free + evictable blocks {run['free_blocks_end']} of "
                   f"{run['pool_blocks']}")
    return bad


class GcClock:
    """Seconds the interpreter's garbage collector has run since
    :meth:`start` (a ``gc.callbacks`` hook, removed by :meth:`stop`)."""

    def __init__(self):
        self.total, self._t0 = 0.0, None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    def start(self):
        import gc

        gc.callbacks.append(self._hook)
        return self

    def stop(self):
        import gc

        gc.callbacks.remove(self._hook)


def count_block_calls(kv, gc_clock=None):
    """Wrap ``kv``'s ``gather_blocks`` / ``scatter_blocks`` to record each
    call's block count; every scatter is checked on the spot: a gather of
    the blocks just written equals the payload (the spooled copies of the
    pre-eviction gather), and each gather's wait for the device work
    queued before it is timed apart from the gather, as is the garbage
    collection inside it (with ``gc_clock``); the first gather and the
    first of 5 blocks or more are traced (the host calls that took the
    most time; the profiler warmed up first).  Returns the record."""
    import torch

    calls = {"gather": [], "scatter": [], "scatter_mismatch": 0,
             "drain_ms": [], "gather_ms": [], "gc_ms": [], "check_ms": [],
             "traces": []}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        pass
    real_gather, real_scatter = kv.gather_blocks, kv.scatter_blocks

    def gather(blocks, **kw):
        # the device work queued before the spool drains first, timed on
        # its own: the gather's own synchronization would wait for it
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gc0 = gc_clock.total if gc_clock else 0.0
        traced = not calls["gather"] or (len(blocks) >= 5 and not any(
            n >= 5 for n in calls["gather"]))
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = real_gather(blocks, **kw)
            rows = sorted(prof.key_averages(),
                          key=lambda e: -e.self_cpu_time_total)[:8]
            calls["traces"].append({
                "call": len(calls["gather"]), "blocks": len(blocks),
                "top_host_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                                for e in rows]})
        else:
            out = real_gather(blocks, **kw)
        calls["gc_ms"].append(1e3 * ((gc_clock.total if gc_clock else 0.0)
                                     - gc0))
        calls["drain_ms"].append(1e3 * (t1 - t0))
        calls["gather_ms"].append(1e3 * (time.perf_counter() - t1))
        calls["gather"].append(len(blocks))
        return out

    def scatter(blocks, payload):
        calls["scatter"].append(len(blocks))
        real_scatter(blocks, payload)
        t0 = time.perf_counter()
        records = isinstance(payload, list)
        back = real_gather(blocks, per_block=records)
        pairs = zip(back, payload) if records else [(back, payload)]
        calls["scatter_mismatch"] += sum(
            int(not torch.equal(b[l][k], p[l][k].to(b[l][k])))
            for b, p in pairs for l in b for k in b[l])
        # inside the restore's timed window: reported apart
        calls["check_ms"].append(1e3 * (time.perf_counter() - t0))

    kv.gather_blocks, kv.scatter_blocks = gather, scatter
    return calls


def tier_session_mix(torch, np, idle_fraction=0.5, resume_cadence=3,
                     max_sessions=36, prompt_len=88, turn_tail=16,
                     turn_gen=8, block=16, budget_blocks_bf16=56,
                     chatty_window=2, max_turns=4):
    """``bench_serving.py`` ``measure_session_mix``'s two arms on the
    32-layer Llama-2-7B geometry with phase 5's int8 tree: bf16 KV with no
    tier against int8 KV with the host tier, the same device byte budget
    (56 bf16 blocks of 16 tokens), ``max_sessions`` 36 as in the bench
    (at 16 the treatment arm never read the tier back).  A session is resident while each of its resumes is served from
    warm or restorable KV; each arm runs until the first resume that needs
    recompute (or a preemption) or the cap.  Counts set to 0 before each
    arm and read after it; the treatment arm's gathers and scatters are
    counted and each scatter checked against its payload.  Then the
    explicit round trip on two fresh treatment engines: a session grown
    the same way on both, evicted and restored on one, attached from the
    device on the other, and the next logits of each."""
    from deepspeed_tpu_torch.checkpoint import random_int8_llama_params
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)
    from deepspeed_tpu_torch.inference.v2.ragged import BlockedKVCache
    from deepspeed_tpu_torch.models import LlamaConfig
    from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler,
                                             SamplingParams)

    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)     # 32 layers
    params = random_int8_llama_params(cfg, groups=16, seed=SEED)
    max_ctx = prompt_len + max_turns * (turn_tail + turn_gen) + 16
    per_tok = {dt: BlockedKVCache(cfg.num_hidden_layers, 1, block,
                                  cfg.num_key_value_heads, cfg.head_dim,
                                  dt, device="cpu").per_token_bytes
               for dt in ("bf16", "int8")}
    budget_bytes = budget_blocks_bf16 * block * per_tok["bf16"]

    def make_engine(kv_dtype, host_tier):
        num_blocks = budget_bytes // (block * per_tok[kv_dtype]) + 1
        return InferenceEngineV2(
            RaggedLlama(cfg, block, use_kernels=True), params,
            RaggedInferenceEngineConfig.from_dict({
                "state_manager": {"max_ragged_batch_size": 256,
                                  "max_ragged_sequence_count": 4,
                                  "max_context": max_ctx},
                "kv_cache": {"block_size": block,
                             "num_blocks": int(num_blocks),
                             "dtype": kv_dtype,
                             "enable_prefix_cache": True,
                             "host_tier": host_tier}}))

    sampling = SamplingParams(greedy=True, max_new_tokens=turn_gen)

    def run_arm(kv_dtype, host_tier):
        rng = np.random.default_rng(SEED)
        eng = make_engine(kv_dtype, host_tier)
        sm = eng.state_manager
        sched = ContinuousBatchScheduler(eng)

        def turn(prompt):
            req = sched.submit(prompt, sampling=sampling)
            sched.run_until_idle()
            if req.state.value != "finished":
                raise RuntimeError(f"a session turn did not finish: "
                                   f"{req.state.value} {req.finish_reason}")
            return list(req.prompt) + list(req.generated)

        def hit_tokens():
            return sm.prefix_cache.stats.hit_tokens

        def session_prompt():
            return rng.integers(0, cfg.vocab_size,
                                size=(prompt_len,)).tolist()

        turn(session_prompt())                      # warm-up session
        gc_clock = GcClock().start()
        calls = (count_block_calls(sm.kv_cache, gc_clock) if host_tier
                 else None)
        histories, turns_done, last_touch = {}, {}, {}
        is_idle = {s: (s * 2654435761 % 100) < idle_fraction * 100
                   for s in range(max_sessions)}
        clean_through, recompute, stop = 0, 0, "cap"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()

        def resume(sid, round_no):
            nonlocal recompute
            prev = histories[sid]
            expected = ((len(prev) - 1) // block) * block
            tail = rng.integers(0, cfg.vocab_size,
                                size=(turn_tail,)).tolist()
            before = hit_tokens()
            histories[sid] = turn(prev + tail)
            turns_done[sid] += 1
            last_touch[sid] = round_no
            got = hit_tokens() - before
            if got < expected:
                recompute += expected - got
                return False
            return True

        for s in range(max_sessions):
            histories[s] = turn(session_prompt())
            turns_done[s], last_touch[s] = 1, s
            ok = True
            for c in range(max(0, s - chatty_window + 1), s + 1):
                if ok and not is_idle[c] and turns_done[c] < max_turns:
                    ok = resume(c, s)
            if ok and (s + 1) % resume_cadence == 0:
                idle_live = [x for x in range(s + 1)
                             if is_idle[x] and turns_done[x] < max_turns]
                if idle_live:
                    ok = resume(min(idle_live, key=lambda x: last_touch[x]),
                                s)
            if not ok:
                stop = "recompute"
                break
            if sched.metrics.preemptions > 0:
                stop = "preemption"
                break
            clean_through = s + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gc_clock.stop()
        out = {"kv_dtype": kv_dtype, "host_tier": host_tier,
               "gc_s": gc_clock.total,
               "kv_blocks": sm.allocator.num_blocks,
               "block_bytes": block * per_tok[kv_dtype],
               "max_resident_sessions": clean_through, "stop": stop,
               "recompute_tokens": recompute, "wall_s": wall,
               "launches": read_launches()}
        if host_tier:
            st = sm.host_tier.stats
            out.update({
                "spooled_blocks": st.spooled_blocks,
                "restored_blocks": st.restored_blocks,
                "dropped_blocks": st.dropped_blocks,
                "tier_bytes": sm.host_tier.bytes,
                "spool_ms_p50": 1e3 * st.spool_pct(50),
                "spool_ms_p95": 1e3 * st.spool_pct(95),
                "restore_ms_p50": 1e3 * st.restore_pct(50),
                "restore_ms_p95": 1e3 * st.restore_pct(95),
                "spool_ms": [1e3 * x for x in st.spool_s],
                "spool_blocks": list(st.spool_blocks_per_call),
                "spool_calls": len(st.spool_s),
                "restore_calls": len(st.restore_s),
                "spool_blocks_per_call_max": st.spool_blocks_pct(100),
                "restore_blocks_per_call_max": st.restore_blocks_pct(100),
                "gather_calls": len(calls["gather"]),
                "gathered_blocks": sum(calls["gather"]),
                "scatter_calls": len(calls["scatter"]),
                "scattered_blocks": sum(calls["scatter"]),
                "scatter_mismatches": calls["scatter_mismatch"],
                "spool_drain_ms": calls["drain_ms"],
                "spool_gather_ms": calls["gather_ms"],
                "spool_gc_ms": calls["gc_ms"],
                "spool_traces": calls["traces"],
                "restore_ms": [1e3 * x for x in st.restore_s],
                "restore_check_ms": calls["check_ms"]})
        del sched, eng
        torch.cuda.empty_cache()
        return out

    baseline = run_arm("bf16", False)
    treatment = run_arm("int8", True)

    # the explicit round trip: one session grown token by token on two
    # fresh treatment engines
    rng = np.random.default_rng(SEED + 26)
    prompt = rng.integers(0, cfg.vocab_size, size=(prompt_len,)).tolist()
    fed = rng.integers(0, cfg.vocab_size, size=(turn_gen,)).tolist()
    tail = rng.integers(0, cfg.vocab_size, size=(turn_tail,)).tolist()
    hist = prompt + fed
    logits = {}
    trip = {}
    for side in ("restored", "never_evicted"):
        eng = make_engine("int8", True)
        sm = eng.state_manager
        eng.put([1], [prompt])
        for t in fed:
            eng.put([1], [[t]])
        n_full = len(hist) // block
        pre = sm.kv_cache.gather_blocks(list(sm.get_sequence(1).blocks)
                                        [:n_full])
        eng.flush([1])
        calls = count_block_calls(sm.kv_cache)
        if side == "restored":
            trip["evicted"] = sm.prefix_cache.evict(n_full)
        attached = eng.attach_prefix(1, hist + tail)
        post = sm.kv_cache.gather_blocks(list(sm.get_sequence(1).blocks)
                                         [:n_full])
        torch.cuda.synchronize()
        row = eng.put([1], [(hist + tail)[attached:]])[1]
        logits[side] = torch.as_tensor(np.asarray(row))
        trip[side] = {
            "attached": attached,
            "gather_calls_before_check": calls["gather"][:-1],
            "scatter_calls": calls["scatter"],
            "scatter_mismatches": calls["scatter_mismatch"],
            "round_trip_bit_exact": all(
                torch.equal(pre[l][k], post[l][k])
                for l in pre for k in pre[l]),
            "restored_blocks": sm.host_tier.stats.restored_blocks,
            "spool_ms": [1e3 * x for x in sm.host_tier.stats.spool_s],
            "restore_ms": [1e3 * x for x in sm.host_tier.stats.restore_s],
            "restore_check_ms": calls["check_ms"]}
        eng.flush([1])
        del eng
        torch.cuda.empty_cache()
    diff = (logits["restored"] - logits["never_evicted"]).abs()
    trip["continuation_bit_equal"] = bool(torch.equal(
        logits["restored"], logits["never_evicted"]))
    trip["continuation_max_abs_diff"] = float(diff.max())
    trip["blocks"] = len(hist) // block
    del params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_hidden_layers, "block": block,
            "budget_bytes": budget_bytes, "max_sessions": max_sessions,
            "per_token_bytes": per_tok, "baseline": baseline,
            "treatment": treatment, "round_trip": trip}


def tier_failures(run) -> list:
    """The bars of phase 26 that ``run`` misses (empty when it passes)."""
    bad = []
    t, b, trip = run["treatment"], run["baseline"], run["round_trip"]
    for arm in (b, t):
        keys = TIER_KERNELS[arm["kv_dtype"]]
        if not all(arm["launches"][k] > 0 for k in keys):
            bad.append(f"{arm['kv_dtype']} arm launches {arm['launches']}")
    # the mix reads the tier back: a resumed session's spooled blocks
    if not (t["restored_blocks"] > 0 and t["restore_calls"] > 0):
        bad.append(f"the session mix never restored from the tier "
                   f"({t['spooled_blocks']} blocks spooled)")
    # one gather a spool, one scatter a restore
    if (t["gather_calls"], t["gathered_blocks"]) != (
            t["spool_calls"], t["spooled_blocks"]) \
            or (t["scatter_calls"], t["scattered_blocks"]) != (
                t["restore_calls"], t["restored_blocks"]):
        bad.append(f"calls: gathers {t['gather_calls']} ({t['gathered_blocks']}"
                   f" blocks) for {t['spool_calls']} spools "
                   f"({t['spooled_blocks']}), scatters {t['scatter_calls']} "
                   f"({t['scattered_blocks']}) for {t['restore_calls']} "
                   f"restores ({t['restored_blocks']})")
    if t["scatter_mismatches"]:
        bad.append(f"{t['scatter_mismatches']} restored leaves differ from "
                   f"their spooled payload")
    r = trip["restored"]
    if trip["evicted"] != trip["blocks"] or r["restored_blocks"] \
            != trip["blocks"] or r["gather_calls_before_check"] != [
                trip["blocks"]] or r["scatter_calls"] != [trip["blocks"]]:
        bad.append(f"round trip: evicted {trip['evicted']}, restored "
                   f"{r['restored_blocks']} of {trip['blocks']} blocks, "
                   f"spool gathers {r['gather_calls_before_check']}, "
                   f"restore scatters {r['scatter_calls']}")
    if not (r["round_trip_bit_exact"]
            and trip["never_evicted"]["round_trip_bit_exact"]) \
            or r["scatter_mismatches"]:
        bad.append("the spool round trip is not bit-exact")
    if r["attached"] != trip["never_evicted"]["attached"]:
        bad.append(f"attached {r['attached']} vs "
                   f"{trip['never_evicted']['attached']} tokens")
    if not trip["continuation_bit_equal"]:
        bad.append(f"the continuation after a restore differs from the "
                   f"never-evicted run by {trip['continuation_max_abs_diff']}")
    return bad


CKPT_STEPS = 4


def checkpoint_run(torch, np, dev):
    """Phase 27.  Training: the 12-layer bench model (bench.py:84-100) for
    4 steps, ``save_checkpoint`` (through ``CheckpointEngine`` and
    ``AsyncCheckpointEngine``, two tags), 4 more steps: the straight run.
    A second straight run of 8 steps says whether two straight runs are
    bit-equal.  For each tag a fresh engine built through ``initialize``
    (from another seed) loads it and takes the last 4 steps.  Then a tag
    saved after step 8 is corrupted and ``load_checkpoint`` must fall back
    to the newest verified tag.  Serving: Llama-2-7B width at 2 layers
    with int8 records through ``serialize`` -> ``load_serialized``, the
    next-token logits of both engines."""
    import gc
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import (AsyncCheckpointEngine,
                                                CheckpointEngine,
                                                random_int8_llama_params)
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.model_implementations import (
        RaggedLlama)
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = bench_llama(torch, 12)
    rng = np.random.default_rng(SEED + 27)
    batches = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(8, 1024)).astype(np.int32)).to(dev)
        for _ in range(2 * CKPT_STEPS)]

    def engine(seed):
        model = LlamaForCausalLM(cfg, seed=seed, device=dev)
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config=BENCH_DS_CONFIG, device=dev)
        return eng

    def steps(eng, which):
        return [float(train_step(eng, batches[i])) for i in which]

    def masters(eng):
        return [m.detach().clone() for m in eng.master]

    def dir_bytes(path):
        return sum(p.stat().st_size for p in Path(path).rglob("*")
                   if p.is_file())

    gc.collect()
    torch.cuda.empty_cache()
    straight = engine(SEED)
    losses = steps(straight, range(CKPT_STEPS))
    torch.cuda.synchronize()
    saves = {}
    for tag, ce in (("sync", CheckpointEngine()),
                    ("async", AsyncCheckpointEngine())):
        straight.checkpoint_engine = ce
        t0 = time.perf_counter()
        straight.save_checkpoint(str(root), tag=f"{tag}{CKPT_STEPS}")
        saves[tag] = {"save_s": time.perf_counter() - t0,
                      "bytes": dir_bytes(root / f"{tag}{CKPT_STEPS}")}
    straight.checkpoint_engine = None
    # where a save's time goes: the device -> host copy of the state and
    # the CRC32 pass over the written tag
    from deepspeed_tpu_torch.checkpoint.engine import engine_state_trees
    from deepspeed_tpu_torch.resilience import manifest

    t0 = time.perf_counter()
    engine_state_trees(straight)
    host_copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verified = manifest.verify_tag(str(root / f"sync{CKPT_STEPS}"), "full")
    crc_s = time.perf_counter() - t0
    reset_launches()
    losses += steps(straight, range(CKPT_STEPS, 2 * CKPT_STEPS))
    straight_launches = read_launches(TRAINING)
    final = masters(straight)
    # the tag the fallback walks back past
    straight.save_checkpoint(str(root), tag=f"late{2 * CKPT_STEPS}")
    del straight
    gc.collect()
    torch.cuda.empty_cache()
    again = engine(SEED)
    losses2 = steps(again, range(2 * CKPT_STEPS))
    final2 = masters(again)
    del again
    gc.collect()
    torch.cuda.empty_cache()

    def distance(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    straight_bit_equal = losses == losses2 and distance(final, final2) == 0
    straight_distance = distance(final, final2)
    resumed = {}
    for tag in ("sync", "async"):
        eng = engine(SEED + 1)
        t0 = time.perf_counter()
        path, client = eng.load_checkpoint(str(root), tag=f"{tag}{CKPT_STEPS}")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        on_device = all(m.device == dev for m in eng.master) and all(
            t.device == dev for v in eng.opt_state.values() for t in v)
        reset_launches()
        tail = steps(eng, range(CKPT_STEPS, 2 * CKPT_STEPS))
        launches = read_launches(TRAINING)
        dist = distance(masters(eng), final)
        resumed[tag] = {
            **saves[tag], "load_s": load_s, "loaded": path is not None,
            "global_steps_after_load": client.get("global_steps"),
            "on_device": on_device, "losses": tail,
            "loss_max_diff": max(abs(a - b) for a, b in
                                 zip(tail, losses[CKPT_STEPS:])),
            "bit_equal": tail == losses[CKPT_STEPS:] and dist == 0,
            "master_distance": dist, "launches": launches}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # a corrupted newest tag: the load falls back to the newest verified
    # tag below it
    shard = root / f"late{2 * CKPT_STEPS}" / \
        "zero_pp_rank_0_mp_rank_00_states.npz"
    with open(shard, "r+b") as f:
        f.seek(shard.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    eng = engine(SEED + 1)
    t0 = time.perf_counter()
    path, _ = eng.load_checkpoint(str(root))
    fallback = {"loaded": None if path is None else Path(path).name,
                "load_s": time.perf_counter() - t0,
                "latest": (root / "latest").read_text().strip()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # serving: serialize -> load_serialized at 7B width, 2 layers, int8
    scfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16, num_hidden_layers=2)
    params = random_int8_llama_params(scfg, groups=16, seed=SEED)
    src = InferenceEngineV2(RaggedLlama(scfg, 128), params,
                            serving_engine_config(512))
    prompt = np.random.default_rng(SEED).integers(
        0, scfg.vocab_size, size=200).tolist()
    want = torch.as_tensor(np.asarray(src.put([1], [prompt])[1]))
    t0 = time.perf_counter()
    src.serialize(str(root / "serve"))
    save_s = time.perf_counter() - t0
    del src, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dst = InferenceEngineV2.load_serialized(
        str(root / "serve"), RaggedLlama(scfg, 128),
        serving_engine_config(512))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = torch.as_tensor(np.asarray(dst.put([1], [prompt])[1]))
    serving = {"layers": 2, "save_s": save_s, "load_s": load_s,
               "bytes": dir_bytes(root / "serve"),
               "params_on_device": all(
                   t.device == dev for t in _leaves(dst.params)),
               "logits_bit_equal": bool(torch.equal(got, want)),
               "logits_max_abs_diff": float((got - want).abs().max())}
    del dst
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return {"training": {
        "layers": cfg.num_hidden_layers, "batch": [8, 1024],
        "steps": 2 * CKPT_STEPS, "losses": losses,
        "straight_bit_equal": straight_bit_equal,
        "straight_distance": straight_distance,
        "straight_loss_max_diff": max(abs(a - b)
                                      for a, b in zip(losses, losses2)),
        "launches": straight_launches, "resumed": resumed,
        "host_copy_s": host_copy_s, "crc_s": crc_s,
        "verified": verified[0],
        "fallback": fallback}, "serving": serving}


def checkpoint_failures(run) -> list:
    """The bars of phase 27 that ``run`` misses (empty when it passes)."""
    bad = []
    tr = run["training"]
    if not all(math.isfinite(x) for x in tr["losses"]):
        bad.append(f"losses {tr['losses']}")
    for tag, r in tr["resumed"].items():
        if not (r["loaded"] and r["on_device"]
                and r["global_steps_after_load"] == CKPT_STEPS):
            bad.append(f"{tag}: load {r}")
        if tr["straight_bit_equal"]:
            if not r["bit_equal"]:
                bad.append(f"{tag}: the resumed run is not bit-equal to "
                           f"the straight run (which repeats bit for bit): "
                           f"loss diff {r['loss_max_diff']}, master "
                           f"distance {r['master_distance']}")
        elif r["loss_max_diff"] > LOSS_TOL \
                or r["master_distance"] > tr["straight_distance"]:
            bad.append(f"{tag}: the resumed run is off the straight run "
                       f"by loss {r['loss_max_diff']} (bar {LOSS_TOL}) and "
                       f"master {r['master_distance']} (two straight runs "
                       f"{tr['straight_distance']})")
        if not all(v > 0 for v in r["launches"].values()):
            bad.append(f"{tag}: flash launches {r['launches']}")
    if not tr["verified"]:
        bad.append("a saved tag fails its own manifest")
    if tr["fallback"]["loaded"] != f"sync{CKPT_STEPS}" \
            and tr["fallback"]["loaded"] != f"async{CKPT_STEPS}":
        bad.append(f"fallback past the corrupted tag: {tr['fallback']}")
    sv = run["serving"]
    if not (sv["logits_bit_equal"] and sv["params_on_device"]):
        bad.append(f"serving: {sv}")
    return bad


# --------------------------------------------------------------------- #
def main() -> int:
    if not (ROOT / "deepspeed_tpu_torch" / "csrc").is_dir():
        return fail("deepspeed_tpu_torch/ not found beside chip_smoke.py: "
                    "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no GPU")

    # 1. environment
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from deepspeed_tpu_torch.ops import _build

    t0 = time.perf_counter()
    planted_builds = start_planted_builds()
    bsa_planted_builds = start_planted_builds("block_sparse_attention",
                                              BSA_PLANTED)
    secs = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall; per source "
          f"{ {k: round(v, 1) for k, v in secs.items()} }", flush=True)
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas {src}] {line.strip()}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # the cases of PRs 1-9 draw from `gen` in their old order (the same
    # inputs as before); PR 10's from their own generator
    gen_new = torch.Generator(device=dev)
    gen_new.manual_seed(SEED + 10)
    gen_long = torch.Generator(device=dev)       # the long decode / verify cases
    gen_long.manual_seed(SEED + 11)
    gen_gmm = torch.Generator(device=dev)        # the skewed / forward gmm cases
    gen_gmm.manual_seed(SEED + 14)
    cases = (qmm_cases(torch, gen, dev, QMM_CASES[:8])
             + attention_cases(torch, gen, dev)
             + mixtral_attention_cases(torch, gen, dev)
             + gmm_cases(torch, gen, dev)
             + gmm_backward_cases(torch, gen, dev, gen_gmm)
             + qmm_cases(torch, gen_new, dev, QMM_CASES[8:])
             + b5_cases(torch, gen_new, dev)
             + long_cases(torch, gen_long, dev)
             + gmm_training_forward_cases(torch, gen_gmm, dev))
    for c in cases:
        extra = "".join(f" {k} {c[k]}" for k in ("pad_max_abs", "k_splits",
                                                 "tile_rows", "grid",
                                                 "bit_equal",
                                                 "zeros_max_abs",
                                                 "boundary_mac_waste",
                                                 "tflops", "library")
                        if k in c)
        print(f"[kernel] {c['name']}: err {c['max_abs_err']:.3g} "
              f"norm err {c['norm_rel_err']:.3g} ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
              f"library {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']}){extra}", flush=True)
        if "launch" in c:
            print(f"  [launch] {c['launch']}", flush=True)
    bad = [c["name"] for c in cases if not (c["max_abs_err"] <= TOL
                                            and c["norm_rel_err"] <= NORM_TOL)
           or c.get("pad_max_abs", 0.0) != 0.0
           or c.get("zeros_max_abs", 0.0) != 0.0
           or not c.get("bit_equal", True)]
    if bad:
        return fail(f"kernels disagree with their plain versions (or a pad "
                    f"row of the tiled prefill, a grouped GEMM forward or "
                    f"dlhs row past the groups or an empty group's drhs "
                    f"block is not zero, or two runs of the decode / verify "
                    f"or a grouped GEMM kernel or the skinny int8 matmul "
                    f"differ): {bad}")
    skinny_goals = qmm_skinny_goals(cases)
    print(f"[qmm-goals] {json.dumps(skinny_goals)}", flush=True)

    # 4. slice end to end: kernels vs plain paths, 2 layers at 7B width
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 32000, size=256).tolist() for _ in range(8)]
    e2e = slice_kernel_vs_plain(torch, np, prompts)
    print(f"[slice] {json.dumps(e2e)}", flush=True)
    if not e2e["logits_rel_err"] <= TOL or not e2e["finite"]:
        return fail(f"kernel path logits differ from the plain path: "
                    f"{e2e['logits_rel_err']}")
    if any(v == 0 for v in e2e["kernel_launches"].values()) or any(
            e2e["plain_launches"].values()):
        return fail(f"launch counts: kernel path {e2e['kernel_launches']}, "
                    f"plain path {e2e['plain_launches']}")

    # 5. the served run (counts reset just before, read just after)
    served = served_run(torch, prompts)
    print(f"[served] {json.dumps(served)}", flush=True)
    launches = dict(served["launches"])
    if any(v == 0 for v in launches.values()):
        return fail(f"a kernel of the serving path never launched: "
                    f"{launches}")
    if not (served["finite"] and served["tokens_in_vocab"]
            and served["tokens_shape"] == [8, 48]):
        return fail(f"served output malformed: {served}")

    # 6. flash-attention kernels against their plain versions
    flash = [flash_case(torch, gen, dev, *c) for c in FLASH_CASES]
    for c in flash:
        rel, norm_rel = ({k: float(f"{v:.3g}") for k, v in c[e].items()}
                         for e in ("rel_err", "norm_rel_err"))
        print(f"[flash] {c['name']}: rel err {rel} norm rel err {norm_rel}"
              f" | ms fwd {c['ms']['fwd']:.4f} fwd+bwd "
              f"{c['ms']['fwd+bwd']:.4f} (dq {c['ms']['bwd_dq']:.4f} dkv "
              f"{c['ms']['bwd_dkv']:.4f}) | plain fwd "
              f"{c['plain_ms']['fwd']:.3f} fwd+bwd "
              f"{c['plain_ms']['fwd+bwd']:.3f} | library fwd "
              f"{c['library_ms']['fwd']:.4f} fwd+bwd "
              f"{c['library_ms']['fwd+bwd']:.4f} bwd "
              f"{c['library_ms']['bwd']:.4f} | bound fwd "
              f"{c['bound_ms']['fwd']:.4f} fwd+bwd "
              f"{c['bound_ms']['fwd+bwd']:.4f} "
              f"({c['bound_by']['fwd+bwd']}) | reproducible "
              f"{c['reproducible']}", flush=True)
        print_launches(c)
    bad = [c["name"] for c in flash
           if not all(v <= TOL for v in c["rel_err"].values())
           or not all(v <= NORM_TOL for v in c["norm_rel_err"].values())
           or not c["reproducible"]]
    if bad:
        return fail(f"flash kernels disagree with their plain versions, or "
                    f"two runs differ: {bad}")

    # 7. the training slice: kernels vs plain versions, 2 layers
    t_slice = training_kernel_vs_plain(torch, np, dev)
    print(f"[train-slice] {json.dumps(t_slice)}", flush=True)
    if not t_slice["loss_rel_err"] <= LOSS_TOL or not all(
            math.isfinite(x) for x in t_slice["kernel_losses"]):
        return fail(f"kernel-path losses differ from the plain path: "
                    f"{t_slice}")
    grad_rel = t_slice["attn_grad_norm_rel_err"]
    if not t_slice["logits_norm_rel_err"] <= LOGITS_TOL or len(
            grad_rel) != 6 or not all(v <= GRAD_TOL
                                      for v in grad_rel.values()) or any(
            not d["kernel"] <= FP32_RATIO * d["plain"]
            for d in (t_slice["logits_vs_fp32"],
                      t_slice["attn_grad_vs_fp32"])):
        return fail(f"kernel-path logits or attention gradients differ "
                    f"from the plain path: {t_slice}")
    if any(v == 0 for v in t_slice["kernel_launches"].values()) or any(
            t_slice["plain_launches"].values()):
        return fail(f"launch counts: kernel path "
                    f"{t_slice['kernel_launches']}, plain path "
                    f"{t_slice['plain_launches']}")

    # 8. the trained run (counts reset just before the timed steps)
    trained = trained_run(torch, np, dev)
    print(f"[trained] {json.dumps(trained)}", flush=True)
    if not (trained["finite"]
            and trained["last_loss"] < trained["first_loss"]):
        return fail(f"training did not converge: {trained['losses']}")
    if any(v != 12 for v in trained["launches_per_step"].values()):
        return fail(f"flash kernel launches per step are not 12 each: "
                    f"{trained['launches_per_step']}")

    # 9. the speculative slice: kernels vs plain paths, 2 layers, int8 KV
    spec = speculative_kernel_vs_plain(torch, np, prompts)
    print(f"[spec-slice] {json.dumps(spec)}", flush=True)
    if not (spec["verify_rel_err"] <= TOL
            and spec["verify_vs_decode_rel_err"] <= TOL and spec["finite"]):
        return fail(f"kernel-path verify logits differ from the plain path "
                    f"or from sequential decode: {spec}")
    if any(v == 0 for v in spec["kernel_launches"].values()) or any(
            spec["plain_launches"].values()):
        return fail(f"launch counts: kernel path {spec['kernel_launches']}, "
                    f"plain path {spec['plain_launches']}")
    if any(a != b for a, b in spec["free_blocks_after_reject"].values()):
        return fail(f"a rejected verify pass left blocks behind: "
                    f"{spec['free_blocks_after_reject']}")

    # 10. the speculative served run (counts reset just before, read after)
    spec_run = speculative_served_run(torch, np)
    print(f"[spec-served] {json.dumps(spec_run)}", flush=True)
    spec_l, ref_l = spec_run["spec_launches"], spec_run["decode_loop_launches"]
    if any(spec_l[k] == 0 for k in INT8_SPEC_RUN) \
            or any(ref_l[k] == 0 for k in INT8_DECODE_RUN):
        return fail(f"a kernel of the speculative path never launched: "
                    f"speculative run {spec_l}, decode_loop run {ref_l}")
    if not (spec_run["finite"] and spec_run["tokens_in_vocab"]
            and spec_run["all_blocks_free"]):
        return fail(f"speculative served output malformed: {spec_run}")
    # each int8 kernel's count from a run that serves with it: prefill and
    # verify from the speculative run, decode from the decode_loop run
    launches.update({k: spec_l[k] for k in ("paged_attention_int8",
                                            "paged_verify_attention_int8")})
    launches["paged_decode_attention_int8"] = ref_l[
        "paged_decode_attention_int8"]

    # 11. Mixtral at full width, 2 layers: kernels vs plain paths
    mix = mixtral_kernel_vs_plain(torch, np, prompts)
    print(f"[mixtral-slice] {json.dumps(mix)}", flush=True)
    missed = mixtral_slice_failures(mix)
    if missed:
        return fail(f"Mixtral kernel-path logits differ from the plain "
                    f"path: {'; '.join(missed)}")
    if any(v == 0 for v in mix["kernel_launches"].values()) \
            or mix["kernel_other_launches"] \
            or any(mix["plain_launches"].values()) \
            or not mix["verify"]["verify_launches"].get("paged_attention"):
        return fail(f"Mixtral launch counts: kernel path "
                    f"{mix['kernel_launches']} (others "
                    f"{mix['kernel_other_launches']}), plain path "
                    f"{mix['plain_launches']}, verify "
                    f"{mix['verify']['verify_launches']}")

    # 12. Mixtral served at full width, 16 of 32 layers (counts reset just
    # before, read just after)
    mixtral = mixtral_served_run(torch, np, prompts)
    print(f"[mixtral-served] {json.dumps(mixtral)}", flush=True)
    if mixtral["prefill_trace"] is not None:
        print(f"[mixtral-served] traced 2 x 256 prefill: device "
              f"{mixtral['prefill_trace']['device_busy_ms_per_step']:.2f} ms,"
              f" grouped GEMM {mixtral['prefill_gmm_ms']:.2f} ms by kernel "
              f"{json.dumps(mixtral['prefill_trace']['grouped_gemm_ms_per_step'])}"
              f"; bounds: the grouped GEMMs "
              f"{mixtral['prefill_gmm_bound_ms']:.2f} ms, the forward "
              f"{mixtral['prefill_forward_bound_ms']:.2f} ms", flush=True)
    mix_l = mixtral["launches"]
    want_l = mixtral["expected_launches"]
    if any(mix_l[k] != v for k, v in want_l.items()) or any(
            v for k, v in mix_l.items() if k not in want_l):
        return fail(f"Mixtral served launches {mix_l}, expected {want_l} "
                    f"and no other kernel")
    if not (mixtral["finite"] and mixtral["tokens_in_vocab"]
            and mixtral["all_blocks_free"]
            and mixtral["tokens_shape"] == [8, 47]):
        return fail(f"Mixtral served output malformed: {mixtral}")

    # 13. MoE training at full width, 2 layers: kernels vs plain versions
    moe_layer = moe_layer_kernel_vs_plain(torch, dev)
    print(f"[moe-layer] {json.dumps(moe_layer)}", flush=True)
    moe_model = moe_model_kernel_vs_plain(torch, np, dev)
    print(f"[moe-slice] {json.dumps(moe_model)}", flush=True)
    missed = moe_training_failures(moe_layer, moe_model)
    if missed:
        return fail(f"MoE training through the kernels differs from the "
                    f"plain path: {'; '.join(missed)}")
    if any(v == 0 for v in moe_layer["kernel_launches"].values()) \
            or any(v == 0 for v in moe_model["kernel_launches"].values()) \
            or moe_model["kernel_other_launches"] \
            or any(moe_layer["plain_launches"].values()) \
            or any(moe_model["plain_launches"].values()):
        return fail(f"MoE training launch counts: layer {moe_layer}, model "
                    f"kernel path {moe_model['kernel_launches']} (others "
                    f"{moe_model['kernel_other_launches']}), plain path "
                    f"{moe_model['plain_launches']}")

    # 14-15. MoE trained at full width, 2 layers, through initialize ->
    # engine: dropless, then capacity top-2 (counts reset just before the
    # timed steps, read just after)
    moe_runs = {}
    for phase, dropless in ((14, True), (15, False)):
        run = moe_trained_run(torch, np, dev, dropless)
        print(f"[moe-trained {run['model']}] {json.dumps(run)}", flush=True)
        if run["trace"] is not None:
            print(f"[moe-trained {run['model']}] traced step "
                  f"{run['trace']['wall_ms_per_step']:.2f} ms, grouped GEMM "
                  f"device ms by kernel: "
                  f"{json.dumps(run['trace']['grouped_gemm_ms_per_step'])}",
                  flush=True)
        if not (run["finite"] and run["last_loss"] < run["first_loss"]):
            return fail(f"phase {phase}: MoE training did not converge: "
                        f"{run['losses']}")
        got_l, want_l = run["launches"], run["expected_launches"]
        if any(got_l[k] != v for k, v in want_l.items()) or any(
                v for k, v in got_l.items() if k not in want_l):
            return fail(f"phase {phase}: launches {got_l}, expected "
                        f"{want_l} and no other kernel")
        moe_runs[run["model"]] = run
    moe_l = moe_runs["dropless"]["launches"]

    # 16. the strided mode against the plain versions and the contiguous
    # mode, at GPT-2's and the other training shapes
    strided = [flash_case(torch, gen, dev, *c) for c in STRIDED_CASES]
    for c in strided:
        print(f"[strided] {c['name']}: norm rel err "
              f"{ {k: float(f'{v:.3g}') for k, v in c['norm_rel_err'].items()} }"
              f" bit-equal {all(c['bit_equal_to_contiguous'].values())} | "
              f"ms fwd+bwd {c['ms']['fwd+bwd']:.4f} contiguous+copies "
              f"{c['ms']['fwd+bwd contiguous + copies']:.4f} | plain "
              f"{c['plain_ms']['fwd+bwd']:.3f} | SDPA "
              f"{c['library_ms']['fwd+bwd']:.4f} | bound "
              f"{c['bound_ms']['fwd+bwd']:.4f} ({c['bound_by']['fwd+bwd']})"
              f" | ms fwd {c['ms']['fwd']:.4f} dq {c['ms']['bwd_dq']:.4f} "
              f"dkv {c['ms']['bwd_dkv']:.4f} | SDPA fwd "
              f"{c['library_ms']['fwd']:.4f} bwd {c['library_ms']['bwd']:.4f}"
              f" | reproducible {c['reproducible']}", flush=True)
        print_launches(c)
    bad = [c["name"] for c in strided
           if not all(v <= TOL for v in c["rel_err"].values())
           or not all(v <= NORM_TOL for v in c["norm_rel_err"].values())
           or not all(c["bit_equal_to_contiguous"].values())
           or not c["reproducible"]]
    if bad:
        return fail(f"strided flash kernels disagree with their plain "
                    f"versions or with the contiguous mode, or two runs "
                    f"differ: {bad}")

    # 17. the slice checked: GPT-2-125M, 12 layers, paired; kernels vs
    # plain vs fp32, and the folded and bshd layouts against paired
    g_slice = gpt2_kernel_vs_plain(torch, np, dev)
    print(f"[gpt2-slice] {json.dumps(g_slice)}", flush=True)
    grad_rel = g_slice["c_attn_grad_norm_rel_err"]
    if not (g_slice["finite"] and g_slice["loss_rel_err"] <= LOSS_TOL
            and g_slice["logits_norm_rel_err"] <= LOGITS_TOL
            and len(grad_rel) == 24          # 12 c_attn weights, 12 biases
            and all(v <= GRAD_TOL for v in grad_rel.values())
            and all(d["kernel"] <= FP32_RATIO * d["plain"]
                    for d in (g_slice["logits_vs_fp32"],
                              g_slice["c_attn_grad_vs_fp32"]))):
        return fail(f"GPT-2 kernel path differs from the plain path: "
                    f"{g_slice}")
    want_k = {k: (36 if k in FLASH_BY_ENTRY["paired"] else 0)
              for k in ALL_FLASH}
    if g_slice["kernel_launches"] != want_k or any(
            g_slice["plain_launches"].values()) or any(
            d["launches"] != {k: (36 if k in FLASH_BY_ENTRY[lay] else 0)
                              for k in ALL_FLASH}
            for lay, d in g_slice["layouts_vs_paired"].items()):
        return fail(f"GPT-2 slice launches: paired "
                    f"{g_slice['kernel_launches']}, plain "
                    f"{g_slice['plain_launches']}, others "
                    f"{g_slice['layouts_vs_paired']}")

    # 18. the trained runs under each layout (counts reset just before
    # the timed steps, read just after)
    runs = {}
    for kind, layout, heads, batch in LAYOUT_RUNS:
        run = trained_run(torch, np, dev, kind=kind, layout=layout,
                          heads=heads, batch=batch,
                          traced=(kind, layout) == ("gpt2", "paired"))
        key = f"{kind} {layout} H{heads} B{batch}"
        print(f"[layout-trained {key}] {json.dumps(run)}", flush=True)
        if not (run["finite"] and run["last_loss"] < run["first_loss"]):
            return fail(f"phase 18 {key}: training did not converge: "
                        f"{run['losses']}")
        if run["launches"] != run["expected_launches"]:
            return fail(f"phase 18 {key}: launches {run['launches']}, "
                        f"expected {run['expected_launches']}")
        runs[key] = run

    # 19. the int8 quantizer kernel against its plain version, bit for bit
    qcases = quantizer_cases(torch, gen, dev)
    traced = quantizer_calls_traced()
    for c in qcases:
        x_shape = tuple(int(v) for v in c["name"].split("[")[1].split("]")[0]
                        .split(","))
        dtype = "float32" if "fp32" in c["name"] else "bfloat16"
        c["a_call"] = traced.get(f"{x_shape} {c['groups']} {dtype}")
        print(f"[quantizer] {c['name']}: bit-equal {c['bit_equal']} "
              f"(two runs {c['two_runs_bit_equal']}) max abs err "
              f"{c['max_abs_err']} ms {c['ms']:.4f} plain "
              f"{c['plain_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']}, {c['ms'] / c['bound_ms']:.2f}x) a call "
              f"{c['a_call']} plan {c['plan']}"
              + (f" zero group {c['zero_group']}" if "zero_group" in c
                 else ""), flush=True)
    bad = [c["name"] for c in qcases
           if not (c["bit_equal"] and c["two_runs_bit_equal"])
           or c.get("zero_group") is False]
    if bad:
        return fail(f"the quantizer kernel's q or scales differ from its "
                    f"plain version: {bad}")
    bad = [(c["name"], c["a_call"]) for c in qcases if c["a_call"] is None
           or (c["a_call"]["kernels"], c["a_call"]["memsets"]) != (1, 0)]
    if bad:
        return fail(f"the quantizer is not one launch and no memset a "
                    f"call: {bad}")

    # 20. from_hf of a 2-layer Llama-2-7B checkpoint, int8 and bf16
    hf = from_hf_run(torch, np, dev, prompts)
    print(f"[from-hf] {json.dumps(hf)}", flush=True)
    i8, b16 = hf["int8_serve_launches"], hf["bf16_serve_launches"]
    if hf["records"] != 15 or hf["records_not_bit_equal"]:
        return fail(f"from_hf(quantize_bits=8): {hf['records']} records, "
                    f"not the plain quantizer's bits: "
                    f"{hf['records_not_bit_equal']}")
    if hf["int8_load_quantize_launches"] != 15 \
            or hf["bf16_load_quantize_launches"] \
            or i8["quantized_matmul"] != \
            hf["expected_int8_serve_quantized_matmul"] \
            or b16["quantized_matmul"] or i8["quantize"] or b16["quantize"] \
            or not all(r["paged_attention"] and r["paged_decode_attention"]
                       for r in (i8, b16)):
        return fail(f"from_hf launches: loads "
                    f"{hf['int8_load_quantize_launches']} / "
                    f"{hf['bf16_load_quantize_launches']} quantize, served "
                    f"int8 {i8} (quantized_matmul expected "
                    f"{hf['expected_int8_serve_quantized_matmul']}), bf16 "
                    f"{b16}")
    if not (hf["finite"] and hf["tokens_in_vocab"]
            and hf["logits_norm_rel_err"] <= INT8_LOGITS_NORM_TOL):
        return fail(f"from_hf: the int8 engine's logits are "
                    f"{hf['logits_norm_rel_err']:.4g} from the bf16 "
                    f"engine's in norm (bar {INT8_LOGITS_NORM_TOL}) or not "
                    f"finite")

    # 21. Llama-2-7B quantized on the card from bf16, then served
    qserved = quantized_served_run(torch, np, dev, prompts)
    print(f"[quantized-served] {json.dumps(qserved)} | phase 5: TTFT "
          f"{served['ttft_ms']} decode ms/step "
          f"{served['decode_ms_per_step']:.2f}", flush=True)
    ql = qserved["launches"]
    if not (qserved["matrices_quantized"] == 225
            == qserved["quantize_launches"]) or ql["quantize"] \
            or ql["quantized_matmul"] != qserved["expected_quantized_matmul"] \
            or not (ql["paged_attention"] and ql["paged_decode_attention"]):
        return fail(f"phase 21 launches: {qserved['matrices_quantized']} "
                    f"matrices, {qserved['quantize_launches']} quantize "
                    f"launches (225 expected), served {ql} (quantized_matmul "
                    f"expected {qserved['expected_quantized_matmul']})")
    if not (qserved["finite"] and qserved["tokens_in_vocab"]
            and qserved["tokens_shape"] == [8, qserved["gen_tokens"]]):
        return fail(f"phase 21 served output malformed: {qserved}")

    # 22. Evoformer attention: the kernel route against the plain version;
    # the first eight cases draw from `gen` in their old order (the same
    # inputs as before), the rest from their own generator
    gen_evo = torch.Generator(device=dev)
    gen_evo.manual_seed(SEED + 13)
    evo_cases = [evoformer_case(torch, gen if i < 8 else gen_evo, dev, *c)
                 for i, c in enumerate(EVO_CASES)]
    for c in evo_cases:
        old = f"{c['old_ms']:.4f}" if c["old_ms"] is not None else "n/a"
        print(f"[evoformer] {c['name']}: route {c['route']} "
              f"{c['bias_kinds']} err {c['max_abs_err']:.3g} norm "
              f"err {c['norm_rel_err']:.3g} grads "
              f"{ {k: float(f'{v:.3g}') for k, v in c['grad_norm_rel_err'].items()} }"
              f" bit-equal {c['bit_equal']} | ms {c['ms']:.4f} old {old} "
              f"(PERF.md row 22) plain {c['plain_ms']:.4f} SDPA "
              f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
              f"({c['bound_by']})"
              + (f" 3xTF32 bound {c['bound_3xtf32_ms']:.4f}"
                 if "bound_3xtf32_ms" in c else "")
              + f" exp floor {c['exp_floor_ms']:.4f} | peak "
              f"MB kernel {c['kernel_fwd_peak_extra_mb']:.1f} dense "
              f"{c['dense_fwd_peak_extra_mb']:.1f}"
              + (f" | masked rows vs mean v {c['masked_rows_vs_mean_v']:.3g}"
                 if "masked_rows_vs_mean_v" in c else ""), flush=True)
        if "launch" in c:
            print(f"  [launch] {c['launch']}", flush=True)
    bad = [c["name"] for c in evo_cases
           if not (evo_bar_met(c["dtype"], c["max_abs_err"],
                               c["norm_rel_err"])
                   and all(v <= EVO_GRAD_NORM_TOL
                           for v in c["grad_norm_rel_err"].values())
                   and c.get("masked_rows_vs_mean_v", 0.0) <= TOL)]
    if bad:
        return fail(f"the Evoformer kernel route differs from the plain "
                    f"version: {bad}")
    bad = [(c["name"], c["fwd_launches"], c["grad_launches"])
           for c in evo_cases
           if not c["fwd_launches"] == c["grad_launches"] == {
               key: int(key == c["kernel"]) for key in EVO_KEYS.values()}]
    if bad:
        return fail(f"Evoformer launches: not one launch of the routed "
                    f"kernel a forward call (and none of the other): {bad}")
    # the tensor-core kernel takes bf16 / fp16 at d a multiple of 8 (up to
    # 128), the general kernel the rest; each gives the same bits twice
    bad = [c["name"] for c in evo_cases
           if c["route"] != ("mma" if c["dtype"] != "fp32"
                             and c["shape"][-1] % 8 == 0 else "simt")
           or not c["bit_equal"]]
    if bad:
        return fail(f"Evoformer: a case off its kernel, or two runs of a "
                    f"kernel not bit-equal: {bad}")
    evo_planted = evoformer_planted(torch, dev, planted_builds)
    for fault, errs in evo_planted.items():
        print(f"[evoformer] planted {fault} ({errs['dtype']}, route "
              f"{errs['route']}): max {errs['max_abs_err']:.3g} norm "
              f"{errs['norm_rel_err']:.3g}", flush=True)
    bad = [f for f, e in evo_planted.items() if e["meets_bar"]]
    if bad:
        return fail(f"Evoformer: planted faults meet their bar: {bad}")

    # 23. block-sparse attention (B11) at BERT width, through
    # SparseSelfAttention ("auto": the kernels, key-padding masks included)
    bsa_cases = []
    for c in BSA_CASES + (BSA_LONG,):
        r = block_sparse_case(torch, np, gen, dev, *c,
                              forward_only=c is BSA_LONG)
        bsa_cases.append(r)
        grads = r.get("grad_norm_rel_err", {})
        print(f"[block-sparse] {r['name']}: err {r['max_abs_err']:.3g} norm "
              f"{r['norm_rel_err']:.3g} grads "
              f"{ {k: float(f'{x:.3g}') for k, x in grads.items()} } fault "
              f"{r['fault_norm_rel_err']:.3g} key-major fault "
              f"{ {k: float(f'{x:.3g}') for k, x in r.get('fault_k_grad_norm_rel_err', {}).items()} }"
              + (f" dense {r['dense_norm_rel_err']:.3g}"
                 if "dense_norm_rel_err" in r else "")
              + f" | density {r['density']:.4f} "
              f"live tiles {r['live_tile_ratio']:.4f} | ms "
              f"{ {k: round(x, 4) for k, x in r['ms'].items()} } plain "
              f"{ {k: round(x, 3) for k, x in r['plain_ms'].items()} } SDPA "
              f"{ {k: round(x, 3) for k, x in r['library_ms'].items()} } "
              f"bound { {k: round(x['bound_ms'], 4) for k, x in r['bounds'].items()} }",
              flush=True)
        print(f"[block-sparse]   {r['name']}: fwd bit-equal "
              f"{r['fwd_bit_equal']}; bwd bit-equal "
              f"{r.get('bwd_bit_equal')}; forced split "
              f"{r.get('fwd_forced_split')}"
              + (f"; fp32 grads {r['grad_fp32_err']}; backward forced split "
                 f"{r['bwd_forced_split']}" if "bwd_forced_split" in r else "")
              + f"; TFLOP/s (cells / tiles) "
              f"{ {k: (round(x['cells'], 1), round(x['tiles'], 1)) for k, x in r['tflops'].items()} }",
              flush=True)
        for kname, info in r.get("launch", {}).items():
            print(f"[launch] {r['name']} {kname}: {json.dumps(info)}",
                  flush=True)
        bad = bsa_failures(r)
        if bad:
            return fail(f"phase 23 {r['name']}: {bad}")
    # the main path's launches by kernel: the fp32 cases' are the
    # split-TF32 kernels (bsa_*_split_kernel), the others' the wgmma ones
    bsa_main = {}
    for key in BSA_KEYS:
        split = sum(c["launches"][key] for c in bsa_cases
                    if c["dtype"] == "fp32")
        bsa_main[key] = sum(c["launches"][key] for c in bsa_cases) - split
        bsa_main[key + "_split"] = split
    bsa_faults = bsa_planted(torch, np, gen, dev, bsa_planted_builds)
    for fault, errs in bsa_faults.items():
        print(f"[block-sparse] planted {fault} ({errs['case']}): max "
              f"{errs['max_abs_err']:.3g} lse {errs['lse_max_abs_err']:.3g}"
              f" grads { {g: float(f'{x:.3g}') for g, x in errs['grad_errs'].items()} }",
              flush=True)
    bad = [f for f, e in bsa_faults.items()
           if e["meets_bar"] or e["grad_meets_bar"]]
    if bad:
        return fail(f"phase 23: planted faults meet an fp32 bar: {bad}")
    for c in bsa_cases:
        if c["layout"] in ("fixed", "bslongformer", "dense") \
                and c["padding"] is None \
                and c["dtype"] == "bf16" and c["shape"][2] == 4096 \
                and c["block"] == 16 and c["shape"][1] == 12:
            print(f"[block-sparse] time vs density: {c['layout']}: density "
                  f"{c['density']:.4f} live 64-tiles {c['live_tile_ratio']:.4f}"
                  f" fwd {c['ms']['fwd']:.4f} ms dQ {c['ms']['bwd_dq']:.4f} "
                  f"dK/dV {c['ms']['bwd_dkv']:.4f}", flush=True)

    # 24. the continuous-batching scheduler serving Llama-2-7B
    sched_run = scheduler_served_run(torch, np)
    print(f"[scheduler] {json.dumps({k: v for k, v in sched_run.items() if k != 'trace'})}",
          flush=True)
    print(f"[scheduler] traced ticks: {json.dumps(sched_run['trace'])}",
          flush=True)
    bad = scheduler_failures(sched_run)
    if bad:
        return fail(f"phase 24: {bad}")

    # 25. the cache-aware router over two replicas serving Llama-2-7B
    routed = router_served_run(torch, np)
    print(f"[router] {json.dumps(routed)}", flush=True)
    print(f"[router] launches: {json.dumps(routed['launches'])}", flush=True)
    print(f"[router] cold TTFT p50 {routed['cold_ttft_ms_p50']:.2f} ms, warm "
          f"{routed['warm_ttft_ms_p50']:.2f} ms; hit rate "
          f"{routed['cache_hit_rate']:.4f}; prefill tokens saved "
          f"{routed['prefill_tokens_saved']} "
          f"({routed['prefill_tokens_saved_pct']:.2f}%); by replica "
          f"{routed['requests_by_replica']}; {smi}", flush=True)
    bad = router_failures(routed)
    if bad:
        return fail(f"phase 25: {bad}")

    # 26. the host KV tier under the session mix at Llama-2-7B width
    tier = tier_session_mix(torch, np)
    print(f"[tier] {json.dumps(tier)}", flush=True)
    for arm in ("baseline", "treatment"):
        print(f"[tier] {arm} launches: "
              f"{json.dumps(tier[arm]['launches'])}", flush=True)
    t = tier["treatment"]
    print(f"[tier] max resident sessions bf16 "
          f"{tier['baseline']['max_resident_sessions']} / int8 + tier "
          f"{t['max_resident_sessions']} (max_sessions "
          f"{tier['max_sessions']}); spooled {t['spooled_blocks']} "
          f"restored {t['restored_blocks']} dropped {t['dropped_blocks']}; "
          f"spool ms p50 {t['spool_ms_p50']:.3f} p95 {t['spool_ms_p95']:.3f} "
          f"(drain of queued device work p50 "
          f"{np.percentile(t['spool_drain_ms'], 50):.3f} p95 "
          f"{np.percentile(t['spool_drain_ms'], 95):.3f}, gather p50 "
          f"{np.percentile(t['spool_gather_ms'], 50):.3f} p95 "
          f"{np.percentile(t['spool_gather_ms'], 95):.3f}); "
          f"restore ms p50 {t['restore_ms_p50']:.3f} p95 "
          f"{t['restore_ms_p95']:.3f} (the check's gather inside it p50 "
          f"{np.percentile(t['restore_check_ms'], 50):.3f}); interpreter "
          f"gc {t['gc_s']:.3f} s of the arm; bytes a block bf16 "
          f"{tier['baseline']['block_bytes']} int8 {t['block_bytes']}; "
          f"{smi}", flush=True)
    bad = tier_failures(tier)
    if bad:
        return fail(f"phase 26: {bad}")

    # 27. checkpoints: a resumed training run and a serialized engine
    ckpt = checkpoint_run(torch, np, dev)
    print(f"[checkpoint] {json.dumps(ckpt)}", flush=True)
    tr = ckpt["training"]
    print(f"[checkpoint] launches: straight "
          f"{json.dumps(tr['launches'])}; resumed "
          f"{json.dumps({k: r['launches'] for k, r in tr['resumed'].items()})}",
          flush=True)
    print(f"[checkpoint] straight runs bit-equal {tr['straight_bit_equal']}; "
          + "; ".join(f"{k}: save {r['save_s']:.2f} s load {r['load_s']:.2f} s"
                      f" {r['bytes']} bytes, bit-equal {r['bit_equal']}"
                      for k, r in tr["resumed"].items())
          + f"; fallback to {tr['fallback']['loaded']}; serialize "
          f"{ckpt['serving']['save_s']:.2f} s load_serialized "
          f"{ckpt['serving']['load_s']:.2f} s {ckpt['serving']['bytes']} "
          f"bytes; {smi}", flush=True)
    bad = checkpoint_failures(ckpt)
    if bad:
        return fail(f"phase 27: {bad}")

    src = "deepspeed_tpu_torch/csrc/"
    ref = "deepspeed_tpu/"
    bf_py = ref + "inference/v2/kernels/blocked_flash.py:"
    # B4 (paged_prefill_attention) is a route of B5's tiled kernel in
    # blocked_flash.cu, the default
    sources = {"quantized_matmul": src + "quantized_matmul.cu",
               **{k: src + "grouped_gemm.cu" for k in MOE_GMM}}
    replaces = {"quantized_matmul": ref + "ops/quantized_matmul.py:47",
                "paged_prefill_attention": bf_py + "490",
                "grouped_gemm": ref + "ops/grouped_gemm.py:92",
                "grouped_gemm_dlhs": ref + "ops/grouped_gemm.py:155",
                "grouped_gemm_drhs": ref + "ops/grouped_gemm.py:225",
                "paged_attention": bf_py + "35",
                "paged_decode_attention": bf_py + "118",
                "paged_decode_attention_int8": bf_py + "118",
                "paged_verify_attention": bf_py + "301",
                "paged_verify_attention_int8": bf_py + "301",
                # no TPU kernel: int8 prefill is an XLA path there
                "paged_attention_int8": ref + "inference/v2/"
                "model_implementations/ragged_llama.py:263"}
    kernels = [{
        "name": c["name"], "route": "cuda",
        "source": sources.get(c["kernel"], src + "blocked_flash.cu"),
        "replaces": replaces[c["kernel"]],
        "launches": {"mixtral": mix_l, "moe_training": moe_l}.get(
            c.get("path"), launches)[c["kernel"]],
        "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    } for c in cases]
    flash_kernels = {
        "fwd": (("o", "lse"), ref + "ops/flash_attention.py:119"),
        "bwd_dq": (("dq", "delta"), ref + "ops/flash_attention.py:260"),
        "bwd_dkv": (("dk", "dv"), ref + "ops/flash_attention.py:302"),
    }
    for c in flash:
        for kname, (outs, where) in flash_kernels.items():
            kernels.append({
                "name": f"flash_attention_{kname}[{c['name']}]",
                "route": "cuda", "source": src + "flash_attention.cu",
                "replaces": where,
                "launches": trained["launches"][f"flash_attention_{kname}"],
                "max_abs_err": max(c["abs_err"][o] for o in outs),
                "ms": c["ms"][kname], "plain_ms": c["plain_ms"][kname],
                "bound_ms": c["bound_ms"][kname],
                "bound_by": c["bound_by"][kname],
                # SDPA's forward computes o; one autograd call over its
                # saved forward computes dQ, dK and dV together: the
                # yardstick of both backward launches
                "library_ms": c["library_ms"]["fwd" if kname == "fwd"
                                              else "bwd"],
            })
    # B7 / B8: the strided mode through the folded and paired entries (one
    # kernel family: a case's times serve both entries); launches from
    # GPT-2's phase-18 runs under "folded" and "paired"
    fa_py = ref + "ops/flash_attention.py:"
    layout_kernels = {
        "folded": {"fwd": "568/:600", "bwd_dq": "720", "bwd_dkv": "766"},
        "paired": {"fwd": "1091/:1133", "bwd_dq": "1272",
                   "bwd_dkv": "1334"},
    }
    for c in strided:
        for entry, lines in layout_kernels.items():
            if entry == "paired" and c["shape"][5] >= 128:
                continue            # pairing applies at d < 128 only
            launched = runs[f"gpt2 {entry} H12 B8"]["launches"]
            for kname, (outs, _) in flash_kernels.items():
                kernels.append({
                    "name": f"flash_attention_{kname}_{entry}[{c['name']}]",
                    "route": "cuda", "source": src + "flash_attention.cu",
                    "replaces": fa_py + lines[kname],
                    "launches": launched[f"flash_attention_{kname}_{entry}"],
                    "max_abs_err": max(c["abs_err"][o] for o in outs),
                    "ms": c["ms"][kname], "plain_ms": c["plain_ms"][kname],
                    "bound_ms": c["bound_ms"][kname],
                    "bound_by": c["bound_by"][kname],
                    "library_ms": c["library_ms"]["fwd" if kname == "fwd"
                                                  else "bwd"],
                })
    for c in qcases:
        kernels.append({
            "name": f"quantize[{c['name']}]", "route": "cuda",
            "source": src + "quantizer.cu",
            "replaces": ref + "ops/quantizer.py:201",
            "launches": qserved["quantize_launches"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None,
        })
    for c in evo_cases:
        kernels.append({
            "name": f"{c['kernel']}[{c['name']}]", "route": "cuda",
            "source": src + "evoformer_attn.cu",
            "replaces": ref + "ops/evoformer_attn.py:63",
            "launches": c["fwd_launches"][c["kernel"]]
            + c["grad_launches"][c["kernel"]],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    bsa_lines = {"fwd": "82", "bwd_dq": "131", "bwd_dkv": "166"}
    bsa_outs = {"fwd": ("max_abs_err",), "bwd_dq": ("dq",),
                "bwd_dkv": ("dk", "dv")}
    for c in bsa_cases:
        for kname in c["ms"]:
            err = (c["max_abs_err"] if kname == "fwd" else
                   max(c["grad_max_abs_err"][o] for o in bsa_outs[kname]))
            # fp32: bsa_fwd_split_kernel, bsa_dq_split_kernel and
            # bsa_dkv_split_kernel
            key = f"block_sparse_attention_{kname}" \
                + ("_split" if c["dtype"] == "fp32" else "")
            kernels.append({
                "name": f"{key}[{c['name']}]",
                "route": "cuda", "source": src + "block_sparse_attention.cu",
                "replaces": ref + "ops/block_sparse_attention.py:"
                + bsa_lines[kname],
                "launches": bsa_main[key],
                "max_abs_err": err, "ms": c["ms"][kname],
                "plain_ms": c["plain_ms"][kname],
                "bound_ms": c["bounds"][kname]["bound_ms"],
                "bound_by": c["bounds"][kname]["bound_by"],
                # SDPA over the expanded mask computes the forward; one
                # autograd call over its saved forward computes dQ, dK
                # and dV together (the forward-only S = 16384 case has
                # none)
                "library_ms": c["library_ms"].get("fwd" if kname == "fwd"
                                                  else "bwd"),
            })
    record = {"kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "build_s": secs,
         "cases": cases, "qmm_skinny_goals": skinny_goals, "slice": e2e,
         "served": served, "flash": flash,
         "train_slice": t_slice, "trained": trained, "spec_slice": spec,
         "spec_served": spec_run, "mixtral_slice": mix,
         "mixtral_served": mixtral, "moe_layer": moe_layer,
         "moe_slice": moe_model, "moe_trained": moe_runs,
         "strided": strided, "gpt2_slice": g_slice, "layout_trained": runs,
         "quantizer": qcases, "from_hf": hf, "quantized_served": qserved,
         "evoformer": evo_cases, "evoformer_planted": evo_planted,
         "block_sparse": bsa_cases, "block_sparse_planted": bsa_faults,
         "scheduler": sched_run, "router": routed, "host_tier": tier,
         "checkpoint": ckpt},
        indent=1))
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(trace_quantizer() if sys.argv[1:] == ["--trace-quantizer"]
             else main())
