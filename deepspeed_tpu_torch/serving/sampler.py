"""Batched sampling over scheduler-packed logits.

Counterpart of ``deepspeed_tpu/serving/sampler.py``, with its names and behaviour
(the port keeps its own copy: it imports nothing of the JAX package).

The scheduler collects one logits row per request that completed a feed
this tick and samples them in ONE vectorised call — never one request at a
time (the per-request python loop is exactly the serving-path overhead the
reference's batched ragged ops exist to avoid).

Determinism contract: the token drawn for a request at generation position
``i`` is a pure function of (logits, sampling params, seed, uid, i).  The
request uid and position — not wall-clock tick — key the noise stream, so
(a) a preempted request that re-prefills its history draws the same
continuation it would have drawn unpreempted, PROVIDED the recomputed
logits match the incremental-decode logits (exact on the f32 CPU path;
low-precision prefill vs decode kernels may round a near-tie differently),
and (b) concurrent requests sharing a ``SamplingParams`` (and its seed)
still draw INDEPENDENT streams — without the uid in the key, two
same-prompt requests would generate identical "samples".
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from deepspeed_tpu_torch.serving.request import SamplingParams


def sample_batch(logits: np.ndarray,
                 params: Sequence[SamplingParams],
                 positions: Sequence[int],
                 uids: Sequence[int]) -> np.ndarray:
    """Sample one token per row of ``logits`` [n, vocab].

    ``params[i]`` is row i's sampling config; ``positions[i]`` its
    generation position (``len(request.generated)`` at draw time) and
    ``uids[i]`` its request uid — together with the seed they key the
    per-request noise stream.  Returns int32 tokens ``[n]``.

    Vectorised: temperature scaling, top-k masking, and the final argmax
    run as whole-batch numpy ops; only the per-row Gumbel noise streams
    are generated per request (they must be, for per-request seeds).
    """
    logits = np.asarray(logits, np.float32)
    if logits.ndim != 2:
        raise ValueError(f"sample_batch: logits must be [n, vocab], "
                         f"got shape {logits.shape}")
    n, vocab = logits.shape
    if len(params) != n or len(positions) != n or len(uids) != n:
        raise ValueError(f"sample_batch: {n} rows but {len(params)} params / "
                         f"{len(positions)} positions / {len(uids)} uids")
    if n == 0:
        return np.zeros((0,), np.int32)

    greedy = np.asarray([p.greedy for p in params], bool)
    scores = logits.copy()

    stochastic = ~greedy
    if stochastic.any():
        temp = np.asarray([max(p.temperature, 1e-6) for p in params],
                          np.float32)
        scores[stochastic] = (scores[stochastic]
                              / temp[stochastic, None])
        # top-k: mask everything below each row's k-th largest score
        for i in np.nonzero(stochastic)[0]:
            k = params[i].top_k
            if 0 < k < vocab:
                kth = np.partition(scores[i], vocab - k)[vocab - k]
                scores[i][scores[i] < kth] = -np.inf
        # Gumbel-max: argmax(scores + G) ~ softmax(scores); the noise
        # stream is seeded by (request seed, uid, generation position)
        # so draws are independent of batch composition and preemption,
        # AND independent across requests sharing a SamplingParams
        noise = np.zeros_like(scores)
        for i in np.nonzero(stochastic)[0]:
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    entropy=params[i].seed,
                    spawn_key=(int(uids[i]), int(positions[i]))))
            noise[i] = rng.gumbel(size=vocab).astype(np.float32)
        scores = scores + noise

    return np.argmax(scores, axis=-1).astype(np.int32)


def sample_one(logits: np.ndarray, params: SamplingParams,
               position: int, uid: int = 0) -> int:
    """Single-row convenience wrapper over :func:`sample_batch`."""
    return int(sample_batch(np.asarray(logits)[None], [params],
                            [position], [uid])[0])
