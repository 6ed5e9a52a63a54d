"""The Evoformer tensor-core kernel's host side and walk on the CPU.

``bias_plan`` (how ``csrc/evoformer_attn.cu`` stages each bias) is held to
brute force over every broadcast pattern ``_canon_bias`` accepts: what a
bias varies over is read off its expanded values plane by plane, and
whether TMA can read its rows off the element addresses of the planes.
``evoformer_attention_tiled_plain`` (the kernel's walk: row blocks, key
steps, exp2 with log2(e), biases added by pattern, the running max guarded
at -inf) is held to the JAX package's Pallas kernel ``_evo_kernel`` run in
interpret mode, in f32, 2e-5 max abs; the general kernel's walk with its
3xTF32 products (``split``, ``tf32_split``) to the JAX package's
``evoformer_attention_dense`` in f32, 1e-5 max abs.  Inputs are made with
numpy from a seed.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attn as jevo
from deepspeed_tpu_torch.ops import evoformer_attn as tevo

FWD_TOL = 2e-5
LEAD, H, SQ = (2, 3), 2, 5


def _brute_plan(c, lead, h, sq, sk):
    """The kind and largest plane offset of canonical bias view ``c`` from
    its values and its element addresses, plane by plane."""
    full = lead + (h, sq, sk)
    e = c.expand(full)
    vals = e.reshape(-1, sq, sk)
    rows = bool((vals != vals[:, :1]).any())
    keys = bool((vals != vals[:, :, :1]).any())
    elt = c.element_size()
    offs = []
    for idx in itertools.product(*(range(n) for n in lead + (h,))):
        offs.append((e[idx + (0, 0)].data_ptr() - c.data_ptr()) // elt)
    if not keys:
        return ("row" if rows else "scalar"), max(offs)
    z = (0,) * len(lead)
    at = lambda r, col: e[z + (0, r, col)].data_ptr()  # noqa: E731
    step = (at(0, 1) - at(0, 0)) // elt
    pitch = (at(1, 0) - at(0, 0)) // elt if rows else 0
    four = (step == 1 and c.data_ptr() % 4 == 0 and (pitch * elt) % 4 == 0
            and all((o * elt) % 4 == 0 for o in offs))
    if not rows:
        return ("key_async" if four else "key_sum"), max(offs)
    tma = (step == 1 and pitch >= sk and (pitch * elt) % 16 == 0
           and c.data_ptr() % 16 == 0 and all(o % pitch == 0 for o in offs))
    return ("tile_tma" if tma else "tile_async" if four else "tile_sum"), \
        max(offs)


def _patterns(sk):
    """Every bias shape ``_canon_bias`` accepts at LEAD, H, SQ, sk: each of
    the five dims full or 1, at full rank and with its leading 1s dropped."""
    full = LEAD + (H, SQ, sk)
    for keep in itertools.product((False, True), repeat=len(full)):
        shape = tuple(n if k else 1 for n, k in zip(full, keep))
        yield shape
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
            yield shape


@pytest.mark.parametrize("sk", [16, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_plan_matches_brute_force(sk, dtype):
    """sk = 16: every tile TMA can read (rows of 32 or 64 bytes); sk = 10:
    a bf16 row pitch of 20 bytes (fp32: 40), which the lanes copy 4 bytes at
    a time."""
    gen = torch.Generator().manual_seed(sk)
    seen = set()
    for shape in _patterns(sk):
        b = torch.randn(shape, generator=gen).to(dtype)
        if b.data_ptr() % 16:
            b = b.clone()
        plan, = tevo.bias_plan([b], LEAD, H, SQ, sk)
        c = plan["view"]
        assert c.dim() == len(LEAD) + 3 and c.data_ptr() == b.data_ptr()
        want = _brute_plan(c, LEAD, H, SQ, sk)
        assert (plan["kind"], plan["max_plane"]) == want, shape
        _, sr, sc = plan["strides"]
        assert sc != 0 or plan["kind"] in ("scalar", "row")
        assert sr != 0 or plan["kind"] in ("scalar", "key_async")
        seen.add(plan["kind"])
    assert seen == {"scalar", "row", "key_async",
                    "tile_tma" if sk == 16 else "tile_async"}


def test_bias_plan_strided_views():
    """Views TMA can and cannot read: a pair bias sliced from wider rows (a
    pitch of 24 keys: TMA); 4-byte copies for a base off 16 bytes, a pitch
    of 18 bf16 keys (36 bytes) and planes that start mid-row; the fp32 sum
    for keys transposed (last stride not 1) and an odd bf16 base (2 bytes
    off); key rows likewise; each against brute force."""
    sk = 16
    wide = torch.randn((2, 1, H, SQ, 24)).bfloat16()
    flat = torch.randn(2 * H * SQ * sk + 3).bfloat16()
    cases = {
        "tile_tma": [wide[..., :sk]],
        "tile_async": [flat[2:2 + 2 * H * SQ * sk].view(2, 1, H, SQ, sk),
                       torch.randn((2, 1, H, SQ, 18)).bfloat16()[..., 2:18],
                       torch.randn((2, 1, H, SQ * sk + 8)).bfloat16()
                       [..., 8:].view(2, 1, H, SQ, sk)],
        "tile_sum": [torch.randn((2, 1, H, sk, SQ)).bfloat16()
                     .transpose(-1, -2),
                     flat[1:1 + 2 * H * SQ * sk].view(2, 1, H, SQ, sk)],
        "key_async": [flat[2:2 + 2 * H * sk].view(2, 1, H, 1, sk)],
        "key_sum": [torch.randn((2, 1, H, 1, sk, 2)).bfloat16()[..., 0],
                    flat[1:1 + 2 * H * sk].view(2, 1, H, 1, sk)],
    }
    for kind, views in cases.items():
        for b in views:
            plan, = tevo.bias_plan([b], LEAD, H, SQ, sk)
            assert plan["kind"] == kind
            assert _brute_plan(plan["view"], LEAD, H, SQ, sk) == (
                kind, plan["max_plane"])


def _inputs(lead, s, h, d, seed, biases):
    """Q/K/V and biases in f32 (numpy): "three" the mask bias [B, N, 1, 1,
    S], the pair bias [B, 1, H, S, S] and a per-row bias [B, N, H, S, 1];
    "eight" those and a scalar, a per-head value, a per-head key bias, a
    tile full in N and a tile read through transposed keys (the fp32 sum);
    "masked" the
    mask and the pair with every key of some rows at -1e9 (uniform: the
    mean of v) and every key of one row at -inf (zeros)."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(lead + (s, h, d)).astype(np.float32)
           for _ in range(3)]
    b, n = lead
    mask = np.where(rng.standard_normal((b, n, 1, 1, s)) > 0, 0.0,
                    -1e9).astype(np.float32)
    pair = rng.standard_normal((b, 1, h, s, s)).astype(np.float32)
    row = rng.standard_normal((b, n, h, s, 1)).astype(np.float32)
    if biases == "three":
        return qkv, [mask, pair, row], None
    if biases == "masked":
        mask[0, 1] = -1e9                        # every key of rows (0, 1)
        mask[1, 0, ..., :s // 2] = -1e9
        neg = np.zeros((b, n, h, s, 1), np.float32)
        neg[1, 1, 0, 3] = -np.inf                # one row: every score -inf
        return qkv, [mask, pair, neg], None
    keyt = rng.standard_normal((b, n, 1, s, s)).astype(np.float32)
    bs = [mask, pair, row,
          rng.standard_normal((1,)).astype(np.float32),
          rng.standard_normal((h, 1, 1)).astype(np.float32),
          rng.standard_normal((b, 1, h, 1, s)).astype(np.float32),
          rng.standard_normal((b, n, 1, s, s)).astype(np.float32),
          np.ascontiguousarray(np.swapaxes(keyt, -1, -2))]
    # the last bias reaches the port as a view with transposed keys
    return qkv, bs, {7: lambda t: torch.from_numpy(keyt).transpose(-1, -2)}


def _jax_kernel(q, k, v, bs, block_q, block_k):
    """The JAX package's `_evo_kernel` in interpret mode on [*, S, H, D]."""
    *lead, sq, h, d = q.shape
    lead = tuple(lead)
    L = int(np.prod(lead))

    def hm(x):
        return jnp.moveaxis(jnp.asarray(x).reshape((L, -1, h, d)), 1, 2)

    canon = tuple(jevo._canon_bias(jnp.asarray(b), lead, h, sq, k.shape[-3])
                  for b in bs)
    out = jevo._evo_kernel_call(hm(q), hm(k), hm(v), canon, lead, block_q,
                                block_k, True)
    return np.asarray(jnp.moveaxis(out, 1, 2).reshape(q.shape))


#: (lead, S, heads, d, biases, the JAX kernel's block_q / block_k)
WALK_CASES = [
    ((1, 2), 250, 2, 32, "three", 125, 50),    # ragged row block, key step
    ((2, 2), 96, 2, 8, "eight", 48, 32),
    ((2, 2), 130, 3, 16, "masked", 65, 26),
    ((1, 3), 64, 2, 24, "three", 64, 16),
]


@pytest.mark.parametrize("lead,s,h,d,biases,bq,bk", WALK_CASES)
def test_tiled_plain_matches_jax_kernel(lead, s, h, d, biases, bq, bk):
    (q, k, v), bs, views = _inputs(lead, s, h, d, seed=s + d, biases=biases)
    tb = [(views or {}).get(i, lambda t: torch.from_numpy(t))(b)
          for i, b in enumerate(bs)]
    kinds = {p["kind"] for p in tevo.bias_plan(tb, lead, h, s, s)}
    want = _jax_kernel(q, k, v, bs, bq, bk)
    got = tevo.evoformer_attention_tiled_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), tb)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    if biases == "eight":
        assert {"scalar", "row", "key_async", "tile_sum"} <= kinds, kinds
    if biases == "masked":
        np.testing.assert_allclose(
            got.numpy()[0, 1], np.broadcast_to(v[0, 1].mean(axis=0),
                                               got.shape[2:]),
            atol=FWD_TOL, rtol=0)
        assert (got.numpy()[1, 1, 3, 0] == 0).all()


@pytest.mark.parametrize("block_rows,block_keys", [(128, 64), (64, 32),
                                                   (32, 128)])
def test_tiled_plain_walk_sizes_agree(block_rows, block_keys):
    """The walk's blocks change nothing but the order of the online
    softmax: every block size gives the dense answer in f32."""
    (q, k, v), bs, _ = _inputs((1, 2), 150, 2, 16, seed=5, biases="three")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = [torch.from_numpy(b) for b in bs]
    got = tevo.evoformer_attention_tiled_plain(*t, tb, block_rows,
                                               block_keys)
    torch.testing.assert_close(got, tevo.evoformer_attention_dense(*t, tb),
                               atol=FWD_TOL, rtol=0)


SPLIT_TOL = 1e-5


def test_tf32_split_rounds_to_ten_mantissa_bits():
    """hi keeps 10 explicit mantissa bits (the low 13 bits 0), rounded to
    nearest with ties away from zero as cvt.rna does; hi + lo is within
    2^-21 of x; a bf16 or fp16 value is exact in TF32, so its lo is 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * np.float32(1e3))
    hi, lo = tevo.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -21).all()
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert tevo.tf32_split(tie)[0].tolist() == [1 + 2 ** -10,
                                                -(1 + 2 ** -10),
                                                1 + 2 ** -9]
    for dt in (torch.bfloat16, torch.float16):
        y = x.to(dt).float()
        hi, lo = tevo.tf32_split(y)
        assert torch.equal(hi, y) and not lo.any()


@pytest.mark.parametrize("d", [32, 12])
def test_split_walk_matches_jax_dense_in_f32(d):
    """At a small triangle shape (lead (1, S), the mask and the pair bias),
    the general kernel's walk with its 3xTF32 products holds the JAX
    package's dense f32 composition within 1e-5; one TF32 product alone
    (the split's cross terms dropped) does not."""
    lead, s, h = (1, 48), 48, 2
    (q, k, v), bs, _ = _inputs(lead, s, h, d, seed=d, biases="three")
    bs = bs[:2]
    want = np.asarray(jevo.evoformer_attention_dense(
        *(jnp.asarray(a) for a in (q, k, v)), [jnp.asarray(b) for b in bs]))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = [torch.from_numpy(b) for b in bs]
    rows, keys = tevo.general_walk(d, torch.float32)
    got = tevo.evoformer_attention_tiled_plain(*t, tb, rows, keys,
                                               split=True)
    np.testing.assert_allclose(got.numpy(), want, atol=SPLIT_TOL, rtol=0)
    one = tevo.evoformer_attention_tiled_plain(
        *(tevo.tf32_split(a)[0] for a in t), tb, rows, keys)
    assert np.abs(one.numpy() - want).max() > SPLIT_TOL
