"""Split-KV flash-decoding on the host: the split plan and the plain
version of the combine, against the JAX package's decode attention.

The decode kernels (B6 ``csrc/decode_attention.cu``; B1 and B5
``csrc/ragged_attention.cu``) cut each row's keys into chunks, attend
each chunk in its own block and merge the partial softmax states in a
second kernel.  Here the partials are computed from the plain attention
(``split_kv.partials_plain``) and merged by the combine's plain version
(``split_kv.merge_partials_plain``).  The merged result must equal the
port's plain versions to 1e-6 in f32 (the same function, summed in
another order) and the JAX package's XLA fallbacks and its Pallas
kernels in interpret mode at 2e-5, the JAX package's own kernel parity
bound.  The cases sit on the split edges: lengths at a chunk boundary,
one key past it and 1; a context ending inside the last split; S_max
smaller than one chunk; length 0 (exact zeros); and every split empty
past a short row next to a deep one.  The host's chunk is the kernels'
one constexpr, and every token of a row's last tile (the only tiles the
ragged kernel splits) has its own slot in the partials.

The CUDA kernels against their plain versions on the card are not CPU
tests: ``chip_smoke.py`` runs them from the port's kernel registry.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.llm.paged_attention import (
    paged_ragged_attention_xla,
)
from paddle_tpu.ops.pallas.decode_attention_kernel import (
    decode_attention_pallas,
    decode_attention_xla,
)
from paddle_tpu.ops.pallas.ragged_attention_kernel import (
    paged_ragged_attention_pallas,
)
from paddle_tpu_torch.inference.llm import paged_attention as port
from paddle_tpu_torch.ops.cuda import decode_attention_kernel as decode
from paddle_tpu_torch.ops.cuda import ragged_attention_kernel as ragged
from paddle_tpu_torch.ops.cuda import split_kv

CHUNK = split_kv.CHUNK
CSRC = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"


def _constexpr(name):
    text = (CSRC / "split_decode.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_constants_mirror_the_kernel_source():
    """The host's chunk and rows a block are the kernels' constexprs."""
    assert _constexpr("kChunk") == CHUNK
    assert _constexpr("kWarps") * _constexpr("kRowsPerWarp") == split_kv.ROWS
    assert CHUNK % (_constexpr("kWarps") * _constexpr("kSubKeys")) == 0, \
        "a split is whole ring stages"


@pytest.mark.parametrize("max_keys", [1, 2, 63, 64, 65, 127, 128, 129, 191,
                                      192, 255, 256, 257, 383, 384, 385,
                                      1000, 1023, 1024, 1025, 2047, 2048,
                                      2049, 4096, 4097])
def test_plan_covers_every_key(max_keys):
    splits = split_kv.plan(max_keys)
    assert splits * CHUNK >= max_keys          # every key has a split
    assert (splits - 1) * CHUNK < max_keys     # and no split is wasted


def test_wrappers_plan_from_shapes_alone():
    """B6 plans from S_max, B1/B5 from the tables' width times the page
    size: the plan is a function of those numbers only."""
    for s_max in (1, 192, 2048):
        assert decode.split_plan(s_max) == split_kv.plan(s_max)
    for p, bs in ((64, 16), (3, 8), (1, 5)):
        assert ragged.split_plan(p, bs) == split_kv.plan(p * bs)


def _split_token_slots(t, rs, rq, nq, nkv, splits, d):
    """The slot of every token whose tile splits, by the kernels' rule:
    the token itself where there are T slots (every tile splits), else
    r * tile + its place in its row's last tile."""
    tile = split_kv.ROWS // (nq // nkv)
    per_token = split_kv.ragged_slots(t, len(rs), nq, nkv, splits, d) == t
    slots = []
    for r, (s0, n) in enumerate(zip(rs, rq)):
        if n <= 0:
            continue
        last0 = (n - 1) // tile * tile
        slots += ([s0 + i for i in range(n)] if per_token else
                  [r * tile + i - last0 for i in range(last0, n)])
    return slots


# (T, Nq, Nkv, splits, D, row_qlen): rows packed back to back from token 0
SLOT_CASES = [
    (8, 12, 12, 8, 64, [1] * 8),                      # decode
    (8, 12, 4, 16, 64, [1, 1, 1, 0, 1, 1, 1, 1]),
    (256, 12, 12, 8, 64, [1, 200, 4, 0, 0, 0, 0, 0]),  # the smoke's mixed step
    (512, 32, 8, 8, 128, [1, 500, 7, 0]),             # past the cap
    (2048, 32, 32, 32, 128, [2000, 1, 1, 1, 1, 1]),
    (4096, 12, 12, 32, 64, [4096]),
    (40, 16, 1, 4, 128, [17, 1, 22]),
    (33, 4, 2, 2, 16, [16, 17]),
]


@pytest.mark.parametrize("case", SLOT_CASES)
def test_ragged_partials_fit_their_slots(case):
    """Every token of a split tile gets its own slot below
    ``ragged_slots``, which never exceeds T; the partials leave the
    per-token layout only where it would pass the cap."""
    t, nq, nkv, splits, d, rq = case
    rs = np.concatenate([[0], np.cumsum(rq)[:-1]]).tolist()
    assert sum(rq) <= t
    n = split_kv.ragged_slots(t, len(rq), nq, nkv, splits, d)
    token_bytes = t * nq * splits * (d + 2) * 4
    assert n == t or (n < t and token_bytes > split_kv.TOKEN_SCRATCH_BYTES)
    slots = _split_token_slots(t, rs, rq, nq, nkv, splits, d)
    assert len(set(slots)) == len(slots), "two tokens share a slot"
    assert all(0 <= x < n for x in slots)


def _merged(q, k, v, limit):
    splits = split_kv.plan(k.shape[1])
    acc, m, l = split_kv.partials_plain(q, k, v, limit, splits)
    return split_kv.merge_partials_plain(acc, m, l, limit)


# (name, B, Nq, Nkv, D, S_max, lengths)
DECODE_CASES = [
    ("chunk_boundary_and_one_past", 4, 4, 2, 16, 384, [128, 129, 256, 257]),
    ("length_one_and_zero", 3, 4, 2, 16, 384, [1, 0, 384]),
    ("ends_inside_last_split", 2, 6, 2, 32, 384, [300, 383]),
    ("s_max_below_one_chunk", 3, 4, 4, 16, 40, [40, 0, 7]),
    ("gqa_16_all_splits", 2, 16, 1, 16, 512, [512, 3]),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_merge_matches_plain_xla_and_pallas(case):
    _, b, nq, nkv, d, s, lens = case
    rng = np.random.RandomState(b * 100 + s)
    q = rng.randn(b, nq, d).astype(np.float32)
    k = rng.randn(b, s, nkv, d).astype(np.float32)
    v = rng.randn(b, s, nkv, d).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    t = torch.from_numpy
    got = _merged(t(q), t(k), t(v), t(lens)).numpy()
    plain = decode.decode_attention_plain(t(q), t(k), t(v), t(lens)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=1e-6)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    xla = np.asarray(decode_attention_xla(jq, jk, jv, jl))
    pallas = np.asarray(decode_attention_pallas(jq, jk, jv, jl,
                                                interpret=True))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    assert np.all(got[lens == 0] == 0.0), "length-0 rows not exact zero"
    assert np.all(got[lens > 0] != 0.0)


def test_decode_partials_of_empty_splits():
    """A split past a row's length holds m = -1e30, l = 0, acc = 0, and
    the merge never reads it."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((2, 2, 8), (2, 512, 2, 8), (2, 512, 2, 8)))
    lens = torch.tensor([1, 129], dtype=torch.int32)
    acc, m, l = split_kv.partials_plain(q, k, v, lens, 4)
    assert torch.all(m[0, :, 1:] == -1e30) and torch.all(l[0, :, 1:] == 0)
    assert torch.all(acc[0, :, 1:] == 0)
    assert torch.all(l[1, :, :2] > 0) and torch.all(l[1, :, 2:] == 0)
    # poisoning the unread splits leaves the merge unchanged
    want = split_kv.merge_partials_plain(acc, m, l, lens)
    acc[0, :, 1:], m[0, :, 1:], l[0, :, 1:] = 7.0, 1e3, 5.0
    acc[1, :, 2:] = float("nan")
    assert torch.equal(split_kv.merge_partials_plain(acc, m, l, lens), want)


def _token_descriptors(t, rs, rq, rp):
    ctx = np.zeros(t, np.int32)
    rows = np.zeros(t, np.int32)
    for r, (s, n, p0) in enumerate(zip(rs, rq, rp)):
        ctx[s:s + n] = p0 + np.arange(1, n + 1)
        rows[s:s + n] = r
    return ctx, rows


# (name, Nq, Nkv, T, block tables' pages, row_start, row_qlen, row_pos0);
# NB 48 pages of 8 slots, D 16
RAGGED_CASES = [
    ("deep_row_beside_short_rows", 4, 2, 8, 48,
     [0, 1, 2, 3], [1, 1, 1, 0], [370, 0, 127, 0]),
    ("prefill_across_a_boundary", 4, 2, 16, 48,
     [0, 10, 11], [10, 1, 1], [120, 128, 255]),
    ("gqa_4_prefill_and_decode", 8, 2, 8, 48, [0, 5], [5, 1], [124, 383]),
]


@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=[c[0] for c in RAGGED_CASES])
def test_ragged_merge_matches_plain_xla_and_pallas(case):
    _, nq, nkv, t, pages, rs, rq, rp = case
    nb, bs, d = 48, 8, 16
    rng = np.random.RandomState(len(rs) * 10 + t)
    kp = rng.randn(nb, bs, nkv, d).astype(np.float32)
    vp = rng.randn(nb, bs, nkv, d).astype(np.float32)
    q = rng.randn(t, nq, d).astype(np.float32)
    bt = np.stack([rng.permutation(nb)[:pages]
                   for _ in rs]).astype(np.int32)
    rs, rq, rp = (np.asarray(a, np.int32) for a in (rs, rq, rp))
    ctx, rows = _token_descriptors(t, rs, rq, rp)
    tt = torch.from_numpy
    # the plain version's gather, then the split and the merge
    btl, rws = tt(bt).long(), tt(rows).long()
    k = tt(kp)[btl].reshape(len(rs), pages * bs, nkv, d)[rws]
    v = tt(vp)[btl].reshape(len(rs), pages * bs, nkv, d)[rws]
    got = _merged(tt(q), k, v, tt(ctx)).numpy()
    plain = port.paged_ragged_attention_plain(
        tt(q), tt(kp), tt(vp), tt(bt), tt(ctx), tt(rows)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=1e-6)
    j = jnp.asarray
    xla = np.asarray(paged_ragged_attention_xla(
        j(q), j(kp), j(vp), j(bt), j(ctx), j(rows)))
    pallas = np.asarray(paged_ragged_attention_pallas(
        j(q), j(kp), j(vp), j(bt), j(rs), j(rq), j(rp), interpret=True))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    assert np.all(got[ctx == 0] == 0.0), "padding tokens not exact zero"
    assert np.all(got[ctx > 0] != 0.0)
