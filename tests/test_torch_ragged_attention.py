"""The port's ragged paged attention against the JAX package's.

Each case of the JAX package's ``TestRaggedAttention`` battery (mixed
batch, pure decode, page-straddling prefill, verify rows, GQA 4) goes,
on the same numpy inputs, through the Pallas kernel in interpret mode,
through its masked-XLA fallback, and through the port's
``paged_ragged_attention`` on CPU tensors (the plain version).
Tolerance: atol = rtol = 2e-5 in f32 — the JAX package's own kernel
parity bound (online softmax against the one-shot softmax).  Tokens
outside every row must be exact zeros.

The CUDA kernel against its plain version on the card is not a CPU
test: ``chip_smoke.py`` runs it from the port's kernel registry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.llm.paged_attention import (
    paged_ragged_attention_xla,
)
from paddle_tpu.ops.pallas.ragged_attention_kernel import (
    paged_ragged_attention_pallas,
)
from paddle_tpu_torch.inference.llm import paged_attention as port
from paddle_tpu_torch.ops.cuda import ragged_attention_kernel as cuda_kernel
from paddle_tpu_torch.ops.cuda import registry


def _token_descriptors(t, row_start, row_qlen, row_pos0):
    ctx = np.zeros(t, np.int32)
    rows = np.zeros(t, np.int32)
    for s, n, p0, r in zip(row_start, row_qlen, row_pos0,
                           range(len(row_start))):
        ctx[s:s + n] = p0 + np.arange(1, n + 1)
        rows[s:s + n] = r
    return ctx, rows


# (name, NB, BS, NQ, NKV, D, T, pool seed, q seed, block tables,
#  row_start, row_qlen, row_pos0) — the JAX battery's cases, with the
# per-sequence decode / verify forms written as ragged rows.  Tables of
# None are drawn from the q stream after q, as the JAX case draws them.
CASES = [
    ("mixed_batch", 6, 8, 4, 2, 16, 16, 30, 31,
     [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 1, 7, 0], [1, 6, 3, 0], [9, 5, 3, 0]),
    ("pure_decode", 6, 8, 4, 2, 16, 8, 32, 33, None,
     list(range(8)), [0, 1, 1, 1, 1, 1, 1, 1],
     [0, 12, 23, 4, 0, 7, 15, 8]),
    ("prefill_aligned", 6, 8, 4, 2, 16, 8, 40, 41, [[3, 1, 4, 0]],
     [0], [8], [0]),
    ("prefill_page_straddle", 6, 8, 4, 2, 16, 8, 40, 41, [[3, 1, 4, 0]],
     [0], [8], [5]),
    ("verify_rows", 6, 8, 4, 2, 16, 16, 50, 51,
     [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 4, 8, 12], [4, 2, 0, 3], [8, 12, 0, 4]),
    ("gqa_group_of_four", 6, 8, 8, 2, 16, 8, 60, 61,
     [[1, 4, 2], [3, 0, 5]], [0, 3], [3, 5], [6, 0]),
]


def _inputs(case):
    (_, nb, bs, nq, nkv, d, t, pseed, qseed, bt, rs, rq, rp) = case
    prng = np.random.RandomState(pseed)
    kp = prng.rand(nb, bs, nkv, d).astype(np.float32)
    vp = prng.rand(nb, bs, nkv, d).astype(np.float32)
    qrng = np.random.RandomState(qseed)
    q = qrng.rand(t, nq, d).astype(np.float32)
    if bt is None:
        bt = qrng.randint(0, nb, size=(t, 3))
    return (q, kp, vp, np.asarray(bt, np.int32), np.asarray(rs, np.int32),
            np.asarray(rq, np.int32), np.asarray(rp, np.int32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_and_xla(case):
    q, kp, vp, bt, rs, rq, rp = _inputs(case)
    ctx, rows = _token_descriptors(q.shape[0], rs, rq, rp)
    pallas = np.asarray(paged_ragged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(rs), jnp.asarray(rq), jnp.asarray(rp), interpret=True))
    xla = np.asarray(paged_ragged_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(rows)))
    t = torch.from_numpy
    got = port.paged_ragged_attention(
        t(q), t(kp), t(vp), t(bt), t(ctx), t(rows), t(rs), t(rq),
        t(rp)).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    dead = ctx == 0
    assert np.all(got[dead] == 0.0), "padding tokens not exact zero"
    assert np.all(got[~dead] != 0.0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_token_descriptors_match_host_form(case):
    q, _kp, _vp, _bt, rs, rq, rp = _inputs(case)
    ctx, rows = _token_descriptors(q.shape[0], rs, rq, rp)
    got_ctx, got_rows = port.token_descriptors(
        q.shape[0], torch.from_numpy(rs), torch.from_numpy(rq),
        torch.from_numpy(rp))
    np.testing.assert_array_equal(got_ctx.numpy(), ctx)
    np.testing.assert_array_equal(got_rows.numpy(), rows)


def test_registry_plain_is_the_dispatch_plain():
    """The per-row plain version the chip smoke holds the kernel to is
    the CPU dispatch's plain version, bitwise."""
    entry = registry.KERNELS["paged_ragged_attention"]
    q, kp, vp, bt, rs, rq, rp = (torch.from_numpy(a)
                                 for a in _inputs(CASES[0]))
    ctx, rows = port.token_descriptors(q.shape[0], rs, rq, rp)
    want = port.paged_ragged_attention_plain(q, kp, vp, bt, ctx, rows)
    assert torch.equal(entry.plain(q, kp, vp, bt, rs, rq, rp), want)


def test_cuda_wrapper_raises_on_cpu_tensors():
    q, kp, vp, bt, rs, rq, rp = (torch.from_numpy(a)
                                 for a in _inputs(CASES[0]))
    before = cuda_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernel.paged_ragged_attention_cuda(q, kp, vp, bt, rs, rq, rp)
    assert cuda_kernel.launches == before


def test_kernel_supports_gate():
    """The CUDA kernel's own needs, not the TPU tiling rules: any token
    count and page size, whole GQA groups of at most 16, head_dim a
    multiple of 8 up to 128."""
    ok = cuda_kernel.supports
    assert ok(16, 64, 12, 12, 1) and ok(5, 64, 12, 12, 13)
    assert ok(16, 128, 32, 8, 256) and ok(1, 8, 16, 1, 3)
    assert not ok(16, 64, 12, 5, 8)         # partial GQA group
    assert not ok(16, 64, 34, 2, 8)         # group of 17
    assert not ok(16, 60, 12, 12, 8)        # head_dim % 8
    assert not ok(16, 136, 12, 12, 8)       # head_dim > 128
    assert not ok(16, 64, 12, 12, 0)        # no tokens


def test_b1_is_in_the_chip_smoke_registry():
    entry = registry.KERNELS["paged_ragged_attention"]
    assert entry.kernel is cuda_kernel.paged_ragged_attention_cuda
    assert entry.source == "paddle_tpu_torch/csrc/ragged_attention.cu"
    assert entry.replaces.startswith(
        "paddle_tpu/ops/pallas/ragged_attention_kernel.py:")
    assert entry.parity.startswith("tests/test_torch_ragged_attention.py")
    entry.reset()
    assert registry.counts()["paged_ragged_attention"] == 0
