"""The port's dense-cache decode attention against the JAX package's.

The cases of the JAX package's ``TestDecodeAttention`` battery (ragged
GQA 4/2 lengths, MHA with lengths [1, 64, 33], and rows of length 0)
go, on the same numpy inputs, through the Pallas kernel in interpret
mode, through its XLA fallback ``decode_attention_xla``, and through
the port's plain version.  Tolerance: atol = rtol = 2e-5 in f32, the
JAX package's own kernel parity bound.  A row of length 0 must be exact
zeros.

The CUDA kernel against its plain version on the card is not a CPU
test: ``chip_smoke.py`` runs it from the port's kernel registry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.decode_attention_kernel import (
    decode_attention_pallas,
    decode_attention_xla,
)
from paddle_tpu_torch.incubate.nn.functional import (
    ragged_decode_attention,
    swiglu,
)
from paddle_tpu_torch.ops.cuda import decode_attention_kernel as kernel
from paddle_tpu_torch.ops.cuda import registry


def _mk(b=3, nq=4, nkv=2, d=16, s=64, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.rand(b, nq, d).astype(np.float32)
    k = rng.rand(b, s, nkv, d).astype(np.float32)
    v = rng.rand(b, s, nkv, d).astype(np.float32)
    lens = rng.randint(1, s + 1, b).astype(np.int32)
    return q, k, v, lens


# (name, _mk keywords, lengths or None for _mk's own)
CASES = [
    ("ragged_gqa_4_2", dict(), None),
    ("mha_tiny_lengths", dict(nq=2, nkv=2, seed=1), [1, 64, 33]),
    ("empty_rows", dict(seed=3), [0, 17, 0]),
    ("gqa_group_of_three", dict(b=4, nq=6, nkv=2, d=32, s=40, seed=4),
     [40, 1, 0, 23]),
]


def _inputs(case):
    _, kw, lens = case
    q, k, v, own = _mk(**kw)
    return q, k, v, np.asarray(own if lens is None else lens, np.int32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_and_xla(case):
    q, k, v, lens = _inputs(case)
    pallas = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True))
    xla = np.asarray(decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    t = torch.from_numpy
    got = ragged_decode_attention(t(q), t(k), t(v), t(lens)).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    assert np.all(got[lens == 0] == 0.0), "length-0 rows not exact zero"
    assert np.all(got[lens > 0] != 0.0)


def test_length_one_attends_position_zero():
    q, k, v, _ = _mk(nq=2, nkv=2, seed=1)
    got = kernel.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([1, 64, 33], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got[0, 0], v[0, 0, 0], atol=2e-5)


def test_dispatcher_routes_cpu_to_plain():
    """A CPU tensor takes the plain version on the default route and
    with the explicit opt-out; nothing reaches the kernel or its
    counter."""
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    want = kernel.decode_attention_plain(q, k, v, lens)
    before = kernel.launches
    assert torch.equal(ragged_decode_attention(q, k, v, lens), want)
    assert torch.equal(ragged_decode_attention(q, k, v, lens,
                                               use_pallas=False), want)
    assert kernel.launches == before


def test_cuda_wrapper_raises_on_cpu_tensors():
    q, k, v, lens = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.decode_attention_cuda(q, k, v, lens)
    assert kernel.launches == before


def test_kernel_supports_gate():
    """The CUDA kernel's own needs, not the TPU's ``S_max % block_s``:
    any S_max, whole GQA groups of at most 16, head_dim % 8 up to 128."""
    ok = kernel.supports
    assert ok(1, 64, 12, 12) and ok(1000, 64, 12, 4) and ok(7, 128, 32, 2)
    assert ok(2048, 64, 12, 4) and ok(3, 8, 16, 1)
    assert not ok(64, 64, 12, 5)          # partial GQA group
    assert not ok(64, 64, 34, 2)          # group of 17
    assert not ok(64, 60, 12, 12)         # head_dim % 8
    assert not ok(64, 136, 12, 12)        # head_dim > 128
    assert not ok(0, 64, 12, 12)          # empty cache


def test_swiglu_matches_jax():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import functional as jax_IF

    rng = np.random.RandomState(6)
    x = rng.randn(3, 10).astype(np.float32)
    y = rng.randn(3, 10).astype(np.float32)
    for args in ((x,), (x, y)):
        want = jax_IF.swiglu(*(paddle.to_tensor(a) for a in args)).numpy()
        got = swiglu(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_b6_is_in_the_chip_smoke_registry():
    entry = registry.KERNELS["decode_attention"]
    assert entry.kernel is kernel.decode_attention_cuda
    assert entry.plain is kernel.decode_attention_plain
    assert entry.source == "paddle_tpu_torch/csrc/decode_attention.cu"
    assert entry.replaces == \
        "paddle_tpu/ops/pallas/decode_attention_kernel.py:115"
    assert entry.parity.startswith("tests/test_torch_decode_attention.py")
    entry.reset()
    assert registry.counts()["decode_attention"] == 0
