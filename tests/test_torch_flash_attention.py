"""The port's flash attention (B2/B3) against the JAX package on the CPU.

On the CPU the dispatcher ``paddle_tpu_torch.ops.attention.
flash_attention`` takes the plain composition, the CUDA kernels' plain
version, with autograd for the gradients.  It is held to the Pallas
kernel in interpret mode (``flash_attention_pallas(interpret=True)``)
and to ``_xla_attention`` on the shapes and tolerances of
``tests/test_pallas_kernels.py``: f32 forward at 2e-4 (online softmax
against one softmax), gradients at 5e-4, bf16 at 2e-2.  The kernels'
plain contracts (``flash_fwd_plain`` with its lse, ``flash_bwd_plain``
from a given dO) are held to the Pallas ``_flash_fwd``/``_flash_bwd``
directly, in f32 and (gradients through the public VJP) in bf16; off
the Pallas kernel's divisible tiling (head_dim 24, seq_q != seq_k) they
are held to the dispatcher's XLA fallback.  The CUDA kernels themselves
are held to these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import _xla_attention
from paddle_tpu.ops.pallas.attention_kernel import (
    _flash_bwd,
    _flash_fwd,
    flash_attention_pallas,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention
from paddle_tpu_torch.ops.cuda import flash_attention_kernel as fak


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(a, dtype=torch.float32, jdtype=jnp.float32):
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, jdtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 2, 64), (1, 256, 4, 32)])
def test_forward_matches_pallas_and_xla(shape, causal):
    (q, jq), (k, jk), (v, jv) = (_both(_rand(shape, s)) for s in (0, 1, 2))
    got = attention.flash_attention(q, k, v, is_causal=causal).numpy()
    pallas = flash_attention_pallas(jq, jk, jv, is_causal=causal,
                                    interpret=True)
    xla = _xla_attention(jq, jk, jv, is_causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_pallas(causal):
    shape = (1, 128, 2, 32)
    arrays = [_rand(shape, s) for s in (3, 4, 5)]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = attention.flash_attention(tq, tk, tv, is_causal=causal)
    (out * torch.cos(out)).sum().backward()

    def loss_pallas(q, k, v):
        o = flash_attention_pallas(q, k, v, is_causal=causal, interpret=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_pallas, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4, err_msg=f"d{name}")


def test_uneven_seq_192_causal():
    shape = (1, 192, 2, 32)
    (q, jq), (k, jk), (v, jv) = (_both(_rand(shape, s)) for s in (6, 7, 8))
    got = attention.flash_attention(q, k, v, is_causal=True).numpy()
    want = flash_attention_pallas(jq, jk, jv, is_causal=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_bf16_forward():
    shape = (1, 128, 2, 64)
    pairs = [_both(_rand(shape, s), torch.bfloat16, jnp.bfloat16)
             for s in (9, 10, 11)]
    got = attention.flash_attention(*(p[0] for p in pairs), is_causal=True)
    assert got.dtype == torch.bfloat16
    want = _xla_attention(*(p[1] for p in pairs), is_causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_contracts_match_pallas_fwd_and_bwd(causal):
    """``flash_fwd_plain`` gives the kernel's (out, lse) and
    ``flash_bwd_plain`` its (dq, dk, dv) from a given dO: held to the
    Pallas ``_flash_fwd``/``_flash_bwd`` on the [B*N, S, H] layout."""
    b, s, n, h = 1, 128, 2, 32
    q, k, v, do = (_rand((b, s, n, h), seed) for seed in (12, 13, 14, 15))
    scale = 1.0 / np.sqrt(h)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fak.flash_fwd_plain(tq, tk, tv, causal, scale)
    assert lse.shape == (b, n, s) and lse.dtype == torch.float32

    def bnsh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * n, s, h))

    jo, jlse = _flash_fwd(bnsh(q), bnsh(k), bnsh(v), causal, scale, 64, 64,
                          True)
    np.testing.assert_allclose(
        out.numpy().transpose(0, 2, 1, 3).reshape(b * n, s, h),
        np.asarray(jo), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy().reshape(b * n, s),
                               np.asarray(jlse)[..., 0], rtol=1e-5,
                               atol=1e-5)
    grads = fak.flash_bwd_plain(tq, tk, tv, out, lse, tdo, causal, scale)
    want = _flash_bwd(bnsh(q), bnsh(k), bnsh(v), jo, jlse, bnsh(do), causal,
                      scale, 64, 64, True)
    for g, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(
            g.numpy().transpose(0, 2, 1, 3).reshape(b * n, s, h),
            np.asarray(w), rtol=5e-4, atol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_plain_matches_pallas_vjp(causal):
    """The bf16 contract the card's tensor-core kernels are held to:
    ``flash_bwd_plain`` from ``flash_fwd_plain``'s bf16 out and lse
    against the VJP of ``flash_attention_pallas(interpret=True)`` on the
    same bf16 inputs, at the bf16 tolerance of
    ``tests/test_pallas_kernels.py`` (2e-2)."""
    shape = (1, 128, 2, 64)
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _both(_rand(shape, s), torch.bfloat16, jnp.bfloat16)
        for s in (31, 32, 33, 34))
    scale = 1.0 / np.sqrt(shape[-1])
    out, lse = fak.flash_fwd_plain(q, k, v, causal, scale)
    grads = fak.flash_bwd_plain(q, k, v, out, lse, do, causal, scale)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_pallas(
        a, b, c, is_causal=causal, interpret=True), jq, jk, jv)
    for g, w, name in zip(grads, vjp(jdo), "qkv"):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2e-2, atol=2e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,seq_k,causal", [
    ((1, 200, 2, 24), None, True),      # head_dim the kernels pad to 32
    ((1, 200, 2, 8), None, True),       # ... and to 32 from 8
    ((1, 200, 2, 40), None, True),      # ... and to 64
    ((2, 77, 4, 64), 333, False),       # seq_q != seq_k
    ((1, 1, 2, 64), None, True),        # one row: dq and dk are zero
    ((1, 65, 2, 64), None, True),       # one row past a 64-row tile
])
def test_plain_matches_xla_fallback_off_the_pallas_tiling(shape, seq_k,
                                                          causal):
    """Shapes the Pallas kernel cannot take (it needs block-divisible
    lengths, ``attention_kernel.py:40-43``) and the card's kernels do:
    ``flash_fwd_plain`` and ``flash_bwd_plain`` against the JAX
    dispatcher's XLA fallback ``_xla_attention`` and its VJP, f32, at the
    forward's 2e-4 and the gradients' 5e-4."""
    b, s, n, h = shape
    sk = s if seq_k is None else seq_k
    arrays = [_rand((b, s, n, h), 35), _rand((b, sk, n, h), 36),
              _rand((b, sk, n, h), 37), _rand((b, s, n, h), 38)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    scale = 1.0 / np.sqrt(h)
    out, lse = fak.flash_fwd_plain(tq, tk, tv, causal, scale)
    want, vjp = jax.vjp(lambda a, b_, c: _xla_attention(
        a, b_, c, is_causal=causal), jq, jk, jv)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    grads = fak.flash_bwd_plain(tq, tk, tv, out, lse, tdo, causal, scale)
    for g, w, name in zip(grads, vjp(jdo), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4, err_msg=f"d{name}")


# ------------------------------------------- the f32 kernels' numerics --
# The CPU shapes of ``chip_smoke.py``'s f32 parity cases.
TF32_CASES = [((2, 128, 2, 64), False), ((2, 128, 2, 64), True),
              ((1, 256, 4, 32), True)]


def _fwd_tf32(q, k, v, causal, scale, parts):
    """(out, lse) with each product (S = Q K^T, O = P V) formed from its
    operands' TF32 parts (``split_tf32``) as the f32 kernels form it:
    ``parts`` 3 is their ``lo hi + hi lo + hi hi``, 1 one TF32 product
    ``hi hi``; softmax, lse and the sums in f32."""
    def mm(a, b):
        ah, al = fak.split_tf32(a)
        bh, bl = fak.split_tf32(b)
        return ah @ bh if parts == 1 else al @ bh + ah @ bl + ah @ bh

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return (mm(p, v) / l).transpose(1, 2), (m + torch.log(l))[..., 0]


def _over_tf32_limit(shape, causal, parts):
    """Largest err / limit of ``_fwd_tf32`` against the JAX ``_flash_fwd``
    (interpret mode) on out and lse, the limit chip_smoke.py's f32 gate:
    ``1e-4 * max(1, max|want|)``."""
    b, s, n, h = shape
    q, k, v = (_rand(shape, seed) for seed in (60, 61, 62))
    scale = 1.0 / np.sqrt(h)
    out, lse = _fwd_tf32(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         scale, parts)

    def bnsh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * n, s, h))

    jo, jlse = _flash_fwd(bnsh(q), bnsh(k), bnsh(v), causal, scale, 64, 64,
                          True)
    got = {"out": out.numpy().transpose(0, 2, 1, 3).reshape(b * n, s, h),
           "lse": lse.numpy().reshape(b * n, s)}
    want = {"out": np.asarray(jo), "lse": np.asarray(jlse)[..., 0]}
    return {name: float(np.abs(got[name] - want[name]).max()
                        / (1e-4 * max(1.0, float(np.abs(want[name]).max()))))
            for name in got}


@pytest.mark.parametrize("shape,causal", TF32_CASES)
def test_three_tf32_products_hold_the_f32_limit(shape, causal):
    """The f32 kernels' products, three TF32 products from each operand's
    hi and lo parts, give a forward within chip_smoke.py's f32 limit of
    the JAX kernel on out and lse, with a tenfold margin."""
    over = _over_tf32_limit(shape, causal, parts=3)
    assert max(over.values()) < 0.1, over


def test_one_tf32_product_breaks_the_f32_limit():
    """One TF32 product (what the tensor cores make of an f32 operand)
    falls outside that limit on out: the gate tells the two apart."""
    over = [_over_tf32_limit(shape, causal, parts=1)["out"]
            for shape, causal in TF32_CASES]
    assert max(over) > 1.0, over


def test_qkv_views_take_the_same_route():
    """Strided q/k/v views of one [B, S, 3, N, H] projection (what GPT
    passes) give what contiguous copies give."""
    qkv = torch.from_numpy(_rand((2, 64, 3, 2, 16), 16))
    q, k, v = qkv.unbind(dim=2)
    got = attention.flash_attention(q, k, v, is_causal=True)
    want = attention.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), is_causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------- routes --
def test_kernel_route_is_decided_from_the_arguments():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 12, 2, 16)
    assert attention.kernel_route(q, q, is_causal=True)
    assert attention.kernel_route(q, k, is_causal=False)
    # the JAX dispatcher's semantic routes take the plain composition
    assert not attention.kernel_route(q, k, is_causal=True)
    assert not attention.kernel_route(q, q, attn_mask=torch.ones(8, 8) > 0)
    assert not attention.kernel_route(q, q, dropout_p=0.1)
    assert not attention.kernel_route(q, q, scale=0.5)


def test_semantic_routes_compute_the_plain_composition():
    q, k, v = (torch.from_numpy(_rand((1, 16, 2, 8), s)) for s in (17, 18,
                                                                    19))
    mask = torch.from_numpy(_rand((16, 16), 20)) > 0
    np.testing.assert_allclose(
        attention.flash_attention(q, k, v, attn_mask=mask).numpy(),
        np.asarray(_xla_attention(*(jnp.asarray(t.numpy()) for t in
                                    (q, k, v)),
                                  attn_mask=jnp.asarray(mask.numpy()))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        attention.flash_attention(q, k, v, scale=0.3).numpy(),
        np.asarray(_xla_attention(*(jnp.asarray(t.numpy()) for t in
                                    (q, k, v)), scale=0.3)),
        rtol=1e-5, atol=1e-5)
    # causal with seq_q != seq_k: bottom-right aligned, as _xla_attention
    np.testing.assert_allclose(
        attention.flash_attention(q[:, :5], k, v, is_causal=True).numpy(),
        np.asarray(_xla_attention(*(jnp.asarray(t.numpy()) for t in
                                    (q[:, :5], k, v)), is_causal=True)),
        rtol=1e-5, atol=1e-5)


def test_attention_dropout_draws_from_the_generator():
    q, k, v = (torch.from_numpy(_rand((1, 32, 2, 8), s)) for s in (21, 22,
                                                                    23))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                              is_causal=True, generator=gen)

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    no_drop = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                             is_causal=True, training=False)
    torch.testing.assert_close(
        no_drop, attention.attention_plain(q, k, v, is_causal=True))


def test_cuda_wrappers_raise_on_cpu_tensors():
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fak.flash_attention_fwd_cuda(q, q, q, True, 0.25)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fak.flash_attention_cuda(q, q, q, is_causal=True)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fak.flash_attention_bwd_cuda(q, q, q, q, lse, q, True, 0.25)


def test_cuda_wrappers_reject_causal_with_unequal_lengths():
    """The kernels' causal mask is top-left aligned, their plain
    version's bottom-right: a direct caller gets an error, not another
    function."""
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        fak.flash_attention_fwd_cuda(q, k, k, True, 0.25)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        fak.flash_attention_cuda(q, k, k, is_causal=True)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        fak.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 8), q,
                                     True, 0.25)


def test_forward_plain_is_attention_plain_with_its_lse():
    """One composition: the forward's plain version returns
    ``attention_plain``'s output bitwise and the lse of its logits."""
    q, k, v = (torch.from_numpy(_rand((2, 48, 2, 16), s)) for s in (24, 25,
                                                                    26))
    out, lse = fak.flash_fwd_plain(q, k, v, True, 0.25)
    torch.testing.assert_close(
        out, attention.attention_plain(q, k, v, is_causal=True, scale=0.25),
        rtol=0, atol=0)
    torch.testing.assert_close(
        lse, torch.logsumexp(attention.causal_logits(q, k, True, 0.25), -1),
        rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_is_autograd_through_attention_plain(causal):
    """The backward's plain contract, given the forward plain's out and
    lse, gives the gradients that autograd through ``attention_plain``
    (what the CPU path trains with) gives."""
    shape = (2, 40, 2, 16)
    q, k, v, do = (torch.from_numpy(_rand(shape, s)) for s in (27, 28, 29,
                                                                30))
    out, lse = fak.flash_fwd_plain(q, k, v, causal, 0.25)
    grads = fak.flash_bwd_plain(q, k, v, out, lse, do, causal, 0.25)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    attention.attention_plain(tq, tk, tv, is_causal=causal,
                              scale=0.25).backward(do)
    for g, t, name in zip(grads, (tq, tk, tv), "qkv"):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-5,
                                   msg=f"d{name}")


def test_supports_takes_any_length_and_small_head_dims():
    assert fak.supports(1000, 1000, 64)          # no tile divides 1000
    assert fak.supports(1024, 1024, 64, torch.bfloat16)
    assert fak.supports(100, 100, 32)
    assert fak.supports(7, 13, 128)
    assert fak.supports(13, 13, 128, torch.bfloat16, causal=True)
    assert not fak.supports(7, 13, 128, causal=True)   # mask alignments
    assert not fak.supports(128, 128, 256)       # head_dim above 128
    assert fak.supports(128, 128, 36)            # any head_dim up to 128
    assert fak.supports(128, 128, 1, torch.bfloat16)
    assert not fak.supports(128, 128, 0)
    assert fak.supports(128, 128, 64, torch.float16)  # C10: f16 too
    assert not fak.supports(128, 128, 64, torch.float64)


def test_supports_takes_every_shape_it_took_before():
    """No redesign narrows ``supports``: any lengths, every head_dim the
    JAX kernel takes (1 to 128; before, only multiples of 8 from 8),
    f32, bf16 or (from C10) float16, causal only on square scores;
    float64 never."""
    lengths = (1, 2, 7, 63, 64, 65, 77, 333, 1000, 1024)
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64):
        for d in range(0, 264, 3):
            for sq in lengths:
                for sk in lengths:
                    for causal in (False, True):
                        before = (1 <= d <= 128
                                  and dtype != torch.float64
                                  and (not causal or sq == sk))
                        assert fak.supports(sq, sk, d, dtype, causal) == \
                            before, (sq, sk, d, dtype, causal)


def test_kernels_are_in_the_chip_smoke_registry():
    from paddle_tpu_torch.ops.cuda import layernorm_kernel as lnk
    from paddle_tpu_torch.ops.cuda import registry

    want = {
        "flash_attention_fwd": (fak.flash_attention_fwd_cuda,
                                "attention_kernel.py:95", "fwd_launches"),
        "flash_attention_bwd": (fak.flash_attention_bwd_cuda,
                                "attention_kernel.py:207", "bwd_launches"),
        "layernorm_fwd": (lnk.layernorm_fwd_cuda, "layernorm_kernel.py:73",
                          "fwd_launches"),
        "layernorm_bwd": (lnk.layernorm_bwd_cuda, "layernorm_kernel.py:99",
                          "bwd_launches"),
    }
    for name, (kernel, replaces, count) in want.items():
        entry = registry.KERNELS[name]
        assert entry.kernel is kernel
        assert entry.replaces == f"paddle_tpu/ops/pallas/{replaces}"
        assert entry.count == count
        setattr(entry.counter, count, 5)
        assert registry.counts()[name] == 5
    registry.reset_counts()
    assert set(registry.counts().values()) == {0}
