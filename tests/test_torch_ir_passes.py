"""The port's FX rewrite passes (``paddle_tpu_torch/framework/ir.py``)
against the JAX package's jaxpr passes (``paddle_tpu/framework/ir.py``).

Each composition of the JAX pass tests is written once in torch and
once in jnp, from the same numpy inputs.  Both go through their
package's ``ir.optimize``: the outputs agree at 2e-5 (f32; the
replacements compute the same function by another algorithm), the
gradients at 1e-4, and the port's ``last_rewrite_count`` equals JAX's
(the JAX side runs as one jitted call, inside which its optimize
wrapper traces).  The declining cases run once each with the count 0 on
both sides.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import ir as jir
from paddle_tpu_torch.framework import ir
from paddle_tpu_torch.ops import attention as port_attention

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-5
GRAD_TOL = 1e-4


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax(fn, *arrays):
    opt = jir.optimize(fn)
    out = jax.jit(opt)(*[jnp.asarray(a) for a in arrays])
    return np.asarray(out), opt.last_rewrite_count


def _port(fn, *arrays):
    opt = ir.optimize(fn)
    out = opt(*[torch.from_numpy(a) for a in arrays])
    return out.detach().numpy(), opt.last_rewrite_count


def _same(tfn, jfn, *arrays, count):
    got, n_port = _port(tfn, *arrays)
    want, n_jax = _jax(jfn, *arrays)
    assert n_jax == count and n_port == n_jax, (n_port, n_jax)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _grads_same(tfn, jfn, *arrays):
    """d/dq of sum(f(q, *rest) * r) through both optimized functions."""
    r = _arrays(_jax(jfn, *arrays)[0].shape, seed=9)[0]
    opt = ir.optimize(tfn)
    q = torch.from_numpy(arrays[0]).requires_grad_()
    (opt(q, *[torch.from_numpy(a) for a in arrays[1:]])
     * torch.from_numpy(r)).sum().backward()
    jopt = jir.optimize(jfn)
    gj = jax.jit(jax.grad(lambda q, *rest: (jopt(q, *rest) * r).sum()))(
        *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gj),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


# ------------------------------------------------------- fuse_attention --
def t_naive2d(q, k, v):
    s = torch.matmul(q, k.T) / math.sqrt(q.shape[-1])
    return torch.softmax(s, -1) @ v


def j_naive2d(q, k, v):
    s = q @ k.T / jnp.sqrt(q.shape[-1] * 1.0)
    return jax.nn.softmax(s, axis=-1) @ v


def t_bhtd(q, k, v):
    s = torch.einsum("bntd,bnsd->bnts", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bnts,bnsd->bntd", torch.softmax(s, -1), v)


def j_bhtd(q, k, v):
    s = jnp.einsum("bntd,bnsd->bnts", q, k) / jnp.sqrt(q.shape[-1] * 1.0)
    return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s, -1), v)


def t_bhtd_matmul(q, k, v):
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(
        q.shape[-1]))
    return torch.matmul(torch.softmax(s, -1), v)


def j_bhtd_matmul(q, k, v):
    s = jnp.einsum("bntd,bnsd->bnts", q, k) * (1.0 / np.sqrt(q.shape[-1]))
    return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s, -1), v)


def t_causal(q, k, v):
    t = q.shape[2]
    s = torch.einsum("bntd,bnsd->bnts", q, k) / math.sqrt(q.shape[-1])
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool))
    s = torch.where(mask, s, torch.tensor(-1e9))
    return torch.einsum("bnts,bnsd->bntd", torch.softmax(s, -1), v)


def j_causal(q, k, v):
    t = q.shape[2]
    s = jnp.einsum("bntd,bnsd->bnts", q, k) / jnp.sqrt(jnp.float32(
        q.shape[-1]))
    mask = jnp.tril(jnp.ones((t, t), dtype=bool))
    s = jnp.where(mask, s, jnp.float32(-1e9))
    return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s, -1), v)


QKV2 = ((8, 16), (8, 16), (8, 16))
QKV4 = ((2, 3, 8, 16), (2, 3, 8, 16), (2, 3, 8, 16))
ATTENTION = {
    "2d": (t_naive2d, j_naive2d, QKV2),
    "bhtd_einsum": (t_bhtd, j_bhtd, QKV4),
    "bhtd_matmul": (t_bhtd_matmul, j_bhtd_matmul, QKV4),
    "unscaled": (lambda q, k, v: torch.softmax(q @ k.T, -1) @ v,
                 lambda q, k, v: jax.nn.softmax(q @ k.T, axis=-1) @ v,
                 QKV2),
    "mul_scaled": (lambda q, k, v: torch.softmax((q @ k.T) * 0.25, -1) @ v,
                   lambda q, k, v: jax.nn.softmax((q @ k.T) * 0.25,
                                                  axis=-1) @ v, QKV2),
    "causal_where": (t_causal, j_causal, QKV4),
}


@pytest.mark.parametrize("name", list(ATTENTION))
def test_fuse_attention_rewrites_and_matches(name):
    tfn, jfn, shapes = ATTENTION[name]
    arrays = _arrays(*shapes)
    _same(tfn, jfn, *arrays, count=1)


@pytest.mark.parametrize("name", ["2d", "bhtd_einsum", "causal_where"])
def test_fuse_attention_gradients_match(name):
    tfn, jfn, shapes = ATTENTION[name]
    _grads_same(tfn, jfn, *_arrays(*shapes))


def test_runtime_scalar_scale_still_fuses():
    arrays = _arrays(*QKV2) + [np.float32(0.3)]
    _same(lambda q, k, v, s: torch.softmax((q @ k.T) * s, -1) @ v,
          lambda q, k, v, s: jax.nn.softmax((q @ k.T) * s, axis=-1) @ v,
          *arrays[:3], np.asarray(arrays[3]), count=1)


def _spy(monkeypatch):
    calls = []
    real = port_attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append(sorted(kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    return calls


def test_causal_tril_routes_to_is_causal(monkeypatch):
    calls = _spy(monkeypatch)
    _same(t_causal, j_causal, *_arrays(*QKV4), count=1)
    assert calls == [["is_causal"]]


def test_causal_where_2d_layout(monkeypatch):
    def tf(q, k, v):
        t = q.shape[0]
        s = q @ k.T / math.sqrt(q.shape[-1])
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool))
        s = torch.where(mask, s, torch.tensor(-1e30))
        return torch.softmax(s, -1) @ v

    def jf(q, k, v):
        t = q.shape[0]
        s = q @ k.T / jnp.sqrt(q.shape[-1] * 1.0)
        mask = jnp.tril(jnp.ones((t, t), dtype=bool))
        s = jnp.where(mask, s, jnp.float32(-1e30))
        return jax.nn.softmax(s, axis=-1) @ v

    calls = _spy(monkeypatch)
    _same(tf, jf, *_arrays(*QKV2), count=1)
    assert calls == [["is_causal"]]


def test_additive_const_causal_bias_routes_to_is_causal(monkeypatch):
    def tf(q, k, v):
        t = q.shape[2]
        s = torch.einsum("bntd,bnsd->bnts", q, k) * (1.0 / np.sqrt(16))
        bias = torch.where(torch.tril(torch.ones((t, t), dtype=torch.bool)),
                           torch.tensor(0.0), torch.tensor(-1e9))
        return torch.einsum("bnts,bnsd->bntd", torch.softmax(s + bias, -1),
                            v)

    def jf(q, k, v):
        t = q.shape[2]
        s = jnp.einsum("bntd,bnsd->bnts", q, k) * (1.0 / np.sqrt(16))
        bias = jnp.where(jnp.tril(jnp.ones((t, t), dtype=bool)),
                         jnp.float32(0.0), jnp.float32(-1e9))
        return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s + bias, -1), v)

    calls = _spy(monkeypatch)
    _same(tf, jf, *_arrays(*QKV4), count=1)
    assert calls == [["is_causal"]]


def test_runtime_masks_route_attn_mask(monkeypatch):
    q, k, v = _arrays(*QKV4)
    pad = np.ones((2, 1, 1, 8), bool)
    pad[0, ..., 6:] = False
    bias = _arrays((2, 1, 8, 8), seed=3)[0]

    def tf(q, k, v, pad):
        s = torch.einsum("bntd,bnsd->bnts", q, k) / 4.0
        s = torch.where(pad, s, torch.tensor(-1e9))
        return torch.einsum("bnts,bnsd->bntd", torch.softmax(s, -1), v)

    def jf(q, k, v, pad):
        s = jnp.einsum("bntd,bnsd->bnts", q, k) / 4.0
        s = jnp.where(pad, s, jnp.float32(-1e9))
        return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s, -1), v)

    def tb(q, k, v, bias):
        s = torch.einsum("bntd,bnsd->bnts", q, k) * 0.25
        return torch.einsum("bnts,bnsd->bntd", torch.softmax(s + bias, -1),
                            v)

    def jb(q, k, v, bias):
        s = jnp.einsum("bntd,bnsd->bnts", q, k) * 0.25
        return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s + bias, -1), v)

    calls = _spy(monkeypatch)
    _same(tf, jf, q, k, v, pad, count=1)
    _same(tb, jb, q, k, v, bias, count=1)
    assert calls == [["attn_mask"], ["attn_mask"]]
    _grads_same(tf, jf, q, k, v, pad)


def test_const_non_causal_mask_routes_attn_mask(monkeypatch):
    blk = np.kron(np.eye(2, dtype=bool), np.ones((4, 4), bool))

    def tf(q, k, v):
        s = torch.einsum("bntd,bnsd->bnts", q, k) / 4.0
        s = torch.where(torch.from_numpy(blk), s, torch.tensor(-1e9))
        return torch.einsum("bnts,bnsd->bntd", torch.softmax(s, -1), v)

    def jf(q, k, v):
        s = jnp.einsum("bntd,bnsd->bnts", q, k) / 4.0
        s = jnp.where(jnp.asarray(blk), s, jnp.float32(-1e9))
        return jnp.einsum("bnts,bnsd->bntd", jax.nn.softmax(s, -1), v)

    calls = _spy(monkeypatch)
    _same(tf, jf, *_arrays(*QKV4), count=1)
    assert calls == [["attn_mask"]]


def _leaky_t(q, k, v):
    p = torch.softmax(q @ k.T, -1)
    return p @ v, p


def _leaky_j(q, k, v):
    p = jax.nn.softmax(q @ k.T, axis=-1)
    return p @ v, p


DECLINES = {
    "no_attention": (lambda q, k, v: torch.tanh(q) + k,
                     lambda q, k, v: jnp.tanh(q) + k, QKV2),
    "classifier_softmax": (lambda q, k, v: torch.softmax(q @ k.T, -1),
                           lambda q, k, v: jax.nn.softmax(q @ k.T, -1),
                           QKV2),
    "shaped_multiplier": (
        lambda q, k, v: torch.softmax((q @ k.T) * (k @ k.T), -1) @ v,
        lambda q, k, v: jax.nn.softmax((q @ k.T) * (k @ k.T), -1) @ v,
        QKV2),
    "non_last_axis_softmax": (
        lambda q, k, v: torch.softmax(q @ k.T, 0) @ v,
        lambda q, k, v: jax.nn.softmax(q @ k.T, axis=0) @ v, QKV2),
    "upsizing_broadcast": (
        lambda q, k, v: torch.softmax(q[:1] @ k.T, -1).expand(6, 8) @ v,
        lambda q, k, v: jnp.broadcast_to(
            jax.nn.softmax(q[:1] @ k.T, -1), (6, 8)) @ v, QKV2),
    "small_fill": (
        lambda q, k, v: torch.softmax(torch.where(
            torch.tril(torch.ones((8, 8), dtype=torch.bool)), q @ k.T,
            torch.tensor(-1.0)), -1) @ v,
        lambda q, k, v: jax.nn.softmax(jnp.where(
            jnp.tril(jnp.ones((8, 8), dtype=bool)), q @ k.T,
            jnp.float32(-1.0)), -1) @ v, QKV2),
}


@pytest.mark.parametrize("name", list(DECLINES))
def test_fuse_attention_declines(name):
    tfn, jfn, shapes = DECLINES[name]
    _same(tfn, jfn, *_arrays(*shapes), count=0)


def test_interior_reuse_blocks_rewrite():
    arrays = _arrays(*QKV2)
    opt, jopt = ir.optimize(_leaky_t), jir.optimize(_leaky_j)
    out = opt(*[torch.from_numpy(a) for a in arrays])
    jout = jax.jit(jopt)(*arrays)
    assert opt.last_rewrite_count == jopt.last_rewrite_count == 0
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_upsizing_mask_declines():
    pad = np.ones((3, 8, 8), bool)

    def tf(q, k, v, pad):
        s = torch.where(pad, q @ k.T / 4.0, torch.tensor(-1e9))
        return torch.softmax(s, -1) @ v

    def jf(q, k, v, pad):
        s = jnp.where(pad, q @ k.T / 4.0, jnp.float32(-1e9))
        return jax.nn.softmax(s, axis=-1) @ v

    _same(tf, jf, *_arrays(*QKV2), pad, count=0)


# ----------------------------------------------------- decode_attention --
def _t_decode(q, ck, cv, offset):
    s_max, hd = ck.shape[1], q.shape[-1]
    logits = torch.einsum("bqnd,bknd->bnqk", q, ck) * (1.0 / math.sqrt(hd))
    q_pos = offset + torch.arange(q.shape[1])[:, None]
    k_pos = torch.arange(s_max)[None, :]
    mask = (k_pos <= q_pos)[None, None]
    logits = torch.where(mask, logits, torch.tensor(-1e30))
    att = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", att, cv)


def _j_decode(q, ck, cv, offset):
    s_max, hd = ck.shape[1], q.shape[-1]
    logits = jnp.einsum("bqnd,bknd->bnqk", q, ck) * (1.0 / jnp.sqrt(
        jnp.asarray(hd, q.dtype)))
    q_pos = offset + jnp.arange(q.shape[1])[:, None]
    k_pos = jnp.arange(s_max)[None, :]
    mask = (k_pos <= q_pos)[None, None]
    logits = jnp.where(mask, logits, jnp.asarray(-1e30, q.dtype))
    att = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("bnqk,bknd->bqnd", att, cv)


@pytest.mark.parametrize("t,count", [(1, 1), (2, 0)])
def test_decode_attention_rewrites_one_token_only(t, count):
    q, ck, cv = _arrays((2, t, 4, 16), (2, 24, 4, 16), (2, 24, 4, 16))
    _same(lambda q, ck, cv: _t_decode(q, ck, cv, 9),
          lambda q, ck, cv: _j_decode(q, ck, cv, 9), q, ck, cv,
          count=count)


def test_decode_attention_routes_the_decode_kernel(monkeypatch):
    from paddle_tpu_torch.incubate.nn import functional as fmod

    seen = []
    real = fmod.ragged_decode_attention

    def spy(q, k, v, lengths, **kw):
        seen.append(lengths.tolist())
        return real(q, k, v, lengths, **kw)

    monkeypatch.setattr(fmod, "ragged_decode_attention", spy)
    q, ck, cv = _arrays((3, 1, 4, 16), (3, 24, 4, 16), (3, 24, 4, 16))
    _same(lambda q, ck, cv: _t_decode(q, ck, cv, 5),
          lambda q, ck, cv: _j_decode(q, ck, cv, 5), q, ck, cv, count=1)
    assert seen == [[6, 6, 6]]


# ------------------------------------------------------- fuse_layernorm --
def t_ln(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * w + b


def j_ln(x, w, b):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-5) * w + b


LN = ((4, 6, 32), (32,), (32,))


def test_fuse_layernorm_rewrites_and_matches():
    arrays = _arrays(*LN)
    _same(t_ln, j_ln, *arrays, count=1)
    _grads_same(t_ln, j_ln, *arrays)


def test_fuse_layernorm_bf16_runs_f32_statistics():
    """bf16 x, w, b: both replacements compute the statistics in f32 and
    cast the output back, so they agree to bf16 rounding."""
    x, w, b = _arrays(*LN)
    opt = ir.optimize(t_ln)
    got = opt(*[torch.from_numpy(a).bfloat16() for a in (x, w, b)])
    jopt = jir.optimize(j_ln)
    want = jax.jit(jopt)(*[jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)])
    assert opt.last_rewrite_count == jopt.last_rewrite_count == 1
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


LN_DECLINES = {
    "rms_norm": (
        lambda x, w, b: x * torch.rsqrt((x ** 2).mean(-1, keepdim=True)
                                        + 1e-5) * w + b,
        lambda x, w, b: x * jax.lax.rsqrt((x ** 2).mean(-1, keepdims=True)
                                          + 1e-5) * w + b),
    "ddof1_variance": (
        lambda x, w, b: (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
            ((x - x.mean(-1, keepdim=True)) ** 2).sum(-1, keepdim=True)
            / (x.shape[-1] - 1) + 1e-5) * w + b,
        lambda x, w, b: (x - x.mean(-1, keepdims=True)) * jax.lax.rsqrt(
            ((x - x.mean(-1, keepdims=True)) ** 2).sum(-1, keepdims=True)
            / (x.shape[-1] - 1) + 1e-5) * w + b),
}


@pytest.mark.parametrize("name", list(LN_DECLINES))
def test_fuse_layernorm_declines(name):
    tfn, jfn = LN_DECLINES[name]
    _same(tfn, jfn, *_arrays(*LN), count=0)


def test_fuse_layernorm_reused_mean_declines():
    def tf(x, w, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * w + b), mu

    def jf(x, w, b):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return ((x - mu) * jax.lax.rsqrt(var + 1e-5) * w + b), mu

    arrays = _arrays(*LN)
    opt, jopt = ir.optimize(tf), jir.optimize(jf)
    out = opt(*[torch.from_numpy(a) for a in arrays])
    jout = jax.jit(jopt)(*arrays)
    assert opt.last_rewrite_count == jopt.last_rewrite_count == 0
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=RTOL, atol=ATOL)


# -------------------------------------------------- chunk_cross_entropy --
def test_chunk_cross_entropy_rewrites_and_matches():
    (logits,) = _arrays((6, 40))
    labels = np.array([3, 0, 39, 7, 7, 12], np.int64)

    def tf(lg, lb):
        return torch.gather(torch.log_softmax(lg, -1), 1, lb[:, None])

    def jf(lg, lb):
        return jnp.take_along_axis(jax.nn.log_softmax(lg, -1), lb[:, None],
                                   axis=1)

    _same(tf, jf, logits, labels, count=1)
    _grads_same(tf, jf, logits, labels)


def test_chunk_cross_entropy_axis0_gather_declines():
    (logits,) = _arrays((6, 6))
    idx = np.array([[3, 0, 5, 1, 1, 2]], np.int64)

    def tf(lg, ix):
        return torch.gather(torch.log_softmax(lg, -1), 0, ix)

    def jf(lg, ix):
        return jnp.take_along_axis(jax.nn.log_softmax(lg, -1), ix, axis=0)

    _same(tf, jf, logits, idx, count=0)


def test_pass_registry_matches_the_reference():
    assert list(ir.PASSES) == list(jir.PASSES)
