"""The port's ``quantization/`` against the JAX package's.

Every quanter and observer sees the same numpy arrays on both sides:
the fake-quant outputs agree at 1e-6 (the same round/clip composition
in f32), the scales at 1e-6 relative, the histogram observers' scales
exactly (numpy on the host on both sides).  The fake-quant's gradient
is the one each framework's autodiff gives the composition (zero
through ``round``, the scale's through the product), compared at 1e-6.
``QuantizedLinear`` stores equal int8 weights and gives outputs at
1e-5.  A QAT run (three SGD steps through fake-quant, then ``convert``)
and a PTQ run (calibration, then ``convert``) follow the JAX runs on
the same weights: losses at 1e-5, converted outputs at 1e-5, int8
weights equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu.quantization as JQ
import paddle_tpu_torch as paddle
import paddle_tpu_torch.quantization as Q
from paddle_tpu_torch import nn
from torch_ref_helpers import jax_twin

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pt(a):
    return paddle.to_tensor(a)


def _jt(a):
    return J.to_tensor(a)


def _jax_fake_quant(x, scale, bits=8):
    """The body of ``paddle_tpu/quantization/__init__.py::_fake_quant``
    on raw arrays (the op wraps its output in a Tensor)."""
    qmax = 2.0 ** (bits - 1) - 1
    s = jnp.maximum(scale, 1e-9)
    q = jnp.clip(jnp.round(x / s * qmax), -qmax, qmax)
    return q * s / qmax


def test_fake_quant_values_and_gradient_match_jax():
    x = _x(64, seed=1, scale=2.0)
    r = _x(64, seed=2)
    for scale in (0.7, 3.0):
        got = Q._fake_quant(torch.from_numpy(x), torch.tensor(scale))
        want = JQ._fake_quant(jnp.asarray(x), jnp.float32(scale))
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.tensor(scale, requires_grad=True)
        (Q._fake_quant(xt, st) * torch.from_numpy(r)).sum().backward()
        gx, gs = jax.grad(
            lambda a, s: (_jax_fake_quant(a, s) * r).sum(), (0, 1))(
            jnp.asarray(x), jnp.float32(scale))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=1e-6)
        np.testing.assert_allclose(float(st.grad), float(gs), rtol=1e-6)


@pytest.mark.parametrize("name", ["FakeQuanterWithAbsMaxObserver",
                                  "AbsmaxObserver",
                                  "MovingAverageAbsMaxObserver",
                                  "HistObserver", "KLObserver"])
def test_observers_match_jax_over_batches(name):
    kw = {"bins": 512} if name in ("HistObserver", "KLObserver") else {}
    port, ref = getattr(Q, name)(**kw), getattr(JQ, name)(**kw)
    for i, s in enumerate((1.0, 3.0, 0.5)):
        x = _x(4, 96, seed=10 + i, scale=s)
        got, want = port(_pt(x)), ref(_jt(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(port.scales(), ref.scales(), rtol=1e-6)


@pytest.mark.parametrize("axis", [-1, 0])
def test_per_channel_quanter_matches_jax(axis):
    w = _x(12, 5, seed=3)
    w[:, 1] *= 40.0
    port = Q.PerChannelAbsMaxQuanter(channel_axis=axis)
    ref = JQ.PerChannelAbsMaxQuanter(channel_axis=axis)
    np.testing.assert_allclose(port(_pt(w)).numpy(), ref(_jt(w)).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.scales(), ref.scales(), rtol=1e-6)


@pytest.mark.parametrize("scales", ["per_channel", "per_tensor"])
def test_quantized_linear_matches_jax(scales):
    paddle.seed(0)
    lin = nn.Linear(16, 8)
    jlin = jax_twin(lambda: J.nn.Linear(16, 8), lin)
    w = lin.weight.numpy()
    sc = np.abs(w).max(0) if scales == "per_channel" \
        else np.float32(np.abs(w).max())
    port, ref = Q.QuantizedLinear(lin, sc), JQ.QuantizedLinear(jlin, sc)
    assert port.qweight._data.dtype == torch.int8
    np.testing.assert_array_equal(port.qweight.numpy(), ref.qweight.numpy())
    x = _x(3, 16, seed=4)
    np.testing.assert_allclose(port(_pt(x)).numpy(), ref(_jt(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


def _mlp(mod):
    return mod.nn.Sequential(mod.nn.Linear(8, 16), mod.nn.ReLU(),
                             mod.nn.Linear(16, 1))


def test_qat_round_trip_follows_jax():
    paddle.seed(0)
    pm = _mlp(paddle)
    jm = jax_twin(lambda: _mlp(J), pm)
    cfgs = [m.QuantConfig(activation=m.FakeQuanterWithAbsMaxObserver,
                          weight=m.PerChannelAbsMaxQuanter)
            for m in (Q, JQ)]
    qat, jqat = Q.QAT(cfgs[0]), JQ.QAT(cfgs[1])
    pm, jm = qat.quantize(pm), jqat.quantize(jm)
    opt = paddle.optimizer.SGD(learning_rate=0.05,
                               parameters=pm.parameters())
    jopt = J.optimizer.SGD(learning_rate=0.05, parameters=jm.parameters())
    X = _x(32, 8, seed=5)
    Y = X.sum(1, keepdims=True)
    for _ in range(3):
        loss = ((pm(_pt(X)) - _pt(Y)) ** 2).mean()
        jloss = ((jm(_jt(X)) - _jt(Y)) ** 2).mean()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        loss.backward()
        jloss.backward()
        opt.step()
        jopt.step()
        opt.clear_grad()
        jopt.clear_grad()
    dep, jdep = qat.convert(pm), jqat.convert(jm)
    kinds = [type(s).__name__ for _, s in dep.named_sublayers()]
    assert kinds.count("QuantizedLinear") == 2
    np.testing.assert_allclose(dep(_pt(X)).numpy(), jdep(_jt(X)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_ptq_round_trip_follows_jax():
    paddle.seed(0)
    pm = _mlp(paddle)
    jm = jax_twin(lambda: _mlp(J), pm)
    cfgs = [m.QuantConfig(activation=m.AbsmaxObserver,
                          weight=m.PerChannelAbsMaxQuanter)
            for m in (Q, JQ)]
    ptq, jptq = Q.PTQ(cfgs[0]), JQ.PTQ(cfgs[1])
    pm, jm = ptq.quantize(pm), jptq.quantize(jm)
    for i in range(3):
        x = _x(16, 8, seed=20 + i)
        np.testing.assert_allclose(pm(_pt(x)).numpy(), jm(_jt(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)
    dep, jdep = ptq.convert(pm), jptq.convert(jm)
    got = [s for _, s in dep.named_sublayers()
           if isinstance(s, Q.QuantizedLinear)]
    want = [s for _, s in jdep.named_sublayers()
            if isinstance(s, JQ.QuantizedLinear)]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert str(a.qweight.dtype) == "torch.int8"
        np.testing.assert_array_equal(a.qweight.numpy(), b.qweight.numpy())
        np.testing.assert_allclose(a.scales.numpy(), b.scales.numpy(),
                                   rtol=1e-6)
    x = _x(5, 8, seed=30)
    np.testing.assert_allclose(dep(_pt(x)).numpy(), jdep(_jt(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_observers_do_not_move_under_a_trace():
    """Under ``to_static`` the observers keep their host statistics and
    the QAT quanter quantizes with the batch's own abs-max, as under
    the JAX trace."""
    ob = Q.AbsmaxObserver()
    fq = Q.FakeQuanterWithAbsMaxObserver()
    f = paddle.jit.to_static(lambda x: fq(ob(x)))
    x = _x(6, seed=6, scale=2.0)
    out = f(_pt(x))
    assert ob.scales() == 0.0 and fq.scales() is None
    want = _jax_fake_quant(jnp.asarray(x), jnp.float32(np.abs(x).max()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
