"""``distribution`` (with its transforms), ``tensor_array``,
``geometric`` and ``strings`` on the port against the JAX package, on
the CPU.

``log_prob``, ``prob``, ``entropy``, ``kl_divergence`` and ``Normal``'s
reparameterised ``rsample`` are functions of the parameters and the
value: held to the JAX package's on the same numpy inputs at 1e-6
(gradients through live parameters too).  Samples come from the port's
seeded ``torch.Generator`` stream, which cannot equal JAX's key stream
draw for draw: they are held by their moments and by repeating under
``paddle.seed``.  (The JAX classes define no ``mean`` or ``variance``;
neither does the port.)
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import distribution as JD

import paddle_tpu_torch as paddle
from paddle_tpu_torch import distribution as D

F32 = np.float32
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


# (class, constructor kwargs, a value inside the support)
CASES = [
    ("Normal", dict(loc=[0.3, -1.0], scale=[1.5, 0.5]), [0.1, -0.7]),
    ("Uniform", dict(low=[0.0, -1.0], high=[2.0, 3.0]), [1.2, 2.5]),
    ("Bernoulli", dict(probs=[0.2, 0.7]), [1.0, 0.0]),
    ("Categorical", dict(logits=[[0.1, 1.0, -0.5], [2.0, 0.0, 0.3]]),
     [2, 0]),
    ("Exponential", dict(rate=[2.0, 0.5]), [0.3, 4.0]),
    ("Laplace", dict(loc=[0.0, 1.0], scale=[1.0, 2.0]), [0.4, -1.0]),
    ("Gamma", dict(concentration=[2.0, 0.7], rate=[1.0, 3.0]), [1.5, 0.2]),
    ("Beta", dict(alpha=[2.0, 0.5], beta=[3.0, 1.5]), [0.3, 0.9]),
    ("LogNormal", dict(loc=[0.0, 0.5], scale=[0.5, 1.0]), [1.3, 0.4]),
    ("Dirichlet", dict(concentration=[1.0, 2.0, 3.0]), [0.2, 0.3, 0.5]),
    ("Multinomial", dict(total_count=5, probs=[0.2, 0.3, 0.5]),
     [1.0, 2.0, 2.0]),
]


def _build(lib, D_, name, kw):
    kw = {k: (lib.to_tensor(np.asarray(v, F32)) if isinstance(v, list)
              else v) for k, v in kw.items()}
    return getattr(D_, name)(**kw)


@pytest.mark.parametrize("name,kw,value", CASES,
                         ids=[c[0] for c in CASES])
def test_densities_and_entropies_match(name, kw, value):
    p, j = _build(paddle, D, name, kw), _build(jpaddle, JD, name, kw)
    v = np.asarray(value, np.int64 if name == "Categorical" else F32)
    np.testing.assert_allclose(_np(p.log_prob(paddle.to_tensor(v))),
                               _np(j.log_prob(jpaddle.to_tensor(v))), **TOL)
    np.testing.assert_allclose(_np(p.prob(paddle.to_tensor(v))),
                               _np(j.prob(jpaddle.to_tensor(v))), **TOL)
    if name not in ("Gamma", "Beta", "LogNormal", "Dirichlet",
                    "Multinomial"):   # the JAX classes have no entropy
        np.testing.assert_allclose(_np(p.entropy()), _np(j.entropy()),
                                   **TOL)
    assert list(p.batch_shape) == list(j.batch_shape)
    assert list(p.event_shape) == list(j.event_shape)


@pytest.mark.parametrize("name,a,b", [
    ("Normal", dict(loc=[0.0, 1.0], scale=[1.0, 2.0]),
     dict(loc=[1.0, -1.0], scale=[2.0, 0.5])),
    ("Categorical", dict(logits=[0.1, 1.0, -0.5]),
     dict(logits=[1.0, 0.0, 0.2])),
    ("Bernoulli", dict(probs=[0.2, 0.9]), dict(probs=[0.5, 0.4])),
])
def test_kl_divergence_matches(name, a, b):
    got = D.kl_divergence(_build(paddle, D, name, a),
                          _build(paddle, D, name, b))
    want = JD.kl_divergence(_build(jpaddle, JD, name, a),
                            _build(jpaddle, JD, name, b))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_gradients_through_live_parameters_match():
    """log_prob, entropy, kl and rsample's ``loc + scale * eps`` backprop
    to the parameters as the JAX tape does (rsample's eps is the port's
    own draw, so its gradient is held to d/dloc = 1, d/dscale = eps)."""
    loc, scale = np.array([0.3, -0.2], F32), np.array([1.2, 0.7], F32)
    v = np.array([0.5, 0.1], F32)
    grads = []
    for lib, D_ in ((paddle, D), (jpaddle, JD)):
        lt = lib.to_tensor(loc, stop_gradient=False)
        st = lib.to_tensor(scale, stop_gradient=False)
        d = D_.Normal(lt, st)
        other = D_.Normal(lib.to_tensor(np.zeros(2, F32)),
                          lib.to_tensor(np.ones(2, F32)))
        total = (d.log_prob(lib.to_tensor(v)).sum() + d.entropy().sum()
                 + D_.kl_divergence(d, other).sum())
        total.backward()
        grads.append((_np(lt.grad), _np(st.grad)))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    lt = paddle.to_tensor(loc, stop_gradient=False)
    st = paddle.to_tensor(scale, stop_gradient=False)
    paddle.seed(5)
    s = D.Normal(lt, st).rsample((3,))
    s.sum().backward()
    paddle.seed(5)
    eps = torch.randn((3, 2), generator=paddle.framework.random.generator(
        "cpu"))
    np.testing.assert_allclose(_np(s), loc + scale * eps.numpy(), **TOL)
    np.testing.assert_allclose(_np(lt.grad), [3.0, 3.0])
    np.testing.assert_allclose(_np(st.grad), eps.sum(0).numpy(), rtol=1e-6)


# (class, kwargs, mean, variance) of the sampled distribution
MOMENTS = [
    ("Normal", dict(loc=[1.0], scale=[2.0]), 1.0, 4.0),
    ("Uniform", dict(low=[-1.0], high=[3.0]), 1.0, 16.0 / 12),
    ("Bernoulli", dict(probs=[0.3]), 0.3, 0.21),
    ("Exponential", dict(rate=[2.0]), 0.5, 0.25),
    ("Laplace", dict(loc=[0.5], scale=[1.5]), 0.5, 4.5),
    ("Gamma", dict(concentration=[2.5], rate=[2.0]), 1.25, 0.625),
    ("Beta", dict(alpha=[2.0], beta=[3.0]), 0.4, 0.04),
    ("LogNormal", dict(loc=[0.0], scale=[0.5]), np.exp(0.125),
     (np.exp(0.25) - 1) * np.exp(0.25)),
]


@pytest.mark.parametrize("name,kw,mean,var", MOMENTS,
                         ids=[m[0] for m in MOMENTS])
def test_samples_by_moments_and_seed(name, kw, mean, var):
    paddle.seed(11)
    d = _build(paddle, D, name, kw)
    s = _np(d.sample((40000,)))
    assert s.shape == (40000, 1)
    assert abs(s.mean() - mean) < 4 * np.sqrt(var / 40000) + 1e-3
    assert abs(s.var() - var) < 0.05 * var
    paddle.seed(11)
    np.testing.assert_array_equal(_np(_build(paddle, D, name, kw).sample(
        (40000,))), s)


def test_categorical_dirichlet_multinomial_samples():
    paddle.seed(2)
    logits = np.array([0.0, 1.0, 2.0], F32)
    p = np.exp(logits) / np.exp(logits).sum()
    c = _np(D.Categorical(paddle.to_tensor(logits)).sample((30000,)))
    np.testing.assert_allclose(np.bincount(c, minlength=3) / 30000, p,
                               atol=0.015)
    a = np.array([1.0, 2.0, 3.0], F32)
    dr = _np(D.Dirichlet(paddle.to_tensor(a)).sample((20000,)))
    np.testing.assert_allclose(dr.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(dr.mean(0), a / a.sum(), atol=0.01)
    m = _np(D.Multinomial(4, paddle.to_tensor(p)).sample((20000,)))
    assert (m.sum(-1) == 4).all()
    np.testing.assert_allclose(m.mean(0), 4 * p, atol=0.05)


TRANSFORMS = [("AffineTransform", (2.0, 3.0)), ("ExpTransform", ()),
              ("SigmoidTransform", ()), ("TanhTransform", ()),
              ("PowerTransform", (2.0,)), ("AbsTransform", ())]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transforms_match(name, args):
    x = np.array([0.3, 0.7, 1.2], F32)
    p, j = getattr(D, name)(*args), getattr(JD, name)(*args)
    y = _np(j.forward(jpaddle.to_tensor(x)))
    np.testing.assert_allclose(_np(p.forward(paddle.to_tensor(x))), y,
                               **TOL)
    np.testing.assert_allclose(_np(p.inverse(paddle.to_tensor(y))),
                               _np(j.inverse(jpaddle.to_tensor(y))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(p.forward_log_det_jacobian(paddle.to_tensor(x))),
        _np(j.forward_log_det_jacobian(jpaddle.to_tensor(x))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        _np(p.inverse_log_det_jacobian(paddle.to_tensor(y))),
        _np(j.inverse_log_det_jacobian(jpaddle.to_tensor(y))), rtol=1e-5,
        atol=1e-6)


def test_jacobians_match_autodiff_in_torch():
    """The port form of the reference body that differentiates with
    ``jax.vmap(jax.grad)``: each transform's log-det-Jacobian is
    log|d forward / dx| by ``torch.func``."""
    x = np.array([0.3, -0.7, 1.2], F32)
    for t in (D.ExpTransform(), D.SigmoidTransform(), D.TanhTransform(),
              D.PowerTransform(3.0)):
        xt = paddle.to_tensor(np.abs(x) if isinstance(
            t, D.PowerTransform) else x)
        ldj = _np(t.forward_log_det_jacobian(xt))
        grad = torch.func.vmap(torch.func.grad(t._forward))(xt._data)
        np.testing.assert_allclose(ldj, np.log(np.abs(grad.numpy())),
                                   rtol=1e-4, atol=1e-5)


def test_chain_and_transformed_distribution():
    chain = [(2.0, 0.5), ()]
    pc = D.ChainTransform([D.AffineTransform(*chain[0]), D.ExpTransform()])
    jc = JD.ChainTransform([JD.AffineTransform(*chain[0]),
                            JD.ExpTransform()])
    x = np.array([0.1, -0.4], F32)
    np.testing.assert_allclose(
        _np(pc.forward_log_det_jacobian(paddle.to_tensor(x))),
        _np(jc.forward_log_det_jacobian(jpaddle.to_tensor(x))), **TOL)
    pt = D.TransformedDistribution(D.Normal(0.0, 1.0), [D.ExpTransform()])
    jt = JD.TransformedDistribution(JD.Normal(0.0, 1.0), [JD.ExpTransform()])
    v = np.array([0.5, 1.7], F32)
    np.testing.assert_allclose(_np(pt.log_prob(paddle.to_tensor(v))),
                               _np(jt.log_prob(jpaddle.to_tensor(v))),
                               rtol=1e-6, atol=1e-6)
    paddle.seed(1)
    assert (_np(pt.sample((500,))) > 0).all()


def test_tensor_array():
    from paddle_tpu_torch import tensor_array as pta

    from paddle_tpu import tensor_array as jta

    for ta, lib in ((pta, paddle), (jta, jpaddle)):
        arr = ta.create_array("float32")
        ta.array_write(lib.to_tensor(np.ones(2, F32)), 0, arr)
        ta.array_write(lib.to_tensor(np.full(2, 3.0, F32)),
                       lib.to_tensor(np.array(2)), arr)
        assert ta.array_length(arr) == 3 and arr[1] is None
        np.testing.assert_array_equal(_np(ta.array_read(arr, 2)), [3, 3])
        arr.write(0, lib.to_tensor(np.zeros(2, F32)))
        np.testing.assert_array_equal(_np(arr.read(0)), [0, 0])
    assert paddle.create_array is pta.create_array


def test_geometric_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 3).astype(F32)
    y = rng.randn(6, 3).astype(F32)
    src = np.array([0, 1, 2, 3, 4, 0], np.int64)
    dst = np.array([1, 2, 1, 0, 4, 4], np.int64)
    seg = np.array([0, 0, 1, 2, 2], np.int64)
    for reduce_op in ("sum", "mean", "max", "min"):
        got = paddle.geometric.send_u_recv(paddle.to_tensor(x),
                                           paddle.to_tensor(src),
                                           paddle.to_tensor(dst),
                                           reduce_op=reduce_op)
        want = jpaddle.geometric.send_u_recv(
            jpaddle.to_tensor(x), jpaddle.to_tensor(src.astype(np.int32)),
            jpaddle.to_tensor(dst.astype(np.int32)), reduce_op=reduce_op)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got = paddle.geometric.send_ue_recv(
        paddle.to_tensor(x), paddle.to_tensor(y), paddle.to_tensor(src),
        paddle.to_tensor(dst), message_op="mul", reduce_op="sum")
    want = jpaddle.geometric.send_ue_recv(
        jpaddle.to_tensor(x), jpaddle.to_tensor(y),
        jpaddle.to_tensor(src.astype(np.int32)),
        jpaddle.to_tensor(dst.astype(np.int32)), message_op="mul",
        reduce_op="sum")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for fn in ("segment_sum", "segment_mean", "segment_max",
               "segment_min"):
        got = getattr(paddle.geometric, fn)(paddle.to_tensor(x),
                                            paddle.to_tensor(seg))
        want = getattr(jpaddle.geometric, fn)(
            jpaddle.to_tensor(x), jpaddle.to_tensor(seg.astype(np.int32)))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_strings_on_the_port():
    s = paddle.strings.to_string_tensor([["Hello", "WORLD"], ["ÀbC", "x"]])
    np.testing.assert_array_equal(paddle.strings.lower(s).numpy(),
                                  [["hello", "world"], ["àbc", "x"]])
    assert paddle.strings.upper(s).shape == [2, 2]


def test_stft_round_trip_with_a_torch_window():
    """The port form of the reference body that passes a jax array as
    the window."""
    x = paddle.to_tensor(np.random.RandomState(3).randn(2, 512).astype(F32))
    win = paddle.to_tensor(np.hanning(128).astype(F32))
    spec = paddle.signal.stft(x, n_fft=128, hop_length=32, window=win)
    assert spec.shape[-2] == 65
    back = paddle.signal.istft(spec, n_fft=128, hop_length=32, window=win,
                               length=512)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-3,
                               atol=1e-3)
