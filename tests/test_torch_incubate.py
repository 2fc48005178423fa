"""The incubate namespace on the port against the JAX package, on the
CPU: ``asp``'s n:m masks and their re-application through training,
``incubate.autograd``'s functional transforms (``torch.func`` against
``jax``), and ``LookAhead`` / ``ModelAverage`` over 5 steps at 1e-6 from
the same numpy weights, with their state crossing between the packages.
"""

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import incubate as jincubate
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt

import paddle_tpu_torch as paddle
from paddle_tpu_torch import incubate, nn, optimizer

F32 = np.float32


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


def _mlps(seed=0):
    """The same 8-16-4 MLP in both packages (numpy weights)."""
    rng = np.random.RandomState(seed)
    sd = {"0.weight": rng.randn(8, 16).astype(F32) * 0.3,
          "0.bias": rng.randn(16).astype(F32) * 0.1,
          "2.weight": rng.randn(16, 4).astype(F32) * 0.3,
          "2.bias": rng.randn(4).astype(F32) * 0.1}
    pm = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    pm.set_state_dict(sd)
    jm.set_state_dict({k: jpaddle.to_tensor(v) for k, v in sd.items()})
    return pm, jm


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(32, 8).astype(F32), rng.randn(32, 4).astype(F32)


def _step(model, opt, lib, x, y):
    loss = lib.nn.functional.mse_loss(model(lib.to_tensor(x)),
                                      lib.to_tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


def _params_close(pm, jm, tol=1e-6):
    for p, j in zip(pm.parameters(), jm.parameters()):
        np.testing.assert_allclose(_np(p), _np(j), rtol=tol, atol=tol)


# ------------------------------------------------------------------- asp --
def test_masks_and_density_match():
    rng = np.random.RandomState(2)
    for shape in ((8, 16), (3, 4, 8), (5, 6)):
        w = rng.randn(*shape).astype(F32)
        got = incubate.asp.create_mask(paddle.to_tensor(w))
        want = jincubate.asp.create_mask(jpaddle.to_tensor(w))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            incubate.asp.create_mask(w, n=1, m=4),
            jincubate.asp.create_mask(w, n=1, m=4))
        assert incubate.asp.calculate_density(w * got) == \
            jincubate.asp.calculate_density(w * want)


def test_prune_and_decorated_training_match():
    """prune_model then 5 SGD steps through asp.decorate: the pruned
    coordinates stay zero and the weights equal the reference's."""
    pm, jm = _mlps()
    incubate.asp.prune_model(pm)
    jincubate.asp.prune_model(jm)
    _params_close(pm, jm)
    po = incubate.asp.decorate(optimizer.SGD(learning_rate=0.1,
                                             parameters=pm.parameters()))
    jo = jincubate.asp.decorate(jopt.SGD(learning_rate=0.1,
                                         parameters=jm.parameters()))
    x, y = _data()
    for _ in range(5):
        assert abs(_step(pm, po, paddle, x, y)
                   - _step(jm, jo, jpaddle, x, y)) < 1e-6
    _params_close(pm, jm)
    for w in (pm[0].weight, pm[2].weight):
        assert incubate.asp.calculate_density(w) == 0.5


# ------------------------------------------------------------ autograd --
def _f(lib):
    def f(x, y):
        return lib.tanh(x) * y + x * x
    return f


def test_functional_transforms_match():
    from paddle_tpu.incubate import autograd as jag

    from paddle_tpu_torch.incubate import autograd as pag

    rng = np.random.RandomState(3)
    x, y, v = (rng.randn(4).astype(F32) for _ in range(3))
    pf, jf = _f(paddle), _f(jpaddle)
    px, py = paddle.to_tensor(x), paddle.to_tensor(y)
    jx, jy = jpaddle.to_tensor(x), jpaddle.to_tensor(y)

    def close(a, b):
        if isinstance(a, (list, tuple)):
            for p, q in zip(a, b):
                close(p, q)
            return
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)

    close(pag.jvp(pf, [px, py])[1], jag.jvp(jf, [jx, jy])[1])
    close(pag.jvp(pf, [px, py], [paddle.to_tensor(v)] * 2),
          jag.jvp(jf, [jx, jy], [jpaddle.to_tensor(v)] * 2))
    close(pag.vjp(pf, [px, py])[1], jag.vjp(jf, [jx, jy])[1])
    close(pag.vjp(pf, [px, py], paddle.to_tensor(v))[1],
          jag.vjp(jf, [jx, jy], jpaddle.to_tensor(v))[1])
    close(pag.grad(pf, [px, py]), jag.grad(jf, [jx, jy]))
    close(pag.grad(lambda a: paddle.sum(a * a * a), px),
          jag.grad(lambda a: jpaddle.sum(a * a * a), jx))
    close(pag.forward_grad(lambda a: paddle.exp(a), px),
          jag.forward_grad(lambda a: jpaddle.exp(a), jx))
    pj = pag.Jacobian(lambda a: paddle.tanh(a) * 2.0, px)
    jj = jag.Jacobian(lambda a: jpaddle.tanh(a) * 2.0, jx)
    close(pj[:], jj[:])
    assert pj.shape == jj.shape
    close(pag.Jacobian(pf, [px, py])[:], jag.Jacobian(jf, [jx, jy])[:])
    ph = pag.Hessian(lambda a, b: paddle.sum(a * a * b), [px, py])
    jh = jag.Hessian(lambda a, b: jpaddle.sum(a * a * b), [jx, jy])
    close(ph[:], jh[:])
    assert ph.shape == jh.shape == [8, 8]
    # plain inputs become f32 tensors, as jnp.asarray makes them
    close(pag.grad(lambda a: paddle.sum(a * a), np.ones(3)),
          jag.grad(lambda a: jpaddle.sum(a * a), np.ones(3)))


def test_prim_flags_keep_the_contract():
    from paddle_tpu_torch.incubate import autograd as pag

    assert not pag.prim_enabled()
    pag.enable_prim()
    assert pag.prim_enabled()
    pag.disable_prim()
    assert not pag.prim_enabled()


def test_create_graph_grad_carries_its_own_graph():
    """The port form of the reference body that reads the JAX tape's
    ``_node``: after ``backward(create_graph=True)`` the gradient is
    itself differentiable (torch's ``grad_fn``)."""
    x = paddle.to_tensor(np.array([1.5], F32), stop_gradient=False)
    y = paddle.sum(x * x)
    y.backward(create_graph=True)
    np.testing.assert_allclose(_np(x.grad), [3.0], rtol=1e-6)
    assert x._data.grad.grad_fn is not None
    x._data.grad = None   # the cycle torch warns about


# ------------------------------------------------ LookAhead, ModelAverage --
def test_lookahead_matches_and_its_state_crosses():
    pm, jm = _mlps()
    po = incubate.LookAhead(optimizer.SGD(learning_rate=0.1,
                                          parameters=pm.parameters()),
                            alpha=0.5, k=2)
    jo = jincubate.LookAhead(jopt.SGD(learning_rate=0.1,
                                      parameters=jm.parameters()),
                             alpha=0.5, k=2)
    x, y = _data()
    for _ in range(5):
        np.testing.assert_allclose(_step(pm, po, paddle, x, y),
                                   _step(jm, jo, jpaddle, x, y), rtol=1e-6)
        _params_close(pm, jm)
    # the port's state, carried into a fresh port wrapper, continues
    # exactly as the reference does from its own attributes
    sd = po.state_dict()
    for i, p in enumerate(jm.parameters()):
        np.testing.assert_allclose(sd[f"lookahead.slow.param{i}"].numpy(),
                                   np.asarray(jo._slow[id(p)]), rtol=1e-6,
                                   atol=1e-6)
    pm2, _ = _mlps()
    pm2.set_state_dict({k: v.numpy() for k, v in pm.state_dict().items()})
    po2 = incubate.LookAhead(optimizer.SGD(learning_rate=0.1,
                                           parameters=pm2.parameters()),
                             alpha=0.5, k=2)
    po2.set_state_dict({k: (v.numpy() if hasattr(v, "numpy") else v)
                        for k, v in sd.items()})
    for _ in range(3):
        np.testing.assert_allclose(_step(pm2, po2, paddle, x, y),
                                   _step(jm, jo, jpaddle, x, y), rtol=1e-6)
    _params_close(pm2, jm)


def test_model_average_matches_and_its_state_crosses():
    pm, jm = _mlps()
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    kw = dict(average_window_rate=0.5, min_average_window=2,
              max_average_window=3)
    pa = incubate.ModelAverage(parameters=pm.parameters(), **kw)
    ja = jincubate.ModelAverage(parameters=jm.parameters(), **kw)
    x, y = _data()
    for _ in range(5):
        _step(pm, po, paddle, x, y)
        _step(jm, jo, jpaddle, x, y)
        pa.step()
        ja.step()
    assert (pa._count, pa._old_count) == (ja._count, ja._old_count)
    with pa, ja:
        _params_close(pm, jm)
        averaged = [_np(p).copy() for p in pm.parameters()]
    _params_close(pm, jm)           # restored
    # the reference's sums, carried into a fresh port ModelAverage
    sd = {"count": ja._count, "old_count": ja._old_count,
          "num_updates": ja._num_updates}
    for i, p in enumerate(jm.parameters()):
        sd[f"sum.param{i}"] = np.asarray(ja._sum[id(p)])
        sd[f"old_sum.param{i}"] = np.asarray(ja._old_sum[id(p)])
    pa2 = incubate.ModelAverage(parameters=pm.parameters(), **kw)
    pa2.set_state_dict(sd)
    pa2.apply()
    for p, want in zip(pm.parameters(), averaged):
        np.testing.assert_allclose(_np(p), want, rtol=1e-6, atol=1e-6)
    pa2.restore()
    back = pa2.state_dict()
    for i in range(4):
        np.testing.assert_array_equal(back[f"sum.param{i}"].numpy(),
                                      sd[f"sum.param{i}"])
