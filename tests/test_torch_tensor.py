"""The port's eager ``Tensor`` and autograd against the JAX package's.

The same numpy inputs go through ``paddle_tpu`` (the JAX reference, its
own tape) and ``paddle_tpu_torch`` (torch autograd); values and
gradients must agree at 1e-6.  Covers ``backward`` (accumulation,
``grad_tensor``, ``retain_graph``), ``paddle.grad`` (``create_graph``,
``allow_unused``), hooks, indexing, the in-place rebinds (with the JAX
package's ``__setitem__`` quirk kept), ``astype``, ``stop_gradient``,
``no_grad``, ``PyLayer``, the pickle payload, the raw-torch pass-through
of a registered op, and the device rule.
"""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.core.tensor import Tensor as JTensor

import paddle_tpu_torch as P
from paddle_tpu_torch.core.tensor import Tensor as PTensor
from paddle_tpu_torch.framework import device as pdevice
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.registry import OPS

TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
W = np.random.RandomState(1).uniform(-1, 1, (3, 4)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def both(fn):
    """``fn(paddle_module)`` run on each package -> (JAX, port)."""
    return fn(J), fn(P)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a.numpy()), b.numpy(), **TOL)


def test_backward_accumulates_like_the_reference():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        y = (p.sin(x) * x + x * 2.0).sum()
        y.backward(retain_graph=True)
        y.backward()
        return x
    jx, px = both(run)
    close(jx.grad, px.grad)
    assert px.is_leaf and not px.stop_gradient


def test_backward_with_grad_tensor_and_nonscalar_error():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        (x * x).backward(p.to_tensor(W))
        return x
    jx, px = both(run)
    close(jx.grad, px.grad)
    for p in (J, P):
        x = p.to_tensor(X, stop_gradient=False)
        with pytest.raises(RuntimeError, match="scalar outputs"):
            (x * x).backward()


def test_paddle_grad_create_graph_second_order():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = p.grad([y], [x], create_graph=True)
        z = (g * g).sum()
        z.backward()
        return g, x
    (jg, jx), (pg, px) = both(run)
    close(jg, pg)
    close(jx.grad, px.grad)
    assert not pg.stop_gradient


def test_paddle_grad_leaves_grad_alone_and_allow_unused():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        u = p.to_tensor(W, stop_gradient=False)
        y = (p.exp(x)).sum()
        g, gu = p.grad(y, [x, u], allow_unused=True, retain_graph=True)
        with pytest.raises(RuntimeError, match="unused"):
            p.grad(y, [x, u])
        return g, gu, x
    (jg, jgu, jx), (pg, pgu, px) = both(run)
    close(jg, pg)
    assert jgu is None and pgu is None
    assert jx.grad is None and px.grad is None
    assert pg.stop_gradient


def test_hooks_on_leaf_and_intermediate():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        h = x * 3.0
        seen = []
        h.register_hook(lambda g: seen.append(g.numpy().copy()) or g * 2.0)
        handle = x.register_hook(lambda g: g + 1.0)
        # (the JAX tape runs a hook once per incoming edge, torch once on
        # their sum: one use of h keeps the two the same)
        (h * p.to_tensor(W)).sum().backward()
        handle.remove()
        return x, seen[0]
    (jx, jseen), (px, pseen) = both(run)
    close(jx.grad, px.grad)
    np.testing.assert_allclose(jseen, pseen, **TOL)


@pytest.mark.parametrize("index", [
    1, (slice(0, 2), 1), (Ellipsis, slice(1, 3)), "int_tensor", "bool_mask"])
def test_getitem_forward_and_grad(index):
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        idx = index
        if index == "int_tensor":
            idx = p.to_tensor(np.array([2, 0]))
        elif index == "bool_mask":
            idx = p.to_tensor(X > 0)
        y = x[idx]
        (y * y).sum().backward()
        return y, x
    (jy, jx), (py, px) = both(run)
    close(jy, py)
    close(jx.grad, px.grad)


def test_setitem_rebinds_and_keeps_the_old_graph():
    """The JAX package's ``__setitem__`` rebinds the value and records
    nothing: the written value gets no gradient, and a gradient through
    the written tensor reaches the old value's graph unmasked.  The
    port keeps that (ROADMAP C, a reference caveat)."""
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        v = p.to_tensor(W[0], stop_gradient=False)
        h = x * 2.0
        h[1] = v
        (h * 3.0).sum().backward()
        return h, x, v
    (jh, jx, jv), (ph, px, pv) = both(run)
    close(jh, ph)
    close(jx.grad, px.grad)
    assert jv.grad is None and pv.grad is None


@pytest.mark.parametrize("write", ["set_value", "zero_", "fill_",
                                   "setitem"])
def test_in_place_writes_on_a_leaf_keep_it_trainable(write):
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        (x * x).sum().backward()
        {"set_value": lambda: x.set_value(W), "zero_": x.zero_,
         "fill_": lambda: x.fill_(0.5),
         "setitem": lambda: x.__setitem__((0, 1), 7.0)}[write]()
        (x * 2.0).sum().backward()
        return x
    jx, px = both(run)
    close(jx, px)
    close(jx.grad, px.grad)
    assert px.is_leaf and not px.stop_gradient


def test_astype_cast_and_grad_through_cast():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        y = x.astype("float64").astype("float32") * x
        y.sum().backward()
        return x.astype("int32"), x.cast("bool"), x
    (ji, jb, jx), (pi, pb, px) = both(run)
    np.testing.assert_array_equal(ji.numpy(), pi.numpy())
    np.testing.assert_array_equal(jb.numpy(), pb.numpy())
    assert pi.dtype == torch.int32 and pb.dtype == torch.bool
    close(jx.grad, px.grad)


def test_stop_gradient_semantics():
    for p in (J, P):
        a = p.to_tensor(X)
        b = p.to_tensor(W, stop_gradient=False)
        assert a.stop_gradient and not b.stop_gradient
        assert (a * 2.0).stop_gradient and not (a * b).stop_gradient
        assert (a * b).detach().stop_gradient
        with p.no_grad():
            assert (a * b).stop_gradient
        a.stop_gradient = False
        assert not (a * 2.0).stop_gradient
        c = b * 2.0
        c.stop_gradient = True
        (c * b).sum().backward()
        assert b.grad is not None
    ji = J.to_tensor(np.array([1, 2]))
    pi = P.to_tensor(np.array([1, 2]))
    assert (ji == ji).stop_gradient and (pi == pi).stop_gradient


def test_pylayer_matches_the_reference():
    def run(p):
        class Cube(p.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                return x * x * x * k

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor
                return dy * 3.0 * x * x

        x = p.to_tensor(X, stop_gradient=False)
        y = Cube.apply(x, 2.0)
        y.sum().backward()
        return y, x
    (jy, jx), (py, px) = both(run)
    close(jy, py)
    close(jx.grad, px.grad)


def test_pickle_payload_is_the_reference_payload():
    jt = J.to_tensor(X, stop_gradient=False)
    pt = P.to_tensor(X, stop_gradient=False)
    jr, pr = jt.__reduce__()[1], pt.__reduce__()[1]
    np.testing.assert_array_equal(np.asarray(jr[1]), pr[1])
    assert jr[2:] == pr[2:]
    back = pickle.loads(pickle.dumps(pt))
    assert isinstance(back, PTensor) and not back.stop_gradient
    np.testing.assert_array_equal(back.numpy(), X)


def test_metadata_and_conversions():
    jt, pt = J.to_tensor(X), P.to_tensor(X)
    assert jt.shape == pt.shape == [3, 4]
    assert jt.ndim == pt.ndim and jt.size == pt.size and len(jt) == len(pt)
    assert pt.place == P.CPUPlace() and P.get_device() == "cpu"
    assert pt.T.shape == [4, 3] and [r.shape for r in pt] == [[4]] * 3
    assert pt[0, 0].item() == pytest.approx(float(X[0, 0]))
    np.testing.assert_allclose(pt.tolist(), X.tolist())
    assert P.to_tensor(2).dtype == torch.int64
    assert P.to_tensor(2.5).dtype == torch.float32
    assert "Tensor(shape=[3, 4], dtype=float32" in repr(pt)
    assert isinstance(pt, PTensor) and isinstance(jt, JTensor)


def test_registered_op_passes_raw_torch_through():
    """A call holding no Tensor is the body on raw torch tensors: what
    the port's GPT, engine and TrainStep rely on."""
    a, b = torch.randn(3, 4), torch.randn(3, 4)
    out = OPS["add"].user_fn(a, b)
    assert type(out) is torch.Tensor and torch.equal(out, a + b)
    g = PF.gelu(a, approximate=True)
    assert type(g) is torch.Tensor
    assert torch.equal(g, torch.nn.functional.gelu(a, approximate="tanh"))
    assert type(PF.layer_norm(a, 4)) is torch.Tensor
    cat = OPS["concat"].user_fn([P.to_tensor(X), P.to_tensor(W)], axis=0)
    assert isinstance(cat, PTensor) and cat.shape == [6, 4]


def test_top_level_exports_follow_the_reference():
    """The port's namespace holds only names the JAX package's holds
    (and the port's own ``resolve_device``)."""
    extra = {n for n in dir(P) if not n.startswith("_")} - set(dir(J))
    assert extra == {"resolve_device"}


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdevice, "_current_device", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.to_tensor(X)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.set_device("gpu")
    assert P.set_device("cpu") == P.CPUPlace()
