"""``utils.register_custom_op`` / ``register_pallas_op``,
``utils.cpp_extension`` and ``cost_model.CostModel`` on the port, held
against the JAX package's.

Each custom op is registered in both packages under one name with the
same forward (and backward): values and gradients equal within 1e-6,
forward-only (torch autograd against ``jax.vjp``), a custom backward
overriding autograd, a ``None`` gradient turning into zeros.
``register_pallas_op`` registers the LayerNorm kernels' launcher (B4a)
with B4b as its backward; on CPU tensors the ops run their plain
versions, held against ``F.layer_norm``'s autograd at 1e-5.
"""

import ctypes

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.utils import register_custom_op as jreg
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.utils import cpp_extension, register_custom_op
from paddle_tpu_torch.utils import register_pallas_op

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _unique(name):
    from paddle_tpu.ops import OPS as JOPS

    i = 0
    while f"{name}{i}" in registry.OPS or f"{name}{i}" in JOPS:
        i += 1
    return f"{name}{i}"


def _grads(pkg, op, xs):
    ts = [pkg.to_tensor(x, stop_gradient=False) for x in xs]
    y = op(*ts)
    (y * y).sum().backward()
    return y.numpy(), [t.grad.numpy() if t.grad is not None
                       else np.zeros_like(x) for t, x in zip(ts, xs)]


CASES = {
    "forward_only": (lambda x, y: x * x * y, None),
    "custom_backward": (lambda x, y: 2.0 * x + y,
                        lambda g, x, y: (10.0 * g, g * 3.0)),
    "none_gradient": (lambda x, y: x + y, lambda g, x, y: (g, None)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_custom_op_values_and_gradients_match_jax(case):
    fwd, bwd = CASES[case]
    name = _unique(f"co_{case}")
    pop = register_custom_op(name, fwd, backward=bwd)
    jop = jreg(name, fwd, backward=bwd)
    rng = np.random.RandomState(0)
    xs = [rng.randn(3, 4).astype(F32) for _ in range(2)]
    py, pg = _grads(P, pop, xs)
    jy, jg = _grads(J, jop, xs)
    np.testing.assert_allclose(py, np.asarray(jy), rtol=1e-6)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    assert registry.OPS[name].tags == ("custom",)
    with pytest.raises(ValueError, match="already registered"):
        register_custom_op(name, fwd)
    # the registry's body runs on raw torch tensors
    out = registry.raw(name)(*[torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(out.detach().numpy(), py, rtol=1e-6)


def test_custom_op_traces_under_to_static():
    name = _unique("co_static")
    op = register_custom_op(name, lambda x: x * 5.0,
                            backward=lambda g, x: g * 5.0)

    @P.jit.to_static
    def f(x):
        return op(x) + 1.0

    x = P.to_tensor(np.ones(4, F32))
    np.testing.assert_allclose(f(x).numpy(), np.full(4, 6.0))


def test_register_pallas_op_over_the_layernorm_launcher():
    """B4a's op forward, B4b's op backward (the stats recomputed by B4a):
    on CPU tensors the plain versions, equal to ``layer_norm_plain``
    and its autograd within 1e-5."""
    from paddle_tpu_torch.ops.cuda.layernorm_kernel import (
        layer_norm_plain, ln_bwd_op, ln_fwd_op)

    def fwd(x, g, b):
        return ln_fwd_op(x, g, b, 1e-5)[0]

    def bwd(dy, x, g, b):
        _, mu, rstd = ln_fwd_op(x, g, b, 1e-5)
        dx, dgdb = ln_bwd_op(x, g, mu, rstd, dy.contiguous())
        return dx, dgdb[0].to(g.dtype), dgdb[1].to(b.dtype)

    name = _unique("ln_kernel")
    op = register_pallas_op(name, fwd, backward=bwd)
    assert registry.OPS[name].tags == ("custom", "cuda")
    rng = np.random.RandomState(1)
    x, g, b = (rng.randn(6, 16).astype(F32), rng.rand(16).astype(F32) + 0.5,
               rng.randn(16).astype(F32))
    dy = rng.randn(6, 16).astype(F32)
    ts = [P.to_tensor(v, stop_gradient=False) for v in (x, g, b)]
    y = op(*ts)
    (y * P.to_tensor(dy)).sum().backward()
    rs = [torch.tensor(v, requires_grad=True) for v in (x, g, b)]
    ry = layer_norm_plain(rs[0], (16,), rs[1], rs[2], 1e-5)
    (ry * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.numpy(), ry.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for t, r in zip(ts, rs):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


SRC = """
extern "C" {
void saxpy(const float* x, const float* y, float* out, long long n,
           float a) {
  for (long long i = 0; i < n; ++i) out[i] = a * x[i] + y[i];
}
}
"""


def test_cpp_extension_builds_once_and_binds(tmp_path):
    mod = cpp_extension.load(
        "port_ext", [SRC], build_directory=str(tmp_path),
        functions={"saxpy": ("void", ["float*", "float*", "float*",
                                      "int64", "float"])})
    again = cpp_extension.load("port_ext", [SRC],
                               build_directory=str(tmp_path))
    assert again._so_path == mod._so_path
    x = np.arange(5, dtype=F32)
    y = np.ones(5, F32)
    out = np.empty(5, F32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa
    mod.saxpy(fp(x), fp(y), fp(out), 5, 2.0)
    np.testing.assert_allclose(out, 2 * x + y)


def test_host_op_from_extension_matches_jax_and_traces(tmp_path):
    """A host function (the extension's saxpy) as an op: values and its
    custom gradient equal the JAX package's host op; under to_static it
    traces through its fake kernel."""
    import jax

    from paddle_tpu.utils import cpp_extension as jcpp

    mod = cpp_extension.load(
        "port_ext2", [SRC], build_directory=str(tmp_path),
        functions={"saxpy": ("void", ["float*", "float*", "float*",
                                      "int64", "float"])})

    def host_fn(x):
        x = np.ascontiguousarray(x, F32)
        out = np.empty_like(x)
        fp = lambda a: a.ctypes.data_as(  # noqa: E731
            ctypes.POINTER(ctypes.c_float))
        mod.saxpy(fp(x), fp(np.ones_like(x)), fp(out), x.size, 3.0)
        return out

    name = _unique("host_saxpy")
    bwd = lambda g, x: g * 3.0  # noqa: E731
    pop = cpp_extension.host_op_from_extension(
        name, host_fn, out_shape_fn=lambda x: x, backward=bwd)
    jop = jcpp.host_op_from_extension(
        name, host_fn,
        out_shape_fn=lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        backward=bwd)
    x = np.random.RandomState(2).randn(2, 3).astype(F32)
    py, pg = _grads(P, pop, [x])
    jy, jg = _grads(J, jop, [x])
    np.testing.assert_allclose(py, 3.0 * x + 1.0, rtol=1e-6)
    np.testing.assert_allclose(py, np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(pg[0], np.asarray(jg[0]), rtol=1e-6)
    f = P.jit.to_static(lambda t: pop(t) * 2.0)
    np.testing.assert_allclose(f(P.to_tensor(x)).numpy(), 2 * py,
                               rtol=1e-6)


def test_cost_model_measures_saves_and_loads(tmp_path):
    from paddle_tpu_torch.cost_model import CostModel, estimate_fn

    x = P.to_tensor(np.random.RandomState(3).rand(32, 32).astype(F32))
    costs = CostModel().profile_measure(lambda: P.matmul(x, x) + x)
    assert costs["matmul"]["calls"] == 5
    assert all(r["op_time_ms"] >= 0 for r in costs.values())
    cm = CostModel()
    t = cm.get_static_op_time("matmul", shapes=((16, 16), (16, 16)))
    assert t["op_time"] > 0
    path = str(tmp_path / "costs.json")
    cm.save(path)
    cm2 = CostModel()
    cm2.load(path)
    assert cm2._static_table == cm._static_table
    est = estimate_fn(lambda a: a @ a, torch.ones(8, 8))
    assert est.flops == 2 * 8 * 8 * 8
