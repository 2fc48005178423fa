"""``jit.to_static``, dy2static, ``static.cond`` / ``while_loop`` and
``jit.save`` / ``load`` on the port, against the JAX package.

``to_static`` traces once per input signature into an FX program and
replays it with the live weights; the outputs follow the JAX
``to_static`` on the same functions and weights at 1e-5.  A traced
``if`` on a tensor becomes ``torch.cond`` and its gradients follow
``jax.grad`` of the ``lax.cond`` form at 1e-5; a traced ``while``
becomes the ``while_loop`` operator.  Dropout inside a ``to_static``
Layer draws fresh values every call and ``paddle.seed`` repeats them.
The ``.pdiparams`` format crosses between the packages both ways, and
the port refuses a JAX ``.pdmodel`` without importing ``paddle_tpu``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import StaticFunction, to_static
from torch_ref_helpers import jax_twin

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# the same source in both packages (dy2static converts the decorated
# function's own statements)
def _port_branchy(x):
    if x.sum() > 0:
        y = x * 2.0 + 1.0
    else:
        y = paddle.tanh(x) - 1.0
    return y * y


def _jax_branchy(x):
    if x.sum() > 0:
        y = x * 2.0 + 1.0
    else:
        y = J.tanh(x) - 1.0
    return y * y


def _port_loopy(x):
    i = paddle.to_tensor(np.int32(0))
    s = x * 0.0
    while s.sum() < 10.0:
        s = s + paddle.abs(x)
        i = i + 1
    return s, i


def _jax_loopy(x):
    i = J.to_tensor(np.int32(0))
    s = x * 0.0
    while s.sum() < 10.0:
        s = s + J.abs(x)
        i = i + 1
    return s, i


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_traced_if_follows_jax(sign):
    x = sign * np.abs(_x(5, seed=1)) + 0.1 * sign
    f, jf = to_static(_port_branchy), J.jit.to_static(_jax_branchy)
    np.testing.assert_allclose(f(paddle.to_tensor(x)).numpy(),
                               jf(J.to_tensor(x)).numpy(), rtol=1e-5)
    gm = f.program(paddle.to_tensor(x))
    assert any("cond" in str(n.target) for n in gm.graph.nodes)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_gradients_through_traced_cond_follow_jax(sign):
    x = sign * np.abs(_x(5, seed=2)) + 0.1 * sign
    f = to_static(_port_branchy)
    xt = paddle.to_tensor(x, stop_gradient=False)
    f(xt).sum().backward()

    def jref(a):
        y = jax.lax.cond(a.sum() > 0, lambda a: a * 2.0 + 1.0,
                         lambda a: jnp.tanh(a) - 1.0, a)
        return (y * y).sum()

    g = jax.jit(jax.grad(jref))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-5,
                               atol=1e-6)


def test_traced_while_follows_jax():
    x = _x(4, seed=3)
    f, jf = to_static(_port_loopy), J.jit.to_static(_jax_loopy)
    (s, i), (js, ji) = f(paddle.to_tensor(x)), jf(J.to_tensor(x))
    np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=1e-5)
    assert int(i.numpy()) == int(ji.numpy())
    gm = f.program(paddle.to_tensor(x))
    assert any("while_loop" in str(n.target) for n in gm.graph.nodes)


def test_static_cond_and_while_loop_direct():
    """``static.nn.cond`` / ``while_loop`` called by hand, eagerly and
    under a trace, as the JAX ones."""
    from paddle_tpu_torch import static

    def f(x):
        y = static.nn.cond(x.sum() > 0, lambda: x * 3.0, lambda: x - 3.0)
        i, acc = static.nn.while_loop(
            lambda i, a: i < 4, lambda i, a: (i + 1, a + y),
            [paddle.to_tensor(np.int64(0)), x])
        return acc

    x = _x(3, seed=4)
    eager = f(paddle.to_tensor(x)).numpy()
    traced = to_static(f)(paddle.to_tensor(x)).numpy()
    y = x * 3.0 if x.sum() > 0 else x - 3.0
    np.testing.assert_allclose(eager, x + 4 * y, rtol=1e-6)
    np.testing.assert_allclose(traced, eager, rtol=1e-6)


def test_cond_branch_mismatch_raises_like_lax():
    from paddle_tpu_torch import static

    def f(x):
        return static.nn.cond(x.sum() > 0, lambda: x, lambda: x[:1])

    with pytest.raises(TypeError, match="identical structure"):
        to_static(f)(paddle.to_tensor(_x(3)))


def test_guard_raises_the_reference_type_error():
    @to_static
    def f(x, flag):
        if paddle.sum(x) > 0:
            if flag:
                return x * 2
            x = x + 1
        return x * 3

    with pytest.raises(TypeError, match="Data-dependent control flow"):
        f(paddle.to_tensor(np.ones(3, np.float32)), True)

    def g(x):
        return x * float(x.sum())

    with pytest.raises(TypeError, match="Data-dependent control flow"):
        to_static(g)(paddle.to_tensor(np.ones(3, np.float32)))


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def test_layer_to_static_follows_jax_and_traces_once_per_signature():
    paddle.seed(0)
    pm = _mlp(paddle)
    jm = jax_twin(lambda: _mlp(J), pm)
    x = _x(2, 8, seed=5)
    eager = pm(paddle.to_tensor(x)).numpy()
    pm, jm = to_static(pm), J.jit.to_static(jm)
    np.testing.assert_allclose(pm(paddle.to_tensor(x)).numpy(),
                               jm(J.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pm(paddle.to_tensor(x)).numpy(), eager,
                               rtol=1e-6)
    static = pm.forward
    assert isinstance(static, StaticFunction) and len(static._cache) == 1
    pm(paddle.to_tensor(_x(7, 8)))
    assert len(static._cache) == 2
    # live weights: a changed weight shows in the next replay
    pm[0].weight.set_value(pm[0].weight.numpy() * 0)
    np.testing.assert_allclose(
        pm(paddle.to_tensor(x)).numpy(),
        np.broadcast_to(_mlp_out_zero_first(pm), (2, 4)), rtol=1e-6)
    assert len(static._cache) == 2


def _mlp_out_zero_first(pm):
    h = np.maximum(pm[0].bias.numpy(), 0)
    return h @ pm[2].weight.numpy() + pm[2].bias.numpy()


def test_replay_is_differentiable_with_live_parameters():
    paddle.seed(0)
    pm = _mlp(paddle)
    x = paddle.to_tensor(_x(3, 8, seed=6))
    pm(x).sum().backward()
    want = [p.grad.numpy().copy() for p in pm.parameters()]
    for p in pm.parameters():
        p.clear_gradient()
    sm = to_static(pm)
    sm(x).sum().backward()
    for p, w in zip(sm.parameters(), want):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-7)


class _Drop(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(6, 6)
        self.drop = nn.Dropout(0.5)

    def forward(self, x):
        return self.drop(self.fc(x))


def test_dropout_draws_fresh_and_paddle_seed_repeats():
    paddle.seed(0)
    m = to_static(_Drop())
    x = paddle.to_tensor(np.ones((4, 6), np.float32))
    paddle.seed(0)
    a, b = m(x).numpy(), m(x).numpy()
    assert not np.array_equal(a, b)          # fresh draws per call
    paddle.seed(0)
    c, d = m(x).numpy(), m(x).numpy()
    np.testing.assert_array_equal(a, c)      # seed repeats them
    np.testing.assert_array_equal(b, d)
    m.eval()
    np.testing.assert_array_equal(m(x).numpy(), m(x).numpy())


def test_batchnorm_statistics_come_back_from_the_graph():
    paddle.seed(0)
    eager, static = nn.BatchNorm1D(5), nn.BatchNorm1D(5)
    static = to_static(static)
    for i in range(3):
        x = paddle.to_tensor(_x(8, 5, seed=10 + i))
        np.testing.assert_allclose(static(x).numpy(), eager(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(static._mean.numpy(), eager._mean.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(static._variance.numpy(),
                               eager._variance.numpy(), rtol=1e-6)


def test_ir_passes_rewrite_the_traced_program():
    def naive(q, k, v):
        s = paddle.matmul(q, k, transpose_y=True) / np.sqrt(8.0)
        return paddle.matmul(paddle.nn.functional.softmax(s, axis=-1), v)

    q, k, v = (paddle.to_tensor(_x(6, 8, seed=s)) for s in (1, 2, 3))
    plain = to_static(naive)
    fused = to_static(naive, ir_passes=True)
    np.testing.assert_allclose(fused(q, k, v).numpy(),
                               plain(q, k, v).numpy(), rtol=1e-5,
                               atol=1e-6)
    assert fused.program(q, k, v).meta["rewrites_by_pass"][
        "fuse_attention"] == 1
    assert "rewrites" not in plain.program(q, k, v).meta
    with pytest.raises(TypeError, match="SEQUENCE"):
        to_static(naive, ir_passes="fuse_attention")
    with pytest.raises(ValueError, match="unknown ir pass"):
        to_static(naive, ir_passes=["fuse_atention"])


# --------------------------------------------------------- save / load --
def test_jit_save_load_round_trip(tmp_path):
    paddle.seed(0)
    m = to_static(_mlp(paddle))
    x = paddle.to_tensor(_x(2, 8, seed=7))
    want = m(x).numpy()
    paddle.jit.save(m, str(tmp_path / "m"))
    assert isinstance(m.forward, StaticFunction)   # restored after save
    loaded = paddle.jit.load(str(tmp_path / "m"))
    np.testing.assert_allclose(loaded(x).numpy(), want, rtol=1e-6)
    with open(tmp_path / "m.pdiparams", "rb") as f:
        blob = pickle.load(f)
    assert blob["__format_version__"] == 2
    assert all(isinstance(v, np.ndarray) for v in blob["state"].values())


def test_pdiparams_cross_both_ways(tmp_path):
    paddle.seed(0)
    pm = _mlp(paddle)
    jm = jax_twin(lambda: _mlp(J), pm)
    for p in jm.parameters():
        p.set_value(np.asarray(p.numpy()) * 1.5)
    x = _x(3, 8, seed=8)
    J.jit.save(jm, str(tmp_path / "jax"))
    from paddle_tpu_torch.jit.save_load import load_state
    pm.set_state_dict(load_state(str(tmp_path / "jax")))
    np.testing.assert_allclose(pm(paddle.to_tensor(x)).numpy(),
                               jm(J.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    for p in pm.parameters():
        p.set_value(p.numpy() * -0.5)
    paddle.jit.save(pm, str(tmp_path / "port"))
    with open(tmp_path / "port.pdiparams", "rb") as f:
        blob = pickle.load(f)
    jm.set_state_dict(blob["state"])
    np.testing.assert_allclose(jm(J.to_tensor(x)).numpy(),
                               pm(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_jax_pdmodel_refused_without_importing_the_reference(tmp_path):
    J.seed(0)
    J.jit.save(_mlp(J), str(tmp_path / "jax"))
    code = (
        "import sys\n"
        "import paddle_tpu_torch as paddle\n"
        "try:\n"
        f"    paddle.jit.load({str(tmp_path / 'jax')!r})\n"
        "except Exception as e:\n"
        "    print('ERR', type(e).__name__, 're-save with the port' in "
        "str(e))\n"
        "print('MODS', any(m == 'paddle_tpu' or m.startswith('paddle_tpu.')"
        " or m == 'jax' or m.startswith('jax.') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert "ERR UnpicklingError True" in out.stdout, out.stdout + out.stderr
    assert "MODS False" in out.stdout, out.stdout + out.stderr


def test_static_inference_model_formats(tmp_path):
    from paddle_tpu_torch import static

    paddle.seed(0)
    m = _mlp(paddle)
    static.save_inference_model(str(tmp_path / "m"), [], [m])
    prog, feeds, fetches = static.load_inference_model(str(tmp_path / "m"))
    x = _x(2, 8, seed=9)
    exe = static.Executor()
    np.testing.assert_allclose(exe.run(prog, feed={"x0": x})[0],
                               m(paddle.to_tensor(x)).numpy(), rtol=1e-6)
    # InputSpec feeds write the reference ProgramDesc, which loads back
    # through the importer and runs by its feed names
    static.save_inference_model(str(tmp_path / "r"),
                                [static.InputSpec([None, 8])], [m])
    assert (tmp_path / "r.pdmodel").read_bytes()[:1] == b"\x0a"
    prog, feeds, fetches = static.load_inference_model(str(tmp_path / "r"))
    assert feeds == ["x0"] and len(fetches) == 1
    np.testing.assert_allclose(exe.run(prog, feed={"x0": x})[0],
                               m(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    # a 0x0a first byte routes to the ProgramDesc importer
    (tmp_path / "pd.pdmodel").write_bytes(b"\x0a\x02ab")
    prog, feeds, fetches = static.load_inference_model(str(tmp_path / "pd"))
    assert type(prog).__name__ == "InferenceProgram"
    assert (feeds, fetches) == ([], [])
    with pytest.raises(NotImplementedError, match="intentionally"):
        static.program_guard()
    with pytest.raises(NotImplementedError, match="to_static"):
        paddle.enable_static()
