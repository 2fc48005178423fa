"""``amp.auto_cast`` in the port against the JAX package's.

``amp_cast_inputs`` picks the dtype the JAX function picks for every
name of both lists and for an op on neither, at O1 and O2, with and
without custom lists; the dispatcher casts a call's Tensor inputs and
leaves raw torch tensors alone, as the JAX dispatch leaves raw arrays;
the bodies of the reference's ``tests/test_io.py::TestAmp`` run against
the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.amp as jamp

import paddle_tpu_torch as P
import paddle_tpu_torch.amp as pamp


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


_NAMES = sorted(jamp.WHITE_LIST | jamp.BLACK_LIST) + ["add", "gelu"]
_POLICIES = [
    dict(level="O1"), dict(level="O2"),
    dict(level="O1", custom_white_list=["gelu", "softmax"],
         custom_black_list=["matmul"]),
    dict(level="O2", custom_black_list=["add"]),
]
_POLICY_IDS = ["O1", "O2", "O1_custom", "O2_custom"]


def _kind(dtype):
    return {jnp.dtype(jnp.bfloat16): "bf16", jnp.dtype(jnp.float32): "f32",
            jnp.dtype(jnp.float16): "f16", torch.bfloat16: "bf16",
            torch.float32: "f32", torch.float16: "f16"}[dtype]


def test_lists_are_the_jax_lists():
    assert pamp.WHITE_LIST == jamp.WHITE_LIST
    assert pamp.BLACK_LIST == jamp.BLACK_LIST


@pytest.mark.parametrize("policy", _POLICIES, ids=_POLICY_IDS)
def test_cast_inputs_picks_the_jax_dtype(policy):
    """For every listed op and two on neither: the dtype each of an f32
    and a bf16 input becomes is the JAX package's."""
    jx = [jnp.ones(2, jnp.float32), jnp.ones(2, jnp.bfloat16)]
    px = [torch.ones(2), torch.ones(2, dtype=torch.bfloat16)]
    for name in _NAMES:
        with jamp.auto_cast(**policy):
            want = [_kind(d.dtype) for d in jamp.amp_cast_inputs(name, jx)]
        with pamp.auto_cast(**policy):
            got = [_kind(d.dtype) for d in pamp.amp_cast_inputs(name, px)]
        assert got == want, (name, policy, got, want)
    assert pamp.amp_cast_inputs("matmul", px) is px   # off: untouched


def test_float64_and_integers_are_never_cast():
    for pol in _POLICIES:
        with pamp.auto_cast(**pol):
            out = pamp.amp_cast_inputs(
                "matmul", [torch.ones(2, dtype=torch.float64),
                           torch.ones(2, dtype=torch.int64)])
        assert [o.dtype for o in out] == [torch.float64, torch.int64]


def test_state_is_thread_local_and_restored():
    import threading

    seen = []
    with pamp.auto_cast(level="O2"):
        t = threading.Thread(target=lambda: seen.append(
            pamp.amp_state().enabled))
        t.start()
        t.join()
        assert pamp.amp_state().enabled
    assert seen == [False] and not pamp.amp_state().enabled
    assert pamp.amp_guard is pamp.auto_cast


def test_dispatcher_casts_tensors_and_leaves_raw_tensors_as_jax_does():
    """An op called with Tensors is cast; the same op called with raw
    torch tensors is not, as the JAX op called with raw arrays is not
    (nothing in the call is a Tensor)."""
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    with J.amp.auto_cast():
        j_t = J.nn.functional.linear(J.to_tensor(x), J.to_tensor(w))
        j_raw = J.nn.functional.linear(jnp.asarray(x), jnp.asarray(w))
        j_soft = J.nn.functional.softmax(J.to_tensor(x).astype("bfloat16"))
    with P.amp.auto_cast():
        p_t = P.nn.functional.linear(P.to_tensor(x), P.to_tensor(w))
        p_raw = P.nn.functional.linear(torch.from_numpy(x),
                                       torch.from_numpy(w))
        p_soft = P.nn.functional.softmax(P.to_tensor(x).astype("bfloat16"))
    assert _kind(j_t.dtype) == _kind(p_t.dtype) == "bf16"
    jr = j_raw._data if isinstance(j_raw, J.Tensor) else j_raw
    assert _kind(jr.dtype) == _kind(p_raw.dtype) == "f32"
    assert _kind(j_soft.dtype) == _kind(p_soft.dtype) == "f32"
    np.testing.assert_allclose(
        np.asarray(j_t.astype("float32").numpy()),
        p_t.astype("float32").numpy(), rtol=1e-2, atol=1e-2)


def test_o1_grads_flow_through_the_casts():
    x = P.to_tensor(np.ones((2, 4), np.float32), stop_gradient=False)
    lin = P.nn.Linear(4, 3)
    with P.amp.auto_cast():
        loss = P.nn.functional.softmax(lin(x)).sum()
    loss.backward()
    assert lin.weight.grad.dtype == torch.float32 and x.grad is not None


# ---- the bodies of the reference's tests/test_io.py::TestAmp ----
class TestAmp:
    def test_autocast_matmul_bf16(self):
        x = P.ones([4, 4])
        with P.amp.auto_cast():
            out = P.matmul(x, x)
        assert out.dtype == torch.bfloat16
        out2 = P.matmul(x, x)
        assert out2.dtype == torch.float32

    def test_blacklist_stays_fp32(self):
        x = P.ones([4, 4])
        with P.amp.auto_cast():
            out = P.nn.functional.softmax(x)
        assert out.dtype == torch.float32

    def test_grad_scaler_bf16_flow(self):
        """The reference body with the port's scaler, which scales at
        every dtype as the JAX one does (bf16 too): the loss is scaled by
        1024, the step applies the unscaled gradient."""
        model = P.nn.Linear(2, 2)
        w0 = model.weight.numpy().copy()
        opt = P.optimizer.SGD(learning_rate=0.1,
                              parameters=model.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=1024.0)
        loss = model(P.ones([1, 2])).sum()
        scaled = scaler.scale(loss)
        assert float(scaled) == 1024.0 * float(loss)
        scaled.backward()
        scaler.step(opt)
        scaler.update()
        assert np.isfinite(model.weight.numpy()).all()
        np.testing.assert_allclose(model.weight.numpy(), w0 - 0.1,
                                   rtol=1e-6)
