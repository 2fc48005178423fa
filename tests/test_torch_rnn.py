"""The port's RNN layers (``nn/rnn.py``) against the JAX package's.

SimpleRNN (tanh and relu), LSTM and GRU, two layers, one direction and
both, batch-first and time-major, with and without ``sequence_length``
and initial states: the port's layer is built, the JAX layer gets its
weights by name (the state-dict keys must be equal, in order), and the
same numpy inputs go through both.  Outputs, final states, the input's
gradient and every weight's gradient of ``sum(out * w)`` (``w`` seeded)
must agree at 1e-5.  The JAX layer runs as one jitted call
(``torch_ref_helpers``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P

from torch_ref_helpers import jax_twin, jax_value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, I, H = 3, 5, 4, 6

# name, layer kwargs, time_major, sequence_length, initial states
CASES = [
    ("lstm_bidirect", "LSTM", dict(direction="bidirect"), False, None, False),
    ("lstm_time_major_lengths", "LSTM", {}, True, [5, 3, 1], True),
    ("gru_bidirect_time_major", "GRU", dict(direction="bidirect"), True,
     None, True),
    ("gru_lengths", "GRU", {}, False, [2, 5, 4], False),
    ("simple_tanh_bidirect_lengths", "SimpleRNN", dict(direction="bidirect"),
     False, [5, 1, 3], False),
    ("simple_relu_time_major", "SimpleRNN", dict(activation="relu"), True,
     None, True),
]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU, torch on one thread: idle intra-op threads
    spinning beside the other test processes slow the JAX compiles."""
    P.set_device("cpu")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(time_major, initial, mode, dirs, seed):
    rng = np.random.RandomState(seed)
    shape = (T, B, I) if time_major else (B, T, I)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    states = None
    if initial:
        n = 2 * dirs
        states = [rng.uniform(-0.5, 0.5, (n, B, H)).astype(np.float32)
                  for _ in range(2 if mode == "LSTM" else 1)]
    return x, states


def _flat(out):
    """(out, final) -> [out, h(, c)] as a flat list."""
    seq, final = out
    return [seq] + (list(final) if isinstance(final, (tuple, list))
                    else [final])


@pytest.mark.parametrize("label,mode,kw,time_major,lengths,initial", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_reference(label, mode, kw, time_major, lengths,
                                 initial):
    dirs = 2 if kw.get("direction") == "bidirect" else 1
    x, states = _inputs(time_major, initial, mode, dirs, seed=len(label))
    P.seed(0)
    pm = getattr(P.nn, mode)(I, H, num_layers=2, time_major=time_major, **kw)
    jm = jax_twin(lambda: getattr(J.nn, mode)(I, H, num_layers=2,
                                              time_major=time_major, **kw),
                  pm)
    seq_len = None if lengths is None else np.array(lengths, np.int64)

    # the port, with autograd
    px = P.to_tensor(x, stop_gradient=False)
    extra = {}
    if seq_len is not None:
        extra["sequence_length"] = P.to_tensor(seq_len)
    if states is not None:
        extra["initial_states"] = tuple(P.to_tensor(s) for s in states)
    outs = _flat(pm(px, **extra))
    w = np.random.RandomState(9).uniform(0.5, 1.5, outs[0].shape) \
        .astype(np.float32)
    (outs[0] * P.to_tensor(w)).sum().backward()

    # the JAX layer, jitted, on the same weights and inputs: its forward
    # takes them positionally, (x[, initial_states][, sequence_length])
    args = [x] + ([tuple(states)] if states is not None else []) \
        + ([seq_len] if seq_len is not None else [])

    def tensor(v):
        return v if isinstance(v, J.Tensor) else J.Tensor(v)

    def positional(*a):
        rest, kw2 = list(a[1:]), {}
        if states is not None:
            kw2["initial_states"] = tuple(tensor(s) for s in rest.pop(0))
        if seq_len is not None:
            kw2["sequence_length"] = tensor(rest.pop(0))
        return type(jm).forward(jm, tensor(a[0]), **kw2)

    jm.forward = positional
    want, _, wgrads, (xgrad,) = jax_value_and_grad(
        jm, lambda o: (o[0] * w).sum(), args, wrt_inputs=(0,))
    want = _flat(want)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(px.grad.numpy(), xgrad, **TOL)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wgrads[name], **TOL,
                                   err_msg=name)


def test_gate_layout_and_init_follow_the_reference():
    """Parameter names and shapes are the JAX layer's, the port draws
    them from Uniform(-1/sqrt(H), 1/sqrt(H)) as the JAX layer does, and a
    JAX state dict loads into a fresh port layer by name."""
    P.seed(0)
    pm = P.nn.LSTM(I, H, num_layers=2, direction="bidirect")
    jm = jax_twin(lambda: J.nn.LSTM(I, H, num_layers=2,
                                    direction="bidirect"), pm)
    bound = 1.0 / np.sqrt(H)
    for v in pm.state_dict().values():
        a = v.numpy()
        assert np.abs(a).max() <= bound and a.std() > bound / 4
    P.seed(1)
    fresh = P.nn.LSTM(I, H, num_layers=2, direction="bidirect")
    jsd = jm.state_dict()
    fresh.set_state_dict({k: np.asarray(v.numpy()) for k, v in jsd.items()})
    for k in jsd:
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                      np.asarray(jsd[k].numpy()))
    assert pm.weight_ih_l0.shape == [4 * H, I]
    assert pm.weight_hh_l1_reverse.shape == [4 * H, H]
    assert pm.weight_ih_l1.shape == [4 * H, 2 * H]
