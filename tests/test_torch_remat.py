"""``jit.TrainStep(remat=True)``: the JAX ``jax.checkpoint`` of the whole
loss as ``torch.utils.checkpoint`` on the port.

- Against the JAX ``TrainStep(remat=True)``: ``gpt_tiny`` from the same
  numpy weights, dropout off, three AdamW steps; the loss and every
  parameter within 1e-5 (the same f32 composition summed in other
  orders; AdamW's epsilon 1e-3 keeps an element whose gradient is
  rounding noise from moving +-lr either way, tests/test_torch_train.py).
- Against the port's own ``remat=False`` with dropout on: bitwise, the
  losses, every gradient and every updated parameter.  The recompute
  draws the same masks only because the step restores the explicit
  generators the forward draws from (the model's and the global ones).
- The forward really runs twice a step under remat.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import gpt_tiny


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


def _batch(seed=1, b=2, t=16):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, (b, t)), rng.randint(0, 128, (b, t))


def test_remat_matches_the_reference_remat():
    jpaddle.seed(0)
    jm = jax_gpt_tiny(num_layers=1)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    pm = gpt_tiny(device="cpu", num_layers=1)
    pm.set_state_dict(sd)
    lr = 1e-3
    jo = jopt.AdamW(learning_rate=lr, parameters=jm.parameters(),
                    epsilon=1e-3)
    po = optimizer.AdamW(learning_rate=lr, parameters=pm.parameters(),
                         epsilon=1e-3)
    jstep = JTrainStep(jm, lambda lg, lb: jm.loss(lg, lb), jo, remat=True)
    pstep = TrainStep(pm, lambda lg, lb: pm.loss(lg, lb), po, remat=True)
    ids, lab = _batch()
    for _ in range(3):
        want = float(jstep(jpaddle.to_tensor(ids.astype(np.int32)),
                           jpaddle.to_tensor(lab.astype(np.int32))).numpy())
        got = pstep(torch.from_numpy(ids), torch.from_numpy(lab)).item()
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstep._params[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _gpt_run(remat, steps=2):
    """Losses, the last step's gradients and the parameters of
    ``steps`` AdamW TrainSteps of a dropout-on gpt_tiny."""
    model = gpt_tiny(device="cpu", num_layers=2, hidden_dropout_prob=0.1,
                     attention_probs_dropout_prob=0.1)
    opt = optimizer.AdamW(learning_rate=1e-3,
                          parameters=model.parameters())
    step = TrainStep(model, lambda lg, lb: model.loss(lg, lb), opt,
                     remat=remat)
    ids, lab = _batch()
    losses = [step(torch.from_numpy(ids), torch.from_numpy(lab)).item()
              for _ in range(steps)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, grads, params


def test_remat_equals_no_remat_bitwise_with_dropout():
    a, b = _gpt_run(False), _gpt_run(True)
    assert a[0] == b[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
        assert torch.equal(a[2][k], b[2][k]), k


def test_remat_restores_the_global_generator_of_a_layer():
    """A Paddle Layer whose dropout draws from the port's global
    generator (no generator of its own): remat's gradients equal the
    plain step's bitwise."""

    def run(remat):
        paddle.seed(3)
        net = nn.Sequential(nn.Linear(8, 32), nn.Dropout(0.5),
                            nn.Linear(32, 4))
        opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        step = TrainStep(net, lambda o, y: nn.functional.mse_loss(o, y),
                         opt, remat=remat)
        rng = np.random.RandomState(0)
        x = paddle.to_tensor(rng.randn(16, 8).astype(np.float32))
        y = paddle.to_tensor(rng.randn(16, 4).astype(np.float32))
        losses = [float(step(x, y)) for _ in range(3)]
        return losses, [p.numpy() for p in net.parameters()]

    a, b = run(False), run(True)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def test_remat_recomputes_the_forward():
    model = gpt_tiny(device="cpu", num_layers=1)
    calls = []
    model.gpt.register_forward_hook(lambda *a: calls.append(1))
    opt = optimizer.SGD(learning_rate=1e-3, parameters=model.parameters())
    ids, lab = _batch()
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        TrainStep(model, lambda lg, lb: model.loss(lg, lb), opt,
                  remat=remat)(torch.from_numpy(ids), torch.from_numpy(lab))
        assert len(calls) == want, remat
