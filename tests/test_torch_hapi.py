"""The port's ``hapi`` (``Model``, ``summary``, ``flops``, callbacks)
against the JAX package's.

``callbacks.py`` is a verbatim copy (``test_torch_engine.py::
test_host_modules_are_verbatim_copies``); the bodies of the reference's
``tests/test_hapi_inference.py`` fit/evaluate/predict, early-stopping,
partial-batch and summary cases run against the port; the same ``Net``,
data and weights go through ``Model.fit`` in both packages, unshuffled,
for 2 epochs, and the losses agree at 1e-5; ``evaluate`` with
``Accuracy`` works in the port where the JAX body raises (ROADMAP C);
``flops`` agrees with XLA's count within the bound its docstring
states.
"""

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.hapi import EarlyStopping, Model, summary
from paddle_tpu_torch.io import TensorDataset


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _net(p):
    class Net(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = p.nn.Linear(8, 32)
            self.fc2 = p.nn.Linear(32, 1)

        def forward(self, x):
            return self.fc2(p.nn.functional.relu(self.fc1(x)))

    return Net()


def Net():
    return _net(paddle)


def _data(n=128, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 8).astype("float32")
    Y = (X @ rs.randn(8, 1)).astype("float32")
    return X, Y


# ---- the bodies of the reference's tests/test_hapi_inference.py ----
def test_hapi_model_fit_evaluate_predict(tmp_path):
    paddle.seed(0)
    X, Y = _data()
    ds = TensorDataset([paddle.to_tensor(X), paddle.to_tensor(Y)])
    model = Model(Net())
    model.prepare(
        optimizer=optimizer.Adam(learning_rate=1e-2,
                                 parameters=model.parameters()),
        loss=lambda out, y: nn.functional.mse_loss(out, y))
    hist = model.fit(ds, epochs=3, batch_size=32, verbose=0)
    assert hist["loss"][-1] < hist["loss"][0] * 0.7

    ev = model.evaluate(ds, batch_size=32)
    assert ev["loss"] < hist["loss"][0]

    preds = model.predict(TensorDataset([paddle.to_tensor(X)]),
                          batch_size=32, stack_outputs=True)
    assert preds[0].shape == (128, 1)

    model.save(str(tmp_path / "m"))
    m2 = Model(Net())
    m2.load(str(tmp_path / "m"))
    np.testing.assert_allclose(
        m2.network.fc1.weight.numpy(), model.network.fc1.weight.numpy())


def test_hapi_early_stopping():
    paddle.seed(0)
    X, Y = _data(64)
    ds = TensorDataset([paddle.to_tensor(X), paddle.to_tensor(Y)])
    model = Model(Net())
    model.prepare(
        optimizer=optimizer.SGD(learning_rate=0.0,
                                parameters=model.parameters()),
        loss=lambda out, y: nn.functional.mse_loss(out, y))
    es = EarlyStopping(monitor="loss", patience=0)
    hist = model.fit(ds, eval_data=ds, epochs=10, batch_size=32, verbose=0,
                     callbacks=[es])
    n_epochs = len(hist["loss"]) // 2  # 2 batches per epoch
    assert n_epochs <= 3


def test_predict_keeps_partial_batches():
    paddle.seed(0)
    X, _ = _data(10)
    model = Model(Net())
    model.prepare(loss=None, optimizer=None)
    preds = model.predict(TensorDataset([paddle.to_tensor(X)]),
                          batch_size=4, stack_outputs=True)
    assert preds[0].shape == (10, 1)  # tail batch of 2 not dropped


def test_summary_counts():
    net = Net()
    info = summary(net)
    assert info["total_params"] == 8 * 32 + 32 + 32 + 1


# ---- the port against the JAX package on the same weights ----
def _fit_losses(p, sd, X, Y):
    net = _net(p)
    if sd is not None:
        net.set_state_dict(sd)
    model = p.Model(net)
    model.prepare(p.optimizer.AdamW(learning_rate=1e-2,
                                    parameters=net.parameters()),
                  lambda out, y: p.nn.functional.mse_loss(out, y))
    ds = p.io.TensorDataset([p.to_tensor(X), p.to_tensor(Y)])
    hist = model.fit(p.io.DataLoader(ds, batch_size=16, shuffle=False),
                     epochs=2, verbose=0)
    return net, hist["loss"]


def test_fit_losses_match_jax():
    X, Y = _data(64, seed=3)
    J.seed(0)
    jnet0 = _net(J)
    sd = {k: np.asarray(v.numpy()) for k, v in jnet0.state_dict().items()}
    jnet, jl = _fit_losses(J, sd, X, Y)
    pnet, pl = _fit_losses(paddle, sd, X, Y)
    assert len(jl) == len(pl) == 8
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(pnet.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_evaluate_with_accuracy_works_where_the_jax_body_raises():
    rng = np.random.RandomState(4)
    X = rng.randn(20, 8).astype("float32")
    y = rng.randint(0, 3, (20, 1))
    outs = []
    for p in (J, paddle):
        p.seed(0)
        net = p.nn.Linear(8, 3)
        if p is paddle:
            net.set_state_dict(sd)
        else:
            sd = {k: np.asarray(v.numpy())
                  for k, v in net.state_dict().items()}
        model = p.Model(net)
        model.prepare(None, p.nn.CrossEntropyLoss(), p.metric.Accuracy())
        ds = p.io.TensorDataset([p.to_tensor(X), p.to_tensor(y)])
        if p is J:
            with pytest.raises(TypeError, match="positional"):
                model.evaluate(ds, batch_size=8, verbose=0)
            logits = np.asarray(net(p.to_tensor(X)).numpy())
            continue
        outs = model.evaluate(ds, batch_size=8, verbose=0)
    want = float(np.mean(np.argmax(logits, -1) == y[:, 0]))
    assert outs["acc"] == pytest.approx(want)
    assert np.isfinite(outs["loss"])


@pytest.mark.parametrize("name,build,shape,rtol", [
    # products and their adds: the walker and XLA count them alike
    ("mlp", lambda p: p.nn.Sequential(p.nn.Linear(16, 32), p.nn.ReLU(),
                                      p.nn.Linear(32, 4)), (8, 16), 1e-9),
    # convolutions with zero padding (only taps inside the input count,
    # as XLA counts them), BatchNorm, pooling; XLA folds a few
    # elementwise ops of eval BatchNorm the walker prices: 0.12%
    ("resnet18_32", lambda p: p.vision.models.resnet18(num_classes=10),
     (1, 3, 32, 32), 5e-3),
    # the walker prices GELU(erf), softmax and LayerNorm at the op level,
    # XLA counts the elementwise chains it expands them into: 11.0% low
    # on this 2-layer, 64-wide model (1.1% at ViT-B/16 widths)
    ("vit_tiny", lambda p: p.vision.models.vit_tiny(), (1, 3, 32, 32),
     0.15),
])
def test_flops_against_xla_cost_analysis(name, build, shape, rtol):
    J.seed(0)
    want = J.flops(build(J), shape)
    paddle.seed(0)
    got = paddle.flops(build(paddle), shape)
    assert got == pytest.approx(want, rel=rtol), (got, want)
