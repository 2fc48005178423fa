"""BERT pretraining through the port's Paddle API against the JAX package.

``bert_tiny`` (2 layers, hidden 64, 4 heads, vocab 256) is built in both
packages from one set of weights, carried from the JAX model to the
port by ``set_state_dict``.  Logits and the pretraining loss must agree
at ``rtol = 1e-4``, ``atol = 1e-5`` in f32, with and without a padding
mask; three eager AdamW steps (``loss.backward(); opt.step();
opt.clear_grad()``) must keep losses and every parameter within
``atol = 1e-4``; a checkpoint written by ``paddle_tpu.save`` must load
into the port with equal logits, and one written by the port into the
JAX model.
"""

import os

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as P
from paddle_tpu_torch.models import bert as pbert

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _batch(seed=0, b=2, t=16, vocab=256, padded=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, t))
    types = rng.randint(0, 2, (b, t))
    mask = np.ones((b, t), np.int64)
    if padded:
        mask[1, t - 5:] = 0
    mlm = np.where(rng.rand(b, t) < 0.15, rng.randint(0, vocab, (b, t)),
                   -100)
    mlm[0, 0] = 7          # at least one masked position
    nsp = rng.randint(0, 2, (b,))
    return ids, types, mask, mlm, nsp


def _models():
    J.seed(0)
    jm = jbert.BertForPretraining(jbert.bert_tiny_config())
    P.seed(1)
    pm = pbert.BertForPretraining(pbert.bert_tiny_config())
    pm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    return jm, pm


def _forward(p, model, batch, masked=True):
    ids, types, mask, mlm, nsp = batch
    logits = model(p.to_tensor(ids), p.to_tensor(types),
                   p.to_tensor(mask) if masked else None)
    loss = model.loss(*logits, p.to_tensor(mlm), p.to_tensor(nsp))
    return logits, loss


def test_state_dict_keys_equal_the_reference():
    jm, pm = _models()
    assert list(jm.state_dict()) == list(pm.state_dict())
    assert [tuple(v.shape) for v in jm.state_dict().values()] == \
        [tuple(v.shape) for v in pm.state_dict().values()]


@pytest.mark.parametrize("masked", [True, False])
def test_logits_and_loss_match_reference(masked):
    jm, pm = _models()
    batch = _batch(padded=masked)
    (jl, jn), jloss = _forward(J, jm, batch, masked)
    (pl, pn), ploss = _forward(P, pm, batch, masked)
    np.testing.assert_allclose(np.asarray(jl.numpy()), pl.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jn.numpy()), pn.numpy(), **TOL)
    np.testing.assert_allclose(float(jloss), float(ploss), **TOL)


def test_eager_adamw_steps_match_reference():
    jm, pm = _models()
    jopt = J.optimizer.AdamW(learning_rate=1e-3,
                             parameters=jm.parameters())
    popt = P.optimizer.AdamW(learning_rate=1e-3,
                             parameters=pm.parameters())
    losses, key_bias_grad = [], 0.0
    for step in range(3):
        batch = _batch(seed=step)
        pair = []
        for p, model, opt in ((J, jm, jopt), (P, pm, popt)):
            _, loss = _forward(p, model, batch)
            loss.backward()
            key_bias_grad = max([key_bias_grad] + [
                float(np.abs(np.asarray(q.grad.numpy())).max())
                for n, q in model.named_parameters()
                if n.endswith("k_proj.bias")])
            opt.step()
            opt.clear_grad()
            pair.append(float(loss))
        losses.append(pair)
    np.testing.assert_allclose(*np.array(losses).T, rtol=0, atol=1e-4)
    # softmax ignores a bias added to every key, so the key projections'
    # bias gradients are rounding noise in both packages, which Adam
    # scales to steps of about lr: those biases may differ by 2 lr a step
    assert key_bias_grad < 1e-5, key_bias_grad
    pparams = dict(pm.named_parameters())
    for name, jp in jm.named_parameters():
        atol = 2 * 1e-3 * 3 if name.endswith("k_proj.bias") else 1e-4
        np.testing.assert_allclose(np.asarray(jp.numpy()),
                                   pparams[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)
        assert pparams[name].grad is None


def test_checkpoints_cross_between_the_packages(tmp_path):
    jm, _ = _models()
    batch = _batch()
    path = os.path.join(tmp_path, "jax.pdparams")
    J.save(jm.state_dict(), path)
    P.seed(3)
    pm = pbert.BertForPretraining(pbert.bert_tiny_config())
    assert pm.set_state_dict(P.load(path)) == ([], [])
    (jl, _), _ = _forward(J, jm, batch)
    (pl, _), _ = _forward(P, pm, batch)
    np.testing.assert_allclose(np.asarray(jl.numpy()), pl.numpy(), **TOL)

    back = os.path.join(tmp_path, "port.pdparams")
    P.save(pm.state_dict(), back)
    J.seed(4)
    jm2 = jbert.BertForPretraining(jbert.bert_tiny_config())
    jm2.set_state_dict(J.load(back))
    (jl2, _), _ = _forward(J, jm2, batch)
    np.testing.assert_allclose(np.asarray(jl2.numpy()), pl.numpy(), **TOL)


def test_port_round_trip_is_bitwise_and_bf16_payload_raises(tmp_path):
    _, pm = _models()
    batch = _batch()
    path = os.path.join(tmp_path, "m.pdparams")
    P.save(pm.state_dict(), path)
    P.seed(9)
    fresh = pbert.BertForPretraining(pbert.bert_tiny_config())
    fresh.set_state_dict(P.load(path))
    pm.eval()
    fresh.eval()
    (a, _), _ = _forward(P, pm, batch)
    (b, _), _ = _forward(P, fresh, batch)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(TypeError, match="bfloat16"):
        P.save({"w": P.to_tensor(np.ones(2, np.float32)).astype("bfloat16")},
               os.path.join(tmp_path, "bf16.pdparams"))
    jax_bf16 = os.path.join(tmp_path, "jax_bf16.pdparams")
    J.save({"w": J.to_tensor(np.ones(2, np.float32)).astype("bfloat16")},
           jax_bf16)
    with pytest.raises(TypeError, match="bfloat16"):
        P.load(jax_bf16)


def test_dropout_trains_differently_and_eval_is_deterministic():
    """BERT-base's dropout 0.1 through the global generator: two training
    forwards differ, ``eval()`` forwards repeat, ``seed`` repeats."""
    P.seed(5)
    model = pbert.BertForPretraining(pbert.bert_tiny_config(
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    batch = _batch()
    (a, _), _ = _forward(P, model, batch)
    (b, _), _ = _forward(P, model, batch)
    assert not np.array_equal(a.numpy(), b.numpy())
    P.seed(6)
    (c, _), _ = _forward(P, model, batch)
    P.seed(6)
    (d, _), _ = _forward(P, model, batch)
    np.testing.assert_array_equal(c.numpy(), d.numpy())
    model.eval()
    (e, _), _ = _forward(P, model, batch)
    (f, _), _ = _forward(P, model, batch)
    np.testing.assert_array_equal(e.numpy(), f.numpy())
