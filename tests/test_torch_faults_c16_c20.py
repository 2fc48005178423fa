"""Faults C16–C20 of ROADMAP C, each held to the reference.

- C16: one generator walk over mixed trees.  A Paddle ``Layer`` keeps a
  ``torch.nn.Module`` as a plain attribute, so the wrappers
  (``DataParallel``, ZeRO stages 2 and 3) hid the GPT's dropout
  generators from ``TrainStep(remat=True)`` and ``fleet.recompute``,
  whose recompute then drew fresh masks.  Remat against no remat, and
  ``fleet.recompute`` against the plain forward, are bitwise with
  dropout on at world size 1 (the JAX ``TrainStep`` is bitwise both
  ways); ``framework.random.generators_of`` finds a generator inside a
  Module held by a Layer held by a Module.
- C17: ``nn.RMSNorm`` is a ``Layer`` with ``weight_attr``, its weight
  in ``named_parameters()`` and ``state_dict()`` as the JAX Layer's,
  the output and input gradient within 1e-6 of the JAX RMSNorm.
- C18: GPT takes ``position_ids``: a continuation's logits within 1e-4
  of the JAX model's; ``None`` is ``arange`` bitwise.
- C19, C20: every public non-module name of the JAX ``models`` and
  ``core`` namespaces is in the port's; each keyword the JAX package
  takes and never reads builds and steps as without it.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as P
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.distributed import DataParallel
from paddle_tpu_torch.distributed.fleet import recompute
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import gpt_tiny


@pytest.fixture(autouse=True)
def _cpu():
    P.set_device("cpu")


def _batch(seed=1, b=2, t=16):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 128, (b, t))),
            torch.from_numpy(rng.randint(0, 128, (b, t))))


def _dropout_gpt():
    return gpt_tiny(device="cpu", num_layers=2, seed=3,
                    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _wrap(model, opt, wrapper):
    if wrapper == "dp":
        return DataParallel(model), opt
    wrapped, opt, _ = group_sharded_parallel(model, opt, level=wrapper)
    return wrapped, opt


def _wrapped_step(wrapper, remat):
    """One SGD (lr 1.0) TrainStep of the dropout-on GPT under
    ``wrapper``: the loss, the gradients as the optimizer's step finds
    them (the ZeRO stages drop the whole gradients in their step) and
    the weights, read through the wrapper's ``state_dict()`` (a ZeRO-3
    parameter is released at rest)."""
    model = _dropout_gpt()
    opt = optimizer.SGD(learning_rate=1.0, parameters=model.parameters())
    target, opt = _wrap(model, opt, wrapper)
    grads, apply = {}, opt.step

    def step_keeping_grads():
        grads.update((n, p.grad.clone())
                     for n, p in model.named_parameters())
        apply()

    opt.step = step_keeping_grads
    step = TrainStep(target, lambda lg, lb: model.loss(lg, lb), opt,
                     remat=remat)
    loss = step(*_batch())
    assert len(grads) == len(list(model.parameters()))
    weights = {k: (v._data if isinstance(v, P.Tensor) else v).clone()
               for k, v in target.state_dict().items()}
    return loss, grads, weights


@pytest.mark.parametrize("wrapper", ["dp", "os_g", "p_g_os"])
def test_remat_equals_no_remat_bitwise_under_a_wrapper(wrapper):
    plain, remat = _wrapped_step(wrapper, False), _wrapped_step(wrapper,
                                                                True)
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys()
    for k in plain[1]:
        assert torch.equal(plain[1][k], remat[1][k]), k
    assert plain[2].keys() == remat[2].keys() and plain[2]
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k


def test_recompute_of_a_wrapped_gpt_equals_the_plain_forward():
    ids, lab = _batch()

    def grads(through_recompute):
        model = _dropout_gpt()
        dp = DataParallel(model)
        logits = recompute(dp, ids) if through_recompute else dp(ids)
        model.loss(logits, lab).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    plain, rec = grads(False), grads(True)
    for k in plain:
        assert torch.equal(plain[k], rec[k]), k


def test_the_walk_crosses_module_layer_module():
    from paddle_tpu_torch.framework.random import generators_of

    class Inner(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.generator = torch.Generator().manual_seed(7)

    holder = P.nn.Layer()
    holder.inner = Inner()            # a plain attribute of the Layer
    outer = torch.nn.Module()
    outer.holder = holder             # a plain attribute of the Module
    found = generators_of(outer)
    assert any(g is holder.inner.generator for g in found)
    model = _dropout_gpt()
    own = model.gpt.embeddings.dropout.generator
    assert any(g is own for g in generators_of(DataParallel(model)))


def _holder(pkg):
    class Holder(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.n = pkg.nn.RMSNorm(8)
            self.l = pkg.nn.Linear(8, 8)

        def forward(self, x):
            return self.l(self.n(x))

    return Holder()


def test_rmsnorm_is_a_layer_with_its_weight():
    want = _holder(J)
    got = _holder(P)
    names = [n for n, _ in want.named_parameters()]
    assert names == ["n.weight", "l.weight", "l.bias"]
    assert [n for n, _ in got.named_parameters()] == names
    assert list(got.state_dict()) == list(want.state_dict())
    assert isinstance(got.n, P.nn.Layer)
    # an optimizer over parameters() trains the norm's weight
    opt = optimizer.SGD(learning_rate=0.5, parameters=got.parameters())
    x = P.to_tensor(np.random.RandomState(0).randn(4, 8).astype(np.float32))
    got(x).square().sum().backward()
    opt.step()
    assert not np.array_equal(got.n.weight.numpy(), np.ones(8, np.float32))
    norm = P.nn.RMSNorm(8, weight_attr=None)
    np.testing.assert_array_equal(norm.weight.numpy(), np.ones(8))
    two = P.nn.RMSNorm(8, weight_attr=P.ParamAttr(
        initializer=P.nn.initializer.Constant(2.0)))
    np.testing.assert_array_equal(two.weight.numpy(), np.full(8, 2.0))


def test_rmsnorm_matches_the_jax_layer():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    c = rng.uniform(0.5, 1.5, (3, 5, 16)).astype(np.float32)
    out = {}
    for pkg in (J, P):
        layer = pkg.nn.RMSNorm(16, epsilon=1e-6)
        layer.set_state_dict({"weight": w})
        xt = pkg.to_tensor(x, stop_gradient=False)
        y = layer(xt)
        (y * pkg.to_tensor(c)).sum().backward()
        out[pkg] = (np.asarray(y.numpy()), np.asarray(xt.grad.numpy()),
                    np.asarray(layer.weight.grad.numpy()))
    for want, got in zip(out[J], out[P]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gpt_position_ids_match_jax():
    J.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    pm.eval()
    ids = np.random.RandomState(5).randint(0, 128, (2, 12))
    pos = (np.arange(12) + 3)[None]
    want = np.asarray(jm(J.to_tensor(ids.astype(np.int32)),
                         J.to_tensor(pos.astype(np.int32))).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        ti = torch.from_numpy(ids)
        arange = torch.arange(12)
        assert torch.equal(pm(ti), pm(ti, arange))
        assert torch.equal(pm.gpt(ti), pm.gpt(ti, position_ids=arange[None]))
        emb = pm.gpt.embeddings
        assert torch.equal(emb(ti), emb(ti, None))
    assert not np.allclose(got, pm(torch.from_numpy(ids)).detach().numpy())


def _public(ns):
    return sorted(n for n in dir(ns) if not n.startswith("_")
                  and not isinstance(getattr(ns, n), types.ModuleType))


def _net():
    P.seed(1)
    return P.nn.Linear(4, 3)


def _step_with(make):
    """The weights after one step of ``make(parameters)`` on a seeded
    Linear."""
    net = _net()
    opt = make(net.parameters())
    x = P.to_tensor(np.random.RandomState(2).randn(5, 4).astype(np.float32))
    net(x).square().mean().backward()
    opt.step()
    return [p.numpy() for p in net.parameters()]


def _train_step(**kw):
    net = _net()
    opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    step = TrainStep(net, lambda o: o.square().mean(), opt, **kw)
    x = P.to_tensor(np.random.RandomState(2).randn(5, 4).astype(np.float32))
    step(x)
    step.sync_to_model()
    return [p.numpy() for p in net.parameters()]


def _decorated(**kw):
    net = _net()
    amp.decorate(net, level="O2", dtype="bfloat16", **kw)
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    return [p.astype("float32").numpy() for p in net.parameters()]


KEYWORDS = {
    "Optimizer.name": (lambda ps: optimizer.Optimizer(parameters=ps,
                                                      name="o").get_lr(),
                       lambda ps: optimizer.Optimizer(parameters=ps)
                       .get_lr()),
    "SGD.name": (lambda: _step_with(lambda ps: optimizer.SGD(
        parameters=ps, name="o")), lambda: _step_with(
        lambda ps: optimizer.SGD(parameters=ps))),
    "Adam.name": (lambda: _step_with(lambda ps: optimizer.Adam(
        parameters=ps, name="o")), lambda: _step_with(
        lambda ps: optimizer.Adam(parameters=ps))),
    "Adam.lazy_mode": (lambda: _step_with(lambda ps: optimizer.Adam(
        parameters=ps, lazy_mode=True)), lambda: _step_with(
        lambda ps: optimizer.Adam(parameters=ps))),
    "AdamW.name": (lambda: _step_with(lambda ps: optimizer.AdamW(
        parameters=ps, name="o")), lambda: _step_with(
        lambda ps: optimizer.AdamW(parameters=ps))),
    "AdamW.lazy_mode": (lambda: _step_with(lambda ps: optimizer.AdamW(
        parameters=ps, lazy_mode=True)), lambda: _step_with(
        lambda ps: optimizer.AdamW(parameters=ps))),
    "AdamW.lr_ratio": (lambda: _step_with(lambda ps: optimizer.AdamW(
        parameters=ps, lr_ratio=lambda p: 0.5)), lambda: _step_with(
        lambda ps: optimizer.AdamW(parameters=ps))),
    "decorate.save_dtype": (lambda: _decorated(save_dtype="float32"),
                            lambda: _decorated()),
    "TrainStep.donate": (lambda: _train_step(donate=False),
                         lambda: _train_step()),
}

CASES = ["models", "core"] + sorted(KEYWORDS)


@pytest.mark.parametrize("case", CASES)
def test_names_and_keywords_of_the_reference(case):
    if case in ("models", "core"):
        want = _public(getattr(J, case))
        got = set(dir(getattr(P, case)))
        assert [n for n in want if n not in got] == []
        return
    with_kw, without = KEYWORDS[case]
    if case == "Optimizer.name":
        params = _net().parameters()
        assert with_kw(params) == without(params)
        return
    for a, b in zip(with_kw(), without()):
        np.testing.assert_array_equal(a, b)
