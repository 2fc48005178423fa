"""The port's optimizers against the JAX package's.

Each optimizer steps the same two f32 parameters in both packages for
five steps, on the loss ``sum(c * p) + sum(d * p^2) / 2`` (a gradient of
products and sums only, so the two autograds agree to rounding); after
every step the parameters agree within 1e-6 of their largest magnitude.
The state dict crosses both ways: the JAX optimizer's, after two steps,
loaded into a fresh port optimizer (and the port's into a fresh JAX
one) continues the run as the original does.  Each optimizer's plain
per-parameter ``rule`` (the JAX ``_update``, transcribed) is held to its
foreach ``step`` at the same tolerance.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P

RNG = np.random.RandomState(21)
P0 = [RNG.uniform(-1, 1, (5, 3)).astype(np.float32),
      RNG.uniform(-1, 1, (7,)).astype(np.float32)]
C = [RNG.uniform(-1, 1, p.shape).astype(np.float32) for p in P0]
D = [RNG.uniform(0.5, 1.5, p.shape).astype(np.float32) for p in P0]
# a zero parameter: the trust ratios' "else 1" branch
P0.append(np.zeros((4,), np.float32))
C.append(RNG.uniform(-1, 1, (4,)).astype(np.float32))
D.append(np.ones((4,), np.float32))
TOL = 1e-6

# name, kwargs (both packages)
CASES = [
    ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9, use_nesterov=True,
                      weight_decay=1e-4)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    ("Adamax", dict(learning_rate=0.05)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    ("RMSProp", dict(learning_rate=0.01, centered=True, weight_decay=0.01)),
    ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.01)),
    ("Lars", dict(learning_rate=0.5, lars_weight_decay=0.001)),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(CASES)]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _params(pkg):
    return [_param(pkg, p) for p in P0]


def _param(pkg, arr):
    return pkg.to_tensor(arr.copy(), stop_gradient=False)


def _loss(pkg, params):
    total = None
    for p, c, d in zip(params, C, D):
        term = pkg.sum(p * pkg.to_tensor(c)) + \
            0.5 * pkg.sum(p * p * pkg.to_tensor(d))
        total = term if total is None else total + term
    return total


def _step(pkg, opt, params):
    _loss(pkg, params).backward()
    opt.step()
    opt.clear_grad()
    return [np.asarray(p.numpy()).copy() for p in params]


def _pair(name, kw):
    jp, pp = _params(J), _params(P)
    return (jp, getattr(J.optimizer, name)(parameters=jp, **kw),
            pp, getattr(P.optimizer, name)(parameters=pp, **kw))


def _close(got, want, what):
    for g, w in zip(got, want):
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(g - w).max() / scale
        assert err < TOL, (what, err)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_five_steps_match_jax(name, kw):
    jp, jopt, pp, popt = _pair(name, kw)
    for i in range(5):
        _close(_step(P, popt, pp), _step(J, jopt, jp), (name, i))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_state_dict_crosses_both_ways(name, kw):
    jp, jopt, pp, popt = _pair(name, kw)
    for _ in range(2):
        _step(J, jopt, jp)
        _step(P, popt, pp)
    # JAX -> port: a fresh port optimizer over the JAX parameters' values
    pp2 = [_param(P, np.asarray(p.numpy())) for p in jp]
    popt2 = getattr(P.optimizer, name)(parameters=pp2, **kw)
    popt2.set_state_dict({k: (v.numpy() if hasattr(v, "numpy") else v)
                          for k, v in jopt.state_dict().items()})
    assert popt2._step_count == 2
    # port -> JAX
    jp2 = [_param(J, np.asarray(p.numpy())) for p in pp]
    jopt2 = getattr(J.optimizer, name)(parameters=jp2, **kw)
    jopt2.set_state_dict({k: (np.asarray(v.numpy() if hasattr(v, "numpy")
                                         else v))
                          for k, v in popt.state_dict().items()})
    assert set(jopt2.state_dict()) == set(popt.state_dict())
    for i in range(3):
        want = _step(J, jopt, jp)
        _close(_step(P, popt2, pp2), want, (name, "jax->port", i))
        _close(_step(J, jopt2, jp2), _step(P, popt, pp),
               (name, "port->jax", i))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_rule_matches_step(name, kw):
    """The plain per-parameter rule, from the same gradients and
    states, gives what the foreach step gives."""
    pp = _params(P)
    opt = getattr(P.optimizer, name)(parameters=pp, **kw)
    for i in range(3):
        _loss(P, pp).backward()
        datas = [p._data for p in pp]
        grads = [d.grad.clone() for d in datas]
        wd = float(kw.get("weight_decay") or 0.0)
        if wd:
            grads = [g + wd * d.detach() for g, d in zip(grads, datas)]
        before = [d.detach().clone() for d in datas]
        states = [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in (opt._accumulators.get(id(p))
                                or opt._init_state(d)).items()}
                  for p, d in zip(pp, datas)]
        want = [opt.rule(b, g, s, opt.get_lr())[0]
                for b, g, s in zip(before, grads, states)]
        opt.step()
        opt.clear_grad()
        _close([d.detach().numpy() for d in datas],
               [w.numpy() for w in want], (name, i))


def test_minimize_is_backward_then_step():
    pp = _params(P)
    opt = P.optimizer.Momentum(learning_rate=0.1, parameters=pp)
    jp = _params(J)
    jopt = J.optimizer.Momentum(learning_rate=0.1, parameters=jp)
    assert opt.minimize(_loss(P, pp)) == (None, None)
    jopt.minimize(_loss(J, jp))
    _close([p.numpy() for p in pp], [p.numpy() for p in jp], "minimize")


def test_momentum_velocity_keeps_the_parameter_dtype():
    """As in the JAX rule: the velocity is bf16 for a bf16 parameter."""
    p = P.to_tensor(np.ones(3, np.float32)).astype("bfloat16")
    p.stop_gradient = False
    opt = P.optimizer.Momentum(learning_rate=0.1, parameters=[p])
    (p * 2.0).sum().backward()
    opt.step()
    assert opt.state_dict()["param0.velocity"].dtype == torch.bfloat16


def test_lamb_keeps_the_exclude_fn_without_reading_it():
    """The JAX Lamb stores ``exclude_from_weight_decay_fn`` and never
    calls it (ROADMAP C); the port's does the same, so excluding every
    parameter changes nothing."""
    runs = []
    for fn in (None, lambda name: True):
        pp = _params(P)
        opt = P.optimizer.Lamb(learning_rate=0.05, parameters=pp,
                               exclude_from_weight_decay_fn=fn)
        runs.append(_step(P, opt, pp))
    _close(runs[1], runs[0], "exclude_fn")
