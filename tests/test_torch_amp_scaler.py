"""Dynamic loss scaling (C9): the port's ``amp.GradScaler``, its
``scaler_*`` functions and ``jit.TrainStep(scaler=)`` against the JAX
package's, on the CPU, from the same numpy weights and inputs.

The scale trajectory, the skip of a step with a non-finite gradient,
``get_scale`` and ``state_dict`` must be equal; parameters within 1e-6
(the same f32 formulas).  The step count follows the JAX package: a
``TrainStep`` counts a skipped step, the optimizer's own count does not
move on it, and AdamW's state (its beta powers) stays.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep

import paddle_tpu_torch as paddle
from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.jit import TrainStep

F = nn.functional


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


def _models(din=8, dout=3, seed=0):
    """A port Linear and a JAX Linear with the same numpy weights."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(din, dout) * 0.3).astype(np.float32)
    b = (rng.randn(dout) * 0.1).astype(np.float32)
    pm, jm = nn.Linear(din, dout), jnn.Linear(din, dout)
    pm.set_state_dict({"weight": w, "bias": b})
    jm.set_state_dict({"weight": jpaddle.to_tensor(w),
                       "bias": jpaddle.to_tensor(b)})
    return pm, jm


def _batches(n=5, inf_at=(2,), din=8, dout=3):
    rng = np.random.RandomState(7)
    out = []
    for i in range(n):
        x = rng.randn(16, din).astype(np.float32)
        if i in inf_at:
            x[3, 1] = np.inf
        out.append((x, rng.randn(16, dout).astype(np.float32)))
    return out


def _close(port_params, jax_params, tol=1e-6):
    for p, j in zip(port_params, jax_params):
        np.testing.assert_allclose(p.numpy(), np.asarray(j.numpy()),
                                   rtol=tol, atol=tol)


def test_scale_multiplies_the_loss():
    loss = np.float32(0.8125)
    got = amp.GradScaler(init_loss_scaling=1024.0).scale(
        paddle.to_tensor(loss))
    want = jpaddle.amp.GradScaler(init_loss_scaling=1024.0).scale(
        jpaddle.to_tensor(loss))
    assert float(got) == float(want) == 1024.0 * 0.8125
    assert amp.GradScaler(enable=False).scale(torch.tensor(2.5)).item() \
        == 2.5


@pytest.mark.parametrize("kw", [
    {},
    dict(init_loss_scaling=1024.0, incr_every_n_steps=2),
    dict(init_loss_scaling=4.0, decr_every_n_nan_or_inf=2,
         incr_every_n_steps=3, decr_ratio=0.25),
    dict(init_loss_scaling=2.0, decr_ratio=0.25),     # the 1.0 floor
    dict(init_loss_scaling=512.0, use_dynamic_loss_scaling=False),
], ids=["defaults", "grow", "two_bad", "floor", "static"])
def test_eager_flow_matches_the_reference(kw):
    """scale -> backward -> step -> update over 6 steps, two of them on
    an input holding inf: the same skips, scales, states and weights."""
    pm, jm = _models()
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    ps, js = amp.GradScaler(**kw), jpaddle.amp.GradScaler(**kw)
    for x, y in _batches(6, inf_at=(1, 2)):
        for model, opt, scaler, lib in ((pm, po, ps, paddle),
                                        (jm, jo, js, jpaddle)):
            loss = lib.nn.functional.mse_loss(model(lib.to_tensor(x)),
                                              lib.to_tensor(y))
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        assert ps.get_scale() == js.get_scale()
        assert ps.state_dict() == js.state_dict()
        assert po._step_count == jo._step_count
        _close(pm.parameters(), jm.parameters())


def test_minimize_and_unscale_once():
    pm, jm = _models()
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    ps = amp.GradScaler(init_loss_scaling=64.0)
    js = jpaddle.amp.GradScaler(init_loss_scaling=64.0)
    (x, y), = _batches(1, inf_at=())
    for model, opt, scaler, lib in ((pm, po, ps, paddle),
                                    (jm, jo, js, jpaddle)):
        loss = lib.nn.functional.mse_loss(model(lib.to_tensor(x)),
                                          lib.to_tensor(y))
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.unscale_(opt)
        scaler.unscale_(opt)           # once a step: the second is a no-op
        g = model.weight.grad.numpy().copy()
        scaler.step(opt)
        scaler.update()
        if lib is paddle:
            pg = g
        else:
            np.testing.assert_allclose(pg, g, rtol=1e-6, atol=1e-7)
    _close(pm.parameters(), jm.parameters())
    assert ps.is_enable() and ps.get_scale() == js.get_scale()


def _train_steps(opt_kind, kw, batches):
    """Port and JAX TrainStep(scaler=) over ``batches`` -> the records of
    both: (loss, scale, state_dict, step) per step, and the models and
    optimizers."""
    pm, jm = _models()
    if opt_kind == "adamw":
        po = optimizer.AdamW(learning_rate=1e-2, parameters=pm.parameters(),
                             epsilon=1e-3)
        jo = jopt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                        epsilon=1e-3)
    else:
        po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
        jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    ps, js = amp.GradScaler(**kw), jpaddle.amp.GradScaler(**kw)
    pstep = TrainStep(pm, lambda o, y: F.mse_loss(o, y), po, scaler=ps)
    jstep = JTrainStep(jm, lambda o, y: jpaddle.nn.functional.mse_loss(o, y),
                       jo, scaler=js)
    rec = []
    for x, y in batches:
        pl = pstep(paddle.to_tensor(x), paddle.to_tensor(y))
        jl = jstep(jpaddle.to_tensor(x), jpaddle.to_tensor(y))
        rec.append(((float(pl), ps.get_scale(), ps.state_dict(),
                     pstep.state_dict()["step"]),
                    (float(jl), js.get_scale(), js.state_dict(),
                     jstep.state_dict()["step"])))
    return rec, (pm, po, pstep), (jm, jo, jstep)


@pytest.mark.parametrize("opt_kind", ["sgd", "adamw"])
def test_train_step_matches_the_reference(opt_kind):
    """Five scaled TrainSteps, the third on an input holding inf: the
    same losses (the unscaled loss; inf on the skipped step), scales,
    counts and step numbers, and parameters within 1e-6 — AdamW keeps
    its moments and beta powers over the skip, and its next update is
    the reference's."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    rec, (pm, po, pstep), (jm, jo, jstep) = _train_steps(
        opt_kind, kw, _batches(5, inf_at=(2,)))
    for (pl, pscale, psd, pn), (jl, jscale, jsd, jn) in rec:
        assert (pscale, psd, pn) == (jscale, jsd, jn)
        if np.isfinite(jl):
            np.testing.assert_allclose(pl, jl, rtol=1e-6)
        else:
            assert not np.isfinite(pl)
    assert [r[0][1] for r in rec] == [1024.0, 2048.0, 1024.0, 1024.0,
                                      2048.0]
    # the JAX TrainStep applies its pytree rule (the optimizer's own
    # count stays 0); the port steps the optimizer, which counted only
    # the four updates, not the skip
    assert po._step_count == 4 and pstep.state_dict()["step"] == 5
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(pm, name).numpy(),
                                   np.asarray(jstep._params[name]),
                                   rtol=1e-6, atol=1e-6)
    if opt_kind == "adamw":
        st = po._accumulators[id(pm.weight)]
        jst = jstep._opt_state["weight"]
        np.testing.assert_allclose(st["beta1_pow"], float(jst["beta1_pow"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(st["moment1"].numpy(),
                                   np.asarray(jst["moment1"]), rtol=1e-5,
                                   atol=1e-8)


def test_skipped_step_keeps_parameters_and_state_bitwise():
    pm, _ = _models()
    po = optimizer.AdamW(learning_rate=1e-2, parameters=pm.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    step = TrainStep(pm, lambda o, y: F.mse_loss(o, y), po, scaler=scaler)
    (x, y), (xi, yi) = _batches(2, inf_at=(1,))
    step(paddle.to_tensor(x), paddle.to_tensor(y))
    before = [p._data.clone() for p in pm.parameters()]
    state = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in po._accumulators[id(po._parameters[0])].items()}
    step(paddle.to_tensor(xi), paddle.to_tensor(yi))
    assert all(torch.equal(a, p._data) for a, p in zip(before,
                                                       pm.parameters()))
    after = po._accumulators[id(po._parameters[0])]
    for k, v in state.items():
        assert (torch.equal(v, after[k]) if isinstance(v, torch.Tensor)
                else v == after[k]), k
    assert scaler.get_scale() == 512.0
    assert scaler.state_dict() == {"scale": 512.0, "good_steps": 0,
                                   "bad_steps": 0}


def test_state_dict_crosses_both_ways_and_writes_through():
    """GradScaler.state_dict loads into the other package's scaler, also
    one attached to a TrainStep (whose live state it then replaces)."""
    kw = dict(init_loss_scaling=256.0, incr_every_n_steps=2)
    rec, (pm, po, pstep), (jm, jo, jstep) = _train_steps(
        "sgd", kw, _batches(3, inf_at=(1,)))
    ps, js = pstep.scaler, jstep.scaler
    assert ps.state_dict() == js.state_dict()
    fresh_p, fresh_j = amp.GradScaler(), jpaddle.amp.GradScaler()
    fresh_p.set_state_dict(js.state_dict())
    fresh_j.set_state_dict(ps.state_dict())
    assert fresh_p.state_dict() == fresh_j.state_dict() == js.state_dict()
    ps.set_state_dict({"scale": 32.0, "good_steps": 1, "bad_steps": 0})
    js.set_state_dict({"scale": 32.0, "good_steps": 1, "bad_steps": 0})
    (x, y), = _batches(1, inf_at=())
    pstep(paddle.to_tensor(x), paddle.to_tensor(y))
    jstep(jpaddle.to_tensor(x), jpaddle.to_tensor(y))
    assert ps.state_dict() == js.state_dict() == {
        "scale": 64.0, "good_steps": 0, "bad_steps": 0}


def test_device_state_functions_follow_the_rule():
    """scaler_apply on tensors: unscaled gradients, the flag, and the
    next state, against the JAX function on the same values."""
    from paddle_tpu.amp import scaler_apply as japply
    from paddle_tpu.amp import scaler_init_state as jinit

    import jax.numpy as jnp

    s = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=1)
    j = jpaddle.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=1)
    pst, jst = amp.scaler_init_state(s), jinit(j)
    for bad in (False, True, False):
        g = np.full((3, 2), 4.0, np.float32)
        if bad:
            g[0, 0] = np.nan
        pg, pf, pst = amp.scaler_apply(s, pst, [torch.from_numpy(g.copy())])
        jg, jf, jst = japply(j, jst, [jnp.asarray(g)])
        assert bool(pf) == bool(jf)
        np.testing.assert_array_equal(pg[0].numpy(), np.asarray(jg[0]))
        assert float(pst["scale"]) == float(jst["scale"])
        assert int(pst["good"]) == int(jst["good"])
        assert int(pst["bad"]) == int(jst["bad"])


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_scale_below_one_checks_the_products(scale):
    """The JAX rule checks ``g / scale``: below a scale of 1 a finite
    gradient near the f32 maximum unscales to inf and the step is
    skipped; at 2 it stays finite.  Eager and on device tensors."""
    from paddle_tpu.amp import scaler_apply as japply
    from paddle_tpu.amp import scaler_init_state as jinit

    import jax.numpy as jnp

    g = np.full((3,), 3e38, np.float32)
    s = amp.GradScaler(init_loss_scaling=scale)
    j = jpaddle.amp.GradScaler(init_loss_scaling=scale)
    _, pf, _ = amp.scaler_apply(s, amp.scaler_init_state(s),
                                [torch.from_numpy(g.copy())])
    _, jf, _ = japply(j, jinit(j), [jnp.asarray(g)])
    assert bool(pf) == bool(jf) == (scale < 1.0)
    pm, _ = _models(din=1, dout=3)
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    pm.bias.grad = torch.from_numpy(g.copy())
    s.unscale_(po)
    assert s._found_inf == (scale < 1.0)


def test_float16_gradients_unscale_into_f32():
    """A float16 gradient is unscaled into an f32 copy (as the JAX step's
    f32 1/scale promotes it): a scaled gradient of 2^-10 unscaled by
    2^16 is 2^-26, which float16 flushes to zero."""
    g = torch.full((4,), 2.0 ** -10, dtype=torch.float16)
    out, found = amp._unscale([g], float(np.float32(2.0 ** -16)))
    assert out[0].dtype == torch.float32 and not bool(found)
    assert float(out[0][0]) == 2.0 ** -26
    assert float(g.float().mul(2.0 ** -16).half()[0]) == 0.0


def test_train_step_without_scaler_and_disabled_scaler():
    pm, _ = _models()
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    step = TrainStep(pm, lambda o, y: F.mse_loss(o, y), po,
                     scaler=amp.GradScaler(enable=False))
    assert step.scaler is None
    (x, y), = _batches(1, inf_at=())
    assert np.isfinite(float(step(paddle.to_tensor(x), paddle.to_tensor(y))))
