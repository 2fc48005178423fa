"""The port's training path against the JAX package on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages.  Tolerances, each with its reason:

- cross entropy, clip, one optimizer update in f32: 1e-5 / 1e-6 — the
  same f32 formulas, summed in another order;
- bf16 optimizer updates: one bf16 ulp of the reference value — the
  two frameworks round a Python scalar times a bf16 tensor at
  different points;
- GPT loss and gradients in f32: 1e-5 — the same composition, other
  matmul summation orders;
- three ``TrainStep``s of AdamW with global-norm clipping on
  ``gpt_tiny(num_layers=2)``: the loss within 1e-5 relative at every
  step and every parameter within 1e-5, except that Adam moves an
  element whose gradient is near 0 by about +-lr, so where the two
  gradients differ in sign the parameters may differ by up to
  2 * lr * steps; at most 0.1% of the elements may;
- an O2 bf16 step: loss within 1e-4 relative, parameters within one
  bf16 ulp of the reference value plus 2 * lr * steps (bf16 forward and
  backward round at other points, and Adam turns any sign difference of
  a tiny gradient into +-lr).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn.layer_base import Parameter as JParameter
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------ cross entropy --
@pytest.mark.parametrize("rows", [512, 100])     # chunked, unchunked
def test_cross_entropy_loss_and_grad(rows):
    v = 37
    logits = _rand((rows, v), rows, 3.0)
    labels = np.random.RandomState(rows + 1).randint(0, v, rows)
    labels[::7] = -100                           # ignored rows
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels.astype(np.int32)))
    jl.backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tl = F.cross_entropy(tx, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert not tx.grad[::7].any()


def test_cross_entropy_bf16_logits_reductions():
    logits = _rand((256, 50), 3, 2.0)
    labels = np.random.RandomState(4).randint(0, 50, 256)
    jx = paddle.to_tensor(logits).astype("bfloat16")
    tx = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    for red in ("mean", "sum", "none"):
        want = JF.cross_entropy(jx, paddle.to_tensor(labels.astype(np.int32)),
                                reduction=red).numpy()
        got = F.cross_entropy(tx, torch.from_numpy(labels), reduction=red)
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), rtol=1e-5,
                                   atol=1e-5)
    F.cross_entropy(tx, torch.from_numpy(labels)).backward()
    assert tx.grad.dtype == torch.bfloat16


# ---------------------------------------------------------- optimizer --
_SHAPES = {"w": (7, 5), "b": (5,), "norm_scale": (5,)}


def _pair_params(dtype, names=False):
    """The same values as JAX Parameters and torch Parameters; with
    ``names`` the torch side is ``(name, tensor)`` pairs."""
    jps, tps = [], []
    for i, (name, shape) in enumerate(sorted(_SHAPES.items())):
        a = _rand(shape, 30 + i, 0.5)
        jp = JParameter(a, name=name if names else None)
        tp = torch.nn.Parameter(torch.from_numpy(a))
        if dtype == "bfloat16":
            jp._rebind(jp._data.astype("bfloat16"))
            tp.data = tp.data.to(torch.bfloat16)
        jps.append(jp)
        tps.append((name, tp) if names else tp)
    return jps, tps


def _step_both(jo, to, jps, tps, step):
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        g = _rand(tuple(tp.shape), 100 * step + i, 0.3)
        jp.grad = JTensor(paddle.to_tensor(g)._data.astype(jp._data.dtype))
        tp.grad = torch.from_numpy(g).to(tp.dtype)
    jo.step()
    to.step()


def _assert_params(jps, tps, dtype):
    for jp, tp in zip(jps, tps):
        want = np.asarray(jp._data, np.float32)
        got = tp.detach().float().numpy()
        assert str(tp.dtype) == f"torch.{dtype}"
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", [
    ("Adam", "float32", {}),
    ("Adam", "float32", {"weight_decay": 0.01}),       # coupled decay
    ("AdamW", "float32", {}),
    ("AdamW", "bfloat16", {}),                         # no master weights
    ("AdamW", "float32", {"apply_decay_param_fun":
                          lambda n: not n.startswith("norm")}),
    ("SGD", "float32", {}),
], ids=["adam", "adam_l2", "adamw", "adamw_bf16", "adamw_mask", "sgd"])
def test_optimizer_updates_match_the_jax_rule(case):
    name, dtype, kw = case
    masked = "apply_decay_param_fun" in kw
    jps, named = _pair_params(dtype, names=masked)
    jo = getattr(jopt, name)(learning_rate=LR, parameters=jps, **kw)
    to = getattr(popt, name)(learning_rate=LR, parameters=named, **kw)
    tps = [t[1] for t in named] if masked else named
    for step in range(3):
        _step_both(jo, to, jps, tps, step)
        _assert_params(jps, tps, dtype)
    if name != "SGD":
        st = to.state_dict()
        assert st["step"] == 3 and st["param0.moment1"].dtype == torch.float32
        assert float(st["param0.beta1_pow"]) == pytest.approx(0.9 ** 3)


def test_decay_mask_leaves_unmasked_parameters_undecayed():
    _, named = _pair_params("float32", names=True)
    before = [p.detach().clone() for _, p in named]
    opt = popt.AdamW(learning_rate=0.1, parameters=named, weight_decay=0.5,
                     apply_decay_param_fun=lambda n: n == "w")
    for _, p in named:
        p.grad = torch.zeros_like(p)
    opt.step()                       # zero gradients: only decay moves
    for (name, p), b in zip(named, before):
        if name == "w":
            torch.testing.assert_close(p.detach(), b * (1 - 0.05))
        else:
            torch.testing.assert_close(p.detach(), b)


@pytest.mark.parametrize("clip", [
    ("ClipGradByValue", (0.2,)), ("ClipGradByNorm", (0.5,)),
    ("ClipGradByGlobalNorm", (1.0,))], ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_the_jax_rule(clip, dtype):
    name, args = clip
    grads = [_rand(s, 50 + i, 0.7) for i, s in enumerate([(6, 4), (4,),
                                                          (3, 3)])]
    jg = [paddle.to_tensor(g).astype(dtype)._data for g in grads]
    tg = [torch.from_numpy(g).to(getattr(torch, dtype)) for g in grads]
    want = getattr(jopt, name)(*args)._clip_jax([None] * 3, jg)
    got = getattr(popt, name)(*args)._clip([None] * 3, tg)
    for g, w in zip(got, want):
        assert g.dtype == tg[0].dtype
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=1e-7)


# ----------------------------------------------------------------- lr --
def test_lr_module_is_a_verbatim_copy():
    with open(os.path.join(ROOT, "paddle_tpu", "optimizer", "lr.py"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "paddle_tpu_torch", "optimizer", "lr.py"),
              "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("make", [
    lambda m: m.CosineAnnealingDecay(0.1, T_max=7),
    lambda m: m.LinearWarmup(m.StepDecay(0.1, step_size=3), 4, 0.0, 0.1),
    lambda m: m.PolynomialDecay(0.1, decay_steps=5, end_lr=0.01),
    lambda m: m.NoamDecay(64, 3),
], ids=["cosine", "warmup_step", "polynomial", "noam"])
def test_schedulers_step_the_same_values(make):
    js, ts = make(jopt.lr), make(popt.lr)
    ps = [torch.nn.Parameter(torch.zeros(2))]
    opt = popt.SGD(learning_rate=ts, parameters=ps)
    for _ in range(10):
        assert ts() == js() == opt.get_lr()
        js.step()
        ts.step()


# ---------------------------------------------------------------- GPT --
@pytest.fixture(scope="module")
def carried():
    """JAX gpt_tiny(num_layers=2) and the port model from its state
    dict; carried weights are bitwise (test_torch_gpt.py)."""
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    return jm, sd


def _batch(seed=1, b=4, t=32):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, (b, t)), rng.randint(0, 128, (b, t))


def test_gpt_loss_and_grads_match_jax(carried):
    jm, sd = carried
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.set_state_dict(sd)
    ids, lab = _batch()
    jloss = jm.loss(jm(paddle.to_tensor(ids.astype(np.int32))),
                    paddle.to_tensor(lab.astype(np.int32)))
    jloss.backward()
    tloss = pm.loss(pm(torch.from_numpy(ids)), torch.from_numpy(lab))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=1e-5)
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   jparams[name].grad.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for p in jparams.values():
        p.clear_gradient()


def test_three_train_steps_match_jax_train_step(carried):
    _, sd = carried
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.set_state_dict(sd)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    po = popt.AdamW(learning_rate=LR, parameters=pm.parameters(),
                    grad_clip=popt.ClipGradByGlobalNorm(1.0))
    jstep = JTrainStep(jm, lambda lg, lb: jm.loss(lg, lb), jo)
    pstep = TrainStep(pm, lambda lg, lb: pm.loss(lg, lb), po)
    ids, lab = _batch()
    steps = 3
    for _ in range(steps):
        want = float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                           paddle.to_tensor(lab.astype(np.int32))).numpy())
        got = pstep(torch.from_numpy(ids), torch.from_numpy(lab)).item()
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    ref = {k: np.asarray(v) for k, v in jstep._params.items()}
    off, total = 0, 0
    for name, p in pm.named_parameters():
        d = np.abs(p.detach().numpy() - ref[name])
        assert d.max() <= 2 * LR * steps, name
        off += int((d > 1e-5).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)
    assert pstep.state_dict()["step"] == steps


def test_o2_bf16_steps_match_the_jax_eager_step(carried):
    """O2 against the JAX eager step (a Python-float lr keeps its bf16
    parameters bf16; see the next test for its TrainStep)."""
    _, sd = carried
    paddle.seed(0)
    jm = paddle.amp.decorate(jax_gpt_tiny(num_layers=2), level="O2",
                             dtype="bfloat16")
    jm.set_state_dict({k: paddle.to_tensor(v).astype("bfloat16")
                       for k, v in sd.items()})
    pm = amp.decorate(gpt_tiny(device="cpu", num_layers=2), level="O2")
    pm.set_state_dict(sd)
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16}
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    po = popt.AdamW(learning_rate=LR, parameters=pm.parameters(),
                    grad_clip=popt.ClipGradByGlobalNorm(1.0))
    pstep = TrainStep(pm, lambda lg, lb: pm.loss(lg, lb), po,
                      scaler=amp.GradScaler())
    ids, lab = _batch()
    steps = 2
    for _ in range(steps):
        jo.clear_grad()
        jl = jm.loss(jm(paddle.to_tensor(ids.astype(np.int32))),
                     paddle.to_tensor(lab.astype(np.int32)))
        jl.backward()
        jo.step()
        got = pstep(torch.from_numpy(ids), torch.from_numpy(lab)).item()
        assert abs(got - float(jl.numpy())) <= 1e-4 * abs(float(jl.numpy()))
    ref = {k: np.asarray(v.numpy(), np.float32)
           for k, v in jm.state_dict().items()}
    for name, p in pm.named_parameters():
        assert p.dtype == torch.bfloat16
        want = ref[name]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        d = np.abs(p.detach().float().numpy() - want)
        assert (d <= ulp + 2 * LR * steps).all(), name


def test_reference_train_step_promotes_o2_params_under_adamw_decay():
    """A reference caveat the port does not copy: the JAX TrainStep
    passes lr as a strongly typed f32 array, so AdamW's ``p - lr*wd*p``
    promotes bf16 parameters to f32 after the first step.  The port
    updates them in place and keeps them bf16."""
    paddle.seed(0)
    jm = paddle.amp.decorate(jax_gpt_tiny(num_layers=1), level="O2",
                             dtype="bfloat16")
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda lg, lb: jm.loss(lg, lb), jo)
    ids, lab = _batch(b=2, t=8)
    jstep(paddle.to_tensor(ids.astype(np.int32)),
          paddle.to_tensor(lab.astype(np.int32)))
    assert {str(v.dtype) for v in jstep._params.values()} == {"float32"}
    pm = amp.decorate(gpt_tiny(device="cpu", num_layers=1), level="O2")
    po = popt.AdamW(learning_rate=LR, parameters=pm.parameters())
    TrainStep(pm, lambda lg, lb: pm.loss(lg, lb), po)(
        torch.from_numpy(ids), torch.from_numpy(lab))
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16}


# ---------------------------------------------------- options, dropout --
def test_unported_options_raise():
    pm = gpt_tiny(device="cpu", num_layers=1)
    opt = popt.AdamW(parameters=pm.parameters())
    with pytest.raises(NotImplementedError, match="slice"):
        TrainStep(pm, pm.loss, opt, remat=True)
    with pytest.raises(NotImplementedError, match="slice"):
        amp.GradScaler(dtype="float16")
    with pytest.raises(NotImplementedError, match="slice"):
        TrainStep(pm, pm.loss, opt, scaler=object())
    scaler = amp.GradScaler()
    loss = torch.tensor(2.5)
    assert scaler.scale(loss) is loss


@pytest.mark.parametrize("make", [
    lambda pm: popt.Adam(parameters=pm.parameters(), multi_precision=True),
    lambda pm: popt.AdamW(parameters=pm.parameters(), multi_precision=True),
    lambda pm: amp.decorate(pm, level="O2", master_weight=True),
], ids=["adam", "adamw", "decorate"])
def test_master_weights_raise_rather_than_being_ignored(make):
    pm = gpt_tiny(device="cpu", num_layers=1)
    with pytest.raises(NotImplementedError, match="master weights"):
        make(pm)
    assert {p.dtype for p in pm.parameters()} == {torch.float32}


def test_dropout_modes_and_generator():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(3)
    y = F.dropout(x, p=0.25, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = F.dropout(x, p=0.25, generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    assert F.dropout(x, p=0.25, training=False) is x
    torch.testing.assert_close(
        F.dropout(x, p=0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    rows = F.dropout(torch.ones(50, 8), p=0.5, axis=0,
                     generator=torch.Generator().manual_seed(4))
    assert all(len(set(r.tolist())) == 1 for r in rows)


def test_gpt_dropout_applies_in_train_mode_only():
    pm = gpt_tiny(device="cpu", num_layers=1, hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1)
    ids = torch.from_numpy(_batch(b=1, t=16)[0])
    pm.eval()
    a, b = pm(ids), pm(ids)
    assert torch.equal(a, b)
    pm.train()
    assert not torch.equal(pm(ids), a)
