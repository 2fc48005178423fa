"""The port's ViT and ResNet against the JAX package's, through
``Model.train_batch`` (the port's ``jit.TrainStep`` over a ``Layer``).

With the JAX model's weights loaded by name: the f32 logits agree at
1e-4; three AdamW steps through ``Model.train_batch`` give the JAX
``TrainStep``'s losses and weights at 1e-4; the port's BatchNorm
buffers after those steps equal the eager JAX step's (the JAX
``TrainStep`` restores its buffers, so they never move: ROADMAP C);
ViT's O1 forward under ``auto_cast`` is held, by the bf16 rule, to the
JAX package's O1 error; checkpoints cross both ways.  ``vision.transforms`` is the
JAX module but for ``Resize``, whose torch body is held to the JAX one.
"""

import ast
import inspect

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.vision.transforms as jax_transforms
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P
import paddle_tpu_torch.vision.transforms as port_transforms

RNG = np.random.RandomState(7)
IMGS = RNG.uniform(-1, 1, (8, 3, 32, 32)).astype(np.float32)
LABELS = RNG.randint(0, 10, (8,))
# AdamW with epsilon 1e-3: at 1e-8 Adam's first steps divide a gradient
# by its own size, so an element whose float32 gradient is rounding noise
# (attention's k bias, whose true gradient is zero; convolutions under a
# BatchNorm of few samples) moves a whole ±lr either way in either
# package.  At 1e-3 each update stays proportional to its gradient.
ADAMW = dict(learning_rate=1e-4, epsilon=1e-3)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _models(name, **kw):
    J.seed(0)
    jm = getattr(J.vision.models, name)(**kw)
    P.seed(0)
    pm = getattr(P.vision.models, name)(**kw)
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert list(jsd) == list(psd)
    pm.set_state_dict({k: np.asarray(v.numpy()) for k, v in jsd.items()})
    return jm, pm


MODELS = [("vit_tiny", {}), ("resnet18", {"num_classes": 10})]


@pytest.mark.parametrize("name,kw", MODELS, ids=[m[0] for m in MODELS])
def test_logits_match_reference(name, kw):
    jm, pm = _models(name, **kw)
    jm.eval()
    pm.eval()
    np.testing.assert_allclose(np.asarray(jm(J.to_tensor(IMGS)).numpy()),
                               pm(P.to_tensor(IMGS)).numpy(), **TOL)


def _train(p, model, steps=3):
    m = p.Model(model)
    m.prepare(p.optimizer.AdamW(parameters=model.parameters(), **ADAMW),
              p.nn.CrossEntropyLoss())
    losses = []
    for i in range(steps):
        x = IMGS[::-1] if i % 2 else IMGS
        losses.append(m.train_batch([p.to_tensor(x.copy())],
                                    [p.to_tensor(LABELS)])[0])
    return losses


def _eager_jax_steps(jm, steps=3):
    opt = J.optimizer.AdamW(parameters=jm.parameters(), **ADAMW)
    loss_fn = J.nn.CrossEntropyLoss()
    for i in range(steps):
        x = IMGS[::-1] if i % 2 else IMGS
        loss = loss_fn(jm(J.to_tensor(x.copy())), J.to_tensor(LABELS))
        loss.backward()
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("name,kw", MODELS, ids=[m[0] for m in MODELS])
def test_three_adamw_steps_through_train_batch(name, kw):
    jm, pm = _models(name, **kw)
    jl = _train(J, jm)
    pl = _train(P, pm)
    np.testing.assert_allclose(pl, jl, **TOL)
    psd = pm.state_dict()
    buffers = {k for k in psd if k.endswith(("_mean", "_variance"))}
    for k, v in jm.state_dict().items():
        if k not in buffers:
            np.testing.assert_allclose(psd[k].numpy(), np.asarray(v.numpy()),
                                       err_msg=k, **TOL)
    if not buffers:
        return
    # the JAX TrainStep leaves BatchNorm's statistics where they began
    assert all(np.all(np.asarray(jm.state_dict()[k].numpy()) ==
                      (0.0 if k.endswith("_mean") else 1.0))
               for k in buffers)
    # the port's equal the eager JAX step's, from the same weights
    je, _ = _models(name, **kw)
    _eager_jax_steps(je)
    for k in sorted(buffers):
        np.testing.assert_allclose(psd[k].numpy(),
                                   np.asarray(je.state_dict()[k].numpy()),
                                   err_msg=k, **TOL)


def test_vit_o1_forward_at_the_bf16_rule():
    """Under ``auto_cast`` (O1) the ViT's matmuls and its patch
    convolution run in bf16.  The bf16 rule of a kernel, 1e-2·|f32| +
    1e-3·rms(f32) per element, is exceeded at a whole model's output by
    both packages (6.7× by the JAX package's O1 logits, 7.5× by the
    port's, on these weights), so the port's O1 logits are held to
    the JAX package's O1 error: their worst ratio to the rule within
    1.25× the JAX one, and the same top-1 class for every image."""
    jm, pm = _models("vit_tiny")
    jm.eval()
    pm.eval()
    ref = pm(P.to_tensor(IMGS)).numpy()
    with P.amp.auto_cast():
        got = pm(P.to_tensor(IMGS))
    with J.amp.auto_cast():
        jgot = jm(J.to_tensor(IMGS))
    assert str(got.dtype) == "torch.bfloat16"
    limit = 1e-2 * np.abs(ref) + 1e-3 * np.sqrt(np.mean(ref ** 2))
    got = got.astype("float32").numpy()
    jgot = np.asarray(jgot.astype("float32").numpy())
    ratio, jratio = [np.max(np.abs(o - ref) / limit) for o in (got, jgot)]
    assert ratio <= 1.25 * jratio, (ratio, jratio)
    np.testing.assert_array_equal(got.argmax(-1), jgot.argmax(-1))


def test_checkpoints_cross_both_ways(tmp_path):
    jm, pm = _models("resnet18", num_classes=10)
    _train(P, pm, steps=1)
    P.save(pm.state_dict(), str(tmp_path / "p.pdparams"))
    J.seed(1)
    jm2 = J.vision.models.resnet18(num_classes=10)
    jm2.set_state_dict(J.load(str(tmp_path / "p.pdparams")))
    pm.eval()
    jm2.eval()
    want = pm(P.to_tensor(IMGS)).numpy()
    np.testing.assert_allclose(np.asarray(jm2(J.to_tensor(IMGS)).numpy()),
                               want, **TOL)
    J.save(jm2.state_dict(), str(tmp_path / "j.pdparams"))
    P.seed(1)
    pm2 = P.vision.models.resnet18(num_classes=10)
    pm2.set_state_dict(P.load(str(tmp_path / "j.pdparams")))
    pm2.eval()
    np.testing.assert_array_equal(pm2(P.to_tensor(IMGS)).numpy(), want)


def _defs(mod):
    tree = ast.parse(inspect.getsource(mod))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_transforms_differ_only_in_resize():
    jd, pd = _defs(jax_transforms), _defs(port_transforms)
    assert set(jd) == set(pd)
    assert [k for k in jd if jd[k] != pd[k]] == ["Resize"]


@pytest.mark.parametrize("shape,size", [((3, 16, 12), 24), ((16, 12, 3), 8),
                                        ((10, 10), (5, 20))])
def test_resize_matches_reference(shape, size):
    """Bilinear with antialiasing, half-pixel centres: the JAX
    ``jax.image.resize(method="linear")``, at 1e-4 of the value range."""
    x = np.random.RandomState(1).uniform(0, 255, shape).astype(np.float32)
    want = jax_transforms.Resize(size)(x)
    got = port_transforms.Resize(size)(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-4)


def test_normalize_hwc_to_chw_pipeline():
    img = np.random.RandomState(2).randint(0, 256, (8, 8, 3)).astype(
        np.uint8)
    pipe = [m.Compose([m.ToTensor(), m.Normalize([0.5] * 3, [0.25] * 3)])
            for m in (jax_transforms, port_transforms)]
    np.testing.assert_array_equal(pipe[0](img), pipe[1](img))
