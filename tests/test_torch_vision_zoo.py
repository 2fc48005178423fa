"""The rest of the port's vision zoo against the JAX package's: VGG,
MobileNetV2, DenseNet, SqueezeNet, ShuffleNetV2 and InceptionV3.

Each model is built in the port at its smallest construction, and the
JAX model gets the port's weights by name (``torch_ref_helpers``: the
state-dict keys must be equal, in order).  The eval forward of every
whole model must agree at 1e-4.  One SGD step — the port's eager step
against the JAX ``TrainStep``, loss ``mean(out * w)``, dropout off —
must give the same loss and updated weights at 1e-4: for VGG and
SqueezeNet as whole models; for the other four on their building
blocks, chained as each model chains them (MobileNetV2's inverted
residuals, ShuffleNetV2's units of both strides, a dense block and a
transition, Inception's first block and grid reduction; the later
blocks in the whole-model forward), since XLA compiles a whole-model
step of those in 8 to 30 s on the CPU.  The whole-model steps run on
the port in the reference bodies of ``test_models_zoo.py``
(``test_torch_reference_bodies.py``, marked slow as their file is).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.vision.models.densenet as JDN
import paddle_tpu.vision.models.inception as JIN
import paddle_tpu.vision.models.mobilenetv2 as JMB
import paddle_tpu.vision.models.shufflenetv2 as JSH
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P
import paddle_tpu_torch.vision.models.densenet as PDN
import paddle_tpu_torch.vision.models.inception as PIN
import paddle_tpu_torch.vision.models.mobilenetv2 as PMB
import paddle_tpu_torch.vision.models.shufflenetv2 as PSH

from torch_ref_helpers import jax_forward, jax_twin

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU, torch on one thread (idle intra-op threads
    spinning beside the other test processes slow the JAX compiles), the
    JAX package without its dispatch cache's per-op compiles."""
    P.set_device("cpu")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)
    torch.set_num_threads(saved)


def _images(hw, seed=0, batch=2, ch=3):
    return np.random.RandomState(seed).rand(batch, ch, hw, hw) \
        .astype(np.float32)


# name, constructor kwargs (the smallest construction), input side
MODELS = [
    ("vgg11", dict(batch_norm=True, num_classes=0, with_pool=False), 32),
    ("mobilenet_v2", dict(scale=0.25, num_classes=5), 32),
    ("densenet121", dict(growth_rate=4, bn_size=1, num_classes=5), 32),
    ("squeezenet1_1", dict(num_classes=5), 48),
    ("shufflenet_v2_x0_25", dict(num_classes=5), 32),
    ("inception_v3", dict(num_classes=5), 75),     # its smallest input
]


def _pair(name, kw):
    P.seed(0)
    pm = getattr(P.vision.models, name)(**kw)
    jm = jax_twin(lambda: getattr(J.vision.models, name)(**kw), pm)
    return pm, jm


@pytest.mark.parametrize("name,kw,hw", MODELS, ids=[m[0] for m in MODELS])
def test_forward_matches_reference(name, kw, hw):
    pm, jm = _pair(name, kw)
    x = _images(hw)
    pm.eval()
    np.testing.assert_allclose(pm(P.to_tensor(x)).numpy(),
                               jax_forward(jm, x), **TOL)


def _no_dropout(model):
    for layer in model.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0


def _step_both(pm, jm, x):
    """One SGD step of ``mean(out * w)`` in each package -> (port loss,
    JAX loss); the models hold the updated weights."""
    _no_dropout(pm)
    _no_dropout(jm)
    pm.train()
    jm.train()
    out = pm(P.to_tensor(x))
    w = np.random.RandomState(1).uniform(0.5, 1.5, out.shape) \
        .astype(np.float32)
    opt = P.optimizer.SGD(learning_rate=LR, parameters=pm.parameters())
    loss = (out * P.to_tensor(w)).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    step = J.jit.TrainStep(
        jm, lambda o, wt: (o * wt).mean(),
        J.optimizer.SGD(learning_rate=LR, parameters=jm.parameters()))
    want = float(step(J.to_tensor(x), J.to_tensor(w)).numpy())
    return float(loss), want


def _assert_step(pm, jm, x):
    got, want = _step_both(pm, jm, x)
    np.testing.assert_allclose(got, want, **TOL)
    jsd = jm.state_dict()
    for name, prm in pm.named_parameters():
        np.testing.assert_allclose(prm.numpy(), np.asarray(jsd[name].numpy()),
                                   **TOL, err_msg=name)


STEP_MODELS = [MODELS[0], MODELS[3]]


@pytest.mark.parametrize("name,kw,hw", STEP_MODELS,
                         ids=[m[0] for m in STEP_MODELS])
def test_whole_model_step_matches_reference(name, kw, hw):
    pm, jm = _pair(name, kw)
    _assert_step(pm, jm, _images(hw, seed=2))


def _mobilenet(m, p):
    return p.nn.Sequential(m.ConvBNReLU(4, 8, stride=2),
                           m.InvertedResidual(8, 8, 1, 6),
                           m.InvertedResidual(8, 16, 2, 6))


def _shufflenet(m, p):
    return p.nn.Sequential(m._InvertedResidual(8, 16, 2),
                           m._InvertedResidual(16, 16, 1),
                           m._InvertedResidual(16, 16, 1, act="swish"))


def _densenet(m, p):
    return p.nn.Sequential(m._DenseBlock(2, 8, 2, 4, 0.0),
                           m._Transition(16, 8))


def _inception(m, p):
    # the first block and the 17 -> 8 grid reduction after it, as in the
    # model, with a narrow input; C to E step in the slow body and run
    # forward in the whole model above
    return p.nn.Sequential(m._InceptionA(4, 8), m._InceptionB(232))


BLOCKS = [("mobilenet_v2", _mobilenet, JMB, PMB, 4, 16),
          ("shufflenet_v2", _shufflenet, JSH, PSH, 8, 16),
          ("densenet", _densenet, JDN, PDN, 8, 8),
          ("inception_v3", _inception, JIN, PIN, 4, 17)]


@pytest.mark.parametrize("name,build,jmod,pmod,ch,hw", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_step_matches_reference(name, build, jmod, pmod, ch, hw):
    P.seed(0)
    pm = build(pmod, P)
    jm = jax_twin(lambda: build(jmod, J), pm)
    _assert_step(pm, jm, _images(hw, seed=3, ch=ch))


def test_shuffle_is_the_reference_permutation():
    x = np.arange(2 * 8 * 2 * 2, dtype=np.float32).reshape(2, 8, 2, 2)
    np.testing.assert_array_equal(
        PSH._channel_shuffle(P.to_tensor(x), 2).numpy(),
        np.asarray(JSH._channel_shuffle(J.to_tensor(x), 2).numpy()))


def test_zoo_names_match_the_reference():
    """Every name the JAX zoo exports, the port's exports too."""
    jnames = {n for n in dir(J.vision.models) if not n.startswith("_")}
    pnames = {n for n in dir(P.vision.models) if not n.startswith("_")}
    assert jnames - pnames == set()


@pytest.mark.parametrize("name", ["vgg", "mobilenetv2", "densenet",
                                  "squeezenet", "shufflenetv2", "inception"])
def test_zoo_modules_differ_only_in_the_package_import(name):
    """Each zoo module is the JAX module's text but where that imports
    the top-level ``paddle_tpu``, which here is the port's package."""
    import inspect
    import importlib

    ref = inspect.getsource(importlib.import_module(
        f"paddle_tpu.vision.models.{name}"))
    port = inspect.getsource(importlib.import_module(
        f"paddle_tpu_torch.vision.models.{name}"))
    assert port == ref.replace("import paddle_tpu as ",
                               "import paddle_tpu_torch as ")
