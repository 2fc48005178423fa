"""The port's convolution, pooling and normalisation layers and the
pooling functions against the JAX package's.

Each layer is built in both packages, the JAX layer's ``state_dict``
(as numpy) is loaded into the port's (the key lists equal, in order),
and the same seeded inputs go through both: outputs, input gradients
and parameter gradients of ``sum(out * w)`` agree at 1e-5 in f32.
BatchNorm's running statistics equal the JAX layer's after three
train-mode calls, and so does its eval output.
"""

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P

RNG = np.random.RandomState(21)
X4 = RNG.uniform(-1, 1, (2, 4, 7, 7)).astype(np.float32)
X3 = RNG.uniform(-1, 1, (2, 4, 9)).astype(np.float32)
X5 = RNG.uniform(-1, 1, (2, 3, 4, 5, 5)).astype(np.float32)
XS = RNG.uniform(-1, 1, (2, 4, 3, 3)).astype(np.float32)
W4 = RNG.uniform(-1, 1, (6, 4, 3, 3)).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


CASES = [
    ("Conv1D", lambda p: p.nn.Conv1D(4, 6, 3, padding=1), (X3,)),
    ("Conv1D_NLC_stride", lambda p: p.nn.Conv1D(
        9, 5, 2, stride=2, data_format="NLC"), (X3,)),
    ("Conv2D", lambda p: p.nn.Conv2D(4, 6, 3, padding=1), (X4,)),
    ("Conv2D_patch", lambda p: p.nn.Conv2D(4, 8, 3, stride=3), (X4,)),
    ("Conv2D_groups_dil", lambda p: p.nn.Conv2D(
        4, 4, 3, padding=2, dilation=2, groups=2, bias_attr=False), (X4,)),
    ("Conv2D_asym_pad", lambda p: p.nn.Conv2D(4, 3, 2, padding=[1, 0, 0, 1]),
     (X4,)),
    ("Conv2D_same", lambda p: p.nn.Conv2D(4, 3, 3, stride=2,
                                          padding="SAME"), (X4,)),
    ("Conv3D", lambda p: p.nn.Conv3D(3, 2, 3, padding=1), (X5,)),
    ("Conv2DTranspose", lambda p: p.nn.Conv2DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1), (XS,)),
    ("MaxPool2D", lambda p: p.nn.MaxPool2D(3, stride=2, padding=1), (X4,)),
    ("MaxPool2D_ceil", lambda p: p.nn.MaxPool2D(2, stride=2, ceil_mode=True),
     (X4,)),
    ("AvgPool2D_excl", lambda p: p.nn.AvgPool2D(3, stride=2, padding=1),
     (X4,)),
    ("AvgPool2D_incl", lambda p: p.nn.AvgPool2D(3, stride=2, padding=1,
                                                exclusive=False), (X4,)),
    ("MaxPool1D", lambda p: p.nn.MaxPool1D(3, stride=2, padding=1), (X3,)),
    ("AvgPool1D", lambda p: p.nn.AvgPool1D(3, stride=2, padding=1), (X3,)),
    ("AdaptiveAvgPool2D", lambda p: p.nn.AdaptiveAvgPool2D((3, 2)), (X4,)),
    ("AdaptiveAvgPool2D_1", lambda p: p.nn.AdaptiveAvgPool2D(1), (X4,)),
    ("AdaptiveMaxPool2D", lambda p: p.nn.AdaptiveMaxPool2D(3), (X4,)),
    ("AdaptiveAvgPool1D", lambda p: p.nn.AdaptiveAvgPool1D(4), (X3,)),
    ("BatchNorm2D_eval", lambda p: p.nn.BatchNorm2D(4).eval(), (X4,)),
    ("BatchNorm1D", lambda p: p.nn.BatchNorm1D(4), (X3,)),
    ("BatchNorm3D", lambda p: p.nn.BatchNorm3D(3), (X5,)),
    ("BatchNorm_relu", lambda p: p.nn.BatchNorm(4, act="relu"), (X4,)),
    ("SyncBatchNorm", lambda p: p.nn.SyncBatchNorm(4), (X4,)),
    ("GroupNorm", lambda p: p.nn.GroupNorm(2, 4), (X4,)),
    ("InstanceNorm2D", lambda p: p.nn.InstanceNorm2D(4), (X4,)),
    ("LocalResponseNorm", lambda p: p.nn.LocalResponseNorm(3), (X4,)),
]


# the JAX max_pool1d has no VJP (its window init is finfo.min, and
# reduce_window's max linearises only with -inf): forward only
NO_JAX_GRAD = {"MaxPool1D"}


def _build(p, ctor):
    p.seed(0)
    return ctor(p)


def _run(p, layer, floats, w_seed=5):
    ins = [p.to_tensor(a, stop_gradient=False) for a in floats]
    out = layer(*ins)
    w = np.random.RandomState(w_seed).uniform(
        0.5, 1.5, out.shape).astype(np.float32)
    (out * p.to_tensor(w)).sum().backward()
    return out, ins


def _copy_state(jl, pl):
    jsd, psd = jl.state_dict(), pl.state_dict()
    assert list(jsd) == list(psd)
    assert all(list(jsd[k].shape) == list(psd[k].shape) for k in jsd)
    missing, unexpected = pl.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jsd.items()})
    assert missing == [] and unexpected == []


@pytest.mark.parametrize("name,ctor,floats", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_reference(name, ctor, floats):
    jl, pl = _build(J, ctor), _build(P, ctor)
    _copy_state(jl, pl)
    if name in NO_JAX_GRAD:
        jout = jl(*[J.to_tensor(a) for a in floats])
        pout, pins = _run(P, pl, floats)
        np.testing.assert_allclose(np.asarray(jout.numpy()), pout.numpy(),
                                   err_msg=name, **TOL)
        assert pins[0].grad is not None
        return
    jout, jins = _run(J, jl, floats)
    pout, pins = _run(P, pl, floats)
    np.testing.assert_allclose(np.asarray(jout.numpy()), pout.numpy(),
                               err_msg=name, **TOL)
    for ji, pi in zip(jins, pins):
        np.testing.assert_allclose(np.asarray(ji.grad.numpy()),
                                   pi.grad.numpy(), err_msg=name, **TOL)
    pgrads = dict(pl.named_parameters())
    for n, jp in jl.named_parameters():
        np.testing.assert_allclose(np.asarray(jp.grad.numpy()),
                                   pgrads[n].grad.numpy(),
                                   err_msg=f"{name}.{n}", **TOL)


@pytest.mark.parametrize("cls", ["BatchNorm1D", "BatchNorm2D", "BatchNorm"])
def test_batchnorm_running_stats_follow_the_jax_rule(cls):
    """Three train-mode calls move ``_mean``/``_variance`` by the JAX
    rule (m · old + (1 - m) · batch, biased variance); the eval output
    then uses them.  torch's rule would give other values."""
    xs = [RNG.uniform(-2, 3, (6, 4, 5)).astype(np.float32)
          for _ in range(3)]
    layers = []
    for p in (J, P):
        layer = _build(p, lambda p: getattr(p.nn, cls)(4))
        layers.append(layer)
        for x in xs:
            layer(p.to_tensor(x if cls == "BatchNorm1D" else x[..., None]))
    jl, pl = layers
    for key in ("_mean", "_variance"):
        np.testing.assert_allclose(np.asarray(jl.state_dict()[key].numpy()),
                                   pl.state_dict()[key].numpy(), **TOL)
    want_mean = 0.0
    for x in xs:
        want_mean = 0.9 * want_mean + 0.1 * x.mean(axis=(0, 2))
    np.testing.assert_allclose(pl._mean.numpy(), want_mean, **TOL)
    jl.eval()
    pl.eval()
    x = xs[0] if cls == "BatchNorm1D" else xs[0][..., None]
    np.testing.assert_allclose(np.asarray(jl(J.to_tensor(x)).numpy()),
                               pl(P.to_tensor(x)).numpy(), **TOL)


def test_spectral_norm_matches_reference_with_its_buffers():
    """SpectralNorm's power iteration and ``weight / sigma`` against the
    JAX layer, from the JAX layer's buffers (the draws differ)."""
    jl = _build(J, lambda p: p.nn.SpectralNorm([6, 4, 3, 3], dim=0,
                                                power_iters=2))
    pl = _build(P, lambda p: p.nn.SpectralNorm([6, 4, 3, 3], dim=0,
                                                power_iters=2))
    _copy_state(jl, pl)
    jout, jins = _run(J, jl, (W4,))
    pout, pins = _run(P, pl, (W4,))
    np.testing.assert_allclose(np.asarray(jout.numpy()), pout.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jins[0].grad.numpy()),
                               pins[0].grad.numpy(), rtol=1e-4, atol=1e-5)
    for key in ("weight_u", "weight_v"):
        np.testing.assert_allclose(np.asarray(jl.state_dict()[key].numpy()),
                                   pl.state_dict()[key].numpy(), **TOL)


FUNCS = [
    ("max_pool2d_same", "max_pool2d", (X4, 3), dict(stride=2,
                                                   padding="SAME")),
    ("max_pool2d_mask", "max_pool2d", (X4, 3), dict(stride=2,
                                                   return_mask=True)),
    ("max_pool2d_nhwc", "max_pool2d", (X4.transpose(0, 2, 3, 1), 2),
     dict(data_format="NHWC")),
    ("avg_pool2d_same", "avg_pool2d", (X4, 3), dict(stride=2,
                                                   padding="SAME")),
    ("avg_pool2d_ceil", "avg_pool2d", (X4, 2), dict(ceil_mode=True)),
    ("max_pool1d_pad", "max_pool1d", (X3, 2), dict(padding=1)),
    ("adaptive_max_pool2d_even", "adaptive_max_pool2d", (X4[..., :6, :6], 3),
     {}),
    ("adaptive_avg_pool2d_nhwc", "adaptive_avg_pool2d",
     (X4.transpose(0, 2, 3, 1), 2), dict(data_format="NHWC")),
    ("conv1d_same", "conv1d", (X3, W4[:, :, 1]), dict(padding="SAME")),
    ("local_response_norm", "local_response_norm", (X4, 5),
     dict(alpha=1e-3, beta=0.5, k=2.0)),
]


@pytest.mark.parametrize("name,fn,args,kwargs", FUNCS,
                         ids=[f[0] for f in FUNCS])
def test_functional_matches_reference(name, fn, args, kwargs):
    """The functional forms keep the JAX bodies' pads, divisors and
    masks (``avg_pool2d`` with "SAME" divides by the window's size,
    ``ceil_mode`` is ignored where the JAX body ignores it)."""
    outs = []
    for p in (J, P):
        targs = [p.to_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        res = getattr(p.nn.functional, fn)(*targs, **kwargs)
        res = res if isinstance(res, (tuple, list)) else (res,)
        outs.append([np.asarray(r.numpy()) for r in res])
    for j, q in zip(*outs):
        assert j.shape == q.shape, name
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(j, q, err_msg=name)
        else:
            np.testing.assert_allclose(j, q, err_msg=name, **TOL)


def test_max_pool2d_mask_at_padded_borders():
    """With padding, the JAX mask is wrong in the windows that touch the
    padding (its patches multiply the -inf border by zero, and the NaN
    wins the argmax: -1 on the low border); the port gives the input
    position of each window's max, as Paddle does.  In the windows
    clear of the padding the two agree."""
    pairs = [J.nn.functional.max_pool2d(J.to_tensor(X4), 3, stride=2,
                                        padding=1, return_mask=True),
             P.nn.functional.max_pool2d(P.to_tensor(X4), 3, stride=2,
                                        padding=1, return_mask=True)]
    (jo, jm), (po, pm) = [(np.asarray(o.numpy()), np.asarray(m.numpy()))
                          for o, m in pairs]
    np.testing.assert_allclose(jo, po, **TOL)
    np.testing.assert_array_equal(jm[..., 1:-1, 1:-1], pm[..., 1:-1, 1:-1])
    assert (jm[..., 0, :] == -1).all() and (jm[..., :, 0] == -1).all()
    flat = X4.reshape(2, 4, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, pm.reshape(2, 4, -1), -1).reshape(po.shape),
        po)
