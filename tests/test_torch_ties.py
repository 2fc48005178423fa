"""Ties and kinks: the port's values and gradients against the JAX
package's at the inputs of ROADMAP C4-C6.

torch's conventions differ from JAX's exactly where the op sweep's
random inputs never land: ``torch.topk`` orders tied values freely
(``lax.top_k`` puts the lowest index first), ``amax`` splits a tied
window maximum's gradient (``reduce_window``'s VJP sends it all to the
first maximum), ``torch.abs`` has derivative 0 at 0 (``lax.abs``: 1),
``torch.clamp`` gives a bound's tie all of the gradient
(``jnp.maximum``/``jnp.minimum`` split it), ``jax.nn.relu6`` has
derivative 0 at both bounds, ``jax.nn.leaky_relu`` 1 at 0, ``jnp.fmax``
sends an equal pair's gradient to ``y``, and ``lax.cummax``'s gradient
follows its associative scan's tree.  Each case takes the same numpy
inputs through both packages; outputs agree at 1e-6 and the gradients
of ``sum(out * w)`` (``w`` seeded) at 1e-6.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as PF

# ROADMAP C6's probe input, with hardswish's kink at -3
X = np.array([0, 1, -1, 0.5, -0.5, 2, 0, 6, -3], np.float32)
ZERO = np.zeros(4, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


# name, fn(pkg, F, *tensors), float inputs (graded), other inputs
CASES = [
    # C4
    ("topk", lambda m, F, x: m.topk(x, 3), [[[0, 1, 1, 2, 1]]], []),
    ("topk_smallest", lambda m, F, x: m.topk(x, 2, largest=False),
     [[[0, 1, 1, 2, 1]]], []),
    ("topk_axis0", lambda m, F, x: m.topk(x, 2, axis=0),
     [[[1, 3], [1, 3], [2, 0]]], []),
    # C5
    ("max_pool2d", lambda m, F, x: F.max_pool2d(x, 2),
     [[[[[1, 1], [0, 1]]]]], []),
    ("max_pool2d_pair", lambda m, F, x: F.max_pool2d(x, 2),
     [[[[[0, 1], [3, 3]]]]], []),
    ("max_pool2d_stride1", lambda m, F, x: F.max_pool2d(x, 2, stride=1),
     [[[[[2, 2, 1], [2, 0, 2], [1, 2, 2]]]]], []),
    ("max_pool2d_mask", lambda m, F, x: F.max_pool2d(x, 2,
                                                     return_mask=True),
     [[[[[1, 1], [0, 1]]]]], []),
    ("MaxPool2D", lambda m, F, x: m.nn.MaxPool2D(2)(x),
     [[[[[1, 1], [0, 1]]]]], []),
    ("pool2d_max", lambda m, F, x: m.pool2d(x, 2, strides=2),
     [[[[[1, 1], [0, 1]]]]], []),
    ("max_pool2d_with_index",
     lambda m, F, x: m.max_pool2d_with_index(x, [2, 2]),
     [[[[[1, 1], [0, 1]]]]], []),
    # jnp.max splits a tie, as amax does: the two agree
    ("maxout", lambda m, F, x: F.maxout(x, 2, axis=1),
     [[[[[1, 3]], [[1, 2]]]]], []),
    # C6
    ("abs", lambda m, F, x: m.abs(x), [X], []),
    ("l1_loss", lambda m, F, x, y: F.l1_loss(x, y, reduction="sum"),
     [X, X[::-1].copy()], []),
    ("norm_p1", lambda m, F, x: m.linalg.norm(x, p=1), [X], []),
    ("dist_p1", lambda m, F, x, y: m.dist(x, y, p=1), [X, X], []),
    ("normalize_p1", lambda m, F, x: F.normalize(x[None], p=1, axis=1),
     [X], []),
    ("bce_with_logits_at_0",
     lambda m, F, x, y: F.binary_cross_entropy_with_logits(x, y),
     [ZERO], [np.array([0, 1, 0.25, 1], np.float32)]),
    ("clip", lambda m, F, x: m.clip(x, 0.0, 1.0), [X], []),
    ("hardtanh", lambda m, F, x: F.hardtanh(x), [X], []),
    ("hardsigmoid", lambda m, F, x: F.hardsigmoid(x, slope=0.5), [X], []),
    ("relu6", lambda m, F, x: F.relu6(x), [X], []),
    ("hardswish", lambda m, F, x: F.hardswish(x), [X], []),
    ("leaky_relu", lambda m, F, x: F.leaky_relu(x), [X], []),
    ("margin_ranking_loss",
     lambda m, F, x, y, lbl: F.margin_ranking_loss(x, y, lbl,
                                                    reduction="sum"),
     [np.array([1, 2, 0, 3], np.float32), np.array([1, 1, 0, 4],
                                                    np.float32)],
     [np.array([1, -1, 1, -1], np.float32)]),
    ("fmax", lambda m, F, x, y: m.fmax(x, y),
     [np.array([1, 2, np.nan, 0], np.float32),
      np.array([1, 3, 1, 0], np.float32)], []),
    ("fmin", lambda m, F, x, y: m.fmin(x, y),
     [np.array([1, 2, 1, 0], np.float32),
      np.array([1, 3, np.nan, 0], np.float32)], []),
    ("cummax", lambda m, F, x: m.cummax(x), [[0, 1, 1, 2]], []),
    ("cummax_run", lambda m, F, x: m.cummax(x), [[1, 1, 1, 1, 1]], []),
    ("cummin_2d", lambda m, F, x: m.cummin(x, axis=1),
     [[[3, 1, 1, 2, 1, 0, 0]]], []),
]


def _run(pkg, fpkg, fn, floats, others):
    ts = [pkg.to_tensor(np.asarray(a, np.float32), stop_gradient=False)
          for a in floats]
    os_ = [pkg.to_tensor(np.asarray(a)) for a in others]
    out = fn(pkg, fpkg, *ts, *os_)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    vals = [np.asarray(o.numpy()) for o in outs]
    rng = np.random.RandomState(5)
    loss = None
    for o, v in zip(outs, vals):
        if np.issubdtype(v.dtype, np.floating):
            w = pkg.to_tensor(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
            term = pkg.sum(o * w)
            loss = term if loss is None else loss + term
    loss.backward()
    grads = [np.zeros(np.shape(a), np.float32) if t.grad is None
             else np.asarray(t.grad.numpy()) for t, a in zip(ts, floats)]
    return vals, grads


@pytest.mark.parametrize("name,fn,floats,others", CASES,
                         ids=[c[0] for c in CASES])
def test_tie_matches_jax(name, fn, floats, others):
    got_v, got_g = _run(P, PF, fn, floats, others)
    want_v, want_g = _run(J, JF, fn, floats, others)
    assert len(got_v) == len(want_v)
    for g, w in zip(got_v, want_v):
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_roadmap_values():
    """The values ROADMAP C4-C6 names, spelled out."""
    row = np.array([[0, 1, 1, 2, 1]], np.float32)
    assert P.topk(P.to_tensor(row), 3)[1].numpy().tolist() == [[3, 1, 2]]
    assert P.topk(P.to_tensor(row), 2, largest=False)[1].numpy().tolist() \
        == [[0, 1]]
    _, (g,) = _run(P, PF, lambda m, F, x: F.max_pool2d(x, 2),
                   [[[[[1, 1], [0, 1]]]]], [])
    assert (g.reshape(-1)[1:] == 0).all() and g.reshape(-1)[0] > 0
    x = P.to_tensor(np.array([0.0], np.float32), stop_gradient=False)
    P.abs(x).sum().backward()
    assert x.grad.numpy().tolist() == [1.0]
    x = P.to_tensor(np.array([0, 1, 1, 2], np.float32), stop_gradient=False)
    P.cummax(x).sum().backward()
    assert x.grad.numpy().tolist() == [1.0, 1.5, 0.5, 1.0]
