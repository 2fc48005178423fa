"""A reduction over an empty axis list reduces nothing (ROADMAP C14).

JAX reads ``axis=[]`` and ``axis=()`` as "no axis": ``jnp.sum(x,
axis=())`` is x.  Torch reads ``dim=()`` as every dim, so the port's
reductions gave one number (and ``logsumexp``, ``median`` and
``nanmedian`` raised).  Every reduction op that takes ``axis`` is held
here to the JAX op at both spellings, with and without ``keepdim``: the
shape and the values (NaN where JAX gives NaN: ``std`` and ``var`` with
``unbiased=True`` divide 0 by n - 1 = 0).  Where the JAX op raises on a
list (``nansum``, ``nanmean``, ``median``, ``nanmedian``, ``quantile``:
jit's static arguments must hash), the port's ``[]`` is held to JAX's
``()``.  The importer's ``reduce_*`` translators at ``dim: []`` with
``reduce_all: false`` are held to the JAX importer's the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.static import program_import as jimp
from paddle_tpu_torch.ops.registry import OPS as POPS
from paddle_tpu_torch.static import program_import as pimp


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _x(nan=False):
    x = np.random.RandomState(14).randn(3, 4).astype(np.float32)
    if nan:
        x[1, 2] = np.nan
    return x


# (op, keyword arguments, input with a NaN, JAX raises on a list)
CASES = [
    ("sum", {}, False, False), ("nansum", {}, True, True),
    ("mean", {}, False, False), ("nanmean", {}, True, True),
    ("max", {}, False, False), ("min", {}, False, False),
    ("amax", {}, False, False), ("amin", {}, False, False),
    ("std", {}, False, False), ("std", {"unbiased": False}, False, False),
    ("var", {}, False, False), ("var", {"unbiased": False}, False, False),
    ("logsumexp", {}, False, False), ("median", {}, False, True),
    ("nanmedian", {}, True, True), ("prod", {}, False, False),
    ("all", {}, False, False), ("any", {}, False, False),
    ("quantile", {"q": 0.5}, False, True),
    ("p_norm", {"porder": 2.0}, False, False),
    ("p_norm", {"porder": float("inf")}, False, False),
    ("p_norm", {"porder": 0.0}, False, False),
    ("frobenius_norm", {}, False, False),
]


def _call(ops, mod, name, x, axis, kw, keepdim):
    fn = ops[name].user_fn if name in ("p_norm", "frobenius_norm") \
        else getattr(mod, name)
    if name == "quantile":
        return fn(mod.to_tensor(x), kw["q"], axis=axis, keepdim=keepdim)
    return fn(mod.to_tensor(x), axis=axis, keepdim=keepdim, **kw)


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("axis", [[], ()], ids=["list", "tuple"])
@pytest.mark.parametrize("name,kw,nan,jax_list_raises", CASES,
                         ids=[f"{c[0]}{''.join(f'-{v}' for v in c[1].values())}"
                              for c in CASES])
def test_empty_axis_reduces_nothing(name, kw, nan, jax_list_raises, axis,
                                    keepdim):
    x = _x(nan)
    ref_axis = () if jax_list_raises else axis
    want = _call(JOPS, J, name, x, ref_axis, kw, keepdim).numpy()
    got = _call(POPS, P, name, x, axis, kw, keepdim).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=1e-6,
                               atol=1e-6, equal_nan=True)


def test_the_list_spellings_jax_refuses_still_raise_there():
    """The reference caveat the port does not copy: these JAX ops raise
    on ``axis=[]`` (a list is no static jit argument)."""
    for name in ("nansum", "nanmean", "median", "nanmedian"):
        with pytest.raises(ValueError, match="hashable"):
            getattr(J, name)(J.to_tensor(_x()), axis=[])


def test_empty_axis_keeps_gradients_flowing():
    t = P.to_tensor(_x(), stop_gradient=False)
    (P.sum(t, axis=[]) * 2.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full((3, 4), 2.0))


@pytest.mark.parametrize("keep_dim", [False, True])
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min", "reduce_prod"])
def test_reduce_translators_at_an_empty_dim(op, keep_dim):
    x = _x()
    attrs = {"dim": [], "keep_dim": keep_dim, "reduce_all": False}
    want = np.asarray(jimp._TRANSLATORS[op]({"X": jnp.asarray(x)}, attrs))
    got = pimp._TRANSLATORS[op]({"X": torch.from_numpy(x)}, attrs).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
