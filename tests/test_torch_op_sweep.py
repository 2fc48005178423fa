"""The port's op registry against the JAX package's, op by op.

The port registers all 389 inventory ops, from every op family of the
JAX package and ``nn/functional.py``.  For each op with a spec the
inputs come from ``op_specs`` (``make(rng)`` with the JAX sweep's
seeds).  The port's forward is held to the spec's numpy reference or
check at the spec's ``rtol``/``atol``, and to the JAX op's output at the
same tolerance; for each spec with ``grad``, the port's torch-autograd
gradient is held to the JAX tape's within the spec's ``grad_rtol`` on
the max-abs scale (the JAX sweep's scale).  The ops without a spec that
are not collectives (the JAX sweep skips those too) run in ``EXTRA``
against the JAX op.  Integer outputs compare by
value: the port keeps Paddle's int64 where the JAX package narrows to
int32, and ``INT_WIDTH_ONLY`` lists every op where only that width
differs.  Complex gradients compare up to torch's conjugate convention
(torch gives dL/dRe + i dL/dIm, the JAX tape dL/dRe - i dL/dIm).
"""

import zlib

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.ops.dispatch import enable_dispatch_cache
from paddle_tpu.ops.inventory import OP_INVENTORY
from paddle_tpu.ops.registry import OPS as JOPS

import op_specs  # noqa: F401  (populates SPECS)
from op_sweep_harness import SPECS, _scalarize, _wrap

import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops.registry import OPS, OpSchemaError, op
from paddle_tpu_torch.ops.waiting import WAITING

_FAMILIES = ("paddle_tpu.ops.creation", "paddle_tpu.ops.math",
             "paddle_tpu.ops.manipulation", "paddle_tpu.ops.logic",
             "paddle_tpu.ops.random", "paddle_tpu.ops.linalg",
             "paddle_tpu.ops.pool_ops", "paddle_tpu.nn.functional",
             "paddle_tpu.ops.misc_ops", "paddle_tpu.ops.vision_ops",
             "paddle_tpu.ops.optim_ops", "paddle_tpu.ops.fused_ops",
             "paddle_tpu.ops.seq_ops", "paddle_tpu.ops.sparse_ops",
             "paddle_tpu.ops.graph_ops", "paddle_tpu.ops.conv_extra",
             "paddle_tpu.ops.fft_ops")
PORTED = sorted(n for n in OP_INVENTORY if n in OPS)
# the collective names: no spec in either package (op_specs SKIPS them)
COLLECTIVES = {"all_gather", "all_reduce", "broadcast", "p_recv",
               "p_recv_array", "reduce", "reduce_scatter"}
SWEPT = sorted(n for n in PORTED if n in SPECS)
# the first six families' 149, linalg's 24, pool's 6, then A23b-2's 63
GRADED_COUNT = 179 + 63
GRADED = sorted(n for n in SWEPT if SPECS[n]["grad"])

# random ops: the port's generator cannot repeat the JAX key stream, so
# only the spec's check (shape, dtype, range) holds them, not the JAX op
RANDOM = {"bernoulli", "gaussian", "multinomial", "poisson", "randint",
          "randperm", "uniform", "uniform_inplace", "exponential_",
          "dirichlet", "truncated_gaussian_random", "gumbel_softmax",
          "class_center_sample"}

# ops whose outputs differ from the JAX op's only in integer width: int64
# in the port, int32 where the JAX package canonicalizes (x64 off)
INT_WIDTH_ONLY = {
    "arange", "argmax", "argmin", "argsort", "kthvalue", "mode", "nonzero",
    "numel", "searchsorted", "topk", "tril_indices", "triu_indices",
    "bincount", "histogram", "matrix_rank",
    "auc", "average_accumulates_", "coalesce", "edit_distance",
    "gather_tree", "matrix_rank_tol", "merge_selected_rows", "nms",
    "reindex_graph", "shard_index", "sparse_coo_tensor", "to_sparse_coo",
    "to_sparse_csr", "viterbi_decode", "weighted_sample_neighbors"}


# decompositions whose vectors LAPACK fixes only up to sign: the port's
# (U, S, Vh) is held to the JAX op's after each singular pair is turned to
# the JAX pair's sign (the spec's check holds the reconstruction as is)
SIGN_FREE = {"svd"}


def _align_svd(got, ref):
    u, s, vh = got
    signs = np.sign(np.sum(u * ref[0], axis=0))
    signs[signs == 0] = 1
    return [u * signs, s, vh * signs[:, None]]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU; the JAX ops eager, without the dispatch
    cache's per-signature compiles (a sweep sees each signature once or
    twice)."""
    paddle.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _seed(name):
    return (zlib.crc32(name.encode()) & 0x7FFFFFFF) or 1


def _port_wrap(args, grad_idx):
    """``op_sweep_harness._wrap`` for the port: numpy arrays (alone or in
    a list) become port Tensors, trainable at the ``grad_idx`` places."""
    def tensor(a, i):
        return paddle.to_tensor(np.asarray(a), stop_gradient=i not in grad_idx)

    out = []
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            out.append(tensor(a, i))
        elif isinstance(a, (list, tuple)) and a and all(
                isinstance(e, np.ndarray) for e in a):
            out.append([tensor(e, i) for e in a])
        else:
            out.append(a)
    return out


def _arrays(result):
    """Flatten an op output (Tensors, nested lists/tuples) to numpy."""
    if isinstance(result, (list, tuple)):
        return [a for r in result for a in _arrays(r)]
    if hasattr(result, "numpy"):
        return [np.asarray(result.numpy())]
    return []


def _is_float(a):
    return np.issubdtype(a.dtype, np.floating) or \
        np.issubdtype(a.dtype, np.complexfloating)


def test_ported_ops_are_the_five_families_and_functional():
    """Every inventory op the JAX package registers, from its op
    families and ``nn/functional.py``, is in the port's registry; the
    ones without a spec are the collectives and the ``EXTRA`` ops."""
    def family(name):
        od = JOPS[name]
        fn = od.jax_fn if od.jax_fn is not None else od.user_fn
        return fn.__module__

    want = sorted(n for n in OP_INVENTORY if family(n) in _FAMILIES)
    assert PORTED == want == sorted(OP_INVENTORY)
    assert len(PORTED) == 389 and len(GRADED) == GRADED_COUNT
    assert set(PORTED) - set(SWEPT) == COLLECTIVES | EXTRA_NO_SPEC


def test_inventory_partition_is_exact():
    """Every inventory name is registered in the port or waits, never
    both; none waits (389 of 389 registered)."""
    inv = set(OP_INVENTORY)
    waiting = [n for names in WAITING.values() for n in names]
    assert not set(waiting) & set(OPS)
    assert inv - set(OPS) == set(waiting) == set()
    assert WAITING == {} and len(inv) == 389


def test_registration_is_validated_against_the_schema():
    """As in the JAX registry: a first registration whose signature lacks
    a required argument of the reference schema is refused (``huber_loss``
    is taken out of the registry for the check and put back)."""
    saved = OPS.pop("huber_loss")
    try:
        with pytest.raises(OpSchemaError, match="huber_loss"):
            @op("huber_loss")
            def huber_loss(input):
                return input
        assert "huber_loss" not in OPS
    finally:
        OPS["huber_loss"] = saved


@pytest.mark.parametrize("name", SWEPT)
def test_op_forward(name):
    s = SPECS[name]
    args, kwargs = s["make"](np.random.RandomState(_seed(name)))
    got = OPS[name].user_fn(*_port_wrap(args, set()), **kwargs)
    if s["check"] is not None:
        s["check"](got, args, kwargs)
    else:
        np_args = [a for a in args if isinstance(a, np.ndarray)]
        expect = s["ref"](*np_args, **kwargs)
        want = _arrays(expect) if isinstance(expect, (list, tuple)) \
            else [np.asarray(expect)]
        gots = _arrays(got)
        assert len(gots) >= len(want)
        for g, w in zip(gots, want):
            if _is_float(np.asarray(w)):
                np.testing.assert_allclose(g, w, rtol=s["rtol"],
                                           atol=s["atol"], err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
    if name in RANDOM:
        return
    args, kwargs = s["make"](np.random.RandomState(_seed(name)))
    ref = _arrays(JOPS[name].user_fn(*_wrap(args, set()), **kwargs))
    gots = _arrays(got)
    assert len(gots) == len(ref), name
    if name in SIGN_FREE:
        gots = _align_svd(gots, ref)
    widths = False
    for g, r in zip(gots, ref):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        if _is_float(r):
            assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
            np.testing.assert_allclose(g, r, rtol=s["rtol"],
                                       atol=s["atol"], err_msg=name)
        else:
            if g.dtype != r.dtype:
                assert np.issubdtype(g.dtype, np.integer) and \
                    np.issubdtype(r.dtype, np.integer), (name, g.dtype)
                widths = True
            np.testing.assert_array_equal(g, r.astype(g.dtype),
                                          err_msg=name)
    assert widths == (name in INT_WIDTH_ONLY), (name, widths)


@pytest.mark.parametrize("name", GRADED)
def test_op_grad(name):
    """The port's gradient against the JAX tape's, the loss a weighted
    sum of the float outputs with the JAX sweep's weights (drawn as
    ``op_sweep_harness._make_weights`` draws them, from the port's
    outputs, which have the JAX op's shapes)."""
    s = SPECS[name]
    rng = np.random.RandomState(_seed(name) ^ 0xA5)
    args, kwargs = s["make"](rng)
    grad_idx = set(s["grad"])
    sel = s.get("grad_out") or (lambda r: r)

    pargs = _port_wrap(args, grad_idx)
    res = sel(OPS[name].user_fn(*pargs, **kwargs))
    parts, weights = [], []
    for r in (res if isinstance(res, (list, tuple)) else [res]):
        if not isinstance(r, paddle.Tensor):
            continue
        if r.dtype.is_complex:
            parts += [paddle.real(r), paddle.imag(r)]
            weights += [rng.uniform(0.5, 1.5, r.shape).astype(np.float32)
                        for _ in range(2)]
        elif r.dtype.is_floating_point:
            parts.append(r)
            weights.append(rng.uniform(0.5, 1.5, r.shape).astype(
                np.dtype(str(r.dtype).split(".")[1])))
    loss = None
    for r, w in zip(parts, weights):
        term = paddle.sum(r * paddle.to_tensor(w))
        loss = term if loss is None else loss + term
    loss.backward()

    jargs = _wrap(args, grad_idx)
    jloss, _ = _scalarize(sel(JOPS[name].user_fn(*jargs, **kwargs)),
                          weights)
    jloss.backward()

    for i in sorted(grad_idx):
        pairs = list(zip(pargs[i], jargs[i])) if isinstance(pargs[i], list) \
            else [(pargs[i], jargs[i])]
        for pt, jt in pairs:
            want = np.asarray(jt.grad.numpy())
            # an input with no differentiable path through the op gets
            # None from torch where the JAX tape deposits zeros
            got = np.zeros_like(want) if pt.grad is None \
                else np.asarray(pt.grad.numpy())
            if np.iscomplexobj(got):
                got = np.conj(got)
            scale = max(np.abs(want).max(), np.abs(got).max(), 1e-3)
            err = np.abs(got - want).max() / scale
            assert err < s["grad_rtol"], (name, i, err, got, want)


# ------------------------------------------- ops outside the inventory --
# the five families' other ops, each against the JAX op on one input
_X = np.random.RandomState(3).uniform(-1, 1, (3, 4)).astype(np.float32)
_Y = np.random.RandomState(4).uniform(-1, 1, (3, 4)).astype(np.float32)
_MASK = np.random.RandomState(5).randint(0, 2, (3, 4)).astype(bool)
EXTRA = [
    ("neg", (_X,), {}), ("frac", (_X * 3,), {}), ("hypot", (_X, _Y), {}),
    ("logaddexp", (_X, _Y), {}), ("copysign", (_X, _Y), {}),
    ("inner", (_X, _Y), {}), ("outer", (_X[0], _Y[0]), {}),
    ("rad2deg", (_X,), {}), ("deg2rad", (_X,), {}),
    ("nan_to_num", (np.array([np.nan, np.inf, -1.0], np.float32),), {}),
    ("nansum", (_X,), {"axis": 1}), ("nanmean", (_X,), {}),
    ("median", (_X,), {"axis": 1}), ("median", (_X,), {}),
    ("quantile", (_X, 0.3), {"axis": 0}), ("std", (_X,), {"axis": 1}),
    ("var", (_X,), {"unbiased": False}), ("cummax", (_X,), {"axis": 1}),
    ("cummin", (_X,), {}), ("diff", (_X,), {}),
    ("trapezoid", (_X,), {}), ("isneginf", (_X,), {}),
    ("polygamma", (np.abs(_X) + 0.5, 1), {}),
    ("mod", (_X * 3, np.float32(0.7)), {}), ("t", (_X,), {}),
    ("moveaxis", (_X, 0, 1), {}), ("chunk", (_X, 2), {"axis": 1}),
    ("rot90", (_X,), {}), ("broadcast_to", (_X[:1], [3, 4]), {}),
    ("masked_fill", (_X, _MASK, 2.0), {}),
    ("sort", (_X,), {"axis": 1, "descending": True}),
    ("bucketize", (_X, np.array([-0.5, 0.0, 0.5], np.float32)), {}),
    ("view_as", (_X, _Y.reshape(4, 3)), {}),
    ("diagonal_scatter", (np.zeros((3, 3), np.float32),
                          np.ones(3, np.float32)), {}),
    ("select_scatter", (_X, _Y[0], 0, 1), {}),
    ("tensordot", (_X, _Y.T), {"axes": 1}), ("atleast_3d", (_X,), {}),
    ("scatter_nd", (np.array([[1], [2]]), _Y[:2], [4, 4]), {}),
    ("diagflat", (_X[0],), {}), ("clone", (_X,), {}),
    ("bitwise_left_shift", (np.array([1, 2], np.int32),
                            np.array([2, 1], np.int32)), {}),
]


# the inventory ops with no spec that are not collectives, once each
_R = np.random.RandomState(6)


def _u(*shape):
    return _R.uniform(-1, 1, shape).astype(np.float32)


def _layer():
    """One pre-LN encoder layer's weights, C = 8, two heads of 4."""
    return [[_u(3, 2, 4, 8)], [_u(3, 2, 4)], [_u(8, 8)], [_u(8)],
            [_u(8, 16)], [_u(16)], [_u(16, 8)], [_u(8)],
            [_u(8) + 1.5], [_u(8)], [_u(8) + 1.5], [_u(8)]]


EXTRA_NO_SPEC = {"coalesce_tensor", "copy_to", "npu_identity",
                 "share_buffer", "add_act_xpu", "conv2d_xpu",
                 "embedding_with_eltwise_add_xpu", "fc_xpu",
                 "fused_multi_transformer_xpu", "generate_sequence_xpu",
                 "multi_encoder_xpu", "yolo_box_xpu"}
EXTRA += [
    ("coalesce_tensor", ([_X, _Y[:2]],), {}),
    ("coalesce_tensor", ([_X, _Y],), {"set_constant": True,
                                       "constant": 0.5}),
    ("copy_to", (_X,), {}), ("npu_identity", (_X,), {}),
    ("share_buffer", (_X, _Y), {}),
    ("add_act_xpu", (_X, _Y), {"act_type": "gelu"}),
    ("add_act_xpu", (_X, _Y), {}),
    ("conv2d_xpu", (_u(2, 3, 6, 6), _u(4, 3, 3, 3), _u(4)),
     {"paddings": (1, 1), "act_type": "relu"}),
    ("embedding_with_eltwise_add_xpu",
     ([np.array([[0, 2], [1, 3]]), np.array([[4, 0], [2, 2]])],
      [_u(5, 6), _u(6, 6)]), {}),
    ("fc_xpu", (_X, _u(4, 5), _u(5)), {"act_type": "tanh"}),
    ("multi_encoder_xpu", (_u(2, 4, 8), *_layer()), {"num_heads": 2}),
    ("fused_multi_transformer_xpu", (_u(1, 4, 8), *_layer()),
     {"num_heads": 2}),
    ("generate_sequence_xpu", (_X,), {"axis": 1}),
    ("yolo_box_xpu", (_u(2, 14, 3, 3), np.array([[96, 96], [64, 80]],
                                                 np.int32),
                      [10, 13, 16, 30], 2), {}),
]


@pytest.mark.parametrize("name,args,kwargs", EXTRA,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(EXTRA)])
def test_extra_op_forward(name, args, kwargs):
    got = _arrays(OPS[name].user_fn(*_port_wrap(args, set()), **kwargs))
    want = _arrays(JOPS[name].user_fn(*_wrap(args, set()), **kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ------------------------------------------------------------ random ops --
@pytest.mark.parametrize("draw", ["uniform", "normal", "randint",
                                  "randperm", "bernoulli", "multinomial",
                                  "poisson", "dropout"])
def test_random_ops_moments_range_and_seed(draw):
    """Shape, dtype, range and moments against the distribution (the
    JAX package's draws cannot be repeated), and one seed repeating."""
    n = 20000
    p = paddle.to_tensor(np.full((n,), 0.3, np.float32))
    fns = {
        "uniform": lambda: paddle.uniform([n], min=-2.0, max=2.0),
        "normal": lambda: paddle.normal(1.0, 2.0, [n]),
        "randint": lambda: paddle.randint(0, 7, [n]),
        "randperm": lambda: paddle.randperm(n),
        "bernoulli": lambda: paddle.bernoulli(p),
        "multinomial": lambda: paddle.multinomial(
            paddle.to_tensor(np.array([0.2, 0.3, 0.5], np.float32)), n,
            replacement=True),
        "poisson": lambda: paddle.poisson(p * 10),
        "dropout": lambda: paddle.nn.functional.dropout(
            paddle.ones([n]), p=0.25),
    }
    paddle.seed(7)
    a = fns[draw]().numpy()
    paddle.seed(7)
    b = fns[draw]().numpy()
    np.testing.assert_array_equal(a, b)
    jref = {"uniform": jpaddle.uniform([8], min=-2.0, max=2.0),
            "normal": jpaddle.normal(1.0, 2.0, [8]),
            "randint": jpaddle.randint(0, 7, [8])}.get(draw)
    if jref is not None:   # the same kind of dtype as the JAX draw
        assert a.dtype.kind == np.asarray(jref.numpy()).dtype.kind
    mean, std = float(a.mean()), float(a.std())
    tol = 4.0 / np.sqrt(n)
    want = {"uniform": (0.0, 4 / np.sqrt(12)), "normal": (1.0, 2.0),
            "randint": (3.0, np.sqrt(48 / 12)),
            "randperm": ((n - 1) / 2, np.sqrt((n * n - 1) / 12)),
            "bernoulli": (0.3, np.sqrt(0.21)),
            "multinomial": (1.3, np.sqrt(0.61)),
            "poisson": (3.0, np.sqrt(3.0)),
            "dropout": (1.0, np.sqrt(1 / 3))}[draw]
    assert abs(mean - want[0]) < tol * max(want[1], 1.0) * 2, (mean, want)
    assert abs(std - want[1]) < 0.05 * want[1], (std, want)
    lo, hi = {"uniform": (-2, 2), "randint": (0, 6), "randperm": (0, n - 1),
              "bernoulli": (0, 1), "multinomial": (0, 2),
              "dropout": (0, 4 / 3)}.get(draw, (-np.inf, np.inf))
    assert a.min() >= lo and a.max() <= hi + 1e-6
    if draw == "randperm":
        np.testing.assert_array_equal(np.sort(a), np.arange(n))
