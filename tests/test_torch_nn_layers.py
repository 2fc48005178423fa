"""The port's ``nn`` layers against the JAX package's.

Each layer is built in both packages; the JAX layer's ``state_dict``
(as numpy) is loaded into the port's with ``set_state_dict`` — the two
key lists must be equal, in order — and the same inputs go through
both.  Outputs, input gradients and parameter gradients of the loss
``sum(out * w)`` (``w`` seeded) must agree at 1e-5.
"""

import collections
import copy

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.ops.dispatch import enable_dispatch_cache

import paddle_tpu_torch as P

RNG = np.random.RandomState(11)
X4 = RNG.uniform(-1, 1, (2, 6, 4, 4)).astype(np.float32)
X2 = RNG.uniform(-1, 1, (4, 8)).astype(np.float32)
X3 = RNG.uniform(-1, 1, (2, 5, 16)).astype(np.float32)
Y2 = RNG.uniform(-1, 1, (4, 8)).astype(np.float32)
IDS = RNG.randint(0, 10, (3, 5))
LBL = RNG.randint(0, 8, (4,))
PROB = 1 / (1 + np.exp(-X2))
MASK = np.where(RNG.rand(2, 1, 5, 5) < 0.3, -1e4, 0.0).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port on the CPU; the JAX layers eager, without the dispatch
    cache's compiles (each call signature is seen once or twice)."""
    P.set_device("cpu")
    enable_dispatch_cache(False)
    yield
    enable_dispatch_cache(True)


def _acts():
    names = ["CELU", "ELU", "GELU", "Hardshrink", "Hardsigmoid", "Hardswish",
             "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout",
             "Mish", "PReLU", "ReLU", "ReLU6", "SELU", "Sigmoid", "SiLU",
             "Silu", "Softmax", "Softplus", "Softshrink", "Softsign",
             "Swish", "Tanh", "Tanhshrink"]
    return [(n, (lambda p, n=n: getattr(p.nn, n)()), (X4,), ())
            for n in names]


# name, ctor(p), float inputs (grad-checked), other inputs
CASES = _acts() + [
    ("Linear", lambda p: p.nn.Linear(8, 5), (X2,), ()),
    ("Linear_nobias", lambda p: p.nn.Linear(8, 5, bias_attr=False), (X2,),
     ()),
    ("Embedding", lambda p: p.nn.Embedding(10, 4, padding_idx=0), (),
     (IDS,)),
    ("Identity", lambda p: p.nn.Identity(), (X2,), ()),
    ("Flatten", lambda p: p.nn.Flatten(), (X4,), ()),
    ("Pad2D", lambda p: p.nn.Pad2D([1, 0, 2, 1]), (X4,), ()),
    ("PixelShuffle", lambda p: p.nn.PixelShuffle(1), (X4,), ()),
    ("Bilinear", lambda p: p.nn.Bilinear(8, 8, 3), (X2, Y2), ()),
    ("CosineSimilarity", lambda p: p.nn.CosineSimilarity(axis=1), (X2, Y2),
     ()),
    ("Dropout_eval", lambda p: p.nn.Dropout(0.5).eval(), (X2,), ()),
    ("Dropout_p0", lambda p: p.nn.Dropout(0.0), (X2,), ()),
    ("Dropout2D_eval", lambda p: p.nn.Dropout2D(0.5).eval(), (X4,), ()),
    ("Pad1D", lambda p: p.nn.Pad1D([2, 1]), (X3,), ()),
    ("LayerNorm", lambda p: p.nn.LayerNorm(8, epsilon=1e-12), (X2,), ()),
    ("LayerNorm_2d", lambda p: p.nn.LayerNorm([4, 4]), (X4,), ()),
    ("Sequential", lambda p: p.nn.Sequential(
        p.nn.Linear(8, 6), p.nn.ReLU(), p.nn.Linear(6, 3)), (X2,), ()),
    ("MSELoss", lambda p: p.nn.MSELoss(), (X2, Y2), ()),
    ("L1Loss", lambda p: p.nn.L1Loss(), (X2, Y2), ()),
    ("SmoothL1Loss", lambda p: p.nn.SmoothL1Loss(), (X2, Y2), ()),
    ("KLDivLoss", lambda p: p.nn.KLDivLoss(), (X2,), (PROB,)),
    ("BCELoss", lambda p: p.nn.BCELoss(), (PROB.astype(np.float32),),
     ((Y2 > 0).astype(np.float32),)),
    ("BCEWithLogitsLoss", lambda p: p.nn.BCEWithLogitsLoss(), (X2,),
     ((Y2 > 0).astype(np.float32),)),
    ("MarginRankingLoss", lambda p: p.nn.MarginRankingLoss(0.1), (X2, Y2),
     (np.sign(Y2).astype(np.float32),)),
    ("CrossEntropyLoss", lambda p: p.nn.CrossEntropyLoss(), (X2,), (LBL,)),
    ("NLLLoss", lambda p: p.nn.NLLLoss(), (np.log(PROB / PROB.sum(
        -1, keepdims=True)).astype(np.float32),), (LBL,)),
    ("MultiHeadAttention", lambda p: p.nn.MultiHeadAttention(16, 4), (X3,),
     ()),
    ("TransformerEncoderLayer_post", lambda p: p.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, activation="gelu"), (X3,), ()),
    ("TransformerEncoderLayer_pre", lambda p: p.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, normalize_before=True), (X3,), ()),
    ("TransformerEncoder", lambda p: p.nn.TransformerEncoder(
        p.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0), 2,
        p.nn.LayerNorm(16)), (X3,), ()),
    ("TransformerDecoder", lambda p: p.nn.TransformerDecoder(
        p.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0), 2), (X3, X3),
     ()),
    ("Transformer", lambda p: p.nn.Transformer(
        16, 4, 1, 1, 32, dropout=0.0), (X3, X3), ()),
]


def _build(p, ctor):
    p.seed(0)
    return ctor(p)


def _run(p, layer, floats, others, w_seed=5):
    ins = [p.to_tensor(a, stop_gradient=False) for a in floats]
    ins += [p.to_tensor(a) for a in others]
    out = layer(*ins)
    w = np.random.RandomState(w_seed).uniform(
        0.5, 1.5, out.shape).astype(np.float32)
    (out * p.to_tensor(w)).sum().backward()
    return out, ins


@pytest.mark.parametrize("name,ctor,floats,others", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_reference(name, ctor, floats, others):
    jl, pl = _build(J, ctor), _build(P, ctor)
    jsd, psd = jl.state_dict(), pl.state_dict()
    assert list(jsd) == list(psd)
    missing, unexpected = pl.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jsd.items()})
    assert missing == [] and unexpected == []
    jout, jins = _run(J, jl, floats, others)
    pout, pins = _run(P, pl, floats, others)
    np.testing.assert_allclose(np.asarray(jout.numpy()), pout.numpy(),
                               err_msg=name, **TOL)
    for ji, pi in zip(jins[:len(floats)], pins):
        np.testing.assert_allclose(np.asarray(ji.grad.numpy()),
                                   pi.grad.numpy(), err_msg=name, **TOL)
    pgrads = dict(pl.named_parameters())
    for n, jp in jl.named_parameters():
        if jp.grad is None:
            assert pgrads[n].grad is None, n
            continue
        np.testing.assert_allclose(np.asarray(jp.grad.numpy()),
                                   pgrads[n].grad.numpy(),
                                   err_msg=f"{name}.{n}", **TOL)


def test_attention_mask_and_cache_match_reference():
    """An additive mask (the plain route) and the incremental cache of
    MultiHeadAttention, against the JAX layer."""
    outs = []
    for p in (J, P):
        layer = _build(p, lambda p: p.nn.MultiHeadAttention(16, 4))
        if p is P:
            layer.set_state_dict({k: np.asarray(v.numpy())
                                  for k, v in jl_sd.items()})
        else:
            jl_sd = layer.state_dict()
        x = p.to_tensor(X3)
        masked = layer(x, attn_mask=p.to_tensor(MASK))
        cache = layer.gen_cache(x)
        step, cache = layer(x[:, :2], cache=cache)
        step2, cache = layer(x[:, 2:3], cache=cache)
        outs.append([masked, step, step2, cache.k])
    for j, q in zip(*outs):
        np.testing.assert_allclose(np.asarray(j.numpy()), q.numpy(), **TOL)


def test_layer_api_matches_reference():
    """Traversal, buffers, hooks, train/eval, deep copies and ``to``."""
    keys = []
    for p in (J, P):
        net = _build(p, lambda p: p.nn.Sequential([
            ("fc", p.nn.Linear(8, 4)), ("act", p.nn.GELU()),
            ("norm", p.nn.LayerNorm(4))]))
        net.register_buffer("steps", p.to_tensor(np.zeros(2, np.float32)))
        net.register_buffer("scratch", p.to_tensor(np.ones(1, np.float32)),
                            persistable=False)
        calls = []
        h = net.register_forward_post_hook(
            lambda layer, inp, out: calls.append(out.shape))
        net(p.to_tensor(X2))
        h.remove()
        net(p.to_tensor(X2))
        net.eval()
        assert not net.fc.training and calls == [[4, 4]]
        keys.append((list(net.state_dict()),
                     [n for n, _ in net.named_sublayers()],
                     [n for n, _ in net.named_buffers()],
                     len(net.parameters())))
    assert keys[0] == keys[1]
    net = P.nn.LayerList([P.nn.Linear(2, 2)])
    net.append(P.nn.Linear(2, 3))
    assert len(net) == 2 and net[1].weight.shape == [2, 3]
    d = P.nn.LayerDict({"a": P.nn.ReLU()})
    assert "a" in d and list(d.keys()) == ["a"]
    pl = P.nn.ParameterList([P.nn.Linear(2, 2).weight])
    assert len(pl.parameters()) == 1
    lin = P.nn.Linear(3, 3)
    lin.to(dtype="float64")
    assert str(lin.weight.dtype) == "torch.float64"
    assert lin.weight.is_leaf and not lin.weight.stop_gradient
    twin = copy.deepcopy(lin)
    assert twin.weight is not lin.weight and twin.weight.is_leaf
    assert not twin.weight.stop_gradient and twin.weight.persistable
    np.testing.assert_array_equal(twin.weight.numpy(), lin.weight.numpy())
    twin.weight.set_value(np.zeros((3, 3)))
    assert lin.weight.numpy().any()
    with pytest.raises(NotImplementedError, match="A23b"):
        P.nn.Upsample(scale_factor=2)


def test_state_dict_orders_match_for_shared_and_nested():
    sd = collections.OrderedDict()
    for p in (J, P):
        enc = _build(p, lambda p: p.nn.TransformerEncoder(
            p.nn.TransformerEncoderLayer(16, 4, 32), 3))
        sd[p.__name__] = list(enc.state_dict())
    assert sd["paddle_tpu"] == sd["paddle_tpu_torch"]
    assert len(sd["paddle_tpu_torch"]) == 3 * 16
