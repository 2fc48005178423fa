"""The port's ProgramDesc exporter (``paddle_tpu_torch/static/
program_export.py``) held against the JAX package's.

Models (an MLP, pools, conv-bn-relu, a transposed conv, GPT, BERT and
Llama tiny configurations, ResNet-18 on 32 x 32 inputs and a
``to_static`` model with ``cond`` and ``while``) carry one set of
weights across the two packages and go both ways: the port's export
loads into the JAX importer and the JAX export into the port's, and
each gives the JAX model's outputs.  The counts of the fused and
structural reference ops equal those of the JAX export of the same
model.  The JAX exporter's grammar is held with torch spellings of its
reference bodies: folded literals, deferred broadcasts, declined
fusions, refusals by name, the dynamic-batch rules, a kernel op in the
trace, a bfloat16 variable.  Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu.static import program_export as jexp
from paddle_tpu.static import program_import as jimp
from paddle_tpu_torch import nn
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.static import program_export as pexp
from paddle_tpu_torch.static import program_import as pimp
from torch_ref_helpers import jax_forward, jax_twin

F32 = np.float32
COUNTED = ("softmax", "layer_norm", "gelu", "batch_norm", "conv2d",
           "conv2d_transpose", "pool2d", "clip", "expand_v2")


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _counts(ops):
    return {k: ops.count(k) for k in COUNTED}


def _both_ways(tmp_path, pm, jm, spec, feeds, tol):
    """Export ``pm`` (port) and ``jm`` (JAX, same weights) at ``spec``
    ``(shape, dtype)``; the port's artifact through the JAX importer and
    the JAX artifact through the port's must give ``jm``'s outputs
    within ``tol`` on every feed.  Returns the two op lists."""
    shape, dtype = spec
    pp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    pops = pexp.export_reference_inference_model(
        pp, [InputSpec(shape, dtype)], pm)
    jops = jexp.export_reference_inference_model(
        jp, [JSpec(shape, dtype)], jm)
    jprog, _, _ = jimp.load_reference_inference_model(pp)
    pprog, _, _ = pimp.load_reference_inference_model(jp)
    for x in feeds:
        want = jax_forward(jm, x)
        want = want[0] if isinstance(want, (tuple, list)) else want
        got_j = np.asarray(jprog(J.to_tensor(x))[0].numpy())
        got_p = pprog(P.to_tensor(x))[0].numpy()
        np.testing.assert_allclose(got_j, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got_p, want, rtol=tol, atol=tol)
    return pops, jops


def _layer_pair(port_ctor, jax_ctor):
    P.seed(0)
    pm = port_ctor()
    pm.eval()
    jm = jax_twin(jax_ctor, pm)
    jm.eval()
    return pm, jm


def _mlp(ns):
    return ns.Sequential(ns.Linear(4, 8), ns.ReLU(), ns.Linear(8, 3),
                         ns.Softmax())


def _pools(ns):
    return ns.Sequential(
        ns.Conv2D(2, 3, 3, padding=1), ns.ReLU(),
        ns.MaxPool2D(3, 2, padding=1),
        ns.AvgPool2D(3, 1, padding=1, ceil_mode=True, exclusive=True),
        ns.AvgPool2D(2, 2, exclusive=False),
        ns.AdaptiveAvgPool2D(2), ns.Flatten())


def _conv_bn(ns):
    return ns.Sequential(ns.Conv2D(1, 4, 3, padding=1), ns.BatchNorm2D(4),
                         ns.ReLU6(), ns.Flatten(), ns.Linear(4 * 4 * 4, 3))


def _deconv(ns):
    return ns.Sequential(ns.Conv2D(3, 4, 3, stride=2, padding=1), ns.ReLU(),
                         ns.Conv2DTranspose(4, 3, 3, stride=2, padding=1,
                                            output_padding=1))


LAYERS = {
    "mlp": (_mlp, ([None, 4], "float32"), [(2, 4), (7, 4)], 1e-5),
    "pools": (_pools, ([None, 2, 9, 9], "float32"), [(2, 2, 9, 9)], 1e-5),
    "conv_bn_relu6": (_conv_bn, ([None, 1, 4, 4], "float32"),
                      [(2, 1, 4, 4), (5, 1, 4, 4)], 1e-5),
    "conv_transpose": (_deconv, ([None, 3, 8, 8], "float32"),
                       [(1, 3, 8, 8), (2, 3, 8, 8)], 1e-5),
    # the four layers the exporter refused (ROADMAP C15): aten.var
    # (GroupNorm, InstanceNorm2D), aten.logaddexp (Mish) and
    # aten.log_sigmoid_forward (LogSigmoid)
    "group_norm": (lambda ns: ns.Sequential(ns.GroupNorm(2, 4)),
                   ([None, 4, 3, 3], "float32"),
                   [(2, 4, 3, 3), (5, 4, 3, 3)], 1e-5),
    "instance_norm": (lambda ns: ns.Sequential(ns.InstanceNorm2D(4)),
                      ([None, 4, 3, 3], "float32"),
                      [(2, 4, 3, 3), (5, 4, 3, 3)], 1e-5),
    "mish": (lambda ns: ns.Sequential(ns.Mish()), ([None, 6], "float32"),
             [(2, 6), (7, 6)], 1e-5),
    "log_sigmoid": (lambda ns: ns.Sequential(ns.LogSigmoid()),
                    ([None, 6], "float32"), [(2, 6), (7, 6)], 1e-5),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_go_both_ways_with_jax_op_counts(name, tmp_path):
    """Outputs within the stated tolerance of the JAX model both ways;
    the counted op types equal the JAX export's."""
    build, spec, shapes, tol = LAYERS[name]
    pm, jm = _layer_pair(lambda: build(nn), lambda: build(J.nn))
    rng = np.random.RandomState(1)
    feeds = [rng.randn(*s).astype(F32) for s in shapes]
    pops, jops = _both_ways(tmp_path, pm, jm, spec, feeds, tol)
    assert _counts(pops) == _counts(jops)
    assert pops[0] == "feed" and pops[-1] == "fetch"
    if name in ("mish", "log_sigmoid"):
        # logaddexp's equations, op for op
        assert sorted(pops) == sorted(jops)
    elif name in ("group_norm", "instance_norm"):
        # jnp.var's equations, but for its guard on n - ddof > 0: the
        # count is known at export and the port folds it (no
        # fill_constant / greater_than / where)
        assert set(pops) <= set(jops)
        assert {k: pops.count(k) for k in ("reduce_sum", "square",
                                           "rsqrt")} == \
            {k: jops.count(k) for k in ("reduce_sum", "square", "rsqrt")}


def test_gpt_tiny_both_ways(tmp_path):
    """``gpt_tiny(use_flash_attention=False)`` (the C13 keyword) with a
    dynamic batch: 2 softmax, 5 layer_norm, 2 gelu as in the JAX
    export; logits within 2e-4 both ways at batch 1 and 3."""
    from paddle_tpu.models.gpt import gpt_tiny as jgpt
    from paddle_tpu_torch.models.gpt import gpt_tiny

    kw = dict(num_layers=2, hidden_size=32, num_attention_heads=2,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, use_flash_attention=False)
    J.seed(0)
    jm = jgpt(**kw)
    jm.eval()
    pm = gpt_tiny(device="cpu", **kw)
    pm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    pm.eval()
    rng = np.random.RandomState(2)
    feeds = [rng.randint(0, 100, (b, 16)).astype(np.int32) for b in (1, 3)]
    pops, jops = _both_ways(tmp_path, pm, jm, ([None, 16], "int32"),
                            feeds, 2e-4)
    assert _counts(pops) == _counts(jops)
    assert (pops.count("softmax"), pops.count("layer_norm"),
            pops.count("gelu")) == (2, 5, 2)


def test_llama_tiny_both_ways(tmp_path):
    """RoPE/GQA/SwiGLU as slice/mul chains; outputs within 1e-4."""
    from paddle_tpu.models.llama import llama_tiny as jllama
    from paddle_tpu_torch.models.llama import llama_tiny

    J.seed(0)
    jm = jllama(num_layers=2)
    jm.eval()
    pm = llama_tiny(device="cpu", num_layers=2)
    pm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    pm.eval()
    ids = np.random.RandomState(3).randint(0, 100, (2, 16)).astype(np.int32)
    pops, jops = _both_ways(tmp_path, pm, jm, ([2, 16], "int32"), [ids],
                            1e-4)
    assert _counts(pops) == _counts(jops)
    assert "slice" in pops and "matmul_v2" in pops


def test_bert_tiny_both_ways(tmp_path):
    """Outputs within 1e-4.  The counts equal the JAX export's but for
    expand_v2: the JAX embedding gather wraps negative ids
    (``where(ids < 0, ids + n, ids)``) and, over the collapsed zeros of
    the default token types, forces two expansions torch's embedding
    does not spell; the port looks that constant row up once and
    broadcasts it."""
    from paddle_tpu.models.bert import bert_tiny as jbert
    from paddle_tpu_torch.models.bert import bert_tiny

    pm, jm = _layer_pair(bert_tiny, jbert)
    ids = np.random.RandomState(4).randint(0, 100, (2, 16)).astype(np.int32)
    pops, jops = _both_ways(tmp_path, pm, jm, ([2, 16], "int32"), [ids],
                            1e-4)
    want = _counts(jops)
    want["expand_v2"] -= 2
    assert _counts(pops) == want


def test_resnet18_both_ways(tmp_path):
    """ResNet-18 on 32 x 32 inputs with a dynamic batch: 20 conv2d, 20
    batch_norm, 2 pool2d as in the JAX export; within 1e-4."""
    from paddle_tpu.vision.models import resnet18 as jres
    from paddle_tpu_torch.vision.models import resnet18

    pm, jm = _layer_pair(lambda: resnet18(num_classes=10),
                         lambda: jres(num_classes=10))
    x = np.random.RandomState(5).randn(2, 3, 32, 32).astype(F32)
    pops, jops = _both_ways(tmp_path, pm, jm, ([None, 3, 32, 32],
                                               "float32"), [x], 1e-4)
    assert _counts(pops) == _counts(jops)
    assert _counts(pops)["conv2d"] == 20 and _counts(pops)["pool2d"] == 2


def _stepper(pkg):
    class Stepper(pkg.nn.Layer):
        def forward(self, x):
            i = pkg.to_tensor(np.int32(0))
            while i < 6:
                x = x * 2.0
                i = i + 1
            if pkg.mean(x) > 0:
                return x + 1.0
            return x - 1.0
    return Stepper()


def test_to_static_control_flow_both_ways(tmp_path):
    """dy2static ``while`` and ``if`` export as ``while`` and
    ``conditional_block`` + ``select_input`` sub-blocks in both
    packages; each artifact runs in the other importer to the eager
    value within 1e-6, both branches."""
    pm, jm = _stepper(P), _stepper(J)
    P.jit.to_static(pm)
    J.jit.to_static(jm)
    pp, jp = str(tmp_path / "p"), str(tmp_path / "j")
    pops = pexp.export_reference_inference_model(pp, [InputSpec([2, 3])],
                                                 pm)
    jops = jexp.export_reference_inference_model(jp, [JSpec([2, 3])], jm)
    for ops in (pops, jops):
        assert {"while", "conditional_block", "select_input"} <= set(ops)
    blocks = pimp.parse_program_blocks(open(pp + ".pdmodel", "rb").read())
    assert len(blocks) == len(jimp.parse_program_blocks(
        open(jp + ".pdmodel", "rb").read())) == 4
    jprog, _, _ = jimp.load_reference_inference_model(pp)
    pprog, _, _ = pimp.load_reference_inference_model(jp)
    for sign in (1.0, -1.0):
        x = np.full((2, 3), 0.25 * sign, F32)
        want = x * 64 + (1.0 if sign > 0 else -1.0)
        np.testing.assert_allclose(np.asarray(jprog(J.to_tensor(x))[0]
                                              .numpy()), want, rtol=1e-6)
        np.testing.assert_allclose(pprog(P.to_tensor(x))[0].numpy(), want,
                                   rtol=1e-6)


# ---- the grammar, with torch spellings of the JAX reference bodies


class _Fn(nn.Layer):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *xs):
        out = self.fn(*[x._data for x in xs])
        return P.to_tensor(out) if not isinstance(out, tuple) else out


def _roundtrip(tmp_path, fn, spec, *feeds, name="m"):
    prefix = str(tmp_path / name)
    ops = pexp.export_reference_inference_model(prefix, spec, _Fn(fn))
    prog, _, _ = P.static.load_inference_model(prefix)
    outs = [prog(*[P.to_tensor(f) for f in fs])[0].numpy() for fs in feeds]
    return prefix, ops, outs


def test_literals_fold_and_materialize_as_in_jax(tmp_path):
    """Scalars fold into scale/relu (no fill_constant); literal unary
    ops fold; a deferred literal reaching cumsum materializes at the
    traced shape; exact within 1e-6."""
    x = np.random.RandomState(6).randn(4, 3).astype(F32)
    _, ops, (out,) = _roundtrip(
        tmp_path, lambda d: torch.relu(d * 2.0 - 0.5),
        [InputSpec([None, 3])], (x,), name="a")
    assert "scale" in ops and "relu" in ops and "fill_constant" not in ops
    np.testing.assert_allclose(out, np.maximum(x * 2.0 - 0.5, 0), rtol=1e-6)
    _, ops, (out,) = _roundtrip(
        tmp_path, lambda d: d * torch.rsqrt(torch.tensor(16.0))
        + torch.sqrt(torch.tensor(4.0)), [InputSpec([None, 3])], (x,),
        name="b")
    assert "fill_constant" not in ops
    np.testing.assert_allclose(out, x * 0.25 + 2.0, rtol=1e-6)
    y = np.random.RandomState(7).randn(2, 5).astype(F32)
    _, ops, (out,) = _roundtrip(
        tmp_path, lambda d: torch.cumsum(torch.ones_like(d), 1) * d,
        [InputSpec([2, 5])], (y,), name="c")
    assert "fill_constant" in ops and "cumsum" in ops
    np.testing.assert_allclose(out, np.cumsum(np.ones_like(y), 1) * y,
                               rtol=1e-6)


def test_iota_cumsum_pad_and_big_int_literal_as_jax(tmp_path):
    """The two bodies held op for op to the JAX export of the same
    function: the arange folds to a constant, the int32 cumsum stays
    int32, and an integer above 2^24 rides in ``str_value`` exactly."""
    x = np.random.RandomState(8).randn(3, 4).astype(F32)

    def pos_mix(d):
        pos = torch.arange(d.shape[1], dtype=torch.float32)
        return torch.nn.functional.pad(torch.cumsum(d + pos, 1), (1, 2),
                                       value=0.5)

    def jpos_mix(d):
        pos = jnp.arange(d.shape[1], dtype=jnp.float32)
        return jnp.pad(jnp.cumsum(d + pos, axis=1), ((0, 0), (1, 2)),
                       constant_values=0.5)

    big = 16777217

    def int_count(d):
        c = torch.cumsum(torch.full_like(d.to(torch.int32), big), 1)
        return d + c.to(torch.float32)

    def jint_count(d):
        c = jnp.cumsum(jnp.full_like(d.astype(jnp.int32), big), axis=1)
        return d + c.astype(jnp.float32)

    class JFn(J.nn.Layer):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn

        def forward(self, x):
            return J.Tensor(self.fn(x._data))

    for i, (fn, jfn, shape) in enumerate(((pos_mix, jpos_mix, [3, 4]),
                                          (int_count, jint_count, [2, 3]))):
        prefix, ops, _ = _roundtrip(tmp_path, fn, [InputSpec(shape)],
                                    name=f"p{i}")
        jops = jexp.export_reference_inference_model(
            str(tmp_path / f"j{i}"), [JSpec(shape)], JFn(jfn))
        # op for op with its output's declared dtype and dims, the
        # layout-only reshape2 aside (JAX reshapes a constant before a
        # broadcast that torch leaves implicit)
        assert _typed_ops(prefix, pimp) == \
            _typed_ops(str(tmp_path / f"j{i}"), jimp)
        assert [o for o in ops if o != "reshape2"] == \
            [o for o in jops if o != "reshape2"]
    prog, _, _ = P.static.load_inference_model(str(tmp_path / "p0"))
    want = np.pad(np.cumsum(x + np.arange(4, dtype=F32), 1),
                  ((0, 0), (1, 2)), constant_values=0.5)
    np.testing.assert_allclose(prog(P.to_tensor(x))[0].numpy(), want,
                               rtol=1e-5, atol=1e-6)
    fc = [o for o in pimp.parse_program(open(str(tmp_path / "p1.pdmodel"),
                                             "rb").read())[0]
          if o.type == "fill_constant"][0]
    assert fc.attrs["str_value"] == str(big)
    prog, _, _ = P.static.load_inference_model(str(tmp_path / "p1"))
    np.testing.assert_array_equal(
        prog(P.to_tensor(np.zeros((2, 3), F32)))[0].numpy(),
        np.cumsum(np.full((2, 3), big, np.int64), 1).astype(F32))


def _typed_ops(prefix, imp):
    ops, vars_ = imp.parse_program(open(prefix + ".pdmodel", "rb").read())
    out = []
    for o in ops:
        if o.type in ("reshape2", "feed", "fetch"):
            continue
        name = (o.outputs.get("Out") or o.outputs.get("Y"))[0]
        v = vars_[name]
        out.append((o.type, np.dtype(v["dtype"]).name, v["shape"],
                    o.attrs.get("str_value")))
    return out


def test_broadcasts_defer_and_force_per_block(tmp_path):
    """An expansion with only elementwise consumers emits no expand_v2
    at a dynamic batch; a tied constant serializes once; a broadcast
    forced inside a cond branch re-emits in the main block; fully
    collapsed literal compares and selects defer (1e-5)."""
    mask = torch.tensor([1.0, 0.0, 1.0])
    x = np.random.RandomState(9).randn(5, 3).astype(F32)
    _, ops, (out,) = _roundtrip(
        tmp_path, lambda d: d * torch.broadcast_to(mask, d.shape),
        [InputSpec([None, 3])], (x,), name="m")
    assert "expand_v2" not in ops
    np.testing.assert_allclose(out, x * mask.numpy(), rtol=1e-6)

    w = torch.from_numpy(np.random.RandomState(10).randn(4, 4).astype(F32))
    prefix, _, (out,) = _roundtrip(
        tmp_path, lambda d: (d @ w) @ w, [InputSpec([None, 4])],
        (x[:2, :1].repeat(4, 1),), name="t")
    import os
    assert os.path.getsize(prefix + ".pdiparams") < 150

    base = torch.tensor([1.0, 2.0, 3.0])

    def cross_block(d):
        m = torch.broadcast_to(base, (4, 3))
        picked = P.static.nn.cond(P.to_tensor(d.sum() > 0),
                                  lambda: m.t().sum(),
                                  lambda: torch.zeros(()))
        picked = getattr(picked, "_data", picked)
        return m.t().sum(1) + picked + d

    for sign in (1.0, -1.0):
        xv = np.full((4, 3), 0.1 * sign, F32)
        _, _, (out,) = _roundtrip(tmp_path, cross_block,
                                  [InputSpec([4, 3])], (xv,),
                                  name=f"x{int(sign)}")
        mb = np.broadcast_to(base.numpy(), (4, 3))
        want = mb.T.sum(1) + (mb.T.sum() if sign > 0 else 0.0) + xv
        np.testing.assert_allclose(out, want, rtol=1e-5)

    def token_typish(d):
        z = torch.zeros(d.shape, dtype=torch.int32)
        t = torch.where(z < 0, z + 2, z)
        return d + t.reshape(t.shape + (1,)).reshape(t.shape).float()

    y = np.random.RandomState(11).randn(2, 5).astype(F32)
    _, _, (out,) = _roundtrip(tmp_path, token_typish, [InputSpec([2, 5])],
                              (y,), name="tt")
    np.testing.assert_allclose(out, y, rtol=1e-6)


def test_compositions_fuse_and_decline_as_in_jax(tmp_path):
    """erfc that is not gelu's stays unfused; a LayerNorm whose mean or
    whose mean's sum escapes the chain declines, a plain one fuses; a
    flipped-kernel conv fuses to conv2d_transpose (each within 1e-5)."""
    from scipy.special import erfc

    x = np.random.RandomState(12).randn(3, 4).astype(F32)
    _, ops, (out,) = _roundtrip(
        tmp_path, lambda d: (0.5 * d) * torch.erfc(d * 0.5),
        [InputSpec([3, 4])], (x,), name="e")
    assert "gelu" not in ops
    np.testing.assert_allclose(out, 0.5 * x * erfc(x * 0.5), rtol=1e-5,
                               atol=1e-6)
    g = torch.full((4,), 2.0)
    b = torch.zeros(4)

    def norm_plus_mean(d):
        mu = d.mean(-1, keepdim=True)
        var = torch.square(d - mu).mean(-1, keepdim=True)
        return (d - mu) * torch.rsqrt(var + 1e-5) * g + b + mu

    def shared_sum(d):
        s = d.sum(-1)
        mu = s.reshape(3, 1) / 4.0
        var = torch.square(d - mu).mean(-1, keepdim=True)
        return (d - mu) * torch.rsqrt(var + 1e-5) * g + b + s.reshape(3, 1)

    mu = x.mean(-1, keepdims=True)
    var = np.square(x - mu).mean(-1, keepdims=True)
    normed = (x - mu) / np.sqrt(var + 1e-5) * 2.0
    for fn, want, tag in ((norm_plus_mean, normed + mu, "n"),
                          (shared_sum, normed + x.sum(-1, keepdims=True),
                           "s")):
        _, ops, (out,) = _roundtrip(tmp_path, fn, [InputSpec([3, 4])], (x,),
                                    name=tag)
        assert "layer_norm" not in ops
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)

    def plain_norm(d):
        mu = d.mean(-1, keepdim=True)
        var = ((d - mu) ** 2).mean(-1, keepdim=True)
        return (d - mu) * torch.rsqrt(var + 1e-5) * g + b

    _, ops, (out,) = _roundtrip(tmp_path, plain_norm, [InputSpec([3, 4])],
                                (x,), name="ln")
    assert ops.count("layer_norm") == 1 and "rsqrt" not in ops
    np.testing.assert_allclose(out, normed, rtol=1e-5, atol=1e-5)

    # a stride-1 transposed conv spelled as a conv over the flipped,
    # transposed filter fuses to one conv2d_transpose (JAX's rev rule)
    w = torch.from_numpy(np.random.RandomState(16).randn(3, 2, 3, 3)
                         .astype(F32))

    def flipped(d):
        return torch.nn.functional.conv2d(
            d, w.flip([2, 3]).transpose(0, 1), padding=1)

    z = np.random.RandomState(17).randn(2, 3, 5, 5).astype(F32)
    _, ops, (out,) = _roundtrip(tmp_path, flipped, [InputSpec([None, 3, 5,
                                                               5])],
                                (z,), name="ct")
    assert ops.count("conv2d_transpose") == 1 and "conv2d" not in ops
    np.testing.assert_allclose(out, flipped(torch.from_numpy(z)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_remainder_split_and_while_round_trip(tmp_path):
    """fmod exports as the exact truncated composition; a split exports
    as ``split``; ``static.nn.while_loop`` as ``while`` (1e-6)."""
    x = np.repeat(np.array([[-7.0, 7.0, -2.5, 2.5]], F32), 2, 0)
    _, _, (out,) = _roundtrip(tmp_path, lambda d: torch.fmod(d, 3.0),
                              [InputSpec([None, 4])], (x,), name="r")
    np.testing.assert_allclose(out, np.fmod(x, 3.0), rtol=1e-6, atol=1e-6)
    y = np.random.RandomState(13).randn(4, 6).astype(F32)

    def qkvish(d):
        a, b, c = torch.split(d, 2, dim=1)
        return a * 2 + b - c

    _, ops, (out,) = _roundtrip(tmp_path, qkvish, [InputSpec([None, 6])],
                                (y,), name="s")
    assert "split" in ops
    a, b, c = np.split(y, 3, 1)
    np.testing.assert_allclose(out, a * 2 + b - c, rtol=1e-6)

    def doubler(d):
        i0 = torch.zeros((), dtype=torch.int32)
        _, out = P.static.nn.while_loop(lambda i, v: i < 5,
                                        lambda i, v: (i + 1, v * 2.0),
                                        [i0, d])
        return getattr(out, "_data", out)

    z = np.random.RandomState(14).randn(2, 3).astype(F32)
    _, ops, (out,) = _roundtrip(tmp_path, doubler, [InputSpec([2, 3])],
                                (z,), name="w")
    assert "while" in ops
    np.testing.assert_allclose(out, z * 32, rtol=1e-6)


def test_refusals_name_what_they_refuse(tmp_path):
    """Each refusal raises NotImplementedError (ValueError for no
    InputSpec) naming its cause, as the JAX exporter's do."""
    def export(fn, spec, tag):
        return pexp.export_reference_inference_model(
            str(tmp_path / tag), spec, _Fn(fn))

    with pytest.raises(NotImplementedError, match="sort"):
        export(lambda d: torch.sort(d, -1)[0], [InputSpec([None, 4])], "so")
    with pytest.raises(ValueError, match="InputSpec"):
        pexp.export_reference_inference_model(str(tmp_path / "no"), [],
                                              nn.Linear(2, 2))
    with pytest.raises(NotImplementedError, match="bitwise"):
        export(lambda d: d & 0xFF, [InputSpec([None, 4], "int32")], "bi")
    with pytest.raises(NotImplementedError, match="batch"):
        export(lambda d: torch.split(d, [1, d.shape[0] - 1], 0)[0].sum()
               + torch.split(d, [1, d.shape[0] - 1], 0)[1].sum(),
               [InputSpec([None, 3])], "sb")
    with pytest.raises(NotImplementedError, match="placeholder"):
        export(lambda d: d * 2.0, [InputSpec([None, pexp._BATCH])], "pb")
    lin = nn.Linear(4, 2)
    lin.to(dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        pexp.export_reference_inference_model(
            str(tmp_path / "bf"), [InputSpec([None, 4], "bfloat16")], lin)


def test_kernel_op_in_the_trace_refuses(tmp_path):
    """A ``paddle_tpu_torch::`` kernel op (called directly, on the CPU)
    refuses with the JAX ``pallas_call`` message, the kernel named."""
    import paddle_tpu_torch.ops.cuda.layernorm_kernel  # noqa: F401

    w, b = torch.ones(8), torch.zeros(8)

    def ln(d):
        return torch.ops.paddle_tpu_torch.layernorm_fwd(
            d.reshape(-1, 8), w, b, 1e-5)[0].reshape(d.shape)

    with pytest.raises(NotImplementedError,
                       match="kernel paddle_tpu_torch::layernorm_fwd"):
        pexp.export_reference_inference_model(
            str(tmp_path / "k"), [InputSpec([None, 8])], _Fn(ln))


@pytest.mark.parametrize("name", ["relu6", "adaptive_avg_pool2d"])
def test_compositions_export_as_the_jax_ops(name, tmp_path):
    """The port's ``relu6`` (a ``where`` over a clamp) and its tiling
    adaptive average pool (a window sum) export the JAX export's op
    list; outputs within 1e-6 both ways."""
    build, spec, shape = {
        "relu6": (lambda ns: ns.ReLU6(), ([None, 4], "float32"), (5, 4)),
        "adaptive_avg_pool2d": (lambda ns: ns.AdaptiveAvgPool2D(2),
                                ([None, 3, 4, 6], "float32"),
                                (2, 3, 4, 6))}[name]
    pm, jm = _layer_pair(lambda: build(nn), lambda: build(J.nn))
    feed = np.random.RandomState(16).randn(*shape).astype(F32) * 4
    pops, jops = _both_ways(tmp_path, pm, jm, spec, [feed], 1e-6)
    assert pops == jops


def test_pool_routing_holds_only_in_its_own_context():
    """``pool_ops.routed_windows`` (what the exporter's trace sets)
    routes ``window_reduce`` in its own context only: another thread
    computes the plain reduction meanwhile."""
    import threading

    from paddle_tpu_torch.ops import pool_ops

    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    args = ([2, 3], [2, 2], [2, 2], [(0, 0), (0, 0)], "max")
    want = torch.tensor([[[[5.0, 7.0], [13.0, 15.0]]]])
    inside, leave = threading.Event(), threading.Event()
    seen = {}

    def exporter():
        with pool_ops.routed_windows(lambda *a: "routed"):
            seen["routed"] = pool_ops.window_reduce(x, *args)
            inside.set()
            leave.wait(30)

    t = threading.Thread(target=exporter)
    t.start()
    try:
        assert inside.wait(30)
        assert torch.equal(pool_ops.window_reduce(x, *args), want)
    finally:
        leave.set()
        t.join()
    assert seen["routed"] == "routed"
    assert torch.equal(pool_ops.window_reduce(x, *args), want)


def test_export_leaves_the_generators_as_they_were(tmp_path):
    from paddle_tpu_torch.framework import random as prandom

    P.seed(3)
    model = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.5))
    model.eval()
    g = prandom.generator("cpu")
    before = g.get_state().clone()
    pexp.export_reference_inference_model(str(tmp_path / "g"),
                                          [InputSpec([None, 4])], model)
    assert torch.equal(g.get_state(), before)


def test_save_inference_model_writes_the_reference_format(tmp_path):
    """``save_inference_model`` with InputSpec feeds writes the 0x0a
    ProgramDesc; with no feeds the jit.save pickle; ``load_inference_
    model`` routes on the first byte."""
    P.seed(0)
    model = nn.Sequential(nn.Linear(4, 2))
    model.eval()
    ref, native = str(tmp_path / "ref"), str(tmp_path / "native")
    P.static.save_inference_model(ref, [InputSpec([None, 4])], model)
    P.static.save_inference_model(native, [], model)
    assert open(ref + ".pdmodel", "rb").read(1) == b"\x0a"
    assert open(native + ".pdmodel", "rb").read(1) != b"\x0a"
    prog, feeds, fetches = P.static.load_inference_model(ref)
    assert isinstance(prog, pimp.InferenceProgram) and feeds == ["x0"]
    x = np.random.RandomState(15).randn(3, 4).astype(F32)
    np.testing.assert_allclose(prog(P.to_tensor(x))[0].numpy(),
                               model(P.to_tensor(x)).numpy(), rtol=1e-5)
    for name in ("program_guard", "data", "Program"):
        with pytest.raises(NotImplementedError, match="intentionally"):
            getattr(P.static, name)()
