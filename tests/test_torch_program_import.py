"""The port's ProgramDesc importer (``paddle_tpu_torch/static/
program_import.py``) held against the JAX package's.

The same artifacts load into both importers and give the same outputs:
programs the reference tests' own wire encoder builds
(``tests/test_program_import.py``), covering the op table, control flow
and the detection ops, and programs the JAX exporter writes.  Also: the
gradients of ``to_layer()`` against ``jax.grad`` of the JAX program, the
``while`` gradient refusal of both, a bfloat16 parameter (VarType 22)
read equal to the JAX reader's, and the program runs as one trace per
signature (never op by op).  Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as J
import paddle_tpu_torch as P
import test_program_import as T
from paddle_tpu.static import program_import as jimp
from paddle_tpu_torch.static import program_import as pimp

F32 = np.float32
T.paddle = J   # the encoder module's own helpers never touch it


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


def _load_both(prefix):
    jprog, jfeeds, jfetches = jimp.load_reference_inference_model(prefix)
    pprog, pfeeds, pfetches = pimp.load_reference_inference_model(prefix)
    assert (pfeeds, pfetches) == (jfeeds, jfetches)
    return jprog, pprog


def _run_both(prefix, *feeds):
    jprog, pprog = _load_both(prefix)
    jout = [np.asarray(o.numpy()) for o in jprog(*feeds)]
    pout = [np.asarray(o.numpy()) for o in pprog(*feeds)]
    assert len(jout) == len(pout)
    return jout, pout


# ---- programs of the reference tests' encoder, one per op family


def _mlp(tmp_path, rng):
    w = rng.randn(4, 3).astype(F32)
    b = rng.randn(3).astype(F32)
    feeds, fetches = T.feed_fetch(["x"], ["out"])
    ops = feeds + [
        T.op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["h0"]},
             [T.attr("x_num_col_dims", 0, i=1),
              T.attr("y_num_col_dims", 0, i=1)]),
        T.op("elementwise_add", {"X": ["h0"], "Y": ["b"]},
             {"Out": ["h1"]}, [T.attr("axis", 0, i=-1)]),
        T.op("gelu", {"X": ["h1"]}, {"Out": ["h2"]}),
        T.op("layer_norm", {"X": ["h2"]}, {"Y": ["h3"]},
             [T.attr("begin_norm_axis", 0, i=1)]),
        T.op("softmax", {"X": ["h3"]}, {"Out": ["out"]},
             [T.attr("axis", 0, i=-1)]),
    ] + fetches
    vars_ = [T.var("x", [-1, 4]), T.var("w", [4, 3], persistable=True),
             T.var("b", [3], persistable=True)]
    return T.write_model(tmp_path, "mlp", ops, vars_, {"w": w, "b": b}), \
        [rng.randn(5, 4).astype(F32)]


def _cnn(tmp_path, rng):
    w = rng.randn(2, 1, 3, 3).astype(F32)
    stats = {k: (rng.rand(2) + 0.5).astype(F32)
             for k in ("bns", "bnv")}
    stats.update({k: rng.randn(2).astype(F32) for k in ("bnb", "bnm")})
    feeds, fetches = T.feed_fetch(["x"], ["out"])
    ops = feeds + [
        T.op("conv2d", {"Input": ["x"], "Filter": ["cw"]},
             {"Output": ["c"]},
             [T.attr("strides", 3, ints=[1, 1]),
              T.attr("paddings", 3, ints=[1, 0, 1, 0]),
              T.attr("dilations", 3, ints=[1, 1]),
              T.attr("groups", 0, i=1)]),
        T.op("batch_norm", {"X": ["c"], "Scale": ["bns"], "Bias": ["bnb"],
                            "Mean": ["bnm"], "Variance": ["bnv"]},
             {"Y": ["n"]}, [T.attr("epsilon", 1, f=1e-5)]),
        T.op("relu6", {"X": ["n"]}, {"Out": ["r"]}),
        T.op("pool2d", {"X": ["r"]}, {"Out": ["p"]},
             [T.attr("pooling_type", 2, s="avg"),
              T.attr("ksize", 3, ints=[2, 2]),
              T.attr("strides", 3, ints=[2, 2]),
              T.attr("paddings", 3, ints=[1, 1]),
              T.attr("ceil_mode", 6, b=True),
              T.attr("exclusive", 6, b=True)]),
        T.op("flatten_contiguous_range", {"X": ["p"]}, {"Out": ["out"]},
             [T.attr("start_axis", 0, i=1), T.attr("stop_axis", 0, i=-1)]),
    ] + fetches
    vars_ = [T.var("x", [-1, 1, 5, 5]),
             T.var("cw", [2, 1, 3, 3], persistable=True)] + \
        [T.var(k, [2], persistable=True) for k in stats]
    return T.write_model(tmp_path, "cnn", ops, vars_, {"cw": w, **stats}), \
        [rng.randn(2, 1, 5, 5).astype(F32)]


def _shapes(tmp_path, rng):
    feeds, fetches = T.feed_fetch(["x"], ["a", "idx", "s", "c"])
    ops = feeds + [
        T.op("split", {"X": ["x"]}, {"Out": ["s0", "s1"]},
             [T.attr("axis", 0, i=1), T.attr("sections", 3, ints=[2, -1])]),
        T.op("elementwise_max", {"X": ["s0"], "Y": ["s1"]},
             {"Out": ["m"]}, [T.attr("axis", 0, i=-1)]),
        T.op("top_k_v2", {"X": ["m"]}, {"Out": ["a"], "Indices": ["idx"]},
             [T.attr("k", 0, i=2), T.attr("axis", 0, i=-1)]),
        T.op("unsqueeze2", {"X": ["m"]}, {"Out": ["u"]},
             [T.attr("axes", 3, ints=[0, 3])]),
        T.op("tile", {"X": ["u"]}, {"Out": ["t"]},
             [T.attr("repeat_times", 3, ints=[2, 1, 1, 2])]),
        T.op("reduce_prod", {"X": ["t"]}, {"Out": ["s"]},
             [T.attr("dim", 3, ints=[0, 3])]),
        T.op("cumsum", {"X": ["m"]}, {"Out": ["c0"]},
             [T.attr("axis", 0, i=1), T.attr("exclusive", 6, b=True),
              T.attr("reverse", 6, b=True)]),
        T.op("round", {"X": ["c0"]}, {"Out": ["c"]}),
    ] + fetches
    x = rng.randn(3, 4).astype(F32)
    x[0, :2] = x[0, 2:]           # ties in top_k
    return T.write_model(tmp_path, "shapes", ops, [T.var("x", [-1, 4])],
                         {}), [x]


def _cond(tmp_path, rng):
    return T.TestControlFlow()._cond_program(tmp_path), \
        [np.full((2, 3), -1.5, F32)]


def _cond_pos(tmp_path, rng):
    return T.TestControlFlow()._cond_program(tmp_path), \
        [np.full((2, 3), 1.5, F32)]


def _while(tmp_path, rng):
    feeds, fetches = T.feed_fetch(["x"], ["xo"])
    b0 = feeds + [
        T.op("fill_constant", {}, {"Out": ["i"]},
             [T.attr("shape", 11, longs=[1]), T.attr("value", 1, f=0.0),
              T.attr("dtype", 0, i=5)]),
        T.op("fill_constant", {}, {"Out": ["five"]},
             [T.attr("shape", 11, longs=[1]), T.attr("value", 1, f=5.0),
              T.attr("dtype", 0, i=5)]),
        T.op("less_than", {"X": ["i"], "Y": ["five"]},
             {"Out": ["cond"]}, [T.attr("axis", 0, i=-1)]),
        T.op("while", {"X": ["x", "i"], "Condition": ["cond"]},
             {"Out": ["x", "i"], "StepScopes": ["_ss"]},
             [T.attr_block("sub_block", 1)]),
        T.op("assign", {"X": ["x"]}, {"Out": ["xo"]}),
    ] + fetches
    sub = [
        T.op("scale", {"X": ["x"]}, {"Out": ["x"]},
             [T.attr("scale", 1, f=2.0), T.attr("bias", 1, f=0.0),
              T.attr("bias_after_scale", 6, b=True)]),
        T.op("scale", {"X": ["i"]}, {"Out": ["i"]},
             [T.attr("scale", 1, f=1.0), T.attr("bias", 1, f=1.0),
              T.attr("bias_after_scale", 6, b=True)]),
        T.op("less_than", {"X": ["i"], "Y": ["five"]},
             {"Out": ["cond"]}, [T.attr("axis", 0, i=-1)]),
    ]
    prefix = T.write_model_blocks(tmp_path, "wh",
                                  [(b0, [T.var("x", [-1, 2])]), (sub, [])],
                                  {})
    return prefix, [rng.randn(3, 2).astype(F32)]


def _yolo(tmp_path, rng):
    feeds, fetches = T.feed_fetch(["x", "imgsize"], ["out", "idx", "num"])
    ops = feeds + [
        T.op("yolo_box", {"X": ["x"], "ImgSize": ["imgsize"]},
             {"Boxes": ["boxes"], "Scores": ["scores"]},
             [T.attr("anchors", 3, ints=[10, 13, 16, 30, 33, 23]),
              T.attr("class_num", 0, i=2),
              T.attr("conf_thresh", 1, f=0.01),
              T.attr("downsample_ratio", 0, i=16)]),
        T.op("transpose2", {"X": ["scores"]}, {"Out": ["scores_t"]},
             [T.attr("axis", 3, ints=[0, 2, 1])]),
        T.op("multiclass_nms3", {"BBoxes": ["boxes"],
                                 "Scores": ["scores_t"]},
             {"Out": ["out"], "Index": ["idx"], "NmsRoisNum": ["num"]},
             [T.attr("score_threshold", 1, f=0.01),
              T.attr("nms_top_k", 0, i=10), T.attr("keep_top_k", 0, i=10),
              T.attr("nms_threshold", 1, f=0.45)]),
    ] + fetches
    vars_ = [T.var("x", [1, 21, 4, 4]), T.var("imgsize", [1, 2], dtype=2)]
    return T.write_model(tmp_path, "yolo", ops, vars_, {}), \
        [rng.rand(1, 21, 4, 4).astype(F32), np.asarray([[64, 64]], np.int32)]


def _prior_box(tmp_path, rng):
    d = T.TestDetectionOps()
    feeds, fetches = T.feed_fetch(["feat", "image", "tb"], ["pb", "dec"])
    ops = feeds + [
        T.op("prior_box", {"Input": ["feat"], "Image": ["image"]},
             {"Boxes": ["pb"], "Variances": ["pv"]},
             [d._add_floats("min_sizes", [16.0]),
              d._add_floats("aspect_ratios", [1.0, 2.0]),
              d._add_floats("variances", [0.1, 0.1, 0.2, 0.2]),
              T.attr("flip", 6, b=False), T.attr("clip", 6, b=True),
              T.attr("offset", 1, f=0.5)]),
        T.op("reshape2", {"X": ["pb"]}, {"Out": ["pb2"]},
             [T.attr("shape", 3, ints=[-1, 4])]),
        T.op("reshape2", {"X": ["pv"]}, {"Out": ["pv2"]},
             [T.attr("shape", 3, ints=[-1, 4])]),
        T.op("box_coder", {"PriorBox": ["pb2"], "PriorBoxVar": ["pv2"],
                           "TargetBox": ["tb"]}, {"Out": ["dec"]},
             [T.attr("code_type", 2, s="decode_center_size")]),
    ] + fetches
    vars_ = [T.var("feat", [1, 8, 4, 4]), T.var("image", [1, 3, 32, 32]),
             T.var("tb", [1, 32, 4])]
    return T.write_model(tmp_path, "pb", ops, vars_, {}), [
        rng.rand(1, 8, 4, 4).astype(F32),
        rng.rand(1, 3, 32, 32).astype(F32),
        (rng.rand(1, 32, 4) * 0.1).astype(F32)]


def _norms(tmp_path, rng):
    scale = (rng.rand(4) + 0.5).astype(F32)
    bias = rng.randn(4).astype(F32)
    al = np.array([0.1, 0.2, 0.3, 0.4], F32)
    feeds, fetches = T.feed_fetch(["x"], ["y"])
    ops = feeds + [
        T.op("group_norm", {"X": ["x"], "Scale": ["gs"], "Bias": ["gb"]},
             {"Y": ["g"]}, [T.attr("groups", 0, i=2),
                            T.attr("epsilon", 1, f=1e-5)]),
        T.op("instance_norm", {"X": ["g"], "Scale": ["gs"],
                               "Bias": ["gb"]}, {"Y": ["i"]},
             [T.attr("epsilon", 1, f=1e-5)]),
        T.op("mish", {"X": ["i"]}, {"Out": ["m"]}),
        T.op("prelu", {"X": ["m"], "Alpha": ["al"]}, {"Out": ["pr"]}),
        T.op("pad3d", {"X": ["pr"]}, {"Out": ["y"]},
             [T.attr("paddings", 3, ints=[1, 0, 0, 1, 0, 0]),
              T.attr("mode", 2, s="reflect")]),
    ] + fetches
    vars_ = [T.var("x", [-1, 4, 1, 3, 3]),
             T.var("gs", [4], persistable=True),
             T.var("gb", [4], persistable=True),
             T.var("al", [4], persistable=True)]
    return T.write_model(tmp_path, "norms", ops, vars_,
                         {"gb": bias, "gs": scale, "al": al}), \
        [rng.randn(2, 4, 1, 3, 3).astype(F32)]


PROGRAMS = {"mlp": _mlp, "conv_bn_pool": _cnn, "shapes": _shapes,
            "cond_false": _cond, "cond_true": _cond_pos, "while": _while,
            "yolo_nms": _yolo, "prior_box_coder": _prior_box,
            "norms_pad3d": _norms}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_encoder_programs_match_the_jax_importer(name, tmp_path):
    """Each program through both importers: outputs within 1e-5
    (absolute and relative), integer outputs equal."""
    prefix, feeds = PROGRAMS[name](tmp_path, np.random.RandomState(0))
    jout, pout = _run_both(prefix, *feeds)
    for j, p in zip(jout, pout):
        assert j.shape == p.shape
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(p, j)


def test_jax_exported_models_load_into_the_port(tmp_path):
    """Artifacts written by the JAX exporter (a conv net with pooling,
    a transformer block spelled as the JAX GPT spells it) give the JAX
    importer's outputs through the port's, within 1e-5."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.static import InputSpec
    from paddle_tpu.static.program_export import \
        export_reference_inference_model

    J.seed(0)
    net = jnn.Sequential(jnn.Conv2D(2, 4, 3, padding=1),
                         jnn.BatchNorm2D(4), jnn.ReLU(),
                         jnn.MaxPool2D(2, 2), jnn.Flatten(),
                         jnn.Linear(4 * 4 * 4, 8), jnn.LayerNorm(8),
                         jnn.GELU(), jnn.Linear(8, 3), jnn.Softmax())
    net.eval()
    prefix = str(tmp_path / "jnet")
    export_reference_inference_model(prefix,
                                     [InputSpec([None, 2, 8, 8])], net)
    x = np.random.RandomState(1).randn(3, 2, 8, 8).astype(F32)
    jout, pout = _run_both(prefix, x)
    np.testing.assert_allclose(pout[0], jout[0], rtol=1e-5, atol=1e-5)


def test_program_runs_as_one_trace_per_signature(tmp_path):
    prefix, feeds = _mlp(tmp_path, np.random.RandomState(2))
    prog, _, _ = pimp.load_reference_inference_model(prefix)
    prog(*feeds)
    prog(*feeds)
    prog(np.random.RandomState(3).randn(7, 4).astype(F32))
    assert len(prog._jitted._cache) == 2


def test_to_layer_gradients_match_jax(tmp_path):
    """Gradients of ``sum(out * c)`` through ``to_layer()`` against
    ``jax.grad`` over the JAX program's ``apply``, for the parameters
    and through a conditional_block, within 1e-5."""
    rng = np.random.RandomState(4)
    prefix, (x,) = _mlp(tmp_path, rng)
    c = rng.randn(5, 3).astype(F32)
    jprog, pprog = _load_both(prefix)
    names = sorted(jprog.params)

    def jloss(params, xx):
        (out,) = jprog.apply(params, xx)
        return jnp.sum(out * c)

    jg = jax.grad(jloss)({n: jprog.params[n] for n in names},
                         jnp.asarray(x))
    layer = pprog.to_layer()
    out = layer(P.to_tensor(x))
    (out * P.to_tensor(c)).sum().backward()
    for n in names:
        got = layer._parameters[layer._safe[n]].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg[n]), rtol=1e-5,
                                   atol=1e-5)

    prefix = T.TestControlFlow()._cond_program(tmp_path)
    jprog, pprog = _load_both(prefix)
    for sign in (1.0, -1.0):
        xv = np.full((2, 3), 1.5 * sign, F32)
        jgx = jax.grad(lambda v: sum(jnp.sum(o) for o in
                                     jprog.apply({}, v)))(jnp.asarray(xv))
        xt = torch.tensor(xv, requires_grad=True)
        (out,) = pprog.apply({}, xt)
        out.sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                                   rtol=1e-6)


def test_while_has_no_gradient_in_either(tmp_path):
    """A reverse-mode gradient through an imported ``while`` raises in
    both packages (``lax.while_loop``'s rule)."""
    prefix, (x,) = _while(tmp_path, np.random.RandomState(5))
    jprog, pprog = _load_both(prefix)
    with pytest.raises(Exception, match="while_loop|[Rr]everse"):
        jax.grad(lambda v: jnp.sum(jprog.apply({}, v)[0]))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (out,) = pprog.apply({}, xt)
    np.testing.assert_allclose(out.detach().numpy(), x * 32, rtol=1e-6)
    with pytest.raises(ValueError, match="Reverse-mode"):
        out.sum().backward()


def test_bf16_parameter_reads_as_the_jax_reader_reads_it(tmp_path):
    """VarType 22: the port views the raw words as torch.bfloat16; the
    values equal the JAX reader's ml_dtypes array exactly."""
    import ml_dtypes

    vals = np.random.RandomState(6).randn(3, 5).astype(
        ml_dtypes.bfloat16)
    desc = T._fint(1, 22) + T._fint(2, 3) + T._fint(2, 5)
    rec = (np.uint32(0).tobytes() + np.uint64(0).tobytes()
           + np.uint32(0).tobytes() + np.int32(len(desc)).tobytes()
           + desc + vals.tobytes())
    jarr, jend = jimp.read_lod_tensor(rec, 0)
    parr, pend = pimp.read_lod_tensor(rec, 0)
    assert pend == jend == len(rec)
    assert parr.dtype == torch.bfloat16
    np.testing.assert_array_equal(parr.float().numpy(),
                                  np.asarray(jarr).astype(np.float32))
    bad = desc.replace(T._fint(1, 22), T._fint(1, 23))
    with pytest.raises(ValueError, match="data_type"):
        pimp.read_lod_tensor(rec.replace(desc, bad), 0)


def test_supported_ops_and_unknown_op_report_match(tmp_path):
    assert set(pimp.supported_ops()) == set(jimp.supported_ops())
    feeds, fetches = T.feed_fetch(["x"], ["y"])
    ops = feeds + [T.op("exotic_a", {"X": ["x"]}, {"Out": ["h"]}),
                   T.op("exotic_b", {"X": ["h"]}, {"Out": ["y"]})] + fetches
    prefix = T.write_model(tmp_path, "bad", ops, [T.var("x", [2])], {})
    with pytest.raises(NotImplementedError, match="2 ProgramDesc op.*"
                       "'exotic_a' -> \\[h\\]; 'exotic_b' -> \\[y\\]"):
        pimp.load_reference_inference_model(prefix)
