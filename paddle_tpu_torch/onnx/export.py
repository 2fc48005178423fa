"""ONNX export — native traced-program -> ONNX converter (port of
``paddle_tpu/onnx/export.py``).

Reference parity: ``paddle.onnx.export`` (python/paddle/onnx/export.py)
is a thin wrapper over the external paddle2onnx converter.  Here the
export is native: the Layer is traced as the program exporter traces it
(``static.program_export.trace``: fake tensors, the parameters as graph
inputs whose values become initializers) at the given example inputs,
lowered into the program exporter's primitive vocabulary, and each
primitive maps to ONNX ops.  The composite ops (softmax, gelu,
layer norm, eval batch norm) decompose in this trace and export as
their primitive compositions, as the JAX exporter exports them.  On top
of the JAX package's op subset, a 2-D convolution exports as ``Conv``
and a pool as ``MaxPool`` / ``AveragePool``, so convolutional models
export.  An unsupported primitive raises with its name.  The messages
are the port's own codec (``onnx_subset_pb2``); the producer name stays
``"paddle_tpu"``.
"""

import numpy as np
import torch

from ..static import program_export as _px
from . import onnx_subset_pb2 as pb

# ONNX TensorProto.DataType values
_DTYPE = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}
_BFLOAT16 = 16

_OPSET = 13


def _onnx_dtype(dt):
    if dt is _px.BF16:
        return _BFLOAT16
    try:
        return _DTYPE[np.dtype(dt)]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"ONNX export: unsupported dtype {dt} (primitive outputs of "
            "this type, e.g. complex FFT, cannot be exported)")


class _Graph:
    def __init__(self):
        self.nodes = []
        self.initializers = {}
        self.names = {}
        self.const_names = {}
        self.counter = 0

    def fresh(self, hint="t"):
        self.counter += 1
        return f"{hint}_{self.counter}"

    def name_of(self, atom):
        if isinstance(atom, _px.Literal):
            dt = atom.aval.dtype
            return self.add_const(np.asarray(
                atom.val, np.float32 if dt is _px.BF16 else dt))
        if isinstance(atom, _px._Const):
            if atom.key not in self.const_names:
                self.const_names[atom.key] = self.add_const(
                    np.asarray(atom.val))
            return self.const_names[atom.key]
        key = id(atom)
        if key not in self.names:
            self.names[key] = self.fresh("v")
        return self.names[key]

    def add_const(self, arr, name=None):
        arr = np.asarray(arr)
        name = name or self.fresh("const")
        t = pb.TensorProto()
        t.name = name
        t.dims[:] = list(arr.shape)
        t.data_type = _onnx_dtype(arr.dtype)
        t.raw_data = arr.tobytes()
        self.initializers[name] = t
        return name

    def add_node(self, op_type, inputs, n_out=1, **attrs):
        node = pb.NodeProto()
        node.op_type = op_type
        node.name = self.fresh(op_type)
        node.input[:] = inputs
        outs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        node.output[:] = outs
        for k, v in attrs.items():
            a = node.attribute.add()
            a.name = k
            if isinstance(v, bool):
                a.type, a.i = 2, int(v)
            elif isinstance(v, int):
                a.type, a.i = 2, v
            elif isinstance(v, float):
                a.type, a.f = 1, v
            elif isinstance(v, str):
                a.type, a.s = 3, v.encode()
            elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, int) for x in v):
                a.type = 7
                a.ints[:] = list(v)
            else:
                raise TypeError(f"attr {k}={v!r}")
        self.nodes.append(node)
        return outs[0] if n_out == 1 else outs


def _map_dot_general(g, ins, in_avals, params):
    ((cl, cr), (bl, br)) = params["dimension_numbers"]
    lrank, rrank = len(in_avals[0].shape), len(in_avals[1].shape)
    # numpy-matmul layout: batch dims leading, contraction = (last of
    # lhs, second-to-last of rhs)
    std = (tuple(cl) == (lrank - 1,) and tuple(cr) == (max(rrank - 2, 0),)
           and tuple(bl) == tuple(range(lrank - 2))
           and tuple(br) == tuple(range(rrank - 2)))
    if std:
        return g.add_node("MatMul", ins)
    if lrank == 2 and rrank == 2:
        a, b = ins
        if tuple(cl) == (0,):
            a = g.add_node("Transpose", [a], perm=[1, 0])
        if tuple(cr) == (1,):
            b = g.add_node("Transpose", [b], perm=[1, 0])
        return g.add_node("MatMul", [a, b])
    raise NotImplementedError(
        f"dot_general dimension_numbers {params['dimension_numbers']}")


def _map_broadcast(g, x, in_shape, params):
    shape = params["shape"]
    bdims = params["broadcast_dimensions"]
    # insert singleton dims so rank matches, then Expand
    interim = [1] * len(shape)
    for src, dst in enumerate(bdims):
        interim[dst] = in_shape[src]
    if tuple(interim) != tuple(in_shape):
        x = g.add_node("Reshape", [x, g.add_const(
            np.asarray(interim, np.int64))])
    if tuple(interim) == tuple(shape):
        return x
    return g.add_node("Expand", [x, g.add_const(
        np.asarray(shape, np.int64))])


_SIMPLE = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
    "max": "Max", "min": "Min", "pow": "Pow",
    "neg": "Neg", "exp": "Exp", "log": "Log", "tanh": "Tanh",
    "logistic": "Sigmoid", "sqrt": "Sqrt", "abs": "Abs", "sign": "Sign",
    "floor": "Floor", "ceil": "Ceil", "erf": "Erf",
    "and": "And", "or": "Or", "not": "Not", "xor": "Xor",
}

_COMPARE = {"eq": "Equal", "ne": ("Equal", "Not"), "lt": "Less",
            "le": "LessOrEqual", "gt": "Greater", "ge": "GreaterOrEqual"}


def _convert_eqn(g, prim, ins_atoms, outs, params):
    ins = [g.name_of(a) for a in ins_atoms]
    in_avals = [a.aval for a in ins_atoms]
    aval = outs[0].aval

    def bind(out_name):
        g.names[id(outs[0])] = out_name

    if prim == "dot_general":
        bind(_map_dot_general(g, ins, in_avals, params))
    elif prim == "broadcast_in_dim":
        bind(_map_broadcast(g, ins[0], in_avals[0].shape, params))
    elif prim in _SIMPLE:
        bind(g.add_node(_SIMPLE[prim], ins))
    elif prim in _COMPARE:
        spec = _COMPARE[prim]
        if isinstance(spec, tuple):
            x = ins
            for op in spec:
                x = [g.add_node(op, x)]
            bind(x[0])
        else:
            bind(g.add_node(spec, ins))
    elif prim == "integer_pow":
        bind(g.add_node("Pow", [ins[0], g.add_const(
            np.asarray(params["y"], np.float32))]))
    elif prim == "rsqrt":
        bind(g.add_node("Reciprocal", [g.add_node("Sqrt", ins)]))
    elif prim == "erfc":
        one = g.add_const(np.asarray(1.0, np.float32))
        bind(g.add_node("Sub", [one, g.add_node("Erf", ins)]))
    elif prim == "square":
        bind(g.add_node("Mul", [ins[0], ins[0]]))
    elif prim == "rem":
        # rem is the C-style truncated remainder = ONNX Mod fmod=1
        bind(g.add_node("Mod", ins, fmod=1))
    elif prim == "reduce_sum":
        axes = g.add_const(np.asarray(params["axes"], np.int64))
        bind(g.add_node("ReduceSum", [ins[0], axes], keepdims=0))
    elif prim in ("reduce_max", "reduce_min", "reduce_prod"):
        op = {"reduce_max": "ReduceMax", "reduce_min": "ReduceMin",
              "reduce_prod": "ReduceProd"}[prim]
        bind(g.add_node(op, ins, axes=list(params["axes"]), keepdims=0))
    elif prim in ("reshape", "squeeze"):
        bind(g.add_node("Reshape", [ins[0], g.add_const(
            np.asarray(aval.shape, np.int64))]))
    elif prim == "transpose":
        bind(g.add_node("Transpose", ins, perm=list(params["permutation"])))
    elif prim == "convert_element_type":
        bind(g.add_node("Cast", ins, to=_onnx_dtype(params["new_dtype"])))
    elif prim == "select_n":
        if len(ins) != 3:
            raise NotImplementedError("select_n with >2 cases")
        pred, on_false, on_true = ins
        bind(g.add_node("Where", [pred, on_true, on_false]))
    elif prim == "concatenate":
        bind(g.add_node("Concat", ins, axis=int(params["dimension"])))
    elif prim == "slice":
        starts = np.asarray(params["start_indices"], np.int64)
        ends = np.asarray(params["limit_indices"], np.int64)
        strides = params.get("strides")
        strides = np.asarray(
            strides if strides is not None else [1] * len(starts), np.int64)
        axes = np.arange(len(starts), dtype=np.int64)
        bind(g.add_node("Slice", [ins[0], g.add_const(starts),
                                  g.add_const(ends), g.add_const(axes),
                                  g.add_const(strides)]))
    elif prim == "split":
        axis = int(params["axis"])
        start = 0
        nd = len(in_avals[0].shape)
        for ov, size in zip(outs, params["sizes"]):
            starts = np.zeros(nd, np.int64)
            ends = np.asarray(in_avals[0].shape, np.int64)
            starts[axis], ends[axis] = start, start + size
            start += size
            g.names[id(ov)] = g.add_node("Slice", [
                ins[0], g.add_const(starts), g.add_const(ends),
                g.add_const(np.arange(nd, dtype=np.int64)),
                g.add_const(np.ones(nd, np.int64))])
    elif prim == "argmax":
        bind(g.add_node("Cast", [g.add_node(
            "ArgMax", ins, axis=int(params["axes"][0]), keepdims=0)],
            to=_onnx_dtype(aval.dtype)))
    elif prim in ("stop_gradient", "copy"):
        bind(g.add_node("Identity", ins))
    elif prim == "conv_general_dilated":
        pads = params["padding"]
        bind(g.add_node(
            "Conv", ins,
            strides=[int(s) for s in params["window_strides"]],
            pads=[int(pads[0][0]), int(pads[1][0]), int(pads[0][1]),
                  int(pads[1][1])],
            dilations=[int(d) for d in params.get("rhs_dilation", (1, 1))],
            group=int(params.get("feature_group_count", 1))))
    elif prim in ("reduce_window_max", "reduce_window_sum"):
        win = params["window_dimensions"]
        st = params["window_strides"]
        pads = params["padding"]
        if len(win) != 4 or win[:2] != (1, 1) or st[:2] != (1, 1):
            raise NotImplementedError(
                "ONNX export: only NCHW spatial pools are supported")
        attrs = dict(kernel_shape=[int(win[2]), int(win[3])],
                     strides=[int(st[2]), int(st[3])],
                     pads=[int(pads[2][0]), int(pads[3][0]),
                           int(pads[2][1]), int(pads[3][1])])
        if prim.endswith("max"):
            bind(g.add_node("MaxPool", ins, **attrs))
        else:
            avg = g.add_node("AveragePool", ins, count_include_pad=1,
                             **attrs)
            k = g.add_const(np.asarray(float(win[2] * win[3]), np.float32))
            bind(g.add_node("Mul", [avg, k]))
    elif prim == "kernel":
        raise NotImplementedError(
            f"ONNX export: the hand-written kernel {params['kernel']} has "
            "no ONNX translation; export a CPU copy of the model, where "
            "the kernels are off")
    else:
        raise NotImplementedError(
            f"ONNX export: unsupported primitive {prim!r} "
            f"(params={dict(params)})")


def export_program(prog, arg_names, path, graph_name="paddle_tpu_graph"):
    """Serialize a lowered program (``static.program_export.Program``)
    to an ONNX ModelProto file."""
    g = _Graph()

    model = pb.ModelProto()
    model.ir_version = 8
    model.producer_name = "paddle_tpu"
    ops = model.opset_import.add()
    ops.domain = ""
    ops.version = _OPSET

    graph = model.graph
    graph.name = graph_name

    for iv, nm in zip(prog.invars, arg_names):
        g.names[id(iv)] = nm
        vi = graph.input.add()
        vi.name = nm
        tt = vi.type.tensor_type
        tt.elem_type = _onnx_dtype(iv.aval.dtype)
        for d in iv.aval.shape:
            tt.shape.dim.add().dim_value = int(d)

    live = {v for v in prog.outvars if not _px._atomic(v)}
    for prim, ins, outs, params in _px._dce(list(prog.eqns), live):
        _convert_eqn(g, prim, ins, outs, params)

    for i, ov in enumerate(prog.outvars):
        nm = g.name_of(ov)
        out_name = f"output_{i}"
        idn = pb.NodeProto()
        idn.op_type = "Identity"
        idn.name = g.fresh("Identity")
        idn.input[:] = [nm]
        idn.output[:] = [out_name]
        g.nodes.append(idn)
        vo = graph.output.add()
        vo.name = out_name
        tt = vo.type.tensor_type
        tt.elem_type = _onnx_dtype(ov.aval.dtype)
        for d in ov.aval.shape:
            tt.shape.dim.add().dim_value = int(d)

    graph.node.extend(g.nodes)
    graph.initializer.extend(g.initializers.values())

    with open(path, "wb") as f:
        f.write(model.SerializeToString())
    return path


def _decompositions():
    """The program exporter's table, plus the composites ONNX exports as
    their compositions."""
    from torch._decomp import get_decompositions

    aten = torch.ops.aten
    table = dict(_px.DECOMPOSITIONS)
    table.update(get_decompositions([
        aten._softmax, aten._log_softmax, aten.gelu,
        aten.native_layer_norm, aten._native_batch_norm_legit_no_training,
        aten.silu, aten.hardtanh]))
    return table


def export(layer, path, input_spec=None, opset_version=13, **kwargs):
    """``paddle.onnx.export`` parity: save ``layer`` as ``{path}.onnx``.

    ``input_spec``: example inputs (Tensors / numpy arrays / shape-dtype
    specs) defining the traced signature.  Parameters are baked into the
    model as initializers.  The trace runs on the device the layer's
    parameters live on.
    """
    from ..core.tensor import Tensor
    from ..framework.dtype import convert_dtype

    if opset_version != _OPSET:
        raise ValueError(
            f"only opset {_OPSET} is supported (requested {opset_version})")
    if input_spec is None:
        raise ValueError("input_spec (example inputs) is required")

    _names, values = _px._state_of(layer)
    dev = values[0].device if values else torch.device("cpu")
    examples = []
    for spec in input_spec:
        if isinstance(spec, Tensor):
            examples.append(spec._data.to(dev))
        elif isinstance(spec, torch.Tensor):
            examples.append(spec.to(dev))
        elif hasattr(spec, "shape") and hasattr(spec, "dtype") and \
                not isinstance(spec, np.ndarray):
            examples.append(torch.zeros(
                [int(d) for d in spec.shape],
                dtype=convert_dtype(spec.dtype) or torch.float32,
                device=dev))
        else:
            examples.append(torch.as_tensor(np.asarray(spec), device=dev))

    gm, names, values = _px.trace(layer, examples,
                                  decompositions=_decompositions())
    static = {i: _px._Const(_px._np_value(v), key=("param", id(v)))
              for i, v in enumerate(values)}
    try:
        prog = _px.lower(gm, static)
    except NotImplementedError as exc:
        raise NotImplementedError(
            f"ONNX export: unsupported primitive — {exc}") from None
    arg_names = [f"input_{i}" for i in range(len(examples))]
    out = path if path.endswith(".onnx") else path + ".onnx"
    return export_program(prog, arg_names, out,
                          graph_name=type(layer).__name__)
