"""Minimal numpy evaluator for exported ONNX models (port of
``paddle_tpu/onnx/runtime.py``).

Two jobs: (1) self-verification of the native exporter — run the
exported graph and compare with the model, no onnxruntime needed; (2) a
tiny host-side inference runtime for environments without an ONNX
backend.  Covers exactly the node set the exporter emits: the JAX
package's set, and ``Conv``, ``MaxPool`` and ``AveragePool``, which the
port's exporter emits for convolutional models.  Host only: numpy in,
numpy out.
"""

import numpy as np

from . import onnx_subset_pb2 as pb

_NP_DTYPE = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
             6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
             11: np.float64}


def _tensor_to_np(t):
    if t.data_type == 16:  # bfloat16: widen to float32 for numpy eval
        words = np.frombuffer(t.raw_data, dtype=np.uint16)
        return (words.astype(np.uint32) << 16).view(np.float32).reshape(
            list(t.dims))
    return np.frombuffer(t.raw_data,
                         dtype=_NP_DTYPE[t.data_type]).reshape(list(t.dims))


def _attrs(node):
    out = {}
    for a in node.attribute:
        if a.type == 1:
            out[a.name] = a.f
        elif a.type == 2:
            out[a.name] = a.i
        elif a.type == 3:
            out[a.name] = a.s.decode()
        elif a.type == 7:
            out[a.name] = list(a.ints)
    return out


def load(path):
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    return m


def _windows(x, kernel, strides, dilations):
    """[N, C, oh, ow, kh, kw] windows of an NCHW array (already
    padded)."""
    kh, kw = kernel
    eh, ew = (kh - 1) * dilations[0] + 1, (kw - 1) * dilations[1] + 1
    v = np.lib.stride_tricks.sliding_window_view(x, (eh, ew), axis=(2, 3))
    v = v[:, :, ::strides[0], ::strides[1], ::dilations[0], ::dilations[1]]
    return v


def _pad_nchw(x, pads, value=0.0):
    t, l_, b, r = pads
    return np.pad(x, ((0, 0), (0, 0), (t, b), (l_, r)),
                  constant_values=value)


def _conv(x, w, at):
    pads = at.get("pads", [0, 0, 0, 0])
    strides = at.get("strides", [1, 1])
    dil = at.get("dilations", [1, 1])
    g = at.get("group", 1)
    x = _pad_nchw(x, [pads[0], pads[1], pads[2], pads[3]])
    win = _windows(x, w.shape[2:], strides, dil)      # N C oh ow kh kw
    n, c, oh, ow = win.shape[:4]
    cg, og = c // g, w.shape[0] // g
    outs = []
    for gi in range(g):
        wv = win[:, gi * cg:(gi + 1) * cg]
        wg = w[gi * og:(gi + 1) * og]                  # og cg kh kw
        outs.append(np.einsum("ncyxhw,ochw->noyx", wv, wg, optimize=True))
    return np.concatenate(outs, axis=1).astype(x.dtype)


def _pool(x, at, kind):
    k = at["kernel_shape"]
    pads = at.get("pads", [0, 0, 0, 0])
    strides = at.get("strides", [1, 1])
    fill = -np.inf if kind == "max" else 0.0
    x = _pad_nchw(x, [pads[0], pads[1], pads[2], pads[3]], fill)
    win = _windows(x, k, strides, [1, 1])
    if kind == "max":
        return win.max(axis=(4, 5))
    return win.sum(axis=(4, 5)) / float(k[0] * k[1])


def run(model_or_path, inputs):
    """Evaluate the graph on ``inputs`` (dict name->array or list by
    position); returns list of output arrays."""
    m = model_or_path if isinstance(model_or_path, pb.ModelProto) \
        else load(model_or_path)
    g = m.graph
    env = {t.name: _tensor_to_np(t) for t in g.initializer}
    if isinstance(inputs, dict):
        env.update({k: np.asarray(v) for k, v in inputs.items()})
    else:
        for vi, arr in zip(g.input, inputs):
            env[vi.name] = np.asarray(arr)

    for node in g.node:
        ins = [env[n] for n in node.input]
        at = _attrs(node)
        op = node.op_type
        if op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Gemm":
            out = ins[0] @ ins[1] + (ins[2] if len(ins) > 2 else 0)
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Pow":
            out = np.power(ins[0], ins[1].astype(ins[0].dtype))
        elif op == "Mod":
            out = (np.fmod(ins[0], ins[1]) if at.get("fmod")
                   else np.mod(ins[0], ins[1]))
        elif op == "Max":
            out = np.maximum(ins[0], ins[1])
        elif op == "Min":
            out = np.minimum(ins[0], ins[1])
        elif op == "Neg":
            out = -ins[0]
        elif op == "Exp":
            out = np.exp(ins[0])
        elif op == "Log":
            out = np.log(ins[0])
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Sqrt":
            out = np.sqrt(ins[0])
        elif op == "Reciprocal":
            out = 1.0 / ins[0]
        elif op == "Abs":
            out = np.abs(ins[0])
        elif op == "Sign":
            out = np.sign(ins[0])
        elif op == "Floor":
            out = np.floor(ins[0])
        elif op == "Ceil":
            out = np.ceil(ins[0])
        elif op == "Round":
            out = np.round(ins[0])
        elif op == "Erf":
            from math import erf
            out = np.vectorize(erf)(ins[0]).astype(ins[0].dtype)
        elif op in ("And", "Or", "Xor"):
            fn = {"And": np.logical_and, "Or": np.logical_or,
                  "Xor": np.logical_xor}[op]
            out = fn(ins[0], ins[1])
        elif op == "Not":
            out = np.logical_not(ins[0])
        elif op == "Equal":
            out = ins[0] == ins[1]
        elif op == "Less":
            out = ins[0] < ins[1]
        elif op == "LessOrEqual":
            out = ins[0] <= ins[1]
        elif op == "Greater":
            out = ins[0] > ins[1]
        elif op == "GreaterOrEqual":
            out = ins[0] >= ins[1]
        elif op == "Where":
            out = np.where(ins[0], ins[1], ins[2])
        elif op == "Clip":
            out = np.clip(ins[0], ins[1], ins[2])
        elif op == "Relu":
            out = np.maximum(ins[0], 0)
        elif op == "Reshape":
            out = ins[0].reshape(ins[1].astype(np.int64))
        elif op == "Expand":
            out = np.broadcast_to(ins[0], ins[1].astype(np.int64))
        elif op == "Transpose":
            out = np.transpose(ins[0], at.get("perm"))
        elif op == "Cast":
            to = at["to"]
            out = ins[0].astype(np.float32 if to == 16 else _NP_DTYPE[to])
        elif op == "ReduceSum":
            axes = tuple(ins[1].astype(np.int64)) if len(ins) > 1 else None
            out = ins[0].sum(axis=axes,
                             keepdims=bool(at.get("keepdims", 1)))
        elif op in ("ReduceMax", "ReduceMin", "ReduceProd"):
            fn = {"ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceProd": np.prod}[op]
            out = fn(ins[0], axis=tuple(at.get("axes", [])) or None,
                     keepdims=bool(at.get("keepdims", 1)))
        elif op == "ArgMax":
            out = np.argmax(ins[0], axis=at.get("axis", 0))
            if at.get("keepdims", 1):
                out = np.expand_dims(out, at.get("axis", 0))
            out = out.astype(np.int64)
        elif op == "Concat":
            out = np.concatenate(ins, axis=at["axis"])
        elif op == "Slice":
            x, starts, ends, axes, steps = ins
            sl = [slice(None)] * x.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                sl[int(ax)] = slice(int(s), int(e), int(st))
            out = x[tuple(sl)]
        elif op == "Identity":
            out = ins[0]
        elif op == "Conv":
            out = _conv(ins[0], ins[1], at)
        elif op == "MaxPool":
            out = _pool(ins[0], at, "max")
        elif op == "AveragePool":
            out = _pool(ins[0], at, "avg")
        else:
            raise NotImplementedError(f"runtime: unsupported op {op}")
        env[node.output[0]] = np.asarray(out)

    return [env[vo.name] for vo in g.output]
