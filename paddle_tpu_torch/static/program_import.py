"""One-way ProgramDesc importer: run reference-format inference models
(port of ``paddle_tpu/static/program_import.py``).

The reference serializes inference programs as a ``ProgramDesc``
protobuf (``model.pdmodel``) plus a combined parameter stream
(``model.pdiparams``), loaded by python/paddle/static/io.py:727
``load_inference_model`` and executed by an interpreter over OpDesc.
Here the program is TRANSLATED instead: each OpDesc maps through a
table onto a torch composition, and the composed function is traced
once per input signature by ``jit.StaticFunction`` (the JAX package's
``jax.jit``) and replayed — the program never runs op by op eagerly.
``conditional_block`` runs as ``static.cond`` (both branches traced, the
untaken one yielding zeros that the paired ``select_input`` never
picks) and ``while`` as ``static.while_loop``, whose rules are
``lax.while_loop``'s: loop-invariant shapes and no reverse-mode
gradient, so a backward through an imported ``while`` raises as in the
JAX package (its carried values pass an identity op whose backward
raises, ``paddle_tpu_import::while_barrier``).

The translators are compositions, as in the JAX importer: ``layer_norm``
and ``softmax`` among them, so an imported program reaches no
hand-written kernel; the detection ops call the port's registered op
bodies where the JAX importer calls ``OPS[name].jax_fn``.

Format interfaces implemented against the published schemas (field
numbers cited inline):
- paddle/fluid/framework/framework.proto (ProgramDesc/BlockDesc/
  OpDesc/VarDesc/VarType wire layout)
- paddle/fluid/framework/tensor_util.cc TensorToStream +
  lod_tensor.cc SerializeToStream (the .pdiparams per-tensor stream)
- python/paddle/static/io.py:661 (combined params are concatenated in
  sorted-variable-name order)

VarType codes 0-6, 20 and 21 read as numpy arrays; code 22 (bfloat16)
reads its raw 16-bit words as a ``torch.bfloat16`` tensor.  Any other
code raises.
"""

import struct

import numpy as np
import torch
import torch.nn.functional as tF

# ------------------------------------------------------------ wire reader --


class _Reader:
    def __init__(self, data, pos=0, end=None):
        self.d = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def eof(self):
        return self.pos >= self.end

    def varint(self):
        shift, out = 0, 0
        while True:
            b = self.d[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def skip(self, wire_type):
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            self.pos += self.varint()
        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")

    def bytes_(self):
        n = self.varint()
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out


def _zigzag64(v):
    # proto2 int64/int32 fields are plain (non-zigzag) varints; negative
    # values arrive as 2^64 complements
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse(data, schema, pos=0, end=None):
    """Parse one message.  ``schema``: field_no -> (name, kind[, sub]).
    kinds: int (varint, sign-corrected), bool, float, double, str,
    bytes, msg (sub-schema dict), rep_* for repeated fields (repeated
    varints accept both packed and unpacked encodings)."""
    r = _Reader(data, pos, end)
    out = {}
    for no, (name, kind, *_s) in schema.items():
        if kind.startswith("rep_"):
            out[name] = []
    while not r.eof():
        key = r.varint()
        no, wt = key >> 3, key & 7
        if no not in schema:
            r.skip(wt)
            continue
        name, kind, *sub = schema[no]
        if kind in ("int", "bool"):
            v = _zigzag64(r.varint())
            out[name] = bool(v) if kind == "bool" else v
        elif kind == "float":
            (v,) = struct.unpack("<f", r.d[r.pos:r.pos + 4])
            r.pos += 4
            out[name] = v
        elif kind == "double":
            (v,) = struct.unpack("<d", r.d[r.pos:r.pos + 8])
            r.pos += 8
            out[name] = v
        elif kind == "str":
            out[name] = r.bytes_().decode("utf-8")
        elif kind == "bytes":
            out[name] = bytes(r.bytes_())
        elif kind == "msg":
            b = r.bytes_()
            out[name] = _parse(b, sub[0])
        elif kind == "rep_int":
            if wt == 2:  # packed
                b = r.bytes_()
                rr = _Reader(b)
                while not rr.eof():
                    out[name].append(_zigzag64(rr.varint()))
            else:
                out[name].append(_zigzag64(r.varint()))
        elif kind == "rep_float":
            if wt == 2:
                b = r.bytes_()
                out[name].extend(
                    struct.unpack(f"<{len(b) // 4}f", b))
            else:
                (v,) = struct.unpack("<f", r.d[r.pos:r.pos + 4])
                r.pos += 4
                out[name].append(v)
        elif kind == "rep_str":
            out[name].append(r.bytes_().decode("utf-8"))
        elif kind == "rep_bytes":
            out[name].append(bytes(r.bytes_()))
        elif kind == "rep_msg":
            out[name].append(_parse(r.bytes_(), sub[0]))
        else:
            raise ValueError(f"unknown kind {kind}")
    return out


# ------------------------------------------- framework.proto field layout --
# (field numbers cite framework.proto; only the inference-relevant subset)

_TENSOR_DESC = {1: ("data_type", "int"), 2: ("dims", "rep_int")}
_LOD_TENSOR_DESC = {1: ("tensor", "msg", _TENSOR_DESC),
                    2: ("lod_level", "int")}
_VAR_TYPE = {1: ("type", "int"),
             3: ("lod_tensor", "msg", _LOD_TENSOR_DESC)}
_VAR_DESC = {1: ("name", "str"), 2: ("type", "msg", _VAR_TYPE),
             3: ("persistable", "bool")}
_OP_VAR = {1: ("parameter", "str"), 2: ("arguments", "rep_str")}
_OP_ATTR = {1: ("name", "str"), 2: ("type", "int"), 3: ("i", "int"),
            4: ("f", "float"), 5: ("s", "str"), 6: ("ints", "rep_int"),
            7: ("floats", "rep_float"), 8: ("strings", "rep_str"),
            10: ("b", "bool"), 11: ("bools", "rep_int"),
            12: ("block_idx", "int"), 13: ("l", "int"),
            14: ("blocks_idx", "rep_int"), 15: ("longs", "rep_int"),
            19: ("float64", "double")}
_OP_DESC = {3: ("type", "str"), 1: ("inputs", "rep_msg", _OP_VAR),
            2: ("outputs", "rep_msg", _OP_VAR),
            4: ("attrs", "rep_msg", _OP_ATTR)}
_BLOCK_DESC = {1: ("idx", "int"), 2: ("parent_idx", "int"),
               3: ("vars", "rep_msg", _VAR_DESC),
               4: ("ops", "rep_msg", _OP_DESC)}
_PROGRAM_DESC = {1: ("blocks", "rep_msg", _BLOCK_DESC)}

# VarType.Type -> numpy dtype (framework.proto enum values); 22 (BF16)
# reads as torch.bfloat16 (read_lod_tensor)
_BF16 = 22
_DTYPES = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
           4: np.float16, 5: np.float32, 6: np.float64,
           20: np.uint8, 21: np.int8}
_TORCH = {0: torch.bool, 1: torch.int16, 2: torch.int32, 3: torch.int64,
          4: torch.float16, 5: torch.float32, 6: torch.float64,
          20: torch.uint8, 21: torch.int8, _BF16: torch.bfloat16}


def _torch_dtype(code, default=5):
    return _TORCH.get(default if code is None else code, torch.float32)


def _attr_value(a):
    t = a.get("type")
    # AttrType enum: INT FLOAT STRING INTS FLOATS STRINGS BOOLEAN
    # BOOLEANS ... LONG ... LONGS ... FLOAT64
    if t == 0:
        return a.get("i", 0)
    if t == 1:
        return a.get("f", 0.0)
    if t == 2:
        return a.get("s", "")
    if t == 3:
        return list(a.get("ints", []))
    if t == 4:
        return list(a.get("floats", []))
    if t == 5:
        return list(a.get("strings", []))
    if t == 6:
        return bool(a.get("b", False))
    if t == 7:
        return [bool(x) for x in a.get("bools", [])]
    if t == 8:                      # BLOCK: a sub-block index
        return a.get("block_idx", 0)
    if t == 9:
        return a.get("l", 0)
    if t == 10:                     # BLOCKS
        return list(a.get("blocks_idx", []))
    if t == 11:
        return list(a.get("longs", []))
    if t == 15:
        return a.get("float64", 0.0)
    return None


class OpDef:
    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, raw):
        self.type = raw["type"]
        self.inputs = {v["parameter"]: list(v.get("arguments", []))
                       for v in raw.get("inputs", [])}
        self.outputs = {v["parameter"]: list(v.get("arguments", []))
                        for v in raw.get("outputs", [])}
        self.attrs = {a["name"]: _attr_value(a)
                      for a in raw.get("attrs", [])}


def _block_view(block):
    ops = [OpDef(o) for o in block.get("ops", [])]
    vars_ = {}
    for v in block.get("vars", []):
        vt = v.get("type", {})
        lod = vt.get("lod_tensor") or {}
        td = lod.get("tensor") or {}
        code = td.get("data_type", 5)
        vars_[v["name"]] = {
            "persistable": v.get("persistable", False),
            # VarType.Type — needed to EXCLUDE feed/fetch holders from
            # the params stream (real exports mark them persistable,
            # but io_utils.is_persistable drops non-LOD_TENSOR types)
            "vtype": vt.get("type", 7),
            "dtype": torch.bfloat16 if code == _BF16
            else _DTYPES.get(code, np.float32),
            "shape": list(td.get("dims", [])),
        }
    return ops, vars_


def parse_program_blocks(data):
    """bytes (a .pdmodel file) -> [(ops, var_descs)] for ALL blocks —
    sub-blocks hold conditional_block/while bodies (framework.proto
    BlockDesc; reference conditional_block_op.cc / while_op.cc)."""
    prog = _parse(data, _PROGRAM_DESC)
    if not prog.get("blocks"):
        raise ValueError("ProgramDesc has no blocks")
    return [_block_view(b) for b in prog["blocks"]]


def parse_program(data):
    """bytes (a .pdmodel file) -> (ops, var_descs) of block 0."""
    return parse_program_blocks(data)[0]


# ------------------------------------------------------- parameter stream --

def read_lod_tensor(buf, pos):
    """One LoDTensor record at ``pos`` (tensor_util.cc TensorToStream /
    lod_tensor.cc SerializeToStream); returns (array, new_pos): a numpy
    array, or a ``torch.bfloat16`` tensor for code 22."""
    (ver,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if ver != 0:
        raise ValueError(f"unsupported tensor version {ver}")
    (lod_level,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", buf, pos)
        pos += 8 + nbytes
    (tver,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if tver != 0:
        raise ValueError(f"unsupported tensor version {tver}")
    (desc_size,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    desc = _parse(buf, _TENSOR_DESC, pos, pos + desc_size)
    pos += desc_size
    code = desc.get("data_type", 5)
    dims = [int(d) for d in desc.get("dims", [])]
    count = int(np.prod(dims)) if dims else 1
    if code == _BF16:
        words = np.frombuffer(buf, dtype=np.int16, count=count,
                              offset=pos).reshape(dims).copy()
        return torch.from_numpy(words).view(torch.bfloat16), pos + 2 * count
    if code not in _DTYPES:
        raise ValueError(f"unsupported VarType data_type {code}")
    dtype = _DTYPES[code]
    nbytes = count * np.dtype(dtype).itemsize
    arr = np.frombuffer(buf, dtype=dtype, count=count,
                        offset=pos).reshape(dims)
    return arr, pos + nbytes


def load_combined_params(data, names_sorted):
    """The .pdiparams stream: tensors concatenated in sorted-name order
    (io.py:661)."""
    out, pos = {}, 0
    for name in names_sorted:
        arr, pos = read_lod_tensor(data, pos)
        out[name] = arr
    if pos != len(data):
        raise ValueError(
            f"params stream has {len(data) - pos} trailing bytes — "
            "persistable-name set mismatch")
    return out


# ---------------------------------------------------------- op translation --

def _same_pads(in_size, stride, ksize):
    out = -(-in_size // stride)
    total = max((out - 1) * stride + ksize - in_size, 0)
    return total // 2, total - total // 2


def _conv2d(ins, attrs):
    x, w = ins["Input"], ins["Filter"]
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1) or 1
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        # reference UpdatePaddingAndDilation: SAME forces dilation 1 and
        # pads for the raw kernel
        dil = [1, 1]
        ph = _same_pads(x.shape[2], strides[0], w.shape[2])
        pw = _same_pads(x.shape[3], strides[1], w.shape[3])
    elif algo == "VALID":
        ph = pw = (0, 0)
    elif len(pads) == 2:
        ph, pw = (pads[0], pads[0]), (pads[1], pads[1])
    else:
        ph, pw = (pads[0], pads[1]), (pads[2], pads[3])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return tF.conv2d(x, w, None, tuple(strides), (ph[0], pw[0]),
                         tuple(dil), groups)
    x = tF.pad(x, [pw[0], pw[1], ph[0], ph[1]])
    return tF.conv2d(x, w, None, tuple(strides), 0, tuple(dil), groups)


def _pool2d(ins, attrs):
    """Delegates to the registered pool2d body (ops/pool_ops.py) — one
    pooling implementation, including adaptive output sizes, ceil_mode,
    and exclusive in-bounds averaging; the importer only resolves the
    legacy padding_algorithm to explicit pads."""
    x = ins["X"]
    ksize = attrs.get("ksize", [2, 2])
    strides = attrs.get("strides", ksize)
    pads = list(attrs.get("paddings", [0, 0]))
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "VALID":
        pads = [0, 0]
    elif algo == "SAME":
        ph = _same_pads(x.shape[2], strides[0], ksize[0])
        pw = _same_pads(x.shape[3], strides[1], ksize[1])
        pads = [ph[0], ph[1], pw[0], pw[1]]
    return _registry_op(
        "pool2d", x, ksize, strides=strides, paddings=pads,
        ceil_mode=attrs.get("ceil_mode", False),
        exclusive=attrs.get("exclusive", True),
        pooling_type=attrs.get("pooling_type", "max"),
        global_pooling=attrs.get("global_pooling", False),
        adaptive=attrs.get("adaptive", False))


def _reshape2(ins, attrs):
    if any(k in ins for k in ("Shape", "ShapeTensor")):
        raise NotImplementedError(
            "reshape2 with a tensor-valued shape is not translated — "
            "the attr would be stale; re-export with a static shape")
    shape = attrs.get("shape")
    if shape is None:
        raise NotImplementedError(
            "reshape2 without a shape attr is not translated")
    x = ins["X"]
    if 0 in shape:   # 0 = copy the corresponding input dim
        if any(d == 0 and i >= x.dim() for i, d in enumerate(shape)):
            # reference InferShape rejects this; fabricating a size-1
            # dim here would silently diverge from the runtime
            raise ValueError(
                f"reshape2: shape attr {list(shape)} uses 0 (copy input "
                f"dim) at an index >= input rank {x.dim()}")
        shape = [s if d == 0 else d
                 for d, s in zip(shape, list(x.shape) + [1] * len(shape))]
    return x.reshape(shape)


def _fill_constant(ins, attrs, dev):
    code = attrs.get("dtype", 5)
    dt = _torch_dtype(code)
    val = attrs.get("value", 0.0)
    sv = attrs.get("str_value", "")
    if sv:
        # reference semantics: the exact string attr wins over the
        # float32 `value`, which rounds integers above 2^24
        val = float(sv) if (dt.is_floating_point) else int(sv)
    elif not dt.is_floating_point and dt != torch.bool:
        val = int(val)
    return torch.full(list(attrs.get("shape", [])), val, dtype=dt,
                      device=dev)


def _cat(fn, ins, attrs):
    if "AxisTensor" in ins:
        raise NotImplementedError(
            "concat/stack with a tensor-valued axis is not translated — "
            "re-export with a static axis")
    return fn(ins["__X_all__"], attrs.get("axis", 0))


def _eltwise(fn):
    def run(ins, attrs):
        x, y = ins["X"], ins["Y"]
        axis = attrs.get("axis", -1)
        if y.dim() < x.dim():
            if axis is None or axis == -1:
                axis = x.dim() - y.dim()
            y = y.reshape(tuple(y.shape) + (1,) * (x.dim() - y.dim() - axis))
        return fn(x, y)
    return run


def _dims(x, dims):
    return tuple(range(x.dim())) if dims is None else tuple(dims)


def _sum(x, dims, keep):
    return torch.sum(x, dim=_dims(x, dims), keepdim=keep)


def _mean(x, dims, keep):
    return torch.mean(x, dim=_dims(x, dims), keepdim=keep)


def _amax(x, dims, keep):
    return torch.amax(x, dim=_dims(x, dims), keepdim=keep)


def _amin(x, dims, keep):
    return torch.amin(x, dim=_dims(x, dims), keepdim=keep)


def _prod(x, dims, keep):
    for d in sorted((a % max(x.dim(), 1) for a in _dims(x, dims)),
                    reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


def _reduce(fn):
    def run(ins, attrs):
        dims = attrs.get("dim", [0])
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            return fn(ins["X"], None, keep)
        if not dims:
            # an empty dim list reduces nothing, as in JAX (torch reads
            # dim=() as every dim): reduce a new unit axis instead
            return fn(ins["X"].unsqueeze(0), [0], False)
        return fn(ins["X"], dims, keep)
    return run


def _act(fn):
    return lambda ins, attrs: fn(ins["X"])


def _matmul(ins, attrs):
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", attrs.get("trans_x", False)):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", attrs.get("trans_y", False)):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    return out * alpha if alpha != 1.0 else out


def _mul(ins, attrs):
    x, y = ins["X"], ins["Y"]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), -1)
    y2 = y.reshape(int(np.prod(ys[:yn])), -1)
    return (x2 @ y2).reshape(xs[:xn] + ys[yn:])


def _batch_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[axis] = -1
    mean = ins["Mean"].reshape(shape)
    var = ins["Variance"].reshape(shape)
    scale = ins["Scale"].reshape(shape)
    bias = ins["Bias"].reshape(shape)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _layer_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    ax = attrs.get("begin_norm_axis", 1)
    red = tuple(range(ax, x.dim()))
    mu = x.mean(red, keepdim=True)
    var = torch.square(x - mu).mean(red, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    tail = tuple(x.shape[ax:])
    if "Scale" in ins:
        y = y * ins["Scale"].reshape(tail)
    if "Bias" in ins:
        y = y + ins["Bias"].reshape(tail)
    return y


def _dropout(ins, attrs):
    x = ins["X"]
    if attrs.get("dropout_implementation",
                 "downgrade_in_infer") == "upscale_in_train":
        return x
    return x * (1.0 - attrs.get("dropout_prob", 0.5))


def _slice(ins, attrs):
    x = ins["Input"]
    if any(k in ins for k in ("StartsTensor", "EndsTensor",
                              "StartsTensorList", "EndsTensorList")):
        raise NotImplementedError(
            "slice with tensor-valued starts/ends is not translated — "
            "the attrs would be stale; re-export with static bounds")
    axes = attrs.get("axes", [])
    starts = attrs.get("starts", [])
    ends = attrs.get("ends", [])
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = slice(s, min(e, x.shape[a]))
    out = x[tuple(idx)]
    dec = attrs.get("decrease_axis", [])
    if dec:
        out = out.reshape([d for i, d in enumerate(out.shape)
                           if i not in dec])
    return out


def _interp(mode):
    def run(ins, attrs):
        if any(k in ins for k in ("OutSize", "SizeTensor", "Scale")):
            raise NotImplementedError(
                f"{mode}_interp with tensor-valued output size is not "
                "translated — re-export with static out_h/out_w")
        x = ins["X"]
        oh = attrs.get("out_h", -1)
        ow = attrs.get("out_w", -1)
        scale = attrs.get("scale", [])
        if oh <= 0 and scale:
            s = scale if isinstance(scale, (list, tuple)) else [scale]
            s = list(s) * 2 if len(s) == 1 else s
            oh = int(x.shape[2] * s[0])
            ow = int(x.shape[3] * s[1])
        # the port's vision interp carries the reference's align_corners
        # / align_mode semantics exactly (ops/vision_ops.py)
        from ..ops.vision_ops import _interp_impl

        return _interp_impl(
            x, mode, [oh, ow], None,
            attrs.get("align_corners", False),
            attrs.get("align_mode", 1), "NCHW")
    return run


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                                     device=x.device)),
                         torch.full((), hi, dtype=x.dtype, device=x.device))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_TRANSLATORS = {
    "mul": _mul,
    "matmul": _matmul,
    "matmul_v2": _matmul,
    "elementwise_add": _eltwise(torch.add),
    "elementwise_sub": _eltwise(torch.sub),
    "elementwise_mul": _eltwise(torch.mul),
    "elementwise_div": _eltwise(torch.div),
    "elementwise_pow": _eltwise(torch.pow),
    "elementwise_max": _eltwise(torch.maximum),
    "elementwise_min": _eltwise(torch.minimum),
    "relu": _act(torch.relu),
    "relu6": _act(lambda x: _clip(x, 0, 6)),
    "sigmoid": _act(torch.sigmoid),
    "tanh": _act(torch.tanh),
    "sqrt": _act(torch.sqrt),
    "exp": _act(torch.exp),
    "abs": _act(torch.abs),
    "log": _act(torch.log),
    "square": _act(torch.square),
    "erf": _act(torch.erf),
    "gelu": lambda ins, attrs: tF.gelu(
        ins["X"], approximate="tanh" if attrs.get("approximate", False)
        else "none"),
    "leaky_relu": lambda ins, attrs: tF.leaky_relu(
        ins["X"], attrs.get("alpha", 0.02)),
    "hard_sigmoid": lambda ins, attrs: _clip(
        attrs.get("slope", 0.2) * ins["X"] + attrs.get("offset", 0.5),
        0.0, 1.0),
    "hard_swish": lambda ins, attrs: ins["X"] * _clip(
        ins["X"] + attrs.get("offset", 3.0), 0.0,
        attrs.get("threshold", 6.0)) / attrs.get("scale", 6.0),
    "swish": lambda ins, attrs: ins["X"] * torch.sigmoid(
        attrs.get("beta", 1.0) * ins["X"]),
    "pow": lambda ins, attrs: torch.pow(ins["X"],
                                        attrs.get("factor", 1.0)),
    "clip": lambda ins, attrs: _clip(ins["X"], attrs.get("min", 0.0),
                                     attrs.get("max", 1.0)),
    "softmax": lambda ins, attrs: torch.softmax(
        ins["X"], dim=attrs.get("axis", -1)),
    "scale": lambda ins, attrs: (
        ins["X"] * attrs.get("scale", 1.0) + attrs.get("bias", 0.0)
        if attrs.get("bias_after_scale", True)
        else (ins["X"] + attrs.get("bias", 0.0)) * attrs.get("scale", 1.0)),
    "conv2d": _conv2d,
    "depthwise_conv2d": _conv2d,
    "pool2d": _pool2d,
    "batch_norm": _batch_norm,
    "layer_norm": _layer_norm,
    "dropout": _dropout,
    "reshape2": lambda ins, attrs: _reshape2(ins, attrs),
    "transpose2": lambda ins, attrs: ins["X"].permute(list(attrs["axis"])),
    "concat": lambda ins, attrs: _cat(torch.cat, ins, attrs),
    "stack": lambda ins, attrs: _cat(torch.stack, ins, attrs),
    "squeeze2": lambda ins, attrs: _squeeze(ins["X"],
                                            attrs.get("axes", [])),
    "unsqueeze2": lambda ins, attrs: _expand_dims(ins["X"],
                                                  attrs.get("axes", [])),
    "flatten_contiguous_range": lambda ins, attrs: ins["X"].reshape(
        tuple(ins["X"].shape[:attrs.get("start_axis", 1)])
        + (-1,) + tuple(ins["X"].shape[attrs.get("stop_axis", -1) %
                                       ins["X"].dim() + 1:])),
    "flatten2": lambda ins, attrs: ins["X"].reshape(
        int(np.prod(ins["X"].shape[:attrs.get("axis", 1)])), -1),
    "slice": _slice,
    "cast": lambda ins, attrs: ins["X"].to(
        _torch_dtype(attrs.get("out_dtype", 5))),
    "shape": lambda ins, attrs: _int_vector(list(ins["Input"].shape),
                                            ins["Input"].device),
    "fill_constant": None,            # needs the device: see _run_ops
    "assign": lambda ins, attrs: ins["X"],
    "lookup_table_v2": lambda ins, attrs: tF.embedding(ins["Ids"],
                                                       ins["W"]),
    "reduce_mean": _reduce(_mean),
    "reduce_sum": _reduce(_sum),
    "reduce_max": _reduce(_amax),
    "arg_max": lambda ins, attrs: _arg_reduce(torch.argmax, ins, attrs),
    "nearest_interp_v2": _interp("nearest"),
    "bilinear_interp_v2": _interp("bilinear"),
    "equal": _eltwise(torch.eq),
    "greater_than": _eltwise(torch.gt),
    "silu": _act(tF.silu),
    "mish": lambda ins, attrs: ins["X"] * torch.tanh(_softplus(ins["X"])),
    "softplus": lambda ins, attrs: _softplus(
        attrs.get("beta", 1.0) * ins["X"]) / attrs.get("beta", 1.0),
    "floor": _act(torch.floor),
    "rsqrt": _act(torch.rsqrt),
    "prelu": lambda ins, attrs: _prelu(ins, attrs),
    # jnp.mod / floor_divide: floor semantics, as torch's remainder
    "elementwise_mod": _eltwise(torch.remainder),
    "elementwise_floordiv": _eltwise(
        lambda a, b: torch.div(a, b, rounding_mode="floor")),
    "reduce_min": _reduce(_amin),
    "reduce_prod": _reduce(_prod),
    "logsumexp": lambda ins, attrs: torch.logsumexp(
        ins["X"],
        dim=(tuple(range(ins["X"].dim()))
             if attrs.get("reduce_all", False)
             else tuple(attrs.get("axis", [0]))),
        keepdim=attrs.get("keepdim", False)),
    "pad3d": lambda ins, attrs: _pad3d(ins, attrs),
    "split": lambda ins, attrs: _split(ins, attrs),
    "top_k_v2": lambda ins, attrs: _topk(ins, attrs),
    "expand_v2": lambda ins, attrs: _expand_v2(ins, attrs),
    "tile": lambda ins, attrs: _tile(ins, attrs),
    "gather": lambda ins, attrs: _gather(ins, attrs),
    "instance_norm": lambda ins, attrs: _instance_norm(ins, attrs),
    "group_norm": lambda ins, attrs: _group_norm(ins, attrs),
    # comparison / logical / selection family (the export side emits
    # these from the eq/gt/lt/ge/le/ne/and/or/xor/select nodes)
    "less_than": _eltwise(torch.lt),
    "less_equal": _eltwise(torch.le),
    "greater_equal": _eltwise(torch.ge),
    "not_equal": _eltwise(torch.ne),
    "logical_and": _eltwise(torch.logical_and),
    "logical_or": _eltwise(torch.logical_or),
    "logical_xor": _eltwise(torch.logical_xor),
    "logical_not": _act(torch.logical_not),
    "where": lambda ins, attrs: torch.where(ins["Condition"].to(torch.bool),
                                            ins["X"], ins["Y"]),
    "sign": _act(torch.sign),
    "log1p": _act(torch.log1p),
    "log2": _act(torch.log2),
    "log10": _act(torch.log10),
    "sin": _act(torch.sin),
    "cos": _act(torch.cos),
    "tan": _act(torch.tan),
    "asin": _act(torch.asin),
    "acos": _act(torch.acos),
    "atan": _act(torch.atan),
    "sinh": _act(torch.sinh),
    "cosh": _act(torch.cosh),
    "ceil": _act(torch.ceil),
    # reference round is std::round (half AWAY from zero); torch.round
    # is banker's rounding and diverges at .5 ties
    "round": _act(lambda x: torch.where(x >= 0, torch.floor(x + 0.5),
                                        torch.ceil(x - 0.5))),
    "reciprocal": _act(torch.reciprocal),
    "arg_min": lambda ins, attrs: _arg_reduce(torch.argmin, ins, attrs),
    "cumsum": lambda ins, attrs: _cumsum(ins, attrs),
    "p_norm": lambda ins, attrs: _p_norm(ins, attrs),
    "softsign": _act(lambda x: x / (1 + torch.abs(x))),
    "elu": lambda ins, attrs: tF.elu(ins["X"], attrs.get("alpha", 1.0)),
    "selu": lambda ins, attrs: attrs.get("scale", 1.0507009873554805)
    * torch.where(ins["X"] > 0, ins["X"],
                  attrs.get("alpha", 1.6732632423543772)
                  * (torch.exp(ins["X"]) - 1)),
    "maximum": _eltwise(torch.maximum),
    "minimum": _eltwise(torch.minimum),
    "pad": lambda ins, attrs: _pad(ins, attrs),
    # detection family (PP-YOLO/SSD-class deployments) — delegates to
    # the registered op bodies.  DOCUMENTED DIVERGENCE: reference NMS
    # outputs are ragged LoD tensors; the ops return statically-shaped
    # keep_top_k padding (invalid rows marked -1), as in the JAX
    # package.
    "conv2d_transpose": lambda ins, attrs: _conv2d_transpose(ins, attrs),
    "depthwise_conv2d_transpose": lambda ins, attrs: _conv2d_transpose(
        ins, attrs),
    "yolo_box": lambda ins, attrs: _registry_op(
        "yolo_box", ins["X"], ins["ImgSize"],
        anchors=list(attrs["anchors"]),
        class_num=attrs["class_num"],
        conf_thresh=attrs.get("conf_thresh", 0.01),
        downsample_ratio=attrs.get("downsample_ratio", 32),
        clip_bbox=attrs.get("clip_bbox", True),
        scale_x_y=attrs.get("scale_x_y", 1.0),
        iou_aware=attrs.get("iou_aware", False),
        iou_aware_factor=attrs.get("iou_aware_factor", 0.5)),
    "multiclass_nms3": lambda ins, attrs: _registry_op(
        "multiclass_nms3", ins["BBoxes"], ins["Scores"],
        rois_num=ins.get("RoisNum"),
        score_threshold=attrs.get("score_threshold", 0.05),
        nms_top_k=attrs.get("nms_top_k", -1),
        keep_top_k=attrs.get("keep_top_k", 100),
        nms_threshold=attrs.get("nms_threshold", 0.3),
        normalized=attrs.get("normalized", True),
        nms_eta=attrs.get("nms_eta", 1.0),
        background_label=attrs.get("background_label", -1)),
    "prior_box": lambda ins, attrs: _registry_op(
        "prior_box", ins["Input"], ins["Image"],
        min_sizes=list(attrs["min_sizes"]),
        max_sizes=list(attrs.get("max_sizes", [])) or None,
        aspect_ratios=list(attrs.get("aspect_ratios", [1.0])),
        variances=list(attrs.get("variances",
                                 [0.1, 0.1, 0.2, 0.2])),
        flip=attrs.get("flip", False),
        clip=attrs.get("clip", False),
        steps=(attrs.get("step_w", 0.0), attrs.get("step_h", 0.0)),
        offset=attrs.get("offset", 0.5),
        min_max_aspect_ratios_order=attrs.get(
            "min_max_aspect_ratios_order", False)),
    "box_coder": lambda ins, attrs: _registry_op(
        "box_coder", ins["PriorBox"], ins.get("PriorBoxVar"),
        ins["TargetBox"],
        code_type=attrs.get("code_type", "encode_center_size"),
        box_normalized=attrs.get("box_normalized", True),
        axis=attrs.get("axis", 0),
        variance=list(attrs.get("variance", [])) or None),
}


def _registry_op(name, *args, **kwargs):
    from ..ops.registry import OPS

    return OPS[name].body(*args, **kwargs)


def _int_vector(vals, dev, dtype=torch.int32):
    """A 1-D integer tensor of host ints, built from ``aten.full`` nodes
    (no tensor constant: one would break a ``while_loop`` replay)."""
    return torch.stack([torch.full((), int(v), dtype=dtype, device=dev)
                        for v in vals]) if vals else \
        torch.zeros((0,), dtype=dtype, device=dev)


def _squeeze(x, axes):
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(a % x.dim() for a in axes))


def _expand_dims(x, axes):
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def _conv2d_transpose(ins, attrs):
    if attrs.get("padding_algorithm", "EXPLICIT") != "EXPLICIT":
        raise NotImplementedError(
            "conv2d_transpose SAME/VALID padding_algorithm is not "
            "translated; re-export with explicit paddings")
    out_pad = list(attrs.get("output_padding", []) or [0, 0])
    strides = list(attrs.get("strides", [1, 1]))
    pads = list(attrs.get("paddings", [0, 0]))
    dil = list(attrs.get("dilations", [1, 1]))
    out_size = attrs.get("output_size", []) or []
    if out_size:
        # real programs may carry output_size instead of
        # output_padding: convert (out_pad = target - minimal size)
        x, w = ins["Input"], ins["Filter"]
        p2 = pads if len(pads) == 2 else [pads[0], pads[2]]
        for d in range(2):
            k_eff = (w.shape[2 + d] - 1) * dil[d] + 1
            minimal = (x.shape[2 + d] - 1) * strides[d] \
                - 2 * p2[d] + k_eff
            op_d = int(out_size[d]) - minimal
            if not 0 <= op_d < strides[d] or (out_pad[d] and
                                              out_pad[d] != op_d):
                raise NotImplementedError(
                    f"conv2d_transpose output_size {out_size} is not "
                    "reachable from the op's strides/paddings")
            out_pad[d] = op_d
    return _registry_op(
        "conv2d_transpose", ins["Input"], ins["Filter"],
        stride=strides, padding=pads, output_padding=out_pad,
        dilation=dil, groups=attrs.get("groups", 1) or 1)


def _arg_reduce(fn, ins, attrs):
    """Shared arg_max/arg_min attr handling (flatten/dtype/keepdims)."""
    x = ins["X"]
    dt = _torch_dtype(attrs.get("dtype", 3), 3)
    if attrs.get("flatten", False):
        return fn(x.reshape(-1)).to(dt)
    return fn(x, dim=attrs.get("axis", -1),
              keepdim=attrs.get("keepdims", False)).to(dt)


def _cumsum(ins, attrs):
    x = ins["X"]
    if attrs.get("flatten", False):
        x = x.reshape(-1)
    axis = attrs.get("axis", -1)
    if attrs.get("reverse", False):
        x = torch.flip(x, (axis,))
    # the reference op keeps its input's dtype (torch widens integers)
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        out = out - x          # exclusive = inclusive minus current
    if attrs.get("reverse", False):
        out = torch.flip(out, (axis,))
    return out


def _p_norm(ins, attrs):
    x = ins["X"]
    p = attrs.get("porder", 2.0)
    # the reference op declares SetDefault(-1) for axis; only
    # asvector=True flattens
    axis = attrs.get("axis", -1)
    keep = attrs.get("keepdim", False)
    if attrs.get("asvector", False):
        x = x.reshape(-1)
        axis = 0
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keep)


def _prelu(ins, attrs):
    # only the reference's 'channel' (and scalar 'all') modes on NCHW
    # translate; element mode / NHWC would scale the wrong axis
    if attrs.get("mode", "channel") not in ("channel", "all"):
        raise NotImplementedError(
            f"prelu mode {attrs.get('mode')!r} is not translated")
    if attrs.get("data_format", "NCHW") != "NCHW":
        raise NotImplementedError("prelu: only NCHW is translated")
    x, alpha = ins["X"], ins["Alpha"]
    shape = ((1, -1) + (1,) * (x.dim() - 2)) if alpha.numel() > 1 \
        else tuple(alpha.shape)
    return torch.where(x >= 0, x, x * alpha.reshape(shape))


def _expand_v2(ins, attrs):
    if any(k in ins for k in ("Shape", "expand_shapes_tensor")):
        raise NotImplementedError(
            "expand_v2 with a tensor-valued shape is not translated")
    x = ins["X"]
    tgt = attrs["shape"]
    padded = (1,) * (len(tgt) - x.dim()) + tuple(x.shape)
    return torch.broadcast_to(
        x, [d if s == -1 else s for s, d in zip(tgt, padded)])


def _tile(ins, attrs):
    if any(k in ins for k in ("RepeatTimes", "repeat_times_tensor")):
        raise NotImplementedError(
            "tile with tensor-valued repeat_times is not translated")
    return torch.tile(ins["X"], tuple(attrs.get("repeat_times", [1])))


def _gather(ins, attrs):
    if "Axis" in ins:
        raise NotImplementedError(
            "gather with a tensor-valued axis is not translated")
    return torch.index_select(ins["X"], attrs.get("axis", 0),
                              ins["Index"].reshape(-1))


def _pad(ins, attrs):
    x = ins["X"]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return tF.pad(x, flat, value=attrs.get("pad_value", 0.0))


def _pad3d(ins, attrs):
    if "Paddings" in ins:
        raise NotImplementedError(
            "pad3d with tensor-valued paddings is not translated")
    x = ins["X"]
    p = attrs.get("paddings", [0] * 6)   # (l, r, t, b, f, bk) NCDHW
    mode = attrs.get("mode", "constant")
    if attrs.get("data_format", "NCDHW") != "NCDHW":
        raise NotImplementedError("pad3d: only NCDHW is translated")
    flat = [p[0], p[1], p[2], p[3], p[4], p[5]]
    if mode == "constant":
        return tF.pad(x, flat, value=attrs.get("value", 0.0))
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}.get(mode)
    if tmode is None:
        raise NotImplementedError(f"pad3d mode {mode!r}")
    return tF.pad(x, flat, mode=tmode)


def _split(ins, attrs):
    if "AxisTensor" in ins or "SectionsTensorList" in ins:
        raise NotImplementedError(
            "split with tensor-valued axis/sections is not translated")
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        # -1 means "the rest" (at most one, reference semantics)
        total = x.shape[axis]
        known = sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
        return tuple(torch.split(x, sections, dim=axis))
    num = attrs.get("num", 1)
    return tuple(torch.split(x, x.shape[axis] // num, dim=axis))


def _topk(ins, attrs):
    if "K" in ins:
        raise NotImplementedError(
            "top_k_v2 with a tensor-valued k is not translated")
    x = ins["X"]
    k = attrs.get("k", 1)
    axis = attrs.get("axis", -1)
    largest = attrs.get("largest", True)
    # lax.top_k's order: values by rank, a tie at the lower index first
    vals, idxs = torch.sort(x, dim=axis, descending=largest, stable=True)
    vals = vals.narrow(axis, 0, k)
    idxs = idxs.narrow(axis, 0, k).to(torch.int64)
    return vals, idxs


def _instance_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    red = tuple(range(2, x.dim()))
    mu = x.mean(red, keepdim=True)
    var = torch.square(x - mu).mean(red, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if "Scale" in ins:
        y = y * ins["Scale"].reshape(shape)
    if "Bias" in ins:
        y = y + ins["Bias"].reshape(shape)
    return y


def _group_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    g = attrs.get("groups", 1)
    if attrs.get("data_layout", "NCHW") != "NCHW":
        raise NotImplementedError("group_norm: only NCHW is translated")
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    mu = xg.mean(red, keepdim=True)
    var = torch.square(xg - mu).mean(red, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if "Scale" in ins:
        y = y * ins["Scale"].reshape(shape)
    if "Bias" in ins:
        y = y + ins["Bias"].reshape(shape)
    return y


# ops whose outputs span several parameters, bound in this order
_MULTI_OUT_PARAMS = {
    "top_k_v2": ("Out", "Indices"),
    "yolo_box": ("Boxes", "Scores"),
    "multiclass_nms3": ("Out", "Index", "NmsRoisNum"),
    "prior_box": ("Boxes", "Variances"),
}


def supported_ops():
    return sorted(set(_TRANSLATORS) | _CONTROL_OPS) + ["feed", "fetch"]


# control-flow op types handled structurally by InferenceProgram (not
# through _TRANSLATORS): reference conditional_block_op.cc, while_op.cc,
# select_input_op.cc
_CONTROL_OPS = {"conditional_block", "while", "select_input"}


_BARRIER = None


def _while_barrier():
    """``paddle_tpu_import::while_barrier``: the identity on a value a
    ``while`` carried out, whose backward raises — ``lax.while_loop``
    has no reverse-mode gradient, and neither has an imported
    ``while``."""
    global _BARRIER
    if _BARRIER is not None:
        return _BARRIER

    @torch.library.custom_op("paddle_tpu_import::while_barrier",
                             mutates_args=())
    def while_barrier(x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    @while_barrier.register_fake
    def _(x):
        return torch.empty_like(x)

    def backward(ctx, grad):
        raise ValueError(
            "Reverse-mode differentiation does not work for an imported "
            "while op (lax.while_loop's rule): a traced while_loop has "
            "no reverse-mode gradient")

    while_barrier.register_autograd(backward)
    _BARRIER = while_barrier
    return while_barrier


def _param_tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    arr = np.asarray(v)
    return torch.from_numpy(np.array(arr)).to(device)


def _unwrap(v):
    return getattr(v, "_data", v)


class InferenceProgram:
    """A translated inference program: callable over the feed vars
    (positional, in feed-op ``col`` order) returning the fetch list.
    Traced once per input-shape signature (module docstring).

    ``params`` live on the port's current device, where ``jit.load``
    puts a loaded model's state."""

    def __init__(self, ops, var_descs, params, blocks=None):
        from ..framework.device import current_device
        from ..jit import StaticFunction

        self.var_descs = var_descs
        self.device = current_device()
        self.params = {k: _param_tensor(v, self.device)
                       for k, v in params.items()}
        self.blocks = blocks or []
        self.feed_names = []
        self.fetch_names = []
        self.body = []
        feeds, fetches = {}, {}
        unknown = []
        for op in ops:
            if op.type == "feed":
                feeds[op.attrs.get("col", 0)] = op.outputs["Out"][0]
            elif op.type == "fetch":
                fetches[op.attrs.get("col", 0)] = op.inputs["X"][0]
            else:
                self._check_op(op, _unknown=unknown)
                self.body.append(op)
        if unknown:
            # every missing translation in ONE error, with the output
            # var names, so a port gap is actionable in a single pass
            # (framework.analysis G001 reads the same shape of report)
            detail = "; ".join(
                f"'{t}' -> [{', '.join(outs) or '<no outputs>'}]"
                for t, outs in unknown)
            raise NotImplementedError(
                f"{len(unknown)} ProgramDesc op(s) have no translation "
                f"({len(_TRANSLATORS)} ops supported — see "
                f"static.program_import): {detail}")
        self.feed_names = [feeds[k] for k in sorted(feeds)]
        self.fetch_names = [fetches[k] for k in sorted(fetches)]
        # the jax.jit of the JAX package: one trace per signature
        self._jitted = StaticFunction(self._run)

    def _check_op(self, op, depth=0, _unknown=None):
        if op.type in _CONTROL_OPS:
            sub = op.attrs.get("sub_block")
            if sub is not None:
                if not 0 <= sub < len(self.blocks):
                    raise ValueError(
                        f"{op.type} references sub_block {sub} but the "
                        f"program has {len(self.blocks)} blocks")
                if depth > 16:
                    raise NotImplementedError(
                        "control-flow nesting deeper than 16 blocks")
                for sop in self.blocks[sub][0]:
                    self._check_op(sop, depth + 1, _unknown=_unknown)
            return
        if op.type not in _TRANSLATORS:
            outs = [a for args in op.outputs.values() for a in args]
            if _unknown is not None:
                _unknown.append((op.type, outs))
                return
            raise NotImplementedError(
                f"ProgramDesc op '{op.type}' has no translation "
                f"({len(_TRANSLATORS)} ops supported — see "
                "static.program_import)")

    def _run(self, params, *feed_vals):
        env = dict(params)
        for name, val in zip(self.feed_names, feed_vals):
            env[name] = val
        self._run_ops(self.body, env)
        return [env[n] for n in self.fetch_names]

    def apply(self, params, *feed_vals):
        """The program on explicit ``params`` (name -> torch tensor) and
        torch feeds, as one traced call; differentiable, as the JAX
        ``apply`` is under ``jax.vjp``."""
        return list(self._jitted(dict(params), *feed_vals))

    def _run_ops(self, ops, env):
        for op in ops:
            if op.type == "conditional_block":
                self._run_cond_block(op, env)
                continue
            if op.type == "while":
                self._run_while(op, env)
                continue
            if op.type == "select_input":
                self._run_select_input(op, env)
                continue
            ins = {}
            for param, args in op.inputs.items():
                if not args:
                    continue
                ins[param] = env[args[0]]
                if param == "X" and (len(args) > 1 or
                                     op.type in ("concat", "stack")):
                    ins["__X_all__"] = [env[a] for a in args]
            if op.type == "fill_constant":
                out = _fill_constant(ins, op.attrs, self._dev(env))
            else:
                out = _TRANSLATORS[op.type](ins, op.attrs)
            outs = out if isinstance(out, tuple) else (out,)
            # the primary output parameter varies by legacy op family
            # (Out / Output / Y); ops with several REAL output params
            # (top_k's values + indices) list them in order here, while
            # secondary outputs like XShape are trace metadata and stay
            # unbound
            multi = _MULTI_OUT_PARAMS.get(op.type)
            if multi:
                names = []
                for param in multi:
                    names.extend(op.outputs.get(param, []))
            else:
                names = (op.outputs.get("Out")
                         or op.outputs.get("Output")
                         or op.outputs.get("Y") or [])
            for name, val in zip(names, outs):
                env[name] = _unwrap(val)

    def _dev(self, env):
        for v in env.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return self.device

    def _run_cond_block(self, op, env):
        """conditional_block: run sub_block iff Cond; the untaken branch
        yields zeros (the paired select_input never picks them)."""
        from . import cond

        if not op.attrs.get("is_scalar_condition", True):
            raise NotImplementedError(
                "conditional_block with is_scalar_condition=False "
                "(run-if-nonempty semantics) is not translated")
        pred = env[op.inputs["Cond"][0]].reshape(()).to(torch.bool)
        sub_ops = self.blocks[op.attrs["sub_block"]][0]
        out_names = list(op.outputs.get("Out", []))

        def taken():
            env2 = dict(env)
            self._run_ops(sub_ops, env2)
            return tuple(env2[n] for n in out_names)

        # the outputs' shapes from one pass in the enclosing trace (its
        # nodes are dead and go with the trace's dead code)
        avals = [(tuple(o.shape), o.dtype, o.device) for o in taken()]

        def untaken():
            return tuple(torch.zeros(s, dtype=d, device=dv)
                         for s, d, dv in avals)

        res = cond(pred, taken, untaken)
        res = res if isinstance(res, (tuple, list)) else (res,)
        for name, val in zip(out_names, res):
            env[name] = _unwrap(val)

    def _run_while(self, op, env):
        """while: loop-carried vars = sub-block-written names that
        pre-exist in the parent env (reference scope semantics), plus
        the Condition var the sub-block recomputes each iteration."""
        from . import while_loop

        sub_ops = self.blocks[op.attrs["sub_block"]][0]
        cond_name = op.inputs["Condition"][0]
        written = set()
        for sop in sub_ops:
            for names in sop.outputs.values():
                written.update(names)
        carried = sorted(n for n in written | {cond_name} if n in env)
        if cond_name not in carried:
            raise ValueError(
                f"while Condition var {cond_name!r} has no initial "
                "value in the enclosing scope")
        ci = carried.index(cond_name)

        def cond_f(*carry):
            return _unwrap(carry[ci]).reshape(()).to(torch.bool)

        def body_f(*carry):
            env2 = dict(env)
            env2.update(zip(carried, (_unwrap(c) for c in carry)))
            self._run_ops(sub_ops, env2)
            return tuple(env2[n] for n in carried)

        init = [env[n] for n in carried]
        final = while_loop(cond_f, body_f, init)
        barrier = _while_barrier()
        env.update(zip(carried, (barrier(_unwrap(v)) if _unwrap(
            v).is_floating_point() else _unwrap(v) for v in final)))

    def _run_select_input(self, op, env):
        """select_input: Out = X[Mask] (select_input_op.cc); the cond()
        lowering merges the two conditional_block results by the cast
        condition."""
        xs = [env[a] for a in op.inputs["X"]]
        mask = env[op.inputs["Mask"][0]].reshape(()).to(torch.int32)
        if len(xs) == 2:
            out = torch.where(mask.to(torch.bool), xs[1], xs[0])
        else:
            out = torch.stack(xs).index_select(
                0, mask.reshape(1).to(torch.int64))[0]
        env[op.outputs["Out"][0]] = out

    def to_layer(self):
        """Wrap this imported program as a trainable ``nn.Layer``: every
        entry of ``params`` becomes a live Parameter and the traced
        program runs with them (the backward flows through every
        translator and ``cond``; a traced ``while`` has none, as in
        JAX).  Fine-tuning an imported reference classifier =
        ``prog.to_layer()`` + any optimizer; call ``sync_to_program()``
        afterwards to write the trained weights back for re-export."""
        from ..core.tensor import _wrap
        from ..nn.layer_base import Layer, Parameter

        program = self

        class ImportedProgramLayer(Layer):
            def __init__(self):
                super().__init__()
                self._names = sorted(program.params)
                self._safe = {n: n.replace(".", "__") for n in self._names}
                for n in self._names:
                    self.add_parameter(self._safe[n],
                                       Parameter(program.params[n]))
                self.feed_names = list(program.feed_names)
                self.fetch_names = list(program.fetch_names)

            def forward(self, *feeds):
                params = {n: self._parameters[self._safe[n]]._data
                          for n in self._names}
                dev = program._dev(params)
                outs = program._jitted(
                    params, *[_feed_tensor(f, dev) for f in feeds])
                outs = [_wrap(o) for o in outs]
                return outs if len(outs) > 1 else outs[0]

            def sync_to_program(self):
                program.params = {
                    n: self._parameters[self._safe[n]]._data.detach()
                    for n in self._names}
                return program

        return ImportedProgramLayer()

    def __call__(self, *feeds):
        from ..core.tensor import _wrap

        if len(feeds) != len(self.feed_names):
            raise ValueError(
                f"program expects {len(self.feed_names)} feeds "
                f"{self.feed_names}, got {len(feeds)}")
        dev = self._dev(self.params)
        vals = [_feed_tensor(f, dev) for f in feeds]
        with torch.no_grad():
            outs = self._jitted(self.params, *vals)
        return [_wrap(o) for o in outs]


def _feed_tensor(f, dev):
    data = _unwrap(f)
    if isinstance(data, torch.Tensor):
        return data.to(dev)
    return torch.as_tensor(np.asarray(data), device=dev)


def load_reference_inference_model(path_prefix):
    """(program, feed_names, fetch_names) from model.pdmodel +
    model.pdiparams (io.py:727 parity)."""
    with open(f"{path_prefix}.pdmodel", "rb") as f:
        blocks = parse_program_blocks(f.read())
    ops, var_descs = blocks[0]
    # persistable params may be declared in any block (real exports put
    # them in block 0; be liberal); only LOD_TENSOR (7) vars live in
    # the params stream — feed/fetch holders (FEED_MINIBATCH=9 /
    # FETCH_LIST=10) and RAW vars are persistable in real exports but
    # never serialized (python/paddle/static/io.py is_persistable)
    merged = {}
    for _ops, vdescs in blocks:
        for n, d in vdescs.items():
            merged.setdefault(n, d)
    persist = sorted(n for n, d in merged.items()
                     if d["persistable"] and d["vtype"] == 7)
    params = {}
    if persist:
        with open(f"{path_prefix}.pdiparams", "rb") as f:
            params = load_combined_params(f.read(), persist)
    prog = InferenceProgram(ops, var_descs, params, blocks=blocks)
    return prog, prog.feed_names, prog.fetch_names
