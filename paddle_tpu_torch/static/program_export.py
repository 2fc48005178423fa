"""Reference-format inference model EXPORT: ``.pdmodel`` + ``.pdiparams``
(port of ``paddle_tpu/static/program_export.py``).

The other half of the interop gap (``program_import`` is the read
side): a model trained here can be handed BACK to a reference
deployment.  ``export_reference_inference_model`` traces the Layer's
forward at the declared InputSpec shapes, translates the traced program
into reference ``OpDesc`` s, and serializes the reference wire formats:

- ``.pdmodel``: ProgramDesc protobuf, field numbers per
  paddle/fluid/framework/framework.proto (the schema the importer
  parses — the two sides are written independently so round-trip tests
  cross-validate both).
- ``.pdiparams``: the combined parameter stream (tensor_util.cc
  ``TensorToStream`` records concatenated in sorted-variable-name order,
  python/paddle/static/io.py:661).

API match: python/paddle/static/io.py:442 ``save_inference_model``.

**The trace.**  The JAX exporter calls ``make_jaxpr``; the port calls
``make_fx(tracing_mode="fake")`` with one decomposition table
(:data:`DECOMPOSITIONS`: ``scaled_dot_product_attention`` to its
matmul/softmax math), the parameters and buffers as graph inputs whose
values become the persistable variables.  :func:`lower` then rewrites
the aten graph into the JAX exporter's flat equation list, in its
primitive vocabulary (``add``, ``reduce_sum``, ``broadcast_in_dim``,
``dot_general`` ...), so that the JAX exporter's peephole fusers and its
translation table (ported below with their rules unchanged) run on it:
a hand-written mean/variance LayerNorm, either gelu spelling, eval
BatchNorm and the max-subtracted softmax fuse as they fuse there and
decline where they decline.  These are the JAX exporter's own matchers,
over its equation list; ``framework/ir.py``'s passes match the aten
graph with other rules (a LayerNorm whose gamma is computed fuses there
into the kernel and declines here, where only a parameter can become a
``Scale``), so the two stay apart, as they are in the JAX package.  Ops
that already name a reference op stay
whole: ``_softmax``, ``gelu``, ``native_layer_norm``, eval
``batch_norm``, ``convolution`` (plain and transposed) and
``embedding``.  A traced ``torch.cond`` / ``while_loop`` (the port's
``static.cond`` / ``while_loop``, dy2static's too) lowers its branch and
body graphs the same way and exports as ``conditional_block`` +
``select_input`` and ``while`` sub-blocks.  Input-independent values
(an ``arange``, a causal mask) fold to constants at export time, as the
JAX exporter folds ``iota``.

**Pools.**  The port's pools are compositions (a fill-pad and an
``unfold`` an axis, then ``first_max``, ``ops/pool_ops.py``) where JAX
has one ``reduce_window``.  Matching that composition in the aten graph
would be a fragile pattern over a dozen nodes, so the exporter keeps
the pool's entry whole instead: inside its trace, and in that trace's
context only (``pool_ops.routed_windows``), the port's
``window_reduce`` (the one function every max/avg pool of the port and
its tiling adaptive pools go through) returns the op
``paddle_tpu_export::reduce_window``, whose eager body is the very
same composition and whose node carries the window, strides and pads —
JAX's ``reduce_window_max`` / ``reduce_window_sum`` — and exports as
``pool2d`` by the JAX rules.  Nothing changes for ``to_static``, the
eager path or another thread.  A clip (``ops/math.jclip``) is
``maximum`` then ``minimum``, as ``jnp.clip`` is, and exports as JAX
exports it; so does the port's ``relu6``, a ``where`` over a clamp
whose value is the clamp's.

**Kernels refuse.**  A ``paddle_tpu_torch::`` kernel op in the trace (a
model on the card: GPT's flash attention, every LayerNorm) refuses with
the JAX exporter's ``pallas_call`` message, the kernel named in place of
"Pallas"; export such a model from a CPU copy, where the kernels are
off, as the JAX package exports from its CPU.

**The JAX grammar, unchanged.**  Dynamic batch: InputSpec dims of
None/-1 trace at a placeholder extent (the prime ``_BATCH``) and are
re-encoded as -1 in VarDesc dims / 0 or -1 in ``reshape2`` shape attrs;
a concrete dim equal to it refuses.  Scalar literals fold into
``scale``/``pow``/``relu``; ``fill_constant`` appears only where the
JAX exporter emits it; an ``expand`` whose consumers are elementwise is
dropped and a real expansion emits ``expand_v2``; a tied constant
serializes once; an unsupported op refuses by name.  torch's integer
index values are int64 where JAX's are int32: a ``cumsum`` keeps its
input's dtype as the reference op does.  Tracing leaves the port's
random generators as they were.
"""

import contextlib
import operator
import struct

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

_BATCH = 977  # prime placeholder extent for dynamic (None/-1) dims

# VarType.Type enum (framework.proto)
_VT = {np.dtype(np.bool_): 0, np.dtype(np.int16): 1,
       np.dtype(np.int32): 2, np.dtype(np.int64): 3,
       np.dtype(np.float16): 4, np.dtype(np.float32): 5,
       np.dtype(np.float64): 6, np.dtype(np.uint8): 20,
       np.dtype(np.int8): 21}
_LOD_TENSOR, _FEED_MINIBATCH, _FETCH_LIST = 7, 9, 10

_NP = {torch.bool: np.bool_, torch.int16: np.int16, torch.int32: np.int32,
       torch.int64: np.int64, torch.float16: np.float16,
       torch.float32: np.float32, torch.float64: np.float64,
       torch.uint8: np.uint8, torch.int8: np.int8}


class _BF16:
    """Stand-in dtype of a bfloat16 value (numpy has none)."""

    name = "bfloat16"

    def __repr__(self):
        return "bfloat16"


BF16 = _BF16()


def np_dtype(td):
    """A torch dtype as a numpy dtype (:data:`BF16` for bfloat16)."""
    if td == torch.bfloat16:
        return BF16
    if td not in _NP:
        raise NotImplementedError(f"dtype {td} has no VarType code")
    return np.dtype(_NP[td])


def _is_float(dt):
    return dt is BF16 or np.issubdtype(np.dtype(dt), np.floating)


# --------------------------------------------------------- wire ENCODER --
# (independent of the importer's _Reader and of the test-suite encoder —
# three implementations of one schema keep each other honest)

def _vint(v):
    out = b""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _f(no, wire, payload):
    return _vint(no << 3 | wire) + payload


def _fbytes(no, data):
    return _f(no, 2, _vint(len(data)) + data)


def _fstr(no, s):
    return _fbytes(no, s.encode())


def _fint(no, v):
    return _f(no, 0, _vint(int(v)))


def _ffloat(no, v):
    return _f(no, 5, struct.pack("<f", float(v)))


def _enc_attr(name, kind, value):
    """OpDesc.Attr: name(1), type(2), then the typed field."""
    types = {"i": 0, "f": 1, "s": 2, "ints": 3, "b": 6, "block": 8,
             "l": 9, "longs": 11}
    out = _fstr(1, name) + _fint(2, types[kind])
    if kind == "block":
        return out + _fint(12, value)
    if kind == "i":
        out += _fint(3, value)
    elif kind == "f":
        out += _ffloat(4, value)
    elif kind == "s":
        out += _fstr(5, value)
    elif kind == "ints":
        for x in value:
            out += _fint(6, x)
    elif kind == "b":
        out += _fint(10, int(bool(value)))
    elif kind == "l":
        out += _fint(13, value)
    elif kind == "longs":
        for x in value:
            out += _fint(15, x)
    return out


def _enc_op(type_, inputs, outputs, attrs):
    out = b""
    for param, args in inputs.items():
        body = _fstr(1, param)
        for a in args:
            body += _fstr(2, a)
        out += _fbytes(1, body)
    for param, args in outputs.items():
        body = _fstr(1, param)
        for a in args:
            body += _fstr(2, a)
        out += _fbytes(2, body)
    out += _fstr(3, type_)
    for name, kind, value in attrs:
        out += _fbytes(4, _enc_attr(name, kind, value))
    return out


def _enc_var(name, dims, dtype_code, persistable, vtype=_LOD_TENSOR):
    if vtype == _LOD_TENSOR:
        tensor = _fint(1, dtype_code)
        for d in dims:
            tensor += _fint(2, d)
        body = _fint(1, vtype) + _fbytes(3, _fbytes(1, tensor))
    else:
        body = _fint(1, vtype)
    out = _fstr(1, name) + _fbytes(2, body)
    if persistable:
        out += _fint(3, 1)
    return out


def _enc_program(op_blobs, var_blobs, sub_blocks=()):
    """Block 0 carries all vars; sub-blocks (conditional_block/while
    bodies) carry ops only — the importer merges var scopes."""
    block = _fint(1, 0) + _fint(2, -1)
    for v in var_blobs:
        block += _fbytes(3, v)
    for o in op_blobs:
        block += _fbytes(4, o)
    out = _fbytes(1, block)
    for i, sub_ops in enumerate(sub_blocks):
        blk = _fint(1, i + 1) + _fint(2, 0)
        for o in sub_ops:
            blk += _fbytes(4, o)
        out += _fbytes(1, blk)
    return out


def _tensor_stream(arr):
    """One LoDTensor record (tensor_util.cc TensorToStream)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _VT:
        raise NotImplementedError(
            f"parameter dtype {arr.dtype} has no VarType code; cast the "
            "parameter to float32/float64/int32/int64 before export")
    desc = _fint(1, _VT[arr.dtype])
    for d in arr.shape:
        desc += _fint(2, d)
    out = struct.pack("<I", 0)            # LoDTensor version
    out += struct.pack("<Q", 0)           # lod_level
    out += struct.pack("<I", 0)           # tensor version
    out += struct.pack("<i", len(desc)) + desc
    return out + arr.tobytes()


# ------------------------------------------------- the lowered program --

class _Aval:
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype


class Var:
    """A value of the lowered program (a jaxpr variable)."""

    __slots__ = ("aval",)

    def __init__(self, aval):
        self.aval = aval


class Literal:
    """A scalar riding along unmaterialized (a jaxpr literal)."""

    __slots__ = ("val", "aval")

    def __init__(self, val, dtype):
        self.val = np.asarray(val, dtype=np.float32 if dtype is BF16
                              else dtype)
        self.aval = _Aval((), dtype)


class _Const:
    """A constant array entering the program (a closed-over jaxpr
    constant): a parameter, a buffer or a folded value.  ``key``
    deduplicates it (a tied weight serializes once)."""

    __slots__ = ("val", "key")

    def __init__(self, val, key=None):
        self.val = val
        self.key = id(val) if key is None else key

    @property
    def aval(self):
        v = np.asarray(self.val)
        return _Aval(v.shape, v.dtype)


class Program:
    """A lowered program: ``invars`` (the inputs), ``eqns`` as
    ``(primitive, ins, outs, params)`` and ``outvars`` (atoms)."""

    def __init__(self, invars, eqns, outvars):
        self.invars = invars
        self.eqns = eqns
        self.outvars = outvars


def _atomic(a):
    return isinstance(a, (Literal, _Const))


def _dce(eqns, live):
    keep = []
    for name, ins, outs, params in reversed(eqns):
        if any(o in live for o in outs):
            keep.append((name, ins, outs, params))
            for a in ins:
                if not _atomic(a):
                    live.add(a)
    return keep[::-1]


# ------------------------------------------------------- peephole fusers --
# The JAX exporter's fusers, with their rules unchanged (each declines on
# any interior value consumed outside its pattern).

def _fuse_peepholes(eqns, outs_live):
    """Peepholes over the flat eqn list, fusing spelled-out chains into
    the reference's fused ops (real runtimes have kernels for them; the
    raw forms bloat programs):

    - softmax: ``div(exp(sub(x, reduce_max(x))), reduce_sum(exp))``
      with its reshape/stop_gradient/max(-inf) bookkeeping links ->
      one ``__softmax`` eqn.
    - eval-mode batch norm, layer norm, gelu, conv transpose (below).

    Interior values consumed OUTSIDE a pattern decline the fusion, and
    every reshape link must re-insert the reduced/channel axis exactly
    where the fused op expects it (a wrong-axis normalization over a
    square matrix is shape-silent — it must NOT fuse)."""
    prod = {}
    uses = {}
    for i, (_n, ins, outs, _p) in enumerate(eqns):
        for o in outs:
            prod[o] = i
        for a in ins:
            if not _atomic(a):
                uses[a] = uses.get(a, 0) + 1
    for v in outs_live:
        if not _atomic(v):
            uses[v] = uses.get(v, 0) + 1

    def eqn_of(var, want_name):
        i = prod.get(var)
        if i is None or eqns[i] is None or eqns[i][0] != want_name:
            return None, None
        return i, eqns[i]

    def chase(var, names):
        """Follow single-use unary reshape/convert/stop_gradient links
        ('names') up from var; max(-inf, v) (a softmax guard) follows
        too.  Returns (source var, [indices])."""
        idxs = []
        while True:
            if _atomic(var):
                return var, idxs
            i = prod.get(var)
            if i is None or eqns[i] is None:
                return var, idxs
            n, ins, outs, _p = eqns[i]
            if n == "max" and len(ins) == 2 and uses.get(outs[0]) == 1:
                lit = [a for a in ins if _atomic(a)]
                oth = [a for a in ins if not _atomic(a)]
                if len(lit) == 1 and len(oth) == 1 and \
                        np.asarray(lit[0].val).size == 1 and \
                        float(np.asarray(lit[0].val).reshape(())) == \
                        float("-inf"):
                    idxs.append(i)
                    var = oth[0]
                    continue
            if n in names and len(ins) == 1 and uses.get(outs[0]) == 1:
                idxs.append(i)
                var = ins[0]
                continue
            return var, idxs

    changed = _fuse_batchnorm_eval(eqns, prod, uses, chase)
    changed = _fuse_layernorm(eqns, prod, uses, chase) or changed
    changed = _fuse_gelu(eqns, prod, uses) or changed
    changed = _fuse_conv_transpose(eqns, prod, uses) or changed
    for di in range(len(eqns)):
        if eqns[di] is None or eqns[di][0] != "div":
            continue
        (e_var, t_var), d_outs = eqns[di][1], eqns[di][2]
        if _atomic(e_var) or _atomic(t_var):
            continue
        ei, e_eqn = eqn_of(e_var, "exp")
        if e_eqn is None or uses.get(e_var) != 2:   # div + reduce_sum
            continue
        t_src, t_links = chase(t_var, ("reshape", "broadcast_in_dim"))
        si, s_eqn = eqn_of(t_src, "reduce_sum")
        if s_eqn is None or uses.get(t_src) != 1 or \
                s_eqn[1][0] is not e_var:
            continue
        sum_axes = tuple(s_eqn[3]["axes"])
        if len(sum_axes) != 1:
            continue
        bi, b_eqn = eqn_of(e_eqn[1][0], "sub")
        if b_eqn is None or uses.get(e_eqn[1][0]) != 1:
            continue
        x_var, m_var = b_eqn[1]
        m_src, m_links = chase(
            m_var, ("reshape", "broadcast_in_dim", "stop_gradient",
                    "max"))
        mi, m_eqn = eqn_of(m_src, "reduce_max")
        if m_eqn is None or m_eqn[1][0] is not x_var or \
                tuple(m_eqn[3]["axes"]) != sum_axes:
            continue
        # every interior link must be single-use (chase enforced) and
        # the max/sum reductions must serve only this chain
        if uses.get(m_src, 0) > 1 or uses.get(e_eqn[1][0]) != 1:
            continue
        axis = sum_axes[0]
        x_shape = tuple(int(d) for d in x_var.aval.shape)
        if not (_reinserts_axis(eqns, t_links, x_shape, axis, True)
                and _reinserts_axis(eqns, m_links, x_shape, axis, True)):
            continue
        for idx in [ei, si, bi, mi] + t_links + m_links:
            eqns[idx] = None
        eqns[di] = ("__softmax", [x_var], d_outs, {"axis": axis})
        changed = True
    return [e for e in eqns if e is not None] if changed else eqns


def _lit_scalar(atom):
    if _atomic(atom):
        v = np.asarray(atom.val)
        if v.size == 1:
            return float(v.reshape(()))
    return None


def _lit_mul(eqn, want, tol=1e-5):
    """For mul/add eqns with one scalar-literal operand ~= want
    (RELATIVE tolerance — wide enough for f32-rounded constants,
    narrow enough that a deliberately tweaked near-gelu coefficient
    does not silently fuse): returns the OTHER operand, else None."""
    a, b = eqn[1]
    for lit, other in ((a, b), (b, a)):
        v = _lit_scalar(lit)
        if v is not None and abs(v - want) <= tol * abs(want):
            if not _atomic(other):
                return other
    return None


def _reinserts_axis(eqns, link_idxs, x_shape, axis, require_link):
    """Validate that every reshape/broadcast_in_dim link re-inserts the
    reduced ``axis`` as a size-1 dim of ``x_shape`` (keepdims form) —
    shared by the softmax and layer_norm fusions.  ``require_link``:
    decline when the chain has no shape-bearing link at all (a raw
    right-aligned broadcast can silently mean a different axis)."""
    nd = len(x_shape)
    keep = tuple(1 if i == axis % nd else d
                 for i, d in enumerate(x_shape))
    kept = tuple(i for i in range(nd) if i != axis % nd)
    ok = 0
    for idx in link_idxs:
        if eqns[idx] is None:
            continue
        n_, _i, _o, p_ = eqns[idx]
        if n_ == "reshape":
            if tuple(int(d) for d in p_["new_sizes"]) != keep:
                return False
            ok += 1
        elif n_ == "broadcast_in_dim":
            if tuple(int(d) for d in p_["shape"]) != keep or \
                    tuple(p_["broadcast_dimensions"]) != kept:
                return False
            ok += 1
    return ok > 0 or not require_link


def _fuse_layernorm(eqns, prod, uses, chase):
    """Last-axis layer norm -> one ``__layer_norm`` eqn (reference
    layer_norm op with begin_norm_axis = ndim-1):

    ``add(mul(mul(sub(x, mean), rsqrt(var + eps)), BC(gamma)),
    BC(beta))`` where mean = reduce_sum(x, -1)/n broadcast back and
    var = reduce_sum(square(x - mean), -1)/n — the ~15-op chain every
    transformer block pays twice.  All broadcast-back links must
    re-insert the reduced axis; gamma/beta must be [C] consts mapping
    onto the SAME (last) axis."""
    links = ("reshape", "broadcast_in_dim", "stop_gradient")

    def single(var, name):
        if _atomic(var) or uses.get(var, 0) < 1:
            return None
        i = prod.get(var)
        if i is None or eqns[i] is None or eqns[i][0] != name:
            return None
        return i

    def const_leaf(var):
        src, idxs = chase(var, links)
        return (src, idxs) if isinstance(src, _Const) else (None, idxs)

    def mean_of(var, x_var, axis_want=None):
        """Match ``div(BC(reduce_sum(x)), n)``; returns (axis, n,
        kill-list) or None."""
        di = single(var, "div")
        if di is None or uses.get(var, 0) > 2:
            return None
        num, den = eqns[di][1]
        n_lit = _lit_scalar(den)
        if n_lit is None or _atomic(num):
            return None
        src, lnk = chase(num, links)
        ri = single(src, "reduce_sum") if not _atomic(src) else None
        if ri is None or uses.get(src, 0) != 1:
            # a reduce output consumed OUTSIDE this chain must survive
            return None
        axes = tuple(eqns[ri][3]["axes"])
        if len(axes) != 1 or eqns[ri][1][0] is not x_var:
            return None
        if axis_want is not None and axes[0] != axis_want:
            return None
        return axes[0], n_lit, [di, ri] + lnk

    changed = False
    for ai in range(len(eqns)):
        e = eqns[ai]
        if e is None or e[0] != "add":
            continue
        r_var, beta_var = e[1]
        if _atomic(r_var):
            continue
        beta, beta_links = const_leaf(beta_var)
        if beta is None:
            continue
        ri2 = single(r_var, "mul")
        if ri2 is None or uses.get(r_var) != 1:
            continue
        p_var, gamma_var = eqns[ri2][1]
        if _atomic(p_var):
            continue
        gamma, gamma_links = const_leaf(gamma_var)
        if gamma is None:
            continue
        pi = single(p_var, "mul")
        if pi is None or uses.get(p_var) != 1:
            continue
        l_var, n2_var = eqns[pi][1]
        if _atomic(l_var):
            continue
        n2i = single(n2_var, "rsqrt")
        if n2i is None or uses.get(n2_var, 0) > 1:
            continue
        mi = single(eqns[n2i][1][0], "add")
        if mi is None:
            continue
        k2_var, eps_lit = eqns[mi][1]
        if _lit_scalar(eps_lit) is None:
            k2_var, eps_lit = eps_lit, k2_var
        eps_v = _lit_scalar(eps_lit)
        if eps_v is None or _atomic(k2_var):
            continue
        # the centered value: sub(x, mean) — possibly a SEPARATE eqn
        # from the variance path's sub
        li = single(l_var, "sub")
        if li is None:
            continue
        x_var, f_var = eqns[li][1]
        if _atomic(x_var) or _atomic(f_var):
            continue
        x_shape = tuple(int(d) for d in x_var.aval.shape)
        nd = len(x_shape)
        axis = nd - 1
        got = mean_of(f_var, x_var, axis_want=axis)
        if got is None or abs(got[1] - x_shape[axis]) > 1e-6:
            continue
        _ax, _n, mean_kill = got
        # variance: k2 = div(BC(reduce_sum(square(sub(x, f)))), n)
        vi = single(k2_var, "div")
        if vi is None:
            continue
        vnum, vden = eqns[vi][1]
        vn = _lit_scalar(vden)
        if vn is None or abs(vn - x_shape[axis]) > 1e-6 or _atomic(vnum):
            continue
        vsrc, v_lnk = chase(vnum, links)
        vri = single(vsrc, "reduce_sum") if not _atomic(vsrc) else None
        if vri is None or uses.get(vsrc, 0) != 1 or \
                tuple(eqns[vri][3]["axes"]) != (axis,):
            continue
        hi2 = single(eqns[vri][1][0], "square")
        if hi2 is None:
            continue
        gi2 = single(eqns[hi2][1][0], "sub")
        if gi2 is None:
            continue
        gx, gf = eqns[gi2][1]
        if gx is not x_var or gf is not f_var:
            continue
        # every interior value must die with the fusion: the mean (f)
        # feeds exactly the two subs (or one, if they were shared), and
        # the var/rsqrt interiors have no external consumers
        if uses.get(f_var) != (1 if gi2 == li else 2):
            continue
        if any(uses.get(v, 0) != 1 for v in
               (l_var, k2_var, eqns[n2i][1][0], eqns[hi2][1][0],
                eqns[vri][1][0], vnum)):
            continue
        # gamma/beta: [C] consts broadcasting onto the SAME last axis
        vecs = [np.asarray(c.val) for c in (gamma, beta)]
        if any(v.ndim != 1 or v.shape[0] != x_shape[axis]
               for v in vecs):
            continue

        def maps_last(link_idxs):
            ok = 0
            for idx in link_idxs:
                if eqns[idx] is None:
                    continue
                n_, _i2, _o2, p2 = eqns[idx]
                if n_ == "reshape":
                    sz = tuple(int(d) for d in p2["new_sizes"])
                    if not (len(sz) <= nd and sz[-1] == x_shape[axis]
                            and all(d == 1 for d in sz[:-1])):
                        return False
                    ok += 1
                elif n_ == "broadcast_in_dim":
                    sz = tuple(int(d) for d in p2["shape"])
                    if not (sz[-1] == x_shape[axis]
                            and all(d == 1 for d in sz[:-1])
                            and tuple(p2["broadcast_dimensions"])
                            == (len(sz) - 1,)):
                        return False
                    ok += 1
            return ok > 0 or not link_idxs

        if not (maps_last(gamma_links) and maps_last(beta_links)):
            continue

        if not (_reinserts_axis(eqns, mean_kill, x_shape, axis, False)
                and _reinserts_axis(eqns, v_lnk, x_shape, axis,
                                    False)):
            continue
        if tuple(e[2][0].aval.shape) != x_shape:
            continue
        kill = ([ri2, pi, n2i, mi, li, vi, vri, hi2]
                + mean_kill + v_lnk + gamma_links + beta_links)
        if gi2 != li:
            kill.append(gi2)
        for idx in kill:
            eqns[idx] = None
        eqns[ai] = ("__layer_norm", [x_var, gamma, beta], e[2],
                    {"epsilon": eps_v, "begin_norm_axis": axis})
        changed = True
    return changed


def _fuse_conv_transpose(eqns, prod, uses):
    """``conv_general_dilated(x, transpose(rev(W)), lhs_dilation=s)``
    (the gradient-of-conv spelling of a transposed conv) -> one
    ``__conv2d_transpose`` eqn carrying the ORIGINAL [Cin, Cout, kh, kw]
    filter.  Recovered attrs: strides = lhs_dilation; paddings p =
    k_eff-1-lo; output_padding = hi-lo.  Grouped deconvs decline."""
    changed = False
    for ci in range(len(eqns)):
        e = eqns[ci]
        if e is None or e[0] != "conv_general_dilated":
            continue
        p = e[3]
        lhs_dil = tuple(int(d) for d in p.get("lhs_dilation", (1, 1)))
        if p.get("feature_group_count", 1) != 1:
            continue
        x_var, w_var = e[1]
        if _atomic(w_var) or uses.get(w_var) != 1:
            continue
        ti = prod.get(w_var)
        if ti is None or eqns[ti] is None or \
                eqns[ti][0] != "transpose" or \
                tuple(eqns[ti][3]["permutation"]) != (1, 0, 2, 3):
            continue
        r_var = eqns[ti][1][0]
        if _atomic(r_var) or uses.get(r_var) != 1:
            continue
        ri = prod.get(r_var)
        if ri is None or eqns[ri] is None or eqns[ri][0] != "rev" or \
                tuple(sorted(eqns[ri][3]["dimensions"])) != (2, 3):
            continue
        w_src = eqns[ri][1][0]
        w_shape = tuple(int(d) for d in w_src.aval.shape)
        if len(w_shape) != 4:
            continue
        rhs_dil = tuple(int(d) for d in p.get("rhs_dilation", (1, 1)))
        pads = [(int(lo), int(hi)) for lo, hi in p["padding"]]
        strides_attr, pads_attr, outpad_attr, ok = [], [], [], True
        for d in range(2):
            k_eff = (w_shape[2 + d] - 1) * rhs_dil[d] + 1
            lo, hi = pads[d]
            p_ref = k_eff - 1 - lo
            out_pad = hi - lo
            if p_ref < 0 or out_pad < 0:
                ok = False
                break
            strides_attr.append(lhs_dil[d])
            pads_attr.append(p_ref)
            outpad_attr.append(out_pad)
        if not ok or tuple(int(s) for s in p["window_strides"]) != \
                (1, 1):
            continue
        for idx in (ti, ri):
            eqns[idx] = None
        eqns[ci] = ("__conv2d_transpose", [x_var, w_src], e[2],
                    {"strides": strides_attr, "paddings": pads_attr,
                     "output_padding": outpad_attr,
                     "dilations": list(rhs_dil), "groups": 1})
        changed = True
    return changed


def _fuse_gelu(eqns, prod, uses):
    """gelu chains -> one ``__gelu`` eqn (reference gelu op), both
    spellings:

    exact:  mul(mul(0.5, x), erfc(mul(neg(x), -1/sqrt(2)-ish)))
    approx: mul(x, mul(0.5, add(1, tanh(0.79788*(x + 0.044715*x^3)))))

    Interior single-use only; literals matched with tolerance."""

    def single(var, name):
        if _atomic(var) or uses.get(var) != 1:
            return None
        i = prod.get(var)
        if i is None or eqns[i] is None or eqns[i][0] != name:
            return None
        return i

    changed = False
    for ai in range(len(eqns)):
        e = eqns[ai]
        if e is None or e[0] != "mul":
            continue
        a, b = e[1]
        if _atomic(a) or _atomic(b):
            continue
        # ---- exact form: mul(half, erfc_part) in either order
        for half_v, erfc_v in ((a, b), (b, a)):
            hi = single(half_v, "mul")
            if hi is None:
                continue
            x_var = _lit_mul(eqns[hi], 0.5)
            if x_var is None:
                continue
            ei = single(erfc_v, "erfc")
            if ei is None:
                continue
            di = single(eqns[ei][1][0], "mul")
            if di is None:
                continue
            c_var = _lit_mul(eqns[di], 0.7071067811865476)
            if c_var is None:
                continue
            ci = single(c_var, "neg")
            if ci is None or eqns[ci][1][0] is not x_var:
                continue
            if tuple(e[2][0].aval.shape) != tuple(x_var.aval.shape):
                continue
            for idx in (hi, ei, di, ci):
                eqns[idx] = None
            eqns[ai] = ("__gelu", [x_var], e[2], {"approximate": False})
            changed = True
            break
        if eqns[ai][0] == "__gelu":
            continue
        # ---- tanh approximation: mul(x, half_part) in either order
        for x_var, h_var in ((a, b), (b, a)):
            hi = single(h_var, "mul")
            if hi is None:
                continue
            g_var = _lit_mul(eqns[hi], 0.5)
            if g_var is None:
                continue
            gi = single(g_var, "add")
            if gi is None:
                continue
            f_var = _lit_mul(eqns[gi], 1.0)
            if f_var is None:
                continue
            fi = single(f_var, "tanh")
            if fi is None:
                continue
            ein = single(eqns[fi][1][0], "mul")
            if ein is None:
                continue
            d_var = _lit_mul(eqns[ein], 0.7978845608028654)
            if d_var is None:
                continue
            din = single(d_var, "add")
            if din is None:
                continue
            da, db = eqns[din][1]
            c_var = db if da is x_var else (da if db is x_var else None)
            if c_var is None:
                continue
            cin = single(c_var, "mul")
            if cin is None:
                continue
            b_var = _lit_mul(eqns[cin], 0.044715)
            if b_var is None:
                continue
            bin_ = single(b_var, "integer_pow")
            if bin_ is None or eqns[bin_][3].get("y") != 3 or \
                    eqns[bin_][1][0] is not x_var:
                continue
            if tuple(e[2][0].aval.shape) != tuple(x_var.aval.shape):
                continue
            for idx in (hi, gi, fi, ein, din, cin, bin_):
                eqns[idx] = None
            eqns[ai] = ("__gelu", [x_var], e[2], {"approximate": True})
            changed = True
            break
    return changed


def _fuse_batchnorm_eval(eqns, prod, uses, chase):
    """The eval-mode BN chain ``add(mul(mul(sub(x, BC(mean)),
    BC(rsqrt(add(var, eps)))), BC(gamma)), BC(beta))`` — per-channel
    consts broadcast over NCHW — collapses to one ``__batch_norm`` eqn
    (the reference's fused batch_norm kernel).  BC = reshape/broadcast
    single-use links; every leaf must be a _Const (a TRAINED-stat chain,
    not an activation norm)."""
    links = ("reshape", "broadcast_in_dim", "stop_gradient")

    def const_leaf(var):
        src, idxs = chase(var, links)
        return (src, idxs) if isinstance(src, _Const) else (None, idxs)

    changed = False
    for ai in range(len(eqns)):
        e = eqns[ai]
        if e is None or e[0] != "add":
            continue
        mul2_var, beta_var = e[1]
        if _atomic(mul2_var):
            continue
        beta, beta_links = const_leaf(beta_var)
        if beta is None:
            continue
        m2i = prod.get(mul2_var)
        if m2i is None or eqns[m2i] is None or \
                eqns[m2i][0] != "mul" or uses.get(mul2_var) != 1:
            continue
        mul1_var, gamma_var = eqns[m2i][1]
        if _atomic(mul1_var):
            continue
        gamma, gamma_links = const_leaf(gamma_var)
        if gamma is None:
            continue
        m1i = prod.get(mul1_var)
        if m1i is None or eqns[m1i] is None or \
                eqns[m1i][0] != "mul" or uses.get(mul1_var) != 1:
            continue
        sub_var, rs_var = eqns[m1i][1]
        if _atomic(sub_var):
            continue
        rs_src, rs_links = chase(rs_var, links)
        rsi = prod.get(rs_src)
        if rsi is None or eqns[rsi] is None or \
                eqns[rsi][0] != "rsqrt" or uses.get(rs_src, 0) > 1:
            continue
        vadd_var = eqns[rsi][1][0]
        vi = prod.get(vadd_var)
        if vi is None or eqns[vi] is None or eqns[vi][0] != "add" or \
                uses.get(vadd_var) != 1:
            continue
        var_operand, eps_lit = eqns[vi][1]
        if not _atomic(eps_lit):
            var_operand, eps_lit = eps_lit, var_operand
        if not _atomic(eps_lit):
            continue
        eps_arr = np.asarray(eps_lit.val)
        if eps_arr.ndim != 0:
            continue
        var_c, var_links = const_leaf(var_operand) if not _atomic(
            var_operand) else (var_operand, [])
        if var_c is None:
            continue
        si2 = prod.get(sub_var)
        if si2 is None or eqns[si2] is None or \
                eqns[si2][0] != "sub" or uses.get(sub_var) != 1:
            continue
        x_var, mean_var = eqns[si2][1]
        if _atomic(x_var):
            continue
        mean_c, mean_links = const_leaf(mean_var)
        if mean_c is None:
            continue
        # all four stats must be per-channel vectors of one length
        vecs = [np.asarray(c.val) for c in (mean_c, var_c, gamma, beta)]
        if any(v.ndim != 1 for v in vecs) or \
                len({v.shape[0] for v in vecs}) != 1:
            continue
        # ...and must broadcast onto CHANNEL AXIS 1 of x (NCHW): each
        # chain needs a reshape placing C at index 1 with 1s elsewhere
        # — otherwise this could be a last-axis affine with precomputed
        # stats, which batch_norm would silently mis-normalize
        ch = vecs[0].shape[0]
        x_nd = len(x_var.aval.shape)

        def _chan_shape(sz):
            return (len(sz) == x_nd and sz[1:2] == (ch,)
                    and all(d == 1 for j, d in enumerate(sz) if j != 1))

        def on_axis1(link_idxs):
            ok = 0
            for idx in link_idxs:
                if eqns[idx] is None:
                    continue
                n, _i2, _o2, p2 = eqns[idx]
                if n == "reshape":
                    if not _chan_shape(tuple(int(d)
                                             for d in p2["new_sizes"])):
                        return False
                    ok += 1
                elif n == "broadcast_in_dim":
                    if not _chan_shape(tuple(int(d)
                                             for d in p2["shape"])) or \
                            tuple(p2["broadcast_dimensions"]) != (1,):
                        return False
                    ok += 1
            return ok > 0

        # the rsqrt factor's broadcast reshape may sit before OR after
        # the eps-add/rsqrt (both spellings occur); its path is the
        # rs+var chains combined.  gamma/beta/mean are independent.
        if not (on_axis1(mean_links) and on_axis1(gamma_links)
                and on_axis1(rs_links + var_links)
                and on_axis1(beta_links)):
            continue
        for idx in ([m2i, m1i, rsi, vi, si2] + beta_links + gamma_links
                    + rs_links + var_links + mean_links):
            eqns[idx] = None
        eqns[ai] = ("__batch_norm",
                    [x_var, mean_c, var_c, gamma, beta], e[2],
                    {"epsilon": float(eps_arr)})
        changed = True
    return changed


# ------------------------------------------------------------ translator --

class _Ref:
    """A value bound to a program variable."""

    __slots__ = ("name", "shape", "dtype", "expand_to", "_forced")

    def __init__(self, name, shape, dtype, expand_to=None):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype if dtype is BF16 else np.dtype(dtype)
        # pending broadcast target (see broadcast_in_dim handler): the
        # var holds the size-1-axes reshape; elementwise consumers use
        # it directly, others force an expand_v2 first (cached in
        # _forced so N consumers share one emitted expand)
        self.expand_to = expand_to
        self._forced = None


class _Lit:
    """A scalar literal riding along unmaterialized."""

    __slots__ = ("val", "dtype")

    def __init__(self, val, dtype):
        self.val = val
        self.dtype = dtype if dtype is BF16 else np.dtype(dtype)


class _Exporter:
    def __init__(self):
        self.ops = []           # (type, ins, outs, attrs)
        self.sub_blocks = []    # [[op tuples]] — cond/while bodies
        self.vars = {}          # name -> (dims, dtype_code, persistable)
        self.params = {}        # name -> ndarray
        self.env = {}           # program var -> _Ref | _Lit
        self._const_names = {}  # Const key -> name
        self._n = 0

    # ---- naming / registration

    def _fresh(self, prefix="t"):
        self._n += 1
        return f"{prefix}_{self._n:04d}"

    def _declare(self, name, shape, dtype, persistable=False):
        # persistable params have static shapes by construction — a
        # genuine dim of _BATCH there must not re-encode as dynamic
        if persistable:
            dims = [int(d) for d in shape]
        else:
            dims = [-1 if d == _BATCH else int(d) for d in shape]
        self.vars[name] = (dims, _np_vt(dtype), persistable)

    def _emit(self, op_type, ins, outs, attrs=()):
        self.ops.append((op_type, ins, outs, list(attrs)))

    def _new_out(self, shape, dtype, op_type, ins, attrs=(), prefix="t"):
        name = self._fresh(prefix)
        self._declare(name, shape, dtype)
        self._emit(op_type, ins, {_OUT_PARAM.get(op_type, "Out"): [name]},
                   attrs)
        return _Ref(name, shape, dtype)

    # ---- value access

    def val(self, atom):
        if isinstance(atom, Literal):
            return _Lit(atom.val.item(), atom.aval.dtype)
        if isinstance(atom, _Const):
            v = np.asarray(atom.val)
            if v.ndim == 0:
                return _Lit(v.item(), v.dtype)
            return self.const_ref(v, key=atom.key)
        got = self.env.get(atom)
        if got is None:
            raise AssertionError(f"unbound program var {atom}")
        return got

    def const_ref(self, arr, key=None):
        key = id(arr) if key is None else key
        if key not in self._const_names:
            name = f"p_{len(self.params):04d}"
            self.params[name] = np.asarray(arr)
            self._declare(name, arr.shape, arr.dtype, persistable=True)
            self._const_names[key] = name
        name = self._const_names[key]
        return _Ref(name, arr.shape, arr.dtype)

    def force(self, ref):
        """Materialize a pending expand_v2 (non-elementwise consumer)."""
        if isinstance(ref, _Ref) and ref.expand_to is not None:
            # the cache is scoped to the op list it was emitted into: a
            # var produced inside one cond/while sub-block does not
            # exist in the main block or a sibling branch
            if ref._forced is not None and \
                    ref._forced[0] == id(self.ops):
                return ref._forced[1]
            if any(d == _BATCH for d in ref.expand_to):
                # expand_v2's -1 means 'keep input dim' (which is 1
                # here), so a dynamic-batch expansion is inexpressible
                raise NotImplementedError(
                    "broadcast to a dynamic batch extent feeds a "
                    "non-broadcasting consumer; export with a concrete "
                    "batch size in the InputSpec")
            tgt = [int(d) for d in ref.expand_to]
            out = self._new_out(
                ref.expand_to, ref.dtype, "expand_v2",
                {"X": [ref.name]}, [("shape", "ints", tgt)])
            ref._forced = (id(self.ops), out)
            return out
        return ref

    def materialize(self, lit, shape=(1,)):
        """A scalar literal as a tensor (numpy broadcast covers)."""
        dt = lit.dtype
        code = _np_vt(dt)
        if any(d == _BATCH for d in shape):
            raise NotImplementedError(
                "a constant spanning the dynamic batch extent feeds a "
                "shape-sensitive op; export with a concrete batch size")
        attrs = [("shape", "longs", [int(d) for d in shape]),
                 ("value", "f", float(lit.val)),
                 ("dtype", "i", code)]
        if not _is_float(dt):
            # the float32 `value` attr holds < 25 bits of mantissa; an
            # int literal above 2^24 would round.  The reference runtime
            # gives the string attr precedence, so carry the exact value
            # there (bool rides along as 0/1).
            attrs.append(("str_value", "s", str(int(lit.val))))
        return self._new_out(shape, dt, "fill_constant", {}, attrs)

    def as_ref(self, atom):
        """The operand as a program var: pending broadcasts force, and
        a deferred scalar literal materializes at the operand's TRACED
        shape (shape-sensitive consumers — pad/cumsum/split/reshape —
        must not see the collapsed scalar)."""
        v = self.val(atom)
        if isinstance(v, _Lit):
            shape = tuple(int(d) for d in atom.aval.shape)
            return self.materialize(v, shape or (1,))
        return self.force(v)


def _np_vt(dtype):
    if dtype is BF16:
        raise NotImplementedError(
            "bfloat16 vars have no stable reference wire dtype here; "
            "cast the model to float32 before export "
            "(paddle.amp.decorate is a training-time wrapper)")
    dt = np.dtype(dtype)
    if dt not in _VT:
        raise NotImplementedError(f"dtype {dt} has no VarType code")
    return _VT[dt]


_OUT_PARAM = {"conv2d": "Output", "batch_norm": "Y",
              "conv2d_transpose": "Output"}

_UNARY = {"exp": "exp", "log": "log", "tanh": "tanh", "abs": "abs",
          "square": "square",
          "sqrt": "sqrt", "rsqrt": "rsqrt", "floor": "floor",
          "logistic": "sigmoid", "erf": "erf", "sign": "sign",
          "log1p": "log1p", "sin": "sin", "cos": "cos", "ceil": "ceil",
          "not": "logical_not"}

_BINOP = {"add": "elementwise_add", "sub": "elementwise_sub",
          "mul": "elementwise_mul", "div": "elementwise_div",
          "max": "elementwise_max", "min": "elementwise_min",
          "pow": "elementwise_pow", "rem": "elementwise_mod",
          "eq": "equal", "gt": "greater_than", "lt": "less_than",
          "ge": "greater_equal", "le": "less_equal", "ne": "not_equal",
          "and": "logical_and", "or": "logical_or",
          "xor": "logical_xor"}

_REDUCE = {"reduce_sum": "reduce_sum", "reduce_max": "reduce_max",
           "reduce_min": "reduce_min", "reduce_prod": "reduce_prod"}


def translate(exporter, name, ins, outs, params):
    ex = exporter
    aval = outs[0].aval

    def bind(v):
        ex.env[outs[0]] = v

    # -- aliases / no-ops
    if name in ("stop_gradient", "copy"):
        bind(ex.val(ins[0]))
        return
    if name == "convert_element_type":
        src = ex.val(ins[0])
        tgt = params["new_dtype"]
        if isinstance(src, _Lit):
            bind(_Lit(np.asarray(src.val, np.float32 if tgt is BF16
                                 else tgt).item(), tgt))
            return
        if src.dtype == tgt:
            bind(src)
            return
        src = ex.force(src)
        bind(ex._new_out(aval.shape, tgt, "cast", {"X": [src.name]},
                         [("in_dtype", "i", _np_vt(src.dtype)),
                          ("out_dtype", "i", _np_vt(tgt))]))
        return

    if name == "__batch_norm":  # fused by _fuse_batchnorm_eval / kept whole
        x = ex.as_ref(ins[0])
        mean, var, gamma, beta = (ex.val(a) for a in ins[1:])
        bind(ex._new_out(aval.shape, aval.dtype, "batch_norm",
                         {"X": [x.name], "Mean": [mean.name],
                          "Variance": [var.name],
                          "Scale": [gamma.name], "Bias": [beta.name]},
                         [("epsilon", "f", params["epsilon"]),
                          ("data_layout", "s", "NCHW"),
                          ("is_test", "b", True)]))
        return

    if name == "__conv2d_transpose":
        x = ex.as_ref(ins[0])
        w = ex.val(ins[1])
        if isinstance(w, _Lit):
            raise NotImplementedError(
                "conv2d_transpose with a scalar-literal filter")
        w = ex.force(w)
        bind(ex._new_out(
            aval.shape, aval.dtype, "conv2d_transpose",
            {"Input": [x.name], "Filter": [w.name]},
            [("strides", "ints", params["strides"]),
             ("paddings", "ints", params["paddings"]),
             ("output_padding", "ints", params["output_padding"]),
             ("dilations", "ints", params["dilations"]),
             ("groups", "i", int(params.get("groups", 1))),
             ("padding_algorithm", "s", "EXPLICIT")]))
        return

    if name == "__layer_norm":  # fused by _fuse_layernorm / kept whole
        x = ex.as_ref(ins[0])
        gamma, beta = (ex.val(a) for a in ins[1:])
        bind(ex._new_out(aval.shape, aval.dtype, "layer_norm",
                         {"X": [x.name], "Scale": [gamma.name],
                          "Bias": [beta.name]},
                         [("epsilon", "f", params["epsilon"]),
                          ("begin_norm_axis", "i",
                           int(params["begin_norm_axis"]))]))
        return

    if name == "__gelu":        # fused by _fuse_gelu / kept whole
        x = ex.as_ref(ins[0])
        bind(ex._new_out(aval.shape, aval.dtype, "gelu",
                         {"X": [x.name]},
                         [("approximate", "b",
                           bool(params["approximate"]))]))
        return

    if name == "__softmax":     # fused by _fuse_peepholes / kept whole
        x = ex.as_ref(ins[0])
        bind(ex._new_out(aval.shape, aval.dtype, "softmax",
                         {"X": [x.name]},
                         [("axis", "i", int(params["axis"]))]))
        return

    if name == "__embedding":   # the embedding gather, kept whole
        w = ex.val(ins[0])
        ids = ex.val(ins[1])
        if isinstance(w, _Ref) and isinstance(ids, _Lit):
            # one index everywhere (a ``zeros_like`` token type): the
            # row, broadcast as a deferred expansion
            w = ex.force(w)
            v = int(ids.val)
            row = ex._new_out((1,) + w.shape[1:], w.dtype, "slice",
                              {"Input": [w.name]},
                              [("axes", "ints", [0]),
                               ("starts", "ints", [v]),
                               ("ends", "ints", [v + 1])])
            lead = len(aval.shape) - len(w.shape) + 1
            shape = (1,) * lead + w.shape[1:]
            if shape != row.shape:
                row = ex._new_out(shape, w.dtype, "reshape2",
                                  {"X": [row.name]},
                                  [("shape", "ints", list(shape))])
            bind(_Ref(row.name, shape, w.dtype,
                      expand_to=tuple(aval.shape)) if shape != tuple(
                          aval.shape) else row)
            return
        if not isinstance(w, _Ref) or not isinstance(ids, _Ref):
            raise NotImplementedError(
                "only embedding-style gathers (single leading-axis "
                "index) export to lookup_table_v2")
        bind(ex._new_out(aval.shape, aval.dtype, "lookup_table_v2",
                         {"W": [ex.force(w).name],
                          "Ids": [ex.force(ids).name]}))
        return

    if name in _UNARY:
        x = ex.val(ins[0])
        if isinstance(x, _Lit):
            folds = {
                "exp": np.exp, "log": np.log, "tanh": np.tanh,
                "abs": np.abs, "sqrt": np.sqrt,
                "rsqrt": lambda v: 1.0 / np.sqrt(v),
                "floor": np.floor, "erf": None, "sign": np.sign,
                "log1p": np.log1p, "sin": np.sin, "cos": np.cos,
                "square": np.square, "ceil": np.ceil,
                "logistic": lambda v: 1.0 / (1.0 + np.exp(-v)),
                "not": np.logical_not,
            }
            fn = folds.get(name)
            if fn is None:
                raise NotImplementedError(
                    f"scalar-literal {name} has no constant fold")
            dt = np.float32 if x.dtype is BF16 else x.dtype
            bind(_Lit(np.asarray(fn(np.asarray(x.val, dt)), dt).item(),
                      x.dtype))
            return
        x = ex.force(x)
        bind(ex._new_out(aval.shape, aval.dtype, _UNARY[name],
                         {"X": [x.name]}))
        return

    if name == "slice":
        x = ex.as_ref(ins[0])
        if any(int(s) != 1 for s in (params.get("strides") or
                                     [1] * len(x.shape))):
            raise NotImplementedError(
                "strided slice export is not implemented")
        axes, starts, ends = [], [], []
        for d, (st, li) in enumerate(zip(params["start_indices"],
                                         params["limit_indices"])):
            st, li = int(st), int(li)
            if st == 0 and li == x.shape[d]:
                continue                       # full dim: omit the axis
            if x.shape[d] == _BATCH:
                raise NotImplementedError(
                    "slicing within the dynamic batch dim would bake "
                    "the placeholder extent; export with a concrete "
                    "batch size")
            axes.append(d)
            starts.append(st)
            ends.append(li)
        bind(ex._new_out(aval.shape, aval.dtype, "slice",
                         {"Input": [x.name]},
                         [("axes", "ints", axes),
                          ("starts", "ints", starts),
                          ("ends", "ints", ends)]))
        return

    if name == "erfc":
        x = ex.as_ref(ins[0])
        e = ex._new_out(aval.shape, aval.dtype, "erf", {"X": [x.name]})
        bind(_scale(ex, e, aval, -1.0, 1.0))   # erfc = 1 - erf
        return

    if name == "neg":
        x = ex.as_ref(ins[0])
        bind(ex._new_out(aval.shape, aval.dtype, "scale",
                         {"X": [x.name]},
                         [("scale", "f", -1.0), ("bias", "f", 0.0),
                          ("bias_after_scale", "b", True)]))
        return

    if name == "integer_pow":
        x = ex.as_ref(ins[0])
        y = params["y"]
        if y == 2:
            bind(ex._new_out(aval.shape, aval.dtype, "square",
                             {"X": [x.name]}))
        else:
            bind(ex._new_out(aval.shape, aval.dtype, "pow",
                             {"X": [x.name]},
                             [("factor", "f", float(y))]))
        return

    if name in _BINOP:
        if name in ("and", "or", "xor") and aval.dtype != np.bool_:
            # and/or/xor double as integer BITWISE ops; the reference
            # logical_* family is boolean-only
            raise NotImplementedError(
                f"integer bitwise {name!r} has no reference logical_* "
                "translation (paddle's logical ops are boolean); "
                "restructure with arithmetic ops or export the mask "
                "as a bool tensor")
        if name == "rem":
            bind(_emit_trunc_rem(ex, ins, aval))
            return
        a, b = ex.val(ins[0]), ex.val(ins[1])
        bind(_emit_binop(ex, name, a, b, aval))
        return

    if name == "select_n":
        if len(ins) != 3:
            raise NotImplementedError(
                "select_n with more than two cases has no reference "
                "where-op translation; restructure as nested two-way "
                "selects")
        pred = ex.val(ins[0])
        if isinstance(pred, _Lit):
            bind(ex.val(ins[2] if pred.val else ins[1]))
            return
        on_false = ex.val(ins[1])
        on_true = ex.val(ins[2])
        on_false = on_false if isinstance(on_false, _Ref) \
            else ex.materialize(on_false)
        on_true = on_true if isinstance(on_true, _Ref) \
            else ex.materialize(on_true)
        want = tuple(int(d) for d in aval.shape) or (1,)
        # prefer the UNFORCED operands (mirrors _emit_binop): the
        # importer's where broadcasts numpy-style, so a deferred
        # broadcast needs no expand_v2 when the shapes already imply
        # the output
        implied = np.broadcast_shapes(pred.shape, on_true.shape,
                                      on_false.shape)
        if implied != want:
            pf, tf, ff = (ex.force(pred), ex.force(on_true),
                          ex.force(on_false))
            forced = np.broadcast_shapes(pf.shape, tf.shape, ff.shape)
            if forced == want:
                pred, on_true, on_false = pf, tf, ff
                implied = forced
        out = ex._new_out(implied, aval.dtype, "where",
                          {"Condition": [pred.name],
                           "X": [on_true.name], "Y": [on_false.name]})
        if implied != want:
            out = _Ref(out.name, implied, aval.dtype, expand_to=want)
        bind(out)
        return

    if name == "broadcast_in_dim":
        src = ex.val(ins[0])
        if isinstance(src, _Lit):
            bind(src)              # scalar: numpy broadcasting covers it
            return
        # a chained broadcast must materialize its pending expansion
        # FIRST — the reshape target below is computed from the source's
        # post-force shape
        src = ex.force(src)
        bd = tuple(params["broadcast_dimensions"])
        shape = tuple(int(d) for d in params["shape"])
        expanded = any(shape[d] != src.shape[i]
                       for i, d in enumerate(bd)) or \
            any(i not in bd and shape[i] != 1 for i in range(len(shape)))
        ones = [1] * len(shape)
        for i, d in enumerate(bd):
            ones[d] = int(src.shape[i])
        if tuple(ones) == src.shape:
            mid = src
        else:
            mid = ex._new_out(tuple(ones), src.dtype, "reshape2",
                              {"X": [src.name]},
                              [("shape", "ints", _reshape_attr(
                                  src.shape, tuple(ones)))])
        if expanded:
            mid = _Ref(mid.name, mid.shape, mid.dtype, expand_to=shape)
        bind(mid)
        return

    if name in ("reshape", "squeeze"):
        x = ex.as_ref(ins[0])
        new = tuple(int(d) for d in aval.shape)
        if new == x.shape:
            bind(x)
            return
        bind(ex._new_out(new, aval.dtype, "reshape2", {"X": [x.name]},
                         [("shape", "ints",
                           _reshape_attr(x.shape, new))]))
        return

    if name == "transpose":
        x = ex.as_ref(ins[0])
        bind(ex._new_out(aval.shape, aval.dtype, "transpose2",
                         {"X": [x.name]},
                         [("axis", "ints",
                           list(params["permutation"]))]))
        return

    if name in _REDUCE:
        x = ex.as_ref(ins[0])
        axes = sorted(int(a) for a in params["axes"])
        # reference reduce_* declare dim as std::vector<int> (INTS);
        # LONGS would fail the GetAttr variant access at load time
        attrs = [("dim", "ints", axes), ("keep_dim", "b", False)]
        if len(axes) == len(x.shape):
            attrs.append(("reduce_all", "b", True))
        bind(ex._new_out(aval.shape, aval.dtype, _REDUCE[name],
                         {"X": [x.name]}, attrs))
        return

    if name in ("argmax", "argmin"):
        x = ex.as_ref(ins[0])
        axes = params["axes"]
        if len(axes) != 1:
            raise NotImplementedError(
                "multi-axis argmax/argmin is not exportable")
        op = "arg_max" if name == "argmax" else "arg_min"
        bind(ex._new_out(aval.shape, aval.dtype, op, {"X": [x.name]},
                         [("axis", "l", int(axes[0])),
                          ("keepdims", "b", False),
                          ("dtype", "i",
                           _np_vt(aval.dtype))]))
        return

    if name == "concatenate":
        vals = [ex.force(ex.val(a)) for a in ins]
        if any(isinstance(v, _Lit) for v in vals):
            vals = [v if isinstance(v, _Ref) else
                    ex.materialize(v, tuple(a.aval.shape) or (1,))
                    for v, a in zip(vals, ins)]
        bind(ex._new_out(aval.shape, aval.dtype, "concat",
                         {"X": [v.name for v in vals]},
                         [("axis", "i", int(params["dimension"]))]))
        return

    if name == "cumsum":
        x = ex.as_ref(ins[0])
        if params.get("reverse", False):
            raise NotImplementedError(
                "reverse cumsum export is not implemented")
        # the reference cumsum keeps its input's dtype (torch widens an
        # integer one to int64): the value rides on in the input's type
        bind(ex._new_out(aval.shape, x.dtype, "cumsum",
                         {"X": [x.name]},
                         [("axis", "i", int(params["axis"])),
                          ("flatten", "b", False),
                          ("exclusive", "b", False),
                          ("reverse", "b", False)]))
        return

    if name == "pad":
        x = ex.as_ref(ins[0])
        fill = ex.val(ins[1])
        cfg = params["padding_config"]
        if any(int(i) != 0 for _lo, _hi, i in cfg) or \
                any(int(lo) < 0 or int(hi) < 0 for lo, hi, _i in cfg):
            raise NotImplementedError(
                "interior/negative padding has no reference pad-op "
                "translation")
        if not isinstance(fill, _Lit):
            raise NotImplementedError(
                "pad with a tensor fill value is not exportable")
        pads = []
        for lo, hi, _i in cfg:
            pads += [int(lo), int(hi)]
        bind(ex._new_out(aval.shape, aval.dtype, "pad", {"X": [x.name]},
                         [("paddings", "ints", pads),
                          ("pad_value", "f", float(fill.val))]))
        return

    if name in ("reduce_window_max", "reduce_window_sum"):
        bind(_emit_pool(ex, name, ins, params, aval))
        return

    if name == "split":
        x = ex.as_ref(ins[0])
        axis = int(params["axis"])
        if x.shape[axis] == _BATCH:
            raise NotImplementedError(
                "splitting the dynamic batch axis would bake the "
                "placeholder extent into the sections attr; export "
                "with a concrete batch size")
        sizes = [int(s) for s in params["sizes"]]
        names_out = []
        for ov in outs:
            nm = ex._fresh()
            ex._declare(nm, ov.aval.shape, ov.aval.dtype)
            names_out.append(nm)
        ex._emit("split", {"X": [x.name]}, {"Out": names_out},
                 [("axis", "i", axis), ("sections", "ints", sizes)])
        for ov, nm in zip(outs, names_out):
            ex.env[ov] = _Ref(nm, ov.aval.shape, ov.aval.dtype)
        return

    if name == "dot_general":
        bind(_emit_dot(ex, ins, params, aval))
        return

    if name == "conv_general_dilated":
        bind(_emit_conv(ex, ins, params, aval))
        return

    if name == "cond":
        _emit_cond(ex, ins, outs, params)
        return

    if name == "while":
        _emit_while(ex, ins, outs, params)
        return

    if name == "kernel":
        kname = params["kernel"]
        raise NotImplementedError(
            f"the hand-written kernel {kname} (custom CUDA code) has no "
            "reference-op translation; rebuild the model on its plain "
            "path for export — a model on the CPU runs the kernels' "
            "plain versions, so export a CPU copy of it; "
            "FusedMultiTransformer's decode kernel is inference-only "
            "(export the prefill model instead)")
    raise NotImplementedError(
        f"op {name!r} has no reference-op translation; the "
        "exportable subset is: "
        f"{sorted(set(_UNARY) | set(_BINOP) | set(_REDUCE)) + _OTHERS} "
        "(if the model uses dropout or other train-only randomness, "
        "call .eval() before export; for everything else use the "
        "native format: static.save_inference_model(prefix, [], model))")


_OTHERS = ["argmax", "broadcast_in_dim", "cast", "concatenate",
           "conv_general_dilated", "cumsum", "dot_general", "neg", "pad",
           "reduce_window", "reshape", "select_n", "slice", "split",
           "squeeze", "transpose"]


def _reshape_attr(src_shape, new_shape):
    """Encode a reshape target with dynamic-batch dims as 0/-1."""
    out = []
    inferred = None
    for i, d in enumerate(new_shape):
        if d == _BATCH:
            if i < len(src_shape) and src_shape[i] == _BATCH:
                out.append(0)        # 0 = copy input dim i
                continue
            if inferred is None:
                inferred = i
                out.append(-1)
                continue
            raise NotImplementedError(
                "reshape places the dynamic batch extent in two "
                "positions; inexpressible in reshape2's 0/-1 grammar — "
                "export with a concrete batch size")
        if d != _BATCH and d % _BATCH == 0 and _BATCH in src_shape:
            if inferred is not None:
                raise NotImplementedError(
                    "reshape mixes the dynamic batch extent into "
                    "multiple dims; export with a concrete batch size")
            inferred = i
            out.append(-1)
            continue
        out.append(int(d))
    return out


def _emit_binop(ex, name, a, b, aval):
    op = _BINOP[name]
    # scalar folds (scale / relu / pow) keep programs idiomatic
    if isinstance(b, _Lit) and not isinstance(a, _Lit) and \
            _is_float(aval.dtype):
        a_r = ex.force(a)
        v = float(b.val)
        if name == "add":
            return _scale(ex, a_r, aval, 1.0, v)
        if name == "sub":
            return _scale(ex, a_r, aval, 1.0, -v)
        if name == "mul":
            return _scale(ex, a_r, aval, v, 0.0)
        if name == "div" and v != 0.0:
            return _scale(ex, a_r, aval, 1.0 / v, 0.0)
        if name == "pow":
            return ex._new_out(aval.shape, aval.dtype, "pow",
                               {"X": [a_r.name]},
                               [("factor", "f", v)])
        if name == "max":
            if v == 0.0:
                return ex._new_out(aval.shape, aval.dtype, "relu",
                                   {"X": [a_r.name]})
            if v == float("-inf"):
                return a_r
        if name == "min" and v == float("inf"):
            return a_r
    if isinstance(a, _Lit) and not isinstance(b, _Lit) and \
            _is_float(aval.dtype):
        b_r = ex.force(b)
        v = float(a.val)
        if name == "add":
            return _scale(ex, b_r, aval, 1.0, v)
        if name == "mul":
            return _scale(ex, b_r, aval, v, 0.0)
        if name == "sub":
            return _scale(ex, b_r, aval, -1.0, v)
        if name == "max" and v == float("-inf"):
            return b_r
        if name == "min" and v == float("inf"):
            return b_r
    a = a if isinstance(a, _Ref) else ex.materialize(a)
    b = b if isinstance(b, _Ref) else ex.materialize(b)
    # elementwise consumers don't need a pending broadcast materialized:
    # the size-1-axes form broadcasts numpy-style to the same result —
    # UNLESS the expansion is load-bearing for the output shape (the
    # other operand doesn't force it), in which case expand for real;
    # a materialized scalar is [1] by design and a () target is the same
    # value for every consumer — not a real mismatch
    want = tuple(int(d) for d in aval.shape) or (1,)
    try:
        implied = np.broadcast_shapes(a.shape, b.shape)
    except ValueError:
        implied = None
    if implied != want:
        af, bf = ex.force(a), ex.force(b)
        forced = np.broadcast_shapes(af.shape, bf.shape)
        if forced == want:
            a, b = af, bf
            implied = forced
        # else: EVERY operand is a collapsed literal — compute at the
        # reduced shape and defer the broadcast to consumers, exactly
        # like broadcast_in_dim does
    out = ex._new_out(implied, aval.dtype, op,
                      {"X": [a.name], "Y": [b.name]},
                      [("axis", "i", -1)])
    if implied != want:
        out = _Ref(out.name, implied, aval.dtype, expand_to=want)
    return out


def _emit_trunc_rem(ex, ins, aval):
    """``rem`` is the TRUNCATED remainder (sign of dividend); paddle's
    elementwise_mod is floor-mod (sign of divisor), so a direct mapping
    silently flips signs for negative operands.  Emit the exact
    composition x - trunc(x/y)*y instead; trunc(q) = sign(q)*floor(|q|)."""
    if not _is_float(aval.dtype):
        raise NotImplementedError(
            "integer rem export is not implemented (the float "
            "composition via floor would lose precision)")
    a = ex.val(ins[0])
    b = ex.val(ins[1])
    a = ex.force(a) if isinstance(a, _Ref) else ex.materialize(a)
    b = ex.force(b) if isinstance(b, _Ref) else ex.materialize(b)
    q = ex._new_out(aval.shape, aval.dtype, "elementwise_div",
                    {"X": [a.name], "Y": [b.name]}, [("axis", "i", -1)])
    sg = ex._new_out(aval.shape, aval.dtype, "sign", {"X": [q.name]})
    ab = ex._new_out(aval.shape, aval.dtype, "abs", {"X": [q.name]})
    fl = ex._new_out(aval.shape, aval.dtype, "floor", {"X": [ab.name]})
    tr = ex._new_out(aval.shape, aval.dtype, "elementwise_mul",
                     {"X": [sg.name], "Y": [fl.name]},
                     [("axis", "i", -1)])
    prod = ex._new_out(aval.shape, aval.dtype, "elementwise_mul",
                       {"X": [tr.name], "Y": [b.name]},
                       [("axis", "i", -1)])
    return ex._new_out(aval.shape, aval.dtype, "elementwise_sub",
                       {"X": [a.name], "Y": [prod.name]},
                       [("axis", "i", -1)])


def _scale(ex, x, aval, scale, bias):
    if scale == 1.0 and bias == 0.0:
        return x
    return ex._new_out(aval.shape, aval.dtype, "scale", {"X": [x.name]},
                       [("scale", "f", scale), ("bias", "f", bias),
                        ("bias_after_scale", "b", True)])


def _translate_inline(ex, prog, bindings, out_avals):
    """Translate a lowered sub-program's eqns into the CURRENT op list.

    ``bindings``: inner invar -> outer atom (resolved through the
    enclosing env) or _Ref (direct env seed, for loop-carried names).
    Returns the output values as forced/materialized _Refs."""
    for iv, tgt in bindings.items():
        ex.env[iv] = tgt if isinstance(tgt, (_Ref, _Lit)) else ex.val(tgt)
    outs = prog.outvars
    live = {v for v in outs if not _atomic(v)}
    for nm, ins_, outvars, prm in _fuse_peepholes(_dce(list(prog.eqns),
                                                       live), outs):
        translate(ex, nm, ins_, outvars, prm)
    refs = []
    for atom, aval in zip(outs, out_avals):
        v = ex.val(atom)
        v = ex.force(v) if isinstance(v, _Ref) else \
            ex.materialize(v, tuple(int(d) for d in aval.shape) or (1,))
        refs.append(v)
    return refs


def _translate_sub(ex, prog, bindings, out_avals, tag):
    """Translate a branch/body program into a NEW sub-block.  The
    block's outputs are bound to fresh names via ``assign`` ops (the
    importer's conditional_block/while read the Out names from the
    sub-scope after running its ops).  Returns (out_names, block_idx) —
    block_idx is the 1-based ProgramDesc block the ops landed in."""
    saved = ex.ops
    ex.ops = []
    try:
        vals = _translate_inline(ex, prog, bindings, out_avals)
        out_names = []
        for v, aval in zip(vals, out_avals):
            nm = ex._fresh(tag)
            ex._declare(nm, aval.shape, aval.dtype)
            ex._emit("assign", {"X": [v.name]}, {"Out": [nm]})
            out_names.append(nm)
    finally:
        sub_ops, ex.ops = ex.ops, saved
    ex.sub_blocks.append(sub_ops)
    return out_names, len(ex.sub_blocks)


def _emit_cond(ex, ins, outs, params):
    """cond -> the reference cond() lowering: two guarded
    conditional_blocks merged per-output by select_input(Mask=index)
    (conditional_block_op.cc / select_input_op.cc)."""
    true_p, false_p = params["true"], params["false"]
    idx = ex.as_ref(ins[0])
    c = ex._new_out(idx.shape or (1,), np.bool_, "cast",
                    {"X": [idx.name]},
                    [("in_dtype", "i", _np_vt(idx.dtype)),
                     ("out_dtype", "i", 0)])
    nc = ex._new_out(c.shape, np.bool_, "logical_not", {"X": [c.name]})
    out_avals = [o.aval for o in outs]
    operand_atoms = list(ins[1:])

    def bindings(prog):
        return dict(zip(prog.invars, operand_atoms))

    t_names, t_blk = _translate_sub(ex, true_p, bindings(true_p),
                                    out_avals, "t")
    f_names, f_blk = _translate_sub(ex, false_p, bindings(false_p),
                                    out_avals, "f")
    ex._emit("conditional_block", {"Cond": [c.name]},
             {"Out": t_names, "Scope": []},
             [("sub_block", "block", t_blk),
              ("is_scalar_condition", "b", True)])
    ex._emit("conditional_block", {"Cond": [nc.name]},
             {"Out": f_names, "Scope": []},
             [("sub_block", "block", f_blk),
              ("is_scalar_condition", "b", True)])
    mask = idx if idx.dtype == np.dtype(np.int32) else \
        ex._new_out(idx.shape or (1,), np.int32, "cast",
                    {"X": [idx.name]},
                    [("in_dtype", "i", _np_vt(idx.dtype)),
                     ("out_dtype", "i", 2)])
    for ov, aval, fn, tn in zip(outs, out_avals, f_names, t_names):
        nm = ex._fresh()
        ex._declare(nm, aval.shape, aval.dtype)
        ex._emit("select_input", {"X": [fn, tn], "Mask": [mask.name]},
                 {"Out": [nm]})
        ex.env[ov] = _Ref(nm, aval.shape, aval.dtype)


def _emit_while(ex, ins, outs, params):
    """while_loop -> the reference while op: carried vars get stable
    names the sub-block reassigns each iteration, with the Condition
    recomputed at the end of the body (while_op.cc scope semantics; the
    importer's loop-carry analysis picks these up).  The cond and body
    programs take the carried values first, then the free operands."""
    cond_p, body_p = params["cond"], params["body"]
    n = params["num_carried"]
    init_atoms = list(ins[:n])
    extra_atoms = list(ins[n:])

    # stable carried names, seeded from the inits
    w_names = []
    for atom in init_atoms:
        v = ex.as_ref(atom)
        nm = ex._fresh("w")
        ex._declare(nm, v.shape, v.dtype)
        ex._emit("assign", {"X": [v.name]}, {"Out": [nm]})
        w_names.append(_Ref(nm, v.shape, v.dtype))

    def bindings(prog, carried_refs):
        b = dict(zip(prog.invars[:n], carried_refs))
        b.update(zip(prog.invars[n:], extra_atoms))
        return b

    # initial condition value, computed in the MAIN block
    cond_aval = cond_p.outvars[0].aval
    (cv0,) = _translate_inline(ex, cond_p, bindings(cond_p, w_names),
                               [cond_aval])
    c_name = ex._fresh("c")
    ex._declare(c_name, cond_aval.shape, cond_aval.dtype)
    ex._emit("assign", {"X": [cv0.name]}, {"Out": [c_name]})

    # body sub-block: run body, reassign carried names, recompute cond
    body_avals = [o.aval for o in outs]
    new_names, blk = _translate_sub(ex, body_p, bindings(body_p, w_names),
                                    body_avals, "wb")
    sub_ops = ex.sub_blocks[blk - 1]
    saved, ex.ops = ex.ops, sub_ops
    try:
        new_refs = []
        for nn_, w in zip(new_names, w_names):
            ex._emit("assign", {"X": [nn_]}, {"Out": [w.name]})
            new_refs.append(_Ref(w.name, w.shape, w.dtype))
        (cv,) = _translate_inline(ex, cond_p, bindings(cond_p, new_refs),
                                  [cond_aval])
        ex._emit("assign", {"X": [cv.name]}, {"Out": [c_name]})
    finally:
        ex.ops = saved

    ex._emit("while",
             {"X": [w.name for w in w_names], "Condition": [c_name]},
             {"Out": [w.name for w in w_names], "StepScopes": []},
             [("sub_block", "block", blk)])
    for ov, w in zip(outs, w_names):
        ex.env[ov] = _Ref(w.name, w.shape, w.dtype)


def _maybe_transpose(ex, ref, perm):
    if tuple(perm) == tuple(range(len(ref.shape))):
        return ref
    shape = tuple(ref.shape[p] for p in perm)
    return ex._new_out(shape, ref.dtype, "transpose2", {"X": [ref.name]},
                       [("axis", "ints", list(perm))])


def _emit_dot(ex, ins, params, aval):
    """dot_general -> matmul_v2, canonicalizing layout when needed.

    dot_general's output dim order is ALWAYS (batch..., lhs_free...,
    rhs_free...), which is exactly batched-matmul output order — so
    permuting each operand to (batch..., free, contract) (using the
    trans_x/trans_y attrs to absorb a flip for free) needs no output
    transpose."""
    (lc, rc), (lb, rb) = params["dimension_numbers"]
    a = ex.force(ex.val(ins[0]))
    b = ex.force(ex.val(ins[1]))
    la, lb_ = len(a.shape), len(b.shape)
    if len(lc) != 1 or len(rc) != 1:
        raise NotImplementedError(
            "dot_general with multiple contracting dims is not "
            "exportable as matmul_v2")
    free_l = [d for d in range(la) if d not in lb and d != lc[0]]
    free_r = [d for d in range(lb_) if d not in rb and d != rc[0]]
    if len(lb) == 0 and lb_ == 2 and la > 2 and len(free_r) == 1:
        # [..., M, K] @ [K, N]-style: matmul_v2 broadcasts the leading
        # dims
        if lc[0] not in (la - 1, la - 2):
            raise NotImplementedError(
                "dot_general contracting dim layout is not a matmul")
        return ex._new_out(aval.shape, aval.dtype, "matmul_v2",
                           {"X": [a.name], "Y": [b.name]},
                           [("trans_x", "b", lc[0] == la - 2),
                            ("trans_y", "b", rc[0] == lb_ - 1)])
    if len(free_l) != 1 or len(free_r) != 1 or len(lb) != len(rb):
        raise NotImplementedError(
            "dot_general on non-matrix operands is not exportable as "
            "matmul_v2 (vectors: reshape to [1, n] first)")
    # lhs -> (batch..., M, K) or (batch..., K, M)+trans_x
    perm_a = tuple(lb) + (free_l[0], lc[0])
    alt_a = tuple(lb) + (lc[0], free_l[0])
    ident = tuple(range(la))
    if alt_a == ident and perm_a != ident:
        a, trans_x = _maybe_transpose(ex, a, alt_a), True
    else:
        a, trans_x = _maybe_transpose(ex, a, perm_a), False
    # rhs -> (batch..., K, N) or (batch..., N, K)+trans_y
    perm_b = tuple(rb) + (rc[0], free_r[0])
    alt_b = tuple(rb) + (free_r[0], rc[0])
    ident = tuple(range(lb_))
    if alt_b == ident and perm_b != ident:
        b, trans_y = _maybe_transpose(ex, b, alt_b), True
    else:
        b, trans_y = _maybe_transpose(ex, b, perm_b), False
    return ex._new_out(aval.shape, aval.dtype, "matmul_v2",
                       {"X": [a.name], "Y": [b.name]},
                       [("trans_x", "b", trans_x),
                        ("trans_y", "b", trans_y)])


def _emit_pool(ex, name, ins, params, aval):
    """reduce_window over NCHW spatial dims -> pool2d.

    max -> pool2d(max).  sum -> pool2d(avg, exclusive=False) scaled by
    the window size: non-exclusive average divides by the CONSTANT
    kh*kw and zero-pads, so sum == avg * kh*kw exactly, padding
    included (the program's own count-divide then turns into an
    elementwise_div of two exported tensors — the spelled-out form of
    the reference's exclusive average)."""
    win = tuple(int(w) for w in params["window_dimensions"])
    strides = tuple(int(s) for s in params["window_strides"])
    pads = params["padding"]
    if len(win) != 4 or win[0] != 1 or win[1] != 1 or \
            strides[0] != 1 or strides[1] != 1 or \
            tuple(pads[0]) != (0, 0) or tuple(pads[1]) != (0, 0):
        raise NotImplementedError(
            "only NCHW spatial reduce_windows export to pool2d")
    xval = ex.val(ins[0])
    if isinstance(xval, _Lit):
        # exclusive-average COUNT path: a window reduction over a
        # constant is input-independent — fold it now (batch/chan dims
        # collapse to 1; the downstream divide broadcasts)
        src = tuple(1 if (i < 2 or d == _BATCH) else int(d)
                    for i, d in enumerate(ins[0].aval.shape))
        from ..ops.pool_ops import window_reduce

        dt = np.float32 if xval.dtype is BF16 else xval.dtype
        full = torch.full(src, xval.val, dtype=torch.from_numpy(
            np.zeros(0, dt)).dtype)
        kind = "max" if name.endswith("max") else "add"
        arr = window_reduce(full, [2, 3], win[2:], strides[2:],
                            [tuple(pads[2]), tuple(pads[3])], kind).numpy()
        ref = ex.const_ref(arr, key=("rwfold", name, src, win, strides,
                                     tuple(map(tuple, pads)),
                                     float(xval.val)))
        if arr.shape != tuple(int(d) for d in aval.shape):
            ref = _Ref(ref.name, ref.shape, ref.dtype,
                       expand_to=tuple(int(d) for d in aval.shape))
        return ref
    x = ex.force(xval)
    attrs = [
        ("pooling_type", "s", "max" if name.endswith("max") else "avg"),
        ("ksize", "ints", [win[2], win[3]]),
        ("strides", "ints", [strides[2], strides[3]]),
        ("paddings", "ints", [int(pads[2][0]), int(pads[2][1]),
                              int(pads[3][0]), int(pads[3][1])]),
        ("ceil_mode", "b", False),
        ("exclusive", "b", False),
        ("adaptive", "b", False),
        ("global_pooling", "b", False),
    ]
    if name.endswith("sum") and not _is_float(aval.dtype):
        # integer avg pooling truncates the divide, so avg*k != sum
        raise NotImplementedError(
            "integer window-sum pooling is not exportable (the "
            "avg-pool*k identity only holds for floats)")
    out = ex._new_out(aval.shape, aval.dtype, "pool2d", {"X": [x.name]},
                      attrs)
    if name.endswith("sum"):
        out = _scale(ex, out, aval, float(win[2] * win[3]), 0.0)
    return out


def _emit_conv(ex, ins, params, aval):
    if tuple(params.get("lhs_dilation", (1, 1))) != (1, 1):
        raise NotImplementedError(
            "transposed conv (lhs_dilation) export is not implemented")
    x = ex.force(ex.val(ins[0]))
    w = ex.force(ex.val(ins[1]))
    pads = params["padding"]
    attrs = [
        ("strides", "ints", [int(s) for s in params["window_strides"]]),
        ("paddings", "ints", [int(pads[0][0]), int(pads[0][1]),
                              int(pads[1][0]), int(pads[1][1])]),
        ("dilations", "ints",
         [int(d) for d in params.get("rhs_dilation", (1, 1))]),
        ("groups", "i", int(params.get("feature_group_count", 1))),
        ("padding_algorithm", "s", "EXPLICIT"),
    ]
    return ex._new_out(aval.shape, aval.dtype, "conv2d",
                       {"Input": [x.name], "Filter": [w.name]}, attrs)


# ------------------------------------------------------------ the trace --

def _sdpa_math(query, key, value, attn_mask=None, dropout_p=0.0,
               is_causal=False, scale=None, enable_gqa=False):
    """``scaled_dot_product_attention`` as its matmul/softmax math on
    [..., L, E] (the decomposition the export's trace uses)."""
    if dropout_p:
        raise NotImplementedError(
            "attention dropout is train-only randomness; call .eval() "
            "before export")
    if enable_gqa:
        raise NotImplementedError("grouped-query SDPA is not exportable")
    s = 1.0 / (query.shape[-1] ** 0.5) if scale is None else scale
    logits = torch.matmul(query, key.transpose(-2, -1)) * s
    if is_causal:
        lq, lk = query.shape[-2], key.shape[-2]
        keep = torch.ones((lq, lk), dtype=torch.bool,
                          device=query.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    return torch.matmul(torch.softmax(logits, dim=-1), value)


def _var(x, dim=None, *, correction=None, keepdim=False):
    """``aten.var`` as ``jnp.var``'s equations: the mean, the sum of the
    squared deviations over n - correction, and NaN where that count is
    not positive (GroupNorm and InstanceNorm reach it)."""
    dims = list(range(x.dim())) if dim is None else \
        [int(d) % x.dim() for d in dim]
    n = 1
    for d in dims:
        n *= x.shape[d]
    mean = torch.sum(x, dims, keepdim=True) / n
    ss = torch.sum(torch.square(x - mean), dims, keepdim=keepdim)
    count = torch.full((), n - (1.0 if correction is None
                                else float(correction)),
                       dtype=x.dtype, device=x.device)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(count > 0, ss / count, nan)


def _var_dim(x, dim=None, unbiased=True, keepdim=False):
    return _var(x, dim, correction=1 if unbiased else 0, keepdim=keepdim)


def _logaddexp(a, b):
    """``aten.logaddexp`` as ``jnp.logaddexp``'s equations: max(a, b) +
    log1p(exp(-|a - b|)), and a + b where a - b is NaN (Mish reaches
    it)."""
    d = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(d != d, a + b, out)


def _log_sigmoid_forward(x):
    """``aten.log_sigmoid_forward`` as ``jax.nn.log_sigmoid``:
    -softplus(-x), softplus being logaddexp(., 0).  The buffer output
    (the backward's) is empty."""
    out = -_logaddexp(-x, torch.zeros_like(x))
    return out, torch.zeros((0,), dtype=x.dtype, device=x.device)


DECOMPOSITIONS = {
    torch.ops.aten.scaled_dot_product_attention.default: _sdpa_math,
    torch.ops.aten.var.correction: _var,
    torch.ops.aten.var.dim: _var_dim,
    torch.ops.aten.var.default:
        lambda x, unbiased=True: _var_dim(x, None, unbiased),
    torch.ops.aten.logaddexp.default: _logaddexp,
    torch.ops.aten.log_sigmoid_forward.default: _log_sigmoid_forward,
}


_REDUCE_WINDOW = None


def _reduce_window_op():
    """``paddle_tpu_export::reduce_window``: the port's window reduction
    as one op of the export's trace (module docstring)."""
    global _REDUCE_WINDOW
    if _REDUCE_WINDOW is not None:
        return _REDUCE_WINDOW
    from ..ops import pool_ops

    plain = pool_ops.window_reduce_plain

    @torch.library.custom_op("paddle_tpu_export::reduce_window",
                             mutates_args=())
    def reduce_window(x: torch.Tensor, dims: list[int], ksize: list[int],
                      strides: list[int], pads: list[int],
                      kind: str) -> torch.Tensor:
        pairs = [(pads[2 * i], pads[2 * i + 1]) for i in range(len(dims))]
        return plain(x, list(dims), list(ksize), list(strides), pairs,
                     kind).clone()

    @reduce_window.register_fake
    def _(x, dims, ksize, strides, pads, kind):
        shape = list(x.shape)
        for i, d in enumerate(dims):
            span = shape[d] + pads[2 * i] + pads[2 * i + 1] - ksize[i]
            shape[d] = span // strides[i] + 1
        dt = x.dtype if kind == "max" or x.is_floating_point() \
            else torch.int64
        return x.new_empty(shape, dtype=dt)

    _REDUCE_WINDOW = reduce_window
    return reduce_window


def _whole_pools():
    """Every window reduction of the export's trace kept as one
    ``paddle_tpu_export::reduce_window`` op (module docstring), in the
    trace's own context."""
    from ..ops import pool_ops

    op = _reduce_window_op()

    def route(x, dims, ksize, strides, pads, kind):
        flat = [int(v) for p in pads for v in p]
        return op(x, [int(d) for d in dims], [int(k) for k in ksize],
                  [int(s) for s in strides], flat, kind)

    return pool_ops.routed_windows(route)


@contextlib.contextmanager
def _kept_generators(layer):
    """Every torch.Generator the trace could draw from restored after
    it: the port's global ones and those the model's modules hold (the
    JAX exporter saves and restores its key)."""
    from ..framework.random import generators_of

    states = [(g, g.get_state()) for g in generators_of(layer)]
    try:
        yield
    finally:
        for g, s in states:
            g.set_state(s)


def _state_of(layer):
    """``(names, tensors, setter)``: the layer's parameters and buffers
    (a Paddle ``Layer`` or a ``torch.nn.Module``)."""
    if isinstance(layer, torch.nn.Module):
        named = dict(layer.named_parameters())
        for n, b in layer.named_buffers():
            named.setdefault(n, b)
        return list(named), [v.detach() for v in named.values()]
    from ..jit import _state

    state = _state(layer) if hasattr(layer, "named_parameters") else {}
    return list(state), [state[n]._data.detach() for n in state]


def trace(layer, examples, decompositions=None):
    """``(GraphModule, state names, state values)``: ``layer`` traced on
    ``examples`` (torch tensors; their values are never read) with the
    parameters and buffers as the leading graph inputs, decomposed by
    ``decompositions`` (default :data:`DECOMPOSITIONS`)."""
    from ..core.tensor import Tensor, _wrap
    from ..framework import mode

    names, values = _state_of(layer)
    ns = len(names)
    is_module = isinstance(layer, torch.nn.Module)

    def traced(*flat):
        if is_module:
            out = torch.func.functional_call(
                layer, dict(zip(names, flat[:ns])), tuple(flat[ns:]))
        else:
            from ..jit import _state

            state = _state(layer) if ns else {}
            saved = [(state[n], state[n]._data) for n in names]
            for n, d in zip(names, flat[:ns]):
                state[n]._data = d
            try:
                with mode.tracing():
                    out = layer(*[_wrap(x) for x in flat[ns:]])
            finally:
                for t, d in saved:
                    t._data = d
        leaves = pytree.tree_leaves(
            out, is_leaf=lambda x: isinstance(x, Tensor))
        return tuple(x._data if isinstance(x, Tensor) else
                     x if isinstance(x, torch.Tensor) else
                     torch.as_tensor(np.asarray(x)) for x in leaves)

    with _kept_generators(layer), _whole_pools(), torch.no_grad():
        gm = make_fx(traced, decomposition_table=DECOMPOSITIONS
                     if decompositions is None else decompositions,
                     tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*values, *examples)
    gm.graph.eliminate_dead_code()
    return gm, names, values


# ------------------------------------------------------ aten -> program --

aten = torch.ops.aten

_ALIAS = {aten.clone.default, aten.alias.default, aten.detach.default,
          aten.lift_fresh_copy.default, aten.contiguous.default,
          aten._assert_tensor_metadata.default}
_UNARY_ATEN = {
    aten.exp.default: "exp", aten.log.default: "log",
    aten.tanh.default: "tanh", aten.abs.default: "abs",
    aten.sqrt.default: "sqrt", aten.rsqrt.default: "rsqrt",
    aten.floor.default: "floor", aten.ceil.default: "ceil",
    aten.sigmoid.default: "logistic", aten.erf.default: "erf",
    aten.sign.default: "sign", aten.log1p.default: "log1p",
    aten.sin.default: "sin", aten.cos.default: "cos",
    aten.neg.default: "neg", aten.erfc.default: "erfc",
    aten.logical_not.default: "not", aten.square.default: "square",
}
_BIN_ATEN = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "pow": "pow", "fmod": "rem",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt",
    "ge": "ge", "logical_and": "and", "logical_or": "or",
    "logical_xor": "xor", "bitwise_and": "and", "bitwise_or": "or",
    "bitwise_xor": "xor",
}
# input-independent creation ops: their value is known at export time
_CREATE = {aten.full.default, aten.ones.default, aten.zeros.default,
           aten.scalar_tensor.default, aten.arange.default,
           aten.arange.start, aten.arange.start_step, aten.empty.memory_format}


def _aval_of(v):
    return _Aval(tuple(v.shape), np_dtype(v.dtype))


def _np_value(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bfloat16 vars have no stable reference wire dtype here; "
            "cast the model to float32 before export "
            "(paddle.amp.decorate is a training-time wrapper)")
    return t.numpy()


class _Lowering:
    """Rewrites one aten graph into a :class:`Program`."""

    def __init__(self, gm, static_inputs):
        self.gm = gm
        self.eqns = []
        self.env = {}        # fx node -> atom | [atoms] | ("static", tensor)
        self.static_inputs = static_inputs   # placeholder idx -> const

    def emit(self, name, ins, out_avals, params=None):
        outs = [Var(a) for a in out_avals]
        self.eqns.append((name, list(ins), outs, params or {}))
        return outs

    def one(self, name, ins, aval, **params):
        return self.emit(name, ins, [aval], params)[0]

    # ---- operand access
    def atom(self, a, like=None):
        """An operand as an atom: a node's value, a static value as a
        literal or constant, a Python scalar as a literal."""
        if isinstance(a, torch.fx.Node):
            v = self.env[a]
            if isinstance(v, tuple) and v and v[0] == "static":
                return self.static_atom(v[1])
            return v
        dt = like.aval.dtype if like is not None and not isinstance(
            a, bool) else None
        if isinstance(a, bool):
            return Literal(a, np.dtype(np.bool_))
        if dt is None:
            dt = np.dtype(np.float32) if isinstance(a, float) \
                else np.dtype(np.int64)
        return Literal(a, dt)

    def static_atom(self, t):
        """A known value: a 0-d one as a literal, one whose elements are
        all equal as a broadcast literal (the JAX spelling of a
        ``full``), any other as a folded constant."""
        arr = _np_value(t)
        if arr.ndim == 0:
            return Literal(arr.item(), arr.dtype)
        flat = arr.reshape(-1)
        if flat.size and np.all(flat == flat[0]):
            return self.one("broadcast_in_dim",
                            [Literal(flat[0].item(), arr.dtype)],
                            _Aval(arr.shape, arr.dtype),
                            shape=arr.shape, broadcast_dimensions=())
        return _Const(arr, key=("folded", arr.shape, str(arr.dtype),
                                arr.tobytes()))

    def is_static(self, a):
        if isinstance(a, torch.fx.Node):
            v = self.env.get(a)
            return isinstance(v, tuple) and bool(v) and v[0] == "static"
        if isinstance(a, (list, tuple)):
            return all(self.is_static(x) for x in a)
        return True

    def static_val(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a][1]
        if isinstance(a, (list, tuple)):
            return type(a)(self.static_val(x) for x in a)
        return a

    # ---- the graph
    def run(self):
        placeholders = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        invars = []
        for i, n in enumerate(placeholders):
            if i in self.static_inputs:
                self.env[n] = self.static_inputs[i]
            else:
                v = Var(_aval_of(n.meta["val"]))
                invars.append(v)
                self.env[n] = v
        outvars = None
        for n in self.gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "output":
                outvars = [self.atom(a) for a in
                           pytree.tree_leaves(n.args[0])]
                continue
            if n.op == "get_attr":
                obj = getattr(self.gm, n.target)
                if isinstance(obj, torch.Tensor):
                    self.env[n] = ("static", obj) if obj.numel() <= 1 \
                        else _Const(_np_value(obj), key=id(obj))
                else:
                    self.env[n] = obj   # a sub-GraphModule
                continue
            self.node(n)
        return Program(invars, self.eqns, outvars)

    def node(self, n):
        t = n.target
        if t is operator.getitem:
            src = self.env[n.args[0]]
            self.env[n] = src[n.args[1]] if not (
                isinstance(src, tuple) and src and src[0] == "static") \
                else ("static", src[1][n.args[1]])
            return
        ns = getattr(t, "namespace", None)
        if ns == "paddle_tpu_torch":
            out = n.meta.get("val")
            avals = [_aval_of(v) for v in pytree.tree_leaves(out)]
            self.env[n] = self.emit("kernel", [], avals or [_Aval((), np.dtype(
                np.float32))], {"kernel": f"paddle_tpu_torch::"
                                f"{t._schema.name.split('::')[-1]}"})
            return
        # input-independent values are computed now (folded)
        if t in _CREATE or (isinstance(t, torch._ops.OpOverload)
                            and ns == "aten" and n.all_input_nodes and
                            all(self.is_static(a) for a in n.all_input_nodes)
                            and t not in _ALIAS):
            if not any(d == _BATCH for v in pytree.tree_leaves(n.meta.get(
                    "val")) if isinstance(v, torch.Tensor) for d in v.shape):
                args = pytree.tree_map(
                    lambda a: self.static_val(a) if isinstance(
                        a, torch.fx.Node) else a, n.args)
                kwargs = dict(n.kwargs)
                if "device" in kwargs:
                    kwargs["device"] = torch.device("cpu")
                args = pytree.tree_map(
                    lambda a: a.cpu() if isinstance(a, torch.Tensor) else a,
                    args)
                self.env[n] = ("static", t(*args, **kwargs))
                return
        if t in _ALIAS:
            self.env[n] = self.env[n.args[0]]
            return
        handler = _ATEN.get(t) or _ATEN.get(getattr(t, "overloadpacket", None))
        if handler is None:
            name = getattr(t, "__name__", str(t))
            if isinstance(t, torch._ops.OpOverload):
                name = t._schema.name.split("::")[-1]
            raise NotImplementedError(
                f"op {name!r} has no reference-op translation; the "
                f"exportable subset is: "
                f"{sorted(set(_UNARY) | set(_BINOP) | set(_REDUCE)) + _OTHERS}"
                " (if the model uses dropout or other train-only "
                "randomness, call .eval() before export; for everything "
                "else use the native format: "
                "static.save_inference_model(prefix, [], model))")
        self.env[n] = handler(self, n)

    def aval(self, n):
        return _aval_of(n.meta["val"])


# ---- aten handlers: each returns the node's atom (or list of atoms)

def _h_view(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    if tuple(x.aval.shape) == aval.shape:
        return x
    return L.one("reshape", [x], aval, new_sizes=aval.shape)


def _h_permute(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    perm = [int(p) % nd for p in n.args[1]]
    return L.one("transpose", [x], L.aval(n), permutation=tuple(perm))


def _h_t(L, n):
    x = L.atom(n.args[0])
    if len(x.aval.shape) < 2:
        return x
    return L.one("transpose", [x], L.aval(n), permutation=(1, 0))


def _h_transpose(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    a, b = int(n.args[1]) % nd, int(n.args[2]) % nd
    perm = list(range(nd))
    perm[a], perm[b] = perm[b], perm[a]
    return L.one("transpose", [x], L.aval(n), permutation=tuple(perm))


def _broadcast(L, x, aval):
    """``x`` broadcast numpy-style (right-aligned) to ``aval``."""
    shape = aval.shape
    if tuple(x.aval.shape) == shape:
        return x
    off = len(shape) - len(x.aval.shape)
    return L.one("broadcast_in_dim", [x], aval, shape=shape,
                 broadcast_dimensions=tuple(range(off, len(shape))))


def _h_expand(L, n):
    return _broadcast(L, L.atom(n.args[0]), L.aval(n))


def _h_dot(L, n):
    a, b = L.atom(n.args[0]), L.atom(n.args[1])
    if n.target == aten.mm.default:
        dn = (((1,), (0,)), ((), ()))
    else:   # bmm
        dn = (((2,), (1,)), ((0,), (0,)))
    return L.one("dot_general", [a, b], L.aval(n), dimension_numbers=dn)


def _h_addmm(L, n):
    bias, a, b = (L.atom(x) for x in n.args[:3])
    aval = L.aval(n)
    if n.kwargs.get("beta", 1) != 1 or n.kwargs.get("alpha", 1) != 1:
        raise NotImplementedError("addmm with alpha/beta is not exportable")
    prod = L.one("dot_general", [a, b], aval,
                 dimension_numbers=(((1,), (0,)), ((), ())))
    return L.one("add", [prod, _broadcast(L, bias, aval)], aval)


_ARITH = ("add", "sub", "mul", "div", "max", "min", "pow", "rem")


def _h_binary(L, n):
    """A binary aten op, its Python scalar operands as literals (a weak
    type: the literal takes the dtype the op computes in) and mixed
    tensor dtypes cast to it, as torch promotes them implicitly."""
    prim = _BIN_ATEN[n.target.overloadpacket.__name__]
    aval = L.aval(n)
    a, b = n.args[0], n.args[1]
    x = L.atom(a) if isinstance(a, torch.fx.Node) else None
    y = L.atom(b) if isinstance(b, torch.fx.Node) else None
    if prim in _ARITH:
        dt = aval.dtype
    else:
        tensors = [v.aval.dtype for v in (x, y)
                   if v is not None and not isinstance(v, Literal)]
        dt = tensors[0] if len(tensors) == 1 else (
            np.promote_types(*tensors) if tensors else np.dtype(np.float32))
    x = Literal(a, dt) if x is None else _cast_to(L, x, dt)
    y = Literal(b, dt) if y is None else _cast_to(L, y, dt)
    alpha = n.kwargs.get("alpha", 1)
    if alpha != 1:
        y = L.one("mul", [y, Literal(alpha, dt)], y.aval)
    if n.kwargs.get("rounding_mode") is not None:
        raise NotImplementedError(
            "div with a rounding_mode is not exportable")
    return L.one(prim, [x, y], aval)


def _as_dtype(a, dt):
    if isinstance(a, Literal) and a.aval.dtype != dt:
        return Literal(a.val.item(), dt)
    return a


def _cast_to(L, x, dt):
    if isinstance(x, Literal):
        return _as_dtype(x, dt)
    if x.aval.dtype == dt:
        return x
    return L.one("convert_element_type", [x], _Aval(x.aval.shape, dt),
                 new_dtype=dt)


def _h_rsub(L, n):
    aval = L.aval(n)
    x = L.atom(n.args[0])
    y = _as_dtype(L.atom(n.args[1], like=x), aval.dtype)
    return L.one("sub", [y, x], aval)


def _h_unary(L, n):
    return L.one(_UNARY_ATEN[n.target], [L.atom(n.args[0])], L.aval(n))


def _h_reciprocal(L, n):
    aval = L.aval(n)
    return L.one("div", [Literal(1.0, aval.dtype), L.atom(n.args[0])], aval)


def _h_silu(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    return L.one("mul", [x, L.one("logistic", [x], aval)], aval)


def _h_leaky_relu(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    slope = n.args[1] if len(n.args) > 1 else 0.01
    pos = L.one("ge", [x, Literal(0.0, aval.dtype)],
                _Aval(aval.shape, np.dtype(np.bool_)))
    neg = L.one("mul", [x, Literal(slope, aval.dtype)], aval)
    return L.one("select_n", [pos, neg, x], aval)


def _h_relu(L, n):
    aval = L.aval(n)
    return L.one("max", [L.atom(n.args[0]), Literal(0.0, aval.dtype)], aval)


def _h_pow(L, n):
    x, e = n.args[0], n.args[1]
    aval = L.aval(n)
    if isinstance(e, torch.fx.Node) or isinstance(x, (int, float)):
        return _h_binary(L, n)
    xa = L.atom(x)
    if float(e) == 2.0:
        return L.one("square", [xa], aval)
    if float(e) == int(e) and int(e) > 0:
        return L.one("integer_pow", [xa], aval, y=int(e))
    return L.one("pow", [xa, Literal(float(e), aval.dtype)], aval)


def _h_clamp(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    lo = n.args[1] if len(n.args) > 1 else n.kwargs.get("min")
    hi = n.args[2] if len(n.args) > 2 else n.kwargs.get("max")
    if lo is not None:
        x = L.one("max", [x, _as_dtype(L.atom(lo, like=x), aval.dtype)],
                  aval)
    if hi is not None:
        x = L.one("min", [x, _as_dtype(L.atom(hi, like=x), aval.dtype)],
                  aval)
    return x


def _unalias(a):
    while isinstance(a, torch.fx.Node) and a.target in _ALIAS:
        a = a.args[0]
    return a


def _bounded_clamp(n):
    """The clamp node when ``n`` is ``where(lo < x & x < hi, x,
    clamp(x, lo, hi))`` (the port's ``relu6``, whose ``where`` only pins
    the gradient at the bounds), else None: the where's value is the
    clamp's, and it exports as the JAX package's ``jnp.clip``."""
    c, a, b = (_unalias(v) for v in n.args[:3])
    if not (isinstance(b, torch.fx.Node) and isinstance(c, torch.fx.Node)
            and b.target is aten.clamp.default and _unalias(b.args[0]) is a
            and len(b.args) == 3 and c.target in (
                aten.bitwise_and.Tensor, aten.logical_and.default)):
        return None
    sides = set()
    for side in (_unalias(v) for v in c.args[:2]):
        if not isinstance(side, torch.fx.Node) or len(side.args) != 2 \
                or _unalias(side.args[0]) is not a:
            return None
        sides.add((side.target, float(side.args[1])))
    lo, hi = float(b.args[1]), float(b.args[2])
    return b if sides == {(aten.gt.Scalar, lo), (aten.lt.Scalar, hi)} \
        else None


def _h_where(L, n):
    clamp = _bounded_clamp(n)
    if clamp is not None:
        return L.atom(clamp)
    c, a, b = n.args[:3]
    aval = L.aval(n)
    ca = L.atom(c)
    aa = _cast_to(L, L.atom(a) if isinstance(a, torch.fx.Node)
                  else Literal(a, aval.dtype), aval.dtype)
    ba = _cast_to(L, L.atom(b) if isinstance(b, torch.fx.Node)
                  else Literal(b, aval.dtype), aval.dtype)
    return L.one("select_n", [ca, ba, aa], aval)


def _h_masked_fill(L, n):
    x, mask, v = n.args[:3]
    aval = L.aval(n)
    va = L.atom(v) if isinstance(v, torch.fx.Node) else \
        Literal(v, aval.dtype)
    return L.one("select_n", [L.atom(mask), L.atom(x), va], aval)


def _dims(x, dims):
    nd = len(x.aval.shape)
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return tuple(range(nd))
    if isinstance(dims, int):
        dims = [dims]
    return tuple(sorted(int(d) % nd for d in dims))


def _keep(L, red, x, axes, aval):
    """A reduction's output with the reduced axes re-inserted as size 1
    (keepdim), as ``jnp``'s ``keepdims`` spells it."""
    if tuple(red.aval.shape) == aval.shape:
        return red
    kept = tuple(i for i in range(len(x.aval.shape)) if i not in axes)
    return L.one("broadcast_in_dim", [red], aval, shape=aval.shape,
                 broadcast_dimensions=kept)


def _reduce_h(prim):
    def h(L, n):
        x = L.atom(n.args[0])
        dims = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim")
        keep = n.args[2] if len(n.args) > 2 else n.kwargs.get("keepdim",
                                                               False)
        axes = _dims(x, dims)
        aval = L.aval(n)
        if prim == "reduce_sum" and aval.dtype != x.aval.dtype:
            x = _cast_to(L, x, aval.dtype)
        red_shape = tuple(d for i, d in enumerate(x.aval.shape)
                          if i not in axes)
        red = L.one(prim, [x], _Aval(red_shape, aval.dtype), axes=axes)
        return _keep(L, red, x, axes, aval) if keep else red
    return h


def _h_sum_default(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    x = _cast_to(L, x, aval.dtype)
    return L.one("reduce_sum", [x], aval,
                 axes=tuple(range(len(x.aval.shape))))


def _h_mean(L, n):
    x = L.atom(n.args[0])
    dims = n.args[1] if len(n.args) > 1 else None
    keep = n.args[2] if len(n.args) > 2 else n.kwargs.get("keepdim", False)
    axes = _dims(x, dims)
    aval = L.aval(n)
    count = 1
    for a in axes:
        count *= x.aval.shape[a]
    red_shape = tuple(d for i, d in enumerate(x.aval.shape) if i not in axes)
    red = L.one("reduce_sum", [x], _Aval(red_shape, aval.dtype), axes=axes)
    if keep:
        red = _keep(L, red, x, axes, aval)
    return L.one("div", [red, Literal(float(count), aval.dtype)], aval)


def _h_arg(prim):
    def h(L, n):
        x = L.atom(n.args[0])
        dim = n.args[1] if len(n.args) > 1 else None
        keep = n.args[2] if len(n.args) > 2 else False
        aval = L.aval(n)
        if dim is None:
            flat = L.one("reshape", [x], _Aval((int(np.prod(x.aval.shape)),),
                                               x.aval.dtype),
                         new_sizes=(int(np.prod(x.aval.shape)),))
            return L.one(prim, [flat], aval, axes=(0,), index_dtype=aval.dtype)
        axis = int(dim) % len(x.aval.shape)
        red_shape = tuple(d for i, d in enumerate(x.aval.shape) if i != axis)
        red = L.one(prim, [x], _Aval(red_shape, aval.dtype), axes=(axis,),
                    index_dtype=aval.dtype)
        return _keep(L, red, x, (axis,), aval) if keep else red
    return h


def _h_cat(L, n):
    xs = [L.atom(a) for a in n.args[0]]
    aval = L.aval(n)
    nd = len(aval.shape)
    dim = int(n.args[1] if len(n.args) > 1 else n.kwargs.get("dim", 0)) % nd
    xs = [_cast_to(L, x, aval.dtype) for x in xs
          if not (len(x.aval.shape) == 1 and x.aval.shape[0] == 0)]
    return L.one("concatenate", xs, aval, dimension=dim)


def _h_stack(L, n):
    aval = L.aval(n)
    nd = len(aval.shape)
    dim = int(n.args[1] if len(n.args) > 1 else 0) % nd
    xs = []
    for a in n.args[0]:
        x = L.atom(a)
        shape = list(x.aval.shape)
        shape.insert(dim, 1)
        xs.append(L.one("reshape", [x], _Aval(shape, x.aval.dtype),
                        new_sizes=tuple(shape)))
    return L.one("concatenate", xs, aval, dimension=dim)


def _h_split(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    vals = n.meta["val"]
    dim = int(n.args[2] if len(n.args) > 2 else n.kwargs.get("dim", 0)) % nd
    sizes = [int(v.shape[dim]) for v in vals]
    return L.emit("split", [x], [_aval_of(v) for v in vals],
                  {"axis": dim, "sizes": sizes})


def _h_unbind(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    dim = int(n.args[1] if len(n.args) > 1 else 0) % nd
    k = x.aval.shape[dim]
    piece = list(x.aval.shape)
    piece[dim] = 1
    parts = L.emit("split", [x], [_Aval(piece, x.aval.dtype)] * k,
                   {"axis": dim, "sizes": [1] * k})
    return [L.one("reshape", [p], _aval_of(v), new_sizes=tuple(v.shape))
            for p, v in zip(parts, n.meta["val"])]


def _h_slice(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    dim = int(n.args[1] if len(n.args) > 1 else 0) % nd
    start = n.args[2] if len(n.args) > 2 else 0
    end = n.args[3] if len(n.args) > 3 else None
    step = n.args[4] if len(n.args) > 4 else 1
    size = x.aval.shape[dim]
    start = 0 if start is None else int(start)
    end = size if end is None else int(end)
    start = max(0, start + size if start < 0 else start)
    end = min(size, max(0, end + size if end < 0 else end))
    starts = [0] * nd
    limits = list(x.aval.shape)
    starts[dim], limits[dim] = start, end
    if start == 0 and end == size and step == 1:
        return x
    return L.one("slice", [x], L.aval(n), start_indices=tuple(starts),
                 limit_indices=tuple(limits),
                 strides=None if step == 1 else tuple(
                     step if i == dim else 1 for i in range(nd)))


def _h_select(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    dim = int(n.args[1]) % nd
    idx = int(n.args[2]) % x.aval.shape[dim]
    starts = [0] * nd
    limits = list(x.aval.shape)
    starts[dim], limits[dim] = idx, idx + 1
    shape = list(x.aval.shape)
    shape[dim] = 1
    s = L.one("slice", [x], _Aval(shape, x.aval.dtype),
              start_indices=tuple(starts), limit_indices=tuple(limits),
              strides=None)
    aval = L.aval(n)
    return L.one("reshape", [s], aval, new_sizes=aval.shape)


def _h_squeeze(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    if tuple(x.aval.shape) == aval.shape:
        return x
    return L.one("reshape", [x], aval, new_sizes=aval.shape)


def _h_cumsum(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    axis = int(n.args[1]) % len(x.aval.shape)
    return L.one("cumsum", [x], aval, axis=axis, reverse=False)


def _h_pad(L, n):
    x = L.atom(n.args[0])
    flat = list(n.args[1])
    value = n.args[2] if len(n.args) > 2 else n.kwargs.get("value", 0.0)
    nd = len(x.aval.shape)
    cfg = [(0, 0, 0)] * nd
    for i in range(len(flat) // 2):
        d = nd - 1 - i
        cfg[d] = (int(flat[2 * i]), int(flat[2 * i + 1]), 0)
    aval = L.aval(n)
    return L.one("pad", [x, Literal(value, aval.dtype)], aval,
                 padding_config=tuple(cfg))


def _h_to(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    if x.aval.dtype == aval.dtype or isinstance(x, Literal) and \
            x.aval.dtype == aval.dtype:
        return x
    if isinstance(x, Literal):
        return Literal(x.val.item(), aval.dtype)
    return L.one("convert_element_type", [x], aval, new_dtype=aval.dtype)


def _h_like(value):
    def h(L, n):
        aval = L.aval(n)
        v = value if value is not None else n.args[1]
        return L.one("broadcast_in_dim", [Literal(v, aval.dtype)], aval,
                     shape=aval.shape, broadcast_dimensions=())
    return h


def _h_full(L, n):
    aval = L.aval(n)
    v = n.args[1] if n.target == aten.full.default else (
        1 if n.target == aten.ones.default else 0)
    return L.one("broadcast_in_dim", [Literal(v, aval.dtype)], aval,
                 shape=aval.shape, broadcast_dimensions=())


def _h_embedding(L, n):
    w, ids = L.atom(n.args[0]), L.atom(n.args[1])
    return L.one("__embedding", [w, ids], L.aval(n))


def _h_index_select(L, n):
    x, dim, idx = n.args[:3]
    xa = L.atom(x)
    if int(dim) % len(xa.aval.shape) != 0:
        raise NotImplementedError(
            "only embedding-style gathers (single leading-axis index) "
            "export to lookup_table_v2")
    return L.one("__embedding", [xa, L.atom(idx)], L.aval(n))


def _h_index(L, n):
    x, idxs = n.args[0], n.args[1]
    if len(idxs) != 1 or idxs[0] is None:
        raise NotImplementedError(
            "only embedding-style gathers (single leading-axis index) "
            "export to lookup_table_v2")
    return L.one("__embedding", [L.atom(x), L.atom(idxs[0])], L.aval(n))


def _h_softmax(L, n):
    x = L.atom(n.args[0])
    axis = int(n.args[1]) % len(x.aval.shape)
    return L.one("__softmax", [x], L.aval(n), axis=axis)


def _h_log_softmax(L, n):
    x = L.atom(n.args[0])
    aval = L.aval(n)
    axis = int(n.args[1]) % len(x.aval.shape)
    red_shape = tuple(d for i, d in enumerate(aval.shape) if i != axis)
    m = L.one("reduce_max", [x], _Aval(red_shape, aval.dtype), axes=(axis,))
    m = L.one("stop_gradient", [_keep(L, m, x, (axis,), aval)], aval)
    z = L.one("sub", [x, m], aval)
    s = L.one("reduce_sum", [L.one("exp", [z], aval)],
              _Aval(red_shape, aval.dtype), axes=(axis,))
    ls = L.one("log", [s], _Aval(red_shape, aval.dtype))
    return L.one("sub", [z, _keep(L, ls, x, (axis,), aval)], aval)


def _h_gelu(L, n):
    approx = n.kwargs.get("approximate", n.args[1] if len(n.args) > 1
                          else "none")
    return L.one("__gelu", [L.atom(n.args[0])], L.aval(n),
                 approximate=approx == "tanh")


def _const_operand(L, a, what):
    v = L.atom(a) if a is not None else None
    if v is not None and not isinstance(v, _Const):
        raise NotImplementedError(
            f"{what} with a computed (non-parameter) operand is not "
            "exportable")
    return v


def _h_layer_norm(L, n):
    x, shape, w, b, eps = n.args[:5]
    if len(shape) != 1 or w is None or b is None:
        raise NotImplementedError(
            "layer_norm over several trailing dims or without both "
            "weight and bias is not exportable")
    out = L.one("__layer_norm", [L.atom(x), _const_operand(L, w, "layer_norm"),
                                 _const_operand(L, b, "layer_norm")],
                _aval_of(n.meta["val"][0]), epsilon=float(eps),
                begin_norm_axis=len(L.atom(x).aval.shape) - 1)
    return [out, None, None]


def _h_batch_norm(L, n):
    x, w, b, mean, var, _mom, eps = n.args[:7]
    out = L.one("__batch_norm",
                [L.atom(x), _const_operand(L, mean, "batch_norm"),
                 _const_operand(L, var, "batch_norm"),
                 _const_operand(L, w, "batch_norm"),
                 _const_operand(L, b, "batch_norm")],
                _aval_of(n.meta["val"][0]), epsilon=float(eps))
    return [out, None, None]


def _h_convolution(L, n):
    x, w, bias, stride, padding, dilation, transposed, out_pad, groups = \
        n.args[:9]
    xa, wa = L.atom(x), L.atom(w)
    aval = L.aval(n)
    if len(xa.aval.shape) != 4:
        raise NotImplementedError("only 2-D NCHW convolutions export")
    if transposed:
        out = L.one("__conv2d_transpose", [xa, wa], aval,
                    strides=[int(s) for s in stride],
                    paddings=[int(p) for p in padding],
                    output_padding=[int(p) for p in out_pad],
                    dilations=[int(d) for d in dilation],
                    groups=int(groups))
    else:
        out = L.one("conv_general_dilated", [xa, wa], aval,
                    window_strides=tuple(int(s) for s in stride),
                    padding=tuple((int(p), int(p)) for p in padding),
                    rhs_dilation=tuple(int(d) for d in dilation),
                    feature_group_count=int(groups))
    if bias is None:
        return out
    b = L.atom(bias)
    c = b.aval.shape[0]
    bc = L.one("broadcast_in_dim", [b], _Aval((1, c, 1, 1), b.aval.dtype),
               shape=(1, c, 1, 1), broadcast_dimensions=(1,))
    return L.one("add", [out, bc], aval)


def _h_reduce_window(L, n):
    x, dims, ksize, strides, pads, kind = n.args[:6]
    xa = L.atom(x)
    nd = len(xa.aval.shape)
    win, st, pad = [1] * nd, [1] * nd, [(0, 0)] * nd
    for i, d in enumerate(dims):
        win[d], st[d] = int(ksize[i]), int(strides[i])
        pad[d] = (int(pads[2 * i]), int(pads[2 * i + 1]))
    return L.one("reduce_window_max" if kind == "max"
                 else "reduce_window_sum", [xa], L.aval(n),
                 window_dimensions=tuple(win), window_strides=tuple(st),
                 padding=tuple(pad))


def _sub_program(gm):
    """A branch or loop body (a sub-GraphModule) lowered on its own."""
    return _Lowering(gm, {}).run()


def _h_cond(L, n):
    pred, true_gm, false_gm, operands = n.args[:4]
    p = L.atom(pred)
    ops = [L.atom(o) for o in operands]
    tg, fg = L.env[true_gm], L.env[false_gm]
    tp = _sub_program(tg)
    fp = _sub_program(fg)
    avals = [_aval_of(v) for v in n.meta["val"]]
    return L.emit("cond", [p] + ops, avals, {"true": tp, "false": fp})


def _h_while(L, n):
    cond_gm, body_gm, carried, extra = n.args[:4]
    cs = [L.atom(c) for c in carried]
    es = [L.atom(e) for e in extra]
    cp = _sub_program(L.env[cond_gm])
    bp = _sub_program(L.env[body_gm])
    avals = [_aval_of(v) for v in n.meta["val"]]
    return L.emit("while", cs + es, avals,
                  {"cond": cp, "body": bp, "num_carried": len(cs)})


def _h_flip(L, n):
    x = L.atom(n.args[0])
    nd = len(x.aval.shape)
    return L.one("rev", [x], L.aval(n),
                 dimensions=tuple(sorted(int(d) % nd for d in n.args[1])))


def _h_amax(L, n):
    return _reduce_h("reduce_max")(L, n)


_ATEN = {
    aten.view.default: _h_view, aten._unsafe_view.default: _h_view,
    aten.reshape.default: _h_view, aten.unsqueeze.default: _h_view,
    aten.flatten.using_ints: _h_view,
    aten.squeeze.dim: _h_squeeze, aten.squeeze.dims: _h_squeeze,
    aten.squeeze.default: _h_squeeze,
    aten.permute.default: _h_permute, aten.t.default: _h_t,
    aten.transpose.int: _h_transpose, aten.flip.default: _h_flip,
    aten.expand.default: _h_expand,
    aten.mm.default: _h_dot, aten.bmm.default: _h_dot,
    aten.addmm.default: _h_addmm,
    aten.rsub.Scalar: _h_rsub,
    aten.reciprocal.default: _h_reciprocal,
    aten.relu.default: _h_relu, aten.silu.default: _h_silu,
    aten.leaky_relu.default: _h_leaky_relu,
    aten.hardtanh.default: _h_clamp,
    aten.pow.Tensor_Scalar: _h_pow, aten.pow.Tensor_Tensor: _h_pow,
    aten.clamp.default: _h_clamp, aten.clamp_min.default: _h_clamp,
    aten.where.self: _h_where, aten.masked_fill.Scalar: _h_masked_fill,
    aten.masked_fill.Tensor: _h_masked_fill,
    aten.sum.dim_IntList: _reduce_h("reduce_sum"),
    aten.sum.default: _h_sum_default,
    aten.amax.default: _h_amax, aten.amin.default: _reduce_h("reduce_min"),
    aten.prod.dim_int: _reduce_h("reduce_prod"),
    aten.mean.dim: _h_mean, aten.mean.default: _h_mean,
    aten.argmax.default: _h_arg("argmax"),
    aten.argmin.default: _h_arg("argmin"),
    aten.cat.default: _h_cat, aten.stack.default: _h_stack,
    aten.split.Tensor: _h_split, aten.split_with_sizes.default: _h_split,
    aten.unbind.int: _h_unbind,
    aten.slice.Tensor: _h_slice, aten.select.int: _h_select,
    aten.cumsum.default: _h_cumsum,
    aten.constant_pad_nd.default: _h_pad,
    aten._to_copy.default: _h_to, aten.to.dtype: _h_to,
    aten.ones_like.default: _h_like(1), aten.zeros_like.default: _h_like(0),
    aten.full_like.default: _h_like(None),
    aten.full.default: _h_full, aten.ones.default: _h_full,
    aten.zeros.default: _h_full,
    aten.embedding.default: _h_embedding,
    aten.index_select.default: _h_index_select,
    aten.index.Tensor: _h_index,
    aten._softmax.default: _h_softmax,
    aten._log_softmax.default: _h_log_softmax,
    aten.gelu.default: _h_gelu,
    aten.native_layer_norm.default: _h_layer_norm,
    aten._native_batch_norm_legit_no_training.default: _h_batch_norm,
    aten.convolution.default: _h_convolution,
    torch.ops.higher_order.cond: _h_cond,
    torch.ops.higher_order.while_loop: _h_while,
}
for _op, _prim in _BIN_ATEN.items():
    _pk = getattr(aten, _op, None)
    if _pk is not None:
        _ATEN[_pk] = _h_binary
for _op in _UNARY_ATEN:
    _ATEN[_op] = _h_unary


def _register_reduce_window():
    _ATEN[_reduce_window_op()._opoverload] = _h_reduce_window


def lower(gm, static_inputs=None):
    """The aten graph ``gm`` as a :class:`Program` in the JAX
    exporter's vocabulary; ``static_inputs`` maps placeholder positions
    to :class:`_Const` values (the parameters)."""
    _register_reduce_window()
    return _Lowering(gm, static_inputs or {}).run()


def _spec_dtype(spec):
    from ..framework.dtype import convert_dtype

    return convert_dtype(spec.dtype) or torch.float32


def trace_specs(layer, input_specs):
    """``(Program, args)``: ``layer`` traced at the InputSpec shapes
    (None/-1 dims at ``_BATCH``) and lowered, the parameters as
    constants; ``args`` are the example tensors' shapes and dtypes."""
    names, values = _state_of(layer)
    device = values[0].device if values else torch.device("cpu")
    examples = []
    for spec in input_specs:
        dims = tuple(_BATCH if (d is None or d == -1) else int(d)
                     for d in spec.shape)
        examples.append(torch.empty(dims, dtype=_spec_dtype(spec),
                                    device=device))
    gm, names, values = trace(layer, examples)
    static = {}
    for i, v in enumerate(values):
        arr = _np_value(v)
        static[i] = _Const(arr, key=("param", id(v)))
    return lower(gm, static), examples


# ------------------------------------------------------------ public API --

def export_reference_inference_model(path_prefix, input_specs, layer):
    """Write ``{path_prefix}.pdmodel`` + ``.pdiparams`` in the reference
    wire format.  Returns the list of emitted op types (feed/fetch
    included) for introspection/testing.

    ``input_specs``: list of static.InputSpec; None/-1 dims are dynamic.
    ``layer``: a Layer over Tensors or a ``torch.nn.Module`` over torch
    tensors; it is traced on the device its parameters live on.
    """
    specs = list(input_specs)
    if not specs:
        raise ValueError("reference-format export needs at least one "
                         "InputSpec describing the program feeds")
    for spec in specs:
        if _BATCH in [d for d in spec.shape if d is not None and d != -1]:
            raise NotImplementedError(
                f"a concrete InputSpec dim equals the dynamic-dim "
                f"placeholder ({_BATCH}); pad the dimension by one or "
                "export with a different extent")

    prog, examples = trace_specs(layer, specs)
    ex = _Exporter()
    outs = prog.outvars
    live = {v for v in outs if not _atomic(v)}
    flat = _fuse_peepholes(_dce(list(prog.eqns), live), outs)

    # feeds
    for i, (spec, arg) in enumerate(zip(specs, examples)):
        fname = spec.name or f"x{i}"
        dt = np_dtype(arg.dtype)
        ex._declare(fname, tuple(arg.shape), dt)
        ex.env[prog.invars[i]] = _Ref(fname, tuple(arg.shape), dt)
        ex._emit("feed", {"X": ["feed"]}, {"Out": [fname]},
                 [("col", "i", i)])

    for name, ins, outvars, prm in flat:
        translate(ex, name, ins, outvars, prm)

    # fetches
    for i, atom in enumerate(outs):
        v = ex.val(atom)
        v = ex.force(v) if isinstance(v, _Ref) else ex.materialize(v)
        ex._emit("fetch", {"X": [v.name]}, {"Out": ["fetch"]},
                 [("col", "i", i)])

    # serialize
    var_blobs = [_enc_var("feed", [], 0, True, vtype=_FEED_MINIBATCH),
                 _enc_var("fetch", [], 0, True, vtype=_FETCH_LIST)]
    for name, (dims, code, persistable) in sorted(ex.vars.items()):
        var_blobs.append(_enc_var(name, dims, code, persistable))
    op_blobs = [_enc_op(t, i, o, a) for t, i, o, a in ex.ops]
    sub_blobs = [[_enc_op(t, i, o, a) for t, i, o, a in blk]
                 for blk in ex.sub_blocks]
    with open(f"{path_prefix}.pdmodel", "wb") as f:
        f.write(_enc_program(op_blobs, var_blobs, sub_blobs))
    blob = b"".join(_tensor_stream(ex.params[k])
                    for k in sorted(ex.params))
    with open(f"{path_prefix}.pdiparams", "wb") as f:
        f.write(blob)
    return [t for t, _i, _o, _a in ex.ops]
