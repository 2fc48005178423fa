"""Op library: registry + eager dispatch + Tensor method patching.

Port of ``paddle_tpu/ops/__init__.py``: every op family of the JAX
package is imported here, in its order (``nn/functional.py`` registers
its own), so the registry holds the whole inventory
(``inventory.OP_INVENTORY``).
"""

from . import creation, linalg, logic, manipulation, math, random  # noqa: F401
from . import (  # noqa: F401
    conv_extra,
    fft_ops,
    fused_ops,
    graph_ops,
    misc_ops,
    optim_ops,
    pool_ops,
    seq_ops,
    sparse_ops,
    vision_ops,
)
from .dispatch import (  # noqa: F401
    apply_op,
    dispatch_cache_clear,
    dispatch_cache_info,
    enable_dispatch_cache,
    set_debug_hook,
)
from .registry import OPS, coverage, op, raw  # noqa: F401
from ..core.tensor import Tensor


def _u(name):
    return OPS[name].user_fn


# aliases: same op, second paddle-facing name
for _alias, _orig in [("unbind", "unstack"), ("remainder", "mod"),
                      ("inv", "inverse")]:
    if _orig in OPS and _alias not in OPS:
        OPS[_alias] = OPS[_orig]


_BINARY_DUNDERS = {
    "__add__": "add", "__radd__": "add",
    "__sub__": "subtract",
    "__mul__": "multiply", "__rmul__": "multiply",
    "__truediv__": "divide",
    "__floordiv__": "floor_divide",
    "__mod__": "mod",
    "__pow__": "pow",
    "__matmul__": "matmul",
    "__eq__": "equal", "__ne__": "not_equal",
    "__lt__": "less_than", "__le__": "less_equal",
    "__gt__": "greater_than", "__ge__": "greater_equal",
    "__and__": "bitwise_and", "__or__": "bitwise_or",
    "__xor__": "bitwise_xor",
}

_REFLECTED = {
    "__rsub__": "subtract",
    "__rtruediv__": "divide",
    "__rpow__": "pow",
    "__rfloordiv__": "floor_divide",
    "__rmod__": "mod",
    "__rmatmul__": "matmul",
}

# Tensor.<method> -> op name (method signature == op signature minus leading x)
_METHODS = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "maximum", "minimum", "fmax", "fmin", "atan2", "logaddexp",
    "sqrt", "rsqrt", "exp", "expm1", "log", "log2", "log10", "log1p",
    "abs", "neg", "sign", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "reciprocal", "square", "erf", "erfinv",
    "digamma", "lgamma", "logit", "sigmoid", "angle", "conj", "real", "imag",
    "nan_to_num", "clip", "scale", "lerp", "increment",
    "sum", "nansum", "mean", "nanmean", "prod", "max", "min", "amax", "amin",
    "logsumexp", "std", "var", "median", "nanmedian", "quantile",
    "cumsum", "cumprod", "logcumsumexp", "diff",
    "all", "any", "isnan", "isinf", "isfinite", "isclose", "allclose",
    "equal_all", "equal", "not_equal", "greater_than", "greater_equal",
    "less_than", "less_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "reshape", "transpose", "moveaxis", "unstack", "unbind", "split", "chunk",
    "squeeze", "unsqueeze", "flatten", "flip", "rot90", "roll", "tile",
    "expand", "expand_as", "broadcast_to", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "index_add", "index_sample",
    "take_along_axis", "put_along_axis", "masked_select", "masked_fill",
    "where", "unique", "unique_consecutive", "sort", "argsort", "topk",
    "kthvalue", "mode", "argmax", "argmin", "nonzero", "searchsorted",
    "bucketize", "repeat_interleave", "diagonal", "fill_diagonal",
    "tensordot", "as_complex", "as_real",
    "matmul", "bmm", "mm", "dot", "mv", "addmm", "norm", "dist", "cross",
    "cholesky", "inverse", "det", "slogdet", "svd", "qr", "eigvals",
    "pinv", "solve", "matrix_power", "matrix_rank", "lu", "lstsq",
    "cond", "histogram", "bincount", "trace", "cast", "zeros_like",
    "ones_like",
]


def _patch_tensor():
    for dunder, opname in _BINARY_DUNDERS.items():
        if opname not in OPS:
            continue
        fn = _u(opname)

        def make(fn=fn):
            def meth(self, other):
                return fn(self, other)
            return meth
        setattr(Tensor, dunder, make())

    for dunder, opname in _REFLECTED.items():
        if opname not in OPS:
            continue
        fn = _u(opname)

        def make_r(fn=fn):
            def meth(self, other):
                return fn(other, self)
            return meth
        setattr(Tensor, dunder, make_r())

    def _neg(self):
        return _u("neg")(self)

    def _abs(self):
        return _u("abs")(self)

    def _invert(self):
        return _u("logical_not")(self)

    Tensor.__neg__ = _neg
    Tensor.__abs__ = _abs
    Tensor.__invert__ = _invert

    seen = set()
    for name in _METHODS:
        if name in seen or name not in OPS:
            continue
        seen.add(name)
        fn = OPS[name].user_fn

        def make_m(fn=fn):
            def meth(self, *args, **kwargs):
                return fn(self, *args, **kwargs)
            return meth
        if not hasattr(Tensor, name):
            setattr(Tensor, name, make_m())


_patch_tensor()
