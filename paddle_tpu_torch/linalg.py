"""paddle.linalg namespace (reference python/paddle/tensor/linalg.py
exported via python/paddle/linalg.py) — re-exports the registered linear
-algebra ops under their namespaced home."""

from .ops.registry import OPS as _OPS

_NAMES = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
    "eig", "eigh", "eigvals", "eigvalsh", "householder_product", "inv",
    "lstsq", "lu", "lu_unpack", "matrix_power", "matrix_rank", "multi_dot",
    "norm", "pinv", "qr", "slogdet", "solve", "svd", "triangular_solve",
]

for _n in _NAMES:
    if _n in _OPS:
        globals()[_n] = _OPS[_n].user_fn

# matmul/transpose also live here in the reference namespace
for _n in ("matmul", "transpose", "dot", "t"):
    if _n in _OPS:
        globals()[_n] = _OPS[_n].user_fn

__all__ = [n for n in (_NAMES + ["matmul", "transpose", "dot", "t"])
           if n in globals()]
