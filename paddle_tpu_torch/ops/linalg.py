"""Linear algebra ops (paddle.tensor.linalg parity).

Port of ``paddle_tpu/ops/linalg.py``.  The products (``matmul``, ``bmm``,
``mm``, ``mv``, ``einsum``) are ``torch.matmul`` / ``torch.einsum``,
cuBLAS on the card, as the JAX package leaves them to XLA's dot.  The
decompositions keep jnp's conventions where torch's differ: ``qr``
with ``mode="r"`` returns R alone, ``lu`` returns LAPACK's 1-based
int32 pivots, ``lstsq`` is jnp's SVD solve (residuals always, rank by
``rcond · s[0]``), ``histogram`` bins as ``jnp.histogram`` does (edges
from ``linspace``, the last one inclusive) and ``bincount`` never
returns an empty result.
"""

import torch

from .registry import op


def _t(x):
    return x.transpose(-1, -2)


@op()
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = _t(x)
    if transpose_y and y.dim() > 1:
        y = _t(y)
    return torch.matmul(x, y)


@op()
def bmm(x, y):
    return torch.matmul(x, y)


@op()
def mm(x, y):
    return torch.matmul(x, y)


@op()
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op()
def mv(x, vec):
    return torch.matmul(x, vec)


@op()
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@op()
def multi_dot(x):
    return torch.linalg.multi_dot(list(x))


_INF = float("inf")


@op()
def norm(x, p="fro", axis=None, keepdim=False):
    if axis is None:
        flat = x.reshape(-1)
        if p in ("fro", 2):
            return torch.linalg.vector_norm(flat, 2)
        if p == _INF:
            return torch.max(torch.abs(flat))
        if p == -_INF:
            return torch.min(torch.abs(flat))
        if p == 0:
            return torch.sum(flat != 0).to(x.dtype)
        return torch.sum(torch.abs(flat) ** p) ** (1.0 / p)
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                        keepdim=keepdim)
    if isinstance(axis, (list, tuple)):
        axis = axis[0]
    if p == "fro":
        p = 2
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


@op()
def dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(d.dtype)
    if p == _INF:
        return torch.max(torch.abs(d))
    if p == -_INF:
        return torch.min(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


@op()
def cross(x, y, axis=9):
    axis = -1 if axis == 9 else axis
    return torch.linalg.cross(x, y, dim=axis)


@op()
def cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return _t(L).conj() if upper else L


@op()
def cholesky_solve(x, y, upper=False):
    # solve A z = x given the Cholesky factor y of A
    fac = y if not upper else _t(y).conj()
    z = torch.linalg.solve_triangular(fac, x, upper=False)
    return torch.linalg.solve_triangular(_t(fac).conj(), z, upper=True)


@op()
def inverse(x):
    return torch.linalg.inv(x)


@op()
def det(x):
    return torch.linalg.det(x)


@op()
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@op()
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@op()
def svdvals(x):
    return torch.linalg.svdvals(x)


@op()
def qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r")[1]
    return tuple(torch.linalg.qr(x, mode=mode))


@op()
def eig(x):
    return tuple(torch.linalg.eig(x))


@op()
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@op()
def eigvals(x):
    return torch.linalg.eigvals(x)


@op()
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@op()
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@op()
def solve(x, y):
    return torch.linalg.solve(x, y)


@op()
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """Solve ``op(x) z = y`` for triangular ``x`` (``op`` the transpose
    when ``transpose``); a 1-D ``y`` is one right-hand side."""
    a = _t(x) if transpose else x
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    z = torch.linalg.solve_triangular(a, b, upper=upper != transpose,
                                      unitriangular=unitriangular)
    return z[:, 0] if vec else z


@op()
def lu(x, pivot=True):
    lu_mat, piv = torch.linalg.lu_factor(x)
    return lu_mat, piv.to(torch.int32)  # paddle pivots are 1-based


@op()
def lstsq(x, y, rcond=None, driver=None):
    """jnp's least squares through the SVD -> (solution, residuals,
    rank, singular values)."""
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    m, n = x.shape[-2], x.shape[-1]
    eps = torch.finfo(x.dtype).eps
    rc = eps * max(n, m) if rcond is None else (eps if rcond < 0 else rcond)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rc * s[0])
    rank = mask.sum().to(torch.int32)
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    sol = _t(vt).conj() @ (s_inv * (_t(u).conj() @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    if vec:
        sol = sol.reshape(-1)
    return sol, resid, rank, s


@op()
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@op()
def matrix_rank(x, tol=None, hermitian=False):
    s = torch.linalg.svdvals(x)
    rtol = (torch.finfo(s.dtype).eps * max(x.shape[-2:])
            if tol is None else tol)
    cut = rtol * s.amax(dim=-1, keepdim=True)
    return torch.sum(s > cut, dim=-1)


@op()
def cond(x, p=None):
    return torch.linalg.cond(x, p=p)


@op()
def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *operands)


@op()
def histogram(x, bins=100, min=0, max=0, weight=None, density=False):
    a = x.reshape(-1)
    fdt = a.dtype if a.is_floating_point() else torch.float32
    if min == 0 and max == 0:
        lo, hi = a.min().item(), a.max().item()  # noqa: H001 (data-dependent range, as jnp.histogram reads it)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    else:
        lo, hi = min, max
    edges = torch.linspace(lo, hi, bins + 1, dtype=fdt, device=a.device)
    af = a.to(fdt)
    idx = torch.searchsorted(edges, af, right=True)
    idx = torch.where(af == edges[-1], bins, idx)
    w = torch.ones_like(af) if weight is None else weight.reshape(-1)
    keep = idx <= bins
    counts = torch.zeros(bins + 2, dtype=w.dtype, device=a.device)
    counts.index_add_(0, torch.where(keep, idx, bins + 1), w)
    counts = counts[1:bins + 1]
    if density:
        return counts / torch.diff(edges) / counts.sum()
    return counts if weight is not None else counts.to(torch.int64)


@op()
def bincount(x, weights=None, minlength=0):
    length = max(minlength, int(x.max()) + 1 if x.numel() else  # noqa: H001 (data-dependent length, eager-only)
                 minlength)
    out = torch.bincount(x, weights=weights, minlength=max(length, 1))
    return out if weights is None else out.to(weights.dtype)


@op()
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else _t(x))


@op()
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else _t(x), correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@op()
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op()
def matrix_transpose(x):
    return _t(x)


@op()
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)
