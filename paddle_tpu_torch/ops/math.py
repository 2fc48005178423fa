"""Elementwise & reduction math ops (paddle.tensor.math parity).

Port of ``paddle_tpu/ops/math.py``: each op is its torch composition on
torch tensors.  Where jnp and torch differ in meaning, the body keeps
jnp's: ``mod`` is the floored remainder, ``median`` averages the two
middle values of an even count, ``max``/``min`` reduce values only.
"""

import builtins

import torch

from ..framework.dtype import convert_dtype
from .registry import op


def _dims(x, axis):
    """A Paddle ``axis`` (None, int or list) -> the tuple of torch dims."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)  # noqa: H001 (int attrs by contract)


def _reduction(x, axis, keepdim):
    """(x, dims, keepdim) for a torch reduction of ``axis``.  An empty
    axis list reduces nothing, as in JAX (torch reads ``dim=()`` as every
    dim): x gains a leading unit axis, the only one reduced, so the op
    keeps its own dtype rules and gives x's shape."""
    if isinstance(axis, (list, tuple)) and not axis:
        return x.unsqueeze(0), (0,), False
    return x, _dims(x, axis), keepdim


def _flat_axis(x, axis):
    """(x flattened, 0) when ``axis`` is None, else (x, axis)."""
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def _scalar_like(v, x):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v, dtype=x.dtype, device=x.device)


# ---- JAX's derivatives at kinks and ties (ROADMAP C6) ----
# ``lax.abs`` has derivative +1 at 0 (torch: 0); ``jnp.maximum`` /
# ``jnp.minimum`` split a tie's gradient in halves, as ``torch.maximum``
# does and ``torch.clamp`` (all of it to x) does not.

def jabs(x):
    """``jnp.abs``: |x|, with derivative +1 at 0."""
    if x.is_complex():
        return torch.abs(x)
    return torch.where(x >= 0, x, -x)


def jmaximum(x, v):
    """``jnp.maximum(x, v)`` for a tensor or a scalar ``v``."""
    return torch.maximum(x, _scalar_like(v, x))


def jminimum(x, v):
    """``jnp.minimum(x, v)`` for a tensor or a scalar ``v``."""
    return torch.minimum(x, _scalar_like(v, x))


def jclip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, a bound's tie
    taking half the gradient."""
    if lo is not None:
        x = jmaximum(x, lo)
    if hi is not None:
        x = jminimum(x, hi)
    return x


def _associative_scan(fn, elems, axis):
    """``lax.associative_scan(fn, elems, axis=axis)``, the same pairwise
    tree, so that a tie in ``fn`` splits its gradient as in JAX."""
    n = elems.shape[axis]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * (axis % t.dim())
                 + (slice(start, stop, step),)]

    reduced = fn(sl(elems, 0, -1, 2), sl(elems, 1, None, 2))
    odd = _associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn(sl(odd, 0, -1), sl(elems, 2, None, 2))
    else:
        even = fn(odd, sl(elems, 2, None, 2))
    even = torch.cat([sl(elems, 0, 1), even], dim=axis)
    return _interleave(even, odd, axis)


def _interleave(a, b, axis):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) - len(b) is
    0 or 1)."""
    axis = axis % a.dim()
    na, nb = a.shape[axis], b.shape[axis]
    if nb < na:
        pad = list(b.shape)
        pad[axis] = 1
        b = torch.cat([b, torch.zeros(pad, dtype=b.dtype, device=b.device)],
                      dim=axis)
    out = torch.stack([a, b], dim=axis + 1).flatten(axis, axis + 1)
    return out.narrow(axis, 0, na + nb)

# ---- binary elementwise ----

@op()
def add(x, y):
    return torch.add(x, y)

@op()
def subtract(x, y):
    return torch.subtract(x, y)

@op()
def multiply(x, y):
    return torch.multiply(x, y)

@op()
def divide(x, y):
    return torch.true_divide(x, y)

@op()
def floor_divide(x, y):
    return torch.floor_divide(x, y)

@op()
def mod(x, y):
    return torch.remainder(x, y)

remainder = mod

@op()
def pow(x, y):
    return torch.pow(x, y)

@op()
def maximum(x, y):
    return torch.maximum(x, _scalar_like(y, x))

@op()
def minimum(x, y):
    return torch.minimum(x, _scalar_like(y, x))

@op()
def fmax(x, y):
    return torch.where((x > y) | torch.isnan(y), x, y)

@op()
def fmin(x, y):
    return torch.where((x < y) | torch.isnan(y), x, y)

@op()
def atan2(x, y):
    return torch.atan2(x, y)

@op()
def hypot(x, y):
    return torch.hypot(x, y)

@op()
def logaddexp(x, y):
    return torch.logaddexp(x, y)

@op()
def heaviside(x, y):
    # jnp's composition (torch's heaviside has no derivative)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.where(x < 0, zero, torch.where(x > 0, one, y.to(x.dtype)))

@op()
def copysign(x, y):
    return torch.copysign(x, y)

@op()
def gcd(x, y):
    return torch.gcd(x, y)

@op()
def lcm(x, y):
    return torch.lcm(x, y)

@op()
def inner(x, y):
    return torch.inner(x, y)

@op()
def outer(x, y):
    return torch.outer(x, y)

@op()
def kron(x, y):
    return torch.kron(x, y)

# ---- unary elementwise ----

@op()
def sqrt(x):
    return torch.sqrt(x)

@op()
def rsqrt(x):
    return torch.rsqrt(x)

@op()
def exp(x):
    return torch.exp(x)

@op()
def expm1(x):
    return torch.expm1(x)

@op()
def log(x):
    return torch.log(x)

@op()
def log2(x):
    return torch.log2(x)

@op()
def log10(x):
    return torch.log10(x)

@op()
def log1p(x):
    return torch.log1p(x)

@op("abs")
def abs_(x):
    return jabs(x)

@op()
def neg(x):
    return torch.neg(x)

@op()
def sign(x):
    return torch.sign(x)

@op()
def floor(x):
    return torch.floor(x)

@op()
def ceil(x):
    return torch.ceil(x)

@op("round")
def round_(x):
    return torch.round(x)

@op()
def trunc(x):
    return torch.trunc(x)

@op()
def frac(x):
    return x - torch.trunc(x)

@op()
def sin(x):
    return torch.sin(x)

@op()
def cos(x):
    return torch.cos(x)

@op()
def tan(x):
    return torch.tan(x)

@op()
def asin(x):
    return torch.asin(x)

@op()
def acos(x):
    return torch.acos(x)

@op()
def atan(x):
    return torch.atan(x)

@op()
def sinh(x):
    return torch.sinh(x)

@op()
def cosh(x):
    return torch.cosh(x)

@op()
def tanh(x):
    return torch.tanh(x)

@op()
def asinh(x):
    return torch.asinh(x)

@op()
def acosh(x):
    return torch.acosh(x)

@op()
def atanh(x):
    return torch.atanh(x)

@op()
def reciprocal(x):
    return torch.reciprocal(x)

@op()
def square(x):
    return torch.square(x)

@op()
def erf(x):
    return torch.special.erf(x)

@op()
def erfinv(x):
    return torch.special.erfinv(x)

@op()
def digamma(x):
    return torch.special.digamma(x)

@op()
def lgamma(x):
    return torch.lgamma(x)

@op()
def polygamma(x, n):
    return torch.special.polygamma(n, x)

@op()
def i0(x):
    return torch.special.i0(x)

@op()
def i1(x):
    return torch.special.i1(x)

@op()
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))

@op()
def sigmoid(x):
    return torch.sigmoid(x)

@op()
def angle(x):
    return torch.angle(x)

@op()
def conj(x):
    return torch.conj_physical(x)

@op()
def real(x):
    return torch.real(x).clone() if x.is_complex() else x.clone()

@op()
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)

@op()
def rad2deg(x):
    return torch.rad2deg(x)

@op()
def deg2rad(x):
    return torch.deg2rad(x)

@op()
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)

@op()
def clip(x, min=None, max=None):
    return jclip(x, min, max)

@op()
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    return out

@op()
def lerp(x, y, weight):
    return x + weight * (y - x)

@op()
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)

@op()
def increment(x, value=1.0):
    return x + value

# ---- reductions ----

@op("sum")
def sum_(x, axis=None, dtype=None, keepdim=False):
    dtype = convert_dtype(dtype)
    if dtype is None and x.dtype == torch.bool:
        dtype = torch.int64
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dtype)

@op()
def nansum(x, axis=None, dtype=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.nansum(x, dim=dims, keepdim=keepdim,
                        dtype=convert_dtype(dtype))

@op()
def mean(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.mean(x, dim=dims, keepdim=keepdim)

@op()
def nanmean(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.nanmean(x, dim=dims, keepdim=keepdim)

@op()
def prod(x, axis=None, keepdim=False, dtype=None):
    out = x if dtype is None else x.to(convert_dtype(dtype))
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out

@op("max")
def max_(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.amax(x, dim=dims, keepdim=keepdim)

@op("min")
def min_(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.amin(x, dim=dims, keepdim=keepdim)

@op()
def amax(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.amax(x, dim=dims, keepdim=keepdim)

@op()
def amin(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.amin(x, dim=dims, keepdim=keepdim)

@op()
def logsumexp(x, axis=None, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)

@op()
def std(x, axis=None, unbiased=True, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.std(x, dim=dims, correction=1 if unbiased else 0,
                     keepdim=keepdim)

@op()
def var(x, axis=None, unbiased=True, keepdim=False):
    x, dims, keepdim = _reduction(x, axis, keepdim)
    return torch.var(x, dim=dims, correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    if isinstance(axis, (list, tuple)) and not axis:
        return fn(x.unsqueeze(0), q, dim=0)
    if axis is None:
        out = fn(x.reshape(-1), q)
        return out.reshape([1] * x.dim()) if keepdim else out
    return fn(x, q, dim=axis, keepdim=keepdim)

@op()
def median(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)

@op()
def nanmedian(x, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)

@op()
def quantile(x, q, axis=None, keepdim=False):
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return _quantile(torch.quantile, x, q, axis, keepdim)

@op()
def cumsum(x, axis=None, dtype=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=convert_dtype(dtype))

@op()
def cumprod(x, dim=None, dtype=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=convert_dtype(dtype))

@op()
def cummax(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return _associative_scan(torch.maximum, x, axis)

@op()
def cummin(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return _associative_scan(torch.minimum, x, axis)

@op()
def logcumsumexp(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(x, dim=axis)

@op()
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)

@op()
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)

# ---- comparison-reductions / checks ----

@op("all")
def all_(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)

@op("any")
def any_(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)

@op()
def isnan(x):
    return torch.isnan(x)

@op()
def isinf(x):
    return torch.isinf(x)

@op()
def isfinite(x):
    return torch.isfinite(x)

@op()
def isneginf(x):
    return torch.isneginf(x)

@op()
def isposinf(x):
    return torch.isposinf(x)

@op()
def isreal(x):
    return torch.isreal(x)

@op()
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)

@op()
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))

@op()
def equal_all(x, y):
    same = x.shape == y.shape and torch.equal(x, y)
    return torch.tensor(same, device=x.device)
