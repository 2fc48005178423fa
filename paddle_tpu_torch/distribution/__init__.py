"""paddle.distribution (port of ``paddle_tpu/distribution/__init__.py``;
reference python/paddle/distribution/).

The JAX package's classes over torch: the same parameters, the same
``log_prob`` / ``prob`` / ``entropy`` / ``kl_divergence`` formulas
(differentiable through live Tensors where the JAX classes are, by the
op dispatcher), and ``Normal``'s reparameterised ``rsample``
``loc + scale * eps``.  Samples draw from the global ``torch.Generator``
of the current device (``framework/random.py``, seeded by
``paddle.seed``): they repeat under a seed and agree with the JAX
package's in distribution, not draw for draw (a generator cannot
reproduce a JAX key stream).  Categorical draws are the Gumbel-max
argmax, gamma draws ``torch._standard_gamma``; Beta and Dirichlet are
normalised gammas.
"""

import math

import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..framework.random import generator
from ..ops.dispatch import apply_op


def _d(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=current_device())


def _f32(x):
    return _d(x).to(torch.float32)


def _t(x):
    """Keep Tensors (autograd flows); lift plain values to float32 Tensors."""
    if isinstance(x, Tensor):
        return x
    return _wrap(_f32(x))


def _elemwise(name, fn, *args):
    """Run ``fn`` through the op dispatcher so autograd records it
    (distribution parameters may be live Tensors)."""
    return apply_op(name, fn, args, {})


def _shape(sample_shape, base):
    return tuple(sample_shape) + tuple(base)


def _gen(like):
    return generator(like.device)


def _uniform(shape, like):
    """U[0, 1) draws of ``shape`` in f32 on ``like``'s device."""
    return torch.rand(shape, generator=_gen(like), device=like.device)


def _gamma(conc, shape):
    """Gamma(conc, 1) draws of ``shape`` (``conc`` broadcast to it)."""
    return torch._standard_gamma(conc.expand(shape).contiguous(),
                                 generator=_gen(conc))


def _categorical(logits, shape):
    """Indices drawn from ``softmax(logits)`` (the last axis), ``shape``
    of them over the batch: the Gumbel-max argmax."""
    n = logits.shape[-1]
    u = _uniform(tuple(shape) + (n,), logits)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return _wrap(torch.exp(_d(self.log_prob(value))))

    def entropy(self):
        raise NotImplementedError


class Normal(Distribution):
    """Differentiable: loc/scale may be live Tensors — log_prob, entropy,
    kl_divergence and rsample record on autograd."""

    def __init__(self, loc, scale, name=None):
        self._loc = _t(loc)
        self._scale = _t(scale)
        super().__init__(torch.broadcast_shapes(tuple(self._loc.shape),
                                                tuple(self._scale.shape)))

    @property
    def loc(self):
        return self._loc._data

    @property
    def scale(self):
        return self._scale._data

    def sample(self, shape=()):
        eps = torch.randn(_shape(shape, self.batch_shape),
                          generator=_gen(self.loc), device=self.loc.device)
        return _elemwise("normal_rsample",
                         lambda loc, scale: loc + scale * eps,
                         self._loc, self._scale)

    def log_prob(self, value):
        const = 0.5 * math.log(2 * math.pi)
        return _elemwise(
            "normal_log_prob",
            lambda v, loc, scale: (-((v - loc) ** 2) / (2 * scale ** 2)
                                   - torch.log(scale) - const),
            value if isinstance(value, Tensor) else _t(value),
            self._loc, self._scale)

    def entropy(self):
        shape = self.batch_shape
        return _elemwise(
            "normal_entropy",
            lambda scale: (0.5 + 0.5 * math.log(2 * math.pi)
                           + torch.log(scale)
                           + torch.zeros(shape, device=scale.device)),
            self._scale)

    def kl_divergence(self, other):
        return _elemwise(
            "normal_kl",
            lambda la, sa, lb, sb: (torch.log(sb / sa)
                                    + (sa ** 2 + (la - lb) ** 2)
                                    / (2 * sb ** 2) - 0.5),
            self._loc, self._scale, other._loc, other._scale)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _f32(low)
        self.high = _f32(high)
        super().__init__(torch.broadcast_shapes(self.low.shape,
                                                self.high.shape))

    def sample(self, shape=()):
        u = _uniform(_shape(shape, self.batch_shape), self.low)
        return _wrap(self.low + (self.high - self.low) * u)

    def log_prob(self, value):
        v = _d(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return _wrap(torch.where(inside, lp, -math.inf))

    def entropy(self):
        return _wrap(torch.log(self.high - self.low)
                     + torch.zeros(self.batch_shape, device=self.low.device))


class Bernoulli(Distribution):
    def __init__(self, probs=None, logits=None, name=None):
        if probs is not None:
            self._probs = _t(probs)
        else:
            self._probs = _elemwise("sigmoid", torch.sigmoid, _t(logits))
        super().__init__(tuple(self._probs.shape))

    @property
    def probs(self):
        return self._probs._data

    @property
    def logits(self):
        p = self._probs._data
        return torch.log(p) - torch.log1p(-p)

    def sample(self, shape=()):
        p = self.probs.detach()
        u = _uniform(_shape(shape, self.batch_shape), p)
        return _wrap((u < p).to(torch.float32))

    def log_prob(self, value):
        return _elemwise(
            "bernoulli_log_prob",
            lambda v, p: (v * torch.log(torch.clamp(p, min=1e-12))
                          + (1 - v) * torch.log(torch.clamp(1 - p,
                                                            min=1e-12))),
            value if isinstance(value, Tensor) else _t(value), self._probs)

    def entropy(self):
        return _elemwise(
            "bernoulli_entropy",
            lambda p: -(p * torch.log(torch.clamp(p, min=1e-12))
                        + (1 - p) * torch.log(torch.clamp(1 - p,
                                                          min=1e-12))),
            self._probs)


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self._logits = _t(logits)
        super().__init__(tuple(self._logits.shape)[:-1])

    @property
    def logits(self):
        return self._logits._data

    @property
    def probs(self):
        return torch.softmax(self._logits._data, dim=-1)

    def sample(self, shape=()):
        return _wrap(_categorical(self.logits.detach(),
                                  _shape(shape, self.batch_shape)))

    def log_prob(self, value):
        v = _d(value).long()
        return _elemwise(
            "categorical_log_prob",
            lambda logits: torch.gather(
                torch.log_softmax(logits, dim=-1).expand(
                    v.shape + logits.shape[-1:]),
                -1, v[..., None])[..., 0],
            self._logits)

    def entropy(self):
        return _elemwise(
            "categorical_entropy",
            lambda logits: -torch.sum(
                torch.softmax(logits, -1) * torch.log_softmax(logits, -1),
                dim=-1),
            self._logits)


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _f32(rate)
        super().__init__(self.rate.shape)

    def sample(self, shape=()):
        e = torch.empty(_shape(shape, self.batch_shape),
                        device=self.rate.device)
        return _wrap(e.exponential_(generator=_gen(self.rate)) / self.rate)

    def log_prob(self, value):
        v = _d(value)
        return _wrap(torch.log(self.rate) - self.rate * v)

    def entropy(self):
        return _wrap(1.0 - torch.log(self.rate))


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _f32(loc)
        self.scale = _f32(scale)
        super().__init__(torch.broadcast_shapes(self.loc.shape,
                                                self.scale.shape))

    def sample(self, shape=()):
        # inverse CDF of a uniform draw on (-1, 1)
        u = 2.0 * _uniform(_shape(shape, self.batch_shape), self.loc) - 1.0
        tiny = torch.finfo(torch.float32).tiny
        lap = -torch.sign(u) * torch.log(torch.clamp(1.0 - u.abs(),
                                                     min=tiny))
        return _wrap(self.loc + self.scale * lap)

    def log_prob(self, value):
        v = _d(value)
        return _wrap(-torch.abs(v - self.loc) / self.scale
                     - torch.log(2 * self.scale))

    def entropy(self):
        return _wrap(1.0 + torch.log(2 * self.scale))


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        self.concentration = _f32(concentration)
        self.rate = _f32(rate)
        super().__init__(torch.broadcast_shapes(self.concentration.shape,
                                                self.rate.shape))

    def sample(self, shape=()):
        return _wrap(_gamma(self.concentration,
                            _shape(shape, self.batch_shape)) / self.rate)

    def log_prob(self, value):
        v = _d(value)
        a, b = self.concentration, self.rate
        return _wrap(a * torch.log(b) + (a - 1) * torch.log(v) - b * v
                     - torch.lgamma(a))


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha = _f32(alpha)
        self.beta = _f32(beta)
        super().__init__(torch.broadcast_shapes(self.alpha.shape,
                                                self.beta.shape))

    def sample(self, shape=()):
        full = _shape(shape, self.batch_shape)
        x, y = _gamma(self.alpha, full), _gamma(self.beta, full)
        return _wrap(x / (x + y))

    def log_prob(self, value):
        v = _d(value)
        a, b = self.alpha, self.beta
        lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return _wrap((a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                     - lbeta)


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self._normal = Normal(loc, scale)
        super().__init__(self._normal.batch_shape)

    def sample(self, shape=()):
        return _wrap(torch.exp(_d(self._normal.sample(shape)).detach()))

    def log_prob(self, value):
        v = _d(value)
        return _wrap(_d(self._normal.log_prob(_wrap(torch.log(v))))
                     - torch.log(v))


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs = _f32(probs)
        super().__init__(self.probs.shape[:-1], self.probs.shape[-1:])

    def sample(self, shape=()):
        n = self.probs.shape[-1]
        draws = _categorical(
            torch.log(self.probs),
            _shape(shape, self.batch_shape) + (self.total_count,))
        return _wrap(torch.nn.functional.one_hot(draws, n)
                     .to(torch.float32).sum(dim=-2))

    def log_prob(self, value):
        v = _d(value)
        logp = torch.log(torch.clamp(self.probs, min=1e-12))
        coef = (torch.lgamma(torch.tensor(self.total_count + 1.0,
                                          device=v.device))
                - torch.sum(torch.lgamma(v + 1.0), dim=-1))
        return _wrap(coef + torch.sum(v * logp, dim=-1))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _f32(concentration)
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=()):
        g = _gamma(self.concentration,
                   _shape(shape, self.batch_shape) + self.event_shape)
        return _wrap(g / g.sum(dim=-1, keepdim=True))

    def log_prob(self, value):
        v = _d(value)
        a = self.concentration
        norm = (torch.sum(torch.lgamma(a), dim=-1)
                - torch.lgamma(torch.sum(a, dim=-1)))
        return _wrap(torch.sum((a - 1) * torch.log(v), dim=-1) - norm)


def kl_divergence(p, q):
    """Registered closed forms (differentiable); falls back to
    p.kl_divergence(q)."""
    if isinstance(p, Normal) and isinstance(q, Normal):
        return p.kl_divergence(q)
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        return _elemwise(
            "categorical_kl",
            lambda a, b: torch.sum(
                torch.softmax(a, -1)
                * (torch.log_softmax(a, -1) - torch.log_softmax(b, -1)),
                dim=-1),
            p._logits, q._logits)
    if isinstance(p, Bernoulli) and isinstance(q, Bernoulli):
        def _kl(pa, qa):
            pa = torch.clamp(pa, 1e-12, 1 - 1e-12)
            qa = torch.clamp(qa, 1e-12, 1 - 1e-12)
            return (pa * (torch.log(pa) - torch.log(qa))
                    + (1 - pa) * (torch.log1p(-pa) - torch.log1p(-qa)))
        return _elemwise("bernoulli_kl", _kl, p._probs, q._probs)
    if hasattr(p, "kl_divergence"):
        return p.kl_divergence(q)
    raise NotImplementedError(
        f"kl_divergence not registered for {type(p).__name__}/"
        f"{type(q).__name__}")


from .transform import (  # noqa: E402,F401
    AbsTransform,
    AffineTransform,
    ChainTransform,
    ExpTransform,
    PowerTransform,
    SigmoidTransform,
    TanhTransform,
    Transform,
    TransformedDistribution,
)
