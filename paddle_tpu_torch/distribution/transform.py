"""paddle.distribution.transform (port of ``paddle_tpu/distribution/
transform.py``) — bijective transforms + TransformedDistribution
(reference python/paddle/distribution/transform.py: Transform base with
forward/inverse/log_det_jacobian and the standard zoo;
transformed_distribution.py).

The JAX module's formulas over torch; sampling composes
transform.forward over the base distribution's samples, log_prob
subtracts the forward log-det-Jacobian at the pre-image (standard change
of variables).
"""

import math

import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device

__all__ = ["Transform", "AffineTransform", "ExpTransform",
           "SigmoidTransform", "TanhTransform", "PowerTransform",
           "AbsTransform", "ChainTransform", "TransformedDistribution"]


def _d(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=current_device())


def _softplus(x):
    """log(1 + exp(x)), as the JAX module's ``logaddexp(0, x)``."""
    return torch.logaddexp(torch.zeros_like(x), x)


class Transform:
    """Bijection base (reference transform.py Transform)."""

    def forward(self, x):
        return _wrap(self._forward(_d(x)))

    def inverse(self, y):
        return _wrap(self._inverse(_d(y)))

    def forward_log_det_jacobian(self, x):
        return _wrap(self._fldj(_d(x)))

    def inverse_log_det_jacobian(self, y):
        return _wrap(-self._fldj(self._inverse(_d(y))))

    # subclass hooks over torch tensors
    def _forward(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def _fldj(self, x):
        raise NotImplementedError


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = _d(loc)
        self.scale = _d(scale)

    def _forward(self, x):
        return self.loc + self.scale * x

    def _inverse(self, y):
        return (y - self.loc) / self.scale

    def _fldj(self, x):
        return torch.broadcast_to(torch.log(torch.abs(self.scale)), x.shape)


class ExpTransform(Transform):
    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        return x


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = _d(power)

    def _forward(self, x):
        return torch.pow(x, self.power)

    def _inverse(self, y):
        return torch.pow(y, 1.0 / self.power)

    def _fldj(self, x):
        return torch.log(torch.abs(self.power * torch.pow(x, self.power - 1)))


class SigmoidTransform(Transform):
    def _forward(self, x):
        return 1.0 / (1.0 + torch.exp(-x))

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _fldj(self, x):
        # log sigmoid'(x) = -softplus(-x) - softplus(x)
        return -_softplus(-x) - _softplus(x)


class TanhTransform(Transform):
    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _fldj(self, x):
        return 2.0 * (math.log(2.0) - x - _softplus(-2.0 * x))


class AbsTransform(Transform):
    """Non-bijective |x| (reference AbsTransform): inverse returns the
    positive branch."""

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y

    def _fldj(self, x):
        return torch.zeros_like(x)


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _fldj(self, x):
        total = torch.zeros_like(x)
        for t in self.transforms:
            total = total + t._fldj(x)
            x = t._forward(x)
        return total


class TransformedDistribution:
    """Reference transformed_distribution.TransformedDistribution."""

    def __init__(self, base, transforms):
        self.base = base
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transform = ChainTransform(transforms) \
            if len(transforms) != 1 else transforms[0]

    def sample(self, shape=()):
        x = self.base.sample(shape)
        return self.transform.forward(x)

    def rsample(self, shape=()):
        x = self.base.rsample(shape) if hasattr(self.base, "rsample") \
            else self.base.sample(shape)
        return self.transform.forward(x)

    def log_prob(self, value):
        y = _d(value)
        x = self.transform._inverse(y)
        base_lp = _d(self.base.log_prob(_wrap(x)))
        return _wrap(base_lp - self.transform._fldj(x))

    def prob(self, value):
        return _wrap(torch.exp(_d(self.log_prob(value))))
