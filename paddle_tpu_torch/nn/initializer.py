"""Weight initializers (paddle.nn.initializer parity).

Port of ``paddle_tpu/nn/initializer.py``.  Each initializer is a
callable ``(shape, dtype) -> torch.Tensor`` (any dtype spelling) on the current device
(``framework.device.set_device``), drawing in f32 from that device's
global generator (``framework/random.py``) and cast to ``dtype``.  The
distributions are the JAX package's; the draws are not (a generator
cannot repeat a JAX key stream).
"""

import math

import numpy as np
import torch

from ..framework.device import current_device
from ..framework.dtype import convert_dtype
from ..framework.random import generator


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape):
    dev = current_device()
    return torch.empty(shape, dtype=torch.float32, device=dev), generator(dev)


def _normal(shape, mean, std, dtype):
    out, gen = _empty(shape)
    return out.normal_(mean, std, generator=gen).to(convert_dtype(dtype))


def _uniform(shape, low, high, dtype):
    out, gen = _empty(shape)
    return out.uniform_(low, high, generator=gen).to(convert_dtype(dtype))


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(shape, self.value, dtype=convert_dtype(dtype),
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _normal(shape, self.mean, self.std, dtype)


class TruncatedNormal(Initializer):
    """Normal(mean, std) truncated to two standard deviations, drawn by
    the inverse CDF."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        lo = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2)))
        u = _uniform(shape, lo, 1.0 - lo, torch.float32)
        z = math.sqrt(2) * torch.erfinv(2 * u - 1)
        return (self.mean + self.std * z.clamp(-2.0, 2.0)).to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, self.low, self.high, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(shape, 0.0, self.gain * math.sqrt(2.0 / (fi + fo)),
                       dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = _kaiming_gain(self.negative_slope, self.nonlinearity)
        return _normal(shape, 0.0, gain / math.sqrt(fi), dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = _kaiming_gain(self.negative_slope, self.nonlinearity)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from ..core.tensor import Tensor
        v = self.value
        v = v._data if isinstance(v, Tensor) else \
            torch.as_tensor(np.asarray(v))
        return v.detach().to(device=current_device(), dtype=convert_dtype(dtype),
                             copy=True).reshape(shape)


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix: the QR factor of a normal
    draw, signs fixed by R's diagonal (the rows or columns, whichever
    are fewer, orthonormal)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        a = _normal((max(rows, cols), min(rows, cols)), 0.0, 1.0,
                    torch.float32)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(convert_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + mid] = 1.0
        return torch.as_tensor(out, device=current_device()).to(convert_dtype(dtype))
