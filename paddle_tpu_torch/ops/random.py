"""Random ops over the global generators (paddle.tensor.random parity).

Port of ``paddle_tpu/ops/random.py``.  Every draw comes from the global
``torch.Generator`` of the device its result lives on
(``framework/random.py``, seeded by ``paddle.seed``); ``uniform(seed=n)``
draws from a generator of its own seeded with ``n``.  A generator cannot
reproduce the JAX package's key stream: the two agree in distribution,
shape, dtype and range, not draw for draw.
"""

import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.random import generator
from .registry import op, register_external


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()  # noqa: H001 (concrete shape required)
    return tuple(int(s) for s in shape)


def _float(dtype):
    return convert_dtype(dtype) if dtype else get_default_dtype()


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = generator(dev)
    out = torch.empty(_shape(shape), dtype=_float(dtype), device=dev)
    return _wrap(out.uniform_(min, max, generator=gen))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        ref = m if isinstance(m, torch.Tensor) else s
        out_shape = torch.broadcast_shapes(
            tuple(m.shape) if isinstance(m, torch.Tensor) else (),
            tuple(s.shape) if isinstance(s, torch.Tensor) else ())
        z = torch.randn(out_shape, dtype=get_default_dtype(),
                        device=ref.device, generator=generator(ref.device))
        return _wrap(m + s * z)
    dev = current_device()
    z = torch.randn(_shape(shape or []), dtype=get_default_dtype(),
                    device=dev, generator=generator(dev))
    return _wrap(mean + std * z)


def standard_normal(shape, dtype=None, name=None):
    dev = current_device()
    return _wrap(torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                             generator=generator(dev)))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype=dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return _wrap(torch.randint(low, high, _shape(shape),
                               dtype=convert_dtype(dtype), device=dev,
                               generator=generator(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = x._data
    return _wrap(torch.randint(low, high, tuple(d.shape),
                               dtype=convert_dtype(dtype) or d.dtype,
                               device=d.device, generator=generator(d.device)))


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return _wrap(torch.randperm(n, dtype=convert_dtype(dtype), device=dev,
                                generator=generator(dev)))


@op()
def bernoulli(x):
    return torch.bernoulli(x, generator=generator(x.device))


@op()
def multinomial(x, num_samples=1, replacement=False):
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=generator(x.device))


@op()
def poisson(x):
    return torch.poisson(x, generator=generator(x.device))


def rand_like(x, dtype=None):
    d = x._data
    out = torch.empty_like(d, dtype=convert_dtype(dtype) or d.dtype)
    return _wrap(out.uniform_(0.0, 1.0, generator=generator(d.device)))


def normal_like(x, mean=0.0, std=1.0):
    d = x._data
    z = torch.randn(tuple(d.shape), dtype=d.dtype, device=d.device,
                    generator=generator(d.device))
    return _wrap(mean + std * z)


for _name, _fn in (("randint", randint), ("randperm", randperm),
                   ("uniform", uniform), ("gaussian", normal)):
    register_external(_name, _fn)
