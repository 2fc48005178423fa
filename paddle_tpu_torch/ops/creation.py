"""Tensor creation ops (paddle.tensor.creation parity).

Port of ``paddle_tpu/ops/creation.py``.  The functions that build a
Tensor from a shape (``zeros``, ``arange``, ``eye`` ...) place it on the
current device (``framework.device.set_device``); the ``*_like`` ops and
the rest are registered ops on torch tensors.
"""

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap, to_tensor  # noqa: F401
from ..framework.device import current_device
from ..framework.dtype import convert_dtype, get_default_dtype
from .registry import op, register_external


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else get_default_dtype()
    return convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()  # noqa: H001 (concrete shape required)
    return tuple(int(s) for s in shape)


def zeros(shape, dtype=None, name=None):
    return _wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                             device=current_device()))


def ones(shape, dtype=None, name=None):
    return _wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                            device=current_device()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        # stays on the device: a 0-d fill broadcast, no host round trip
        fv = fill_value._data.reshape(())
        return _wrap(fv.to(_dt(dtype, default=fv.dtype)).expand(
            _shape(shape)).clone())
    if dtype is None:
        dtype = np.asarray(fill_value).dtype  # noqa: H001 (py scalar)
        dtype = get_default_dtype() if dtype == np.float64 else dtype
    return _wrap(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                            device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange takes python scalars")
    if end is None:
        start, end = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
            dtype = "int64"
        else:
            dtype = get_default_dtype()
    return _wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                              device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _wrap(torch.linspace(float(start), float(stop), int(num),  # noqa: H001 (scalar args by contract)
                                dtype=_dt(dtype), device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _wrap(torch.logspace(float(start), float(stop), int(num),  # noqa: H001 (scalar args by contract)
                                base=base, dtype=_dt(dtype),
                                device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = num_rows if num_columns is None else num_columns
    return _wrap(torch.eye(num_rows, cols, dtype=_dt(dtype),
                           device=current_device()))


@op()
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


@op()
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


@op()
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


@op()
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


@op()
def diag(x, offset=0, padding_value=0):
    out = torch.diag(x, diagonal=offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool),
                          diagonal=offset)
        out = torch.where(mask, out, torch.full_like(out, padding_value))
    return out


@op()
def diagflat(x, offset=0):
    return torch.diagflat(x, offset=offset)


@op()
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


@op()
def tril(x, diagonal=0):
    return torch.tril(x, diagonal=diagonal)


@op()
def triu(x, diagonal=0):
    return torch.triu(x, diagonal=diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _wrap(torch.tril_indices(row, col, offset, dtype=_dt(dtype),
                                    device=current_device()))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _wrap(torch.triu_indices(row, col, offset, dtype=_dt(dtype),
                                    device=current_device()))


@op()
def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return tuple(torch.meshgrid(*args, indexing="ij"))


@op()
def assign(x, output=None):
    return x.clone() if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x), device=current_device())  # noqa: H001 (host data)


@op()
def complex(real, imag):
    return torch.complex(real, imag)


@op()
def polar(abs, angle):
    return torch.polar(abs, angle)


@op()
def clone(x):
    return torch.clone(x)


@op()
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


for _name, _fn in (("arange", arange), ("empty", empty), ("eye", eye),
                   ("full", full), ("linspace", linspace),
                   ("logspace", logspace), ("ones", ones), ("zeros", zeros),
                   ("tril_indices", tril_indices),
                   ("triu_indices", triu_indices)):
    register_external(_name, _fn)
