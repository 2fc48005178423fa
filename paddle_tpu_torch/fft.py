"""paddle.fft (port of ``paddle_tpu/fft.py``) over ``torch.fft``: every
transform is a registered op, so eager autograd works through it, with
numpy's normalizations and argument conventions."""

import torch

from .core.tensor import _wrap
from .framework.device import current_device
from .ops.registry import op


def _norm_ok(norm):
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(f"invalid norm {norm!r}")
    return norm


def _axes(axes):
    return None if axes is None else tuple(axes)


def fft(x, n=None, axis=-1, norm="backward", name=None):
    return _fft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("fft")
def _fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(x, n=n, dim=axis, norm=norm)


def ifft(x, n=None, axis=-1, norm="backward", name=None):
    return _ifft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("ifft")
def _ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(x, n=n, dim=axis, norm=norm)


def rfft(x, n=None, axis=-1, norm="backward", name=None):
    return _rfft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("rfft")
def _rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(x, n=n, dim=axis, norm=norm)


def irfft(x, n=None, axis=-1, norm="backward", name=None):
    return _irfft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("irfft")
def _irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(x, n=n, dim=axis, norm=norm)


def hfft(x, n=None, axis=-1, norm="backward", name=None):
    return _hfft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("hfft")
def _hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(x, n=n, dim=axis, norm=norm)


def ihfft(x, n=None, axis=-1, norm="backward", name=None):
    return _ihfft(x, n=n, axis=axis, norm=_norm_ok(norm))


@op("ihfft")
def _ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(x, n=n, dim=axis, norm=norm)


def fft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _fft2(x, s=s, axes=tuple(axes), norm=_norm_ok(norm))


@op("fft2")
def _fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(x, s=s, dim=axes, norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _ifft2(x, s=s, axes=tuple(axes), norm=_norm_ok(norm))


@op("ifft2")
def _ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(x, s=s, dim=axes, norm=norm)


def fftn(x, s=None, axes=None, norm="backward", name=None):
    return _fftn(x, s=s, axes=axes, norm=_norm_ok(norm))


@op("fftn")
def _fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(x, s=s, dim=_axes(axes), norm=norm)


def ifftn(x, s=None, axes=None, norm="backward", name=None):
    return _ifftn(x, s=s, axes=axes, norm=_norm_ok(norm))


@op("ifftn")
def _ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(x, s=s, dim=_axes(axes), norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _rfft2(x, s=s, axes=tuple(axes), norm=_norm_ok(norm))


@op("rfft2")
def _rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(x, s=s, dim=axes, norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return _irfft2(x, s=s, axes=tuple(axes), norm=_norm_ok(norm))


@op("irfft2")
def _irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(x, s=s, dim=axes, norm=norm)


def rfftn(x, s=None, axes=None, norm="backward", name=None):
    return _rfftn(x, s=s, axes=axes, norm=_norm_ok(norm))


@op("rfftn")
def _rfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.rfftn(x, s=s, dim=_axes(axes), norm=norm)


def irfftn(x, s=None, axes=None, norm="backward", name=None):
    return _irfftn(x, s=s, axes=axes, norm=_norm_ok(norm))


@op("irfftn")
def _irfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(x, s=s, dim=_axes(axes), norm=norm)


@op("fftshift")
def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(x, dim=_axes(axes))


@op("ifftshift")
def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(x, dim=_axes(axes))


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _wrap(torch.fft.fftfreq(n, d=d, device=current_device()))


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _wrap(torch.fft.rfftfreq(n, d=d, device=current_device()))
