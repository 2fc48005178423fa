"""FFT ops (phi ``fft_c2c`` / ``fft_r2c`` / ``fft_c2r``).

Port of ``paddle_tpu/ops/fft_ops.py`` over ``torch.fft``: the three
kernel-level ops the ``fft`` module builds on, with numpy's
normalizations (``backward``, ``forward``, ``ortho``).
"""

import math

import torch

from .registry import op

_NORM = ("backward", "forward", "ortho")


def _norm(normalization):
    if normalization in (None, ""):
        return "backward"
    if normalization not in _NORM:
        raise ValueError(f"unsupported fft normalization: {normalization}")
    return normalization


def _complex_of(x):
    return x.to(torch.complex64 if x.element_size() <= 4
                else torch.complex128)


@op()
def fft_c2c(x, axes, normalization="backward", forward=True):
    fn = torch.fft.fftn if forward else torch.fft.ifftn
    return fn(x, dim=tuple(axes), norm=_norm(normalization))


@op()
def fft_r2c(x, axes, normalization="backward", forward=True, onesided=True):
    axes = tuple(axes)
    norm = _norm(normalization)
    if not forward:
        # ihfft: conj(rfft(x)) with the inverse transform's normalization
        n = 1
        for a in axes:
            n *= x.shape[a]
        base = torch.conj(
            torch.fft.rfftn(x, dim=axes, norm="backward") if onesided
            else torch.fft.fftn(_complex_of(x), dim=axes, norm="backward"))
        if norm == "backward":
            return base / n
        if norm == "ortho":
            return base / math.sqrt(n)
        return base
    if onesided:
        return torch.fft.rfftn(x, dim=axes, norm=norm)
    return torch.fft.fftn(_complex_of(x), dim=axes, norm=norm)


@op()
def fft_c2r(x, axes, normalization="backward", forward=False,
            last_dim_size=0):
    axes = tuple(axes)
    s = None
    if last_dim_size:
        s = [x.shape[a] for a in axes]
        s[-1] = last_dim_size
    return torch.fft.irfftn(x, s=s, dim=axes, norm=_norm(normalization))
