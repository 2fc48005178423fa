"""paddle.audio.functional — mel/window/dct math over torch (port of
``paddle_tpu/audio/functional.py``).

Reference: python/paddle/audio/functional/{functional,window}.py (hz↔mel,
fbank matrices, dct basis, windows, power_to_db).  The formulas are the
JAX module's, in f32.  A Tensor argument gives a Tensor on its device,
a raw torch tensor a torch tensor, a Python scalar a float; host data
(numpy, lists) and the constructors without a tensor argument
(``mel_frequencies``, ``fft_frequencies``, ``compute_fbank_matrix``,
``create_dct``, ``get_window``) give torch tensors on the current device
(``paddle.set_device``; CUDA unless the caller named the CPU).
"""

import math

import numpy as np
import torch

from ..core.tensor import Tensor
from ..framework.device import current_device
from ..ops.registry import register_external

__all__ = ["hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
           "compute_fbank_matrix", "power_to_db", "create_dct",
           "get_window"]


def _f32(x, device=None):
    """x (Tensor, torch tensor, scalar or host data) as an f32 torch
    tensor: a tensor's on its device, host data on ``device`` or the
    current device."""
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    if np.isscalar(x):                  # a float back: no device round trip
        device = torch.device("cpu")
    return torch.as_tensor(np.array(x, np.float32),
                           device=device or current_device())


def _like(out, like):
    """``out`` in the kind of ``like``: float, Tensor or torch tensor."""
    if np.isscalar(like):
        return float(out)
    return Tensor(out) if isinstance(like, Tensor) else out


def hz_to_mel(freq, htk=False):
    """Hertz → mel.  Slaney (default) or HTK scale (reference parity)."""
    f = _f32(freq)
    if htk:
        mel = 2595.0 * torch.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        mel = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        mel = torch.where(f >= min_log_hz,
                          min_log_mel + torch.log(
                              torch.clamp(f, min=1e-10) / min_log_hz)
                          / logstep,
                          mel)
    return _like(mel, freq)


def mel_to_hz(mel, htk=False):
    m = _f32(mel)
    if htk:
        hz = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        hz = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        hz = torch.where(m >= min_log_mel,
                         min_log_hz * torch.exp(logstep * (m - min_log_mel)),
                         hz)
    return _like(hz, mel)


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False):
    low = hz_to_mel(float(f_min), htk)
    high = hz_to_mel(float(f_max), htk)
    mels = torch.linspace(low, high, n_mels, dtype=torch.float32,
                          device=current_device())
    return mel_to_hz(mels, htk)


def fft_frequencies(sr, n_fft):
    return torch.linspace(0.0, float(sr) / 2, n_fft // 2 + 1,
                          dtype=torch.float32, device=current_device())


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney"):
    """[n_mels, n_fft//2 + 1] triangular mel filterbank."""
    if f_max is None:
        f_max = float(sr) / 2
    fftfreqs = fft_frequencies(sr, n_fft)                      # [F]
    melfreqs = mel_frequencies(n_mels + 2, f_min, f_max, htk)  # [M+2]
    fdiff = torch.diff(melfreqs)
    ramps = melfreqs[:, None] - fftfreqs[None, :]              # [M+2, F]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp(torch.minimum(lower, upper), min=0.0)  # [M, F]
    if norm == "slaney":
        enorm = 2.0 / (melfreqs[2:n_mels + 2] - melfreqs[:n_mels])
        weights = weights * enorm[:, None]
    return weights


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    x = spect._data if isinstance(spect, Tensor) else spect
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x), device=current_device())
    log_spec = 10.0 * torch.log10(torch.clamp(x, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return Tensor(log_spec) if isinstance(spect, Tensor) else log_spec


def create_dct(n_mfcc, n_mels, norm="ortho"):
    """[n_mels, n_mfcc] DCT-II basis (reference create_dct)."""
    dev = current_device()
    n = torch.arange(n_mels, dtype=torch.float32, device=dev)
    k = torch.arange(n_mfcc, dtype=torch.float32, device=dev)
    dct = torch.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm == "ortho":
        dct = dct * math.sqrt(2.0 / n_mels)
        dct[:, 0] = dct[:, 0] * (1.0 / math.sqrt(2))
    else:
        dct = dct * 2.0
    return dct


_WINDOWS = {}


def _arange(n):
    return torch.arange(n, dtype=torch.float32, device=current_device())


def _win_hann(n, periodic):
    m = n if periodic else n - 1
    return 0.5 - 0.5 * torch.cos(2 * math.pi * _arange(n) / max(m, 1))


def _win_hamming(n, periodic):
    m = n if periodic else n - 1
    return 0.54 - 0.46 * torch.cos(2 * math.pi * _arange(n) / max(m, 1))


def _win_blackman(n, periodic):
    m = n if periodic else n - 1
    t = 2 * math.pi * _arange(n) / max(m, 1)
    return 0.42 - 0.5 * torch.cos(t) + 0.08 * torch.cos(2 * t)


_WINDOWS.update(hann=_win_hann, hamming=_win_hamming,
                blackman=_win_blackman,
                rect=lambda n, periodic: torch.ones(
                    n, dtype=torch.float32, device=current_device()))
_WINDOWS["boxcar"] = _WINDOWS["rect"]


def get_window(window, win_length, fftbins=True):
    if isinstance(window, tuple):  # ("gaussian", std) style: unsupported tail
        window = window[0]
    if window not in _WINDOWS:
        raise ValueError(f"unsupported window {window!r}; "
                         f"have {sorted(_WINDOWS)}")
    return _WINDOWS[window](int(win_length), bool(fftbins)).to(torch.float32)


for _name in ("hz_to_mel", "mel_to_hz", "compute_fbank_matrix",
              "power_to_db"):
    register_external(f"audio.{_name}", globals()[_name], tags=("audio",))
