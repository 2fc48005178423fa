"""paddle.audio.features — Spectrogram / MelSpectrogram /
LogMelSpectrogram / MFCC as nn.Layers (port of
``paddle_tpu/audio/features.py``).

Reference: python/paddle/audio/features/layers.py.  Built on the port's
own stft (``paddle_tpu_torch/signal.py``) and the mel/dct math of
``audio.functional``; the pipeline is torch on the input's device and
keeps autograd.  The window, filterbank and dct basis are plain
attributes, as in the JAX layers (not in the state dict), made on the
current device and moved to the input's at the first call there.  A
Tensor input gives a Tensor, a raw torch tensor a torch tensor.
"""

import torch

from ..core.tensor import Tensor, _wrap
from ..nn.layer_base import Layer
from .. import signal as _signal
from . import functional as F

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _out(t, like):
    return _wrap(t) if isinstance(like, Tensor) else t


def _on(t, x):
    """Constant ``t`` on ``x``'s device."""
    return t if t.device == x.device else t.to(x.device)


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.window = F.get_window(window, self.win_length)

    def forward(self, x):
        data = _raw(x)
        self.window = _on(self.window, data)
        spec = _signal.stft(data, self.n_fft, hop_length=self.hop_length,
                            win_length=self.win_length, window=self.window,
                            center=self.center, pad_mode=self.pad_mode)
        mag = torch.abs(spec)
        if self.power != 1.0:
            mag = mag ** self.power
        return _out(mag, x)


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False,
                 norm="slaney", dtype="float32"):
        super().__init__()
        self._spectrogram = Spectrogram(
            n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            window=window, power=power, center=center, pad_mode=pad_mode)
        self.fbank = F.compute_fbank_matrix(
            sr=sr, n_fft=n_fft, n_mels=n_mels, f_min=f_min, f_max=f_max,
            htk=htk, norm=norm)

    def forward(self, x):
        spec = self._spectrogram(_raw(x))          # [..., freq, time]
        self.fbank = _on(self.fbank, spec)
        mel = torch.einsum("mf,...ft->...mt", self.fbank, spec)
        return _out(mel, x)


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False,
                 norm="slaney", ref_value=1.0, amin=1e-10, top_db=None,
                 dtype="float32"):
        super().__init__()
        self._mel = MelSpectrogram(
            sr=sr, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            window=window, power=power, center=center, pad_mode=pad_mode,
            n_mels=n_mels, f_min=f_min, f_max=f_max, htk=htk, norm=norm)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        mel = self._mel(_raw(x))
        return _out(F.power_to_db(mel, ref_value=self.ref_value,
                                  amin=self.amin, top_db=self.top_db), x)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        self._log_mel = LogMelSpectrogram(
            sr=sr, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            window=window, power=power, center=center, pad_mode=pad_mode,
            n_mels=n_mels, f_min=f_min, f_max=f_max, htk=htk, norm=norm,
            ref_value=ref_value, amin=amin, top_db=top_db)
        self.dct = F.create_dct(n_mfcc, n_mels)

    def forward(self, x):
        logmel = self._log_mel(_raw(x))          # [..., n_mels, time]
        self.dct = _on(self.dct, logmel)
        mfcc = torch.einsum("mk,...mt->...kt", self.dct, logmel)
        return _out(mfcc, x)
