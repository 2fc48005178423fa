"""paddle.signal (port of ``paddle_tpu/signal.py``): frame, overlap_add,
stft and istft, each a registered op over torch."""

import torch

from .ops.registry import op

_tF = torch.nn.functional


@op("frame")
def frame(x, frame_length, hop_length, axis=-1):
    """Overlapping frames along ``axis``: axis -1 gives [...,
    frame_length, num_frames], axis 0 [num_frames, frame_length, ...]."""
    front = axis == 0
    work = torch.movedim(x, 0, -1) if front else x
    if axis not in (-1, 0, x.dim() - 1):
        work = torch.movedim(x, axis, -1)
    num_frames = 1 + (work.shape[-1] - frame_length) // hop_length
    out = work.unfold(-1, frame_length, hop_length)[..., :num_frames, :]
    if front:
        return torch.movedim(torch.movedim(out, -2, 0), -1, 1)
    return torch.movedim(out, -2, -1)


def _overlap(frames, hop_length):
    """frames [..., num_frames, frame_length] summed into a signal."""
    num_frames, frame_length = frames.shape[-2], frames.shape[-1]
    n = (num_frames - 1) * hop_length + frame_length
    idx = (torch.arange(num_frames, device=frames.device)[:, None]
           * hop_length
           + torch.arange(frame_length, device=frames.device)[None, :])
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, num_frames * frame_length)
    out = torch.zeros((flat.shape[0], n), dtype=frames.dtype,
                      device=frames.device).index_add(1, idx.reshape(-1),
                                                      flat)
    return out.reshape(tuple(lead) + (n,))


@op("overlap_add")
def overlap_add(x, hop_length, axis=-1):
    """Inverse of frame.  axis=-1: x [..., frame_length, num_frames];
    axis=0: x [num_frames, frame_length, ...]."""
    work = torch.movedim(torch.movedim(x, 0, -1), 0, -2) if axis == 0 \
        else x
    out = _overlap(work.transpose(-1, -2), hop_length)
    return torch.movedim(out, -1, 0) if axis == 0 else out


def _padded_window(window, win_length, n_fft, like, device):
    if window is None:
        return torch.ones((n_fft,), dtype=like, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = _tF.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _pad_last(x, pad, mode):
    shape = x.shape
    flat = x.reshape(-1, 1, shape[-1])
    mode = {"edge": "replicate"}.get(mode, mode)
    out = _tF.pad(flat, (pad, pad), mode=mode)
    return out.reshape(tuple(shape[:-1]) + (out.shape[-1],))


@op("stft")
def _stft_impl(x, window, n_fft, hop_length, win_length, center, pad_mode,
               normalized, onesided):
    xd = _pad_last(x, n_fft // 2, pad_mode) if center else x
    frames = xd.unfold(-1, n_fft, hop_length)
    if window is not None:
        frames = frames * _padded_window(window, win_length, n_fft,
                                         frames.dtype, frames.device)
    spec = torch.fft.rfft(frames, dim=-1) if onesided else \
        torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / (n_fft ** 0.5)
    return spec.transpose(-1, -2)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform: [..., n_fft/2+1, num_frames]."""
    return _stft_impl(x, window, n_fft, hop_length or n_fft // 4,
                      win_length or n_fft, center, pad_mode, normalized,
                      onesided)


@op("istft")
def _istft_impl(x, window, n_fft, hop_length, win_length, center,
                normalized, onesided, length):
    spec = x.transpose(-1, -2)
    if normalized:
        spec = spec * (n_fft ** 0.5)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided else \
        torch.fft.ifft(spec, dim=-1).real
    w = _padded_window(window, win_length, n_fft, frames.dtype,
                       frames.device)
    frames = frames * w
    out = _overlap(frames, hop_length)
    wsq = _overlap((w * w).expand(frames.shape[-2], n_fft), hop_length)
    out = out / torch.clamp(wsq, min=1e-11)
    if center:
        pad = n_fft // 2
        out = out[..., pad:out.shape[-1] - pad]
    if length is not None:
        out = out[..., :length]
    return out


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    return _istft_impl(x, window, n_fft, hop_length or n_fft // 4,
                       win_length or n_fft, center, normalized, onesided,
                       length)
