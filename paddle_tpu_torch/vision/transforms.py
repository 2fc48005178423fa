"""Minimal vision transforms over numpy arrays
(reference python/paddle/vision/transforms/)."""

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean, std, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float32)
        if self.data_format == "CHW":
            return (x - self.mean[:, None, None]) / self.std[:, None, None]
        return (x - self.mean) / self.std


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float32) / 255.0
        if x.ndim == 2:
            x = x[None]
        elif self.data_format == "CHW" and x.shape[-1] in (1, 3, 4):
            x = np.transpose(x, (2, 0, 1))
        return x


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        import torch
        arr = torch.as_tensor(np.asarray(x, dtype=np.float32))
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if not chw:
            arr = arr[None] if arr.ndim == 2 else arr.permute(2, 0, 1)
        out = torch.nn.functional.interpolate(
            arr[None], size=self.size, mode="bilinear", align_corners=False,
            antialias=True)[0]
        if not chw:
            out = out[0] if np.ndim(x) == 2 else out.permute(1, 2, 0)
        return out.numpy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, x):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.flip(x, axis=-1))
        return x


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, x):
        if self.padding:
            pad = [(0, 0)] * (x.ndim - 2) + [(self.padding, self.padding)] * 2
            x = np.pad(x, pad, mode="constant")
        h, w = x.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return x[..., i:i + th, j:j + tw]
