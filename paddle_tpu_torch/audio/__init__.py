"""paddle.audio — feature layers + DSP functional (port of
``paddle_tpu/audio``).

Reference: python/paddle/audio/ (features, functional, backends,
datasets).  Backends (soundfile IO) and downloadable datasets are gated
as in the JAX package: ``load``/``save`` raise with guidance, while the
compute path (spectrogram/mel/mfcc) is torch (see features.py /
functional.py).
"""

from . import features, functional  # noqa: F401


def load(*args, **kwargs):
    raise NotImplementedError(
        "paddle_tpu_torch.audio.load requires an audio IO backend "
        "(soundfile); decode to numpy yourself and feed the array to "
        "audio.features.")


def save(*args, **kwargs):
    raise NotImplementedError(
        "paddle_tpu_torch.audio.save requires an audio IO backend "
        "(soundfile).")


class datasets:
    """Downloadable audio corpora (reference audio/datasets/: TESS, ESC50)
    are unavailable without a network; the classes raise with
    guidance."""

    class _Gated:
        def __init__(self, *a, **k):
            raise RuntimeError(
                f"paddle_tpu_torch.audio.datasets.{type(self).__name__}: "
                "automatic download is unavailable; decode local files "
                "and feed arrays through audio.features.")

    class TESS(_Gated):
        pass

    class ESC50(_Gated):
        pass
