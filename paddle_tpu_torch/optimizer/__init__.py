"""paddle_tpu_torch.optimizer (port of ``paddle_tpu/optimizer``): the
optimizers, gradient clipping and learning-rate schedulers the training
path uses.  ``lr`` is a verbatim copy of the JAX package's host-only
module."""

from . import lr  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401
