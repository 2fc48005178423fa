"""Core: the eager Tensor (port of ``paddle_tpu/core``)."""

from .tensor import Tensor, to_tensor  # noqa: F401
