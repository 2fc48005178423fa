"""Core: the eager Tensor (port of ``paddle_tpu/core``)."""
