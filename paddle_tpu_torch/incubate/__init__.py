"""paddle.incubate (port of ``paddle_tpu/incubate``): the ``nn``
namespace (``FusedMultiTransformer`` and ``functional``'s fused
functions)."""

from . import nn  # noqa: F401
