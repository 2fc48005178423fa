"""paddle.incubate (port of ``paddle_tpu/incubate``): ``asp``,
``autograd``, ``distributed`` (the MoE layer, its gates and clip),
``nn`` (``FusedMultiTransformer`` and ``functional``'s fused
functions), ``LookAhead`` and ``ModelAverage``."""

from . import asp, autograd, distributed, nn  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401
