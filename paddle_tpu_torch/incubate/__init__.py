"""paddle.incubate (port of ``paddle_tpu/incubate``): ``asp``,
``autograd``, ``nn`` (``FusedMultiTransformer`` and ``functional``'s
fused functions), ``LookAhead`` and ``ModelAverage``.
``incubate.distributed`` waits for ROADMAP A23b-6c."""

from . import asp, autograd, nn  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401
