"""fleet.utils — the timers (a verbatim copy of the JAX package's
``timer_helper``); ``hybrid_parallel_util`` comes with ROADMAP A23b-6b.
"""

from . import timer_helper  # noqa: F401
from .timer_helper import get_timers, set_timers  # noqa: F401
from ..._later import A23B6B, later

__getattr__ = later(__name__, ("hybrid_parallel_util",
                               "fused_allreduce_gradients"), A23B6B)
