"""fleet.utils — the timers (a verbatim copy of the JAX package's
``timer_helper``) and the hybrid-parallel helpers.

Reference: python/paddle/distributed/fleet/utils/ (timer_helper,
hybrid_parallel_util, ...).
"""

from . import hybrid_parallel_util, timer_helper  # noqa: F401
from .hybrid_parallel_util import fused_allreduce_gradients  # noqa: F401
from .timer_helper import get_timers, set_timers  # noqa: F401
