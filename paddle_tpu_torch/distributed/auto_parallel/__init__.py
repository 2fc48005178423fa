"""auto_parallel — the ``Strategy`` config surface (a verbatim copy of
the JAX package's ``strategy.py``).  The process mesh, placements,
``shard_tensor`` and the rest of the interface, the Engine and the tuner
come with ROADMAP A23b-6b; each of those names raises
``NotImplementedError`` naming it.
"""

from .strategy import Strategy  # noqa: F401
from .._later import A23B6B, later

__getattr__ = later(__name__, (
    "ProcessMesh", "Partial", "Replicate", "Shard", "dtensor_from_fn",
    "reshard", "shard_layer", "shard_op", "shard_tensor", "Engine",
    "ClusterSpec", "CostEstimator", "Mapper", "ParallelTuner",
    "process_mesh", "placement", "interface", "engine", "tuner"), A23B6B)
