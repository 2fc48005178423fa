"""auto_parallel — semi-automatic parallelism (reference
python/paddle/distributed/auto_parallel/, 38.5k LoC; SURVEY §2.7).

Port of ``paddle_tpu/distributed/auto_parallel``.  The reference pipeline
is Completer → Partitioner → Resharder; the JAX package leaves all three
to GSPMD over marked shardings.  The port runs one process a rank: a
``ProcessMesh`` is a mesh of ranks, a distributed tensor is this rank's
block carrying its mesh and placements (``shard_tensor``), and
``reshard`` moves it with collectives over the mesh dims' groups.  With
them: the ``Strategy`` config surface (a verbatim copy), the ``Engine``
train/eval/predict driver and the tuner.
"""

from .process_mesh import ProcessMesh  # noqa: F401
from .placement import Partial, Replicate, Shard  # noqa: F401
from .interface import (  # noqa: F401
    DistTensor,
    dtensor_from_fn,
    reshard,
    shard_layer,
    shard_op,
    shard_tensor,
)
from .strategy import Strategy  # noqa: F401
from .engine import Engine  # noqa: F401
from .tuner import (  # noqa: F401
    ClusterSpec,
    CostEstimator,
    Mapper,
    ParallelTuner,
)
