"""paddle_tpu_torch.distributed.fleet (reference
python/paddle/distributed/fleet/).

The host-only parts of the JAX package's ``fleet`` are here as verbatim
copies: ``DistributedStrategy``, the timers of ``utils`` and the elastic
manager (``fleet.elastic``).  The topology, ``init``, the
``meta_parallel`` layers, recompute, the meta optimizers and the dataset
come with ROADMAP A23b-6b; each of those names raises
``NotImplementedError`` naming it.
"""

from .distributed_strategy import DistributedStrategy  # noqa: F401
from . import utils  # noqa: F401
from .._later import A23B6B, later

__getattr__ = later(__name__, (
    "AXIS_MAP", "CommunicateTopology", "HybridCommunicateGroup",
    "ParallelMode", "build_mesh", "meta_parallel", "mp_layers",
    "InMemoryDataset", "QueueDataset", "recompute", "recompute_sequential",
    "init", "get_hybrid_communicate_group", "is_initialized",
    "distributed_model", "distributed_optimizer", "worker_index",
    "worker_num", "is_first_worker", "barrier_worker", "topology", "spmd",
    "dataset", "meta_optimizers", "hybrid_parallel_optimizer"), A23B6B)
