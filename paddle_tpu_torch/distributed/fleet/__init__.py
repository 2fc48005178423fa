"""paddle_tpu_torch.distributed.fleet (reference
python/paddle/distributed/fleet/).

Port of ``paddle_tpu/distributed/fleet``.  **The design.**  The JAX
package runs one controller: ``fleet.init`` builds one device Mesh of
the hybrid topology, tensor, sequence and context parallelism are
sharding annotations, GSPMD inserts every collective and every result is
the global one.  The port runs one process a rank (``distributed``'s
design mapping), and each rank holds only its own block:

- **A mesh is ranks, not devices.**  ``build_mesh(dp, pp, sharding, mp,
  sep)`` returns a ``topology.RankMesh``: a numpy array of global ranks
  with the JAX axis order and the JAX dropping of an unused ``sep``, so
  ``hcg.mesh.shape`` is the JAX dict; more ranks than the world has
  raise the JAX ``ValueError``.  Every comm list of every axis is a
  ``Group`` created on every rank in one order.
- **``HybridCommunicateGroup``** holds one group per axis, from
  ``CommunicateTopology.get_comm_list`` (copied verbatim);
  ``global_rank`` is the process's rank.
- **Tensor parallelism is Megatron's**, built from the autograd
  functions of ``meta_parallel/mp_layers.py`` (copy/all-reduce,
  split/concat and the sequence-parallel all-gather/reduce-scatter
  pair).  The Paddle-API layers (``ColumnParallelLinear``,
  ``RowParallelLinear``, ``VocabParallelEmbedding``,
  ``ParallelCrossEntropy``) and the port's ``torch.nn.Module`` GPT and
  Llama run the same functions.  A parameter keeps its JAX
  ``mesh_axes``; ``spmd.shard_parameters`` and ``TensorParallel`` slice
  each to the rank's block by them (the fused qkv by heads:
  ``mp_layers.qkv_head_permutation``).  A sliced model's logits are its
  rank's vocab block and its ``loss`` the vocab-parallel cross entropy:
  the logits are never gathered.
- **State dicts keep the JAX layout**: ``TensorParallel.state_dict()``
  gathers whole parameters with the qkv columns in their JAX order
  (``mp_layers.whole_of``, the inverse of ``block_of``, which carries
  weights across), so a ``paddle.save`` of it loads in either package.
- **Entry points.**  ``fleet.init(strategy)`` → ``distributed_model`` →
  ``distributed_optimizer`` (the ``HybridParallelOptimizer``: the dp
  average, the sequence-parallel gradients' mp all-reduce and the
  hybrid global-norm clip, directly around the base optimizer and under
  the meta-optimizers, so that it runs once an update), and ``use_mesh(build_mesh(...))`` around a
  model built with ``sequence_parallel=`` (sliced by
  ``shard_parameters(model, mesh)``) or ``cp_mode=`` (its attention
  runs ``context_parallel_attention`` over the mesh's ``sep`` group).
  ``worker_index``/``worker_num``/``is_first_worker`` read the default
  group.
- **Device.**  ``init`` forms the default group as
  ``init_parallel_env`` does: card ``PADDLE_LOCAL_RANK`` (``device=``
  to choose, ``"cpu"`` in the tests), NCCL when every rank has a card
  of its own, gloo otherwise.

The dataset (``InMemoryDataset``, ``QueueDataset``, ``dataset.py``) is
the JAX module's, the global shuffle reading the port's rank and world
size.
"""

from .distributed_strategy import DistributedStrategy
from .topology import (  # noqa: F401
    AXIS_MAP,
    CommunicateTopology,
    HybridCommunicateGroup,
    ParallelMode,
    RankMesh,
    build_mesh,
)
from . import spmd  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from .meta_parallel import mp_layers  # noqa: F401
from . import dataset  # noqa: F401
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401


class _FleetState:
    def __init__(self):
        self.strategy = None
        self.hcg = None
        self.initialized = False


_state = _FleetState()


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO",
         device=None):
    """Build the hybrid topology (reference fleet.py:167 → topology.py:140)
    over the world ``init_parallel_env`` forms (``device``: its card
    choice, module docstring)."""
    from ..parallel import get_world_size, init_parallel_env

    init_parallel_env(device=device)
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    n_dev = get_world_size()
    degrees = (hc.get("dp_degree", 1), hc.get("pp_degree", 1),
               hc.get("sharding_degree", 1), hc.get("mp_degree", 1))
    import numpy as np
    need = int(np.prod(degrees))
    if need == 1 and n_dev > 1:
        hc["dp_degree"] = n_dev
        degrees = (n_dev, 1, 1, 1)
    topo = CommunicateTopology(
        ["data", "pipe", "sharding", "model"],
        [degrees[0], degrees[1], degrees[2], degrees[3]])
    _state.strategy = strategy
    _state.hcg = HybridCommunicateGroup(topo)
    _state.initialized = True
    return _state.hcg


def get_hybrid_communicate_group():
    if _state.hcg is None:
        raise RuntimeError("call fleet.init() first")
    return _state.hcg


def is_initialized():
    return _state.initialized


def distributed_model(model):
    """Wrap per active strategy (reference fleet.py distributed_model)."""
    from ..parallel import DataParallel
    from .meta_optimizers import apply_recompute_to_model

    model = apply_recompute_to_model(model, _state.strategy)
    hcg = get_hybrid_communicate_group()
    if hcg.get_pipe_parallel_world_size() > 1:
        from .meta_parallel.pipeline_parallel import PipelineParallel
        return PipelineParallel(model, hcg, _state.strategy)
    if hcg.get_model_parallel_world_size() > 1:
        from .meta_parallel.tensor_parallel import TensorParallel
        return TensorParallel(model, hcg, _state.strategy)
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    from .meta_optimizers import apply_strategy_to_optimizer

    # the HybridParallelOptimizer goes under the meta-optimizers, around
    # the base optimizer: its gradient sync and clip run once an update,
    # as the base optimizer's clip does in the JAX package (whose
    # pass-through wrapper sits outside them)
    return apply_strategy_to_optimizer(
        optimizer, strategy or _state.strategy, hcg=_state.hcg)


def worker_index():
    from ..parallel import get_rank
    return get_rank()


def worker_num():
    from ..parallel import get_world_size
    return get_world_size()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    from ..communication import barrier
    barrier()
