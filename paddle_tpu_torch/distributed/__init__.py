"""paddle_tpu_torch.distributed (reference python/paddle/distributed/).

Port of ``paddle_tpu/distributed``.  **The design mapping.**  The JAX
package runs one controller: a ``Group`` is a 1-D ``jax.sharding.Mesh``
over ``jax.devices()``, ``get_world_size()`` is ``jax.device_count()``,
"each rank's tensor" is one shard of a global array and a collective is a
``lax.psum``-family call inside ``shard_map``.  The port uses the PyTorch
idiom: one process a rank, a ``Group`` wraps a ``torch.distributed``
process group, ``get_world_size()`` is that group's size and each
collective is the ``torch.distributed`` call on the rank's own tensor.
NCCL runs when every rank has a card of its own, gloo when ranks share a
card or run on the CPU (a CUDA tensor then goes through the host).  The
launcher's ``TCPStore`` owns the master port and ``init_parallel_env``
meets the other ranks on torch's c10d store at the master port + 1; the
rank and world size come from ``PADDLE_TRAINER_ID`` and
``PADDLE_TRAINERS_NUM``, the card from ``PADDLE_LOCAL_RANK``.

Here: the store, ``spawn``, the launcher, ``rpc`` and the elastic
manager (verbatim copies of the JAX modules), the groups and every
collective (``group``, ``communication``), ``init_parallel_env`` and a
bucketed gradient-averaging ``DataParallel`` (``parallel``), the ZeRO
stages (``sharding``), the distributed checkpoint (``checkpoint``),
fleet's hybrid parallelism (``fleet``: the topology, tensor, sequence
and context parallelism, recompute, the meta optimizers, the dataset),
``auto_parallel`` and the parameter server (``ps``: the host sparse
tables, their service, the graph tables and the device hot-row cache).
"""

from .communication import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    alltoall,
    barrier,
    broadcast,
    p2p_permute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .group import (  # noqa: F401
    Group,
    destroy_process_group,
    get_group,
    new_group,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
)
from .store import TCPStore  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from . import auto_parallel  # noqa: F401
from . import checkpoint  # noqa: F401
from . import launch  # noqa: F401
from . import ps  # noqa: F401
from . import rpc  # noqa: F401
from .spawn import spawn  # noqa: F401
