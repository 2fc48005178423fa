"""paddle_tpu_torch.distributed — the rank and world size a sampler
shards by (``io/sampler.py::DistributedBatchSampler``).

The JAX package answers with ``jax.process_index()`` and
``jax.device_count()`` (``paddle_tpu/distributed/parallel.py``), the
chips of the program.  The port answers with ``torch.distributed``'s
rank and world size when a default process group is up, else rank 0 of
1: one process, whatever the cards it sees.  The rest of the package
(collectives over NCCL, fleet, sharding) waits for A23b.
"""


def _group_up():
    from torch import distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None):
    if _group_up():
        from torch import distributed as dist
        return dist.get_rank()
    return 0


def get_world_size(group=None):
    if _group_up():
        from torch import distributed as dist
        return dist.get_world_size()
    return 1
