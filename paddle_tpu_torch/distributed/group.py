"""Process groups over ``torch.distributed``.

Port of ``paddle_tpu/distributed/group.py``.  The JAX package runs one
controller: its ``Group`` is a named 1-D ``jax.sharding.Mesh`` over
``jax.devices()``, and "the current rank" is the process index.  The port
runs one process a rank (the PyTorch idiom): a :class:`Group` wraps a
``torch.distributed`` process group, its ``rank`` is this process's index
in ``ranks`` (-1 outside the group, as the reference's
``get_group_rank`` answers) and its size is the group's.

The default group (id 0) is the world that ``init_parallel_env`` formed.
Before that, and only in a job of one process, it is a group of one rank
with no process group behind it: every collective over it is the
identity the JAX module defines for one copy.  A job of more processes
that has not formed its group has no default group.

The backend (:func:`mp_backend`): NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU; gloo stages a CUDA
tensor through the host (``communication.py``).
"""

import datetime
import os

_default_group = None
_groups = {}
_next_gid = 1


def mp_backend(devices):
    """The backend of a group whose ranks run on ``devices`` (one
    ``torch.device`` a rank): NCCL when every rank has a CUDA device of
    its own, gloo otherwise (ranks sharing a card, or on the CPU)."""
    if devices[0].type == "cuda" and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _group(backend, store, name, rank, size, timeout):
    """A process group of ``size`` ranks of ``backend`` over ``store``
    (keys prefixed with ``name``), outside the default group's
    bookkeeping (the tensor-parallel ranks' groups)."""
    from torch import distributed as dist

    prefixed = dist.PrefixStore(name, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(prefixed, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(prefixed, rank, size, opts)


def _world_up():
    from torch import distributed as dist
    return dist.is_available() and dist.is_initialized()


def _global_rank():
    from torch import distributed as dist
    return dist.get_rank() if _world_up() else 0


class Group:
    """``ranks`` (global ranks, in group order) over ``process_group``
    (None only for the one-rank group of a job that formed none)."""

    def __init__(self, ranks, process_group=None, gid=0, name=None,
                 backend=None):
        self.ranks = list(ranks)
        self.id = gid
        self.name = name or f"group_{gid}"
        self.process_group = process_group
        self.backend = backend

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def rank(self):
        """This process's rank in the group, -1 outside it."""
        return self.get_group_rank(_global_rank())

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"ranks={self.ranks})")


def _ensure_default_group():
    """The default group: the world once formed, else one rank in a job
    of one process.  A job of more processes must form its group first
    (``init_parallel_env``): nothing falls back to a local copy."""
    global _default_group
    if _default_group is not None:
        return _default_group
    if _world_up():
        from torch import distributed as dist
        _default_group = Group(range(dist.get_world_size()),
                               dist.group.WORLD, gid=0, name="default",
                               backend=dist.get_backend())
    else:
        n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        if n != 1:
            raise RuntimeError(
                f"this job has {n} ranks and no process group: call "
                "paddle.distributed.init_parallel_env() first")
        _default_group = Group([0], None, gid=0, name="default")
    _groups[0] = _default_group
    return _default_group


def get_group(gid=0):
    if gid == 0:
        return _ensure_default_group()
    return _groups[gid]


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` of the world (reference
    python/paddle/distributed/collective.py:175).  Every rank of the
    world calls it, members or not, as ``torch.distributed.new_group``
    asks; a rank outside ``ranks`` gets a group whose ``rank`` is -1."""
    global _next_gid
    world = _ensure_default_group()
    ranks = list(range(world.nranks)) if ranks is None else \
        [int(r) for r in ranks]
    bad = [r for r in ranks if not 0 <= r < world.nranks]
    if bad:
        raise ValueError(f"ranks {bad} are outside the world of "
                         f"{world.nranks}")
    pg, chosen = None, None
    if world.process_group is not None:
        from torch import distributed as dist
        chosen = backend or world.backend
        if isinstance(timeout, (int, float)):
            timeout = datetime.timedelta(seconds=timeout)
        pg = dist.new_group(ranks, backend=chosen, timeout=timeout)
    g = Group(ranks, pg, gid=_next_gid, backend=chosen)
    _groups[_next_gid] = g
    _next_gid += 1
    return g


def destroy_process_group(group=None):
    """Destroy ``group``, or with None every group and the world."""
    global _default_group
    from torch import distributed as dist

    if group is None:
        if _world_up():
            dist.destroy_process_group()
        _groups.clear()
        _default_group = None
        return
    _groups.pop(group.id, None)
    if group.id == 0:
        destroy_process_group()
    elif group.process_group is not None and group.is_member():
        dist.destroy_process_group(group.process_group)
