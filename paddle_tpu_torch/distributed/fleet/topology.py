"""The hybrid-parallel topology over the ranks of the world.

Port of ``paddle_tpu/distributed/fleet/topology.py`` (reference
python/paddle/distributed/fleet/base/topology.py:54,140).  The JAX
module turns the topology ["data", "pipe", "sharding", "model"(, "sep")]
into one ``jax.sharding.Mesh`` of devices, from which XLA derives every
communicator.  The port runs one process a rank, so a mesh is ranks, not
devices: :func:`build_mesh` returns a :class:`RankMesh` (a numpy array
of global ranks with the JAX axis names, order and dropping), and each
axis of size > 1 has one ``Group`` per comm list: the ranks that differ
only along that axis.  ``torch.distributed`` asks every rank of the
world to call ``new_group`` for every such list, members or not, in one
order; the mesh does so for every axis as it is built, in axis order,
and keeps the groups on the world's default group, so a second mesh or
``HybridCommunicateGroup`` over the same lists shares them.

``CommunicateTopology`` is host arithmetic, copied verbatim.
"""

import numpy as np

from ..group import Group, _ensure_default_group, _global_rank


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        rank = 0
        for c, d in zip(coords, self._dims):
            rank = rank * d + c
        return rank

    def get_coord(self, rank):
        coords = []
        for d in reversed(self._dims):
            coords.append(rank % d)
            rank //= d
        return tuple(reversed(coords))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        other_sizes = [d for i, d in enumerate(self._dims) if i != axis]
        lists = []
        for flat in range(int(np.prod(other_sizes)) if other_sizes else 1):
            coords_other = []
            f = flat
            for d in reversed(other_sizes):
                coords_other.append(f % d)
                f //= d
            coords_other = list(reversed(coords_other))
            comm = []
            for k in range(self._dims[axis]):
                coord = list(coords_other)
                coord.insert(axis, k)
                comm.append(self.get_rank(**dict(zip(self._parallel_names,
                                                     coord))))
            lists.append(comm)
        return lists


# canonical mesh axis names (paddle name -> mesh axis)
AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding", "model": "mp",
            "sep": "sep"}


def axis_group(ranks):
    """The group over ``ranks`` (global ranks in group order), created
    once a world: every rank of the world must ask for the same lists in
    the same order (``torch.distributed.new_group``).  One rank is a
    group without a process group, whose collectives are the identity."""
    from ..group import new_group

    world = _ensure_default_group()
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) == 1:
        return Group(ranks, None, gid=-1, name=f"ranks{list(ranks)}")
    cache = world.__dict__.setdefault("_axis_groups", {})
    if ranks not in cache:
        cache[ranks] = new_group(list(ranks))
    return cache[ranks]


class RankMesh:
    """A named cartesian mesh of global ranks: the port's counterpart of
    a ``jax.sharding.Mesh`` (``devices`` is the array of ranks,
    ``axis_names`` and ``shape`` as there).  Each axis of size > 1 has a
    group per comm list, created as the mesh is built (module
    docstring); :meth:`group` is this rank's along an axis."""

    def __init__(self, ranks, axis_names):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d ranks for axes "
                             f"{self.axis_names}")
        self._groups = {}
        for axis in self.axis_names:
            for comm in self.comm_lists(axis):
                g = axis_group(comm)
                for r in comm:
                    self._groups[(axis, r)] = g

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def comm_lists(self, axis):
        """The rank lists along ``axis`` (the other coordinates fixed),
        in the mesh's order."""
        i = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, i, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, moved.shape[-1])]

    def coord(self, axis, rank=None):
        """``rank``'s (this process's by default) index along ``axis``;
        -1 for a rank outside the mesh."""
        rank = _global_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            return -1
        return int(where[0][self.axis_names.index(axis)])

    def group(self, axis, rank=None):
        """The group along ``axis`` that holds ``rank`` (this process by
        default); for a rank outside the mesh, the first list's."""
        rank = _global_rank() if rank is None else rank
        g = self._groups.get((axis, rank))
        if g is None:
            g = self._groups[(axis, self.comm_lists(axis)[0][0])]
        return g

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def __eq__(self, other):
        return (isinstance(other, RankMesh)
                and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __hash__(self):
        return hash((self.axis_names, self.devices.tobytes()))

    def __repr__(self):
        return f"RankMesh({self.shape})"


def build_mesh(dp=1, pp=1, sharding=1, mp=1, sep=1, devices=None):
    """The hybrid mesh over the first ``dp*pp*sharding*mp*sep`` ranks of
    ``devices`` (the world's ranks by default).  Axis order follows the
    reference topology order (data, pipe, sharding, model) so rank layout
    matches fleet's (distributed_strategy.proto:68-71 degrees); the sep
    axis is dropped unless used, as in the JAX module."""
    if devices is None:
        devices = list(range(_ensure_default_group().nranks))
    need = dp * pp * sharding * mp * sep
    if need > len(devices):
        raise ValueError(f"topology requires {need} devices, have "
                         f"{len(devices)}")
    arr = np.array(devices[:need]).reshape(dp, pp, sharding, mp, sep)
    axes = ("dp", "pp", "sharding", "mp", "sep")
    if sep == 1:
        arr = arr.reshape(dp, pp, sharding, mp)
        axes = ("dp", "pp", "sharding", "mp")
    return RankMesh(arr, axes)


class HybridCommunicateGroup:
    """Reference topology.py:140.  The same rank/degree accessors and
    per-axis Groups; ``mesh`` is the :class:`RankMesh` of the topology,
    whose groups are the axes' groups here (every comm list of every
    axis created on every rank, in topology order)."""

    def __init__(self, topology):
        self._topo = topology
        self.global_rank = _global_rank()
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()
        dims = {n: topology.get_dim(n) for n in names}
        self._dp_degree = dims.get("data", 1)
        self._pp_degree = dims.get("pipe", 1)
        self._sharding_degree = dims.get("sharding", 1)
        self._mp_degree = dims.get("model", 1)
        self._sep_degree = dims.get("sep", 1)
        self.mesh = build_mesh(self._dp_degree, self._pp_degree,
                               self._sharding_degree, self._mp_degree,
                               self._sep_degree)
        coord = self._topo.get_coord(self.global_rank)
        self._coord = dict(zip(names, coord))
        self._groups = {}
        for name in names:
            # every list, in one order on every rank: a rank asking for
            # its own list first would meet another rank's different
            # list in new_group and hang
            for comm in topology.get_comm_list(name):
                axis_group(comm)
            self._groups[name] = axis_group(self._current_axis_ranks(name))

    # --- degrees ---
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # --- ranks within axis ---
    def get_data_parallel_rank(self):
        return self._coord.get("data", 0)

    def get_model_parallel_rank(self):
        return self._coord.get("model", 0)

    def get_stage_id(self):
        return self._coord.get("pipe", 0)

    def get_sharding_parallel_rank(self):
        return self._coord.get("sharding", 0)

    # --- groups ---
    def _axis_group(self, paddle_axis):
        return self._groups[paddle_axis]

    def _current_axis_ranks(self, axis_name):
        comm_lists = self._topo.get_comm_list(axis_name)
        for comm in comm_lists:
            if self.global_rank in comm:
                return comm
        return comm_lists[0]

    def get_data_parallel_group(self):
        return self._axis_group("data")

    def get_model_parallel_group(self):
        return self._axis_group("model")

    def get_pipe_parallel_group(self):
        return self._axis_group("pipe")

    def get_sharding_parallel_group(self):
        return self._axis_group("sharding")

    def get_check_parallel_group(self, *a):
        return self._axis_group("data")

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    # --- pipeline helpers ---
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree > 1 or self._pp_degree > 1 or \
                self._sharding_degree > 1:
            return ParallelMode.TENSOR_PARALLEL if self._mp_degree > 1 \
                else ParallelMode.PIPELINE_PARALLEL
        return ParallelMode.DATA_PARALLEL


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
