"""ProcessMesh (reference auto_parallel/process_mesh.py; C++
paddle/phi/core/distributed/auto_parallel/process_mesh.h:32).

Port of ``paddle_tpu/distributed/auto_parallel/process_mesh.py``: a named
cartesian topology of process ids.  The JAX mesh materializes as a
``jax.sharding.Mesh`` over the local devices (``jax_mesh``), which has no
counterpart here: the port runs one process a rank, and a process id is
a rank of the world.  ``rank_mesh()`` is the mesh's ``fleet.RankMesh``
(its groups, one per comm list of each dim, created on every rank of the
world in one order); ``coord(dim)`` is this rank's index along a dim.
"""

import numpy as np


class ProcessMesh:
    def __init__(self, mesh, dim_names=None, process_ids=None, shape=None):
        arr = np.asarray(mesh)
        if process_ids is not None and shape is not None:
            arr = np.asarray(process_ids).reshape(shape)
        self._shape = list(arr.shape)
        self._process_ids = arr.flatten().tolist()
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._rank_mesh = None

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def process_ids(self):
        return self._process_ids

    # reference alias
    processes = process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, name):
        return self._shape[self._dim_names.index(name)]

    def rank_mesh(self):
        """The ``fleet.RankMesh`` of these process ids and dim names."""
        if self._rank_mesh is None:
            from ..fleet.topology import RankMesh
            self._rank_mesh = RankMesh(self.mesh, self._dim_names)
        return self._rank_mesh

    def coord(self, dim, rank=None):
        """``rank``'s (this process's by default) index along mesh dim
        ``dim`` (a name or an index); -1 outside the mesh."""
        from ..group import _global_rank

        rank = _global_rank() if rank is None else rank
        where = np.argwhere(self.mesh == rank)
        if not len(where):
            return -1
        i = dim if isinstance(dim, int) else self._dim_names.index(dim)
        return int(where[0][i])

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._process_ids),
                     tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")
