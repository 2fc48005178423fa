"""Placement types: Shard(dim) / Replicate / Partial.

Reference: the dist_attr dims_mapping model
(paddle/phi/core/distributed/auto_parallel/dist_attr.h:35) and the
placements API that succeeded it.  Port of
``paddle_tpu/distributed/auto_parallel/placement.py``: the JAX specs are
``PartitionSpec`` s; the port's are tuples of the same entries (a mesh
dim name, a tuple of names, or None a tensor dim).
"""


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """Pending-reduction state: each rank holds a partial value of the
    whole, which ``reshard`` to ``Replicate`` reduces over the mesh dim's
    group (``reduce_type`` "sum", "max", "min" or "avg")."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def placements_to_spec(placements, mesh_dim_names, ndim):
    """[Shard(0), Replicate()] + mesh dims -> spec entries."""
    entries = [None] * ndim
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            if entries[pl.dim] is None:
                entries[pl.dim] = mesh_dim_names[mesh_dim]
            elif isinstance(entries[pl.dim], tuple):
                entries[pl.dim] = entries[pl.dim] + (mesh_dim_names[mesh_dim],)
            else:
                entries[pl.dim] = (entries[pl.dim], mesh_dim_names[mesh_dim])
    return tuple(entries)


def shard_spec_to_spec(shard_spec, ndim):
    """2.5-style shard_spec list (dim name or None per tensor dim)."""
    entries = list(shard_spec) + [None] * (ndim - len(shard_spec))
    return tuple(entries)
