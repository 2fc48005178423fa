"""Names of the distributed slice that later parts of the port bring.

A submodule whose JAX counterpart holds more than the part ported so far
answers each such name with ``NotImplementedError`` naming the ROADMAP
item that brings it, rather than an ``AttributeError`` that reads as a
missing API.
"""

A23B6C = ("ROADMAP A23b-6c (the parameter server and fleet's dataset, "
          "parallel/, MoE, the CTR models, enable_dist_inference and the "
          "cross-card SyncBatchNorm)")


def later(module, names, item):
    """A module ``__getattr__`` raising for ``names`` (item: the
    ROADMAP item that brings them)."""
    names = frozenset(names)

    def __getattr__(name):
        if name in names:
            raise NotImplementedError(
                f"{module}.{name} is not ported yet: {item}")
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__
