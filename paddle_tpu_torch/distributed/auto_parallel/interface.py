"""shard_tensor / shard_op / shard_layer / reshard.

Reference: auto_parallel/interface.py:28,117 (shard_tensor records a
TensorDistAttr that the Completer propagates).  Port of
``paddle_tpu/distributed/auto_parallel/interface.py``.  In JAX the marker
places a global array with a ``NamedSharding`` and XLA propagates.  The
port runs one process a rank, so a distributed tensor is the rank's
block: ``shard_tensor`` keeps, for each mesh dim with ``Shard(d)``, this
rank's block of tensor dim ``d`` (``Replicate`` and ``Partial`` keep the
value as it is), and the result carries ``process_mesh``,
``placements`` and ``global_shape``.  ``reshard`` moves a distributed
tensor to new placements with collectives over each mesh dim's group:
``Shard`` → ``Replicate`` all-gathers, ``Partial`` → ``Replicate``
all-reduces, ``Replicate`` → ``Shard`` keeps the block, ``Shard(d)`` →
``Shard(e)`` gathers then splits.  The groups are the ``ProcessMesh``'s
(``rank_mesh()``), created on every rank of the world in one order, so
every rank of the world calls these functions together.
"""

import torch

from ...core.tensor import Tensor
from .placement import (
    Partial,
    Placement,
    Replicate,
    Shard,
    shard_spec_to_spec,
)
from .process_mesh import ProcessMesh


class DistTensor(Tensor):
    """A Tensor over this rank's block, with ``process_mesh``,
    ``placements`` and ``global_shape``."""


def _as_mesh(pm):
    return pm if isinstance(pm, ProcessMesh) else ProcessMesh(pm)


def _placements(pm, placements_or_spec, ndim):
    """Placements a mesh dim from the placements API (one per mesh dim)
    or a 2.5 shard_spec (one mesh-dim name or None per tensor dim)."""
    if placements_or_spec is None:
        return [Replicate() for _ in range(pm.ndim)]
    entries = list(placements_or_spec)
    if entries and isinstance(entries[0], Placement):
        return entries + [Replicate()] * (pm.ndim - len(entries))
    out = [Replicate() for _ in range(pm.ndim)]
    for d, name in enumerate(shard_spec_to_spec(entries, ndim)):
        if name is not None:
            out[pm.dim_names.index(name)] = Shard(d)
    return out


def _data(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _block(data, pm, placements):
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = pm.shape[mesh_dim]
            i = max(pm.coord(mesh_dim), 0)
            size = data.shape[pl.dim]
            if size % n:
                raise ValueError(f"dim {pl.dim} of {size} does not split "
                                 f"over {n} ranks")
            data = data.narrow(pl.dim, i * (size // n), size // n)
    return data.contiguous()


def _result(x, data, pm, placements, global_shape, stop_gradient=None):
    if stop_gradient is None:
        stop_gradient = x.stop_gradient if isinstance(x, Tensor) else True
    sg = bool(stop_gradient)
    if isinstance(x, Tensor) and hasattr(x, "__dict__"):
        out = x._rebind(data.detach().requires_grad_(
            not sg and data.is_floating_point()))
    else:
        out = DistTensor(data, stop_gradient=sg)
    out.process_mesh = pm
    out.placements = list(placements)
    out.global_shape = list(global_shape)
    return out


def shard_tensor(x, process_mesh=None, placements=None, shard_spec=None,
                 mesh=None, stop_gradient=None):
    """This rank's block of ``x`` over the mesh (module docstring).

    Accepts both the placements API (``[Shard(0), Replicate()]`` — one entry
    per MESH dim) and the 2.5 shard_spec API (one mesh-dim name or None per
    TENSOR dim).  A Parameter (or another Tensor that takes attributes)
    becomes the block itself; any other input gives a ``DistTensor``.
    """
    pm = _as_mesh(process_mesh if process_mesh is not None else mesh)
    data = _data(x)
    pls = _placements(pm, placements if placements is not None
                      else shard_spec, data.dim())
    return _result(x, _block(data, pm, pls), pm, pls, data.shape,
                   stop_gradient)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """Create a distributed tensor by sharding fn's output."""
    return shard_tensor(fn(*args, **kwargs), process_mesh=mesh,
                        placements=placements)


def _group(pm, mesh_dim):
    return pm.rank_mesh().group(pm.dim_names[mesh_dim])


def reshard(x, mesh, placements):
    """Move a distributed tensor to ``placements`` on ``mesh`` (module
    docstring); a tensor without placements is taken as replicated."""
    from ..fleet.meta_parallel import mp_layers

    pm = _as_mesh(mesh)
    data = _data(x)
    src_pm = getattr(x, "process_mesh", None) or pm
    src = list(getattr(x, "placements", None) or
               [Replicate() for _ in range(src_pm.ndim)])
    # every mesh dim back to replicated on the source mesh ...
    for mesh_dim, pl in enumerate(src):
        if isinstance(pl, Shard):
            data = mp_layers.all_gather(data.contiguous(),
                                        _group(src_pm, mesh_dim), pl.dim)
        elif isinstance(pl, Partial):
            g = _group(src_pm, mesh_dim)
            op = {"sum": "sum", "avg": "sum", "max": "max"}.get(
                pl.reduce_type)
            if op is None:
                raise NotImplementedError(
                    f"Partial({pl.reduce_type!r}) has no reshard")
            data = mp_layers.all_reduce(data, g, op)
            if pl.reduce_type == "avg":
                data = data / g.nranks
    # ... then this rank's block of the target placements
    pls = _placements(pm, placements, data.dim())
    return _result(x, _block(data, pm, pls), pm, pls, data.shape)


def shard_op(op_fn, process_mesh=None, in_shard_specs=None,
             out_shard_specs=None):
    """Wrap a callable so that each output is resharded to its spec in
    ``out_shard_specs`` (one mesh-dim name or None a tensor dim): the
    reference records the dist attrs on the op (interface.py:117) and
    the JAX package constrains the output's sharding; here each rank
    keeps its block of the output."""
    pm = None if process_mesh is None else _as_mesh(process_mesh)

    def wrapped(*args, **kwargs):
        out = op_fn(*args, **kwargs)
        if pm is None or out_shard_specs is None:
            return out

        def constrain(t, spec_entry):
            if spec_entry is None:
                return t
            return reshard(t, pm, list(spec_entry))

        if isinstance(out, (tuple, list)):
            specs = list(out_shard_specs) + [None] * (len(out)
                                                      - len(out_shard_specs))
            return type(out)(constrain(t, s) for t, s in zip(out, specs))
        return constrain(out, out_shard_specs[0])

    return wrapped


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """Shard a Layer's parameters over a mesh (reference api shard_layer).

    ``shard_fn(name, layer, mesh)`` may shard params (``shard_tensor`` on
    them); the default replicates them: each parameter takes the mesh
    and ``Replicate`` placements and, over a mesh of more than one rank,
    the values of the mesh's first rank.  ``input_fn``/``output_fn`` are
    accepted and unused, as in the JAX package."""
    pm = _as_mesh(process_mesh)
    if shard_fn is not None:
        for name, sub in layer.named_sublayers(include_self=True):
            shard_fn(name, sub, pm)
        return layer
    from .. import communication as dist
    from ..fleet.topology import axis_group

    g = axis_group(pm.process_ids) if len(pm.process_ids) > 1 else None
    for p in layer.parameters():
        if g is not None and g.process_group is not None:
            dist.broadcast(p._data, src=pm.process_ids[0], group=g)
        p.process_mesh = pm
        p.placements = [Replicate() for _ in range(pm.ndim)]
        p.global_shape = list(p.shape)
    return layer

