"""SPMD context: the active mesh and the sharding helpers.

Port of ``paddle_tpu/distributed/fleet/spmd.py``.  The JAX module
installs a device mesh, turns ``Parameter.mesh_axes`` into
``NamedSharding`` s and ``jax.device_put`` s the arrays; GSPMD then
derives the communication.  The port runs one process a rank and its
mesh is a ``topology.RankMesh`` of ranks:

- ``use_mesh`` / ``current_mesh``: the thread's active mesh, as in JAX
  (the models' context-parallel attention reads it);
- ``named_sharding`` / ``param_shardings``: a :class:`NamedSharding`
  (the mesh and a spec tuple, axis names the mesh lacks dropped) a
  parameter, from its ``mesh_axes``;
- ``shard_parameters`` slices every parameter split over ``mp`` to this
  rank's block (``mp_layers.block_of``: the packed qkv and gate_up by
  their parts) and gives every module of the model the
  ``mp_layers.MPContext`` its forward runs the Megatron collectives
  with.  Under sequence parallelism (the model's
  ``config.sequence_parallel``) each replicated parameter is marked
  ``sequence_parallel``: its gradient is a partial sum over the ranks'
  sequence shards, which the hybrid optimizer all-reduces over the mp
  group before it clips;
- ``gather_parameters`` is the inverse: every parameter whole again, in
  the JAX layout (the qkv columns in their JAX order);
- ``shard_batch`` gives this rank its block of dim 0 over the data axes.
"""

import contextlib
import threading

import torch

from ...core.tensor import Tensor
from ...framework.random import modules_of
from ..parallel import _leaf
from .meta_parallel import mp_layers


class _SpmdState(threading.local):
    def __init__(self):
        self.mesh = None


_state = _SpmdState()


def current_mesh():
    return _state.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _state.mesh
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


class NamedSharding:
    """A mesh and a spec (one mesh axis name, tuple of names or None a
    dim): the port's ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def named_sharding(mesh, axes, ndim=None):
    """axes: tuple like ("mp", None) aligned to leading dims."""
    if axes is None:
        return NamedSharding(mesh, ())
    spec = list(axes)
    if ndim is not None:
        spec = spec + [None] * (ndim - len(spec))
    # drop axis names not present in this mesh (e.g. mp metadata on a dp mesh)
    spec = [a if (a is None or a in mesh.axis_names or
                  isinstance(a, tuple)) else None for a in spec]
    return NamedSharding(mesh, spec)


def _params(layer):
    """(name, parameter) pairs of a port Layer or a torch module."""
    return list(layer.named_parameters())


def param_shardings(layer, mesh):
    """dict name -> NamedSharding from Parameter.mesh_axes (default
    replicated)."""
    return {name: named_sharding(mesh, getattr(p, "mesh_axes", None),
                                 ndim=len(p.shape))
            for name, p in _params(layer)}


def _model_seed(layer):
    for m in modules_of(layer):
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator):
            return g.initial_seed()
    return torch.initial_seed()


def shard_parameters(layer, mesh, placement=True):
    """Slice every parameter split over ``mp`` to this rank's block and
    give the model its ``MPContext`` (module docstring).  A mesh whose
    ``mp`` axis has one rank changes nothing."""
    if mesh.axis_size("mp") <= 1:
        return layer
    group = mesh.group("mp")
    cfg = getattr(layer, "config", None)
    sp = bool(getattr(cfg, "sequence_parallel", False))
    params = _params(layer)
    device = _leaf(params[0][1]).device if params else torch.device("cpu")
    ctx = mp_layers.MPContext(group, sequence_parallel=sp)
    ctx.generator = mp_layers.local_generator(device, _model_seed(layer),
                                              ctx.rank)
    with torch.no_grad():
        for _, p in params:
            axes, parts = mp_layers.param_spec(p)
            if mp_layers.mp_dim(axes) is None:
                if sp:
                    p.sequence_parallel = True
                continue
            leaf = _leaf(p)
            block = mp_layers.block_of(leaf.detach(), axes, parts, ctx.rank,
                                       ctx.size).clone()
            if isinstance(p, Tensor):
                p._rebind(block.requires_grad_(leaf.requires_grad))
            else:
                p.data = block
    for m in modules_of(layer):
        m.__dict__["_mp"] = ctx
        m.__dict__["mp_generator"] = ctx.generator
    return layer


def gather_parameters(layer):
    """{name: whole parameter} in the JAX layout: each sliced parameter's
    blocks gathered over the model's mp group and put back in the JAX
    order (``mp_layers.whole_of``); a replicated one as it is."""
    from torch import distributed as dist

    ctx = mp_layers.mp_of(layer)
    out = {}
    for name, p in _params(layer):
        leaf = _leaf(p).detach()
        axes, parts = mp_layers.param_spec(p)
        if ctx is None or ctx.size == 1 or mp_layers.mp_dim(axes) is None:
            out[name] = leaf
            continue
        buf = mp_layers._stage(ctx.group, leaf)
        blocks = [torch.empty_like(buf) for _ in range(ctx.size)]
        dist.all_gather(blocks, buf, group=ctx.group.process_group)
        out[name] = mp_layers.whole_of(
            [b.to(leaf.device) for b in blocks], axes, parts)
    return out


def batch_spec(mesh, extra_batch_axes=("dp",)):
    axes = tuple(a for a in extra_batch_axes if a in mesh.axis_names)
    if not axes:
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def _batch_block(mesh, axes):
    """(this rank's index, count) over the data axes ``axes``, flattened
    in mesh order."""
    index, count = 0, 1
    for a in axes:
        n = mesh.axis_size(a)
        index = index * n + max(mesh.coord(a), 0)
        count *= n
    return index, count


def shard_batch(batch, mesh, axes=("dp",)):
    """This rank's block of dim 0 of every tensor in ``batch`` (a tensor,
    a Tensor or a tuple/list/dict of them) over the data ``axes``."""
    present = tuple(a for a in axes if a in mesh.axis_names)
    index, count = _batch_block(mesh, present)

    def put(x):
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        data = x._data if isinstance(x, Tensor) else x
        if count == 1 or not isinstance(data, torch.Tensor):
            return x
        n = data.shape[0]
        if n % count:
            raise ValueError(f"a batch of {n} does not split over {count} "
                             f"ranks of {present}")
        k = n // count
        out = data[index * k:(index + 1) * k]
        return Tensor(out, stop_gradient=x.stop_gradient) \
            if isinstance(x, Tensor) else out

    return put(batch)
