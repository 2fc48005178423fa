"""group_sharded (ZeRO) API — stages 1/2/3 over a process group.

Port of ``paddle_tpu/distributed/sharding/__init__.py``: the API of
``paddle.distributed.sharding.group_sharded_parallel`` /
``save_group_sharded_model`` (reference
python/paddle/distributed/sharding/group_sharded.py:179) and the stage
classes it dispatches to.  The JAX package places arrays: a tensor is
sharded over the group along the first dim that splits evenly
(:func:`_shard_spec`) and XLA inserts the collectives.  The port runs one
process a rank and does the ZeRO stages itself over the group, whose
ranks are data-parallel (each averages the gradients of its own batch),
slicing each tensor along the same axis, rank i holding block i:

- ``os`` (stage 1): the gradients are averaged (one all-reduce a dtype);
  each rank keeps the optimizer state of its block of every parameter
  and updates that block only; the updated blocks are all-gathered into
  every rank's parameters.
- ``os_g`` (stage 2): the gradients are also reduce-scattered: a rank
  gets the average of its block only, and the full gradients go.
- ``p_g_os`` (stage 3): the parameters are also kept as their block at
  rest.  :class:`GroupShardedStage3` frees each sliced parameter's
  storage, all-gathers it before the forward, frees it after, gathers it
  again when the backward starts (a hook on the forward's outputs) and
  frees it when the backward ends; the optimizer updates the blocks.

A tensor no dim of which splits evenly stays whole on every rank (the
JAX ``P()``), its gradient averaged by an all-reduce.  The global-norm
and per-tensor clips sum their squares over the blocks and the group, so
every level updates to the plain step's values; the optimizer's state
dict is the whole tensors' (gathered), so it crosses to an unsharded
optimizer and to the JAX package.  A ZeRO-3 model's ``state_dict()``
gathers the whole tensors and names, in ``shards``, the block each rank
holds: the distributed checkpoint writes only those blocks.
"""

import os

import torch

from ...core.tensor import Tensor
from ..communication import _local
from ..group import _ensure_default_group
from ..parallel import _Wrapper

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def _shard_spec(shape, axis_size):
    """The dim a tensor of ``shape`` is sliced along over ``axis_size``
    ranks: the first that splits evenly (None: the tensor stays whole —
    tiny params aren't worth scattering), the JAX spec's dim."""
    for i, d in enumerate(shape):
        if d % axis_size == 0 and d >= axis_size:
            return i
    return None


def _leaf(p):
    return p._data if isinstance(p, Tensor) else p


def _pg(g):
    """The group's process group, None for a one-rank group without one
    (then every collective below is the identity)."""
    return None if _local(g) else g.process_group


def _staged(g, t):
    t = t.detach()
    if g.backend == "gloo" and t.is_cuda:
        return t.to("cpu", copy=True, memory_format=torch.contiguous_format)
    return t.contiguous()


def _block(t, axis, i, n):
    k = t.shape[axis] // n
    return t.narrow(axis, i * k, k)


def _gather_axis(g, shard, axis):
    """Every rank's block of ``axis``, in rank order: the whole tensor."""
    from torch import distributed as dist

    if _pg(g) is None:
        return shard.detach().clone()
    moved = _staged(g, shard.movedim(axis, 0))
    out = moved.new_empty((g.nranks * moved.shape[0],) + moved.shape[1:])
    dist.all_gather_into_tensor(out, moved, group=g.process_group)
    return out.to(shard.device).movedim(0, axis)


def _reduce_scatter_avg(g, full, axis):
    """This rank's block of the group's average of ``full``."""
    from torch import distributed as dist

    n = g.nranks
    if _pg(g) is None:
        return full.detach().clone()
    moved = _staged(g, full.movedim(axis, 0))
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=g.process_group)
    return out.div_(n).to(full.device).movedim(0, axis)


def _all_reduce(g, tensors, avg=True):
    """The group's sums (averages with ``avg``) of ``tensors``, one
    all-reduce a dtype and device."""
    from torch import distributed as dist

    out = [t.detach().clone() for t in tensors]
    if _pg(g) is None or not out:
        return out
    kinds = {}
    for i, t in enumerate(out):
        kinds.setdefault((t.dtype, t.device), []).append(i)
    for idx in kinds.values():
        flat = _staged(g, torch.cat([out[i].reshape(-1) for i in idx]))
        dist.all_reduce(flat, group=g.process_group)
        if avg:
            flat.div_(g.nranks)
        off = 0
        for i in idx:
            k = out[i].numel()
            out[i] = flat[off:off + k].view(out[i].shape).to(out[i].device)
            off += k
    return out


class ShardedStateDict(dict):
    """A state dict of whole tensors, with ``shards``: name -> (axis,
    block index, block count) of the block this rank holds."""

    def __init__(self, *a, shards=None, **k):
        super().__init__(*a, **k)
        self.shards = dict(shards or {})


class GroupShardedStage3(_Wrapper):
    """Parameters kept as this rank's block at rest (module docstring).
    Reference: group_sharded_stage3.py's pre-forward gather and post
    hooks, at the granularity of the whole model."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=None, offload=False):
        super().__init__(layer)
        self._group = group
        self._g = group if group is not None else _ensure_default_group()
        n, r = self._g.nranks, max(self._g.rank, 0)
        self._shards = {}     # id(param) -> [param, axis, block]
        self._names = {}
        self._in_backward = False
        for name, p in self._named():
            p.zero_stage = 3
            axis = _shard_spec(tuple(p.shape), n)
            p.sharding_axis = axis
            self._names[id(p)] = name
            if axis is not None:
                block = _block(_leaf(p).detach(), axis, r, n).clone()
                self._shards[id(p)] = [p, axis, block]
        self._release()

    def _named(self):
        return list(self._layers.named_parameters())

    def shard_of(self, p):
        """This rank's block of parameter ``p`` (None: ``p`` is whole)."""
        entry = self._shards.get(id(p))
        return None if entry is None else entry[2]

    def _gather(self):
        for p, axis, block in self._shards.values():
            full = _gather_axis(self._g, block, axis)
            leaf = _leaf(p)
            leaf.untyped_storage().resize_(leaf.numel()
                                           * leaf.element_size())
            leaf.data.copy_(full)

    def _release(self):
        for p, _, _ in self._shards.values():
            _leaf(p).untyped_storage().resize_(0)

    def _pre_backward(self, grad):
        if not self._in_backward:
            self._in_backward = True
            self._gather()
            torch.autograd.Variable._execution_engine.queue_callback(
                self._post_backward)
        return grad

    def _post_backward(self):
        self._release()
        self._in_backward = False

    def forward(self, *args, **kwargs):
        self._gather()
        try:
            out = self._layers(*args, **kwargs)
        finally:
            self._release()
        if torch.is_grad_enabled():
            stack = [out]
            while stack:
                o = stack.pop()
                if isinstance(o, (list, tuple)):
                    stack.extend(o)
                elif isinstance(o, dict):
                    stack.extend(o.values())
                else:
                    t = _leaf(o)
                    if isinstance(t, torch.Tensor) and t.requires_grad:
                        t.register_hook(self._pre_backward)
        return out

    def state_dict(self, *a, **k):
        """The whole tensors (gathered copies), with the blocks this rank
        holds named in ``shards`` (module docstring)."""
        self._gather()
        try:
            sd = self._layers.state_dict(*a, **k)
            out = ShardedStateDict()
            for name, v in sd.items():
                data = _leaf(v).detach().clone()
                out[name] = Tensor(data) if isinstance(v, Tensor) else data
        finally:
            self._release()
        by_name = {self._names[i]: e for i, e in self._shards.items()}
        out.shards = {name: (by_name[name][1], max(self._g.rank, 0),
                             self._g.nranks)
                      for name in out if name in by_name}
        return out

    def set_state_dict(self, sd, *a, **k):
        """Load whole tensors and keep this rank's blocks of them."""
        self._gather()
        try:
            ret = self._layers.set_state_dict(sd, *a, **k)
            n, r = self._g.nranks, max(self._g.rank, 0)
            for entry in self._shards.values():
                entry[2] = _block(_leaf(entry[0]).detach(), entry[1], r,
                                  n).clone()
        finally:
            self._release()
        return ret


class GroupShardedStage2(_Wrapper):
    """Gradients and optimizer state sliced, parameters whole (the
    optimizer wrapper reduce-scatters).  Reference:
    group_sharded_stage2.py."""

    def __init__(self, layer, optimizer=None, group=None, **kw):
        super().__init__(layer)
        self._group = group
        n = (group if group is not None else _ensure_default_group()).nranks
        for p in layer.parameters():
            p.zero_stage = 2
            p.sharding_axis = _shard_spec(tuple(p.shape), n)


class ShardingOptimizerWrapper:
    """The ZeRO step of ``optimizer`` over ``group`` at ``level`` (1, 2
    or 3; module docstring).  Covers DygraphShardingOptimizer (stage 1,
    dygraph_sharding_optimizer.py:96) and GroupShardedOptimizerStage2:
    every tensor is sliced by blocks, which balances memory and needs no
    greedy assignment of parameters to ranks.  ``model`` is the
    :class:`GroupShardedStage3` whose blocks a level-3 step updates."""

    def __init__(self, optimizer, group=None, level=1, model=None):
        self._inner_opt = optimizer
        self._g = group if group is not None else _ensure_default_group()
        self._level = level
        self._model = model

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _axis(self, item):
        axis = getattr(item, "sharding_axis", None)
        if axis is None and not hasattr(item, "sharding_axis"):
            axis = _shard_spec(tuple(_leaf(item).shape), self._g.nranks)
        return axis

    def _blocks(self, item, leaf):
        """(this rank's block of the parameter to update in place, its
        axis or None)."""
        axis = self._axis(item)
        if axis is None:
            return leaf, None
        if self._level >= 3:
            return self._model.shard_of(item), axis
        return _block(leaf, axis, max(self._g.rank, 0), self._g.nranks), axis

    def _grad_blocks(self, items):
        """The group's average gradient of each (item, leaf), as this
        rank's block where the parameter is sliced."""
        g, r, n = self._g, max(self._g.rank, 0), self._g.nranks
        grads = [leaf.grad for _, leaf in items]
        axes = [self._axis(item) for item, _ in items]
        if self._level == 1:
            full = _all_reduce(g, grads)
            return full, axes
        whole = [i for i, a in enumerate(axes) if a is None]
        out = [None] * len(items)
        for i, avg in zip(whole, _all_reduce(g, [grads[i] for i in whole])):
            out[i] = avg
        for i, a in enumerate(axes):
            if a is not None:
                out[i] = _reduce_scatter_avg(g, grads[i], a)
        return out, axes

    def _clip(self, blocks, axes):
        """The optimizer's clip over gradient blocks: norms summed over
        the blocks of the group, so it equals the unsliced clip."""
        from ...optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                       ClipGradByValue)

        clip = self._inner_opt._grad_clip
        if isinstance(clip, ClipGradByValue):
            return clip._clip(None, blocks)
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            raise NotImplementedError(
                f"{type(clip).__name__} over gradient blocks")
        sq = [torch.sum(torch.square(b.float())) for b in blocks]
        sliced = [i for i, a in enumerate(axes) if a is not None]
        for i, s in zip(sliced, _all_reduce(self._g, [sq[i] for i in sliced],
                                            avg=False)):
            sq[i] = s
        if isinstance(clip, ClipGradByGlobalNorm):
            gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
            scale = clip.clip_norm / torch.clamp(gnorm, min=clip.clip_norm)
            return torch._foreach_mul(blocks, scale)
        out = []
        for b, s in zip(blocks, sq):
            scale = torch.clamp(clip.clip_norm / torch.clamp(
                torch.sqrt(s), min=1e-12), max=1.0)
            out.append((b.float() * scale).to(b.dtype))
        return out

    @torch.no_grad()
    def step(self):
        inner = self._inner_opt
        items = []
        for item in inner._parameters:
            leaf = _leaf(item)
            if leaf.grad is not None and leaf.requires_grad:
                items.append((item, leaf))
        inner._step_count += 1
        if not items:
            return
        lr = inner.get_lr()
        r, n = max(self._g.rank, 0), self._g.nranks
        grads, axes = self._grad_blocks(items)
        if self._level == 1:
            if inner._grad_clip is not None:
                grads = inner._grad_clip._clip([l for _, l in items], grads)
            grads = [gr if a is None else _block(gr, a, r, n)
                     for gr, a in zip(grads, axes)]
        elif inner._grad_clip is not None:
            grads = self._clip(grads, axes)
        owners, params, states = [], [], []
        for (item, leaf), a in zip(items, axes):
            block, _ = self._blocks(item, leaf)
            owners.append(item)
            params.append(block)
            state = inner._accumulators.get(id(item))
            if state is None:
                state = inner._accumulators[id(item)] = \
                    inner._init_state(block)
            states.append(state)
        if inner._weight_decay and not inner._decay_applied_in_rule():
            wd = float(inner._weight_decay)
            grads = [gr + wd * p for gr, p in zip(grads, params)]
        inner._apply(params, grads, states, lr, owners)
        if self._level >= 2:
            for _, leaf in items:
                leaf.grad = None
        if self._level < 3:
            for (item, leaf), block, a in zip(items, params, axes):
                if a is not None:
                    leaf.copy_(_gather_axis(self._g, block, a))

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        """The inner optimizer's state dict with every sliced state
        gathered whole (the unsliced optimizer's keys and shapes)."""
        sd = self._inner_opt.state_dict()
        for i, item in enumerate(self._inner_opt._parameters):
            axis = self._axis(item)
            state = self._inner_opt._accumulators.get(id(item))
            if axis is None or not state:
                continue
            shape = tuple(_leaf(item).shape)
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and v.dim() == len(shape) \
                        and tuple(v.shape) != shape:
                    sd[f"param{i}.{k}"] = _gather_axis(self._g, v, axis)
        return sd

    def set_state_dict(self, state_dict):
        """Load whole states and keep this rank's blocks of them."""
        inner = self._inner_opt
        inner.set_state_dict(state_dict)
        r, n = max(self._g.rank, 0), self._g.nranks
        for item in inner._parameters:
            axis = self._axis(item)
            state = inner._accumulators.get(id(item))
            if axis is None or not state:
                continue
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and \
                        tuple(v.shape) == tuple(_leaf(item).shape):
                    state[k] = _block(v, axis, r, n).clone()


# Reference-named alias (dygraph_sharding_optimizer.py:96)
DygraphShardingOptimizer = ShardingOptimizerWrapper


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=0, segment_size=0,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Reference entry point (group_sharded.py:179).  level: 'os' |
    'os_g' | 'p_g_os'.  Returns (model, optimizer, scaler)."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    stage = _LEVELS[level]
    g = group if group is not None else _ensure_default_group()
    if stage >= 3:
        model = GroupShardedStage3(model, optimizer=optimizer, group=g,
                                   sync_buffers=sync_buffers,
                                   offload=offload)
    elif stage == 2:
        model = GroupShardedStage2(model, optimizer=optimizer, group=g)
    else:
        for p in model.parameters():
            p.zero_stage = 1
            p.sharding_axis = _shard_spec(tuple(p.shape), g.nranks)
    optimizer = ShardingOptimizerWrapper(
        optimizer, group=g, level=stage,
        model=model if stage >= 3 else None)
    return model, optimizer, scaler


def _host(v):
    """A state value as the reference saves it: a numpy array (a Tensor
    for bfloat16, which numpy has no dtype for), or the value."""
    if isinstance(v, (Tensor, torch.Tensor)):
        data = _leaf(v).detach().cpu()
        return Tensor(data) if data.dtype == torch.bfloat16 else \
            data.numpy()
    return v


def save_group_sharded_model(model, output, optimizer=None):
    """Gather shards and save full state (reference group_sharded.py:149).
    Every rank of the group calls it (the gathers); rank 0 writes."""
    from ...framework_io import save

    sd = model.state_dict()
    opt_sd = None
    if optimizer is not None:
        opt_sd = _opt_state_arrays(optimizer)
    g = getattr(model, "_g", None) or _ensure_default_group()
    if g.rank > 0:
        return
    os.makedirs(output, exist_ok=True)
    save({k: _host(v) for k, v in sd.items()},
         os.path.join(output, "model.pdmodel"))
    if opt_sd is not None:
        save({k: _host(v) for k, v in opt_sd.items()},
             os.path.join(output, "model.pdopt"))


def _opt_state_arrays(opt):
    flat = {}
    sd = opt.state_dict() if hasattr(opt, "state_dict") else {}
    for k, v in sd.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[f"{k}.{k2}"] = v2
        else:
            flat[k] = v
    return flat
