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
  frees it when the backward ends; the optimizer updates the blocks.  A
  parameter read at rest (``numpy()``, ``detach()``, the inner model's
  ``state_dict()`` or forward, a checkpoint) is the whole tensor, as the
  JAX placement's: the read all-gathers the blocks into a temporary,
  which costs one all-gather of that parameter and, at world size > 1,
  is a collective that every rank must make (a read one rank makes alone
  raises after the wrapper's ``read_timeout``); a write at rest, on the
  parameter or through a view of it, lands in the block (the class's
  docstring).  The leaf's storage still holds 0 bytes:
  ``untyped_storage()`` and ``numel()`` read the leaf itself.

A tensor no dim of which splits evenly stays whole on every rank (the
JAX ``P()``), its gradient averaged by an all-reduce.  The global-norm
and per-tensor clips sum their squares over the blocks and the group, so
every level updates to the plain step's values; the optimizer's state
dict is the whole tensors' (gathered), so it crosses to an unsharded
optimizer and to the JAX package.  A ZeRO-3 model's ``state_dict()``
gathers the whole tensors and names, in ``shards``, the block each rank
holds: the distributed checkpoint writes only those blocks.
"""

import contextlib
import copy
import datetime
import os
import weakref

import numpy as np
import torch
from torch._C import DisableTorchFunctionSubclass
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.weak import WeakIdKeyDictionary

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


# ------------------------------------------- a ZeRO-3 parameter at rest --
# What runs on a leaf at rest as it is: attribute getters and setters
# and methods that read no element (its true storage and bytes too).
# Every other function on it reads the whole value (_at_rest_call).
_ELEMENT_ATTRS = ("data", "real", "imag", "T", "H", "mT", "mH")
_META = set()
for _name, _attr in vars(torch._C.TensorBase).items():
    if type(_attr).__name__ == "getset_descriptor" \
            and _name not in _ELEMENT_ATTRS:
        _META.update((getattr(torch.Tensor, _name).__get__,
                      getattr(torch.Tensor, _name).__set__))
for _name in ("size", "dim", "numel", "nelement", "element_size", "stride",
              "storage_offset", "is_contiguous", "is_floating_point",
              "is_complex", "is_signed", "is_inference", "untyped_storage",
              "storage", "_typed_storage", "data_ptr", "get_device",
              "requires_grad_", "detach_", "register_hook",
              "register_post_accumulate_grad_hook", "retain_grad", "__len__",
              "_is_view", "is_shared", "is_pinned", "record_stream",
              "_fix_weakref", "__dir__"):
    _META.add(getattr(torch.Tensor, _name))
_ALIASES = (torch.Tensor.detach, torch.Tensor.data.__get__)
_SET_DATA = torch.Tensor.data.__set__


def _holder(t):
    """(stage, shard) holding ``t`` at rest, or None (``t`` is plain)."""
    stage = type(t)._stage()
    if stage is None or not stage._at_rest:
        return None
    shard = stage._shards.get(stage._holders.get(t))
    return None if shard is None else (stage, shard)


def _storage_ptr(t):
    with DisableTorchFunctionSubclass():
        return t.untyped_storage().data_ptr() \
            if t.layout == torch.strided else 0


class _ReadAtRest(torch.autograd.Function):
    """The whole value of a leaf at rest; its gradient reaches the leaf
    whole, as in the wrapper's own forward."""

    @staticmethod
    def forward(ctx, leaf, g, block, axis):
        return _gather_axis(g, block, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _Whole:
    """A parameter's whole value, all-gathered at rest for an op
    (``value``), with the block it was gathered from and the versions
    both had then: an op that bumped ``value``'s version wrote into the
    parameter, and a view of ``value`` (:class:`_ViewAtRest`) re-reads it
    where the block has changed since."""

    __slots__ = ("stage", "shard", "value", "block", "version", "seen")

    def __init__(self, stage, shard, given):
        self.stage, self.shard = stage, shard
        stage._all_read()
        if torch.is_grad_enabled() and given.requires_grad:
            with DisableTorchFunctionSubclass():
                self.value = _ReadAtRest.apply(given, stage._g, shard.block,
                                               shard.axis)
        else:
            # a normal tensor under inference mode too: it keeps a version
            with torch.inference_mode(False):
                self.value = _gather_axis(stage._g, shard.block, shard.axis)
        self.mark()

    def mark(self):
        """``value`` is the block's now."""
        self.block = self.shard.block
        self.version, self.seen = self.block._version, self.value._version

    def sync(self):
        """Re-read ``value`` where the block changed since it was read."""
        if self.shard.block is not self.block \
                or self.block._version != self.version:
            self.stage._all_read()
            with torch.no_grad(), DisableTorchFunctionSubclass():
                self.value.copy_(_gather_axis(self.stage._g,
                                              self.shard.block,
                                              self.shard.axis))
            self.mark()

    def write_back(self, given):
        """Where the op wrote into ``value``, make it the parameter's
        value (its block); an in-place op on a tensor that requires grad
        raises as torch does and writes nothing."""
        if self.value._version == self.seen:
            return
        if torch.is_grad_enabled() and any(t.requires_grad for t in given):
            self.version = None     # the next read of a view re-reads
            raise RuntimeError("a leaf Variable that requires grad is "
                               "being used in an in-place operation.")
        self.stage._write_whole(self.shard, self.value)
        self.mark()


_VIEWS = WeakIdKeyDictionary()      # a view of a whole value -> its _Whole


def _at_rest_call(func, args, kwargs):
    flat, spec = tree_flatten((args, kwargs))
    given, wholes, by_shard = list(flat), {}, {}
    for i, a in enumerate(flat):
        if isinstance(a, _ViewAtRest):
            w = _VIEWS.get(a)
            if w is not None:
                wholes[i] = w
        elif isinstance(a, _AtRest):
            h = _holder(a)
            if h is not None:
                wholes[i] = h
    if not wholes:
        with DisableTorchFunctionSubclass():
            return func(*args, **kwargs)
    if func in _ALIASES and isinstance(wholes.get(0), tuple):
        stage, _ = wholes[0]
        with DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
        out.__class__ = stage._rest_class(type(out))
        stage._holders[out] = stage._holders[args[0]]
        return out
    if func == _SET_DATA and isinstance(wholes.get(0), tuple):
        stage, shard = wholes[0]
        return stage._write_whole(shard, args[1])
    params = {}
    for i, w in list(wholes.items()):
        if isinstance(w, _Whole):
            w.sync()
            continue
        stage, shard = w
        if id(shard) not in by_shard:
            by_shard[id(shard)] = _Whole(stage, shard, flat[i])
        w = wholes[i] = by_shard[id(shard)]
        flat[i] = w.value
        params[id(w.value)] = given[i]
    new_args, new_kwargs = tree_unflatten(flat, spec)
    with DisableTorchFunctionSubclass():
        out = func(*new_args, **new_kwargs)
    seen = {}
    for i, w in wholes.items():
        seen.setdefault(id(w), (w, []))[1].append(given[i])
    for w, args_of in seen.values():
        w.write_back(args_of)
    values = {_storage_ptr(w.value): w for w, _ in seen.values()}
    return tree_map(lambda o: _through(o, params, values), out)


def _through(o, params, values):
    """A result of an op at rest: the parameter where it is the value
    gathered for it (an in-place op's or ``to``'s own input), a view
    that reads and writes through a value it shares memory with, an
    array of such a value read-only."""
    if id(o) in params:
        return params[id(o)]
    if isinstance(o, np.ndarray) and not o.flags.owndata:
        o.flags.writeable = False
    if isinstance(o, torch.Tensor) and not isinstance(o, _AtRest):
        w = values.get(_storage_ptr(o))
        if w is not None and o is not w.value:
            o.__class__ = _ViewAtRest
            _VIEWS[o] = w
    return o


def _dispatch(cls, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if func in _META or (func == torch.Tensor.type and len(args) == 1
                         and not kwargs):
        with DisableTorchFunctionSubclass():
            return func(*args, **kwargs)
    return _at_rest_call(func, args, kwargs)


class _AtRest:
    """The mixin of the class a ZeRO-3 leaf takes at rest, and of the
    aliases ``detach()`` and ``.data`` make of it there; a subclass a
    stage and leaf class (:meth:`GroupShardedStage3._rest_class`)."""

    __torch_function__ = classmethod(_dispatch)

    def __deepcopy__(self, memo):
        """A whole copy in the leaf's own class (``Parameter``'s would
        take this class)."""
        with torch.no_grad():
            data = self.clone()
        out = self._plain(data, self.requires_grad) \
            if issubclass(self._plain, torch.nn.Parameter) \
            else data.requires_grad_(self.requires_grad)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out


class _ViewAtRest(torch.Tensor):
    """A view of a whole value read at rest (``p.view(-1)``, ``p[0]``,
    ``p.T``): each op on it first re-reads the value where the block has
    changed since, and a write into it lands in the block."""

    __torch_function__ = classmethod(_dispatch)

    def __deepcopy__(self, memo):
        with torch.no_grad():
            out = self.clone().requires_grad_(self.requires_grad)
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        with DisableTorchFunctionSubclass():
            return self.as_subclass(torch.Tensor).__reduce_ex__(proto)


class _Sliced:
    """The mixin of the class a Paddle ``Parameter`` of stage 3 takes: a
    rebind of its value at rest (``set_value``, ``copy_``, ``Layer.to``)
    lands in the block and the leaf stays; it pickles and copies as its
    own class."""

    def _to_block(self, new):
        h = _holder(self._data) if isinstance(self._data, _AtRest) else None
        if h is None or h[1].leaf is not self._data:
            return False
        h[0]._write_whole(h[1], new)
        return True

    def _rebind_value(self, new):
        return self if self._to_block(new) else super()._rebind_value(new)

    def _rebind(self, data):
        return self if self._to_block(data) else super()._rebind(data)

    @contextlib.contextmanager
    def _as_plain(self):
        cls, self.__class__ = self.__class__, self._plain
        try:
            yield self
        finally:
            self.__class__ = cls

    def __reduce__(self):
        with self._as_plain():
            return self.__reduce__()

    def __deepcopy__(self, memo):
        with self._as_plain():
            return self.__deepcopy__(memo)


class _Shard:
    """A sliced parameter: its owner (a Paddle Parameter or a torch
    leaf), the axis, this rank's block, and the leaf that is freed at
    rest with its own class and the class it takes there."""

    __slots__ = ("param", "axis", "block", "leaf", "cls", "rest")

    def __init__(self, param, axis, block, rest_class):
        self.param, self.axis, self.block = param, axis, block
        self.leaf = _leaf(param)
        self.cls = type(self.leaf)
        self.rest = rest_class(self.cls)


class GroupShardedStage3(_Wrapper):
    """Parameters kept as this rank's block at rest (module docstring).
    Reference: group_sharded_stage3.py's pre-forward gather and post
    hooks, at the granularity of the whole model.

    At rest every sliced leaf holds no bytes and takes a subclass of its
    own class, so the optimizer, autograd and the model keep the same
    object.  Its ``__torch_function__`` reads it as the whole tensor:
    every op on it runs on the blocks all-gathered into a temporary
    (with grad enabled, a gather whose gradient reaches the leaf whole),
    which goes when the op's result does.  An op that reads no element
    (shape, dtype, device, ``grad``, ``requires_grad``, hooks,
    ``untyped_storage()``, ``data_ptr()``) runs on the leaf itself, so
    the storage reads 0 bytes.  ``detach()`` and ``.data`` give aliases
    that read and write the same way.  An op that bumps the temporary's
    version counter wrote into it (an in-place op, ``out=``, indexing
    assignment, ``F.relu(p, inplace=True)``), and the temporary becomes
    the block; so does ``p.data =``, and a Paddle ``set_value``,
    ``copy_`` or ``Layer.to`` (its parameter takes a subclass too).  A
    view taken at rest (``view``, indexing, ``.T``) reads and writes
    through its temporary, which it re-reads first where the block has
    changed since; an array from ``numpy()`` is read-only.  Each read
    costs one all-gather of the parameter: at world size > 1 it is a
    collective, so every rank must read the same parameters in the same
    order, as ``state_dict()`` requires.  A read that the other ranks do
    not make within ``read_timeout`` seconds (a barrier on a gloo group
    of its own) raises instead of hanging.  ``forward`` gathers the
    leaves in place and restores their class, so the step's own ops pay
    nothing."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=None, offload=False):
        super().__init__(layer)
        self._group = group
        self._g = group if group is not None else _ensure_default_group()
        n, r = self._g.nranks, max(self._g.rank, 0)
        self._shards = {}     # id(param) -> _Shard
        self._names = {}
        self._in_backward = False
        self._at_rest = False
        self._rest_classes = {}
        self._holders = WeakIdKeyDictionary()   # leaf or alias -> id(param)
        # seconds a read at rest waits for the other ranks to make it too
        self.read_timeout = 120.0
        self._reads = None if _pg(self._g) is None else \
            torch.distributed.new_group(self._g.ranks, backend="gloo",
                                        use_local_synchronization=True)
        for name, p in self._named():
            p.zero_stage = 3
            axis = _shard_spec(tuple(p.shape), n)
            p.sharding_axis = axis
            self._names[id(p)] = name
            if axis is not None:
                block = _block(_leaf(p).detach(), axis, r, n).clone()
                self._shards[id(p)] = _Shard(p, axis, block,
                                             self._rest_class)
                self._holders[_leaf(p)] = id(p)
                if isinstance(p, Tensor):
                    p.__class__ = self._rest_class(type(p), _Sliced, "")
        self._release()

    def _rest_class(self, cls, mixin=_AtRest, suffix="AtRest"):
        """The class a tensor of class ``cls`` takes at rest here (a
        Paddle parameter's, ``mixin`` _Sliced, for good)."""
        out = self._rest_classes.get((cls, mixin))
        if out is None:
            out = self._rest_classes[cls, mixin] = type(
                f"{cls.__name__}{suffix}", (mixin, cls),
                {"_plain": cls, "_stage": weakref.ref(self)})
        return out

    def _all_read(self):
        """Wait for every rank to make this read at rest too: it
        all-gathers, and a read that one rank makes alone would hang."""
        if self._reads is None:
            return
        try:
            torch.distributed.monitored_barrier(
                self._reads,
                timeout=datetime.timedelta(seconds=self.read_timeout))
        except RuntimeError as e:
            raise RuntimeError(
                "GroupShardedStage3: a parameter read at rest all-gathers "
                "its blocks, and a rank did not make the read within "
                f"{self.read_timeout} s; read on every rank (the "
                "wrapper's state_dict(), then save on one)") from e

    def _named(self):
        return list(self._layers.named_parameters())

    def shard_of(self, p):
        """This rank's block of parameter ``p`` (None: ``p`` is whole)."""
        shard = self._shards.get(id(p))
        return None if shard is None else shard.block

    def _managed(self):
        """The shards whose leaf is the parameter's value now (a
        ``functional_call`` or a ``to_static`` trace binds its own
        values in their place, which the forward then reads)."""
        return [s for s in self._shards.values() if _leaf(s.param) is s.leaf]

    def _gather(self):
        self._at_rest = False
        for s in self._managed():
            full = _gather_axis(self._g, s.block, s.axis)
            leaf = s.leaf
            leaf.__class__ = s.cls
            leaf.untyped_storage().resize_(leaf.numel()
                                           * leaf.element_size())
            leaf.data.copy_(full)

    def _release(self):
        for s in self._managed():
            s.leaf.untyped_storage().resize_(0)
            s.leaf.__class__ = s.rest
        self._at_rest = True

    @contextlib.contextmanager
    def _own_classes(self):
        """The leaves at rest in their own classes for the body: the ZeRO
        step reads and clears their gradients, and reads no element of
        them (it updates the blocks), so it pays no dispatch."""
        shards = self._managed() if self._at_rest else []
        for s in shards:
            s.leaf.__class__ = s.cls
        try:
            yield
        finally:
            for s in shards:
                s.leaf.__class__ = s.rest

    def _write_whole(self, shard, new):
        """Make ``new``, a whole value of the parameter, its value at
        rest: this rank's block of it.  A new dtype or device is the
        leaf's too, which still holds no bytes."""
        leaf = shard.leaf
        if tuple(new.shape) != tuple(leaf.shape):
            raise RuntimeError(
                f"a ZeRO-3 parameter of shape {tuple(leaf.shape)} at rest "
                f"cannot take a value of shape {tuple(new.shape)}")
        n, r = self._g.nranks, max(self._g.rank, 0)
        with torch.no_grad():
            block = _block(new.detach(), shard.axis, r, n)
            if (block.dtype, block.device) == (shard.block.dtype,
                                               shard.block.device):
                shard.block.copy_(block)
                return None
            with torch.inference_mode(False):
                shard.block = block.clone()
            empty = torch.empty(tuple(leaf.shape), dtype=block.dtype,
                                device=block.device)
            empty.untyped_storage().resize_(0)
            with DisableTorchFunctionSubclass():
                _SET_DATA(leaf, empty)
        return None

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
        by_name = {self._names[i]: s for i, s in self._shards.items()}
        out.shards = {name: (by_name[name].axis, max(self._g.rank, 0),
                             self._g.nranks)
                      for name in out if name in by_name}
        return out

    def set_state_dict(self, sd, *a, **k):
        """Load whole tensors: each parameter's write at rest keeps this
        rank's block of it."""
        return self._layers.set_state_dict(sd, *a, **k)


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

    def _own_classes(self):
        return self._model._own_classes() if self._level >= 3 \
            else contextlib.nullcontext()

    def step(self):
        with self._own_classes():
            self._step()

    @torch.no_grad()
    def _step(self):
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
        with self._own_classes():
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
