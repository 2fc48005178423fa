"""Communication API (reference python/paddle/distributed/communication/).

Port of ``paddle_tpu/distributed/communication.py``.  The JAX module
runs one controller: "each rank's tensor" is one shard of a global array,
and a collective is a ``lax.psum``-family call inside ``shard_map``; on an
unsharded array (one copy) it is the identity.  The port runs one process
a rank, and each collective is the ``torch.distributed`` call on the
rank's own tensor, over the group's process group:

- ``all_reduce`` (SUM, MAX, MIN, PROD, AVG), ``broadcast``, ``reduce``,
  ``scatter``, ``send`` and ``recv`` write the rank's tensor: a Tensor
  takes the result as its value (the JAX ``set_value``), a raw torch
  tensor is written in place; both are returned.
- ``all_gather`` fills ``tensor_list`` with the ranks' tensors in rank
  order and returns their concatenation along axis 0, a Tensor;
  ``all_gather_object`` fills ``object_list``.
- ``reduce_scatter`` reduces the concatenation of ``tensor_list`` (or
  the tensor) over the ranks and gives each rank its block of axis 0.
- ``alltoall`` / ``all_to_all`` sends block i (list item i, or block i
  of axis 0) to rank i.
- ``p2p_permute(tensor, perm)`` sends each rank's tensor along the
  ``(src, dst)`` pairs of group ranks; a rank no pair sends to gets
  zeros, as ``lax.ppermute`` gives.
- ``barrier`` and ``wait``.

AVG is SUM divided by the group's size (gloo has no AVG).  A gloo group
stages a CUDA tensor through the host.  A collective runs only over a
process group: the one exception is a group of one rank that has none
(a job of one process), where the result is the JAX module's identity;
a rank outside the group leaves its tensor as it is.  Every call is
synchronous: ``sync_op=False`` is accepted and changes nothing.
"""

import torch

from ..core.tensor import Tensor, _wrap
from .group import _ensure_default_group, _global_rank


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _resolve(group):
    return group if group is not None else _ensure_default_group()


def _data(x):
    return x._data if isinstance(x, Tensor) else x


def _local(g):
    """Whether the collective is the identity of one copy (a group of
    one rank without a process group); a group of more ranks without
    one raises."""
    if g.process_group is not None:
        return False
    if g.nranks == 1:
        return True
    raise RuntimeError(f"{g} has no process group: call "
                       "paddle.distributed.init_parallel_env() first")


def _torch_op(op):
    from torch import distributed as dist
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "prod": dist.ReduceOp.PRODUCT}[op]


def _staged(g, t):
    """The buffer a collective of ``g`` runs on: a contiguous copy of
    ``t`` (on the host for a gloo group and a CUDA tensor)."""
    t = t.detach()
    if g.backend == "gloo" and t.is_cuda:
        return t.to("cpu", copy=True, memory_format=torch.contiguous_format)
    return t.clone(memory_format=torch.contiguous_format)


def _give(tensor, buf):
    """Make ``buf`` the value of ``tensor`` (a Tensor or a torch tensor),
    on its device; returns ``tensor``."""
    if isinstance(tensor, Tensor):
        return tensor.set_value(buf)
    with torch.no_grad():
        tensor.copy_(buf)
    return tensor


def _avg(buf, n):
    if buf.is_floating_point() or buf.is_complex():
        return buf.div_(n)
    return buf.floor_divide_(n)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    if _local(g) or not g.is_member():
        return tensor
    buf = _staged(g, _data(tensor))
    dist.all_reduce(buf, op=_torch_op(op), group=g.process_group)
    if op == ReduceOp.AVG:
        _avg(buf, g.nranks)
    return _give(tensor, buf)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    data = _data(tensor).detach()
    if _local(g):
        parts = [data.clone() for _ in range(g.nranks)]
    else:
        buf = _staged(g, data)
        parts = [torch.empty_like(buf) for _ in range(g.nranks)]
        dist.all_gather(parts, buf, group=g.process_group)
        parts = [p.to(data.device) for p in parts]
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(_wrap(p) for p in parts)
    return _wrap(torch.cat(parts, dim=0) if data.dim() else
                 torch.stack(parts))


def all_gather_object(object_list, obj, group=None):
    from torch import distributed as dist

    g = _resolve(group)
    if _local(g):
        got = [obj] * g.nranks
    else:
        got = [None] * g.nranks
        dist.all_gather_object(got, obj, group=g.process_group)
    object_list.clear()
    object_list.extend(got)


def _block(g, n, what):
    if n % g.nranks:
        raise ValueError(f"{what}: axis 0 of {n} does not split over "
                         f"{g.nranks} ranks")
    return n // g.nranks


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    if isinstance(tensor_or_tensor_list, (list, tuple)):
        src = torch.cat([_data(t).detach() for t in tensor_or_tensor_list])
    else:
        src = _data(tensor_or_tensor_list).detach()
    if _local(g):
        out = src.clone()
    else:
        buf = _staged(g, src)
        k = _block(g, buf.shape[0], "reduce_scatter")
        out = buf.new_empty((k,) + tuple(buf.shape[1:]))
        dist.reduce_scatter_tensor(out, buf, op=_torch_op(op),
                                   group=g.process_group)
        if op == ReduceOp.AVG:
            _avg(out, g.nranks)
        out = out.to(src.device)
    if tensor is not None:
        return _give(tensor, out)
    return _wrap(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    if _local(g) or not g.is_member():
        return tensor
    buf = _staged(g, _data(tensor))
    dist.broadcast(buf, src=src, group=g.process_group)
    return _give(tensor, buf)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on ``dst`` (a global rank); the other ranks'
    tensors are left as they were."""
    from torch import distributed as dist

    g = _resolve(group)
    if _local(g) or not g.is_member():
        return tensor
    buf = _staged(g, _data(tensor))
    dist.reduce(buf, dst=dst, op=_torch_op(op), group=g.process_group)
    if _global_rank() != dst:
        return tensor
    if op == ReduceOp.AVG:
        _avg(buf, g.nranks)
    return _give(tensor, buf)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group takes ``tensor_list[i]`` of ``src`` (a global
    rank)."""
    from torch import distributed as dist

    g = _resolve(group)
    if _local(g):
        if tensor_list:
            _give(tensor, _data(tensor_list[g.rank]).detach())
        return tensor
    if not g.is_member():
        return tensor
    buf = _staged(g, _data(tensor))
    parts = None
    if _global_rank() == src:
        parts = [_staged(g, _data(t)) for t in tensor_list]
    dist.scatter(buf, parts, src=src, group=g.process_group)
    return _give(tensor, buf)


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    if isinstance(in_tensor_list, (list, tuple)):
        datas = [_data(t).detach() for t in in_tensor_list]
        if _local(g):
            outs = [d.clone() for d in datas]
        else:
            bufs = [_staged(g, d) for d in datas]
            got = [torch.empty_like(b) for b in bufs]
            dist.all_to_all(got, bufs, group=g.process_group)
            outs = [o.to(d.device) for o, d in zip(got, datas)]
        outs = [_wrap(o) for o in outs]
        if out_tensor_list is not None:
            out_tensor_list.clear()
            out_tensor_list.extend(outs)
        return outs
    data = _data(in_tensor_list).detach()
    if _local(g):
        return in_tensor_list
    _block(g, data.shape[0], "alltoall")
    buf = _staged(g, data)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g.process_group)
    out = out.to(data.device)
    return _wrap(out) if isinstance(in_tensor_list, Tensor) else out


all_to_all = alltoall


def _peer(g, what):
    if _local(g):
        raise RuntimeError(f"{what} needs a peer: this job has one rank")


def send(tensor, dst=0, group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    _peer(g, "send")
    dist.send(_staged(g, _data(tensor)), dst=dst, group=g.process_group)


def recv(tensor, src=0, group=None, sync_op=True):
    from torch import distributed as dist

    g = _resolve(group)
    _peer(g, "recv")
    buf = _staged(g, _data(tensor))
    dist.recv(buf, src=src, group=g.process_group)
    return _give(tensor, buf)


def p2p_permute(tensor, perm, group=None):
    """``lax.ppermute``: ``perm`` is a list of (src, dst) group ranks;
    each rank's result is the tensor of the rank that sends to it, or
    zeros (reference send_v2/recv_v2 as a collective permute)."""
    from torch import distributed as dist

    g = _resolve(group)
    data = _data(tensor).detach()
    me = 0 if _local(g) else g.rank
    bad = [pair for pair in perm
           if not all(0 <= int(r) < g.nranks for r in pair)]
    if bad:
        raise ValueError(f"pairs {bad} are outside the group of "
                         f"{g.nranks}")
    out = torch.zeros_like(data)
    ops, recv_buf = [], None
    for s, d in perm:
        if s == me and d == me:
            out = data.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, _staged(g, data),
                                  g.ranks[d], group=g.process_group))
        elif d == me:
            recv_buf = torch.empty_like(_staged(g, data))
            ops.append(dist.P2POp(dist.irecv, recv_buf, g.ranks[s],
                                  group=g.process_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv_buf is not None:
        out = recv_buf.to(data.device)
    return _wrap(out) if isinstance(tensor, Tensor) else out


def barrier(group=None):
    from torch import distributed as dist

    g = _resolve(group)
    if not _local(g) and g.is_member():
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Every call above is synchronous on the host; on a card, wait for
    the device's queued work on the tensor's device."""
    data = _data(tensor)
    if isinstance(data, torch.Tensor) and data.is_cuda:
        torch.cuda.synchronize(data.device)
