"""Graph message-passing ops (the ``paddle.geometric`` kernels).

Port of ``paddle_tpu/ops/graph_ops.py``: every reduction is a segment
reduction (``scatter_reduce`` over the destination index), an empty
max/min segment giving 0 as in the reference; the sampling and reindex
ops have data-dependent output shapes and are host ops (numpy), as
there.
"""
# noqa-module: H001 (sampling/reindex are host ops by design: their
# output shapes are data-dependent; see the module docstring)

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..framework.random import generator
from .dispatch import apply_op
from .registry import op, register_external

_REDUCE = {"sum": "sum", "add": "sum", "max": "amax", "min": "amin"}


def _segment_reduce(msg, dst, num_segments, reduce_op):
    reduce_op = reduce_op.lower()
    idx = dst.long().reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
    shape = (num_segments,) + tuple(msg.shape[1:])
    if reduce_op == "mean":
        s = torch.zeros(shape, dtype=msg.dtype, device=msg.device)
        s = s.scatter_add(0, idx, msg)
        cnt = torch.zeros((num_segments,), dtype=msg.dtype,
                          device=msg.device).index_add(
            0, dst.long(), torch.ones((msg.shape[0],), dtype=msg.dtype,
                                      device=msg.device))
        return s / torch.clamp(cnt.reshape((-1,) + (1,) * (msg.dim() - 1)),
                               min=1)
    red = _REDUCE[reduce_op]
    init = {"sum": 0.0, "amax": float("-inf"), "amin": float("inf")}[red]
    out = torch.full(shape, init, dtype=msg.dtype, device=msg.device)
    out = out.scatter_reduce(0, idx, msg, reduce=red, include_self=True)
    if red != "sum":
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out


@op()
def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None):
    n = int(out_size) if out_size else x.shape[0]
    return _segment_reduce(x[src_index.long()], dst_index, n, reduce_op)


def _combine(xe, ye, message_op):
    message_op = message_op.lower()
    if message_op == "add":
        return xe + ye
    if message_op == "sub":
        return xe - ye
    if message_op == "mul":
        return xe * ye
    if message_op == "div":
        return xe / ye
    raise ValueError(f"unknown message_op {message_op}")


@op()
def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None):
    """x node features, y edge features; message = x[src] (op) y."""
    n = int(out_size) if out_size else x.shape[0]
    msg = _combine(x[src_index.long()], y, message_op)
    return _segment_reduce(msg, dst_index, n, reduce_op)


@op()
def send_uv(x, y, src_index, dst_index, message_op="add"):
    """Per-edge message from both endpoint features (no reduce)."""
    return _combine(x[src_index.long()], y[dst_index.long()], message_op)


def _segment_pool_pure(x, seg, num=0, pool="sum"):
    return _segment_reduce(x, seg, num, pool)


def segment_pool(x, segment_ids, pooltype="SUM"):
    """Segment reduction with the reference's [max_id+1, ...] output
    shape; the segment count is read on the host, as in the JAX op."""
    seg = segment_ids._data if isinstance(segment_ids, Tensor) \
        else segment_ids
    num = int(seg.max()) + 1 if seg.numel() else 0
    return apply_op("segment_pool", _segment_pool_pure, (x, segment_ids),
                    {"num": num, "pool": pooltype.lower()})


register_external("segment_pool", segment_pool)


# ---- host-side (dynamic-output) graph sampling ops ----

def _host(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).reshape(-1)


def _int64(a):
    return _wrap(torch.as_tensor(np.asarray(a, np.int64),
                                 device=current_device()))


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None):
    """Compact node ids: x = center nodes, neighbors = flat neighbor
    list -> (reindexed src, dst, out_nodes); a host op."""
    x_np, nbr, cnt = _host(x), _host(neighbors), _host(count)
    out_nodes = list(x_np)
    mapping = {int(v): i for i, v in enumerate(x_np)}
    for v in nbr:
        if int(v) not in mapping:
            mapping[int(v)] = len(out_nodes)
            out_nodes.append(int(v))
    src = [mapping[int(v)] for v in nbr]
    dst = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    return _int64(src), _int64(dst), _int64(out_nodes)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, return_eids=False):
    """Weighted neighbor sampling on a CSC graph; a host op, seeded from
    the global generator so that ``paddle.seed`` repeats it."""
    row_np, colptr_np = _host(row), _host(colptr)
    w_np, nodes = _host(edge_weight), _host(input_nodes)
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (),
                             generator=generator(current_device()),
                             device=current_device()))
    rng = np.random.RandomState(seed)
    out_nbr, out_cnt, out_eid = [], [], []
    for v in nodes:
        s, e = int(colptr_np[v]), int(colptr_np[v + 1])
        deg = e - s
        if sample_size < 0 or deg <= sample_size:
            sel = np.arange(s, e)
        else:
            p = w_np[s:e].astype(np.float64)
            p = p / p.sum() if p.sum() > 0 else None
            sel = s + rng.choice(deg, size=sample_size, replace=False, p=p)
        out_nbr.extend(row_np[sel])
        out_eid.extend(sel)
        out_cnt.append(len(sel))
    outs = (_int64(out_nbr), _int64(out_cnt))
    if return_eids:
        return outs + (_int64(out_eid),)
    return outs


register_external("reindex_graph", reindex_graph)
register_external("weighted_sample_neighbors", weighted_sample_neighbors)
