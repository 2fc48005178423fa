"""Sparse-tensor primitive ops (phi sparse kernel layer).

Port of ``paddle_tpu/ops/sparse_ops.py``: a sparse tensor is an
(indices, values, shape) triple, as there; ``coalesce`` keeps the JAX
op's fixed output length (the input's nnz, padded), and the dense ->
COO/CSR conversions are host ops, since nnz depends on the data.
"""
# noqa-module: H001 (COO/CSR construction walks host index lists by
# design: nnz is data-dependent; see the module docstring)

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from .registry import op, register_external


@op()
def sparse_coo_tensor(values, indices, shape):
    """Build the (indices, values, shape) triple."""
    dev = values.device
    return (torch.as_tensor(indices, device=dev).to(torch.int64), values,
            torch.as_tensor(np.asarray(shape).reshape(-1), dtype=torch.int64,
                            device=dev))


@op()
def coalesce(indices, values, shape=None):
    """Sum duplicate coordinates; sorted output, padded to the input's
    nnz (phi CoalesceKernel; the JAX op's fixed length)."""
    nd, nnz = indices.shape
    if shape is None:
        dims = [int(indices[i].max()) + 1 for i in range(nd)]
    else:
        dims = [int(s) for s in shape[:nd]]
    strides = np.ones(nd, np.int64)
    for i in range(nd - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    st = torch.as_tensor(strides, device=indices.device)
    flat = (indices * st[:, None]).sum(0)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    uniq = torch.cat([uniq, torch.full((nnz - uniq.shape[0],), -1,
                                       dtype=uniq.dtype,
                                       device=uniq.device)])
    summed = torch.zeros((nnz,) + tuple(values.shape[1:]),
                         dtype=values.dtype, device=values.device)
    summed = summed.index_add(0, inv.reshape(-1), values)
    rem = torch.where(uniq >= 0, uniq, torch.zeros_like(uniq))
    new_idx = []
    for i in range(nd):
        new_idx.append(rem // int(strides[i]))
        rem = rem % int(strides[i])
    return torch.stack(new_idx), summed


@op()
def to_dense(indices, values, shape):
    dense = torch.zeros(tuple(int(s) for s in shape)
                        + tuple(values.shape[1:]),
                        dtype=values.dtype, device=values.device)
    return dense.index_put(tuple(indices[i] for i in range(
        indices.shape[0])), values, accumulate=True)


def _host(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _device(x):
    if isinstance(x, Tensor):
        return x._data.device
    return x.device if isinstance(x, torch.Tensor) else current_device()


def _tensor(a, dev):
    return _wrap(torch.as_tensor(np.ascontiguousarray(a), device=dev))


def to_sparse_coo(x, sparse_dim=None):
    """Dense -> COO (a host op: nnz is data-dependent)."""
    arr, dev = _host(x), _device(x)
    sd = sparse_dim or arr.ndim
    flat_tail = arr.reshape(arr.shape[:sd] + (-1,))
    mask = (flat_tail != 0).any(-1).reshape(arr.shape[:sd])
    idx = np.stack(np.nonzero(mask))
    vals = arr[tuple(idx)]
    return (_tensor(idx.astype(np.int64), dev), _tensor(vals, dev),
            tuple(arr.shape))


def csr_crows(rows, nrows, batch=None, nbatch=None):
    """Row pointers in the phi layout: [nrows+1], or for batched CSR the
    per-batch pointers concatenated to [nbatch*(nrows+1)]."""
    if batch is None:
        crows = np.zeros(nrows + 1, np.int64)
        np.add.at(crows, np.asarray(rows) + 1, 1)
        return np.cumsum(crows)
    crows = np.zeros((nbatch, nrows + 1), np.int64)
    np.add.at(crows, (np.asarray(batch), np.asarray(rows) + 1), 1)
    return np.cumsum(crows, axis=1).reshape(-1)


def to_sparse_csr(x):
    """Dense 2-D/3-D -> CSR (a host op); 3-D in the batched layout."""
    arr, dev = _host(x), _device(x)
    if arr.ndim == 2:
        rows, cols = np.nonzero(arr)
        vals = arr[rows, cols]
        crows = csr_crows(rows, arr.shape[0])
    elif arr.ndim == 3:
        b, rows, cols = np.nonzero(arr)
        vals = arr[b, rows, cols]
        crows = csr_crows(rows, arr.shape[1], batch=b, nbatch=arr.shape[0])
    else:
        raise ValueError("to_sparse_csr expects a 2-D or 3-D tensor")
    return (_tensor(crows, dev), _tensor(cols.astype(np.int64), dev),
            _tensor(vals, dev), tuple(arr.shape))


@op()
def values(indices, values, shape=None):
    """``.values()`` of a sparse tensor: the values, passed through."""
    return values


register_external("to_sparse_coo", to_sparse_coo)
register_external("to_sparse_csr", to_sparse_csr)
