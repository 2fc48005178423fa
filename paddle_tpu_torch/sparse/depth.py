"""Sparse kernel depth (port of ``paddle_tpu/sparse/depth.py``):
batch_norm, addmm, mv, softmax, fused attention.

Reference kernel surface: paddle/phi/kernels/sparse/{batch_norm_kernel.h,
addmm_kernel.h, mv_kernel.h, softmax_kernel.h, pool_kernel.h,
fused_attention_kernel.h} and the python API at
python/paddle/sparse/nn/functional/.

As in the JAX module, every kernel is a gather and segment reductions
over the static nonzero structure: the coordinates are host numpy (moved
to the device once a call), the VALUES are differentiable Tensor inputs
routed through ``apply_op``, so autograd records the chain.  The JAX
``segment_sum`` / ``segment_max`` become ``index_add`` /
``scatter_reduce(amax)`` into zeros / ``-inf``.
"""

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..ops.dispatch import apply_op


def _tensor(x):
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return _wrap(x)
    return _wrap(torch.as_tensor(np.asarray(x), device=current_device()))


def _vals_tensor(sp):
    """The autograd-connected values Tensor of a SparseTensor."""
    t = getattr(sp, "_values_t", None)
    return t if t is not None else _wrap(sp._vals)


def _rebuild(sp, vals_t, fmt=None):
    """Same sparsity structure, new values (keeps the autograd chain)."""
    from . import SparseTensor

    out = SparseTensor(sp._idx, vals_t._data, sp._shape, fmt or sp._fmt)
    out._values_t = vals_t
    return out


def _segment_sum(v, seg, n):
    """``jax.ops.segment_sum(v, seg, n)``: rows of ``v`` summed into ``n``
    segments."""
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add(0, seg, v)


def _segment_max(v, seg, n):
    """``jax.ops.segment_max(v, seg, n)``: -inf where a segment is
    empty."""
    out = torch.full((n,) + tuple(v.shape[1:]), -torch.inf, dtype=v.dtype,
                     device=v.device)
    idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    return out.scatter_reduce(0, idx, v, reduce="amax", include_self=True)


def _spmm(v, idx, shape, bd):
    """A 2-D COO matrix (values ``v``, device coordinates ``idx``
    ``[nnz, 2]``) times dense ``bd``: each nonzero scales the row of
    ``bd`` its column picks, summed into its row."""
    rows, cols = idx[:, 0], idx[:, 1]
    contrib = v.reshape((-1,) + (1,) * (bd.dim() - 1)) * bd[cols]
    return _segment_sum(contrib, rows, shape[0])


def _row_segments(sp):
    """Linear row ids (all dims but the last) for each nonzero."""
    idx = sp._idx                               # [nnz, nd]
    dims = sp.shape
    nd = idx.shape[1]
    rows = np.zeros(len(idx), np.int64)
    stride = 1
    for d in range(nd - 2, -1, -1):
        rows += idx[:, d] * stride
        stride *= dims[d]
    n_rows = int(np.prod(dims[:-1])) if nd > 1 else 1
    return rows, n_rows


def softmax(x, axis=-1, name=None):
    """Row-wise softmax over the nonzeros (sparse softmax_kernel.h).

    Matches the reference restriction: only the last axis (CSR is
    row-major; phi supports axis=-1 on CPU for COO too)."""
    nd = len(x.shape)
    if axis not in (-1, nd - 1):
        raise ValueError(
            f"sparse softmax supports only the last axis, got {axis} "
            "(reference sparse softmax_kernel restriction)")
    vals = _vals_tensor(x)
    if vals._data.dim() != 1:
        raise ValueError("sparse softmax expects scalar per-entry values")
    rows, n_rows = _row_segments(x)
    rows_t = torch.as_tensor(rows, device=vals._data.device)

    def fn(v):
        m = _segment_max(v, rows_t, n_rows)
        e = torch.exp(v - torch.where(torch.isfinite(m), m, 0.0)[rows_t])
        s = _segment_sum(e, rows_t, n_rows)
        return e / torch.clamp(s, min=torch.finfo(e.dtype).tiny)[rows_t]

    out = apply_op("sparse_softmax", fn, (vals,), {})
    return _rebuild(x, out)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """out = beta*input + alpha*(x @ y) — DENSE + COO/CSR @ DENSE -> DENSE
    (sparse addmm_kernel.h AddmmCooDenseKernel/AddmmCsrDenseKernel)."""
    if len(x.shape) != 2:
        raise ValueError("sparse addmm expects a 2-D sparse x")
    idx, shape = x._idx_t(), x._shape
    vals = _vals_tensor(x)

    def fn(inp, xv, yd):
        return beta * inp + alpha * _spmm(xv, idx, shape, yd)

    return apply_op("sparse_addmm", fn, (_tensor(input), vals, _tensor(y)),
                    {})


def mv(x, vec, name=None):
    """COO/CSR @ dense vector -> dense vector (sparse mv_kernel.h)."""
    if len(x.shape) != 2:
        raise ValueError("sparse mv expects a 2-D sparse x")
    idx, shape = x._idx_t(), x._shape
    vals = _vals_tensor(x)

    def fn(xv, vd):
        return _spmm(xv, idx, shape, vd)

    return apply_op("sparse_mv", fn, (vals, _tensor(vec)), {})


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """softmax(QK^T/sqrt(d)) @ V evaluated ONLY at sparse_mask's nonzeros
    (sparse fused_attention_kernel.h; python
    paddle/sparse/nn/functional/transformer.py attention).

    query/key/value: [B, H, L, D]; sparse_mask: SparseTensor with shape
    [B*H, L, L] (its values are layout-only, as in the reference);
    key_padding_mask [B, L] and attn_mask [L, L] exclude positions where
    the mask value is 0 (fused_attention_kernel.cu AttnSoftmaxGpuKernel).
    """
    q, k, v = _tensor(query), _tensor(key), _tensor(value)
    B, H, L, D = q._data.shape
    if list(sparse_mask.shape) != [B * H, L, L]:
        raise ValueError(
            f"sparse_mask dense shape must be [batch*heads, seq, seq] = "
            f"[{B * H}, {L}, {L}], got {sparse_mask.shape}")
    dev = q._data.device
    idx = sparse_mask._idx                          # [nnz, 3]
    b_t = torch.as_tensor(idx[:, 0], device=dev)
    row_t = torch.as_tensor(idx[:, 1], device=dev)
    col_t = torch.as_tensor(idx[:, 2], device=dev)
    seg_t = torch.as_tensor(idx[:, 0] * L + idx[:, 1], device=dev)
    n_seg = B * H * L
    scale = 1.0 / float(np.sqrt(D))

    args = [q, k, v]
    has_kp = key_padding_mask is not None
    has_am = attn_mask is not None
    if has_kp:
        args.append(_tensor(key_padding_mask))
    if has_am:
        args.append(_tensor(attn_mask))

    def fn(qd, kd, vd, *masks):
        mi = iter(masks)
        kp = next(mi) if has_kp else None
        am = next(mi) if has_am else None
        qf = qd.reshape(B * H, L, D)
        kf = kd.reshape(B * H, L, D)
        vf = vd.reshape(B * H, L, D)
        s = (qf[b_t, row_t] * kf[b_t, col_t]).sum(-1) * scale   # [nnz]
        if kp is not None:
            s = torch.where(kp[b_t // H, col_t] == 0, -torch.inf, s)
        if am is not None:
            s = torch.where(am[row_t, col_t] == 0, -torch.inf, s)
        m = _segment_max(s, seg_t, n_seg)
        e = torch.where(torch.isfinite(s),
                        torch.exp(s - torch.where(torch.isfinite(m), m,
                                                  0.0)[seg_t]),
                        0.0)
        denom = _segment_sum(e, seg_t, n_seg)
        p = e / torch.clamp(denom, min=torch.finfo(e.dtype).tiny)[seg_t]
        out = _segment_sum(p[:, None] * vf[b_t, col_t], seg_t, n_seg)
        return out.reshape(B, H, L, D)

    return apply_op("sparse_fused_attention", fn, tuple(args), {})


def max_pool3d(x, kernel_size, stride=None, padding=0, name=None):
    """Functional sparse max pool (sparse pool_kernel.h MaxPoolCoo)."""
    from .conv import MaxPool3D

    return MaxPool3D(kernel_size, stride=stride, padding=padding)(x)
