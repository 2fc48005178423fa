"""paddle.sparse (port of ``paddle_tpu/sparse/__init__.py``; reference
python/paddle/sparse/ over the COO/CSR kernels at
paddle/phi/kernels/sparse/).

The JAX package wraps ``jax.experimental.sparse.BCOO``; the port keeps
the same triple itself: ``SparseTensor`` holds the coordinates as a host
int64 array ``[nnz, sparse_ndim]`` (the BCOO layout; ``indices()``
gives the reference's ``[sparse_ndim, nnz]``), the values as a torch
tensor ``[nnz, *dense_tail]`` on the device, and the dense shape.
Every operation keeps the JAX semantics: the structure (coordinates,
their order, ``coalesce``'s sorted unique output, the union structure of
the binaries, ``sum`` / ``transpose`` / ``reshape`` / ``slice``'s
coordinate arithmetic) is computed on the host with numpy, and the
values move through the op dispatcher as differentiable torch functions
of the input values (gathers, ``index_add`` segment sums, a product a
nonzero), so autograd reaches them as the JAX tape does.  Nothing is
densified but ``to_dense`` and the JAX package's own dense steps
(``masked_matmul``'s product, a dense-by-sparse ``matmul``).
"""

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..framework.dtype import convert_dtype
from ..ops.dispatch import apply_op


class _AllReduceSum(torch.autograd.Function):
    """``t`` summed over ``group``; the backward sums the gradients over
    the group the same way."""

    @staticmethod
    def forward(ctx, t, group):
        from ..distributed.fleet.meta_parallel import mp_layers

        ctx.group = group
        return mp_layers.all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed.fleet.meta_parallel import mp_layers

        return mp_layers.all_reduce(g, ctx.group), None


class SparseTensor:
    """COO sparse tensor handle (``paddle.sparse.sparse_coo_tensor``
    result): host coordinates ``[nnz, sparse_ndim]``, device values,
    dense shape; ``_values_t``, when set, is the autograd-connected
    values Tensor (see ``sparse/depth.py``)."""

    def __init__(self, indices, values, shape, fmt="coo"):
        self._idx = np.asarray(indices, np.int64)   # [nnz, sparse_ndim]
        self._vals = values
        self._shape = tuple(int(s) for s in shape)
        self._fmt = fmt
        self._values_t = None

    # -------- reference accessors --------
    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._vals.dtype

    @property
    def nnz(self):
        return len(self._idx)

    def _device(self):
        return self._vals.device

    def _idx_t(self):
        """The coordinates on the values' device, ``[nnz, sparse_ndim]``."""
        return torch.as_tensor(self._idx, device=self._device())

    def indices(self):
        return _wrap(self._idx_t().T)

    def values(self):
        if self._values_t is not None:
            return self._values_t
        return _wrap(self._vals)

    def to_dense(self):
        dense = torch.zeros(self._shape, dtype=self._vals.dtype,
                            device=self._device())
        idx = self._idx_t()
        cols = tuple(idx[:, i] for i in range(idx.shape[1]))
        return _wrap(dense.index_put(cols, self._vals.detach(),
                                     accumulate=True))

    def is_sparse_coo(self):
        return self._fmt == "coo"

    def is_sparse_csr(self):
        return self._fmt == "csr"

    def coalesce(self):
        from .depth import _segment_sum, _vals_tensor

        dims = self._shape[:self._idx.shape[1]]
        lin = np.ravel_multi_index(tuple(self._idx.T), dims)
        uniq, inv = np.unique(lin, return_inverse=True)
        out_idx = np.stack(np.unravel_index(uniq, dims), 1)
        inv_t = torch.as_tensor(inv.reshape(-1), device=self._device())
        n_out = len(uniq)
        vals = apply_op("sparse_coalesce",
                        lambda v: _segment_sum(v, inv_t, n_out),
                        (_vals_tensor(self),), {})
        out = SparseTensor(out_idx, vals._data, self._shape, self._fmt)
        out._values_t = vals
        return out

    # -------- csr view --------
    def crows(self):
        from ..ops.sparse_ops import csr_crows

        if self._idx.shape[1] == 3:   # batched CSR: concatenated pointers
            out = csr_crows(self._idx[:, 1], self._shape[1],
                            batch=self._idx[:, 0], nbatch=self._shape[0])
        else:
            out = csr_crows(self._idx[:, 0], self._shape[0])
        return _wrap(torch.as_tensor(out, device=self._device()))

    def cols(self):
        return _wrap(torch.as_tensor(self._idx[:, -1],
                                     device=self._device()))

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz}, "
                f"format={self._fmt})")


def _host(x):
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _data(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=current_device())


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True):
    idx = _host(indices).astype(np.int64)
    val = _data(values)
    if dtype is not None:
        val = val.to(convert_dtype(dtype))
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.max(axis=1))
        shape = shape + tuple(val.shape[1:])
    out = SparseTensor(idx.T, val.detach(), tuple(shape), "coo")
    if isinstance(values, Tensor) and not values.stop_gradient:
        vt = values
        if vt._data.dtype != val.dtype:
            # cast through the op layer so the autograd thread and the
            # payload agree in dtype
            from ..ops.registry import OPS
            vt = OPS["cast"].user_fn(vt, val.dtype)
        out._values_t = vt
    return out


def sparse_csr_tensor(crows, cols, values, shape, dtype=None):
    """2-D CSR, or 3-D batched CSR with crows = concatenated per-batch
    row pointers, shape [batch * (nrows + 1)] (phi sparse_csr_tensor.h)."""
    crows_np = _host(crows)
    cols_np = _host(cols)
    if len(shape) == 3:
        nb, nr = int(shape[0]), int(shape[1])
        if crows_np.size != nb * (nr + 1):
            raise ValueError(
                f"batched CSR needs crows of size batch*(nrows+1) = "
                f"{nb * (nr + 1)}, got {crows_np.size}")
        per = crows_np.reshape(nb, nr + 1)
        counts = np.diff(per, axis=1)                     # [B, nr]
        rows = np.tile(np.arange(nr), nb)
        batch = np.repeat(np.arange(nb), nr)
        rows = np.repeat(rows, counts.reshape(-1))
        batch = np.repeat(batch, counts.reshape(-1))
        indices = np.stack([batch, rows, cols_np])
    else:
        rows = np.repeat(np.arange(len(crows_np) - 1), np.diff(crows_np))
        indices = np.stack([rows, cols_np])
    t = sparse_coo_tensor(indices, values, shape, dtype=dtype)
    t._fmt = "csr"
    return t


def _unary(name, fn):
    def impl(x):
        if isinstance(x, SparseTensor):
            from .depth import _rebuild, _vals_tensor

            out = apply_op(f"sparse_{name}", fn, (_vals_tensor(x),), {})
            return _rebuild(x, out)
        if isinstance(x, Tensor):
            return apply_op(f"sparse_{name}", fn, (x,), {})
        return _wrap(fn(_data(x)))
    impl.__name__ = name
    return impl


relu = _unary("relu", lambda v: torch.clamp(v, min=0))
sin = _unary("sin", torch.sin)
tanh = _unary("tanh", torch.tanh)
abs = _unary("abs", torch.abs)  # noqa: A001  (reference name)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
neg = _unary("neg", torch.neg)
expm1 = _unary("expm1", torch.expm1)
log1p = _unary("log1p", torch.log1p)
asin = _unary("asin", torch.asin)
asinh = _unary("asinh", torch.asinh)
atan = _unary("atan", torch.atan)
atanh = _unary("atanh", torch.atanh)
sinh = _unary("sinh", torch.sinh)
tan = _unary("tan", torch.tan)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
isnan = _unary("isnan", torch.isnan)


def cast(x, dtype):
    d = convert_dtype(dtype)
    return _unary("cast", lambda v: v.to(d))(x)


def pow(x, factor, name=None):  # noqa: A001  (reference name)
    return _unary("pow", lambda v: torch.pow(v, factor))(x)


def coalesce(x, name=None):
    return x.coalesce()


def _as_tensor(x):
    return x if isinstance(x, Tensor) else _wrap(_data(x))


def matmul(a, b):
    """sparse @ dense, dense @ sparse or dense @ dense (reference
    sparse.matmul).  A sparse left operand is a gather of the dense
    rows its columns pick, a product a nonzero and a segment sum into
    its rows (BCOO's ``@``); a sparse right operand is densified first,
    as the JAX body does (``ops/sparse_ops.to_dense``)."""
    from ..ops.sparse_ops import to_dense
    from .depth import _spmm, _vals_tensor

    if isinstance(a, SparseTensor):
        idx, shape = a._idx_t(), a._shape

        def fn(v, bd):
            return _spmm(v, idx, shape, bd)

        return apply_op("sparse_matmul", fn,
                        (_vals_tensor(a), _as_tensor(b)), {})
    if isinstance(b, SparseTensor):
        idx, shape = b._idx_t(), b._shape

        def fn(ad, v):
            return ad @ to_dense(idx.T, v, shape)

        return apply_op("sparse_matmul", fn,
                        (_as_tensor(a), _vals_tensor(b)), {})
    return apply_op("sparse_matmul", lambda x, y: x @ y,
                    (_as_tensor(a), _as_tensor(b)), {})


def masked_matmul(a, b, mask):
    """dense@dense evaluated only at mask's nonzeros (reference
    sparse.masked_matmul): the JAX body's full product, gathered."""
    from .depth import _rebuild

    idx = mask._idx_t()

    def fn(ad, bd):
        return (ad @ bd)[idx[:, 0], idx[:, 1]]

    vals = apply_op("sparse_masked_matmul", fn,
                    (_as_tensor(a), _as_tensor(b)), {})
    return _rebuild(mask, vals, fmt="coo")


def _union_binary(name, fn):
    """Elementwise sparse∘sparse on the UNION structure (reference phi
    sparse elementwise kernels operate over the merged coordinate set;
    implicit-zero positions on both sides stay unrepresented)."""

    def impl(a, b):
        if not (isinstance(a, SparseTensor) and isinstance(b,
                                                           SparseTensor)):
            raise TypeError(f"sparse.{name} expects two sparse tensors")
        if a._shape != b._shape:
            raise ValueError(
                f"sparse.{name}: shapes differ "
                f"({a.shape} vs {b.shape}) — linearizing b's indices "
                "with a's dims would corrupt the union structure")
        from .depth import _vals_tensor

        ia, ib = a._idx, b._idx
        dims = a._shape[:ia.shape[1]]
        lin_a = np.ravel_multi_index(tuple(ia.T), dims)
        lin_b = np.ravel_multi_index(tuple(ib.T), dims)
        uniq = np.unique(np.concatenate([lin_a, lin_b]))
        dev = a._device()
        pos_a = torch.as_tensor(np.searchsorted(uniq, lin_a), device=dev)
        pos_b = torch.as_tensor(np.searchsorted(uniq, lin_b), device=dev)
        out_idx = np.stack(np.unravel_index(uniq, dims), 1)
        n_out = len(uniq)

        def pure(va, vb):
            ea = torch.zeros((n_out,) + tuple(va.shape[1:]), dtype=va.dtype,
                             device=va.device).index_add(0, pos_a, va)
            eb = torch.zeros((n_out,) + tuple(vb.shape[1:]), dtype=vb.dtype,
                             device=vb.device).index_add(0, pos_b, vb)
            return fn(ea, eb)

        vals = apply_op(f"sparse_{name}", pure,
                        (_vals_tensor(a), _vals_tensor(b)), {})
        out = SparseTensor(out_idx, vals._data, a._shape, a._fmt)
        out._values_t = vals
        return out

    impl.__name__ = name
    return impl


add = _union_binary("add", torch.add)
subtract = _union_binary("subtract", torch.subtract)
multiply = _union_binary("multiply", torch.multiply)
divide = _union_binary("divide", torch.divide)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """reference paddle.sparse.sum: axis=None -> dense scalar; an axis
    reduces to a sparse tensor over the remaining coordinates."""
    from .depth import _segment_sum, _vals_tensor

    vt = _vals_tensor(x)
    if axis is None:
        out = apply_op("sparse_sum", lambda v: torch.sum(v), (vt,), {})
        return out if dtype is None else out.cast(dtype)
    nd = len(x.shape)
    axis = axis % nd
    idx = x._idx
    n_sparse = idx.shape[1]
    if axis >= n_sparse:
        # dense-tail axis: reduce inside the values, structure unchanged
        vax = axis - n_sparse + 1
        out_v = apply_op(
            "sparse_sum",
            lambda v: torch.sum(v, dim=vax, keepdim=keepdim), (vt,), {})
        if dtype is not None:
            out_v = out_v.cast(dtype)
        new_shape = tuple(
            (1 if i == axis else d) for i, d in enumerate(x._shape)
            if keepdim or i != axis)
        out = SparseTensor(idx, out_v._data, new_shape, "coo")
        out._values_t = out_v
        return out
    keep_cols = [i for i in range(n_sparse) if i != axis]
    rem = idx[:, keep_cols]
    dims = [x.shape[i] for i in keep_cols]
    lin = np.ravel_multi_index(tuple(rem.T), dims) if keep_cols else \
        np.zeros(len(idx), np.int64)
    uniq, inv = np.unique(lin, return_inverse=True)
    inv_t = torch.as_tensor(inv.reshape(-1), device=x._device())
    n_out = len(uniq)

    vals = apply_op("sparse_sum", lambda v: _segment_sum(v, inv_t, n_out),
                    (vt,), {})
    if dtype is not None:
        vals = vals.cast(dtype)
    dense_tail = tuple(x._shape[n_sparse:])
    out_rem = np.stack(np.unravel_index(uniq, dims), 1) if keep_cols \
        else np.zeros((n_out, 0), np.int64)
    if keepdim:
        out_idx = np.insert(out_rem, axis, 0, axis=1)
        shape = tuple(1 if i == axis else d
                      for i, d in enumerate(x._shape[:n_sparse])
                      ) + dense_tail
    else:
        out_idx = out_rem
        shape = tuple(dims) + dense_tail
    out = SparseTensor(out_idx, vals._data, shape, "coo")
    out._values_t = vals
    return out


def transpose(x, perm, name=None):
    """Permute sparse dims: indices reorder, values untouched."""
    from .depth import _vals_tensor

    idx = x._idx
    if len(perm) != idx.shape[1]:
        raise ValueError(
            f"sparse.transpose perm must cover the {idx.shape[1]} "
            "sparse dims")
    new_idx = idx[:, list(perm)]
    new_shape = tuple(x._shape[p] for p in perm) \
        + tuple(x._shape[idx.shape[1]:])
    vals = _vals_tensor(x)
    out = SparseTensor(new_idx, vals._data, new_shape, x._fmt)
    out._values_t = vals if not vals.stop_gradient else None
    return out


def reshape(x, shape, name=None):
    """Relinearize coordinates into the new shape (same nnz/values)."""
    from .depth import _vals_tensor

    idx = x._idx
    nd = idx.shape[1]
    old_dims = x._shape[:nd]
    total = int(np.prod(old_dims))
    shape = [int(s) for s in shape]
    neg = [i for i, s in enumerate(shape) if s == -1]
    if neg:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[neg[0]] = total // known
    if int(np.prod(shape)) != total:
        raise ValueError(f"cannot reshape {old_dims} into {shape}")
    lin = np.ravel_multi_index(tuple(idx.T), old_dims)
    new_idx = np.stack(np.unravel_index(lin, shape), 1)
    vals = _vals_tensor(x)
    out = SparseTensor(new_idx, vals._data,
                       tuple(shape) + tuple(x._shape[nd:]), "coo")
    out._values_t = vals if not vals.stop_gradient else None
    return out


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    """Keep nonzeros inside the window; coordinates shift to the new
    origin (reference sparse slice kernel semantics)."""
    from .depth import _vals_tensor

    idx = x._idx
    nd = idx.shape[1]
    shape = list(x._shape[:nd])
    lo = [0] * nd
    hi = list(shape)
    full_nd = len(x.shape)
    for a, st, e in zip(axes, starts, ends):
        a = a % full_nd
        if a >= nd:
            raise NotImplementedError(
                "sparse.slice over a dense-tail dim is not supported "
                f"(axis {a}, {nd} sparse dims)")
        st = st + shape[a] if st < 0 else st
        e = e + shape[a] if e < 0 else e
        lo[a] = builtins.min(builtins.max(0, int(st)), shape[a])
        hi[a] = builtins.max(builtins.min(shape[a], int(e)), lo[a])
    mask = np.ones(len(idx), bool)
    for a in range(nd):
        mask &= (idx[:, a] >= lo[a]) & (idx[:, a] < hi[a])
    sel = np.nonzero(mask)[0]
    new_idx = idx[sel] - np.asarray(lo, np.int64)[None, :]
    sel_t = torch.as_tensor(sel, device=x._device())
    vals = apply_op("sparse_slice", lambda v: v[sel_t],
                    (_vals_tensor(x),), {})
    new_shape = tuple(h - lo_ for lo_, h in zip(lo, hi)) \
        + tuple(x._shape[nd:])
    out = SparseTensor(new_idx, vals._data, new_shape, "coo")
    out._values_t = vals
    return out


def is_same_shape(a, b):
    return list(a.shape) == list(b.shape)


class nn:
    """paddle.sparse.nn: activation/norm + sparse 3D conv/pool layers."""

    class ReLU:
        def __call__(self, x):
            return relu(x)

    class Softmax:
        def __init__(self, axis=-1):
            self.axis = axis

        def __call__(self, x):
            from .depth import softmax as _sm

            return _sm(x, axis=self.axis)


def _install_depth():
    # conv.py / depth.py import back from this module; bind after defs
    from ..nn.norm import _BatchNormBase
    from .conv import Conv3D, MaxPool3D, SubmConv3D, sparse_conv3d
    from .depth import addmm, attention, max_pool3d, mv, softmax

    class BatchNorm(_BatchNormBase):
        """Sparse batch norm (sparse batch_norm_kernel.cc): the dense BN
        runs over x.values() [nnz, C] — stats over the NONZERO sites per
        channel, channels last (NDHWC) — and the sparsity is untouched."""

        def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                     weight_attr=None, bias_attr=None,
                     data_format="NDHWC", use_global_stats=None,
                     name=None):
            if data_format != "NDHWC":
                raise ValueError(
                    "sparse BatchNorm only supports NDHWC (channels-last "
                    "values layout, as in the reference)")
            super().__init__(num_features, momentum=momentum,
                             epsilon=epsilon, weight_attr=weight_attr,
                             bias_attr=bias_attr, data_format="NHWC",
                             use_global_stats=use_global_stats, name=name)

        def forward(self, x):
            from .depth import _rebuild, _vals_tensor

            out_vals = super().forward(_vals_tensor(x))
            return _rebuild(x, out_vals)

    class SyncBatchNorm(BatchNorm):
        """Sparse sync BN (sparse sync_batch_norm_kernel.h): in training,
        with a world of more than one rank, the batch
        statistics are the world's: each rank's per-channel sum, sum of
        squares and count over its nonzero sites all-reduced before
        normalising (an all-reduce whose backward all-reduces the
        gradients, so they are the gradients of the ranks' summed
        losses); on one rank it equals BatchNorm."""

        def _group(self):
            from ..distributed.group import _ensure_default_group

            g = _ensure_default_group()
            return g if g.process_group is not None and g.nranks > 1 \
                else None

        def forward(self, x):
            from .depth import _rebuild, _vals_tensor

            group = self._group()
            if group is None or not self.training or self.use_global_stats:
                return super().forward(x)
            v = _vals_tensor(x)._data
            c = v.shape[1]
            local = torch.cat([v.sum(0), (v * v).sum(0),
                               v.new_full((1,), float(v.shape[0]))])
            stats = _AllReduceSum.apply(local, group)
            n = stats[2 * c]
            mean = stats[:c] / n
            var = stats[c:2 * c] / n - mean * mean
            out = (v - mean) * torch.rsqrt(var + self.epsilon)
            if self.weight is not None:
                out = out * self.weight._data
            if self.bias is not None:
                out = out + self.bias._data
            m = self.momentum
            with torch.no_grad():
                self._mean.set_value(m * self._mean._data +
                                     (1 - m) * mean.detach())
                self._variance.set_value(m * self._variance._data +
                                         (1 - m) * var.detach())
            return _rebuild(x, _wrap(out))

    nn.Conv3D = Conv3D
    nn.SubmConv3D = SubmConv3D
    nn.MaxPool3D = MaxPool3D
    nn.BatchNorm = BatchNorm
    nn.SyncBatchNorm = SyncBatchNorm

    class functional:
        pass

    functional.relu = relu
    functional.softmax = softmax
    functional.attention = attention
    functional.max_pool3d = max_pool3d
    nn.functional = functional

    g = globals()
    g["sparse_conv3d"] = sparse_conv3d
    g["softmax"] = softmax
    g["addmm"] = addmm
    g["mv"] = mv

    # Tensor.to_sparse_coo()/to_sparse_csr() return SparseTensor (the
    # reference Tensor-method surface); the values come from a
    # differentiable gather so dense->sparse keeps the autograd chain.
    def _sparse_from_idx(dense_t, idx_cols, shape, fmt):
        dev = dense_t._data.device
        gather = tuple(torch.as_tensor(c, device=dev) for c in idx_cols)
        vals = apply_op("to_sparse_" + fmt, lambda d: d[gather],
                        (dense_t,), {})
        out = SparseTensor(np.stack(idx_cols, 1), vals._data, shape, fmt)
        if not dense_t.stop_gradient:
            out._values_t = vals
        return out

    def _to_sparse_coo(self, sparse_dim=None):
        arr = np.asarray(self.numpy())
        sd = sparse_dim or arr.ndim
        flat_tail = arr.reshape(arr.shape[:sd] + (-1,))
        mask = (flat_tail != 0).any(-1).reshape(arr.shape[:sd])
        idx = np.nonzero(mask)
        return _sparse_from_idx(self, idx, arr.shape, "coo")

    def _to_sparse_csr(self):
        arr = np.asarray(self.numpy())
        if arr.ndim not in (2, 3):
            raise ValueError("to_sparse_csr expects a 2-D or 3-D tensor")
        idx = np.nonzero(arr)
        return _sparse_from_idx(self, idx, arr.shape, "csr")

    Tensor.to_sparse_coo = _to_sparse_coo
    Tensor.to_sparse_csr = _to_sparse_csr


_install_depth()
