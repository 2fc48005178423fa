"""Sparse 3D convolution / pooling (port of ``paddle_tpu/sparse/conv.py``;
reference paddle/phi/kernels/sparse/ conv_kernel + pool kernels;
python/paddle/sparse/nn/layer/conv.py).

The JAX algorithm, never a dense fallback: for each kernel offset a
gather/scatter "rulebook" matches input coordinates to output
coordinates (the reference's rulebook scheme for point clouds), built on
the host with numpy; then, on the device, the conv gathers the input
rows, runs one small matmul an offset and segment-sums (``index_add_``)
into the outputs, and the pool takes a segment max
(``scatter_reduce(amax)``).  The JAX module builds the rulebook with
Python dictionaries over every site; the port builds the same one (the
same output coordinates in the same order, the same (input row, output
row) pairs an offset in the same order, the last of duplicate input
sites winning) with sorted keys and ``searchsorted``, so a KITTI-sized
voxel set takes milliseconds, not seconds.  The work is O(nnz * K^3),
not O(D^3).

Coordinate layout: indices [N, 4] = (batch, z, y, x) int64, values
[N, C]; matches ``paddle.sparse.sparse_coo_tensor`` for conv inputs.
"""

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..nn.initializer import Normal
from ..nn.layer_base import Layer
from ..ops.dispatch import apply_op


def _as_tuple3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _out_extent(spatial, kernel_size, stride, padding):
    return tuple((d + 2 * p - k) // s + 1
                 for d, k, s, p in zip(spatial, kernel_size, stride,
                                       padding))


def _keys(coords, lo, span):
    return np.ravel_multi_index(tuple((coords - lo).T), span)


def _lookup(table, rows, query):
    """For each query coordinate, ``rows``' entry of the table row with
    the same coordinates, or -1 (the table's coordinates are unique)."""
    if not len(table) or not len(query):
        return np.full(len(query), -1, np.int64)
    both = np.concatenate([table, query])
    lo = both.min(0)
    span = tuple(both.max(0) - lo + 1)
    kt, kq = _keys(table, lo, span), _keys(query, lo, span)
    order = np.argsort(kt, kind="stable")
    ks = kt[order]
    pos = np.minimum(np.searchsorted(ks, kq), len(ks) - 1)
    return np.where(ks[pos] == kq, rows[order][pos], -1)


def _dict_rows(coords):
    """The rows of ``{tuple(c): i for i, c in enumerate(coords)}`` in its
    iteration order: one a distinct coordinate, in order of first
    appearance, each the coordinate's last row."""
    if not len(coords):
        return np.zeros(0, np.int64)
    lo = coords.min(0)
    k = _keys(coords, lo, tuple(coords.max(0) - lo + 1))
    _, first = np.unique(k, return_index=True)
    _, last_rev = np.unique(k[::-1], return_index=True)
    last = len(k) - 1 - last_rev
    return last[np.argsort(first, kind="stable")]


def _rulebook(coords, kernel_size, stride, padding, submanifold, spatial):
    """Host-side neighbor maps.

    ``spatial``: input dense extent (D, H, W) — bounds the output grid
    exactly like a dense conv3d would.  Returns (out_coords [M,4], pairs:
    list per offset of (in_rows, out_rows) int64 arrays).
    """
    coords = np.asarray(coords, np.int64).reshape(-1, 4)
    kd, kh, kw = kernel_size
    sd, sh, sw = stride
    pd, ph, pw = padding
    offsets = [(dz, dy, dx) for dz in range(kd) for dy in range(kh)
               for dx in range(kw)]
    in_rows_iter = _dict_rows(coords)
    steps = np.asarray([sd, sh, sw])

    if submanifold:
        out_coords = coords
    else:
        # full conv: every input site contributes to all covered output
        # sites; output site set = union over offsets of shifted sites,
        # clipped to the dense output extent, sorted
        ext = np.asarray(_out_extent(spatial, kernel_size, stride,
                                     padding))
        outs = []
        for dz, dy, dx in offsets:
            o = coords[:, 1:] + np.asarray([pd - dz, ph - dy, pw - dx])
            ok = (o % steps == 0).all(1)
            o = o // steps
            ok &= ((o >= 0) & (o < ext)).all(1)
            outs.append(np.concatenate([coords[ok, :1], o[ok]], 1))
        out_coords = np.unique(np.concatenate(outs), axis=0) \
            .reshape(-1, 4)

    pairs = []
    center = np.asarray([kd // 2, kh // 2, kw // 2])
    if submanifold:
        out_rows_iter = _dict_rows(out_coords)
        oc = out_coords[out_rows_iter]
        table = coords[in_rows_iter]
        for off in offsets:
            shift = np.concatenate([[0], np.asarray(off) - center])
            irow = _lookup(table, in_rows_iter, oc + shift)
            hit = irow >= 0
            pairs.append((irow[hit], out_rows_iter[hit]))
    else:
        ic = coords[in_rows_iter]
        out_rows = np.arange(len(out_coords))
        for dz, dy, dx in offsets:
            o = ic[:, 1:] + np.asarray([pd - dz, ph - dy, pw - dx])
            ok = (o % steps == 0).all(1)
            q = np.concatenate([ic[:, :1], o // steps], 1)
            orow = np.where(ok, _lookup(out_coords, out_rows, q), -1)
            hit = orow >= 0
            pairs.append((in_rows_iter[hit], orow[hit]))
    return out_coords, pairs


def _on_device(pairs, dev):
    """The non-empty offsets' (offset, in_rows, out_rows) as device
    tensors, from one host-to-device copy."""
    live = [(k, i, o) for k, (i, o) in enumerate(pairs) if len(i)]
    if not live:
        return []
    flat = torch.as_tensor(np.concatenate(
        [np.concatenate([i, o]) for _, i, o in live]), device=dev)
    out, at = [], 0
    for k, i, o in live:
        n = len(i)
        out.append((k, flat[at:at + n], flat[at + n:at + 2 * n]))
        at += 2 * n
    return out


def _as_values(values):
    if isinstance(values, Tensor):
        return values
    if isinstance(values, torch.Tensor):
        return _wrap(values)
    return _wrap(torch.as_tensor(np.asarray(values),
                                 device=current_device()))


def sparse_conv3d(indices, values, weight, kernel_size, stride=1,
                  padding=0, submanifold=False, spatial=None):
    """values [N, Cin]; weight [kd*kh*kw, Cin, Cout]; spatial (D, H, W).

    Returns (out_indices [M, 4], out_values [M, Cout]).
    """
    ks = _as_tuple3(kernel_size)
    vt, wt = _as_values(values), _as_values(weight)
    coords = np.asarray(indices, np.int64).reshape(-1, 4)
    if len(coords) == 0:  # empty input -> empty output
        return (np.zeros((0, 4), np.int64),
                _wrap(torch.zeros((0, wt._data.shape[-1]),
                                  dtype=vt._data.dtype,
                                  device=vt._data.device)))
    if spatial is None:
        spatial = tuple(int(coords[:, i].max()) + 1 for i in (1, 2, 3))
    out_coords, pairs = _rulebook(coords, ks, _as_tuple3(stride),
                                  _as_tuple3(padding), submanifold, spatial)
    m = len(out_coords)
    pairs_t = _on_device(pairs, vt._data.device)

    # gather -> one matmul an offset -> segment-sum, a differentiable
    # function of (values, weight) with the rulebook closed over
    def pure(vals_d, w_d):
        out = torch.zeros((m, w_d.shape[-1]), dtype=vals_d.dtype,
                          device=vals_d.device)
        for k, ir, orw in pairs_t:
            out.index_add_(0, orw, vals_d[ir] @ w_d[k])
        return out

    return out_coords, apply_op("sparse_conv3d", pure, (vt, wt), {})


class SubmConv3D(Layer):
    """Submanifold sparse 3D conv (reference sparse.nn.SubmConv3D):
    output sites == input sites, so sparsity never dilates."""

    SUBM = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias_attr=None):
        super().__init__()
        self.kernel_size = _as_tuple3(kernel_size)
        self.stride = _as_tuple3(stride)
        self.padding = _as_tuple3(padding)
        if self.SUBM and self.stride != (1, 1, 1):
            raise ValueError(
                "SubmConv3D is stride-1 by construction (output sites == "
                "input sites); use Conv3D for strided sparse conv")
        k = int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            (k, in_channels, out_channels),
            default_initializer=Normal(0.0, 0.1))
        self.bias = None
        if bias_attr is not False:
            from ..nn.initializer import Constant
            self.bias = self.create_parameter(
                (out_channels,), default_initializer=Constant(0.0))

    def forward(self, x):
        from . import SparseTensor, sparse_coo_tensor

        spatial = None
        if isinstance(x, SparseTensor):
            idx = x._idx                                # [N, 4]
            vals = x.values()
            shp = list(x.shape)
            if len(shp) == 5:                           # (B, D, H, W, C)
                spatial = tuple(shp[1:4])
        else:
            idx, vals = x
            idx = np.asarray(idx, np.int64)
        out_coords, out_vals = sparse_conv3d(
            idx, vals, self.weight, self.kernel_size, self.stride,
            self.padding, submanifold=self.SUBM, spatial=spatial)
        if self.bias is not None:
            out_vals = out_vals + self.bias    # Tensor add: autograd
        if spatial is not None:
            out_sp = spatial if self.SUBM else _out_extent(
                spatial, self.kernel_size, self.stride, self.padding)
            batch = int(idx[:, 0].max()) + 1 if len(idx) else 1
            shape = (batch, *out_sp, out_vals.shape[-1])
            return sparse_coo_tensor(out_coords.T, out_vals, shape=shape)
        return sparse_coo_tensor(out_coords.T, out_vals)


class Conv3D(SubmConv3D):
    """Full sparse 3D conv (reference sparse.nn.Conv3D): sparsity dilates
    by the kernel support."""

    SUBM = False


def _pool_rulebook(idx, ks, st, pad, ext):
    """(rows, output cells, each pair's output row): each site joins
    every window that covers it — for dim value c, cells o with
    o*s - p <= c <= o*s - p + k - 1 (overlap aware, so stride < kernel
    works) — site-major, then z, y, x, as the JAX loops append them; the
    cells sorted and unique, as the JAX ``np.unique`` leaves them."""
    c = idx[:, 1:]
    k, s, p, e = (np.asarray(v) for v in (ks, st, pad, ext))
    lo = np.maximum(0, -(-(c + p - k + 1) // s))   # ceil div
    hi = np.minimum(e - 1, (c + p) // s)
    span = int(max(1, (hi - lo + 1).max()))
    a = np.arange(span)
    oz = lo[:, 0, None, None, None] + a[None, :, None, None]
    oy = lo[:, 1, None, None, None] + a[None, None, :, None]
    ox = lo[:, 2, None, None, None] + a[None, None, None, :]
    shape = (len(idx), span, span, span)
    ok = ((oz <= hi[:, 0, None, None, None])
          & (oy <= hi[:, 1, None, None, None])
          & (ox <= hi[:, 2, None, None, None]))
    rows = np.broadcast_to(np.arange(len(idx))[:, None, None, None],
                           shape)[ok]
    cells = np.stack([np.broadcast_to(idx[:, 0, None, None, None],
                                      shape)[ok],
                      np.broadcast_to(oz, shape)[ok],
                      np.broadcast_to(oy, shape)[ok],
                      np.broadcast_to(ox, shape)[ok]], 1)
    uniq, inv = np.unique(cells, axis=0, return_inverse=True)
    return rows, uniq, inv.reshape(-1)


class MaxPool3D(Layer):
    """Sparse max pool (reference sparse.nn.MaxPool3D): sites bucket into
    output cells by floor-division; per-cell segment max."""

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = _as_tuple3(kernel_size)
        self.stride = _as_tuple3(stride) if stride is not None \
            else self.kernel_size
        self.padding = _as_tuple3(padding)

    def forward(self, x):
        from . import SparseTensor, sparse_coo_tensor
        from .depth import _segment_max

        spatial = None
        if isinstance(x, SparseTensor):
            idx = x._idx
            vt = x.values()            # autograd-connected Tensor
            shp = list(x.shape)
            if len(shp) == 5:
                spatial = tuple(shp[1:4])
        else:
            idx, vals_in = x
            vt = _as_values(vals_in)
        vals = vt._data
        idx = np.asarray(idx, np.int64).reshape(-1, 4)
        if len(idx) == 0:  # empty input -> empty output, shape preserved
            out_sp = (_out_extent(spatial, self.kernel_size, self.stride,
                                  self.padding)
                      if spatial is not None else (1, 1, 1))
            batch = shp[0] if spatial is not None else 1
            return sparse_coo_tensor(
                np.zeros((4, 0), np.int64),
                _wrap(torch.zeros((0, vals.shape[-1]), dtype=vals.dtype,
                                  device=vals.device)),
                shape=(batch, *out_sp, vals.shape[-1]))
        if spatial is None:
            spatial = tuple(int(idx[:, i].max()) + 1 for i in (1, 2, 3))
        ks, st, pad = self.kernel_size, self.stride, self.padding
        ext = _out_extent(spatial, ks, st, pad)
        rows, uniq, inv = _pool_rulebook(idx, ks, st, pad, ext)
        inv_t = torch.as_tensor(inv, device=vals.device)
        rows_t = torch.as_tensor(rows, device=vals.device)
        n_out = len(uniq)

        # segment max as a differentiable function of the values: the
        # gradient reaches the winning sites
        pooled = apply_op("sparse_max_pool3d",
                          lambda v: _segment_max(v[rows_t], inv_t, n_out),
                          (vt,), {})
        batch = int(idx[:, 0].max()) + 1 if len(idx) else 1
        return sparse_coo_tensor(uniq.T, pooled,
                                 shape=(batch, *ext, vals.shape[-1]))
