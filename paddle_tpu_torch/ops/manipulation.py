"""Shape/layout/indexing manipulation ops (paddle.tensor.manipulation
parity).

Port of ``paddle_tpu/ops/manipulation.py``.  Index operands become
int64, torch's index width.  Where torch's own call would order ties
or pick among equals differently from the jnp composition, the body
keeps the composition: ``sort``/``argsort`` sort ascending and flip for
``descending``, ``kthvalue`` reads a stable sort, ``mode`` takes the
smallest most frequent value and its first index.  Out-of-range indices
raise here where jnp clamps them.
"""

import builtins

import torch

from .registry import op


def _axes(axis):
    return list(axis) if isinstance(axis, (list, tuple)) else [axis]


@op()
def reshape(x, shape):
    return x.reshape(tuple(int(s) for s in shape))

@op()
def transpose(x, perm):
    return x.permute(*perm)

@op()
def t(x):
    return x.permute(*range(x.dim() - 1, -1, -1))

@op()
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)

@op()
def concat(x, axis=0):
    return torch.cat(list(x), dim=int(axis))

@op()
def stack(x, axis=0):
    return torch.stack(list(x), dim=axis)

@op()
def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=axis))

unbind = unstack

@op()
def split(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        return tuple(torch.split(x, x.shape[axis] // num_or_sections,
                                 dim=axis))
    sections = list(num_or_sections)
    # paddle allows one -1 section meaning "the rest"
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, sections, dim=axis))

@op()
def chunk(x, chunks, axis=0):
    return tuple(torch.tensor_split(x, chunks, dim=axis))

@op()
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    dims = tuple(a for a in _axes(axis) if x.shape[a] == 1)
    return torch.squeeze(x, dims) if dims else x

@op()
def unsqueeze(x, axis):
    nd = x.dim() + len(_axes(axis))
    for a in sorted(a % nd for a in _axes(axis)):
        x = x.unsqueeze(a)
    return x

@op()
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % nd, stop_axis % nd)

@op()
def flip(x, axis):
    return torch.flip(x, _axes(axis))

@op()
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))

@op()
def roll(x, shifts, axis=None):
    return torch.roll(x, shifts, dims=axis)

@op()
def tile(x, repeat_times):
    return torch.tile(x, tuple(repeat_times))

@op()
def expand(x, shape):
    shape = list(shape)
    # paddle: -1 keeps the original dim
    offset = len(shape) - x.dim()
    for i in range(len(shape)):
        if shape[i] == -1:
            shape[i] = x.shape[i - offset]
    return x.expand(*shape)

@op()
def expand_as(x, y):
    return x.expand(*y.shape)

@op()
def broadcast_to(x, shape):
    return x.expand(*shape)

@op()
def broadcast_tensors(inputs):
    return tuple(torch.broadcast_tensors(*inputs))

@op()
def gather(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())

@op()
def gather_nd(x, index):
    return x[tuple(index.long().movedim(-1, 0))]

@op()
def scatter(x, index, updates, overwrite=True):
    """Row scatter (paddle.scatter: index over dim 0)."""
    idx = (index.reshape(-1).long(),)
    if overwrite:
        return x.index_put(idx, updates)
    # paddle accumulate mode: zero out the target rows, then add
    zeroed = x.index_put(idx, torch.zeros_like(updates))
    return zeroed.index_put(idx, updates, accumulate=True)

@op()
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)), updates,
                       accumulate=True)

@op()
def scatter_nd(index, updates, shape):
    zeros = torch.zeros(tuple(shape), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(tuple(index.long().movedim(-1, 0)), updates,
                           accumulate=True)

@op()
def index_select(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())

@op()
def index_add(x, index, axis, value):
    return torch.index_add(x, axis, index.reshape(-1).long(), value)

@op()
def index_put(x, indices, value, accumulate=False):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    return x.index_put(idx, value, accumulate=accumulate)

@op()
def index_sample(x, index):
    return torch.gather(x, 1, index.long())

@op()
def take_along_axis(arr, indices, axis, broadcast=True):
    indices = indices.long()
    if broadcast:
        shape = list(arr.shape)
        shape[axis] = indices.shape[axis]
        indices = indices.expand(*shape)
    return torch.gather(arr, axis, indices)

@op()
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    indices = indices.long()
    if isinstance(values, torch.Tensor) and values.dim():
        values = values.expand(*indices.shape)
    else:
        values = torch.full(indices.shape, float(values), dtype=arr.dtype,  # noqa: H001 (a scalar value)
                            device=arr.device)
    if reduce == "assign":
        return arr.scatter(axis, indices, values)
    if reduce == "add":
        return arr.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce {reduce!r}")

@op()
def masked_select(x, mask):
    return torch.masked_select(x, mask.bool())

@op()
def masked_fill(x, mask, value):
    value = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask.bool(), value, x)

@op()
def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition.bool(), x, y)

@op()
def select_scatter(x, values, axis, index):
    return torch.select_scatter(x, values, axis, index)

@op()
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    out, inverse, counts = torch.unique(x, sorted=True, return_inverse=True,
                                        return_counts=True, dim=axis)
    res = [out]
    if return_index:
        # the first occurrence of each unique value
        flat = inverse.reshape(-1)
        pos = torch.arange(flat.numel(), device=x.device)
        first = torch.full((out.shape[0 if axis is None else axis],),
                           flat.numel(), dtype=torch.int64, device=x.device)
        res.append(first.scatter_reduce(0, flat, pos, "amin"))
    if return_inverse:
        res.append(inverse)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)

@op()
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    res = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    return tuple(res) if isinstance(res, tuple) else res

@op()
def sort(x, axis=-1, descending=False, stable=False):
    out = torch.sort(x, dim=axis, stable=stable).values
    return torch.flip(out, [axis]) if descending else out

@op()
def argsort(x, axis=-1, descending=False, stable=False):
    out = torch.sort(x, dim=axis, stable=stable).indices
    return torch.flip(out, [axis]) if descending else out

@op()
def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx

@op()
def kthvalue(x, k, axis=-1, keepdim=False):
    vals, idxs = torch.sort(x, dim=axis, stable=True)
    v = vals.select(axis, k - 1)
    i = idxs.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i

@op("mode")
def mode_(x, axis=-1, keepdim=False):
    moved = torch.movedim(x, axis, -1)
    srt = torch.sort(moved, dim=-1).values
    counts = (srt[..., :, None] == srt[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)     # the first of the most frequent
    mode_vals = torch.gather(srt, -1, best[..., None])[..., 0]
    first_idx = torch.argmax((moved == mode_vals[..., None]).int(), dim=-1)
    if keepdim:
        mode_vals = mode_vals.unsqueeze(axis)
        first_idx = first_idx.unsqueeze(axis)
    return mode_vals, first_idx

@op()
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return torch.argmax(x, dim=axis,
                        keepdim=keepdim if axis is not None else False)

@op()
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return torch.argmin(x, dim=axis,
                        keepdim=keepdim if axis is not None else False)

@op()
def nonzero(x, as_tuple=False):
    res = torch.nonzero(x)
    if as_tuple:
        return tuple(res[:, i:i + 1] for i in range(res.shape[1]))
    return res

@op()
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)

@op()
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, right=right,
                           out_int32=out_int32)

@op()
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)

@op()
def slice(x, axes, starts, ends):
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(st), int(en))  # noqa: H001 (int attrs by contract)
    return x[tuple(idx)]

@op()
def strided_slice(x, axes, starts, ends, strides):
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(int(st), int(en), int(sd))  # noqa: H001 (int attrs by contract)
    return x[tuple(idx)]

@op()
def crop(x, shape, offsets=None):
    if offsets is None:
        offsets = [0] * x.dim()
    return x[tuple(builtins.slice(int(o), int(o) + int(s))  # noqa: H001 (int attrs by contract)
                   for o, s in zip(offsets, shape))]

@op()
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])

@op()
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)

@op()
def view_as(x, other):
    return x.reshape(other.shape)

@op()
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)

@op()
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y, offset, axis1, axis2)

@op()
def fill_diagonal(x, value, offset=0, wrap=False):
    n = builtins.min(x.shape[-2], x.shape[-1])
    r = torch.arange(n - abs(offset) if offset else n, device=x.device)
    rows = r - offset if offset < 0 else r
    cols = r + offset if offset > 0 else r
    mask = torch.zeros(x.shape[-2:], dtype=torch.bool, device=x.device)
    mask[rows, cols] = True
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)

@op()
def tensordot(x, y, axes=2):
    return torch.tensordot(x, y, dims=axes)

@op()
def atleast_1d(x):
    return torch.atleast_1d(x)

@op()
def atleast_2d(x):
    return torch.atleast_2d(x)

@op()
def atleast_3d(x):
    return torch.atleast_3d(x)
