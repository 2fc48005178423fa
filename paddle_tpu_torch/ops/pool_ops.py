"""Generic pooling ops (phi ``pool2d``/``pool3d``/``max_pool*_with_index``/
``unpool``).

Port of ``paddle_tpu/ops/pool_ops.py``, where each is an XLA
``reduce_window``.  Here a window reduction is the input padded
(``-inf`` for max, zeros for sums) and unfolded into its windows, then
reduced: the JAX package's windows, pads and divisors exactly, whatever
``torch.nn.functional``'s pooling would count at a padded border.
``ceil_mode`` pads the high side as the JAX body does; adaptive bins
are ``[floor(i·in/out), ceil((i+1)·in/out))``.
"""

import contextlib
import contextvars
import itertools

import torch

from .registry import op


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _normalize_pads(paddings, nd):
    """Per-spatial-dim (lo, hi) pairs from any accepted spelling: int,
    [p_d...], [(lo, hi)...], or the reference's FLAT per-side form
    [lo0, hi0, lo1, hi1, ...] (pool2d attr [pt, pb, pl, pr])."""
    pads = _tup(paddings, nd)
    if len(pads) == 2 * nd and all(isinstance(p, int) for p in pads):
        return tuple((int(pads[2 * i]), int(pads[2 * i + 1]))  # noqa: H001 (padding attrs)
                     for i in range(nd))
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in pads)


def windows(x, dims, ksize, strides, pads, fill):
    """``x`` padded by ``pads`` ((lo, hi) per dim in ``dims``, ``fill``
    in the border) and unfolded: the result has one trailing axis a
    pooled dim, each of its window's length, in ``dims`` order."""
    flat = []
    for d in reversed(range(x.dim())):
        lo, hi = pads[dims.index(d)] if d in dims else (0, 0)
        flat += [lo, hi]
    if any(flat):
        x = torch.nn.functional.pad(x, flat, value=fill)
    for d, k, s in zip(dims, ksize, strides):
        x = x.unfold(d, k, s)
    return x


# set only inside the program exporter's trace, in that trace's context
_ROUTE = contextvars.ContextVar("window_reduce_route", default=None)


@contextlib.contextmanager
def routed_windows(fn):
    """In this context only, ``window_reduce`` returns ``fn`` of its
    arguments (the program exporter keeps each window reduction as one
    op of its trace)."""
    token = _ROUTE.set(fn)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def window_reduce(x, dims, ksize, strides, pads, kind):
    """``lax.reduce_window`` with ``max`` (init ``-inf``, or the integer
    minimum) or ``add`` (init 0) over the spatial ``dims``."""
    route = _ROUTE.get()
    if route is not None:
        return route(x, dims, ksize, strides, pads, kind)
    return window_reduce_plain(x, dims, ksize, strides, pads, kind)


def window_reduce_plain(x, dims, ksize, strides, pads, kind):
    """:func:`window_reduce`'s computation, never routed."""
    nd = len(dims)
    if kind == "max":
        fill = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
    else:
        fill = 0.0
    w = windows(x, dims, ksize, strides, pads, fill)
    if kind == "max":
        return first_max(w, nd)
    return w.sum(dim=tuple(range(w.dim() - nd, w.dim())))


def first_max(w, nd):
    """The max over the last ``nd`` axes of ``w``, taken at the first
    maximal element in row-major window order: a tied maximum's whole
    gradient goes there, as ``reduce_window``'s VJP sends it (and as
    ``return_mask`` indexes it), where ``amax`` would split it."""
    flat = w.reshape(*w.shape[:w.dim() - nd], -1)
    arg = flat.detach().argmax(dim=-1, keepdim=True)
    return torch.gather(flat, -1, arg)[..., 0]


def adaptive_bins(isz, osz):
    """The JAX package's adaptive bins: ``[floor(i·isz/osz),
    ceil((i+1)·isz/osz))``, never empty."""
    return [((i * isz) // osz, max(((i + 1) * isz + osz - 1) // osz,
                                   (i * isz) // osz + 1))
            for i in range(osz)]


def _pool_nd(x, ksize, strides, paddings, pooling_type, exclusive,
             adaptive, ceil_mode, data_format, nd):
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")
    spatial = (list(range(1, nd + 1)) if channel_last
               else list(range(2, nd + 2)))
    if adaptive:
        out = x
        for ax, osz in zip(spatial, _tup(ksize, nd)):
            segs = []
            for s, e in adaptive_bins(out.shape[ax], osz):
                seg = out.narrow(ax, s, e - s)
                segs.append(seg.amax(dim=ax, keepdim=True)
                            if pooling_type == "max"
                            else seg.mean(dim=ax, keepdim=True))
            out = torch.cat(segs, dim=ax)
        return out
    ksize = _tup(ksize, nd)
    strides = _tup(strides, nd)
    pads = _normalize_pads(paddings, nd)
    if ceil_mode:
        new_pads = []
        for i, ax in enumerate(spatial):
            p_lo, p_hi = pads[i]
            span = x.shape[ax] + p_lo + p_hi - ksize[i]
            extra = (-span) % strides[i] if span % strides[i] else 0
            new_pads.append((p_lo, p_hi + extra))
        pads = tuple(new_pads)
    if pooling_type == "max":
        return window_reduce(x, spatial, ksize, strides, pads, "max")
    xs = window_reduce(x.float(), spatial, ksize, strides, pads, "add")
    if exclusive:
        cnt = window_reduce(torch.ones_like(x, dtype=torch.float32), spatial,
                            ksize, strides, pads, "add")
        return (xs / cnt.clamp(min=1.0)).to(x.dtype)
    denom = 1.0
    for k in ksize:
        denom *= k
    return (xs / denom).to(x.dtype)


@op()
def pool2d(x, kernel_size, strides=1, paddings=0, ceil_mode=False,
           exclusive=True, data_format="NCHW", pooling_type="max",
           global_pooling=False, adaptive=False, padding_algorithm="EXPLICIT"):
    if global_pooling:
        spatial = (1, 2) if data_format == "NHWC" else (2, 3)
        return (x.amax(dim=spatial, keepdim=True) if pooling_type == "max"
                else x.mean(dim=spatial, keepdim=True))
    return _pool_nd(x, kernel_size, strides, paddings, pooling_type,
                    exclusive, adaptive, ceil_mode, data_format, 2)


@op()
def pool3d(x, kernel_size, strides=1, paddings=0, ceil_mode=False,
           exclusive=True, data_format="NCDHW", pooling_type="max",
           global_pooling=False, adaptive=False, padding_algorithm="EXPLICIT"):
    if global_pooling:
        spatial = (1, 2, 3) if data_format == "NDHWC" else (2, 3, 4)
        return (x.amax(dim=spatial, keepdim=True) if pooling_type == "max"
                else x.mean(dim=spatial, keepdim=True))
    return _pool_nd(x, kernel_size, strides, paddings, pooling_type,
                    exclusive, adaptive, ceil_mode, data_format, 3)


def _max_pool_with_index(x, ksize, strides, paddings, nd, adaptive):
    """(max, flat spatial index of the first max) over each window;
    padded cells never win."""
    if adaptive:
        return _adaptive_max_with_index(x, _tup(ksize, nd), nd)
    ksize = _tup(ksize, nd)
    strides = _tup(strides, nd)
    pads = _normalize_pads(paddings, nd)
    spatial = list(range(2, nd + 2))
    vals = window_reduce(x.float(), spatial, ksize, strides, pads, "max")
    flat = 1
    for s in x.shape[2:]:
        flat *= s
    idx = torch.arange(flat, device=x.device, dtype=torch.int32).reshape(
        x.shape[2:]).expand(x.shape)
    wv = windows(x.detach().float(), spatial, ksize, strides, pads,
                 float("-inf"))
    wi = windows(idx, spatial, ksize, strides, pads, flat)
    lead = wv.shape[:wv.dim() - nd]
    arg = wv.reshape(*lead, -1).argmax(dim=-1, keepdim=True)
    idxs = torch.gather(wi.reshape(*lead, -1), -1, arg)[..., 0]
    return vals.to(x.dtype), idxs


def _adaptive_max_with_index(x, out_sizes, nd):
    """Per-bin max and flat spatial argmax for adaptive pooling."""
    spatial_shape = x.shape[2:]
    strides = [1] * nd
    for i in range(nd - 2, -1, -1):
        strides[i] = strides[i + 1] * spatial_shape[i + 1]
    all_bins = [adaptive_bins(spatial_shape[i], out_sizes[i])
                for i in range(nd)]
    vals = torch.zeros(x.shape[:2] + tuple(out_sizes), dtype=torch.float32,
                       device=x.device)
    idxs = torch.zeros(x.shape[:2] + tuple(out_sizes), dtype=torch.int32,
                       device=x.device)
    for pos in itertools.product(*[range(s) for s in out_sizes]):
        sl = [slice(None), slice(None)]
        offs = 0
        for d, p in enumerate(pos):
            s, e = all_bins[d][p]
            sl.append(slice(s, e))
            offs += s * strides[d]
        seg = x[tuple(sl)].float()
        segf = seg.reshape(seg.shape[:2] + (-1,))
        am = segf.argmax(dim=-1)
        loc_shape = seg.shape[2:]
        loc_strides = [1] * nd
        for i in range(nd - 2, -1, -1):
            loc_strides[i] = loc_strides[i + 1] * loc_shape[i + 1]
        gidx = torch.zeros_like(am)
        rem = am
        for d in range(nd):
            gidx = gidx + (rem // loc_strides[d]) * strides[d]
            rem = rem % loc_strides[d]
        at = (slice(None), slice(None)) + pos
        vals = _set(vals, at, segf.amax(dim=-1))
        idxs = _set(idxs, at, (gidx + offs).to(torch.int32))
    return vals.to(x.dtype), idxs


def _set(t, at, v):
    """``t.at[at].set(v)`` out of place (autograd sees the write)."""
    t = t.clone()
    t[at] = v
    return t


@op()
def max_pool2d_with_index(x, kernel_size, strides=None, paddings=0,
                          global_pooling=False, adaptive=False,
                          ceil_mode=False):
    if strides is None:
        strides = kernel_size
    if global_pooling:
        kernel_size = tuple(x.shape[2:])
        strides = kernel_size
        paddings = 0
    return _max_pool_with_index(x, kernel_size, strides, paddings, 2,
                                adaptive)


@op()
def max_pool3d_with_index(x, kernel_size, strides=None, paddings=0,
                          global_pooling=False, adaptive=False,
                          ceil_mode=False):
    if strides is None:
        strides = kernel_size
    if global_pooling:
        kernel_size = tuple(x.shape[2:])
        strides = kernel_size
        paddings = 0
    return _max_pool_with_index(x, kernel_size, strides, paddings, 3,
                                adaptive)


maxpool = op("maxpool")(lambda x, kernel_size, strides=1, paddings=0:
                        _pool_nd(x, kernel_size, strides, paddings, "max",
                                 True, False, False, "NCHW", 2))


def _unpool(x, indices, out_spatial):
    n, c = x.shape[:2]
    size = 1
    for s in out_spatial:
        size *= s
    out = torch.zeros((n, c, size), dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(out_spatial))


@op()
def unpool(x, indices, kernel_size=2, strides=2, paddings=0,
           output_size=None, data_format="NCHW"):
    """Max-unpooling: scatter values back to argmax positions."""
    h, w = x.shape[2:]
    if output_size is None:
        ks, st, pd = _tup(kernel_size, 2), _tup(strides, 2), _tup(paddings, 2)
        out = ((h - 1) * st[0] - 2 * pd[0] + ks[0],
               (w - 1) * st[1] - 2 * pd[1] + ks[1])
    else:
        out = (int(output_size[-2]), int(output_size[-1]))
    return _unpool(x, indices, out)


@op()
def unpool3d(x, indices, kernel_size=2, strides=2, paddings=0,
             output_size=None, data_format="NCDHW"):
    d, h, w = x.shape[2:]
    if output_size is None:
        ks, st, pd = _tup(kernel_size, 3), _tup(strides, 3), _tup(paddings, 3)
        out = tuple((s - 1) * st[i] - 2 * pd[i] + ks[i]
                    for i, s in enumerate((d, h, w)))
    else:
        out = tuple(int(s) for s in output_size[-3:])
    return _unpool(x, indices, out)
