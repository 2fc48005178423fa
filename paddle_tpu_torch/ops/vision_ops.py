"""Vision ops: interpolation, sampling, ROI pooling, detection
post-processing.

Port of ``paddle_tpu/ops/vision_ops.py``.  Each op is the JAX body's
gathers and elementwise math on torch tensors, over the batch at once
where the JAX body ``vmap``s.  The detection post-processing keeps the
JAX outputs' fixed shapes: ``nms`` returns the whole score order with
the kept boxes first and a kept count, from a greedy loop of n steps
(each a few small device ops, never a host read);
``multiclass_nms3``, ``matrix_nms`` and ``generate_proposals`` return
padded outputs with counts.  Rounding follows the JAX body: C's
half-away-from-zero where it says so (``_cround``), half-to-even in
``jnp.round``'s places (``torch.round`` is the same).  ``decode_jpeg``
is a host op over Pillow, as there.
"""

import io as _io

import numpy as np
import torch

from ..core.tensor import _wrap
from ..framework.device import current_device
from .math import jclip
from .registry import op, register_external

_tF = torch.nn.functional
_f32 = torch.float32


def _cround(x):
    """C round(): half away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _arange(n, device, dtype=_f32):
    return torch.arange(n, dtype=dtype, device=device)


# ---------------------------------------------------------------- interpolate

def _axis_coords(out_size, in_size, align_corners, device, align_mode=1):
    """Source coordinate of each output index along one axis (f32)."""
    o = _arange(out_size, device)
    if align_corners and out_size > 1:
        return o * ((in_size - 1) / (out_size - 1))
    scale = in_size / out_size
    if align_mode == 1:
        return o * scale
    return torch.clamp((o + 0.5) * scale - 0.5, 0.0, in_size - 1)


def _bshape(x, axis, n):
    shape = [1] * x.dim()
    shape[axis] = n
    return shape


def _interp_linear_axis(x, axis, out_size, align_corners, align_mode=1):
    in_size = x.shape[axis]
    c = _axis_coords(out_size, in_size, align_corners, x.device, align_mode)
    lo = torch.clamp(torch.floor(c).long(), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    w = (c - lo.float()).reshape(_bshape(x, axis, out_size))
    xl = x.index_select(axis, lo).float()
    xh = x.index_select(axis, hi).float()
    return xl * (1 - w) + xh * w


def _cubic_w(t, a=-0.75):
    t = torch.abs(t)
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = (((t - 5) * t + 8) * t - 4) * a
    return torch.where(t <= 1, w1, torch.where(t < 2, w2,
                                               torch.zeros_like(t)))


def _interp_cubic_axis(x, axis, out_size, align_corners):
    in_size = x.shape[axis]
    c = _axis_coords(out_size, in_size, align_corners, x.device, 0)
    base = torch.floor(c).long()
    frac = c - base.float()
    out = 0.0
    for k in range(-1, 3):
        idx = torch.clamp(base + k, 0, in_size - 1)
        w = _cubic_w(frac - k).reshape(_bshape(x, axis, out_size))
        out = out + x.index_select(axis, idx).float() * w
    return out


def _interp_nearest_axis(x, axis, out_size, align_corners):
    in_size = x.shape[axis]
    c = _axis_coords(out_size, in_size, align_corners, x.device, 1)
    idx = (torch.round(c) if align_corners else torch.floor(c)).long()
    return x.index_select(axis, torch.clamp(idx, 0, in_size - 1))


# ---- jax.image.resize (scale-and-translate with its kernels) ----

def _triangle(t):
    return torch.clamp(1 - torch.abs(t), min=0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.
    out = torch.where(t >= 1., ((-0.5 * t + 2.5) * t - 4.) * t + 2., out)
    return torch.where(t >= 2., torch.zeros_like(t), out)


def _weight_mat(in_size, out_size, kernel, antialias, device):
    """``jax.image``'s ``compute_weight_mat`` for scale out/in and no
    translation: [in_size, out_size] f32."""
    inv_scale = 1. / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.) if antialias else 1.
    sample_f = (_arange(out_size, device) + 0.5) * inv_scale - 0.5
    t = torch.abs(sample_f[None, :] - _arange(in_size, device)[:, None]) \
        / kernel_scale
    w = kernel(t)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def image_resize(x, shape, method, antialias=True):
    """``jax.image.resize(x, shape, method)`` for ``nearest``,
    ``linear`` and ``cubic``: each changed dim is a contraction with its
    weight matrix (``nearest`` a gather at ``floor((i + 0.5) * in /
    out)``)."""
    if method == "nearest":
        for d in range(x.dim()):
            m, n = x.shape[d], shape[d]
            if m == n:
                continue
            offs = torch.floor((_arange(n, x.device) + 0.5) * m / n).long()
            x = x.index_select(d, offs)
        return x
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    if not x.is_floating_point():
        x = x.float()
    for d in range(x.dim()):
        m, n = x.shape[d], shape[d]
        if m == n:
            continue
        w = _weight_mat(m, n, kernel, antialias, x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def _spatial_axes(ndim, data_format):
    if data_format.startswith("NC"):
        return list(range(2, ndim))
    return list(range(1, ndim - 1))


def _resolve_sizes(x, axes, size, scale_factor):
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()  # noqa: H001 (output-size attr)
        return [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size] * len(axes))]
    sf = (scale_factor if isinstance(scale_factor, (list, tuple))
          else [scale_factor] * len(axes))
    return [int(x.shape[a] * float(f)) for a, f in zip(axes, sf)]


def _interp_impl(x, mode, size, scale_factor, align_corners, align_mode,
                 data_format):
    axes = _spatial_axes(x.dim(), data_format)
    sizes = _resolve_sizes(x, axes, size, scale_factor)
    out = x
    for a, s in zip(axes, sizes):
        if mode == "nearest":
            out = _interp_nearest_axis(out, a, s, align_corners)
        elif mode in ("linear", "bilinear", "trilinear"):
            out = _interp_linear_axis(out, a, s, align_corners, align_mode)
        elif mode == "bicubic":
            out = _interp_cubic_axis(out, a, s, align_corners)
        elif mode == "area":
            out = image_resize(out, [s if i == a else d for i, d in
                                     enumerate(out.shape)], "linear")
        else:
            raise ValueError(f"unknown interpolate mode {mode}")
    return out.to(x.dtype) if mode == "nearest" else out


def _make_interp(mode):
    def fn(x, out_size=None, size_tensor=None, scale_tensor=None, scale=None,
           data_format="NCHW", align_corners=True, align_mode=1,
           size=None, scale_factor=None):
        size = size if size is not None else out_size
        scale_factor = scale_factor if scale_factor is not None else scale
        return _interp_impl(x, mode.replace("_interp", ""), size,
                            scale_factor, align_corners, align_mode,
                            data_format)
    fn.__name__ = mode
    return fn


linear_interp = op("linear_interp")(_make_interp("linear_interp"))
bilinear_interp = op("bilinear_interp")(_make_interp("bilinear_interp"))
trilinear_interp = op("trilinear_interp")(_make_interp("trilinear_interp"))
nearest_interp = op("nearest_interp")(_make_interp("nearest_interp"))
bicubic_interp = op("bicubic_interp")(_make_interp("bicubic_interp"))


# ------------------------------------------------------- affine / grid sample

def _grid_lin(s, align_corners, device):
    if align_corners:
        return torch.linspace(-1, 1, s, device=device)
    return (torch.arange(s, device=device) * 2 + 1) / s - 1


@op()
def affine_grid(theta, out_shape, align_corners=True):
    """theta [N, 2, 3] (or [N, 3, 4] for 3-d), out_shape (N, C, H, W)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()  # noqa: H001 (shape attr)
    out_shape = [int(s) for s in np.reshape(out_shape, -1)]
    dev = theta.device
    if theta.shape[-2] != 3:
        _, _, h, w = out_shape
        gy, gx = torch.meshgrid(_grid_lin(h, align_corners, dev),
                                _grid_lin(w, align_corners, dev),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
        return torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)
    _, _, d, h, w = out_shape
    gz, gy, gx = torch.meshgrid(_grid_lin(d, align_corners, dev),
                                _grid_lin(h, align_corners, dev),
                                _grid_lin(w, align_corners, dev),
                                indexing="ij")
    base = torch.stack([gx, gy, gz, torch.ones_like(gx)], -1)
    return torch.einsum("dhwk,njk->ndhwj", base.to(theta.dtype), theta)


def _grid_sample_2d(x, grid, mode, padding_mode, align_corners):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()

    def unnorm(g, size):
        if align_corners:
            return (g + 1) * (size - 1) / 2
        return ((g + 1) * size - 1) / 2

    ix, iy = unnorm(gx, w), unnorm(gy, h)
    if padding_mode == "border":
        ix = torch.clamp(ix, 0, w - 1)
        iy = torch.clamp(iy, 0, h - 1)
    elif padding_mode == "reflection":
        def reflect(v, size):
            if align_corners:
                span = 2 * (size - 1)
                v = torch.remainder(torch.abs(v), max(span, 1))
                return torch.where(v > size - 1, span - v, v)
            span = 2 * size
            v = torch.remainder(v + 0.5, span)
            v = torch.where(v < 0, v + span, v)
            v = torch.where(v >= size, span - v, v) - 0.5
            return torch.clamp(v, 0, size - 1)
        ix, iy = reflect(ix, w), reflect(iy, h)
    flat = x.reshape(n, c, h * w)

    def sample(iy_i, ix_i):
        valid = (ix_i >= 0) & (ix_i <= w - 1) & (iy_i >= 0) & (iy_i <= h - 1)
        xi = torch.clamp(ix_i, 0, w - 1).long()
        yi = torch.clamp(iy_i, 0, h - 1).long()
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        g = torch.gather(flat, 2, idx).reshape(n, c, *yi.shape[1:])
        if padding_mode == "zeros":
            g = torch.where(valid[:, None], g, torch.zeros_like(g))
        return g

    if mode == "nearest":
        return sample(torch.round(iy), torch.round(ix)).to(x.dtype)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1, y0 + 1
    wa = ((x1 - ix) * (y1 - iy))[:, None]
    wb = ((x1 - ix) * (iy - y0))[:, None]
    wc = ((ix - x0) * (y1 - iy))[:, None]
    wd = ((ix - x0) * (iy - y0))[:, None]
    va = sample(y0, x0).float()
    vb = sample(y1, x0).float()
    vc = sample(y0, x1).float()
    vd = sample(y1, x1).float()
    return (va * wa + vb * wb + vc * wc + vd * wd).to(x.dtype)


@op()
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    return _grid_sample_2d(x, grid, mode, padding_mode, align_corners)


# ------------------------------------------------------------------ ROI ops

def _batch_idx(boxes, boxes_num):
    r = boxes.shape[0]
    if boxes_num is None:
        return torch.zeros((r,), dtype=torch.long, device=boxes.device)
    cum = torch.cumsum(torch.as_tensor(boxes_num, device=boxes.device)
                       .long(), 0)
    ar = torch.arange(r, device=boxes.device)
    return (ar[:, None] >= cum[None, :]).sum(1)


def _gather_pixels(x, bidx, y, xx):
    """x [N, C, H, W]; bidx [R]; y/xx integer coords [R, P] ->
    [R, C, P]."""
    n, c, h, w = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    flat = (bidx[:, None] * h + y) * w + xx
    return rows[flat.reshape(-1)].reshape(*flat.shape, c).transpose(1, 2)


def _roi_bilinear(x, bidx, y, xx):
    """Bilinear samples of image ``bidx[r]`` at float coords y/xx
    [R, P] -> [R, C, P] (f32)."""
    _, _, h, w = x.shape
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    ly, lx = (y - y0)[:, None], (xx - x0)[:, None]
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    xf = x.float()
    v00 = _gather_pixels(xf, bidx, y0i, x0i)
    v01 = _gather_pixels(xf, bidx, y0i, x1i)
    v10 = _gather_pixels(xf, bidx, y1i, x0i)
    v11 = _gather_pixels(xf, bidx, y1i, x1i)
    return (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
            + v10 * ly * (1 - lx) + v11 * ly * lx)


@op()
def roi_align(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    """x [N,C,H,W]; boxes [R,4] (x1,y1,x2,y2); boxes_num [N] rois per
    image."""
    n, c, h, w = x.shape
    r = boxes.shape[0]
    dev = x.device
    bidx = _batch_idx(boxes, boxes_num)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    bx = boxes.float() * spatial_scale - offset
    x1, y1, x2, y2 = bx.unbind(-1)
    rw = torch.clamp(x2 - x1, min=1e-3 if aligned else 1.0)
    rh = torch.clamp(y2 - y1, min=1e-3 if aligned else 1.0)
    bin_h = (rh / pooled_height)[:, None, None]
    bin_w = (rw / pooled_width)[:, None, None]
    py = _arange(pooled_height, dev)
    px = _arange(pooled_width, dev)
    sy = _arange(sr, dev)
    yy = y1[:, None, None] + (py[:, None] + (sy[None, :] + 0.5) / sr) * bin_h
    xx = x1[:, None, None] + (px[:, None] + (sy[None, :] + 0.5) / sr) * bin_w
    gy = torch.clamp(yy, 0, h - 1).reshape(r, -1)
    gx = torch.clamp(xx, 0, w - 1).reshape(r, -1)
    gyy = gy.repeat_interleave(gx.shape[1], dim=1)
    gxx = gx.repeat(1, gy.shape[1])
    vals = _roi_bilinear(x, bidx, gyy, gxx)
    vals = vals.reshape(r, c, pooled_height, sr, pooled_width, sr)
    return vals.mean(dim=(3, 5)).to(x.dtype)


@op()
def roi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """Max over each bin, the reference's overlapping bins
    ``[floor(i*bin), ceil((i+1)*bin))``; empty bins give 0."""
    n, c, h, w = x.shape
    dev = x.device
    bidx = _batch_idx(boxes, boxes_num)
    bx = _cround(boxes.float() * spatial_scale)
    ph_idx = _arange(pooled_height, dev)
    pw_idx = _arange(pooled_width, dev)
    ys = _arange(h, dev)
    xs = _arange(w, dev)
    outs = []
    for r in range(boxes.shape[0]):
        x1, y1, x2, y2 = bx[r].unbind(-1)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        bin_h, bin_w = rh / pooled_height, rw / pooled_width
        y_start = torch.floor(ph_idx * bin_h)
        y_end = torch.ceil((ph_idx + 1) * bin_h)
        x_start = torch.floor(pw_idx * bin_w)
        x_end = torch.ceil((pw_idx + 1) * bin_w)
        ry = ys[:, None] - y1
        rx = xs[:, None] - x1
        ymask = (ry >= y_start[None]) & (ry < y_end[None]) & (ry >= 0) & \
            (ry < rh)
        xmask = (rx >= x_start[None]) & (rx < x_end[None]) & (rx >= 0) & \
            (rx < rw)
        feat = x[bidx[r]].float()[:, :, :, None, None]
        m = ymask[None, :, None, :, None] & xmask[None, None, :, None, :]
        masked = torch.where(m, feat, torch.full_like(feat, float("-inf")))
        out = masked.amax(dim=(1, 2))
        outs.append(torch.where(torch.isfinite(out), out,
                                torch.zeros_like(out)))
    if not outs:
        return x.new_zeros((0, c, pooled_height, pooled_width))
    return torch.stack(outs).to(x.dtype)


@op()
def psroi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
               output_channels=1, spatial_scale=1.0):
    """Position-sensitive average pooling (reference psroi_pool_kernel.cc:
    rounded raw box coordinates times the scale, integer-pixel bins,
    oc-major channels)."""
    n, c, h, w = x.shape
    dev = x.device
    r = boxes.shape[0]
    bidx = _batch_idx(boxes, boxes_num)
    bx1, by1, bx2, by2 = boxes.float().unbind(-1)
    x1 = _cround(bx1) * spatial_scale
    y1 = _cround(by1) * spatial_scale
    x2 = (_cround(bx2) + 1.0) * spatial_scale
    y2 = (_cround(by2) + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h = (rh / pooled_height)[:, None]
    bin_w = (rw / pooled_width)[:, None]
    feat = x[bidx].float().reshape(r, output_channels, pooled_height,
                                   pooled_width, h, w)
    ph_idx = _arange(pooled_height, dev)[None]
    pw_idx = _arange(pooled_width, dev)[None]
    ys = _arange(h, dev)[None, :, None]
    xs = _arange(w, dev)[None, :, None]
    y_lo = torch.clamp(torch.floor(ph_idx * bin_h + y1[:, None]), 0, h)
    y_hi = torch.clamp(torch.ceil((ph_idx + 1) * bin_h + y1[:, None]), 0, h)
    x_lo = torch.clamp(torch.floor(pw_idx * bin_w + x1[:, None]), 0, w)
    x_hi = torch.clamp(torch.ceil((pw_idx + 1) * bin_w + x1[:, None]), 0, w)
    ymask = ((ys >= y_lo[:, None, :]) & (ys < y_hi[:, None, :])).float()
    xmask = ((xs >= x_lo[:, None, :]) & (xs < x_hi[:, None, :])).float()
    sums = torch.einsum("roPQhw,rhP,rwQ->roPQ", feat, ymask, xmask)
    counts = torch.einsum("rhP,rwQ->rPQ", ymask, xmask)[:, None]
    vals = sums / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, vals, torch.zeros_like(vals)).to(x.dtype)


# -------------------------------------------------------------- NMS family

def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / torch.where(
        union > 0, union, torch.ones_like(union)), torch.zeros_like(union))


def _nms_mask(boxes, scores, iou_threshold):
    """Greedy NMS as the JAX body's fixed-trip loop -> keep mask: n
    device steps in score order, no host read."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = _iou_matrix(boxes)[order][:, order]
    over = iou > iou_threshold
    ar = torch.arange(n, device=boxes.device)
    keep = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep = keep & ~(over[i] & keep[i] & (ar > i))
    inv = torch.empty_like(order)
    inv[order] = ar
    return keep[inv]


@op()
def nms(boxes, iou_threshold=0.3, scores=None):
    if scores is None:
        scores = -_arange(boxes.shape[0], boxes.device)
    scores = scores.float()
    keep = _nms_mask(boxes.float(), scores, iou_threshold)
    # kept indices first (score-ordered), suppressed after; count = #kept
    order = torch.argsort(-torch.where(keep, scores, torch.full_like(
        scores, float("-inf"))), stable=True)
    return order, keep.sum()


def _sort_desc(s):
    """``jnp.argsort(-s)``: ascending order of -s, stable."""
    return torch.argsort(-s, stable=True)


@op()
def matrix_nms(bboxes, scores, score_threshold=0.0, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True):
    """Matrix NMS (SOLOv2): decayed scores, fully parallel.  bboxes
    [N, M, 4], scores [N, C, M] -> (out [N*K, 6], index, rois_num)."""
    n, cnum, m = scores.shape
    k = keep_top_k if keep_top_k > 0 else m
    top = nms_top_k if 0 < nms_top_k < m else m

    def per_image(bb, sc):
        all_s, all_c, all_b = [], [], []
        for ci in range(cnum):
            if ci == background_label:
                continue
            s = sc[ci]
            ord_ = _sort_desc(s)[:top]
            s_s, b_s = s[ord_], bb[ord_]
            iou = torch.triu(_iou_matrix(b_s), diagonal=1)
            max_iou = iou.amax(dim=0)
            upper = torch.triu(torch.ones_like(iou), diagonal=1) > 0
            one = torch.ones_like(iou)
            if use_gaussian:
                decay = torch.exp(-(iou ** 2 - max_iou[:, None] ** 2)
                                  / gaussian_sigma)
            else:
                decay = (1 - iou) / torch.clamp(1 - max_iou[:, None],
                                                min=1e-9)
            decay = torch.where(upper, decay, one).amin(dim=0)
            s_d = s_s * decay
            neg = torch.full_like(s_d, -1.0)
            s_d = torch.where(s_s > score_threshold, s_d, neg)
            s_d = torch.where(s_d > post_threshold, s_d, neg)
            all_s.append(s_d)
            all_c.append(torch.full_like(s_d, ci))
            all_b.append(b_s)
        return _top_rows(all_s, all_c, all_b, k)

    return _per_image_nms(per_image, bboxes, scores, n, k)


def _top_rows(all_s, all_c, all_b, k):
    s_all, c_all = torch.cat(all_s), torch.cat(all_c)
    b_all = torch.cat(all_b, dim=0)
    ord_ = _sort_desc(s_all)[:k]
    s_k, c_k, b_k = s_all[ord_], c_all[ord_], b_all[ord_]
    return (torch.cat([c_k[:, None], s_k[:, None], b_k], dim=1),
            (s_k > 0).sum())


def _per_image_nms(per_image, bboxes, scores, n, k):
    outs, cnts = zip(*[per_image(bb, sc) for bb, sc in
                       zip(bboxes.float(), scores.float())])
    return (torch.stack(outs).reshape(-1, 6),
            torch.zeros((n * k,), dtype=torch.int32, device=bboxes.device),
            torch.stack(cnts).to(torch.int32))


@op()
def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=-1, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=-1):
    """bboxes [N, M, 4], scores [N, C, M] -> padded [N*K, 6] + counts."""
    n, cnum, m = scores.shape
    k = keep_top_k if keep_top_k > 0 else m

    def per_image(bb, sc):
        all_s, all_c, all_b = [], [], []
        for ci in range(cnum):
            if ci == background_label:
                continue
            s = sc[ci]
            keep = _nms_mask(bb, s, nms_threshold)
            s = torch.where(keep & (s >= score_threshold), s,
                            torch.full_like(s, -1.0))
            all_s.append(s)
            all_c.append(torch.full_like(s, ci))
            all_b.append(bb)
        return _top_rows(all_s, all_c, all_b, k)

    return _per_image_nms(per_image, bboxes, scores, n, k)


# ----------------------------------------------------------- box utilities

@op()
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              variance=None):
    pb = prior_box.float()
    tb = target_box.float()
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if prior_box_var is not None:
        var = prior_box_var.float()
    elif variance:
        var = torch.tensor(variance, dtype=_f32, device=pb.device)[None, :]
    else:
        var = torch.ones((1, 4), dtype=_f32, device=pb.device)
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(tw[:, None] / pw[None, :])
        oh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        return out / var[None, :, :] if var.dim() == 2 else out / var
    if tb.dim() == 2:
        tb = tb[:, None, :]
    if axis == 0:
        pcx_, pcy_, pw_, ph_ = (pcx[None, :], pcy[None, :], pw[None, :],
                                ph[None, :])
    else:
        pcx_, pcy_, pw_, ph_ = (pcx[:, None], pcy[:, None], pw[:, None],
                                ph[:, None])
    if var.numel() > 4:
        t = tb * (var[None, :, :] if var.shape[0] != tb.shape[0]
                  else var[:, None, :])
    else:
        t = tb * var.reshape(1, 1, 4)
    dcx = t[..., 0] * pw_ + pcx_
    dcy = t[..., 1] * ph_ + pcy_
    dw = torch.exp(t[..., 2]) * pw_
    dh = torch.exp(t[..., 3]) * ph_
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - norm, dcy + dh * 0.5 - norm],
                       dim=-1)


@op()
def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False):
    fh, fw = input.shape[-2], input.shape[-1]
    ih, iw = image.shape[-2], image.shape[-1]
    step_w = steps[0] if steps[0] > 0 else iw / fw
    step_h = steps[1] if steps[1] > 0 else ih / fh
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    boxes = []
    for ms in min_sizes:
        boxes.append((ms, ms))
        for mx in max_sizes or ():
            s = float(np.sqrt(ms * mx))  # noqa: H001 (prior-box size attrs)
            boxes.append((s, s))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            boxes.append((ms * float(np.sqrt(ar)), ms / float(np.sqrt(ar))))
    dev = input.device
    cx = (_arange(fw, dev) + offset) * step_w
    cy = (_arange(fh, dev) + offset) * step_h
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    wh = torch.tensor(boxes, dtype=_f32, device=dev)
    bx = torch.stack([
        (gx[..., None] - wh[None, None, :, 0] / 2) / iw,
        (gy[..., None] - wh[None, None, :, 1] / 2) / ih,
        (gx[..., None] + wh[None, None, :, 0] / 2) / iw,
        (gy[..., None] + wh[None, None, :, 1] / 2) / ih,
    ], dim=-1)
    if clip:
        bx = torch.clamp(bx, 0.0, 1.0)
    var = torch.tensor(variances, dtype=_f32, device=dev).expand(bx.shape)
    return bx, var


def _top_k(s, k):
    """``lax.top_k``: the k largest, the lowest index first among ties."""
    order = torch.sort(s, descending=True, stable=True)
    return order.values[:k], order.indices[:k]


@op()
def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False):
    """RPN proposals.  scores [N,A,H,W], deltas [N,A*4,H,W] -> padded
    rois [N*K, 4], scores [N*K, 1] and per-image counts."""
    n, a, h, w = scores.shape
    anc = anchors.reshape(-1, 4).float()
    var = variances.reshape(-1, 4).float()
    off = 1.0 if pixel_offset else 0.0
    rois, rscores, cnts = [], [], []
    for sc, dl, imshape in zip(scores.float(), bbox_deltas.float(),
                               im_shape.float()):
        s = sc.permute(1, 2, 0).reshape(-1)
        d = dl.reshape(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
        top_s, idx = _top_k(s, min(pre_nms_top_n, s.shape[0]))
        d, an, va = d[idx], anc[idx], var[idx]
        aw = an[:, 2] - an[:, 0] + off
        ah = an[:, 3] - an[:, 1] + off
        acx = an[:, 0] + aw / 2
        acy = an[:, 1] + ah / 2
        cx = va[:, 0] * d[:, 0] * aw + acx
        cy = va[:, 1] * d[:, 1] * ah + acy
        bw = torch.exp(torch.clamp(va[:, 2] * d[:, 2], max=10.0)) * aw
        bh = torch.exp(torch.clamp(va[:, 3] * d[:, 3], max=10.0)) * ah
        props = torch.stack([cx - bw / 2, cy - bh / 2,
                             cx + bw / 2 - off, cy + bh / 2 - off], dim=1)
        hi = torch.stack([imshape[1] - 1, imshape[0] - 1,
                          imshape[1] - 1, imshape[0] - 1])
        props = jclip(props, 0.0, hi)
        ws = props[:, 2] - props[:, 0] + off
        hs = props[:, 3] - props[:, 1] + off
        valid = (ws >= min_size) & (hs >= min_size)
        ninf = torch.full_like(top_s, float("-inf"))
        s2 = torch.where(valid, top_s, ninf)
        keep = _nms_mask(props, s2, nms_thresh) & valid
        s3 = torch.where(keep, s2, ninf)
        fs, fi = _top_k(s3, min(post_nms_top_n, s3.shape[0]))
        rois.append(props[fi])
        rscores.append(fs)
        cnts.append(torch.isfinite(fs).sum())
    return (torch.stack(rois).reshape(-1, 4),
            torch.stack(rscores).reshape(-1, 1),
            torch.stack(cnts).to(torch.int32))


@op()
def distribute_fpn_proposals(fpn_rois, rois_num=None, min_level=2,
                             max_level=5, refer_level=4, refer_scale=224,
                             pixel_offset=False):
    rois = fpn_rois.float()
    r = rois.shape[0]
    off = 1.0 if pixel_offset else 0.0
    ws = rois[:, 2] - rois[:, 0] + off
    hs = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt(torch.clamp(ws * hs, min=1e-6))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    ar = torch.arange(r, device=rois.device)
    outs, idxs, nums = [], [], []
    for li in range(max_level - min_level + 1):
        mask = lvl == (min_level + li)
        sel = torch.sort(torch.where(mask, ar, torch.full_like(ar, r))).values
        sel_c = torch.clamp(sel, 0, max(r - 1, 0))
        outs.append(torch.where((sel < r)[:, None], rois[sel_c],
                                torch.zeros_like(rois[sel_c])))
        idxs.append(sel)
        nums.append(mask.sum().to(torch.int32))
    cat = torch.cat([torch.where(i < r, i, torch.full_like(i, 10 ** 9))
                     for i in idxs])
    restore = torch.argsort(cat, stable=True)
    return outs, restore[:, None].to(torch.int32), nums


# ---------------------------------------------------------------- YOLO ops

@op()
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    n, c, h, w = x.shape
    na = len(anchors) // 2
    dev = x.device
    an = torch.tensor(anchors, dtype=_f32, device=dev).reshape(na, 2)
    if iou_aware:
        ious = torch.sigmoid(x[:, :na].float())
        x = x[:, na:]
    pred = x.reshape(n, na, 5 + class_num, h, w).float()
    gx = _arange(w, dev)
    gy = _arange(h, dev)
    bx = (torch.sigmoid(pred[:, :, 0]) * scale_x_y
          - 0.5 * (scale_x_y - 1) + gx[None, None, None, :]) / w
    by = (torch.sigmoid(pred[:, :, 1]) * scale_x_y
          - 0.5 * (scale_x_y - 1) + gy[None, None, :, None]) / h
    bw = torch.exp(pred[:, :, 2]) * an[None, :, 0, None, None] / \
        (downsample_ratio * w)
    bh = torch.exp(pred[:, :, 3]) * an[None, :, 1, None, None] / \
        (downsample_ratio * h)
    conf = torch.sigmoid(pred[:, :, 4])
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * ious ** iou_aware_factor
    probs = torch.sigmoid(pred[:, :, 5:]) * conf[:, :, None]
    score_mask = conf > conf_thresh
    imh = img_size[:, 0].float()[:, None, None, None]
    imw = img_size[:, 1].float()[:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        x1, y1 = jclip(x1, 0.0, imw - 1), jclip(y1, 0.0, imh - 1)
        x2, y2 = jclip(x2, 0.0, imw - 1), jclip(y2, 0.0, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(score_mask[..., None], boxes, torch.zeros_like(boxes))
    scores = torch.where(score_mask[:, :, None], probs,
                         torch.zeros_like(probs))
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return boxes.reshape(n, -1, 4), scores


def _bce(p, t):
    return -(t * torch.log(torch.clamp(p, 1e-9, 1.0))
             + (1 - t) * torch.log(torch.clamp(1 - p, 1e-9, 1.0)))


@op()
def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
              anchor_mask=(), class_num=1, ignore_thresh=0.7,
              downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    """YOLOv3 loss: xy/wh/obj/cls terms; [N,C,H,W] preds, [N,B,4] gt
    (reference yolo_loss_kernel.cc)."""
    n, c, h, w = x.shape
    dev = x.device
    na = len(anchor_mask)
    an_all = torch.tensor(anchors, dtype=_f32, device=dev).reshape(-1, 2)
    mask_list = torch.tensor(anchor_mask, dtype=torch.long, device=dev)
    an = an_all[mask_list]
    pred = x.reshape(n, na, 5 + class_num, h, w).float()
    input_size = downsample_ratio * h
    gtb = gt_box.float()
    b = gtb.shape[1]
    px = torch.sigmoid(pred[:, :, 0])
    py = torch.sigmoid(pred[:, :, 1])
    pw, ph, pobj = pred[:, :, 2], pred[:, :, 3], pred[:, :, 4]
    pcls = pred[:, :, 5:]
    gi = torch.clamp((gtb[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gtb[..., 1] * h).to(torch.int32), 0, h - 1).long()
    valid = (gtb[..., 2] > 0) & (gtb[..., 3] > 0)
    gw = gtb[..., 2] * input_size
    gh = gtb[..., 3] * input_size
    inter = torch.minimum(gw[..., None], an_all[None, None, :, 0]) * \
        torch.minimum(gh[..., None], an_all[None, None, :, 1])
    union = gw[..., None] * gh[..., None] + \
        an_all[None, None, :, 0] * an_all[None, None, :, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    hit = best[..., None] == mask_list[None, None, :]
    an_idx = torch.argmax(hit.to(torch.int32), dim=-1)
    responsible = hit.any(dim=-1) & valid
    tx = gtb[..., 0] * w - gi.float()
    ty = gtb[..., 1] * h - gj.float()
    tw = torch.log(torch.clamp(gw / torch.clamp(an[an_idx][..., 0],
                                                min=1e-9), min=1e-9))
    th = torch.log(torch.clamp(gh / torch.clamp(an[an_idx][..., 1],
                                                min=1e-9), min=1e-9))
    tscale = 2.0 - gtb[..., 2] * gtb[..., 3]
    score_w = (gt_score.float() if gt_score is not None
               else torch.ones((n, b), dtype=_f32, device=dev))
    bidx = torch.arange(n, device=dev)[:, None].expand(n, b)
    sel = (bidx, an_idx, gj, gi)
    zero = torch.zeros((), device=dev)
    wgt = torch.where(responsible, tscale * score_w, zero)
    loss_xy = (_bce(px[sel], tx) + _bce(py[sel], ty)) * wgt
    loss_wh = (torch.abs(pw[sel] - tw) + torch.abs(ph[sel] - th)) * wgt
    flat = (((bidx * na + an_idx) * h + gj) * w + gi).reshape(-1)
    obj_t = torch.zeros(n * na * h * w, device=dev).scatter_reduce(
        0, flat, torch.where(responsible, score_w, zero).reshape(-1),
        reduce="amax", include_self=True).reshape(n, na, h, w)
    obj_mask = torch.zeros(n * na * h * w, device=dev).scatter_reduce(
        0, flat, responsible.float().reshape(-1), reduce="amax",
        include_self=True).reshape(n, na, h, w) > 0
    gx_grid = _arange(w, dev)
    gy_grid = _arange(h, dev)
    pbx = (px + gx_grid[None, None, None, :]) / w
    pby = (py + gy_grid[None, None, :, None]) / h
    pbw = torch.exp(torch.clamp(pw, -10, 10)) * \
        an[None, :, 0, None, None] / input_size
    pbh = torch.exp(torch.clamp(ph, -10, 10)) * \
        an[None, :, 1, None, None] / input_size
    p1x = (pbx - pbw / 2)[..., None]
    p1y = (pby - pbh / 2)[..., None]
    p2x = (pbx + pbw / 2)[..., None]
    p2y = (pby + pbh / 2)[..., None]
    g1x = (gtb[..., 0] - gtb[..., 2] / 2)[:, None, None, None, :]
    g1y = (gtb[..., 1] - gtb[..., 3] / 2)[:, None, None, None, :]
    g2x = (gtb[..., 0] + gtb[..., 2] / 2)[:, None, None, None, :]
    g2y = (gtb[..., 1] + gtb[..., 3] / 2)[:, None, None, None, :]
    iw = torch.clamp(torch.minimum(p2x, g2x) - torch.maximum(p1x, g1x),
                     min=0.0)
    ih = torch.clamp(torch.minimum(p2y, g2y) - torch.maximum(p1y, g1y),
                     min=0.0)
    inter_pg = iw * ih
    union_pg = (pbw * pbh)[..., None] + \
        (gtb[..., 2] * gtb[..., 3])[:, None, None, None, :] - inter_pg
    best_iou = torch.where(valid[:, None, None, None, :],
                           inter_pg / torch.clamp(union_pg, min=1e-9),
                           zero).amax(dim=-1)
    ignore = (best_iou > ignore_thresh) & ~obj_mask
    loss_obj = _bce(torch.sigmoid(pobj), obj_t)
    loss_obj = torch.where(ignore, zero, torch.where(
        obj_mask | (obj_t == 0), loss_obj, zero))
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    lbl = torch.clamp(gt_label.long(), 0, class_num - 1)
    cls_t = torch.full((n, b, class_num), smooth, dtype=_f32,
                       device=dev).scatter(-1, lbl[..., None], 1.0 - smooth)
    pc = torch.sigmoid(pcls.permute(0, 1, 3, 4, 2)[sel])
    loss_cls = torch.sum(_bce(pc, cls_t), -1) * responsible.float()
    return (loss_xy.sum(1) + loss_wh.sum(1) + loss_obj.sum((1, 2, 3))
            + loss_cls.sum(1))


# ------------------------------------------------------- deformable conv

@op()
def deformable_conv(x, offset, weight, mask=None, strides=(1, 1),
                    paddings=(0, 0), dilations=(1, 1),
                    deformable_groups=1, groups=1, im2col_step=64):
    """Deformable conv v1/v2: a bilinear-sampled im2col (each of the four
    taps counts only when in bounds), then one matmul per group."""
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    off = offset.float().reshape(n, deformable_groups, kh * kw, 2, oh, ow)
    base_y = (torch.arange(oh, device=dev) * sh - ph)[:, None] + \
        (torch.arange(kh, device=dev) * dh)[None, :]
    base_x = (torch.arange(ow, device=dev) * sw - pw)[:, None] + \
        (torch.arange(kw, device=dev) * dw)[None, :]
    cpd = cin // deformable_groups
    if mask is not None:
        mk = mask.float().reshape(n, deformable_groups, kh * kw, oh, ow)
    cols = []
    for dg in range(deformable_groups):
        feat = x[:, dg * cpd:(dg + 1) * cpd].float().reshape(n, cpd, h * w)
        oy = off[:, dg, :, 0].reshape(n, kh, kw, oh, ow)
        ox = off[:, dg, :, 1].reshape(n, kh, kw, oh, ow)
        yy = base_y.T[None, :, None, :, None] + oy
        xx = base_x.T[None, None, :, None, :] + ox
        y0, x0 = torch.floor(yy), torch.floor(xx)
        dy, dx = yy - y0, xx - x0
        v = 0.0
        for ty, wy in ((y0, 1 - dy), (y0 + 1, dy)):
            for tx, wx in ((x0, 1 - dx), (x0 + 1, dx)):
                ok = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
                idx = (torch.clamp(ty, 0, h - 1).long() * w
                       + torch.clamp(tx, 0, w - 1).long()).reshape(n, 1, -1)
                tap = torch.gather(feat, 2, idx.expand(n, cpd, -1))
                tap = tap.reshape(n, cpd, kh, kw, oh, ow)
                wgt = torch.where(ok, wy * wx, torch.zeros_like(wy))
                v = v + wgt[:, None] * tap
        if mask is not None:
            v = v * mk[:, dg].reshape(n, 1, kh, kw, oh, ow)
        cols.append(v)
    col = torch.cat(cols, dim=1)
    wmat = weight.reshape(cout, cin_g * kh * kw).float()
    cpg, opg = cin // groups, cout // groups
    outs = []
    for g in range(groups):
        cg = col[:, g * cpg:(g + 1) * cpg].reshape(n, cpg * kh * kw, oh * ow)
        outs.append(torch.einsum("ok,nkl->nol",
                                 wmat[g * opg:(g + 1) * opg], cg))
    return torch.cat(outs, dim=1).reshape(n, cout, oh, ow).to(x.dtype)


# --------------------------------------------------------------- fold etc.

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@op()
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im: x [N, C*kh*kw, L] -> [N, C, H, W] (the inverse layout of
    unfold), the overlapping taps summed."""
    return _tF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                    dilation=_pair(dilations), padding=_pair(paddings),
                    stride=_pair(strides))


@op()
def channel_shuffle(x, groups, data_format="NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def decode_jpeg(x, mode="unchanged", name=None):
    """Host-side JPEG decode over Pillow (the reference decodes with
    nvjpeg; here, as in the JAX package, it is a host op feeding the
    input pipeline).  Raises ``NotImplementedError`` without Pillow."""
    data = x.numpy() if hasattr(x, "numpy") else x  # noqa: H001 (host JPEG decode by design)
    data = np.asarray(data, dtype=np.uint8).tobytes()  # noqa: H001 (host JPEG decode by design)
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError as e:
        raise NotImplementedError(
            "decode_jpeg requires Pillow on the host") from e
    img = Image.open(_io.BytesIO(data))
    if mode != "unchanged":
        img = img.convert(mode.upper() if mode != "gray" else "L")
    arr = np.asarray(img)  # noqa: H001 (host JPEG decode by design)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _wrap(torch.as_tensor(np.ascontiguousarray(arr),
                                 device=current_device()))


register_external("decode_jpeg", decode_jpeg)
