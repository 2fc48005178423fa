"""Remaining inventory ops: metrics, normalization variants, losses,
selected-rows/sparse primitives, layout/shape utilities, collective op
names, and registry aliases for creation/random entry points.

Port of ``paddle_tpu/ops/misc_ops.py``: each op is the JAX body's torch
composition, with JAX's explicit output dtypes and its derivatives at
kinks and ties (``math.jabs``/``jmaximum``/``jclip``).  The random ops
(``rrelu``, ``exponential_``, ``uniform_inplace``,
``class_center_sample``, ``truncated_gaussian_random``, ``dirichlet``,
``gumbel_softmax``) draw from a ``torch.Generator``: the global one of
the tensor's device, or one seeded with ``seed`` where the JAX op takes
a fixed key; they agree with the JAX ops in distribution, not draw for
draw.  The collective names resolve lazily against
``distributed/communication.py``, as in the JAX package.
"""

import importlib
import math

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import current_device
from ..framework.dtype import convert_dtype
from ..framework.random import generator
from .dispatch import apply_op
from .math import _reduction, jabs, jclip, jmaximum
from .registry import op, register_external

_tF = torch.nn.functional


def _seeded(seed, device):
    """A generator seeded with ``seed`` (the JAX op's fixed
    ``PRNGKey(seed)``), else the device's global generator."""
    if not seed:
        return generator(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))  # noqa: H001 (seed attr, a Python int)
    return gen


# ----------------------------------------------------------------- metrics

@op()
def accuracy(x, indices, label):
    """phi accuracy op: x = topk values, indices = topk ids, label [N,1]."""
    lbl = label.reshape(-1, 1)
    correct = (indices == lbl).any(dim=1)
    acc = correct.float().mean()
    return (acc, correct.sum().to(torch.int32),
            torch.tensor(lbl.shape[0], dtype=torch.int32,
                         device=label.device))


@op()
def auc(x, label, stat_pos, stat_neg, ins_tag_weight=None, curve="ROC",
        num_thresholds=4095, slide_steps=1):
    """Streaming AUC (phi auc op): bucketed pos/neg histograms."""
    pred = x[:, -1] if x.dim() == 2 else x.reshape(-1)
    lbl = label.reshape(-1)
    bucket = torch.clamp((pred * num_thresholds).to(torch.int32), 0,
                         num_thresholds).long()
    nb = num_thresholds + 1
    zeros = torch.zeros((nb,), dtype=torch.int64, device=x.device)
    pos_hist = zeros.index_add(0, bucket, (lbl > 0).long())
    neg_hist = zeros.index_add(0, bucket, (lbl <= 0).long())
    sp = stat_pos.reshape(-1)[-nb:] + pos_hist
    sn = stat_neg.reshape(-1)[-nb:] + neg_hist
    pos_cum = torch.cumsum(sp.flip(0), 0)
    neg_cum = torch.cumsum(sn.flip(0), 0)
    tot_pos, tot_neg = pos_cum[-1], neg_cum[-1]
    z1 = torch.zeros(1, dtype=pos_cum.dtype, device=x.device)
    area = torch.sum((neg_cum - torch.cat([z1, neg_cum[:-1]]))
                     * (torch.cat([z1, pos_cum[:-1]]) + pos_cum) / 2.0)
    auc_val = torch.where((tot_pos > 0) & (tot_neg > 0),
                          area / torch.clamp(tot_pos * tot_neg, min=1),
                          torch.zeros((), dtype=area.dtype,
                                      device=x.device))
    return auc_val.float(), sp, sn


# ------------------------------------------------------------------ losses

@op()
def bce_loss(input, label):
    x = jclip(input.float(), 1e-12, 1.0 - 1e-7)
    return -(label * torch.log(x) + (1 - label) * torch.log(1 - x))


@op()
def huber_loss(input, label, delta=1.0):
    r = input - label
    ab = jabs(r)
    quad = 0.5 * r * r
    lin = delta * (ab - 0.5 * delta)
    return torch.where(ab <= delta, quad, lin), r


@op()
def kldiv_loss(x, target, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(target) * (target - x)
    else:
        loss = torch.where(
            target > 0, target * (torch.log(jmaximum(target, 1e-12)) - x),
            torch.zeros((), dtype=x.dtype, device=x.device))
    if reduction == "mean":
        return loss.mean()
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    if reduction == "sum":
        return loss.sum()
    return loss


@op()
def log_loss(input, label, epsilon=1e-4):
    x = input.float()
    return -label * torch.log(x + epsilon) \
        - (1 - label) * torch.log(1 - x + epsilon)


@op()
def sigmoid_cross_entropy_with_logits(x, label, normalize=False,
                                      ignore_index=-100, pos_weight=None):
    xf = x.float()
    lb = label.float()
    loss = jmaximum(xf, 0.0) - xf * lb + torch.log1p(torch.exp(-jabs(xf)))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1.0) * lb + 1.0)
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if normalize:
        loss = loss / torch.clamp(mask.sum().float(), min=1.0)
    return loss


@op()
def cross_entropy_with_softmax(logits, label, soft_label=False,
                               use_softmax=True, numeric_stable_mode=True,
                               ignore_index=-100, axis=-1):
    """phi op: returns (softmax, loss)."""
    lf = logits.float()
    sm = torch.softmax(lf, dim=axis)
    logp = torch.log_softmax(lf, dim=axis) if use_softmax else \
        torch.log(jmaximum(lf, 1e-12))
    if soft_label:
        return sm, -(label.float() * logp).sum(dim=axis, keepdim=True)
    lbl = label
    if lbl.dim() == logp.dim():
        lbl = lbl.squeeze(axis)
    lbl_c = torch.clamp(lbl, 0, logp.shape[axis] - 1).long()
    loss = -torch.gather(logp, axis, lbl_c.unsqueeze(axis))
    loss = torch.where(lbl.unsqueeze(axis) == ignore_index,
                       torch.zeros_like(loss), loss)
    return sm, loss


@op()
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         ring_id=-1, rank=0, nranks=1):
    """ArcFace-style margin softmax, single shard (the TP variant is
    ``fleet.meta_parallel.ParallelCrossEntropy`` in the JAX package)."""
    lf = logits.float()
    lbl = label.reshape(-1).long()
    onehot = _tF.one_hot(lbl, lf.shape[1]).float()
    cos = jclip(lf, -1.0, 1.0)
    theta = torch.arccos(cos)
    target_cos = torch.cos(margin1 * theta + margin2) - margin3
    adj = torch.where(onehot > 0, target_cos, cos) * scale
    logp = torch.log_softmax(adj, dim=-1)
    loss = -(onehot * logp).sum(-1, keepdim=True)
    return loss, torch.exp(logp)


@op()
def hsigmoid_loss(x, label, weight, bias=None, num_classes=2,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid over the reference's SimpleCode tree, or a
    custom tree given by ``path_table``/``path_code`` (entries < 0 pad
    a path), as in the JAX body."""
    if (path_table is None) != (path_code is None):
        raise ValueError(
            "hsigmoid_loss: path_table and path_code must be given "
            "together (custom tree) or both omitted (SimpleCode)")
    lbl = label.reshape(-1).long()
    if path_table is not None:
        valid = path_table >= 0
        idxs = torch.clamp(path_table, 0, weight.shape[0] - 1).long()
        bits = torch.where(valid, path_code, torch.zeros_like(path_code))
        bits = bits.float()
    else:
        u = lbl + num_classes
        max_len = int(2 * num_classes - 1).bit_length() - 1
        js = torch.arange(max_len, device=x.device)
        shifted = u[:, None] >> (js[None, :] + 1)
        valid = shifted > 0
        idxs = torch.clamp(shifted - 1, 0, num_classes - 2)
        bits = ((u[:, None] >> js[None, :]) & 1).float()
    w = weight[idxs]
    logit = torch.einsum("nd,nkd->nk", x.float(), w.float())
    if bias is not None:
        logit = logit + bias.reshape(-1)[idxs]
    loss = jmaximum(logit, 0.0) - logit * bits + \
        torch.log1p(torch.exp(-jabs(logit)))
    return torch.where(valid, loss, torch.zeros_like(loss)).sum(
        -1, keepdim=True)


# --------------------------------------------------------- normalization

def _bn_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


@op()
def batch_norm_(x, mean, variance, scale=None, bias=None, momentum=0.9,
                epsilon=1e-5, data_format="NCHW", is_test=False,
                use_global_stats=False, trainable_statistics=False):
    """Training batch norm returning the updated running stats."""
    axis = 1 if data_format == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != axis)
    xf = x.float()
    if is_test or use_global_stats:
        mu, var = mean, variance
        mean_out, var_out = mean, variance
        saved_mu = torch.zeros_like(mean)
        saved_var = torch.zeros_like(variance)
    else:
        mu = xf.mean(red)
        var = xf.var(red, unbiased=False)
        mean_out = momentum * mean + (1 - momentum) * mu
        var_out = momentum * variance + (1 - momentum) * var
        saved_mu, saved_var = mu, 1.0 / torch.sqrt(var + epsilon)
    shape = _bn_shape(x, axis)
    out = (xf - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return (out.to(x.dtype), mean_out, var_out, saved_mu, saved_var)


@op()
def sync_batch_norm_(x, mean, variance, scale=None, bias=None, momentum=0.9,
                     epsilon=1e-5, data_format="NCHW", is_test=False,
                     use_global_stats=False, trainable_statistics=False):
    """Cross-replica batch norm.  Alone (the JAX op outside a ``dp``
    axis; here one process) the batch statistics are this replica's,
    with the variance taken as ``E[x^2] - E[x]^2``, as in the JAX op."""
    if is_test or use_global_stats:
        return batch_norm_(x, mean, variance, scale, bias, momentum,
                           epsilon, data_format, is_test, use_global_stats,
                           trainable_statistics)
    axis = 1 if data_format == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != axis)
    xf = x.float()
    mu = xf.mean(red)
    var = (xf * xf).mean(red) - mu * mu
    mean_out = momentum * mean + (1 - momentum) * mu
    var_out = momentum * variance + (1 - momentum) * var
    shape = _bn_shape(x, axis)
    out = (xf - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if scale is not None:
        out = out * scale.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return (out.to(x.dtype), mean_out, var_out, mu,
            1.0 / torch.sqrt(var + epsilon))


@op()
def spectral_norm(weight, u, v, dim=0, power_iters=1, epsilon=1e-12):
    w = weight.float()
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    if dim != 0:
        w = w.permute(perm)
    wm = w.reshape(w.shape[0], -1)
    uu, vv = u.reshape(-1), v.reshape(-1)
    for _ in range(power_iters):
        vv = wm.T @ uu
        vv = vv / (torch.linalg.vector_norm(vv) + epsilon)
        uu = wm @ vv
        uu = uu / (torch.linalg.vector_norm(uu) + epsilon)
    sigma = uu @ wm @ vv
    out = (wm / sigma).reshape(w.shape)
    if dim != 0:
        out = out.permute(list(np.argsort(perm)))
    return out.to(weight.dtype)


# ---------------------------------------------------------------- norms

@op()
def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
           asvector=False):
    xf = x.float()
    if asvector:
        xf, axis = xf.reshape(-1), 0
    xf, axis, keepdim = _reduction(xf, axis, keepdim)
    if porder == float("inf"):
        out = jabs(xf).amax(dim=axis, keepdim=keepdim)
    elif porder == float("-inf"):
        out = jabs(xf).amin(dim=axis, keepdim=keepdim)
    elif porder == 0:
        out = (xf != 0).sum(dim=axis, keepdim=keepdim).float()
    else:
        out = torch.pow(torch.pow(jabs(xf), porder).sum(
            dim=axis, keepdim=keepdim), 1.0 / porder)
    return out.to(x.dtype)


@op()
def frobenius_norm(x, axis=None, keepdim=False):
    xf, ax, keepdim = _reduction(x.float(), axis, keepdim)
    return torch.sqrt(torch.square(xf).sum(dim=ax, keepdim=keepdim)
                      ).to(x.dtype)


@op()
def squared_l2_norm(x):
    return torch.square(x.float()).sum().reshape(())


@op()
def clip_by_norm(x, max_norm):
    n = torch.sqrt(torch.square(x.float()).sum())
    factor = torch.where(n > max_norm, max_norm / jmaximum(n, 1e-12),
                         torch.ones_like(n))
    return (x.float() * factor).to(x.dtype)


@op()
def renorm(x, p=2.0, axis=0, max_norm=1.0):
    axis = axis if axis >= 0 else x.dim() + axis
    red = tuple(i for i in range(x.dim()) if i != axis)
    norms = torch.pow(torch.pow(jabs(x.float()), p).sum(
        dim=red, keepdim=True), 1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return (x * factor).to(x.dtype)


# ------------------------------------------------------------ elementwise

@op()
def i0e(x):
    return torch.special.i0e(x)


@op()
def i1e(x):
    return torch.special.i1e(x)


@op()
def nextafter(x, y):
    return torch.nextafter(x, y)


@op()
def logsigmoid(x):
    return _tF.logsigmoid(x)


@op()
def tanh_shrink(x):
    return x - torch.tanh(x)


@op()
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True):
    """Randomized leaky ReLU: a slope drawn from U(lower, upper) per
    negative element in training, the fixed slope (lower+upper)/2 in
    eval (reference rrelu_kernel.cc)."""
    if not training:
        mid = (lower + upper) / 2.0
        return apply_op("rrelu_eval", lambda x: torch.where(
            x >= 0, x, (x.float() * mid).to(x.dtype)), (x,), {})

    def body(x):
        a = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        a.uniform_(lower, upper, generator=generator(x.device))
        return torch.where(x >= 0, x, (a * x.float()).to(x.dtype))
    return apply_op("rrelu_train", body, (x,), {})


register_external("rrelu", rrelu)


@op()
def elementwise_pow(x, y):
    return torch.pow(x, y)


@op()
def divide_scalar(x, scalar):
    return x / scalar


@op()
def mean_all(x):
    return x.float().mean().to(x.dtype)


# -------------------------------------------------------------- shape ops

@op()
def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@op()
def reverse(x, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@op()
def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@op()
def split_with_num(x, num, axis=0):
    if x.shape[axis] % num:
        raise ValueError(
            f"split_with_num: axis of size {x.shape[axis]} does not "
            f"split into {num} equal parts")
    return list(torch.chunk(x, num, dim=axis))


@op()
def repeat_interleave_with_tensor_index(x, repeats, axis=None):
    reps = repeats.long()
    total = int(reps.sum())  # noqa: H001 (dynamic output shape)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.repeat_interleave(x, reps, dim=axis, output_size=total)


@op()
def tril_triu(x, diagonal=0, lower=True):
    return torch.tril(x, diagonal) if lower else torch.triu(x, diagonal)


@op()
def trans_layout(x, perm):
    return x.permute(list(perm))


@op()
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    lo = shard_id * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo,
                       torch.full_like(input, ignore_value))


@op()
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """The registry's op draws from a fixed seed (the JAX op's
    ``PRNGKey(0)``); ``nn.functional.gumbel_softmax`` draws from the
    global generator."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(0)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = hard_y + y.detach() - y
    return y


@op()
def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    if isinstance(paddings, torch.Tensor):
        paddings = paddings.tolist()  # noqa: H001 (padding attrs)
    p = [int(v) for v in np.reshape(paddings, -1)]
    mode = {"replicate": "replicate", "reflect": "reflect",
            "circular": "circular", "constant": "constant"}[mode]
    work = x if data_format == "NCDHW" else x.movedim(-1, 1)
    if mode == "constant":
        out = _tF.pad(work, p, mode="constant", value=value)
    else:
        out = _tF.pad(work, p, mode=mode)
    return out if data_format == "NCDHW" else out.movedim(1, -1)


@op()
def full_batch_size_like(input, shape, value, input_dim_idx=0,
                         output_dim_idx=0, dtype=None):
    shp = [int(s) for s in shape]
    shp[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(shp, value, dtype=convert_dtype(dtype) or input.dtype,
                      device=input.device)


@op()
def fill(x, value):
    return torch.full_like(x, value)


@op()
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    rows, cols = x.shape[dim1], x.shape[dim2]
    if offset >= 0:
        n = max(min(rows, cols - offset), 0)
    else:
        n = max(min(rows + offset, cols), 0)
    xi = x.movedim((dim1, dim2), (0, 1))
    idx = torch.arange(n, device=x.device)
    at = (idx, idx + offset) if offset >= 0 else (idx - offset, idx)
    xi = xi.index_put(at, y.to(x.dtype).expand(xi[at].shape))
    return xi.movedim((0, 1), (dim1, dim2))


def _assign_value(shape, dtype, values):
    return torch.as_tensor(np.asarray(values).reshape(shape),  # noqa: H001 (host literal attr)
                           dtype=convert_dtype(dtype),
                           device=current_device())


def assign_value(shape, dtype, values, name=None):
    return _wrap(_assign_value(shape, dtype, values))


register_external("assign_value", assign_value, body=_assign_value)


@op()
def assign_out_(x, output):
    return x.to(output.dtype) if hasattr(output, "dtype") else x


@op()
def add_n(inputs):
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


@op()
def cast(x, dtype):
    return x.to(convert_dtype(dtype))


@op()
def copy_to(x, place=None, blocking=True):
    return x


@op()
def npu_identity(x, format=-1):
    return x


@op()
def share_buffer(*xs):
    return tuple(xs) + tuple(torch.zeros((), dtype=torch.bool,
                                         device=x.device) for x in xs)


@op()
def coalesce_tensor(inputs, dtype=None, copy_data=True, set_constant=False,
                    persist_output=False, constant=0.0, use_align=True,
                    align_size=-1, size_of_dtype=-1):
    """Flatten a param/grad list into one fused buffer and per-tensor
    views of it (reference coalesce_tensor_op.cc)."""
    fused = torch.cat([x.reshape(-1) for x in inputs])
    if set_constant:
        fused = torch.full_like(fused, constant)
    outs, off = [], 0
    for x in inputs:
        n = x.numel()
        outs.append(fused[off:off + n].reshape(x.shape))
        off += n
    return outs, fused


@op()
def merge_selected_rows(rows, values, height=None):
    """SelectedRows merge: sum duplicate rows into (sorted unique rows
    padded with -1 to the input's length, their sums)."""
    n = rows.shape[0]
    uniq, inv = torch.unique(rows, sorted=True, return_inverse=True)
    pad = torch.full((n - uniq.shape[0],), -1, dtype=uniq.dtype,
                     device=rows.device)
    summed = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                         device=values.device)
    summed = summed.index_add(0, inv.reshape(-1), values)
    return torch.cat([uniq, pad]), summed


@op()
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """x = packed LU, y = pivots (1-based, as LAPACK gives them)."""
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    lo = torch.tril(x[..., :, :k], -1) + torch.eye(m, k, dtype=x.dtype,
                                                   device=x.device)
    up = torch.triu(x[..., :k, :])
    piv = y.long() - 1
    perm = torch.arange(m, device=x.device).expand(
        piv.shape[:-1] + (m,)).clone()
    for i in range(piv.shape[-1]):
        j = piv[..., i:i + 1]
        pi = perm[..., i:i + 1].clone()
        pj = torch.gather(perm, -1, j)
        perm[..., i:i + 1] = pj
        perm.scatter_(-1, j, pi)
    pmat = _tF.one_hot(perm, m).to(x.dtype).transpose(-1, -2)
    return pmat, lo, up


@op()
def matrix_rank_tol(x, atol_tensor=None, use_default_tol=True,
                    hermitian=False, rtol_tensor=None):
    xf = x.float()
    s = torch.linalg.svdvals(xf) if not hermitian else \
        torch.abs(torch.linalg.eigvalsh(xf))
    smax = s.amax(-1, keepdim=True)
    if atol_tensor is not None:
        tol = atol_tensor
        if tol.dim() < s.dim():
            tol = tol.reshape(tuple(tol.shape) + (1,))
    else:
        eps = torch.finfo(torch.float32).eps
        tol = max(x.shape[-2], x.shape[-1]) * eps * smax
    return (s > tol).sum(-1)


@op()
def masked_matmul(x, y, mask):
    """Sparse-masked matmul: computed dense, then masked."""
    out = x.float() @ y.float()
    return torch.where(mask != 0, out, torch.zeros_like(out)).to(x.dtype)


# -------------------------------------------------- generator-drawing ops

def _rebind(x, out):
    """The in-place names' rebinding: ``x`` takes ``out``'s value."""
    if isinstance(x, Tensor) and isinstance(out, Tensor):
        x._rebind_value(out._data.detach().clone())
    return out


def exponential_(x, lam=1.0):
    def body(x):
        u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        u.uniform_(1e-9, 1.0, generator=generator(x.device))
        return (-torch.log(u) / lam).to(x.dtype)
    return _rebind(x, apply_op("exponential_", body, (x,), {}))


register_external("exponential_", exponential_)


def uniform_inplace(x, min=-1.0, max=1.0, seed=0, diag_num=0, diag_step=0,
                    diag_val=1.0):
    def body(x):
        u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        u.uniform_(min, max, generator=_seeded(seed, x.device))
        return u.to(x.dtype)
    return _rebind(x, apply_op("uniform_inplace", body, (x,), {}))


register_external("uniform_inplace", uniform_inplace)


def class_center_sample(label, num_classes, num_samples, ring_id=0, rank=0,
                        nranks=1, fix_seed=False, seed=0):
    """Sample class centers (PartialFC): every positive class, then
    random negatives up to ``num_samples``; labels remapped into the
    sampled index space."""
    def body(label):
        lbl = label.reshape(-1).long()
        dev = label.device
        pos = torch.zeros((num_classes,), dtype=torch.bool, device=dev)
        pos[lbl] = True
        if fix_seed:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        else:
            gen = generator(dev)
        noise = torch.rand((num_classes,), generator=gen, device=dev)
        score = torch.where(pos, torch.full_like(noise, 2.0), noise)
        order = torch.sort(score, descending=True, stable=True).indices
        sampled = torch.sort(order[:num_samples]).values
        remap = torch.full((num_classes,), -1, dtype=torch.int64,
                           device=dev)
        remap[sampled] = torch.arange(num_samples, device=dev)
        return remap[lbl], sampled
    return apply_op("class_center_sample", body, (label,), {})


register_external("class_center_sample", class_center_sample)


def truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0, a=-2.0,
                              b=2.0, dtype="float32"):
    """Normal draws truncated to [a, b] (in standard units) by the
    inverse CDF, as ``jax.random.truncated_normal``."""
    dev = current_device()
    u = torch.rand(tuple(int(s) for s in shape),
                   generator=_seeded(seed, dev), device=dev)
    cdf_a = 0.5 * (1 + math.erf(a / math.sqrt(2)))
    cdf_b = 0.5 * (1 + math.erf(b / math.sqrt(2)))
    p = cdf_a + u * (cdf_b - cdf_a)
    z = math.sqrt(2) * torch.special.erfinv(2 * p - 1)
    z = torch.clamp(z, a, b)
    return _wrap((z * std + mean).to(convert_dtype(dtype)))


register_external("truncated_gaussian_random", truncated_gaussian_random)


def dirichlet(alpha):
    def body(alpha):
        g = torch._standard_gamma(alpha.float(),
                                  generator=generator(alpha.device))
        return g / g.sum(-1, keepdim=True)
    return apply_op("dirichlet", body, (alpha,), {})


register_external("dirichlet", dirichlet)


# ------------------------------------------------ registry name aliases

def _lazy(module_path, fname):
    """``module_path``'s ``fname``, imported at the first call (the
    module loads after ops)."""
    def f(*a, **k):
        mod = importlib.import_module(module_path, package=__package__)
        return getattr(mod, fname)(*a, **k)
    f.__name__ = fname
    return f


def _register_aliases():
    register_external("dropout", _lazy("..nn.functional", "dropout"))

    def full_(x, value):
        data = x._data if isinstance(x, Tensor) else x
        out = torch.full_like(data.detach(), value)
        if isinstance(x, Tensor):
            return x._rebind_value(out)
        return out

    register_external("full_", full_)

    def assign_value_(x, values):
        data = x._data if isinstance(x, Tensor) else x
        arr = torch.as_tensor(
            np.asarray(values),  # noqa: H001 (host literal attr)
            device=data.device).reshape(data.shape).to(data.dtype)
        if isinstance(x, Tensor):
            return x._rebind_value(arr)
        return arr

    register_external("assign_value_", assign_value_)

    # collective op names -> the communication wrappers
    comm = "..distributed.communication"
    for name, fname in (("all_reduce", "all_reduce"),
                        ("all_gather", "all_gather"),
                        ("broadcast", "broadcast"), ("reduce", "reduce"),
                        ("reduce_scatter", "reduce_scatter"),
                        ("p_recv", "recv"), ("p_recv_array", "recv")):
        register_external(name, _lazy(comm, fname))


_register_aliases()
