"""nn.functional: stateless NN ops (port of ``paddle_tpu/nn/functional.py``).

Every function of the JAX module is here.  Its inventory ops are
registered ops, with ``linear``, ``rms_norm``, ``cross_entropy`` and the
rarer losses; ``dropout``, ``alpha_dropout``, ``gumbel_softmax``,
``ctc_loss``, ``softmax_with_cross_entropy`` and
``scaled_dot_product_attention`` dispatch the same way without a
registry entry of their own, as in the JAX package.  Called with Paddle Tensors they
return Tensors and record torch autograd; called with raw torch tensors
(the port's GPT, its engine and ``TrainStep``) they are the bodies
themselves (``ops/dispatch.py``).

The pooling functions keep the JAX bodies' windows, pads and divisors
(see the note above ``max_pool2d``).

``layer_norm`` and ``scaled_dot_product_attention`` reach the
hand-written CUDA kernels on CUDA tensors (LayerNorm B4,
``ops/cuda/layernorm_kernel.py``; flash attention B2/B3 through
``ops/attention.py``) and the JAX package's plain compositions on the
CPU.  ``cross_entropy`` keeps the JAX package's chunked f32 softmax
cross entropy, which is XLA composition there and plain PyTorch here.
``interpolate`` is ``jax.image.resize`` as the JAX body calls it
(``ops/vision_ops.image_resize``); ``ctc_loss`` is the ``warpctc`` op.
Randomness (dropout, ``alpha_dropout``, ``gumbel_softmax``) draws from
an explicit ``torch.Generator``: given Paddle Tensors and no generator,
the global generator of the tensor's device (``framework/random.py``);
for ``dropout`` given raw torch tensors and none, PyTorch's default
generator of the device.  Gradients at kinks and ties are JAX's
(``ops/math.jabs``/``jmaximum``/``jclip``, and ``pool_ops.first_max``
for a window's maximum).
"""


import math

import torch

from ..core.tensor import Tensor
from ..framework.dtype import convert_dtype
from ..framework.random import generator as _global_generator
from ..ops.attention import flash_attention as _dispatch_attention
from ..ops.cuda.layernorm_kernel import (layer_norm_plain, layernorm_cuda,
                                         takes_channels)
from ..ops.dispatch import apply_op
from ..ops.math import jabs, jclip, jmaximum
from ..ops.pool_ops import adaptive_bins, first_max, window_reduce
from ..ops.pool_ops import windows as pool_windows
from ..ops.registry import OPS, op
from ..ops.vision_ops import image_resize

_tF = torch.nn.functional

# ---------------- activations ----------------


@op()
def relu(x):
    return torch.relu(x)


@op()
def relu6(x):
    """``jax.nn.relu6``: derivative 1 strictly inside (0, 6), 0 at
    both bounds."""
    return torch.where((x > 0) & (x < 6), x, torch.clamp(x, 0.0, 6.0).detach())


@op()
def relu_(x):
    return torch.relu(x)


@op()
def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


@op()
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@op()
def prelu(x, weight, data_format="NCHW"):
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
        shape[ch_axis] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


@op()
def elu(x, alpha=1.0):
    return _tF.elu(x, alpha)


@op()
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op()
def celu(x, alpha=1.0):
    return _tF.celu(x, alpha)


@op()
def silu(x):
    return _tF.silu(x)


@op()
def swish(x):
    return _tF.silu(x)


@op()
def mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


@op()
def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


@op()
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


@op()
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@op()
def tanhshrink(x):
    return x - torch.tanh(x)


@op()
def hardtanh(x, min=-1.0, max=1.0):
    return jclip(x, min, max)


@op()
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return jclip(slope * x + offset, 0.0, 1.0)


@op()
def hardswish(x):
    return x * jclip(x + 3.0, 0.0, 6.0) / 6.0


@op()
def softsign(x):
    return x / (1.0 + torch.abs(x))


@op()
def log_sigmoid(x):
    return _tF.logsigmoid(x)


@op()
def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


@op()
def log_softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


@op()
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@op()
def maxout(x, groups, axis=1):
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(shape), dim=axis + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """Softmax of (x + Gumbel noise) / temperature; ``hard`` gives the
    one-hot of its argmax with the soft gradient (straight-through).
    The noise draws from ``generator``, else the global generator of
    ``x``'s device."""
    def body(x):
        gen = generator if generator is not None else \
            _global_generator(x.device)
        u = torch.rand(x.shape, generator=gen, device=x.device,
                       dtype=x.dtype)
        u = torch.clamp(u, min=torch.finfo(x.dtype).tiny)
        y = torch.softmax((x - torch.log(-torch.log(u))) / temperature,
                          dim=axis)
        if hard:
            onehot = torch.zeros_like(y).scatter(
                axis, y.argmax(dim=axis, keepdim=True), 1.0)
            y = onehot + y - y.detach()
        return y
    return apply_op("gumbel_softmax", body, (x,), {})


@op()
def normalize(x, p=2, axis=1, epsilon=1e-12):
    nrm = torch.sum(jabs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / jmaximum(nrm, epsilon)


# ---------------- linear / embedding ----------------


@op()
def linear(x, weight, bias=None):
    """y = x @ W + b; weight layout [in, out] (Paddle convention)."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


@op()
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` are zeros.
    ``sparse`` is accepted and ignored, as in the JAX package."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


@op()
def one_hot(x, num_classes):
    return _tF.one_hot(x.long(), num_classes).to(torch.float32)


@op()
def label_smooth(label, prior_dist=None, epsilon=0.1):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


@op()
def bilinear(x1, x2, weight, bias=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


# ---------------- conv ----------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _conv_pads(padding, x, weight, stride, dilation, nd):
    """The JAX package's padding forms (an int, one int a dim, a (lo, hi)
    pair a dim, "SAME" or "VALID") -> (lo, hi) pairs over the spatial
    dims, with XLA's SAME (``lo = total // 2``)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        pairs = []
        for i in range(nd):
            size, k = x.shape[2 + i], weight.shape[2 + i]
            out = -(-size // stride[i])
            total = max((out - 1) * stride[i] + (k - 1) * dilation[i] + 1
                        - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in padding]


def _conv(x, weight, bias, stride, padding, dilation, groups, nd):
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pairs = _conv_pads(padding, x, weight, stride, dilation, nd)
    sym = [lo for lo, hi in pairs]
    if any(lo != hi for lo, hi in pairs):
        x = _tF.pad(x, [p for lo_hi in reversed(pairs) for p in lo_hi])
        sym = [0] * nd
    conv = (_tF.conv1d, _tF.conv2d, _tF.conv3d)[nd - 1]
    out = conv(x, weight, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@op()
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """Convolution (reference: phi conv kernels -> cuDNN); ``weight`` is
    OIHW whatever the data format."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = _conv(x, weight, bias, stride, padding, dilation, groups, 2)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@op()
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3)


@op()
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", output_size=None):
    """Transposed convolution, ``weight`` [in, out / groups, kh, kw]:
    the full transposed product, then each spatial dim cut by its
    (lo, hi) padding and grown by ``output_padding`` at the end, as the
    JAX package's gradient-of-conv form computes it."""
    stride, dilation = _pair(stride), _pair(dilation)
    opad = _pair(output_padding)
    keff = [(weight.shape[2 + i] - 1) * dilation[i] + 1 for i in range(2)]
    if isinstance(padding, str):
        pairs = ([(0, 0), (0, 0)] if padding.upper() == "VALID"
                 else [(k // 2, k // 2) for k in keff])
    else:
        pairs = _conv_pads(padding, x, weight, stride, dilation, 2)
    out = _tF.conv_transpose2d(x, weight, None, stride, 0, 0, groups,
                               dilation)
    for i, (lo, hi) in enumerate(pairs):
        dim = 2 + i
        end = out.shape[dim] - hi + opad[i]
        extra = end - out.shape[dim]
        if extra > 0:   # F.pad lists the last dim first
            out = _tF.pad(out, [0, 0, 0, extra] if dim == 2 else [0, extra])
        out = out.narrow(dim, lo, end - lo)
    if bias is not None:
        out = out + bias.reshape((1, -1, 1, 1))
    return out


@op()
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """1-D convolution; ``weight`` is [out, in / groups, k] whatever the
    data format."""
    if data_format != "NCL":
        x = x.permute(0, 2, 1)
    out = _conv(x, weight, bias, stride, padding, dilation, groups, 1)
    return out.permute(0, 2, 1) if data_format != "NCL" else out


# ---------------- pooling ----------------
# The JAX bodies are ``lax.reduce_window``; each is kept here with its own
# quirks (``ops/pool_ops.window_reduce`` is the window reduction):
# ``avg_pool2d`` divides by the cells inside the input when ``exclusive``
# with explicit padding and by the window's size otherwise; ``ceil_mode``
# grows max_pool2d's high pad by one stride; the 1-D forms ignore
# ``ceil_mode`` and ``exclusive``; adaptive bins are ``[floor(i·in/out),
# ceil((i+1)·in/out))``.


def _pool_pads(padding, x, dims, ks, st):
    """The JAX body's padding (an int, pairs, "SAME" or "VALID" with
    XLA's SAME) -> explicit (lo, hi) pairs over ``dims``."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * len(dims)
        pairs = []
        for d, k, s in zip(dims, ks, st):
            out = -(-x.shape[d] // s)
            total = max((out - 1) * s + k - x.shape[d], 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    return [list(p) for p in _conv_pads(padding, None, None, None, None,
                                        len(dims))]


def _spatial(x, nd, data_format):
    return list(range(2, 2 + nd)) if data_format.startswith("NC") \
        else list(range(1, 1 + nd))


@op()
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    if data_format != "NCHW" and return_mask:
        raise NotImplementedError("return_mask requires NCHW")
    dims = _spatial(x, 2, data_format)
    pairs = _pool_pads(padding, x, dims, ks, st)
    mask_pairs = [(0, 0), (0, 0)] if isinstance(padding, str) else pairs
    if ceil_mode and not isinstance(padding, str):
        for i, d in enumerate(dims):
            span = x.shape[d] + sum(pairs[i]) - ks[i]
            pairs[i][1] += st[i] if span % st[i] else 0
        mask_pairs = pairs
    out = window_reduce(x, dims, ks, st, pairs, "max")
    if not return_mask:
        return out
    # mask: the flattened input position (h*W + w) of each window's max
    n, c, h, w = x.shape
    hw = torch.arange(h * w, dtype=torch.float32, device=x.device)
    hw = hw.reshape(1, 1, h, w).expand(x.shape)
    px = pool_windows(x.detach(), dims, ks, st, mask_pairs, float("-inf"))
    pi = pool_windows(hw, dims, ks, st, mask_pairs, -1.0)
    px = px.reshape(*px.shape[:4], -1)
    arg = px.argmax(dim=-1, keepdim=True)
    mask = torch.gather(pi.reshape(*pi.shape[:4], -1), -1, arg)[..., 0]
    return out, mask.to(torch.int32)


@op()
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    dims = _spatial(x, 2, data_format)
    pairs = _pool_pads(padding, x, dims, ks, st)
    summed = window_reduce(x, dims, ks, st, pairs, "add")
    if exclusive and not isinstance(padding, str):
        counts = window_reduce(torch.ones_like(x), dims, ks, st, pairs,
                               "add")
        return summed / counts
    return summed / float(ks[0] * ks[1])


@op()
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    ks = _pair(kernel_size, 1)
    st = _pair(stride if stride is not None else kernel_size, 1)
    pairs = _pool_pads(padding, x, [2], ks, st)
    # the JAX body's window init is finfo.min, not -inf
    w = pool_windows(x, [2], ks, st, pairs, torch.finfo(x.dtype).min)
    return first_max(w, 1)


@op()
def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    ks = _pair(kernel_size, 1)
    st = _pair(stride if stride is not None else kernel_size, 1)
    pairs = _pool_pads(padding, x, [2], ks, st)
    return window_reduce(x, [2], ks, st, pairs, "add") / float(ks[0])


def _adaptive(x, axes, sizes, reduce):
    for ax, osz in zip(axes, sizes):
        isz = x.shape[ax]
        if isz % osz == 0:
            k = isz // osz
            x = reduce(x.unflatten(ax, (osz, k)), ax + 1)
            continue
        x = torch.cat([reduce(x.narrow(ax, s, e - s), ax, keep=True)
                       for s, e in adaptive_bins(isz, osz)], dim=ax)
    return x


def _mean(t, ax, keep=False):
    return t.mean(dim=ax, keepdim=keep)


def _max(t, ax, keep=False):
    return t.amax(dim=ax, keepdim=keep)


def _tiles(x, dims, sizes):
    """The window of adaptive bins that tile ``x`` on ``dims``, or None."""
    if all(x.shape[d] % o == 0 for d, o in zip(dims, sizes)):
        return [x.shape[d] // o for d, o in zip(dims, sizes)]
    return None


@op()
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """The mean over each adaptive bin: bins that tile the input are one
    window sum over the bin's size, as in the JAX body."""
    dims, sizes = _spatial(x, 2, data_format), _pair(output_size)
    k = _tiles(x, dims, sizes)
    if k is not None:
        return window_reduce(x, dims, k, k, [(0, 0)] * 2, "add") / float(
            k[0] * k[1])
    return _adaptive(x, dims, sizes, _mean)


@op()
def adaptive_max_pool2d(x, output_size, return_mask=False):
    """The max over each adaptive bin; ``return_mask`` is accepted and
    ignored, as in the JAX body.  Bins that tile the input are one
    ``reduce_window`` there, whose VJP sends a tie's gradient to the
    first maximum; uneven bins are ``jnp.max`` slices, which split it."""
    sizes = _pair(output_size)
    k = _tiles(x, [2, 3], sizes)
    if k is not None:
        return window_reduce(x, [2, 3], k, k, [(0, 0)] * 2, "max")
    return _adaptive(x, [2, 3], sizes, _max)


@op()
def adaptive_avg_pool1d(x, output_size):
    return _adaptive(x, [2], (output_size,), _mean)


# ---------------- normalization ----------------


@op()
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the trailing ``normalized_shape`` dims.  A CUDA
    tensor normalised over its last dim with both ``weight`` and
    ``bias``, of a width the kernels take (``C % 8 == 0``, up to 8192),
    launches the LayerNorm kernels (forward and backward), which raise
    for a dtype they do not take; every other call is the JAX
    composition, as the JAX package routes a ``C % 128 != 0`` there."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if (x.is_cuda and len(normalized_shape) == 1 and weight is not None
            and bias is not None and takes_channels(x.shape[-1])):
        return layernorm_cuda(x, weight, bias, eps=epsilon)
    return layer_norm_plain(x, normalized_shape, weight, bias, epsilon)


@op()
def rms_norm(x, weight=None, epsilon=1e-06, axis=-1):
    """RMSNorm: ``x * rsqrt(mean(x ** 2) + epsilon) * weight`` over
    ``axis``, in the input's dtype (the llama family's norm)."""
    var = x.square().mean(dim=axis, keepdim=True)
    out = x * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    return out


@op()
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05, data_format="NCHW",
               use_global_stats=None):
    """-> (out, mean, var): the batch statistics in training (biased
    variance), the running ones otherwise; the BatchNorm layer updates
    its buffers from the returned pair."""
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(a for a in range(x.dim()) if a != ch_axis)
    if training and not use_global_stats:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
    else:
        mean, var = running_mean, running_var
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


@op()
def instance_norm(x, weight=None, bias=None, epsilon=1e-05):
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        shape = [1, -1] + [1] * (x.dim() - 2)
        out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return out


@op()
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05,
               data_format="NCHW"):
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    g = x.reshape(n, num_groups, c // num_groups, *spatial)
    axes = tuple(range(2, g.dim()))
    mean = torch.mean(g, dim=axes, keepdim=True)
    var = torch.var(g, dim=axes, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(n, c, *spatial)
    shape = [1, -1] + [1] * len(spatial)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if data_format != "NCHW":
        out = torch.movedim(out, 1, -1)
    return out


@op()
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """``x / (k + alpha · mean of the squares over a window of ``size``
    channels) ** beta``, the window padded by ``size // 2`` before and
    ``size - 1 - size // 2`` after."""
    sq = x.square()
    half = size // 2
    pad = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = _tF.pad(sq, pad)
    window = sum(padded.narrow(1, i, x.shape[1]) for i in range(size))
    return x / torch.pow(k + alpha * window / size, beta)


# ---------------- dropout ----------------


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero elements with probability ``p``.  ``upscale_in_train`` scales
    the kept ones by ``1 / (1 - p)`` in training and is the identity in
    eval; ``downscale_in_infer`` keeps them unscaled in training and
    scales by ``1 - p`` in eval.  ``axis`` shares one draw along the
    other dims.  A Tensor ``x`` without a ``generator`` draws from the
    global generator of its device."""
    if isinstance(x, Tensor):
        if generator is None and training and p > 0.0:
            generator = _global_generator(x._data.device)
        return apply_op("dropout", _dropout, (x, p, axis, training, mode,
                                              generator), {})
    return _dropout(x, p, axis, training, mode, generator)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def _dropout(x, p, axis, training, mode, generator):
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """Dropout that keeps SELU's mean and variance: a dropped element
    takes SELU's negative saturation, then an affine map restores the
    moments (as the JAX body)."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / math.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))) \
        if p < 1.0 else 0.0
    b = -a * alpha_p * p

    def body(x):
        gen = generator if generator is not None else \
            _global_generator(x.device)
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
        return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b
    return apply_op("alpha_dropout", body, (x,), {})


# ---------------- padding / misc ----------------

_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


@op()
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    if isinstance(pad, (list, tuple)) and len(pad) == x.dim() * 2:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        # paddle convention: pad pairs apply starting from the LAST dim
        # backward ([w_left, w_right, h_top, h_bottom] for NCHW)
        pairs = [(0, 0)] * x.dim()
        np_ = len(pad) // 2
        if data_format.startswith("NC"):
            dims = list(range(x.dim() - 1, x.dim() - 1 - np_, -1))
        else:
            dims = list(range(x.dim() - 2, x.dim() - 2 - np_, -1))
        for i, d in enumerate(dims):
            pairs[d] = (pad[2 * i], pad[2 * i + 1])
    while len(pairs) > 1 and pairs[0] == (0, 0):
        pairs = pairs[1:]
    flat = [int(p) for lo_hi in reversed(pairs) for p in lo_hi]
    if mode == "constant":
        return _tF.pad(x, flat, mode="constant", value=value)
    return _tF.pad(x, flat, mode=_PAD_MODES[mode])


@op()
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _tF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                      padding=_pair(paddings), stride=_pair(strides))


@op()
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@op()
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """``jax.image.resize`` over the two spatial dims of an NCHW input,
    as the JAX body calls it: nearest, linear (also for ``area``) or
    Keys cubic, antialiased when shrinking; ``align_corners`` is
    accepted and ignored there and here."""
    n, c, h, w = x.shape
    if size is None:
        sf = _pair(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic", "linear": "linear",
              "area": "linear"}[mode]
    return image_resize(x, (n, c, int(size[0]), int(size[1])), method)


upsample = interpolate


@op()
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot_ = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot_ / torch.clamp(n1 * n2, min=eps)


@op()
def sequence_mask(x, maxlen=None, dtype="int64"):
    if maxlen is None:
        maxlen = int(x.max())  # noqa: H001 (output width from the data)
    steps = torch.arange(maxlen, device=x.device)
    return (steps < x[..., None]).to(convert_dtype(dtype))


@op()
def temporal_shift(x, seg_num, shift_ratio=0.25):
    nt, c, h, w = x.shape
    n = nt // seg_num
    x = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold], torch.zeros_like(x[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                       x[:, :-1, fold:2 * fold]], 1)
    rest = x[:, :, 2 * fold:]
    return torch.cat([left, right, rest], dim=2).reshape(nt, c, h, w)


# ---------------- loss ----------------

def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@op()
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@op()
def l1_loss(input, label, reduction="mean"):
    return _reduce(jabs(input - label), reduction)


@op()
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@op()
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op()
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    neg_abs = -jabs(logit)
    loss = jmaximum(logit, 0.0) - logit * label \
        + torch.log1p(torch.exp(neg_abs))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1.0) * label + 1.0)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op()
def kl_div(input, label, reduction="mean"):
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op()
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    loss = jmaximum(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


@op()
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = -torch.gather(input, -1, safe[..., None])[..., 0]
    if weight is not None:
        picked = picked * weight[safe]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    if reduction == "mean":
        denom = torch.sum(weight[safe] * valid) if weight is not None \
            else torch.clamp(torch.sum(valid.float()), min=1.0)
        return torch.sum(picked) / denom
    if reduction == "sum":
        return torch.sum(picked)
    return picked


_XENT_CHUNK = 256


def _xent_rows(x_c, y_c):
    x32 = x_c.float()
    m = x32.max(dim=-1).values
    lse = m + torch.log(torch.exp(x32 - m[:, None]).sum(dim=-1))
    picked = x32.gather(-1, y_c[:, None]).squeeze(-1)
    return lse - picked, lse


class _ChunkedSoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross entropy without an f32 copy of all the
    logits (``_chunked_softmax_xent``): both passes walk 256-row chunks
    when the rows divide into them; the backward recomputes the softmax
    from the saved per-row lse and returns the gradient in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits2d, labels1d):
        n = logits2d.shape[0]
        if n % _XENT_CHUNK:
            loss, lse = _xent_rows(logits2d, labels1d)
        else:
            parts = [_xent_rows(x, y) for x, y in zip(
                logits2d.split(_XENT_CHUNK), labels1d.split(_XENT_CHUNK))]
            loss = torch.cat([p[0] for p in parts])
            lse = torch.cat([p[1] for p in parts])
        ctx.save_for_backward(logits2d, labels1d, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2d, labels1d, lse = ctx.saved_tensors
        n = logits2d.shape[0]
        chunk = n if n % _XENT_CHUNK else _XENT_CHUNK
        grad = torch.empty_like(logits2d)
        for s in range(0, n, chunk):
            x_c = logits2d[s:s + chunk].float()
            p = torch.exp(x_c - lse[s:s + chunk, None])
            p[torch.arange(p.shape[0], device=p.device),
              labels1d[s:s + chunk]] -= 1.0
            grad[s:s + chunk] = p * g[s:s + chunk, None]
        return grad, None


@op()
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy in f32 whatever the logits' dtype, as the
    JAX body computes it.  Hard labels over the last axis with softmax,
    no weight and no smoothing take the chunked path (rows whose label
    is ``ignore_index`` count zero; ``mean`` divides by the other rows,
    at least 1).  The rest is the JAX body's general path: soft labels
    (smoothed toward uniform), class ``weight`` (``mean`` divides by the
    valid rows' weights), ``label_smoothing``, another ``axis`` (the
    label picked by ``take_along_axis`` with a trailing index axis, as
    there) and ``use_softmax=False`` (the input taken as
    probabilities)."""
    ax = axis if axis >= 0 else input.dim() + axis
    if (use_softmax and not soft_label and label_smoothing == 0.0
            and weight is None and ax == input.dim() - 1):
        lbl = label
        if lbl.dim() == input.dim() and lbl.shape[ax] == 1:
            lbl = lbl.squeeze(ax)
        v = input.shape[-1]
        flat = input.reshape(-1, v)
        lbl_flat = lbl.reshape(-1).long()
        valid = lbl_flat != ignore_index
        safe = torch.where(valid, lbl_flat, 0)
        loss = _ChunkedSoftmaxXent.apply(flat, safe)
        loss = torch.where(valid, loss, 0.0)
        if reduction == "mean":
            return loss.sum() / valid.sum().float().clamp(min=1.0)
        if reduction == "sum":
            return loss.sum()
        return loss.reshape(lbl.shape)
    logits = input.float()
    logp = torch.log_softmax(logits, dim=ax) if use_softmax else \
        torch.log(jmaximum(logits, 1e-30))
    n_classes = logits.shape[ax]
    valid = None
    if soft_label:
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, dim=ax)
    else:
        lbl = label
        if lbl.dim() == logp.dim() and lbl.shape[ax] == 1:
            lbl = lbl.squeeze(ax)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
        picked = _take_along_axis(logp, safe[..., None], ax)[..., 0]
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * (-picked) + \
                label_smoothing * (-logp.mean(dim=ax))
        else:
            loss = -picked
        if weight is not None:
            loss = loss * weight[safe]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if valid is None:
            return loss.mean()
        denom = jmaximum(valid.float().sum(), 1.0)
        if weight is not None:
            denom = jmaximum(torch.where(valid, weight[safe],
                                         torch.zeros_like(loss)).sum(), 1e-9)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    return loss


def _take_along_axis(arr, idx, axis):
    """``jnp.take_along_axis``: the dims other than ``axis`` broadcast
    between ``arr`` and ``idx``."""
    shape = [max(a, b) for a, b in zip(arr.shape, idx.shape)]
    ishape, ashape = list(shape), list(shape)
    ishape[axis], ashape[axis] = idx.shape[axis], arr.shape[axis]
    return torch.gather(arr.expand(ashape), axis, idx.expand(ishape))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    loss = cross_entropy(logits, label, reduction="none",
                         soft_label=soft_label, ignore_index=ignore_index,
                         axis=axis)
    loss = OPS["unsqueeze"].user_fn(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@op()
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1, input, jmaximum(margin - input, 0.0))
    return _reduce(loss, reduction)


@op()
def square_error_cost(input, label):
    return torch.square(input - label)


@op()
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = jmaximum(logit, 0.0) - logit * label + \
        torch.log1p(torch.exp(-jabs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@op()
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(jabs(a - b) + epsilon, p), -1),
                         1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(jmaximum(d_pos - d_neg + margin, 0.0), reduction)


@op()
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = torch.sum(input1 * input2, -1) / jmaximum(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, jmaximum(cos - margin, 0.0))
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths=None, label_lengths=None,
             blank=0, reduction="mean", norm_by_times=False):
    """CTC loss over the ``warpctc`` op; log_probs [T, B, C] time-major
    logits."""
    loss = OPS["warpctc"].user_fn(log_probs, labels,
                                  logits_length=input_lengths,
                                  labels_length=label_lengths, blank=blank,
                                  norm_by_times=norm_by_times)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# ---------------- attention ----------------


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """SDPA on [batch, seq, heads, dim] (Paddle layout).  Attention
    dropout applies in training only and draws from ``generator`` (for
    Tensor inputs without one, the global generator of their device)."""
    use_drop = dropout_p > 0.0 and training
    if generator is None and use_drop and isinstance(query, Tensor):
        generator = _global_generator(query._data.device)

    def body(query, key, value, attn_mask):
        return _dispatch_attention(query, key, value, attn_mask=attn_mask,
                                   is_causal=is_causal,
                                   dropout_p=dropout_p if use_drop else 0.0,
                                   generator=generator)

    return apply_op("scaled_dot_product_attention", body,
                    (query, key, value, attn_mask), {})


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True):
    """Paddle's ``flash_attention`` API -> ``(out, None)``.  As in the
    JAX package, ``dropout`` is not applied and no softmax is
    returned."""
    out = scaled_dot_product_attention(query, key, value, is_causal=causal,
                                       training=training)
    return out, None


__all__ = [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
    "avg_pool1d", "avg_pool2d", "conv1d", "local_response_norm",
    "max_pool1d", "max_pool2d",
    "batch_norm", "bilinear", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "celu", "conv2d", "conv2d_transpose",
    "conv3d", "cosine_similarity", "cross_entropy", "dropout", "dropout2d",
    "dropout3d", "elu", "embedding", "flash_attention", "gelu", "glu",
    "group_norm", "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
    "instance_norm", "kl_div", "l1_loss", "label_smooth", "layer_norm",
    "leaky_relu", "linear", "log_sigmoid", "log_softmax", "margin_ranking_loss",
    "maxout", "mish", "mse_loss", "nll_loss", "normalize", "one_hot", "pad",
    "pixel_shuffle", "prelu", "relu", "relu6", "relu_", "rms_norm",
    "scaled_dot_product_attention", "selu", "silu", "smooth_l1_loss",
    "softmax", "softplus", "softshrink", "softsign", "swish", "tanhshrink",
    "temporal_shift", "unfold", "alpha_dropout", "cosine_embedding_loss",
    "ctc_loss", "gumbel_softmax", "hinge_embedding_loss", "interpolate",
    "sequence_mask", "sigmoid_focal_loss", "softmax_with_cross_entropy",
    "square_error_cost", "triplet_margin_loss", "upsample"]
