"""Extra convolution variants: depthwise, and the 3-d transpose.

Port of ``paddle_tpu/ops/conv_extra.py``: depthwise convolution is the
grouped convolution with one group a channel; ``conv3d_transpose`` is
the full transposed product cut by each dim's (lo, hi) padding and grown
by ``output_padding``, which is what the JAX body's lhs-dilated
convolution computes.
"""

import torch

from .registry import op, raw

_tF = torch.nn.functional


@op()
def depthwise_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     groups=None, data_format="NCHW"):
    ch_axis = 1 if data_format == "NCHW" else 3
    g = groups or x.shape[ch_axis]
    return raw("conv2d")(x, weight, bias=bias, stride=stride,
                         padding=padding, dilation=dilation, groups=g,
                         data_format=data_format)


@op()
def depthwise_conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                               output_padding=0, dilation=1, groups=None,
                               data_format="NCHW", output_size=None):
    g = groups or x.shape[1]
    return raw("conv2d_transpose")(x, weight, bias=bias, stride=stride,
                                   padding=padding,
                                   output_padding=output_padding,
                                   dilation=dilation, groups=g,
                                   data_format=data_format,
                                   output_size=output_size)


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


@op()
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW", output_size=None):
    stride, dilation = _triple(stride), _triple(dilation)
    opad = _triple(output_padding)
    ks = [(weight.shape[2 + i] - 1) * dilation[i] + 1 for i in range(3)]
    if isinstance(padding, str):
        pairs = ([(0, 0)] * 3 if padding.upper() == "VALID"
                 else [(k // 2, k // 2) for k in ks])
    elif isinstance(padding, int):
        pairs = [(padding, padding)] * 3
    else:
        p = list(padding)
        pairs = ([(pi, pi) for pi in p] if len(p) == 3
                 else [(p[2 * i], p[2 * i + 1]) for i in range(3)])
    out = _tF.conv_transpose3d(x, weight, None, stride, 0, 0, groups,
                               dilation)
    for i, (lo, hi) in enumerate(pairs):
        dim = 2 + i
        end = out.shape[dim] - hi + opad[i]
        if end > out.shape[dim]:
            grow = [0, 0] * (3 - i)
            grow[-1] = end - out.shape[dim]
            out = _tF.pad(out, grow)
        out = out.narrow(dim, lo, end - lo)
    if bias is not None:
        out = out + bias.reshape((1, -1, 1, 1, 1))
    return out
