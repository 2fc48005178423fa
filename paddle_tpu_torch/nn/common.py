"""Common layers: Linear, Embedding, Dropout, Flatten, padding, upsample.

Port of ``paddle_tpu/nn/common.py``.  ``Upsample`` and ``AlphaDropout``
wait for ``F.interpolate`` and ``F.alpha_dropout`` (A23b) and raise
NotImplementedError.
"""

import torch

from . import functional as F
from .initializer import Normal, XavierUniform
from .layer_base import Layer


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features] (paddle layout)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=None if _has_init(weight_attr) else XavierUniform())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((out_features,), attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


def _has_init(attr):
    from .layer_base import ParamAttr
    return isinstance(attr, ParamAttr) and attr.initializer is not None


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=None if _has_init(weight_attr) else Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._data[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "nn.AlphaDropout needs F.alpha_dropout, which is not ported yet "
            "(A23b)")


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(Pad2D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL"):
        super().__init__(padding, mode, value, data_format)


class Upsample(Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "nn.Upsample needs F.interpolate, which is not ported yet (A23b)")


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)
