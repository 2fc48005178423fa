"""Normalization layers (port of ``paddle_tpu/nn/norm.py``).

``LayerNorm`` is the Paddle ``Layer``; ``RMSNorm`` stays the
``torch.nn.Module`` the port's Llama is built from.  The other norms'
classes (batch, group, instance, local response, spectral) wait for
A23b; their functional ops are ported."""

import torch
from torch import nn

from . import functional as F
from .initializer import Constant
from .layer_base import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self.normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(self.normalized_shape,
                                              attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class RMSNorm(nn.Module):
    """``y = x * rsqrt(mean(x ** 2) + epsilon) * weight`` over the last
    dim, with ``weight`` [hidden_size] initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)
