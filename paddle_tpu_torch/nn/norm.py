"""Normalization layers (port of ``paddle_tpu/nn/norm.py``).

``LayerNorm``, ``RMSNorm``, the batch norms, ``GroupNorm``,
``InstanceNorm2D``, ``LocalResponseNorm`` and ``SpectralNorm`` are
Paddle ``Layer``s with the JAX package's parameter and buffer names.
The port's Llama, a ``torch.nn.Module``, keeps an RMSNorm module of its
own (``models/llama.py``).

BatchNorm keeps the JAX running statistics: buffers ``_mean`` and
``_variance`` (zeros and ones), updated in training as ``m · old +
(1 - m) · batch`` with ``momentum = 0.9`` and the batch's biased
variance, written through ``set_value`` (torch's rule weighs the other
way and uses the unbiased variance).  ``SyncBatchNorm`` is BatchNorm on
one card, as the JAX one is on one chip.
"""

import numpy as np
import torch

from ..core.tensor import Tensor
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


class RMSNorm(Layer):
    """``y = x * rsqrt(mean(x ** 2) + epsilon) * weight`` over the last
    dim, with ``weight`` [hidden_size] initialised to ones (the JAX
    package's Layer, beyond the reference surface)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter((hidden_size,), attr=weight_attr,
                                            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                              is_bias=True)
        self.register_buffer("_mean",
                             Tensor(np.zeros(num_features, np.float32)))
        self.register_buffer("_variance",
                             Tensor(np.ones(num_features, np.float32)))

    def forward(self, x):
        training = self.training and not self.use_global_stats
        out, batch_mean, batch_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format,
            use_global_stats=self.use_global_stats)
        if training:
            m = self.momentum
            self._mean.set_value(m * self._mean._data +
                                 (1 - m) * batch_mean._data)
            self._variance.set_value(m * self._variance._data +
                                     (1 - m) * batch_var._data)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """Legacy fluid BatchNorm API shim."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 **kwargs):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon)
        self.act = act

    def forward(self, x):
        out = super().forward(x)
        if self.act == "relu":
            out = F.relu(out)
        return out


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm with the reference's API; on one card its statistics
    are the card's batch, as the JAX one's are on one chip (reference
    python/paddle/nn/layer/norm.py SyncBatchNorm)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format)
            new.weight = layer.weight
            new.bias = layer.bias
            new._buffers = layer._buffers
            return new
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            (num_channels,), attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight, self.bias = None, None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter((num_features,), attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW"):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """Spectral normalization: divide a weight by its largest singular
    value, estimated by persistent power iteration (reference
    python/paddle/nn/layer/norm.py SpectralNorm).

    ``forward(weight)`` reshapes the weight so ``dim`` leads ([H, W],
    W the product of the rest), runs ``power_iters`` u/v updates against
    the persistent buffers ``weight_u`` / ``weight_v`` outside autograd,
    and returns ``weight / sigma``.  The buffers start as normal draws
    of the global generator, normalised (the JAX package draws from its
    key stream, so the two agree on the distribution only)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        from ..framework.device import current_device
        from ..framework.random import generator

        self.dim = int(dim)
        self.power_iters = int(power_iters)
        self.eps = float(eps)
        self._shape = list(weight_shape)
        h = int(weight_shape[self.dim])
        w = int(np.prod([d for i, d in enumerate(weight_shape)
                         if i != self.dim]))
        dev = current_device()
        gen = generator(dev)
        u = torch.randn(h, generator=gen, device=dev)
        v = torch.randn(w, generator=gen, device=dev)
        self.register_buffer("weight_u", Tensor(
            u / torch.clamp(torch.linalg.vector_norm(u), min=self.eps)))
        self.register_buffer("weight_v", Tensor(
            v / torch.clamp(torch.linalg.vector_norm(v), min=self.eps)))

    def forward(self, weight):
        from ..ops.dispatch import apply_op

        w_t = weight if isinstance(weight, Tensor) else Tensor(weight)
        x = w_t._data
        perm = [self.dim] + [i for i in range(x.dim()) if i != self.dim]
        u = self._buffers["weight_u"]._data
        v = self._buffers["weight_v"]._data
        with torch.no_grad():
            m = x.permute(perm).reshape(x.shape[self.dim], -1).float()
            for _ in range(self.power_iters):
                v = m.T @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=self.eps)
                u = m @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=self.eps)
        self._buffers["weight_u"].set_value(u)
        self._buffers["weight_v"].set_value(v)

        def fn(wd):
            md = wd.permute(perm).reshape(wd.shape[self.dim], -1).float()
            sigma = u @ md @ v
            return (wd.float() / torch.clamp(sigma, min=self.eps)).to(
                wd.dtype)

        return apply_op("spectral_norm", fn, (w_t,), {})
