"""Activation layers (port of ``paddle_tpu/nn/activation.py``)."""

from . import functional as F
from .initializer import Constant
from .layer_base import Layer


def _simple(fname, **fixed):
    class _Act(Layer):
        def __init__(self, name=None, **kw):
            super().__init__()
            self._kw = {**fixed, **kw}

        def forward(self, x):
            return getattr(F, fname)(x, **self._kw)

    _Act.__name__ = fname.title().replace("_", "")
    return _Act


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        from ..ops.registry import OPS
        return OPS["sigmoid"].user_fn(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        from ..ops.registry import OPS
        return OPS["tanh"].user_fn(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


ReLU6 = _simple("relu6")
ELU = _simple("elu")
SELU = _simple("selu")
CELU = _simple("celu")
Silu = _simple("silu")
SiLU = Silu
Swish = _simple("swish")
Mish = _simple("mish")
Softplus = _simple("softplus")
Softshrink = _simple("softshrink")
Hardshrink = _simple("hardshrink")
Tanhshrink = _simple("tanhshrink")
Hardtanh = _simple("hardtanh")
Hardsigmoid = _simple("hardsigmoid")
Hardswish = _simple("hardswish")
Softsign = _simple("softsign")
LogSigmoid = _simple("log_sigmoid")
Maxout = _simple("maxout", groups=2)
