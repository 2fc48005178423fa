"""PyLayer: user-defined forward/backward (paddle.autograd.PyLayer parity).

Port of ``paddle_tpu/autograd/py_layer.py``.  The user's static
``forward`` runs with autograd off on the Tensor arguments, as there;
recording goes through one ``torch.autograd.Function`` whose backward
calls the user's ``backward`` with the output gradients as Tensors and
hands back one gradient per Tensor input (None gives zeros, as the JAX
tape fills them).
"""

import torch

from ..core.tensor import Tensor, _wrap


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Apply(torch.autograd.Function):
    """Inputs: the layer class, its context, ``(args, kwargs, the Tensor
    inputs with their places, a dict that receives the output's
    structure)``, then the Tensor inputs' data."""

    @staticmethod
    def forward(ctx, cls, pctx, call, *datas):
        args, kwargs, slots, structure = call
        out = cls.forward(pctx, *args, **kwargs)
        single = isinstance(out, Tensor)
        outs = [out] if single else list(out)
        ctx.layer, ctx.pctx, ctx.inputs = cls, pctx, [t for t, _ in slots]
        structure.update(single=single, type=type(out))
        datas_out = tuple(t._data for t in outs)
        ctx.mark_non_differentiable(*(d for d in datas_out
                                      if not (d.is_floating_point()
                                              or d.is_complex())))
        return datas_out

    @staticmethod
    def backward(ctx, *grads):
        gin = ctx.layer.backward(ctx.pctx, *(_wrap(g) for g in grads))
        if isinstance(gin, Tensor) or gin is None:
            gin = (gin,)
        out = []
        for t, g in zip(ctx.inputs, gin):
            if g is None:
                g = torch.zeros_like(t._data)
            out.append(g._data if isinstance(g, Tensor) else g)
        return (None, None, None, *out)


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        slots = [(a, i) for i, a in enumerate(args) if isinstance(a, Tensor)]
        slots += [(v, k) for k, v in kwargs.items() if isinstance(v, Tensor)]
        structure = {}
        outs = _Apply.apply(cls, ctx, (args, kwargs, slots, structure),
                            *(t._data for t, _ in slots))
        wrapped = [_wrap(o) for o in outs]
        if structure["single"]:
            return wrapped[0]
        if structure["type"] in (list, tuple):
            return structure["type"](wrapped)
        return wrapped
