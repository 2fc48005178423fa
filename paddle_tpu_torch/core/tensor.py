"""Eager Tensor: a handle over one ``torch.Tensor`` with Paddle's API.

Port of ``paddle_tpu/core/tensor.py``, where a Tensor is a handle over a
``jax.Array`` plus the JAX package's own tape metadata.  Here the handle
holds one ``torch.Tensor`` (``_data``) and torch autograd is the tape:
``stop_gradient`` is the inverse of ``_data.requires_grad``, ``grad`` is
``_data.grad`` of a leaf, and ``backward`` / ``register_hook`` go to
torch.

In-place writes (``set_value``, ``copy_``, ``zero_``, ``fill_``,
``__setitem__``) rebind ``_data`` to an out-of-place result, as the JAX
package's do, and record nothing: a leaf that requires grad stays a
leaf (its ``grad`` carried over), and a value with a graph keeps its old
value's graph, so a gradient through a ``__setitem__`` reaches what the
old value was computed from, unmasked, and the written value gets none
(the JAX package's behaviour, kept).

Most operator methods are patched onto this class by
``paddle_tpu_torch.ops``, from the op registry.
"""

import copy

import numpy as np
import torch

from ..framework import mode
from ..framework.device import Place, _torch_device, current_device, place_of
from ..framework.dtype import convert_dtype, dtype_name, get_default_dtype


def _host_to_torch(data, dtype, device):
    """numpy-convertible host data -> a new torch tensor on ``device``."""
    arr = np.asarray(data)
    if arr.dtype.name not in ("bool", "uint8", "int8", "int16", "int32",
                              "int64", "float16", "float32", "float64",
                              "complex64", "complex128"):
        raise TypeError(
            f"host data of dtype {arr.dtype} has no torch counterpart "
            f"(a bfloat16 array needs ml_dtypes; cast it to float32)")
    out = torch.tensor(arr, device=device)
    return out if dtype is None else out.to(dtype)


class Tensor:
    __slots__ = ("_data", "name", "persistable", "trainable", "__weakref__")

    def __init__(self, data, dtype=None, stop_gradient=True, name=None,
                 place=None):
        if isinstance(data, Tensor):
            data = data._data
        dtype = convert_dtype(dtype)
        if isinstance(data, torch.Tensor):
            data = data.detach()
            if dtype is not None and data.dtype != dtype:
                data = data.to(dtype)
            if place is not None:
                data = data.to(_torch_device(place))
        else:
            if dtype is None and isinstance(data, (bool, int, float, list,
                                                   tuple)):
                if np.asarray(data).dtype == np.float64:
                    dtype = get_default_dtype()
            device = current_device() if place is None \
                else _torch_device(place)
            data = _host_to_torch(data, dtype, device)
        if not stop_gradient and (data.is_floating_point()
                                  or data.is_complex()):
            data.requires_grad_(True)
        self._data = data
        self.name = name
        self.persistable = False
        self.trainable = not stop_gradient

    def __reduce__(self):
        # pickle as host data (autograd state dropped), the JAX package's
        # payload; extra attributes of a subclass (Parameter) ride along
        extras = dict(getattr(self, "__dict__", {}) or {})
        return (_tensor_from_pickle,
                (type(self), self.numpy(), self.stop_gradient, self.name,
                 self.persistable, extras))

    def __deepcopy__(self, memo):
        """A new leaf on the same device, same dtype and stop_gradient
        (what the pickle payload round trip gives, without the host)."""
        out = type(self).__new__(type(self))
        out._data = self._data.detach().clone().requires_grad_(
            self._data.requires_grad)
        out.name, out.persistable = self.name, self.persistable
        out.trainable = self.trainable
        for k, v in getattr(self, "__dict__", {}).items():
            setattr(out, k, copy.deepcopy(v, memo))
        return out

    # ---- autograd state ----
    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        if value:
            if d.requires_grad:
                self._data = d.detach() if d.grad_fn is not None \
                    else d.requires_grad_(False)
        elif not d.requires_grad and (d.is_floating_point()
                                      or d.is_complex()):
            if d.grad_fn is None:
                d.requires_grad_(True)

    @property
    def grad(self):
        d = self._data
        if d.grad_fn is not None or d.grad is None:
            return None
        return _wrap(d.grad)

    @grad.setter
    def grad(self, value):
        self._data.grad = value._data if isinstance(value, Tensor) else value

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    # ---- metadata ----
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self):
        return place_of(self._data.device)

    def numel(self):
        return self.size

    def dim(self):
        return self.ndim

    # ---- conversion ----
    def numpy(self):
        """A numpy copy of the value: the optimizers update parameters in
        place, so a view would change under the caller (a JAX array
        never does)."""
        _trace_guard(self)
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: cast the Tensor to "
                            "float32 first (astype)")
        return d.cpu().numpy().copy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self._data.tolist()

    def __array__(self, dtype=None, copy=None):
        """The host copy numpy asks for; bfloat16, which numpy lacks,
        comes as float32 (exact)."""
        d = self._data.detach()
        arr = (d.float() if d.dtype == torch.bfloat16 else d).cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        _trace_guard(self)
        return float(self.item())

    def __int__(self):
        _trace_guard(self)
        return int(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of a multi-element Tensor is ambiguous")
        _trace_guard(self)
        return bool(self._data.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_txt = "" if self.stop_gradient else ", stop_gradient=False"
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        body = np.array2string(d.cpu().numpy(), prefix="       ")
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}"
                f"{grad_txt},\n       {body})")

    # ---- autograd ----
    def backward(self, grad_tensor=None, retain_graph=False,
                 create_graph=False):
        from ..autograd import backward as _backward
        _backward([self], [grad_tensor], retain_graph=retain_graph,
                  create_graph=create_graph)

    def register_hook(self, hook):
        """``hook(grad) -> new grad or None``, run when the gradient of
        this tensor is computed (before a leaf accumulates it); returns
        a handle with ``remove()``."""

        def on_grad(g):
            out = hook(_wrap(g))
            if out is None:
                return None
            return out._data if isinstance(out, Tensor) else \
                torch.as_tensor(out, dtype=g.dtype, device=g.device)

        return self._data.register_hook(on_grad)

    def detach(self):
        t = _wrap(self._data.detach())
        t.name = self.name
        return t

    def detach_(self):
        self._data = self._data.detach()
        return self

    def clone(self):
        from ..ops.dispatch import apply_op
        return apply_op("clone", torch.clone, (self,), {})

    def clear_grad(self):
        self._data.grad = None

    def clear_gradient(self, set_to_zero=False):
        if set_to_zero and self._data.grad is not None:
            self._data.grad = torch.zeros_like(self._data.grad)
        else:
            self._data.grad = None

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    # ---- in-place writes: rebinds, recording nothing (module docstring) ----
    def _rebind_value(self, new):
        """Make ``new`` (a tensor without a graph, the same shape, dtype
        and device) this Tensor's value."""
        old = self._data
        if old.requires_grad:
            if old.grad_fn is None:
                new.requires_grad_(True)
                new.grad = old.grad
            else:
                new = _KeepGraph.apply(old, new)
        self._data = new
        return self

    def set_value(self, value):
        old = self._data
        if isinstance(value, Tensor):
            value = value._data
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                new = value.detach().to(device=old.device, dtype=old.dtype,
                                        copy=True)
            else:
                new = _host_to_torch(value, old.dtype, old.device)
        return self._rebind_value(new)

    def copy_(self, other):
        return self.set_value(other)

    def zero_(self):
        return self._rebind_value(torch.zeros_like(self._data.detach()))

    def fill_(self, value):
        return self._rebind_value(torch.full_like(self._data.detach(),
                                                  value))

    def _rebind(self, data):
        """Internal: replace ``_data`` outright."""
        self._data = data
        return self

    # ---- placement / dtype ----
    def astype(self, dtype):
        from ..ops.dispatch import apply_op
        d = convert_dtype(dtype)
        return apply_op("cast", lambda x: x.to(d), (self,), {})

    def cast(self, dtype):
        return self.astype(dtype)

    def _moved(self, device):
        """A new leaf on ``device`` with this Tensor's stop_gradient (a
        move records nothing, as a JAX ``device_put`` does)."""
        return Tensor(self._data.detach().to(device),
                      stop_gradient=self.stop_gradient)

    def to(self, *args, **kwargs):
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (torch.device, Place)) or (
                    isinstance(a, str) and a.startswith(
                        ("cpu", "gpu", "tpu", "cuda", "xpu"))):
                out = out._moved(_torch_device(a))
            elif a is not None:
                out = out.astype(a)
        return out

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        return self._moved(torch.device("cuda", device_id or 0))

    def pin_memory(self):
        return self

    # ---- indexing ----
    def __getitem__(self, idx):
        from ..ops.dispatch import apply_op
        idx = _unwrap_index(idx)
        return apply_op("getitem", lambda x: x[idx], (self,), {})

    def __setitem__(self, idx, value):
        idx = _unwrap_index(idx)
        value = value._data if isinstance(value, Tensor) else value
        with torch.no_grad():
            new = self._data.detach().clone()
            if isinstance(value, torch.Tensor):
                value = value.to(device=new.device, dtype=new.dtype)
            new[idx] = value
        self._rebind_value(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @property
    def T(self):
        from ..ops.dispatch import apply_op
        return apply_op("t", lambda x: x.permute(*range(x.dim() - 1, -1,
                                                        -1)), (self,), {})

    def __hash__(self):
        return id(self)


class _KeepGraph(torch.autograd.Function):
    """Forward: the new value; backward: the cotangent, unchanged, to the
    old value's graph (an in-place write records nothing)."""

    @staticmethod
    def forward(ctx, old, new):
        return new.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _trace_guard(t):
    """Data-dependent Python control flow inside ``jit.to_static``: the
    value is traced, so a host read would bake one branch into the
    graph.  Raises the JAX package's TypeError (dy2static converts the
    ``if``/``while`` statements it can)."""
    if mode.is_traced(t):
        raise TypeError(mode.TRACE_GUARD_MESSAGE)


def _wrap(t):
    """A Tensor over the torch tensor ``t`` as it is (graph kept): the
    op dispatcher's fast constructor."""
    out = Tensor.__new__(Tensor)
    out._data = t
    out.name = None
    out.persistable = False
    out.trainable = t.requires_grad
    return out


def _unwrap_index(idx):
    if isinstance(idx, Tensor):
        return idx._data
    if isinstance(idx, tuple):
        return tuple(_unwrap_index(i) for i in idx)
    if isinstance(idx, list) and any(isinstance(i, Tensor) for i in idx):
        return [_unwrap_index(i) for i in idx]
    return idx


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor`` parity: a new leaf on ``place`` (default: the
    current device)."""
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)


def _tensor_from_pickle(cls, data, stop_gradient, name, persistable, extras):
    t = cls.__new__(cls)
    Tensor.__init__(t, data, stop_gradient=stop_gradient, name=name)
    for k, v in extras.items():
        setattr(t, k, v)
    t.persistable = persistable
    return t
