"""paddle.incubate.autograd (port of ``paddle_tpu/incubate/autograd``) —
functional higher-order autodiff.

Reference: python/paddle/incubate/autograd/ (primapi.py ``forward_grad``/
``grad``, functional.py ``jvp``/``vjp``/``Jacobian``/``Hessian``).  The
JAX package wraps jax's transforms; the port wraps ``torch.func``'s:
Tensors at the boundary, ``torch.func.jvp`` / ``vjp`` / ``grad`` /
``jacrev`` / ``hessian`` inside, the user's function called on Tensors
over the transforms' tensors (so every op it calls dispatches as usual).
Plain inputs become tensors as ``jnp.asarray`` makes them (float64
narrowed to float32).  ``enable_prim`` / ``disable_prim`` /
``prim_enabled`` keep the JAX contract: a flag with nothing behind it,
since every op already differentiates through its own definition.
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from ...core.tensor import Tensor, _wrap as _wrap_one
from ...framework.device import current_device

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "grad", "forward_grad",
           "enable_prim", "disable_prim", "prim_enabled"]

_is_tensor = lambda v: isinstance(v, Tensor)  # noqa: E731


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=current_device())


def _wrap(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return _wrap_one(x.detach())


def _functional(func):
    """Adapt a Tensor-in/Tensor-out function to raw torch tensors."""

    def fn(*arrays):
        out = func(*(_wrap_one(a) for a in arrays))
        return pytree.tree_map(
            lambda t: t._data if isinstance(t, Tensor)
            else torch.as_tensor(t), out, is_leaf=_is_tensor)

    return fn


def _as_tuple(xs):
    if isinstance(xs, (list, tuple)):
        return tuple(xs), True
    return (xs,), False


def _total(out):
    """The sum of every leaf's sum (a scalar function of the inputs)."""
    return sum(torch.sum(leaf) for leaf in pytree.tree_leaves(out))


def jvp(func, xs, v=None):
    """Forward-mode: returns (func(xs), J @ v).  v defaults to ones."""
    xs_t, _ = _as_tuple(xs)
    primals = tuple(_unwrap(x) for x in xs_t)
    if v is None:
        tangents = tuple(torch.ones_like(p) for p in primals)
    else:
        v_t, _ = _as_tuple(v)
        tangents = tuple(_unwrap(t) for t in v_t)
    out, tan = torch.func.jvp(_functional(func), primals, tangents)
    return _wrap(out), _wrap(tan)


def vjp(func, xs, v=None):
    """Reverse-mode: returns (func(xs), v^T @ J).  v defaults to ones."""
    xs_t, multi = _as_tuple(xs)
    primals = tuple(_unwrap(x) for x in xs_t)
    out, pull = torch.func.vjp(_functional(func), *primals)
    if v is None:
        cot = pytree.tree_map(torch.ones_like, out)
    else:
        cot = pytree.tree_map(_unwrap, v, is_leaf=_is_tensor)
    grads = pull(cot)
    grads = _wrap(list(grads)) if multi else _wrap(grads[0])
    return _wrap(out), grads


def grad(outputs=None, inputs=None, grad_outputs=None, func=None, xs=None):
    """Functional gradient.  Two call forms:

    - ``grad(func, xs)`` (primapi.py:grad): returns d func / d xs.
    - ``grad(outputs, inputs, grad_outputs)``: the eager form, delegating
      to ``paddle_tpu_torch.autograd.grad`` with create_graph=True.
    """
    if callable(outputs):
        func, xs = outputs, inputs
        xs_t, multi = _as_tuple(xs)
        primals = tuple(_unwrap(x) for x in xs_t)
        fn = _functional(func)
        gs = torch.func.grad(lambda *a: _total(fn(*a)),
                             argnums=tuple(range(len(primals))))(*primals)
        return _wrap(list(gs)) if multi else _wrap(gs[0])
    from ...autograd import grad as eager_grad
    return eager_grad(outputs, inputs, grad_outputs=grad_outputs,
                      create_graph=True)


def forward_grad(func, xs, v=None):
    """primapi.forward_grad parity: forward-mode derivative of func at xs."""
    return jvp(func, xs, v)[1]


class Jacobian:
    """Lazy Jacobian (reference functional.py Jacobian): index or
    materialize with ``[:]``."""

    def __init__(self, func, xs, is_batched=False):
        xs_t, self._multi = _as_tuple(xs)
        self._primals = tuple(_unwrap(x) for x in xs_t)
        self._fn = _functional(func)
        self._batched = is_batched
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            jac = torch.func.jacrev(self._fn, argnums=tuple(
                range(len(self._primals))))(*self._primals)
            if not self._multi:
                jac = jac[0] if isinstance(jac, tuple) else jac
            out_leaves = pytree.tree_leaves(jac)
            self._mat = out_leaves[0] if len(out_leaves) == 1 else jac
        return self._mat

    def __getitem__(self, idx):
        m = self._materialize()
        if isinstance(m, (tuple, list)):
            return _wrap([x[idx] for x in m])
        arr = m
        if not self._batched and arr.dim() >= 2:
            arr = arr.reshape(int(np.prod(arr.shape[:arr.dim() // 2])), -1)
        return _wrap(arr[idx])

    @property
    def shape(self):
        m = self._materialize()
        arr = m if not isinstance(m, (tuple, list)) else m[0]
        return list(arr.shape)


class Hessian:
    """Lazy Hessian of a scalar function (reference functional.py)."""

    def __init__(self, func, xs, is_batched=False):
        xs_t, self._multi = _as_tuple(xs)
        self._primals = tuple(_unwrap(x) for x in xs_t)
        fn = _functional(func)
        self._scalar_fn = lambda *arrays: _total(fn(*arrays))
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            n_in = len(self._primals)
            argnums = tuple(range(n_in))
            # argnums as a tuple gives nested tuples h[i][j] even for a
            # single input — uniform block assembly below
            h = torch.func.hessian(self._scalar_fn, argnums=argnums)(
                *self._primals)
            sizes = [int(np.prod(p.shape)) for p in self._primals]
            # full block Hessian over concatenated flattened inputs
            # (reference functional.Hessian semantics)
            self._mat = torch.cat(
                [torch.cat([h[i][j].reshape(sizes[i], sizes[j])
                            for j in range(n_in)], dim=1)
                 for i in range(n_in)], dim=0)
        return self._mat

    def __getitem__(self, idx):
        return _wrap(self._materialize()[idx])

    @property
    def shape(self):
        return list(self._materialize().shape)


# prim-mode toggles: every op already differentiates through its own
# definition, so these keep the flag for API parity with
# python/paddle/incubate/autograd/primx.py.
_PRIM = {"enabled": False}


def enable_prim():
    _PRIM["enabled"] = True


def disable_prim():
    _PRIM["enabled"] = False


def prim_enabled():
    return _PRIM["enabled"]
