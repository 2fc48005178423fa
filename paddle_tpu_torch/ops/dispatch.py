"""Eager op dispatch: one generic mechanism for every registered op.

Port of ``paddle_tpu/ops/dispatch.py``.  An op body is written on torch
tensors; :func:`apply_op` unwraps every ``Tensor`` among the call's
arguments (top level, and inside a list or tuple argument), runs the
body and wraps its outputs, each with ``stop_gradient = not
requires_grad``.  torch autograd records the body as it runs, so there
is no GradNode of the port's own.

A call with no ``Tensor`` in it runs the body on its arguments as they
are: raw torch tensors in, raw torch tensors out.  The port's GPT, its
engine and ``TrainStep`` call ``nn/functional.py`` that way and pay one
scan of the arguments.

Under ``amp.auto_cast`` the floating Tensor inputs of a call are cast
by the AMP policy before the body runs (``amp.cast_target``), as the
JAX dispatch applies ``amp_cast_inputs`` (``paddle_tpu/ops/dispatch.py:
154-155``); raw torch tensors in a call are not, and a call with no
Tensor is never cast.

The JAX package's per-signature jit cache (``dispatch.py:72-135``) has
no counterpart: PyTorch runs eagerly.
"""

import torch

from ..amp import _state as _amp_state
from ..amp import cast_target, cast_to
from ..core.tensor import Tensor, _wrap
from ..framework.flags import _flags


def _unwrap(v):
    """(v with its Tensors replaced by their data, whether it held one)."""
    if isinstance(v, Tensor):
        return v._data, True
    if isinstance(v, (list, tuple)) and any(isinstance(e, Tensor)
                                            for e in v):
        return [e._data if isinstance(e, Tensor) else e for e in v], True
    return v, False


def _unwrap_cast(v, target):
    """``_unwrap`` with each Tensor's data cast to ``target``."""
    if isinstance(v, Tensor):
        return cast_to(v._data, target)
    if isinstance(v, (list, tuple)) and any(isinstance(e, Tensor)
                                            for e in v):
        return [cast_to(e._data, target) if isinstance(e, Tensor) else e
                for e in v]
    return v


def _wrap_out(o):
    if isinstance(o, torch.Tensor):
        return _wrap(o)
    if isinstance(o, list):
        return [_wrap_out(e) for e in o]
    if isinstance(o, tuple):
        return tuple(_wrap_out(e) for e in o)
    return o


def apply_op(name, fn, args, kwargs):
    """Run ``fn`` (a body on torch tensors) over ``args``/``kwargs`` with
    every Tensor unwrapped, and wrap its outputs; a call holding no
    Tensor returns ``fn(*args, **kwargs)`` untouched."""
    found = False
    targs = []
    for a in args:
        a, hit = _unwrap(a)
        targs.append(a)
        found |= hit
    tkw = kwargs
    if kwargs:
        tkw = {}
        for k, v in kwargs.items():
            tkw[k], hit = _unwrap(v)
            found |= hit
    if not found:
        return fn(*args, **kwargs)
    if _amp_state.enabled:
        target = cast_target(name)
        if target is not None:
            targs = [_unwrap_cast(a, target) for a in args]
            tkw = {k: _unwrap_cast(v, target) for k, v in kwargs.items()}
    out = fn(*targs, **tkw)
    if _flags["FLAGS_check_nan_inf"]:
        _check_nan_inf(name, out)
    return _wrap_out(out)


def _check_nan_inf(name, out):
    """FLAGS_check_nan_inf parity: a differentiable output with a NaN or
    an Inf raises (one host read an output)."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        if (isinstance(o, torch.Tensor) and o.requires_grad
                and not bool(torch.isfinite(o).all())):  # noqa: H001 (debug flag, off by default)
            raise FloatingPointError(
                f"NaN or Inf detected in output of op '{name}'")
