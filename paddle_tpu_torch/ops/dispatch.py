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
no counterpart: PyTorch runs eagerly, so there is nothing to compile or
cache.  Its public switches keep their signatures with nothing behind
them: ``enable_dispatch_cache`` records the flag, ``dispatch_cache_info``
reports an empty cache (0 entries, 0 compiled) and
``dispatch_cache_clear`` has nothing to clear.  ``set_debug_hook``
installs the ``amp.debugging`` per-op hook, called as in the JAX
dispatch with the op's name and its flattened tensor outputs; while one
is installed it also sees the calls with no Tensor (the raw path), so a
tensor checker covers GPT's and ``TrainStep``'s ops.  While a
``profiler.Profiler`` records, every call (either path) adds a host
event with the op's name and wall time, as the JAX dispatch does for its
calls; otherwise the profiler costs one thread-local read a call.
"""

import time

import torch

from ..amp import _state as _amp_state
from ..amp import cast_target, cast_to
from ..core.tensor import Tensor, _wrap
from ..framework.flags import _flags
from ..profiler import _events as _profiler_events
from ..profiler import record_host_event


_debug_hook = None
_dispatch_cache_enabled = True


def set_debug_hook(fn):
    """Install (or, with None, remove) the per-op output hook."""
    global _debug_hook
    _debug_hook = fn


def enable_dispatch_cache(flag=True):
    """Record the cache switch; eager torch has no compile to cache."""
    global _dispatch_cache_enabled
    _dispatch_cache_enabled = bool(flag)


def dispatch_cache_clear():
    """Nothing to clear: no op is compiled."""


def dispatch_cache_info():
    """The cache's counts: always empty, since no op is compiled."""
    return {"entries": 0, "compiled": 0}


def _leaves(o):
    if isinstance(o, torch.Tensor):
        return [o]
    if isinstance(o, (list, tuple)):
        return [t for e in o for t in _leaves(e)]
    return []


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
    timing = _profiler_events.active
    if not found:
        if _debug_hook is None and not timing:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if timing:
            record_host_event(name, t0, time.perf_counter() - t0)
        if _debug_hook is not None:
            _debug_hook(name, _leaves(out))
        return out
    t0 = time.perf_counter() if timing else 0.0
    if _amp_state.enabled:
        target = cast_target(name)
        if target is not None:
            targs = [_unwrap_cast(a, target) for a in args]
            tkw = {k: _unwrap_cast(v, target) for k, v in kwargs.items()}
    out = fn(*targs, **tkw)
    if timing:
        record_host_event(name, t0, time.perf_counter() - t0)
    if _debug_hook is not None:
        _debug_hook(name, _leaves(out))
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
