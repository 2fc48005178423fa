"""Execution / grad modes.

Port of ``paddle_tpu/framework/mode.py``.  The grad mode is torch's own
(thread-local, as the JAX package's is): ``no_grad`` and
``set_grad_enabled`` switch what torch autograd records.
``in_dynamic_mode`` is always True.  ``tracing`` marks a ``jit.to_static``
trace (``in_trace`` / ``is_traced``).
"""

import contextlib
import functools
import threading

import torch


def is_grad_enabled():
    return torch.is_grad_enabled()


def set_grad_enabled(enabled):
    torch.set_grad_enabled(bool(enabled))


@contextlib.contextmanager
def grad_enabled(enabled):
    with torch.set_grad_enabled(bool(enabled)):
        yield


class no_grad:
    """Context manager & decorator disabling autograd recording."""

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(False)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)

        return wrapper


def in_dynamic_mode():
    return True


# --------------------------------------------------------------- trace --
# ``jit.to_static`` traces a function once per input signature into an
# FX graph (``make_fx`` over fake tensors).  While it does, every tensor
# the function sees is a traced value, as every array under ``jax.jit``
# is a tracer: ``in_trace()`` is the port's ``isinstance(x, Tracer)``.
_trace_state = threading.local()

TRACE_GUARD_MESSAGE = (
    "Tensor used as a Python bool inside a to_static/jit trace. "
    "Data-dependent control flow cannot be traced: replace "
    "`if`/`while` on tensor values with paddle_tpu.where / "
    "lax.cond-style ops, or move the branch outside the "
    "compiled function.")


def in_trace():
    """Whether a ``to_static`` trace is running on this thread."""
    return getattr(_trace_state, "depth", 0) > 0


def is_traced(x):
    """Whether ``x`` (a Tensor or a torch tensor) is a traced value."""
    data = getattr(x, "_data", x)
    return in_trace() and isinstance(data, torch.Tensor)


@contextlib.contextmanager
def tracing():
    """Mark the body as a ``to_static`` trace on this thread."""
    _trace_state.depth = getattr(_trace_state, "depth", 0) + 1
    try:
        yield
    finally:
        _trace_state.depth -= 1
