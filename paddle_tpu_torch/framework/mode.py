"""Execution / grad modes.

Port of ``paddle_tpu/framework/mode.py``.  The grad mode is torch's own
(thread-local, as the JAX package's is): ``no_grad`` and
``set_grad_enabled`` switch what torch autograd records.
``in_dynamic_mode`` is always True.
"""

import contextlib
import functools

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
