"""Device prefetch — overlap the host-to-device copy with the step.

Port of ``paddle_tpu/io/device_prefetch.py``.  Each batch is staged
``size`` batches ahead: its host arrays and Tensors are copied into
pinned memory and sent to the card with ``non_blocking`` copies on a
side stream, and the consumer's stream waits for that copy only when
the batch is handed out, so the copy runs while the previous step
computes.
"""

import collections
import contextlib

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.device import resolve_device

__all__ = ["prefetch_to_device"]


def _tree_map(fn, obj):
    if isinstance(obj, Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_tree_map(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


def _stage(batch, device, stream):
    """Start the host->device copies of every array in the batch ->
    (the staged batch, its torch tensors, the copies' event)."""
    moved = []

    def send(t):
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out = t.to(device, non_blocking=True)
        moved.append(out)
        return out

    def put(x):
        if isinstance(x, Tensor):
            out = _wrap(send(x._data.detach()))
            if not x.stop_gradient:
                out._data.requires_grad_(True)
            return out
        # only array-like leaves transfer; other payloads pass through
        # untouched (a failing copy of a REAL array raises, it never
        # silently stays host-resident)
        if isinstance(x, (np.ndarray, torch.Tensor, int, float, complex,
                          np.generic)):
            return send(torch.as_tensor(x))
        return x

    ctx = torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()
    with ctx:
        staged = _tree_map(put, batch)
    event = stream.record_event() if stream is not None else None
    return staged, moved, event


def _hand_out(entry, device):
    staged, moved, event = entry
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in moved:   # the side stream's memory is now the step's
            t.record_stream(current)
    return staged


def prefetch_to_device(loader, size=2, device=None):
    """Wrap any batch iterable so batches arrive already on the device.

    ``size`` batches are kept in flight (2 = double buffering).
    ``device=None`` is the CUDA device, and raises when no GPU is
    visible; name ``"cpu"`` to stage on the host.

    >>> for x, y in prefetch_to_device(loader, size=2):
    ...     loss = train_step(x, y)   # the next batch's copy overlaps
    """
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue = collections.deque()
    it = iter(loader)
    try:
        while True:
            while len(queue) < size:
                queue.append(_stage(next(it), device, stream))
            yield _hand_out(queue.popleft(), device)
    except StopIteration:
        while queue:
            yield _hand_out(queue.popleft(), device)
