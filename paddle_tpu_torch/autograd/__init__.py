"""Autograd package: ``backward``, ``paddle.grad``, ``no_grad``,
``PyLayer``.

Port of ``paddle_tpu/autograd`` (``tape.py`` + ``py_layer.py``).  The
JAX package records its own tape of GradNodes; the port has none of its
own: ``backward`` and ``grad`` are ``torch.autograd.backward`` and
``torch.autograd.grad`` over the Tensors' ``_data``, and
``create_graph=True`` keeps torch's graph of the gradients, so they are
differentiable again.
"""

import torch

from ..core.tensor import Tensor, _wrap
from ..framework.mode import (  # noqa: F401
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)


def _as_list(x):
    return [x] if isinstance(x, Tensor) or x is None else list(x)


def _cotangent(t, g):
    if g is None:
        return None
    if isinstance(g, Tensor):
        return g._data
    return torch.as_tensor(g, dtype=t._data.dtype, device=t._data.device)


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False):
    """Reverse accumulation from ``tensors`` into every leaf's ``grad``
    (parity: ``egr::Backward``).  A non-scalar tensor needs its
    ``grad_tensors`` entry; tensors with ``stop_gradient`` are skipped."""
    tensors = _as_list(tensors)
    grads = [None] * len(tensors) if grad_tensors is None \
        else _as_list(grad_tensors)
    roots, cots = [], []
    for t, g in zip(tensors, grads):
        if t.stop_gradient:
            continue
        if g is None and t.size != 1:
            raise RuntimeError(
                f"grad can be implicitly created only for scalar outputs, "
                f"got shape {t.shape}")
        roots.append(t._data)
        cots.append(torch.ones_like(t._data) if g is None
                    else _cotangent(t, g))
    if roots:
        torch.autograd.backward(roots, cots, retain_graph=retain_graph
                                or create_graph, create_graph=create_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """``paddle.grad`` parity: gradients of ``outputs`` with respect to
    ``inputs`` without touching any ``grad``.  With ``create_graph=True``
    the results carry their own graph (higher-order gradients)."""
    single_in = isinstance(inputs, Tensor)
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    gos = [None] * len(outputs) if grad_outputs is None \
        else _as_list(grad_outputs)
    outs, cots = [], []
    for t, g in zip(outputs, gos):
        if g is None and t.size != 1:
            raise RuntimeError(
                f"grad can be implicitly created only for scalar outputs, "
                f"got shape {t.shape}")
        outs.append(t._data)
        cots.append(torch.ones_like(t._data) if g is None
                    else _cotangent(t, g))
    try:
        res = torch.autograd.grad(
            outs, [t._data for t in inputs], cots,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
    except RuntimeError as e:
        if "does not require grad" in str(e) and not allow_unused:
            raise RuntimeError(
                "One of the differentiated tensors appears unused; pass "
                "allow_unused=True to return None for it.") from e
        raise
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError(
            "One of the differentiated tensors appears unused; pass "
            "allow_unused=True to return None for it.")
    results = [None if g is None else _wrap(g if create_graph
                                            else g.detach())
               for g in res]
    return results[0] if single_in else results


from .py_layer import PyLayer, PyLayerContext  # noqa: F401, E402
