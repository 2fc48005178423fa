"""ASP — automatic 2:4 structured sparsity (port of
``paddle_tpu/incubate/asp.py``; reference python/paddle/incubate/asp/:
prune_model computes n:m masks, decorate() wraps the optimizer so masks
re-apply after every step).

The masks are the JAX module's, computed on the host with numpy: keep
the n largest |w| of every group of m along the reduced (last) axis.
The port's parameters are updated in place, so pruning and re-applying
multiply them by the mask on their device, in place.  Hopper's sparse
tensor cores could run a 2:4 matrix faster; nothing here asks them to:
the value is the pruned model and its masks, as in the JAX package.
"""

import weakref

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["calculate_density", "create_mask", "prune_model", "decorate",
           "ASPHelper"]


def _host(x):
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def create_mask(weight, n=2, m=4):
    """n:m mask along the last axis: keep the n largest |w| per group of m.

    Matches reference asp/utils.py get_mask_1d semantics.
    """
    w = _host(weight)
    orig_shape = w.shape
    # groups must lie along the reduced (last) axis — a flat reshape would
    # straddle row boundaries and break the hardware n:m pattern
    if w.ndim == 0 or w.shape[-1] % m != 0:
        return np.ones(orig_shape, w.dtype)  # not maskable
    groups = np.abs(w).reshape(-1, m)
    keep = np.argsort(groups, axis=1)[:, m - n:]
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, keep, 1.0, axis=1)
    return mask.reshape(orig_shape).astype(w.dtype)


def calculate_density(x):
    arr = _host(x)
    return float((arr != 0).sum() / arr.size)


class ASPHelper:
    # id(param) -> (weakref(param), mask on the parameter's device).  The
    # weakref guards against id recycling: a dead param's id reused by a
    # fresh Tensor must NOT pick up the stale mask; dead entries are
    # swept on every prune/reapply.
    _masks = {}

    @classmethod
    def prunable(cls, layer, name, param):
        # reference: prune supported layers' weight matrices only
        return name.endswith("weight") and param.ndim == 2

    @classmethod
    def _sweep(cls):
        dead = [k for k, (wr, _) in cls._masks.items() if wr() is None]
        for k in dead:
            del cls._masks[k]

    @classmethod
    def prune_model(cls, model, n=2, m=4, mask_algo="mask_1d",
                    with_mask=True):
        cls._sweep()
        for name, sub in model.named_sublayers(include_self=True):
            for pname, p in getattr(sub, "_parameters", {}).items():
                if cls.prunable(sub, pname, p):
                    mask = torch.as_tensor(create_mask(p, n=n, m=m)).to(
                        device=p._data.device, dtype=p._data.dtype)
                    with torch.no_grad():
                        p._data.mul_(mask)
                    if with_mask:
                        cls._masks[id(p)] = (weakref.ref(p), mask)
        return {k: m for k, (_, m) in cls._masks.items()}

    @classmethod
    def reapply(cls, parameters):
        cls._sweep()
        for p in parameters:
            entry = cls._masks.get(id(p))
            if entry is not None and entry[0]() is p:
                with torch.no_grad():
                    p._data.mul_(entry[1])


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Reference paddle.incubate.asp.prune_model."""
    return ASPHelper.prune_model(model, n=n, m=m, mask_algo=mask_algo,
                                 with_mask=with_mask)


class _ASPOptimizer:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self, **kwargs):
        # kwargs pass through so wrapped optimizers with richer step
        # contracts keep working
        self._inner.step(**kwargs)
        # pruned weights stay pruned (reference OptimizerWithSparsityGuarantee)
        ASPHelper.reapply(self._inner._parameters)

    def minimize(self, loss, **kw):
        # must route through OUR step so the masks re-apply
        loss.backward()
        self.step()
        return None, None


def decorate(optimizer):
    """Reference paddle.incubate.asp.decorate: masks re-apply after every
    optimizer step so pruned coordinates never regrow."""
    return _ASPOptimizer(optimizer)
