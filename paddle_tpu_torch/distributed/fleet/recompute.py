"""Activation recompute as a user API.

Reference: python/paddle/distributed/fleet/recompute/recompute.py:332
(``recompute``), ``recompute_sequential`` (:456).  Port of
``paddle_tpu/distributed/fleet/recompute.py``: the JAX module wraps the
function in ``jax.checkpoint``; the port runs it under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so the
backward recomputes the forward from the inputs instead of reading saved
activations.  Parameters the function closes over need no listing (the
JAX module collects them as explicit inputs of its op): the
non-reentrant checkpoint differentiates every tensor the body touches.

**Generators.**  ``checkpoint`` restores PyTorch's default generators
before the recompute but not the explicit ``torch.Generator`` s the
port's dropout draws from (a model's own, the mp-local one of a sliced
model, the port's global ones of ``framework/random.py``).  The function
snapshots each generator it can reach (those held by the Layer or
module the function is, is bound to, closes over or takes as a default,
and the global ones) before the forward, sets them back before the recompute and
afterwards returns them to where they were, so the recompute draws the
forward's masks and later draws are not repeated.

**Policies** (the JAX ``jax.checkpoint_policies`` names): ``None`` /
``"full"`` / ``"nothing_saveable"`` save nothing; ``"dots"`` /
``"dots_saveable"`` keep the matmul outputs and ``"dots_with_no_batch_dims"``
those of the un-batched ones (torch's selective checkpoint:
``create_selective_checkpoint_contexts`` with a policy marking them
``MUST_SAVE``); ``"everything_saveable"`` keeps every output.  Another
name raises the JAX ``ValueError``.
"""

import functools

import torch
from torch.utils.checkpoint import checkpoint

_POLICIES = {
    None: None,
    "full": None,  # save nothing; recompute everything
    "dots": "dots_saveable",
    "dots_saveable": "dots_saveable",
    "dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable",
    "nothing_saveable": "nothing_saveable",
    "everything_saveable": "everything_saveable",
}


def _saved_ops(key):
    aten = torch.ops.aten
    if key == "dots_saveable":
        return {aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.baddbmm.default}
    if key == "dots_with_no_batch_dims_saveable":
        return {aten.mm.default, aten.addmm.default}
    return None


def _resolve_policy(name):
    """None (save nothing) or a ``context_fn`` for ``checkpoint``."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {name!r}; use one of "
            f"{sorted(k for k in _POLICIES if isinstance(k, str))}")
    key = _POLICIES[name]
    if key in (None, "nothing_saveable"):
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    keep = _saved_ops(key)

    def policy(ctx, op, *args, **kwargs):
        if keep is None or op in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _generators(function):
    """The explicit generators the function can reach (module
    docstring)."""
    from ...framework import random as _random
    from ...nn.layer_base import Layer

    found = {}

    def visit(obj):
        if isinstance(obj, torch.nn.Module):
            mods = obj.modules()
        elif isinstance(obj, Layer):
            mods = obj.sublayers(include_self=True)
        else:
            return
        for m in mods:
            for v in vars(m).values():
                if isinstance(v, torch.Generator):
                    found[id(v)] = v

    visit(function)
    visit(getattr(function, "__self__", None))
    raw = getattr(function, "__func__", function)
    for cell in getattr(raw, "__closure__", None) or ():
        try:
            visit(cell.cell_contents)
        except ValueError:  # empty cell
            pass
    for default in getattr(raw, "__defaults__", None) or ():
        for obj in default if isinstance(default, (list, tuple)) \
                else (default,):
            visit(obj)
    found.update((id(g), g) for g in _random._generators.values())
    return list(found.values())


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` with activation rematerialization.

    The backward pass recomputes the forward instead of reading saved
    activations — the memory/computation trade the reference implements with
    RecomputeFunction (recompute.py:332).  ``use_reentrant`` is accepted
    for API parity (the port's checkpoint is the non-reentrant one, which
    handles keyword arguments and closed-over parameters); the
    generators' state is always preserved (module docstring)."""
    context_fn = _resolve_policy(policy)
    gens = _generators(function)
    before = [(g, g.get_state()) for g in gens]
    calls = [0]

    def body(*a, **k):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **k)
        now = [(g, g.get_state()) for g in gens]
        for g, state in before:
            g.set_state(state)
        try:
            return function(*a, **k)
        finally:
            for g, state in now:
                g.set_state(state)

    extra = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a paddle.nn.Sequential in segments (reference
    recompute_sequential:456).  ``ctx`` carries {'segments': N}."""
    segments = (ctx or {}).get("segments", 1)
    layers = list(functions)
    seg_size = max(1, len(layers) // max(1, segments))
    out = args[0] if len(args) == 1 else args
    i = 0
    while i < len(layers):
        chunk = layers[i:i + seg_size]

        def seg_fn(x, _chunk=tuple(chunk)):
            for layer in _chunk:
                x = layer(x)
            return x

        out = recompute(seg_fn, out, **kwargs)
        i += seg_size
    return out

