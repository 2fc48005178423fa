"""User custom-op registration (port of ``paddle_tpu/utils/
custom_op.py``) — the reference's runtime-registered external ops
(paddle/fluid/framework/custom_operator.cc, OpMetaInfo at
paddle/phi/api/lib/op_meta_info.cc).

A custom op is a function on torch tensors (a composition, a
hand-written CUDA kernel's launcher, or a host callback), so
registration wires the function, with an optional hand-written
backward, into the port's op registry (``ops/registry.py``): eager
dispatch with Tensors in and out, autograd, AMP casting, profiler events
and coverage accounting come from there.  Without a backward, torch
autograd differentiates the forward (the JAX package's ``jax.vjp``).

>>> def fwd(x, alpha): return x * alpha
>>> def bwd(gout, x, alpha): return gout * alpha, None   # None: no grad
>>> my_scale = register_custom_op("my_scale", fwd, backward=bwd)
>>> y = my_scale(paddle.to_tensor(arr), 3.0)             # Tensor in/out
"""

import torch

from ..ops import registry


def _with_backward(name, forward, backward):
    """``forward`` whose gradient is ``backward(*cotangents, *primals)``
    (one cotangent per output; one gradient per primal, None for none)."""

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.args = args
            return forward(*args)

        @staticmethod
        def backward(ctx, *cots):
            args = ctx.args
            grads = backward(*cots, *args)
            if grads is None:
                grads = (None,) * len(args)
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            if len(grads) != len(args):
                raise ValueError(
                    f"custom backward for {name!r} returned {len(grads)} "
                    f"gradients for {len(args)} inputs")
            # a None gradient of a tensor input is a zero cotangent, as
            # in the JAX package; a non-tensor input takes none
            return tuple(
                (torch.zeros_like(a) if g is None else g)
                if isinstance(a, torch.Tensor) else None
                for g, a in zip(grads, args))

    Op.__name__ = f"custom_{name}"
    return lambda *args: Op.apply(*args)


def register_custom_op(name, forward, backward=None, tags=("custom",)):
    """Register ``forward`` (on torch tensors) as an eager op named
    ``name``.

    ``backward(*cotangents, *primals) -> per-primal cotangents``
    overrides torch autograd (reference custom ops supply an explicit
    grad kernel).  Return ``None`` for a primal that gets no gradient
    (its cotangent becomes zeros).  Without ``backward``, gradients come
    from torch autograd over ``forward`` — a forward that autograd cannot
    see through (a host callback) needs a backward for training.

    Returns the user-facing function (Tensors in/out, autograd
    recorded); the op is in the registry, so ``ops.raw(name)`` works on
    torch tensors and coverage counts it.  A name already registered
    raises ValueError.
    """
    if name in registry.OPS:
        raise ValueError(f"op {name!r} is already registered")
    body = forward if backward is None else \
        _with_backward(name, forward, backward)
    body.__name__ = name
    return registry.op(name, tags=tuple(tags))(body)


def register_pallas_op(name, kernel_fn, backward=None,
                       tags=("custom", "cuda")):
    """Register a hand-written device kernel's launcher as an op.

    Stands where the JAX package registers a Pallas kernel: here
    ``kernel_fn`` launches a hand-written CUDA kernel (the house style is
    ``ops/cuda/``: a launcher over a ``torch.library`` op that builds its
    source with nvcc at the first call, with its plain PyTorch version on
    CPU tensors), ``backward`` launches its backward kernel.  This is
    ``register_custom_op`` with the ``("custom", "cuda")`` tags — the
    entry point keeps the reference API's name and the registry's kernel
    provenance queryable (``OPS[name].tags``).
    """
    return register_custom_op(name, kernel_fn, backward=backward, tags=tags)
