"""Helpers for the port's model tests that hold a model to the JAX
package's on one set of weights.

The port builds its model (torch initialisation, cheap on the CPU); the
JAX model is built with its initializers answering zeros (building it
normally compiles one random draw per parameter shape, seconds per
model) and is then given the port's weights by name with
``set_state_dict``, so both packages run one set of weights.  The JAX
model runs as one jitted ``functional_call`` (forward, or forward and
its gradients): op by op it compiles every op's shape on its own, tens
of seconds for a zoo model's step.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as J
from paddle_tpu.jit import functional_call
from paddle_tpu.nn import initializer as JI


@contextlib.contextmanager
def zero_init():
    """The JAX package's initializers answer zeros inside the block."""
    def zeros(self, shape, dtype=None):
        return jnp.zeros(tuple(int(s) for s in shape), jnp.float32)

    saved = {}
    for name in dir(JI):
        cls = getattr(JI, name)
        if (isinstance(cls, type) and issubclass(cls, JI.Initializer)
                and "__call__" in cls.__dict__):
            saved[cls] = cls.__dict__["__call__"]
            cls.__call__ = zeros
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.__call__ = fn


def port_state(model):
    """The port model's state dict as numpy, by name."""
    return {k: np.array(v.numpy()) for k, v in model.state_dict().items()}


def jax_twin(ctor, port_model):
    """``ctor()`` of the JAX package (zero-initialised) with the port
    model's weights loaded by name; the two key lists must be equal, in
    order."""
    with zero_init():
        jm = ctor()
    keys = list(jm.state_dict())
    assert keys == list(port_model.state_dict()), "state-dict keys differ"
    missing, unexpected = jm.set_state_dict(port_state(port_model))
    assert not missing and not unexpected
    return jm


def jax_params(jm):
    return {k: v._data for k, v in jm.state_dict().items()}


def jax_forward(jm, *inputs, train=False):
    """The JAX model's output on numpy ``inputs``, jitted, as numpy (a
    tuple output as a tuple)."""
    jm.train() if train else jm.eval()
    args = [jax.tree_util.tree_map(jnp.asarray, a) for a in inputs]
    out = jax.jit(lambda p, *a: functional_call(jm, p, *a))(
        jax_params(jm), *args)
    return jax.tree_util.tree_map(np.asarray, out)


def jax_value_and_grad(jm, loss, inputs, extras=(), wrt_inputs=(),
                       train=True):
    """(output, loss, {param: grad}, [input grads]) of ``loss(out,
    *extras)`` on the JAX model's output ``out`` for the numpy
    ``inputs``, in one jitted call; ``loss`` takes and returns jax arrays
    or JAX Tensors, the output comes back as numpy.  ``wrt_inputs`` names
    the positions of the inputs to differentiate too."""
    jm.train() if train else jm.eval()
    args = [jax.tree_util.tree_map(jnp.asarray, a) for a in inputs]
    ext = [jnp.asarray(a) for a in extras]

    def f(params, diff, ext):
        full = list(args)
        for i, a in zip(wrt_inputs, diff):
            full[i] = a
        out = functional_call(jm, params, *full)
        val = loss(out, *ext)
        return (val._data if isinstance(val, J.Tensor) else val), out

    (val, out), (gp, gi) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        jax_params(jm), [args[i] for i in wrt_inputs], ext)
    return (jax.tree_util.tree_map(np.asarray, out), float(val),
            {k: np.asarray(v) for k, v in gp.items()},
            [np.asarray(g) for g in gi])
