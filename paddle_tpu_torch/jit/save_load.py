"""paddle.jit.save / paddle.jit.load — TranslatedLayer parity (port of
``paddle_tpu/jit/save_load.py``).

The Layer object is the program: ``save`` writes ``<prefix>.pdmodel``
(the pickled Layer) and ``<prefix>.pdiparams`` (``{"__format_version__",
"state"}``, the state dict as numpy arrays, as the JAX package writes
it); ``load`` rebuilds the Layer, sets the state and wraps its forward
in ``to_static``, so it runs as one traced program.

The ``.pdiparams`` files of the two packages are the same format: a
JAX-saved one loads into the port's model and the port's into the JAX
model (numpy arrays only; a bfloat16 state raises, as
``framework_io.save`` does, since numpy has no bfloat16).  A
``.pdmodel`` is a pickle of one package's classes: the port loads it
with an unpickler that refuses classes of ``paddle_tpu`` and ``jax``
("re-save with the port") and so never imports the JAX package.
"""

import pickle

import numpy as np
import torch

from ..nn.layer_base import Layer

# Artifact format version (reference op_version_registry.h role).
# v1 = bare pickled state dict, no wrapper.
# v2 wraps the params file in {"__format_version__", "state"}.
# Bump + register an upgrader in _STATE_UPGRADERS when the layout changes.
JIT_FORMAT_VERSION = 2

_STATE_UPGRADERS = {
    # v1 -> v2: same state-dict layout, only the wrapper is new
    1: lambda state: state,
}


class _PortUnpickler(pickle.Unpickler):
    """Loads a ``.pdmodel`` without importing the JAX package: a class
    of ``paddle_tpu`` or ``jax`` raises."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("paddle_tpu", "jax", "jaxlib") or \
                root.startswith("jax"):
            raise pickle.UnpicklingError(
                f"this .pdmodel was saved by the JAX package ({module}."
                f"{name}); it cannot load into paddle_tpu_torch — "
                f"re-save with the port (build the model with "
                f"paddle_tpu_torch, load the .pdiparams into it with "
                f"jit.load's state or set_state_dict, and jit.save it)")
        return super().find_class(module, name)


class TranslatedLayer(Layer):
    """A loaded inference/training layer (reference
    python/paddle/jit/translated_layer.py)."""

    def __init__(self, inner):
        super().__init__()
        self._inner = inner
        from . import to_static
        self._compiled = to_static(inner.forward)

    def forward(self, *args, **kwargs):
        return self._compiled(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._inner.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._inner.set_state_dict(sd, *a, **k)

    def parameters(self, *a, **k):
        return self._inner.parameters(*a, **k)

    def train(self):
        self._inner.train()
        return super().train()

    def eval(self):
        self._inner.eval()
        return super().eval()


def _host(t):
    d = t._data.detach()
    if d.dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16: cast the Layer to float32 "
                        "before jit.save")
    return d.cpu().numpy()


def save(layer, path, input_spec=None, **configs):
    """Save a Layer (or a to_static-decorated Layer) to ``path`` prefix."""
    from . import StaticFunction

    fwd = layer.forward
    restore = None
    if isinstance(fwd, StaticFunction):
        # unwrap the trace cache before pickling; re-wrapped on load
        restore = fwd
        layer.forward = fwd._original or fwd._function
    try:
        if restore is not None and "forward" in vars(layer) and \
                getattr(layer.forward, "__self__", None) is layer:
            del layer.__dict__["forward"]   # the class's own forward
        state = {k: _host(v) for k, v in layer.state_dict().items()}
        with open(path + ".pdmodel", "wb") as f:
            pickle.dump(layer, f)
    finally:
        if restore is not None:
            layer.forward = restore
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"__format_version__": JIT_FORMAT_VERSION,
                     "state": state}, f)


def load_state(path):
    """The state dict of ``<path>.pdiparams`` (either package's file),
    upgraded to the current format."""
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    if isinstance(state, dict) and "__format_version__" in state:
        version = int(state["__format_version__"])
        state = state["state"]
    else:
        version = 1  # bare state dict
    if version > JIT_FORMAT_VERSION:
        raise ValueError(
            f"{path}.pdiparams has format v{version}, newer than this "
            f"build's v{JIT_FORMAT_VERSION} — upgrade paddle_tpu_torch")
    while version < JIT_FORMAT_VERSION:
        upgrader = _STATE_UPGRADERS.get(version)
        if upgrader is None:
            raise ValueError(
                f"no upgrade path from jit.save format v{version}")
        state = upgrader(state)
        version += 1
    return {k: np.asarray(v) for k, v in state.items()}


def load(path, **configs):
    """Load a jit-saved model; returns a TranslatedLayer."""
    with open(path + ".pdmodel", "rb") as f:
        inner = _PortUnpickler(f).load()
    try:
        inner.set_state_dict(load_state(path))
    except FileNotFoundError:
        pass
    return TranslatedLayer(inner)
