"""jit — the training step (port of ``paddle_tpu/jit/__init__.py::
TrainStep``).

The JAX package compiles forward, backward, clipping and the optimizer
update into one XLA program.  PyTorch runs eagerly: one call of
:class:`TrainStep` does the same four things in order on the model's
device, with the attention and LayerNorm of the model going through the
hand-written CUDA kernels.  Capturing the step in a CUDA graph is later
work (ROADMAP A7c).

The model is a ``torch.nn.Module`` over raw torch tensors (the port's
GPT) or a Paddle ``Layer`` over Tensors (what ``hapi.Model`` steps):
then the inputs and labels are Tensors and so is the loss.  A Layer's
buffers update in place as its forward runs (BatchNorm's running
statistics).  The JAX ``TrainStep`` restores every buffer after its
traced forward, so its BatchNorm statistics never move; the eager JAX
step updates them, and so does the port (ROADMAP C).

``remat=True`` is the JAX ``jax.checkpoint`` of the whole loss:
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` over
``loss_fn(model(*inputs), *labels)``, so the backward recomputes the
forward instead of keeping its activations.  ``checkpoint`` restores
PyTorch's default CPU and CUDA generators before the recompute but not
the explicit ``torch.Generator`` s the port's dropout draws from (the
model's own, ``models/gpt.py``, and the global ones of
``framework/random.py``): the step snapshots each of them before the
forward and restores it before the recompute, so the recompute draws
the same masks and the gradients equal those of ``remat=False``.

``scaler=`` (an enabled ``amp.GradScaler``) composes dynamic loss
scaling into the step, as the JAX step does: the loss is multiplied by
the scale, the gradients are unscaled, checked, clipped and applied
unless one is not finite (``amp.scaler_guarded_update``), the scale and
its counts move on the device, and the unscaled loss is returned.  A
skipped step keeps the parameters and the optimizer state bitwise; the
step count (``state_dict()["step"]``) still advances, as the JAX
``self._step`` does, while the optimizer's own count advances only with
an update.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..amp import scaler_guarded_update, scaler_init_state
from ..core.tensor import Tensor
from ..framework import random as _random


class TrainStep:
    """One whole training step per call.

    Usage::

        step = TrainStep(model, loss_fn, opt)
        loss = step(batch_x, batch_y)   # tensors in, detached loss out

    ``model`` is a ``torch.nn.Module`` fed raw torch tensors or a Paddle
    ``Layer`` fed Tensors (module docstring).

    A call clears the gradients, runs ``loss_fn(model(*inputs),
    *labels)`` (under ``checkpoint`` with ``remat=True``), backward
    (of the scaled loss with ``scaler``), then ``optimizer.step()``
    (which applies the optimizer's ``grad_clip``) or, with ``scaler``,
    the guarded update, and returns the loss.  The parameters and the
    optimizer state are updated in place.  The reference's ``donate``
    has no counterpart: the in-place update already reuses the
    buffers."""

    def __init__(self, model, loss_fn, optimizer, remat=False, scaler=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat = remat
        self._step = 0
        self.found_inf = None   # the last scaled step's flag (0-d bool)
        self.scaler = scaler if (scaler is not None and scaler.is_enable()) \
            else None
        if self.scaler is not None:
            self.scaler._compiled_state = scaler_init_state(
                self.scaler, self._device())

    def _device(self):
        p = self.optimizer._parameters[0]
        return (p._data if isinstance(p, Tensor) else p).device

    def _generators(self):
        """Every explicit generator the forward may draw from: those the
        model's modules hold, and the port's global generators (the one
        of the parameters' device created now if it is not yet)."""
        _random.generator(self._device())
        mods = (self.model.modules() if isinstance(self.model,
                                                   torch.nn.Module)
                else self.model.sublayers(include_self=True))
        found = {id(g): g for m in mods for g in vars(m).values()
                 if isinstance(g, torch.Generator)}
        found.update((id(g), g) for g in _random._generators.values())
        return list(found.values())

    def _loss(self, inputs, labels):
        if not self.remat:
            return self.loss_fn(self.model(*inputs), *labels)
        states = [(g, g.get_state()) for g in self._generators()]

        def loss_f(*inputs):
            # the forward draws from these states, and so does the
            # recompute
            for g, state in states:
                g.set_state(state)
            return self.loss_fn(self.model(*inputs), *labels)

        return checkpoint(loss_f, *inputs, use_reentrant=False)

    def __call__(self, inputs, labels=()):
        """inputs: tensor or tuple for the model; labels: tensor or tuple
        for ``loss_fn(output, *labels)``.  Returns the loss, detached."""
        if isinstance(inputs, (torch.Tensor, Tensor)):
            inputs = (inputs,)
        if isinstance(labels, (torch.Tensor, Tensor)):
            labels = (labels,)
        self._step += 1
        self.optimizer.clear_grad()
        loss = self._loss(inputs, labels)
        if self.scaler is None:
            loss.backward()
            self.optimizer.step()
            return loss.detach()
        state = self.scaler._compiled_state
        data = loss._data if isinstance(loss, Tensor) else loss
        (data * state["scale"].to(data.dtype)).backward()
        self.found_inf, self.scaler._compiled_state = scaler_guarded_update(
            self.scaler, state, self.optimizer)
        return loss.detach()

    def state_dict(self):
        return {"params": {k: v.detach() for k, v in
                           self.model.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "step": self._step}
