"""jit — the training step (port of ``paddle_tpu/jit/__init__.py::
TrainStep``).

The JAX package compiles forward, backward, clipping and the optimizer
update into one XLA program.  PyTorch runs eagerly: one call of
:class:`TrainStep` does the same four things in order on the model's
device, with the attention and LayerNorm of the model going through the
hand-written CUDA kernels.  Capturing the step in a CUDA graph is later
work.
"""

import torch

from ..amp import GradScaler


class TrainStep:
    """One whole training step per call.

    Usage::

        step = TrainStep(model, loss_fn, opt)
        loss = step(batch_x, batch_y)   # tensors in, detached loss out

    A call clears the gradients, runs ``loss_fn(model(*inputs),
    *labels)``, ``loss.backward()``, then ``optimizer.step()`` (which
    applies the optimizer's ``grad_clip``), and returns the loss.  The
    parameters and the optimizer state are updated in place.
    ``remat=True`` and a loss scaler other than the bf16 identity
    ``amp.GradScaler`` raise NotImplementedError.  The reference's
    ``donate`` has no counterpart: the in-place update already reuses
    the buffers."""

    def __init__(self, model, loss_fn, optimizer, remat=False, scaler=None):
        if remat:
            raise NotImplementedError(
                "TrainStep(remat=True): activation rematerialisation is "
                "not ported; it comes with slice 8 (the long tail)")
        if scaler is not None and not isinstance(scaler, GradScaler):
            raise NotImplementedError(
                "TrainStep(scaler=...): only the bf16 identity GradScaler "
                "is ported; float16 loss scaling comes with slice 8 (the "
                "long tail)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._step = 0

    def __call__(self, inputs, labels=()):
        """inputs: tensor or tuple for the model; labels: tensor or tuple
        for ``loss_fn(output, *labels)``.  Returns the loss, detached."""
        if isinstance(inputs, torch.Tensor):
            inputs = (inputs,)
        if isinstance(labels, torch.Tensor):
            labels = (labels,)
        self._step += 1
        self.optimizer.clear_grad()
        loss = self.loss_fn(self.model(*inputs), *labels)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def state_dict(self):
        return {"params": {k: v.detach() for k, v in
                           self.model.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "step": self._step}
