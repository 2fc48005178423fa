"""AMP for the port (from ``paddle_tpu/amp/__init__.py``): ``decorate``
and ``GradScaler``.

``decorate(level="O2")`` casts every floating parameter of the model to
the AMP dtype, as the JAX package does; with no master weights in the
optimizers, the parameters are then trained in that dtype.  bf16 has
f32's exponent range, so its ``GradScaler`` is the identity.  Float16
dynamic loss scaling is not ported: asking for it raises.
"""

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16}


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None):
    """O2: cast each model's floating parameters to ``dtype`` (in place,
    ``Module.to``).  O1 leaves them as they are.  ``master_weight=True``
    raises NotImplementedError: the optimizers keep no f32 master copy,
    as the JAX package's do not."""
    if master_weight:
        raise NotImplementedError(
            "amp.decorate(master_weight=True): f32 master weights are not "
            "ported (the JAX package's optimizers keep none either); they "
            "come with slice 8 (the long tail)")
    if level == "O2":
        target = _DTYPES[dtype]
        for m in (models if isinstance(models, (list, tuple)) else [models]):
            m.to(dtype=target)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Loss scaler with the reference API.  For bf16 it is the identity:
    ``scale`` returns the loss, ``step`` runs the optimizer and
    ``update`` does nothing.  ``dtype="float16"`` with scaling enabled
    raises NotImplementedError."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 dtype="bfloat16"):
        if enable and _DTYPES[dtype] == torch.float16:
            raise NotImplementedError(
                "float16 dynamic loss scaling is not ported; it comes with "
                "slice 8 (the long tail). Use dtype='bfloat16'.")
        self._enable = enable

    def scale(self, loss):
        return loss

    def step(self, optimizer):
        optimizer.step()

    def update(self):
        return None

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def is_enable(self):
        return self._enable
