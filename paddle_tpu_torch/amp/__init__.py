"""AMP for the port (from ``paddle_tpu/amp/__init__.py``): ``auto_cast``,
``decorate`` and ``GradScaler``.

``auto_cast`` (alias ``amp_guard``) sets a thread-local policy that the
op dispatcher consults for every op called with Paddle Tensors
(``ops/dispatch.py::apply_op``, as the JAX dispatch calls
``amp_cast_inputs``): at O1 a white-list op (the matmul and conv family)
casts its floating Tensor inputs to the AMP dtype, a black-list op
(softmax, the norms, the losses, the reductions) to float32, and any
other op runs in its inputs' dtypes; at O2 every op casts to the AMP
dtype but the black list.  The lists are the JAX package's, verbatim,
not ``torch.autocast``'s.  float64 inputs are never cast.  A call with
no Tensor in it — raw torch tensors, the engine's, GPT's and
``TrainStep``'s path — does not honour ``auto_cast``, as a JAX op called
with raw arrays does not: there is nothing the dispatcher recognises as
an input.  Off, the policy costs the dispatcher one thread-local read
an op call with Tensors, and nothing on the raw path.

``decorate(level="O2")`` casts every floating parameter of the model to
the AMP dtype, as the JAX package does; with no master weights in the
optimizers, the parameters are then trained in that dtype.  bf16 has
f32's exponent range, so its ``GradScaler`` is the identity.  Float16
dynamic loss scaling is not ported: asking for it raises.
"""

import contextlib
import threading

import torch

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "addmm",
}

BLACK_LIST = {
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "layer_norm", "rms_norm", "batch_norm", "group_norm",
    "instance_norm", "logsumexp", "mean", "sum", "exp", "log", "pow",
    "cumsum", "softmax_with_cross_entropy",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


def cast_target(op_name):
    """The dtype the policy casts ``op_name``'s floating inputs to, or
    None (leave them)."""
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    black = (BLACK_LIST | _state.custom_black) - _state.custom_white
    if _state.level == "O2":
        return torch.float32 if op_name in black else _state.dtype
    if op_name in white:
        return _state.dtype
    if op_name in black:
        return torch.float32
    return None


def cast_to(d, target):
    """``d`` cast to ``target`` if it is a floating tensor other than
    float64."""
    if (isinstance(d, torch.Tensor) and d.is_floating_point()
            and d.dtype != torch.float64 and d.dtype != target):
        return d.to(target)
    return d


def amp_cast_inputs(op_name, datas):
    """Cast per the AMP policy; returns a new list of datas (the JAX
    package's function, which ``apply_op`` applies to a call's Tensor
    inputs)."""
    if not _state.enabled:
        return datas
    target = cast_target(op_name)
    if target is None:
        return datas
    return [cast_to(d, target) for d in datas]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast parity (reference amp/auto_cast.py:646)."""
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = (torch.bfloat16 if dtype in ("bfloat16", "bf16")
                    else torch.float16)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast

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
