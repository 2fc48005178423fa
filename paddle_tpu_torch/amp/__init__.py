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
optimizers, the parameters are then trained in that dtype.

``GradScaler`` is the JAX package's dynamic loss scaler, whatever the
dtype (``scale``, ``unscale_`` once a step, ``step`` skipping the update
on a non-finite gradient, ``update`` halving or doubling the scale).
``scaler_init_state`` / ``scaler_apply`` / ``scaler_guarded_update``
are its form inside ``jit.TrainStep``: the scale and the good and bad
counts are device tensors on the parameters' device, updated there with
``torch.where`` as the JAX step updates them.  Either form unscales
every gradient with one fused multiply and detects a non-finite one with
one fused check (``torch._amp_foreach_non_finite_check_and_unscale_``),
then reads that one flag on the host to skip or run the optimizer (the
port's optimizers update in place, and Adam's beta powers are host
values).  A float16 gradient is unscaled into an f32 copy that the
optimizer steps from, as the JAX step promotes it (its ``1 / scale`` is
an f32 array): unscaled in float16 a scaled gradient would underflow
again.
"""

import contextlib
import threading

import numpy as np
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
             master_weight=None, save_dtype=None):
    """O2: cast each model's floating parameters to ``dtype`` (in place,
    ``Module.to``).  O1 leaves them as they are.  ``master_weight=True``
    raises NotImplementedError: the optimizers keep no f32 master copy,
    as the JAX package's do not.  ``save_dtype`` is taken and not read,
    as in the JAX package."""
    if master_weight:
        raise NotImplementedError(
            "amp.decorate(master_weight=True): f32 master weights are not "
            "ported (the JAX package's optimizers keep none either, so they "
            "are no roadmap item)")
    if level == "O2":
        target = _DTYPES[dtype]
        for m in (models if isinstance(models, (list, tuple)) else [models]):
            m.to(dtype=target)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaler (reference python/paddle/amp/grad_scaler.py:577),
    the JAX package's rules: ``scale`` multiplies the loss by the scale,
    ``unscale_`` divides the optimizer's gradients by it (once a step)
    and records whether one is not finite, ``step`` runs the optimizer
    unless one was (the optimizer's own step count then stays), and
    ``update`` halves the scale (never below 1) after
    ``decr_every_n_nan_or_inf`` bad steps in a row or doubles it after
    ``incr_every_n_steps`` good ones.  ``use_dynamic_loss_scaling=False``
    keeps the scale.  A ``jit.TrainStep`` given the scaler keeps the live
    state on the card (``_compiled_state``); ``get_scale``,
    ``state_dict`` and ``set_state_dict`` read and write it there."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = None   # the step's unscaled gradients, once taken
        self._compiled_state = None

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale (a float16 one
        into an f32 copy, which ``step`` uses; the parameter's own
        gradient gets the copy rounded back) and record whether any is
        not finite: one host read of one flag."""
        if not self._enable or self._unscaled is not None:
            return
        _, params, grads = optimizer._grads()
        inv = float(np.float32(1.0 / self._scale))
        self._unscaled, found = _unscale(grads, inv, self._scale >= 1.0)
        for p, g in zip(params, self._unscaled):
            if g is not p.grad:
                p.grad.copy_(g)
        self._found_inf = bool(found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer._step_with(self._unscaled)
        self._unscaled = None

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def _scale_stays_at_least_one(self):
        """Whether a TrainStep's scale, which starts at ``_scale``, stays
        at least 1: ``update`` floors a decrease at 1, so it does unless
        it starts below 1 or an increase shrinks it."""
        return self._scale >= 1.0 and self._incr_ratio >= 1.0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def get_scale(self):
        st = self._compiled_state
        if st is not None:  # live state owned by a TrainStep
            return float(st["scale"])
        return self._scale

    def state_dict(self):
        st = self._compiled_state
        if st is not None:
            return {"scale": float(st["scale"]),
                    "good_steps": int(st["good"]),
                    "bad_steps": int(st["bad"])}
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def set_state_dict(self, sd):
        self._scale = float(sd.get("scale", self._scale))
        self._good_steps = int(sd.get("good_steps", self._good_steps))
        self._bad_steps = int(sd.get("bad_steps", self._bad_steps))
        st = self._compiled_state
        if st is not None:
            # write through: an attached TrainStep reads this state as
            # its live scaler state on its next step
            self._compiled_state = scaler_init_state(
                self, st["scale"].device)


def _unscale(grads, inv, at_most_one=True):
    """Gradients times ``inv`` (a float, or an f32 0-d tensor on their
    device) -> (the unscaled gradients, a 0-d bool tensor: whether any is
    not finite), in place for f32 and bf16 gradients and into f32 copies
    of float16 ones.  The JAX rule checks the products ``g * inv``; torch's
    fused unscale checks ``g`` and multiplies in the same pass, which is
    the same check when ``inv <= 1`` (a finite ``g`` then gives a finite
    product).  With ``at_most_one=False`` (a scale that may be below 1)
    the products are made first and then checked, a second pass."""
    out = [g.float() if g.dtype == torch.float16 else g for g in grads]
    if not out:
        return out, torch.zeros((), dtype=torch.bool)
    dev = out[0].device
    if not isinstance(inv, torch.Tensor):
        inv = torch.full((), inv, dtype=torch.float32, device=dev)
    found = torch.zeros((), dtype=torch.float32, device=dev)
    if not at_most_one:
        torch._foreach_mul_(out, inv)
        inv = torch.ones((), dtype=torch.float32, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(out, found, inv)
    return out, found > 0


# ---- loss scaling inside jit.TrainStep (update_loss_scaling_ parity) ----

def scaler_init_state(scaler, device=None):
    """The scaler's state as device tensors on ``device``: the f32 scale
    and the int32 good and bad counts."""
    return {"scale": torch.tensor(scaler._scale, dtype=torch.float32,
                                  device=device),
            "good": torch.tensor(scaler._good_steps, dtype=torch.int32,
                                 device=device),
            "bad": torch.tensor(scaler._bad_steps, dtype=torch.int32,
                                device=device)}


def scaler_apply(scaler, state, grads, reduce_found=None):
    """Unscale ``grads`` by the state's scale, detect a non-finite one
    and run the dynamic-scale update, all on the device with no host
    read -> (unscaled grads, found_inf as a 0-d bool tensor, new state).
    The JAX ``scaler_apply``: the reference's update_loss_scaling_
    kernel and fleet's distributed_scaler (fleet/scaler.py:28).  A rank
    holding part of the gradients passes ``reduce_found``, which makes
    its local flag the world's (the flag any rank found)."""
    grads, found = _unscale(grads, torch.reciprocal(state["scale"]),
                            scaler._scale_stays_at_least_one())
    if reduce_found is not None:
        found = reduce_found(found)
    if not scaler._dynamic:
        return grads, found, state
    zero = torch.zeros_like(state["bad"])
    bad1 = torch.where(found, state["bad"] + 1, zero)
    good1 = torch.where(found, zero, state["good"] + 1)
    dec = found & (bad1 >= scaler._decr_every)
    inc = ~found & (good1 >= scaler._incr_every)
    scale = state["scale"]
    scale1 = torch.where(
        dec, torch.clamp(scale * scaler._decr_ratio, min=1.0),
        torch.where(inc, scale * scaler._incr_ratio, scale))
    return grads, found, {"scale": scale1,
                          "good": torch.where(inc, zero, good1),
                          "bad": torch.where(dec, zero, bad1)}


def scaler_guarded_update(scaler, scaler_state, optimizer):
    """``TrainStep``'s epilogue: unscale the optimizer's gradients, then
    clip and update (``optimizer``'s own ``grad_clip`` and rule) unless
    one was not finite; -> (found_inf, new state).  The JAX function
    computes the candidate update and keeps the old parameters and
    optimizer state with ``jnp.where``; the port's optimizers update in
    place, so it reads the flag on the host once and does not run the
    update at all (the parameters and the state stay bitwise)."""
    _, _, grads = optimizer._grads()
    grads, found, new_state = scaler_apply(scaler, scaler_state, grads)
    if not bool(found):  # the step's one host read
        optimizer._step_with(grads)
    return found, new_state


from . import debugging  # noqa: E402,F401
