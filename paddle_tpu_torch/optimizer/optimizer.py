"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``): the base
``Optimizer``, ``SGD``, ``Adam`` and ``AdamW``.

The numerics are the JAX package's rules: Adam's moments are f32,
``beta1_pow`` / ``beta2_pow`` accumulate per step (as f32 values),
AdamW's decoupled decay ``p - lr * wd * p`` comes before the Adam rule
and ``apply_decay_param_fun(name)`` masks it.  torch tensors carry no
Paddle ``name``, so ``parameters`` may hold ``(name, tensor)`` pairs
(``model.named_parameters()``); a parameter given without a name is
decayed, as an unnamed one is in the JAX package.  There are no master
weights: the update is cast to the parameter's own dtype, so under
``amp.decorate(level="O2")`` bf16 parameters are updated in bf16.

Unlike the JAX package's pure rules, ``step`` updates the parameters
and the optimizer state **in place** (``torch._foreach_*`` over every
parameter of the step, under ``no_grad``).
"""

import numpy as np
import torch

from .lr import LRScheduler

_f32 = np.float32


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        self._lr = learning_rate
        self._parameters, self._names = [], {}
        for item in parameters if parameters is not None else []:
            if isinstance(item, tuple):
                name, item = item
                self._names[id(item)] = name
            self._parameters.append(item)
        if not self._parameters:
            raise ValueError("parameters is required")
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}  # id(param) -> state dict
        self._step_count = 0

    # ---- lr ----
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    # ---- state rules (override) ----
    def _init_state(self, p):
        """The initial state dict of one parameter."""
        return {}

    def _apply(self, params, grads, states, lr):
        """Update ``params`` and their ``states`` in place from
        ``grads`` (clipped, with any coupled decay added)."""
        raise NotImplementedError

    def _decay_applied_in_rule(self):
        """AdamW-style decoupled decay handles weight_decay in the rule."""
        return False

    # ---- step ----
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient, in place."""
        self._step_count += 1
        lr = self.get_lr()
        params = [p for p in self._parameters
                  if p.grad is not None and p.requires_grad]
        if not params:
            return
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            grads = self._grad_clip._clip(params, grads)
        if self._weight_decay and not self._decay_applied_in_rule():
            wd = float(self._weight_decay)
            grads = [g + wd * p for g, p in zip(grads, params)]
        states = []
        for p in params:
            state = self._accumulators.get(id(p))
            if state is None:
                state = self._accumulators[id(p)] = self._init_state(p)
            states.append(state)
        self._apply(params, grads, states, lr)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameters:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # ---- checkpoint ----
    def state_dict(self):
        sd = {"step": self._step_count}
        for i, p in enumerate(self._parameters):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                sd[f"param{i}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply(self, params, grads, states, lr):
        # p - lr * g.astype(p.dtype)
        torch._foreach_add_(params, [g.to(p.dtype) for g, p in
                                     zip(grads, params)], alpha=-lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision=True: f32 master weights are not ported "
                "(the JAX package's optimizers keep none either); they come "
                "with slice 8 (the long tail)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        """f32 moments on the parameter's device; the beta powers are f32
        values kept on the host (they are the same for every element)."""
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _f32(1.0), "beta2_pow": _f32(1.0)}

    def _apply(self, params, grads, states, lr):
        """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2 (g in f32);
        p -= (lr * m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)) cast to
        p's dtype."""
        b1, b2 = self._beta1, self._beta2
        g32 = [g.float() for g in grads]
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
        c1, c2 = [], []
        for s in states:
            s["beta1_pow"] = _f32(s["beta1_pow"] * _f32(b1))
            s["beta2_pow"] = _f32(s["beta2_pow"] * _f32(b2))
            c1.append(float(_f32(1) - s["beta1_pow"]))
            c2.append(float(_f32(1) - s["beta2_pow"]))
        mhat = torch._foreach_div(m, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(v, c2))
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(mhat, float(_f32(lr)))
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(params, [u.to(p.dtype) for u, p in
                                     zip(upd, params)])


class AdamW(Adam):
    """Decoupled weight decay (reference python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun
        if apply_decay_param_fun is not None:
            self._decay_ids = {
                id(p) for p in self._parameters
                if id(p) not in self._names
                or apply_decay_param_fun(self._names[id(p)])}
        else:
            self._decay_ids = None

    def _decay_applied_in_rule(self):
        return True

    def _apply(self, params, grads, states, lr):
        """p = p - lr * wd * p on the masked parameters, in their own
        dtype, then the Adam rule."""
        wd = float(self._weight_decay or 0.0)
        if wd:
            decayed = [p for p in params if self._decay_ids is None
                       or id(p) in self._decay_ids]
            if decayed:
                step = torch._foreach_mul(decayed, float(_f32(lr) * _f32(wd)))
                torch._foreach_sub_(decayed, step)
        super()._apply(params, grads, states, lr)
