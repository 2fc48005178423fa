"""Optimizers (port of ``paddle_tpu/optimizer/optimizer.py``): the base
``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``,
``RMSProp``, ``Adagrad``, ``Adadelta``, ``Lamb`` and ``Lars``.

The numerics are the JAX package's rules: Adam's moments are f32,
``beta1_pow`` / ``beta2_pow`` accumulate per step (as f32 values),
AdamW's decoupled decay ``p - lr * wd * p`` comes before the Adam rule
and ``apply_decay_param_fun(name)`` masks it.  ``parameters`` holds
torch tensors, ``(name, tensor)`` pairs (``model.named_parameters()``)
or Paddle ``Parameter``s (``Layer.parameters()``), whose name is
``Parameter.name`` and whose ``_data`` is updated; a parameter without
a name is decayed, as an unnamed one is in the JAX package.  There are no master
weights: the update is cast to the parameter's own dtype, so under
``amp.decorate(level="O2")`` bf16 parameters are updated in bf16.

Unlike the JAX package's pure rules, ``step`` updates the parameters
and the optimizer state **in place** (``torch._foreach_*`` over every
parameter of the step, under ``no_grad``).  Each optimizer also keeps
the JAX ``_update`` as a per-parameter plain rule, ``rule(p, g, state,
lr)`` -> ``(p, state)`` out of place, which the tests and the card's
check hold ``step`` to; nothing on the training path calls it.  The
state dict has the JAX keys (``param{i}.{name}``, ``step``,
``LR_Scheduler``), so a state dict crosses between the packages.

Two JAX behaviours are kept as they are: ``Momentum``'s velocity is in
the parameter's dtype (not f32), and ``Lamb`` stores
``exclude_from_weight_decay_fn`` without reading it.
"""

import numpy as np
import torch

from ..core.tensor import Tensor
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
            elif isinstance(item, Tensor) and item.name is not None:
                self._names[id(item)] = item.name
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

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # ---- state rules (override) ----
    def _init_state(self, p):
        """The initial state dict of one parameter."""
        return {}

    def _apply(self, params, grads, states, lr, owners):
        """Update ``params`` and their ``states`` in place from
        ``grads`` (clipped, with any coupled decay added); ``owners``
        are the objects the caller passed, one a parameter."""
        raise NotImplementedError

    def rule(self, p, g, state, lr):
        """The JAX ``_update`` for one parameter, out of place: (p, g
        after clipping and coupled decay, state, lr) -> (p, state)."""
        raise NotImplementedError

    def _decay_applied_in_rule(self):
        """AdamW-style decoupled decay handles weight_decay in the rule."""
        return False

    # ---- step ----
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient, in place."""
        self._step_with(None)

    def _grads(self):
        """(owners, parameter tensors, their gradients) of every trainable
        parameter that has a gradient."""
        owners, params = [], []
        for item in self._parameters:
            p = item._data if isinstance(item, Tensor) else item
            if p.grad is not None and p.requires_grad:
                owners.append(item)
                params.append(p)
        return owners, params, [p.grad for p in params]

    @torch.no_grad()
    def _step_with(self, grads):
        """``step`` from ``grads`` (one a parameter of :meth:`_grads`, in
        its order; the loss scaler's unscaled gradients, f32 for a
        float16 parameter) or, with None, the parameters' own."""
        self._step_count += 1
        lr = self.get_lr()
        owners, params, own = self._grads()
        if not params:
            return
        if grads is None:
            grads = own
        if self._grad_clip is not None:
            grads = self._grad_clip._clip(params, grads)
        if self._weight_decay and not self._decay_applied_in_rule():
            wd = float(self._weight_decay)
            grads = [g + wd * p for g, p in zip(grads, params)]
        states = []
        for item, p in zip(owners, params):
            state = self._accumulators.get(id(item))
            if state is None:
                state = self._accumulators[id(item)] = self._init_state(p)
            states.append(state)
        self._apply(params, grads, states, lr, owners)

    def clear_grad(self, set_to_zero=False):
        for item in self._parameters:
            p = item._data if isinstance(item, Tensor) else item
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``, as in the JAX package."""
        loss.backward()
        self.step()
        return None, None

    # ---- checkpoint ----
    def state_dict(self):
        sd = {"step": self._step_count}
        for i, p in enumerate(self._parameters):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                sd[f"param{i}.{k}"] = v
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load a state dict of either package: each value takes the kind
        and dtype of this optimizer's own initial state for the key (a
        host f32 scalar or a tensor on the parameter's device)."""
        self._step_count = int(state_dict.get("step", 0))
        for i, item in enumerate(self._parameters):
            prefix = f"param{i}."
            got = {k[len(prefix):]: v for k, v in state_dict.items()
                   if isinstance(k, str) and k.startswith(prefix)}
            if not got:
                continue
            p = item._data if isinstance(item, Tensor) else item
            init = self._init_state(p)
            state = {}
            for k, v in got.items():
                arr = np.array(v.numpy() if hasattr(v, "numpy") else v)
                like = init.get(k)
                if isinstance(like, np.floating):
                    state[k] = _f32(arr.reshape(()))
                else:
                    dtype = like.dtype if isinstance(like, torch.Tensor) \
                        else None
                    state[k] = torch.as_tensor(arr, device=p.device).to(
                        dtype or torch.as_tensor(arr).dtype)
            self._accumulators[id(item)] = state
        if "LR_Scheduler" in state_dict and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state_dict["LR_Scheduler"])


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply(self, params, grads, states, lr, owners):
        # p - lr * g.astype(p.dtype)
        torch._foreach_add_(params, [g.to(p.dtype) for g, p in
                                     zip(grads, params)], alpha=-lr)

    def rule(self, p, g, state, lr):
        return p - lr * g.to(p.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        """The velocity, in the parameter's dtype (as in the JAX rule)."""
        return {"velocity": torch.zeros_like(p)}

    def _apply(self, params, grads, states, lr, owners):
        """v = mu v + g; p -= lr (g + mu v) with Nesterov, else lr v."""
        g = [gi.to(p.dtype) for gi, p in zip(grads, params)]
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, g)
        upd = torch._foreach_add(g, v, alpha=self._momentum) \
            if self._nesterov else v
        torch._foreach_sub_(params, torch._foreach_mul(upd, lr))

    def rule(self, p, g, state, lr):
        g = g.to(p.dtype)
        v = self._momentum * state["velocity"] + g
        p = p - lr * (g + self._momentum * v) if self._nesterov \
            else p - lr * v
        return p, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        if multi_precision:
            raise NotImplementedError(
                "multi_precision=True: f32 master weights are not ported "
                "(the JAX package's optimizers keep none either, so they are "
                "no roadmap item)")
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

    def _apply(self, params, grads, states, lr, owners):
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

    def rule(self, p, g, state, lr):
        g = g.float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        b1p = _f32(state["beta1_pow"] * _f32(b1))
        b2p = _f32(state["beta2_pow"] * _f32(b2))
        mhat = m / float(_f32(1) - b1p)
        vhat = v / float(_f32(1) - b2p)
        upd = lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        return p - upd.to(p.dtype), {"moment1": m, "moment2": v,
                                     "beta1_pow": b1p, "beta2_pow": b2p}


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

    def _apply(self, params, grads, states, lr, owners):
        """p = p - lr * wd * p on the masked parameters, in their own
        dtype, then the Adam rule."""
        wd = float(self._weight_decay or 0.0)
        if wd:
            decayed = [p for p, o in zip(params, owners)
                       if self._decay_ids is None
                       or id(o) in self._decay_ids]
            if decayed:
                step = torch._foreach_mul(decayed, float(_f32(lr) * _f32(wd)))
                torch._foreach_sub_(decayed, step)
        super()._apply(params, grads, states, lr, owners)

    def rule(self, p, g, state, lr, decay=True):
        wd = float(self._weight_decay or 0.0)
        if wd and decay:
            p = p - lr * wd * p
        return super().rule(p, g, state, lr)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _f32(1.0)}

    def _apply(self, params, grads, states, lr, owners):
        """m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
        p -= lr m / ((1 - b1^t) (u + eps))."""
        b1 = self._beta1
        g32 = [g.float() for g in grads]
        m = [s["moment"] for s in states]
        u = [s["inf_norm"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g32))
        c = []
        for s in states:
            s["beta1_pow"] = _f32(s["beta1_pow"] * _f32(b1))
            c.append(float(_f32(1) - s["beta1_pow"]))
        den = torch._foreach_add(u, self._epsilon)
        torch._foreach_mul_(den, c)
        upd = torch._foreach_mul(m, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(params, [x.to(p.dtype) for x, p in
                                     zip(upd, params)])

    def rule(self, p, g, state, lr):
        g = g.float()
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g))
        b1p = _f32(state["beta1_pow"] * _f32(self._beta1))
        upd = lr * m / (float(_f32(1) - b1p) * (u + self._epsilon))
        return p - upd.to(p.dtype), {"moment": m, "inf_norm": u,
                                     "beta1_pow": b1p}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-06,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
             "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _apply(self, params, grads, states, lr, owners):
        """ms = rho ms + (1 - rho) g^2; mom = momentum mom + lr g / sqrt(
        ms [- mg^2] + eps); p -= mom."""
        rho = self._rho
        g32 = [g.float() for g in grads]
        ms = [s["mean_square"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, g32, g32, value=1 - rho)
        if self._centered:
            mg = [s["mean_grad"] for s in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, g32, alpha=1 - rho)
            den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        else:
            den = [x.clone() for x in ms]
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_sqrt_(den)
        mom = [s["momentum"] for s in states]
        torch._foreach_mul_(mom, self._momentum)
        step = torch._foreach_mul(g32, lr)
        torch._foreach_div_(step, den)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(params, [x.to(p.dtype) for x, p in
                                     zip(mom, params)])

    def rule(self, p, g, state, lr):
        g = g.float()
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        new = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            new["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + lr * g / denom
        new["momentum"] = mom
        return p - mom.to(p.dtype), new


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_value,
                                          dtype=torch.float32)}

    def _apply(self, params, grads, states, lr, owners):
        """mom += g^2; p -= lr g / (sqrt(mom) + eps)."""
        g32 = [g.float() for g in grads]
        mom = [s["moment"] for s in states]
        torch._foreach_addcmul_(mom, g32, g32)
        den = torch._foreach_sqrt(mom)
        torch._foreach_add_(den, self._epsilon)
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_sub_(params, [x.to(p.dtype) for x, p in
                                     zip(upd, params)])

    def rule(self, p, g, state, lr):
        g = g.float()
        mom = state["moment"] + g * g
        upd = lr * g / (torch.sqrt(mom) + self._epsilon)
        return p - upd.to(p.dtype), {"moment": mom}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(
                    p, dtype=torch.float32)}

    def _apply(self, params, grads, states, lr, owners):
        """asg = rho asg + (1 - rho) g^2; upd = g sqrt(asu + eps) /
        sqrt(asg + eps); asu = rho asu + (1 - rho) upd^2; p -= lr upd."""
        rho, eps = self._rho, self._epsilon
        g32 = [g.float() for g in grads]
        asg = [s["avg_squared_grad"] for s in states]
        asu = [s["avg_squared_update"] for s in states]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, g32, g32, value=1 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        upd = torch._foreach_mul(g32, num)
        torch._foreach_div_(upd, torch._foreach_sqrt(
            torch._foreach_add(asg, eps)))
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        torch._foreach_sub_(params, torch._foreach_mul(
            [x.to(p.dtype) for x, p in zip(upd, params)], lr))

    def rule(self, p, g, state, lr):
        g = g.float()
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return p - lr * upd.to(p.dtype), {"avg_squared_grad": asg,
                                          "avg_squared_update": asu}


def _ratios(num, den, ok, scale):
    """``scale * where(ok, num / den, 1)`` over per-parameter values
    stacked into vectors -> one 0-d tensor a parameter (no host read)."""
    r = torch.where(ok, num / den, torch.ones_like(num))
    return list((scale * r).unbind(0))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        # stored and never read, as in the JAX package (ROADMAP C)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _f32(1.0), "beta2_pow": _f32(1.0)}

    def _apply(self, params, grads, states, lr, owners):
        """Adam's moments and bias corrections; r = mhat / (sqrt(vhat) +
        eps) + wd p; p -= lr trust r with trust = |p| / |r| where both
        are positive, else 1."""
        b1, b2 = self._beta1, self._beta2
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
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
        r = torch._foreach_div(m, c1)
        den = torch._foreach_sqrt(torch._foreach_div(v, c2))
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(r, den)
        torch._foreach_add_(r, p32, alpha=self._lamb_wd)
        w = torch.stack(torch._foreach_norm(p32))
        n = torch.stack(torch._foreach_norm(r))
        trust = _ratios(w, n, (w > 0) & (n > 0), lr)
        torch._foreach_mul_(r, trust)
        torch._foreach_sub_(params, [x.to(p.dtype) for x, p in
                                     zip(r, params)])

    def rule(self, p, g, state, lr):
        g = g.float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        b1p = _f32(state["beta1_pow"] * _f32(b1))
        b2p = _f32(state["beta2_pow"] * _f32(b2))
        mhat = m / float(_f32(1) - b1p)
        vhat = v / float(_f32(1) - b2p)
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + \
            self._lamb_wd * p.float()
        w_norm = torch.linalg.vector_norm(p.float())
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return (p - (lr * trust * r).to(p.dtype),
                {"moment1": m, "moment2": v, "beta1_pow": b1p,
                 "beta2_pow": b2p})


class Lars(Optimizer):
    """LARS momentum: the per-layer trust ratio ||w|| / (||g|| + wd ||w||)
    scales the learning rate (reference LarsMomentumOptimizer)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._wd = lars_weight_decay
        self._epsilon = epsilon

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _apply(self, params, grads, states, lr, owners):
        """local = coeff |w| / (|g| + wd |w| + eps) where both norms are
        positive, else 1; v = mu v + lr local (g + wd w); p -= v."""
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        w = torch.stack(torch._foreach_norm(p32))
        g = torch.stack(torch._foreach_norm(g32))
        local = _ratios(self._coeff * w, g + self._wd * w + self._epsilon,
                        (w > 0) & (g > 0), lr)
        step = torch._foreach_add(g32, p32, alpha=self._wd)
        torch._foreach_mul_(step, local)
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, step)
        torch._foreach_sub_(params, [x.to(p.dtype) for x, p in
                                     zip(v, params)])

    def rule(self, p, g, state, lr):
        g = g.float()
        pf = p.float()
        w_norm = torch.linalg.vector_norm(pf)
        g_norm = torch.linalg.vector_norm(g)
        local = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + self._wd * w_norm
                                    + self._epsilon),
            torch.ones_like(w_norm))
        v = self._momentum * state["velocity"] + \
            lr * local * (g + self._wd * pf)
        return p - v.to(p.dtype), {"velocity": v}
