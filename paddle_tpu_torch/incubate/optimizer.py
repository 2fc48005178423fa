"""incubate optimizers (port of ``paddle_tpu/incubate/optimizer.py``):
LookAhead, ModelAverage (reference
python/paddle/incubate/optimizer/{lookahead,modelaverage}.py).

Both wrap a base optimizer over the same eager step()/clear_grad()
contract.  The JAX classes rebind parameters to new arrays; the port's
optimizers update parameters in place, so these copy into them (under
``no_grad``) and keep their own buffers (the slow weights, the window
sums, the backup) as separate tensors.  ``state_dict`` /
``set_state_dict`` carry that state as numpy-convertible values under
the JAX attributes' names, beside the inner optimizer's.
"""

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["LookAhead", "ModelAverage"]


def _data(p):
    return p._data if isinstance(p, Tensor) else p


def _like(p, value):
    """``value`` (a tensor or array) as a tensor on ``p``'s device in its
    dtype."""
    if isinstance(value, Tensor):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.array(value))
    d = _data(p)
    return value.detach().to(device=d.device, dtype=d.dtype).clone()


class LookAhead:
    """k steps forward, one step back (Zhang et al.; reference
    lookahead.py): every k inner steps, slow weights move alpha of the
    way toward the fast weights and the fast weights reset to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_num = 0
        self._slow = {}

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)

    @torch.no_grad()
    def step(self):
        params = self.inner_optimizer._parameters
        if self._step_num == 0:
            for p in params:
                self._slow[id(p)] = _data(p).detach().clone()
        self.inner_optimizer.step()
        self._step_num += 1
        if self._step_num % self.k == 0:
            for p in params:
                slow = self._slow[id(p)]
                slow = slow + self.alpha * (_data(p) - slow)
                self._slow[id(p)] = slow
                _data(p).copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        sd = dict(self.inner_optimizer.state_dict())
        sd["lookahead.step_num"] = self._step_num
        for i, p in enumerate(self.inner_optimizer._parameters):
            if id(p) in self._slow:
                sd[f"lookahead.slow.param{i}"] = self._slow[id(p)]
        return sd

    def set_state_dict(self, state_dict):
        self.inner_optimizer.set_state_dict(
            {k: v for k, v in state_dict.items()
             if not str(k).startswith("lookahead.")})
        self._step_num = int(state_dict.get("lookahead.step_num", 0))
        self._slow = {}
        for i, p in enumerate(self.inner_optimizer._parameters):
            v = state_dict.get(f"lookahead.slow.param{i}")
            if v is not None:
                self._slow[id(p)] = _like(p, v)


class ModelAverage:
    """Maintain a windowed average of parameters for evaluation (reference
    modelaverage.py): apply() swaps averaged weights in, restore() swaps
    the training weights back.

    Window semantics follow the reference's tiered-sum scheme: when the
    accumulated count reaches ``max_average_window`` the current sums
    roll into an "old" block and restart, and the old block is dropped
    when the fresh one fills — so the average always covers between one
    and two windows of trailing steps, never the full history.
    """

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required")
        self._parameters = list(parameters)
        self.max_average_window = int(max_average_window)
        self.min_average_window = int(min_average_window)
        self.average_window_rate = average_window_rate
        self._sum = self._zeros()
        self._old_sum = None
        self._count = 0
        self._old_count = 0
        self._num_updates = 0
        self._backup = None

    def _zeros(self):
        return {id(p): torch.zeros_like(_data(p).detach())
                for p in self._parameters}

    def _effective_window(self):
        """Reference dynamic rule: min(max(num_updates * rate,
        min_average_window), max_average_window)."""
        dyn = self._num_updates * self.average_window_rate
        return int(min(max(dyn, self.min_average_window),
                       self.max_average_window))

    @torch.no_grad()
    def step(self):
        """Accumulate the current weights (call after optimizer.step())."""
        for p in self._parameters:
            self._sum[id(p)] = self._sum[id(p)] + _data(p)
        self._count += 1
        self._num_updates += 1
        if self._count >= self._effective_window():
            # roll the window (reference sum_1/sum_2 rotation)
            self._old_sum = self._sum
            self._old_count = self._count
            self._sum = self._zeros()
            self._count = 0

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap in the averaged weights."""
        total = self._count + self._old_count
        if total == 0:
            return
        backup = {id(p): _data(p).detach().clone() for p in self._parameters}
        if need_restore:
            self._backup = backup
        for p in self._parameters:
            s = self._sum[id(p)]
            if self._old_sum is not None:
                s = s + self._old_sum[id(p)]
            _data(p).copy_(s / total)

    @torch.no_grad()
    def restore(self, executor=None):
        """Swap the training weights back."""
        if self._backup is None:
            return
        for p in self._parameters:
            _data(p).copy_(self._backup[id(p)])
        self._backup = None

    def __enter__(self):
        self.apply()
        return self

    def __exit__(self, *exc):
        self.restore()

    def state_dict(self):
        sd = {"count": self._count, "old_count": self._old_count,
              "num_updates": self._num_updates}
        for i, p in enumerate(self._parameters):
            sd[f"sum.param{i}"] = self._sum[id(p)]
            if self._old_sum is not None:
                sd[f"old_sum.param{i}"] = self._old_sum[id(p)]
        return sd

    def set_state_dict(self, state_dict):
        self._count = int(state_dict.get("count", 0))
        self._old_count = int(state_dict.get("old_count", 0))
        self._num_updates = int(state_dict.get("num_updates", 0))
        ps = self._parameters
        self._sum = {id(p): _like(p, state_dict[f"sum.param{i}"])
                     for i, p in enumerate(ps)}
        self._old_sum = None
        if "old_sum.param0" in state_dict:
            self._old_sum = {id(p): _like(p, state_dict[f"old_sum.param{i}"])
                             for i, p in enumerate(ps)}
