"""HybridParallelOptimizer (reference
fleet/utils/../meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:238).

Port of ``paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py``.
The JAX wrapper passes through: a norm over sharded arrays is already
global there.  The port runs one process a rank, each holding its blocks,
so ``step`` does what the reference's wrapper does before the inner
step:

1. with dp > 1 under mp or pp, the gradients averaged over the
   data-parallel group (``fused_allreduce_gradients``; a model of pure
   data parallelism is ``DataParallel``, which averages them in the
   backward);
2. under sequence parallelism, the gradient of each parameter marked
   ``sequence_parallel`` (the replicated ones, whose gradient is a sum
   over the ranks' sequence shards) all-reduced over the mp group;
3. with mp > 1 and a ``ClipGradByGlobalNorm`` on the inner optimizer,
   the global norm taken over the whole model: the sums of squares of
   the gradients split over ``mp`` all-reduced over the mp group, each
   replicated gradient (the same on every rank) counted once; every
   gradient is then scaled by ``clip_norm / max(norm, clip_norm)``, as
   the inner clip would, and the inner step runs without its clip.

At mp == 1 and dp == 1 the inner step runs as it is (bitwise the
unwrapped optimizer).

``fleet.distributed_optimizer`` puts it directly around the base
optimizer, under the meta-optimizer wrappers (the JAX package puts its
pass-through outside them): a gradient-merge step that only
accumulates never reaches it, so the mp all-reduce and the clip act once
an update, on the merged gradients.
"""

import torch

from ...optimizer.clip import ClipGradByGlobalNorm
from ..parallel import _leaf
from .meta_parallel import mp_layers
from .utils.hybrid_parallel_util import fused_allreduce_gradients


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _params(self):
        return getattr(self._inner_opt, "_parameters", [])

    def _sync_sequence_parallel(self, group):
        grads = [_leaf(p).grad for p in self._params()
                 if getattr(p, "sequence_parallel", False)
                 and _leaf(p).grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = mp_layers.all_reduce(flat, group)
        off = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def global_norm(self, group):
        """The whole model's gradient norm (f32) over the mp ``group``."""
        split, repl = [], []
        for p in self._params():
            g = _leaf(p).grad
            if g is None or not _leaf(p).requires_grad:
                continue
            (split if "mp" in (getattr(p, "mesh_axes", None) or ())
             else repl).append(g)

        def sq(grads):
            if not grads:
                return torch.zeros((), dtype=torch.float32,
                                   device=self._device())
            norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
            return torch.sum(torch.stack(norms) ** 2)

        return torch.sqrt(mp_layers.all_reduce(sq(split), group) + sq(repl))

    def _device(self):
        return _leaf(self._params()[0]).device

    @torch.no_grad()
    def step(self, **kwargs):
        hcg = self._hcg
        mp = hcg.get_model_parallel_world_size()
        if hcg.get_data_parallel_world_size() > 1 and (
                mp > 1 or hcg.get_pipe_parallel_world_size() > 1):
            fused_allreduce_gradients(self._params(), hcg)
        inner = self._inner_opt
        clip = getattr(inner, "_grad_clip", None)
        if mp <= 1:
            inner.step(**kwargs)
            return
        group = hcg.get_model_parallel_group()
        self._sync_sequence_parallel(group)
        if not isinstance(clip, ClipGradByGlobalNorm):
            inner.step(**kwargs)
            return
        norm = self.global_norm(group)
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        grads = [_leaf(p).grad for p in self._params()
                 if _leaf(p).grad is not None]
        torch._foreach_mul_(grads, scale)
        inner._grad_clip = None
        try:
            inner.step(**kwargs)
        finally:
            inner._grad_clip = clip

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        return None, None

    @property
    def inner_opt(self):
        return self._inner_opt
