"""Strategy-driven optimizer/model rewrites — the meta-optimizer layer.

Reference: python/paddle/distributed/fleet/meta_optimizers/ (21 program
-rewriting passes chosen by StrategyCompiler / meta_optimizer_factory).
Port of ``paddle_tpu/distributed/fleet/meta_optimizers.py``: each
strategy becomes an optimizer wrapper (gradient merge, localsgd +
adaptive localsgd, DGC, fp16 allreduce, ASP sparsity guarantee,
LARS/LAMB swap) or a model wrapper (recompute) applied by
``fleet.distributed_optimizer`` / ``fleet.distributed_model`` from the
same ``DistributedStrategy`` fields the reference reads, with the JAX
module's rules and composition order.  The port runs one process a
rank, so the wrappers' collectives (localsgd's parameter average, the
fp16 gradient average, adaptive localsgd's loss average) run over the
data-parallel ``Group`` as ``torch.distributed`` calls
(``communication.py``), and every gradient and parameter is updated in
place on its leaf tensor.

Strategies that need no wrapper: ``fuse_all_reduce_ops``/
``fuse_grad_merge`` (``fused_allreduce_gradients`` fuses the gradient
average itself); ``tensor_parallel`` and ``sharding`` are structural
(``TensorParallel``, ``sharding/``).
"""

import numpy as np
import torch

from ..parallel import _leaf

__all__ = ["GradientMergeOptimizer", "LocalSGDOptimizer",
           "AdaptiveLocalSGDOptimizer", "DGCMomentumOptimizer",
           "FP16AllReduceOptimizer", "apply_strategy_to_optimizer",
           "apply_recompute_to_model"]


class _OptimizerWrapper:
    """Delegates everything to the inner optimizer unless overridden."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _leaves(self):
        """The trainable parameters' leaf tensors that have a gradient."""
        return [_leaf(p) for p in self._inner._parameters
                if _leaf(p).grad is not None and _leaf(p).requires_grad]


class GradientMergeOptimizer(_OptimizerWrapper):
    """Accumulate k micro-batch gradients, then apply one update
    (reference meta_optimizers/gradient_merge_optimizer.py; k_steps/avg
    from strategy.gradient_merge_configs).

    Eager contract: grads accumulate in ``.grad`` across backward calls;
    ``step``/``clear_grad`` only take effect on every k-th call.
    """

    def __init__(self, inner, k_steps=1, avg=True):
        super().__init__(inner)
        self.k_steps = max(1, int(k_steps))
        self.avg = avg
        self._micro = 0

    def step(self):
        self._micro += 1
        if self._micro % self.k_steps != 0:
            return
        if self.avg and self.k_steps > 1:
            scale = 1.0 / self.k_steps
            with torch.no_grad():
                for leaf in self._leaves():
                    leaf.grad.mul_(scale)
        self._inner.step()

    def clear_grad(self, set_to_zero=False):
        if self._micro % self.k_steps == 0:
            self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


class LocalSGDOptimizer(_OptimizerWrapper):
    """Step locally; average parameters across the data-parallel group
    every k steps (reference meta_optimizers/localsgd_optimizer.py).
    Cuts per-step allreduce traffic to 1/k at the cost of staleness."""

    def __init__(self, inner, k_steps=1, group=None):
        super().__init__(inner)
        self.k_steps = max(1, int(k_steps))
        self.group = group
        self._local = 0

    def step(self):
        self._inner.step()
        self._local += 1
        if self._local % self.k_steps == 0:
            self._sync_params()

    def _sync_params(self):
        from .. import communication as dist

        for p in self._inner._parameters:
            # AVG does the reduce and the 1/world scaling in one
            # collective, in place on the leaf
            dist.all_reduce(_leaf(p), op=dist.ReduceOp.AVG,
                            group=self.group)


class FP16AllReduceOptimizer(_OptimizerWrapper):
    """Compress the gradient allreduce to fp16
    (reference meta_optimizers/fp16_allreduce_optimizer.py): before the
    inner step, each gradient is cast to fp16, averaged across the
    data-parallel group, and cast back — halving the gradient bytes each
    rank sends."""

    def __init__(self, inner, group=None):
        super().__init__(inner)
        self.group = group

    def step(self, **kwargs):
        from .. import communication as dist

        for leaf in self._leaves():
            g16 = leaf.grad.to(torch.float16)
            dist.all_reduce(g16, op=dist.ReduceOp.AVG, group=self.group)
            with torch.no_grad():
                leaf.grad.copy_(g16)
        self._inner.step(**kwargs)


class AdaptiveLocalSGDOptimizer(LocalSGDOptimizer):
    """LocalSGD whose sync period adapts to training progress
    (reference meta_optimizers/localsgd_optimizer.py
    AdaptiveLocalSGDOptimizer, after Wang & Joshi's adaptive
    communication schedule):

        next_k = clip(ceil(sqrt(lr_0 * loss / (lr * loss_0)
                                * init_k_steps)), 1, 16)

    — early training (loss near loss_0) syncs often; as the loss drops
    the sync period stretches, cutting communication exactly when the
    replicas drift slowest.  Eager contract: pass the step's loss to
    ``step(loss=...)``; the first call pins (lr_0, loss_0) and each sync
    re-evaluates the period using the group-averaged loss.
    """

    def __init__(self, inner, init_k_steps=1, begin_step=1, group=None):
        super().__init__(inner, k_steps=init_k_steps, group=group)
        self.init_k_steps = max(1, int(init_k_steps))
        self.begin_step = max(1, int(begin_step))
        self._lr0 = None
        self._loss0 = None
        self._step_no = 0

    def _lr_value(self):
        return float(self._inner.get_lr())

    def step(self, loss=None):
        self._inner.step()
        self._step_no += 1
        if loss is None:
            # without a loss signal behave like plain LocalSGD
            self._local += 1
            if self._local % self.k_steps == 0:
                self._sync_params()
            return
        data = _leaf(loss)
        lval = float(data.detach() if isinstance(data, torch.Tensor)
                     else data)
        if self._loss0 is None:
            # pin against the GROUP-average loss: a single replica's
            # shard loss would skew every later adaptation
            self._loss0 = max(self._avg_loss(lval), 1e-12)
            self._lr0 = max(self._lr_value(), 1e-12)
        if self._step_no < self.begin_step:
            # reference semantics: begin_step delays LOCAL sgd — the
            # warm-up trains fully synchronously, syncing EVERY step
            self._sync_params()
            return
        self._local += 1
        if self._local % self.k_steps == 0:
            self._sync_params()
            lr = max(self._lr_value(), 1e-12)
            nxt = int(np.ceil(np.sqrt(
                self._lr0 * max(self._avg_loss(lval), 0.0)
                / (lr * self._loss0) * self.init_k_steps)))
            self.k_steps = min(max(nxt, 1), 16)

    def _avg_loss(self, lval):
        if self.group is None and _world_size() <= 1:
            return lval
        from .. import communication as dist

        t = torch.tensor([lval], dtype=torch.float32)
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=self.group)
        return float(t[0])


def _world_size():
    from ..parallel import get_world_size

    return get_world_size()


class DGCMomentumOptimizer(_OptimizerWrapper):
    """Deep Gradient Compression (reference meta_optimizers/dgc_optimizer
    .py, Lin et al. 2018): keep only the top-``(1-sparsity)`` fraction of
    each gradient by magnitude, with the paper's MOMENTUM CORRECTION —
    local momentum ``u = m*u + g`` accumulates into a velocity buffer
    ``v += u``; the top-k of ``v`` is sent and both buffers are cleared
    at sent positions (momentum factor masking), so DELAYED coordinates
    carry their momentum history instead of a bare residual: constant
    grad g delayed 3 steps accumulates (3 + 2m + m^2)g = 5.61g at m=0.9
    where residual-only error feedback would send 3g.  Always-sent
    coordinates restart u each step (paper Algorithm 1), so the dense
    limit is plain SGD — the momentum lives in the correction of delayed
    coordinates, not in the server update.  Use with a plain-SGD inner
    optimizer — DGC owns the momentum (the reference
    DGCMomentumOptimizer likewise replaces Momentum; the strategy
    compiler enforces this)."""

    def __init__(self, inner, sparsity=0.9, momentum=0.9):
        super().__init__(inner)
        self.sparsity = float(sparsity)
        self.momentum = float(momentum)
        self._u = {}  # local momentum
        self._v = {}  # accumulated velocity (what gets sent)

    @torch.no_grad()
    def step(self):
        for p in self._inner._parameters:
            leaf = _leaf(p)
            if leaf.grad is None or not leaf.requires_grad:
                continue
            g = leaf.grad
            u = self._u.get(id(p))
            u = g.clone() if u is None else self.momentum * u + g
            v = self._v.get(id(p))
            v = u if v is None else v + u
            flat = v.abs().reshape(-1)
            k = max(1, int(flat.numel() * (1.0 - self.sparsity)))
            thresh = torch.sort(flat).values[-k]
            mask = v.abs() >= thresh
            sent = torch.where(mask, v, torch.zeros_like(v))
            # momentum factor masking: sent coordinates restart history
            self._u[id(p)] = torch.where(mask, torch.zeros_like(u), u)
            self._v[id(p)] = v - sent
            leaf.grad = sent
        self._inner.step()


def apply_strategy_to_optimizer(optimizer, strategy, hcg=None):
    """StrategyCompiler parity: stack the wrappers the strategy asks for.

    Order mirrors the reference compiler: optimizer swap (lars/lamb, and
    Momentum → SGD under dgc) → compression (dgc, fp16 allreduce) →
    accumulation (gradient_merge, so the merged gradient is allreduced
    ONCE, not per micro-step) → comm reduction (localsgd).  With an
    ``hcg`` (``fleet.distributed_optimizer``) the swapped base optimizer
    is wrapped in the ``HybridParallelOptimizer`` under every wrapper, so
    that its gradient sync and clip run once an update, where the base
    optimizer's own clip would."""
    if hcg is not None:
        from .hybrid_parallel_optimizer import HybridParallelOptimizer

        def wrap_base(opt):
            return HybridParallelOptimizer(opt, hcg, strategy)
    else:
        def wrap_base(opt):
            return opt
    if strategy is None:
        return wrap_base(optimizer)
    if getattr(strategy, "fp16_allreduce", False) and (
            getattr(strategy, "localsgd", False)
            or getattr(strategy, "adaptive_localsgd", False)):
        # a localsgd program HAS no per-step grad allreduce to compress
        # (reference fp16_allreduce only rewrites existing allreduce
        # ops); stacking them would silently reintroduce per-step sync
        raise ValueError(
            "fp16_allreduce cannot combine with localsgd/"
            "adaptive_localsgd: LocalSGD removes the per-step gradient "
            "allreduce that fp16_allreduce compresses")
    dp_group = hcg.get_data_parallel_group() if hcg is not None else None

    if getattr(strategy, "lamb", False) and \
            type(optimizer).__name__ not in ("Lamb",):
        from ...optimizer import Lamb

        kw = {}
        if optimizer._weight_decay:  # carry regularization over
            kw["lamb_weight_decay"] = float(optimizer._weight_decay)
        optimizer = Lamb(learning_rate=optimizer._lr,
                         parameters=optimizer._parameters,
                         grad_clip=optimizer._grad_clip, **kw)
    if getattr(strategy, "lars", False) and \
            type(optimizer).__name__ not in ("Lars",):
        from ...optimizer import Lars

        kw = {}
        if optimizer._weight_decay:
            kw["lars_weight_decay"] = float(optimizer._weight_decay)
        optimizer = Lars(learning_rate=optimizer._lr,
                         parameters=optimizer._parameters,
                         grad_clip=optimizer._grad_clip, **kw)
    dgc_cfg = getattr(strategy, "dgc_configs", None) or {}
    momentum = dgc_cfg.get("momentum")
    if getattr(strategy, "dgc", False) and \
            type(optimizer).__name__ == "Momentum":
        # reference pairing: DGC REPLACES Momentum (dgc_optimizer.py) —
        # wrapping a Momentum inner would apply momentum twice, so swap
        # it for SGD and inherit its momentum coefficient
        from ...optimizer import SGD

        if momentum is None:
            momentum = float(getattr(optimizer, "_momentum", 0.9))
        optimizer = SGD(learning_rate=optimizer._lr,
                        parameters=optimizer._parameters,
                        grad_clip=optimizer._grad_clip)
    optimizer = wrap_base(optimizer)
    if getattr(strategy, "dgc", False):
        optimizer = DGCMomentumOptimizer(
            optimizer, sparsity=dgc_cfg.get("sparsity", 0.9),
            momentum=0.9 if momentum is None else float(momentum))
    if getattr(strategy, "fp16_allreduce", False):
        # BEFORE gradient_merge: the merge wrapper then gates this step,
        # so the merged gradient crosses the wire once (outside the
        # merge, fp16 quantization would compound per micro-step and
        # could overflow the unscaled sum)
        optimizer = FP16AllReduceOptimizer(optimizer, group=dp_group)
    if getattr(strategy, "gradient_merge", False):
        cfg = strategy.gradient_merge_configs
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=cfg.get("k_steps", 1),
            avg=cfg.get("avg", True))
    if getattr(strategy, "adaptive_localsgd", False):
        cfg = getattr(strategy, "adaptive_localsgd_configs", None) or {}
        optimizer = AdaptiveLocalSGDOptimizer(
            optimizer, init_k_steps=cfg.get("init_k_steps", 1),
            begin_step=cfg.get("begin_step", 1), group=dp_group)
    elif getattr(strategy, "localsgd", False):
        # hybrid runs average over the DP axis only — the world group
        # would mix mp/pp shards holding different tensors
        cfg = getattr(strategy, "localsgd_configs", None) or {}
        optimizer = LocalSGDOptimizer(optimizer,
                                      k_steps=cfg.get("k_steps", 4),
                                      group=dp_group)
    if getattr(strategy, "asp", False):
        # reference asp_optimizer.py OptimizerWithSparsityGuarantee:
        # 2:4 masks re-apply after every step so pruned weights never
        # regrow (prune_model must have been called on the model)
        from ...incubate.asp import decorate as _asp_decorate

        optimizer = _asp_decorate(optimizer)
    return optimizer


def apply_recompute_to_model(model, strategy):
    """strategy.recompute → wrap the configured sublayers' forwards in
    ``recompute`` (reference recompute meta-optimizer / recompute_configs
    ["checkpoints"]).  Empty checkpoints = wrap every direct child that
    has parameters."""
    if not getattr(strategy, "recompute", False):
        return model
    from .recompute import recompute

    names = strategy.recompute_configs.get("checkpoints") or None

    def wrap(layer):
        orig = layer.forward

        def fwd(*args, **kwargs):
            if kwargs:
                return orig(*args, **kwargs)  # kwargs not traced: passthrough
            return recompute(orig, *args)

        layer.forward = fwd
        return layer

    if names:
        for name in names:
            node = model
            parts = name.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            wrap(getattr(node, parts[-1]))
    else:
        for _, child in model.named_children() \
                if hasattr(model, "named_children") else []:
            if any(True for _ in child.parameters()):
                wrap(child)
    return model
