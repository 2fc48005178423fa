"""MoE-aware global-norm gradient clipping.

Port of ``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``
(reference python/paddle/incubate/distributed/models/moe/grad_clip.py,
ClipGradForMOEByGlobalNorm).  An expert parameter's gradient belongs to
its expert-parallel rank only, so the expert share of the squared norm
is all-reduced over ``moe_group`` before it joins the dense share, which
every rank holds whole (the reference's two norms; the JAX module's
single controller sees both whole and only keeps them apart).
"""

import torch

from .....optimizer.clip import ClipGradBase


class ClipGradForMOEByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__()
        self.clip_norm = float(clip_norm)
        self.moe_group = moe_group
        self._is_expert = is_expert_param_func or (
            lambda p: getattr(p, "expert", False))

    def global_norm(self, params, grads):
        from .....distributed.fleet.meta_parallel import mp_layers

        dev = grads[0].device
        sq_dense = torch.zeros((), dtype=torch.float32, device=dev)
        sq_expert = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in zip(params, grads):
            contrib = torch.sum(torch.square(g.float()))
            if p is not None and self._is_expert(p):
                sq_expert = sq_expert + contrib
            else:
                sq_dense = sq_dense + contrib
        if self.moe_group is not None:
            sq_expert = mp_layers.all_reduce(sq_expert, self.moe_group)
        return torch.sqrt(sq_dense + sq_expert)

    def _clip(self, params, grads):
        if not grads:
            return grads
        norm = self.global_norm(params, grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
