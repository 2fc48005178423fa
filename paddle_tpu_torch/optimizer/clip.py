"""Gradient clipping (port of ``paddle_tpu/optimizer/clip.py``).

``_clip(params, grads)`` takes and returns lists of gradient tensors;
norms are taken in f32 and each clipped gradient is cast back to its
own dtype, as the JAX rules do.  The inputs are not modified.
"""

import torch


class ClipGradBase:
    def _clip(self, params, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params, grads):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params, grads):
        out = []
        for g in grads:
            g32 = g.float()
            norm = torch.sqrt(torch.sum(g32 * g32))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((g32 * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        """sqrt of the sum of every gradient's f32 sum of squares."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.sqrt(torch.sum(torch.stack(norms) ** 2))

    def _clip(self, params, grads):
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        # one rounding from the f32 product to each gradient's dtype
        return torch._foreach_mul(grads, scale)
