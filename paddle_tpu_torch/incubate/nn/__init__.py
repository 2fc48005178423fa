"""incubate.nn — the pieces of the fused inference transformer the
serving engine shares.  Only ``_layernorm`` is ported so far; the
FusedMultiTransformer itself comes with the dense decode-attention
kernel."""

import torch


def _layernorm(x, w, b, eps):
    """LayerNorm over the last dim as the serving step composes it:
    mean, then ``mean((x - mu) ** 2)``, then ``rsqrt``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b
