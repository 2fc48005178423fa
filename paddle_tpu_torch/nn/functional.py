"""nn.functional — the subset of ``paddle_tpu/nn/functional.py`` that the
GPT training path and the Llama model run, in PyTorch.

``layer_norm`` and ``scaled_dot_product_attention`` reach the
hand-written CUDA kernels on CUDA tensors (LayerNorm B4,
``ops/cuda/layernorm_kernel.py``; flash attention B2/B3 through
``ops/attention.py``) and the JAX package's plain compositions on the
CPU.  ``cross_entropy`` keeps the JAX package's chunked f32 softmax
cross entropy, which is XLA composition there and plain PyTorch here.
Randomness (dropout) draws from an explicit ``torch.Generator``; with
``generator=None`` it draws from PyTorch's default generator of the
tensor's device.
"""

import torch

from ..ops.attention import flash_attention as _dispatch_attention
from ..ops.cuda.layernorm_kernel import layer_norm_plain, layernorm_cuda

# ---------------- activations ----------------


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


# ---------------- linear / embedding ----------------


def linear(x, weight, bias=None):
    """y = x @ W + b; weight layout [in, out] (Paddle convention)."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` are zeros.
    ``sparse`` is accepted and ignored, as in the JAX package."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


# ---------------- normalization ----------------


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the trailing ``normalized_shape`` dims.  A CUDA
    tensor normalised over its last dim with both ``weight`` and
    ``bias`` launches the LayerNorm kernels (forward and backward),
    which raise for a shape they do not take; every other call is the
    JAX composition."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if (x.is_cuda and len(normalized_shape) == 1 and weight is not None
            and bias is not None):
        return layernorm_cuda(x, weight, bias, eps=epsilon)
    return layer_norm_plain(x, normalized_shape, weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon=1e-06, axis=-1):
    """RMSNorm: ``x * rsqrt(mean(x ** 2) + epsilon) * weight`` over
    ``axis``, in the input's dtype (the llama family's norm)."""
    var = x.square().mean(dim=axis, keepdim=True)
    out = x * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    return out


# ---------------- dropout ----------------


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Zero elements with probability ``p``.  ``upscale_in_train`` scales
    the kept ones by ``1 / (1 - p)`` in training and is the identity in
    eval; ``downscale_in_infer`` keeps them unscaled in training and
    scales by ``1 - p`` in eval.  ``axis`` shares one draw along the
    other dims."""
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


# ---------------- loss ----------------

_XENT_CHUNK = 256


def _xent_rows(x_c, y_c):
    x32 = x_c.float()
    m = x32.max(dim=-1).values
    lse = m + torch.log(torch.exp(x32 - m[:, None]).sum(dim=-1))
    picked = x32.gather(-1, y_c[:, None]).squeeze(-1)
    return lse - picked, lse


class _ChunkedSoftmaxXent(torch.autograd.Function):
    """Per-row softmax cross entropy without an f32 copy of all the
    logits (``_chunked_softmax_xent``): both passes walk 256-row chunks
    when the rows divide into them; the backward recomputes the softmax
    from the saved per-row lse and returns the gradient in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits2d, labels1d):
        n = logits2d.shape[0]
        if n % _XENT_CHUNK:
            loss, lse = _xent_rows(logits2d, labels1d)
        else:
            parts = [_xent_rows(x, y) for x, y in zip(
                logits2d.split(_XENT_CHUNK), labels1d.split(_XENT_CHUNK))]
            loss = torch.cat([p[0] for p in parts])
            lse = torch.cat([p[1] for p in parts])
        ctx.save_for_backward(logits2d, labels1d, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2d, labels1d, lse = ctx.saved_tensors
        n = logits2d.shape[0]
        chunk = n if n % _XENT_CHUNK else _XENT_CHUNK
        grad = torch.empty_like(logits2d)
        for s in range(0, n, chunk):
            x_c = logits2d[s:s + chunk].float()
            p = torch.exp(x_c - lse[s:s + chunk, None])
            p[torch.arange(p.shape[0], device=p.device),
              labels1d[s:s + chunk]] -= 1.0
            grad[s:s + chunk] = p * g[s:s + chunk, None]
        return grad, None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy over the last axis with hard labels, in f32
    whatever the logits' dtype.  Rows whose label is ``ignore_index``
    count zero; ``mean`` divides by the number of the other rows (at
    least 1).  Soft labels, class weights, label smoothing, another
    axis or ``use_softmax=False`` are not ported yet."""
    ax = axis if axis >= 0 else input.dim() + axis
    if (not use_softmax or soft_label or label_smoothing != 0.0
            or weight is not None or ax != input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis with "
            "softmax, no weight and no smoothing are ported (the rest is "
            "slice 8, the long tail)")
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    v = input.shape[-1]
    flat = input.reshape(-1, v)
    lbl_flat = lbl.reshape(-1).long()
    valid = lbl_flat != ignore_index
    safe = torch.where(valid, lbl_flat, 0)
    loss = _ChunkedSoftmaxXent.apply(flat, safe)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp(min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(lbl.shape)


# ---------------- attention ----------------


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """SDPA on [batch, seq, heads, dim] (Paddle layout).  Attention
    dropout applies in training only and draws from ``generator``."""
    use_drop = dropout_p > 0.0 and training
    return _dispatch_attention(query, key, value, attn_mask=attn_mask,
                               is_causal=is_causal,
                               dropout_p=dropout_p if use_drop else 0.0,
                               generator=generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True):
    """Paddle's ``flash_attention`` API -> ``(out, None)``.  As in the
    JAX package, ``dropout`` is not applied and no softmax is
    returned."""
    out = scaled_dot_product_attention(query, key, value, is_causal=causal,
                                       training=training)
    return out, None


__all__ = ["cross_entropy", "dropout", "embedding",
           "flash_attention", "gelu", "layer_norm", "linear", "rms_norm",
           "scaled_dot_product_attention"]
