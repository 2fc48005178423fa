"""Attention: the plain composition and the flash dispatcher.

Port of ``paddle_tpu/ops/pallas/__init__.py``: ``_xla_attention``
becomes :func:`attention_plain` and ``flash_attention`` keeps its
semantic routes.  A mask, dropout, an explicit ``scale``, causal
attention with ``seq_q != seq_k`` (the kernel's causal mask is top-left
aligned, the composition's bottom-right) or a head_dim above 128 (the
JAX dispatcher sends it to ``_xla_attention``) take the plain
composition; every other call on CUDA tensors launches the hand-written
flash kernels (``ops/cuda/flash_attention_kernel.py``), which raise for
a shape outside their ``supports``.  The v5e-profiled
``FLAGS_flash_min_seqlen`` threshold is not carried over: the route
depends on the arguments only.  CPU tensors take the plain composition,
the kernels' plain version.
"""

import math

import torch

from .cuda.flash_attention_kernel import _MAX_D, flash_attention_cuda


def causal_logits(q, k, is_causal, scale):
    """f32 logits [B, N, T, S] of q [B, T, N, H] and k [B, S, N, H]:
    products of the input dtype's values accumulated in f32, times
    ``scale``, with the causal mask (bottom-right aligned) at the f32
    minimum."""
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    if is_causal:
        t, s = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((t, s), dtype=torch.bool,
                            device=q.device).tril(diagonal=s - t)
        logits = torch.where(causal, logits, torch.finfo(torch.float32).min)
    return logits


def attention_plain(q, k, v, attn_mask=None, is_causal=False, dropout_p=0.0,
                    generator=None, scale=None):
    """``_xla_attention`` on [B, T, N, H]: the score and context products
    accumulate in f32 from the input dtype's values, the softmax runs in
    f32, the probabilities are cast to the input dtype before the
    context product.  A bool ``attn_mask`` keeps where True; any other
    mask is added.  Dropout (``upscale_in_train``) keeps a probability
    where a uniform draw from ``generator`` is below ``1 - dropout_p``."""
    return attention_plain_with_logits(q, k, v, attn_mask, is_causal,
                                       dropout_p, generator, scale)[0]


def attention_plain_with_logits(q, k, v, attn_mask=None, is_causal=False,
                                dropout_p=0.0, generator=None, scale=None):
    """:func:`attention_plain` -> ``(out, logits)``, with the masked f32
    logits [B, N, T, S] it computed (the flash kernels' plain version
    takes its lse from them)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = causal_logits(q, k, is_causal, scale)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits,
                                 torch.finfo(torch.float32).min)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bnts,bsnh->btnh", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype), logits


def kernel_route(q, k, attn_mask=None, is_causal=False, dropout_p=0.0,
                 scale=None):
    """Whether a call on CUDA tensors takes the flash kernels: no mask,
    no dropout, the default scale, causal only with seq_q == seq_k, and a
    head_dim of at most 128."""
    return (attn_mask is None and dropout_p == 0.0 and scale is None
            and (not is_causal or q.shape[1] == k.shape[1])
            and q.shape[-1] <= _MAX_D)


def flash_attention(q, k, v, attn_mask=None, is_causal=False, dropout_p=0.0,
                    generator=None, scale=None):
    """Attention on [batch, seq, num_heads, head_dim], routed as the JAX
    dispatcher routes it, from the arguments alone (see the module
    docstring).  Differentiable on both routes."""
    if q.is_cuda and kernel_route(q, k, attn_mask, is_causal, dropout_p,
                                  scale):
        return flash_attention_cuda(q, k, v, is_causal)
    return attention_plain(q, k, v, attn_mask=attn_mask, is_causal=is_causal,
                           dropout_p=dropout_p, generator=generator,
                           scale=scale)
