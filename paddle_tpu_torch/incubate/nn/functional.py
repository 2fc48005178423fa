"""incubate.nn.functional — the fused-op entry points the decode paths
call: ``ragged_decode_attention`` (the dense-cache decode kernel) and
``swiglu``.  The rest of the JAX package's fused-op surface is slice 8.
"""

import torch

from ...ops.cuda.decode_attention_kernel import (
    decode_attention_cuda,
    decode_attention_plain,
)

__all__ = ["ragged_decode_attention", "swiglu"]


def swiglu(x, y=None):
    """SwiGLU: ``silu(a) * b`` with ``(a, b)`` the two halves of ``x``'s
    last dim, or ``(x, y)`` when ``y`` is given."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return torch.nn.functional.silu(x) * y


def ragged_decode_attention(q, k_cache, v_cache, lengths, use_pallas=None):
    """Single-token decode attention over a ragged dense KV cache.

    q [B, Nq, D]; k_cache / v_cache [B, S_max, Nkv, D] with Nq % Nkv == 0
    (query heads grouped contiguously per kv head); lengths [B] int32,
    the valid prefix of each sequence (0 gives zeros).  CUDA tensors
    launch the decode kernel (``ops/cuda/decode_attention_kernel.py``),
    which raises on what it does not take; CPU tensors run its plain
    version.  ``use_pallas=False`` is the caller's explicit opt-out of
    the kernel, as in the JAX package, and takes the plain version on
    any device; the default never does."""
    if q.is_cuda and use_pallas is not False:
        return decode_attention_cuda(q, k_cache, v_cache, lengths)
    return decode_attention_plain(q, k_cache, v_cache, lengths)
