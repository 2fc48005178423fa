"""Dense-cache decode attention — the hand-written CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the JAX package's
Pallas kernel ``ops/pallas/decode_attention_kernel.py::
decode_attention_pallas``: one query token per sequence against dense
K/V caches with a valid prefix per sequence.  Shapes are the JAX
kernel's:

    q        [B, Nq, D]          one new token per sequence
    k_cache  [B, S_max, Nkv, D]  Nq % Nkv == 0 (GQA: G = Nq // Nkv query
    v_cache  [B, S_max, Nkv, D]  heads share one kv head)
    lengths  [B] int32           valid cache prefix per sequence

A sequence with ``lengths == 0`` comes back as exact zeros.  The
wrapper takes CUDA tensors only and raises on anything the kernel does
not take; :func:`decode_attention_plain` is the plain version (the JAX
package's ``decode_attention_xla``).  ``launches`` counts the wrapper's
launches (and nothing else): one per call, which runs the split kernel
and its combine (split-KV flash-decoding, ``split_kv.py``).
"""

import ctypes
import math

import torch

from . import _build, split_kv

# incremented once per launch (split kernel + combine), nowhere else
launches = 0

_NAME = "decode_attention"
_MAX_G = 16       # kRows in split_decode.cuh
_MAX_D = 128      # kMaxD in split_decode.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def supports(s_max, head_dim, num_q_heads, num_kv_heads):
    """What the CUDA kernel itself needs: any S_max (it walks only each
    sequence's valid prefix), whole GQA groups of at most 16 query heads
    per kv head, and a head_dim that is a multiple of 8 (16-byte row
    loads) up to 128.  The TPU kernel's ``S_max % block_s`` rule does
    not apply."""
    return (s_max >= 1 and num_kv_heads >= 1
            and num_q_heads % num_kv_heads == 0
            and 1 <= num_q_heads // num_kv_heads <= _MAX_G
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_D)


def split_plan(s_max):
    """The number of splits for caches of ``s_max`` positions: from the
    shape alone, never from the lengths on the card."""
    return split_kv.plan(s_max)


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """Dense masked decode attention in plain PyTorch (the JAX package's
    ``decode_attention_xla``): f32 scores scaled by 1/sqrt(D), positions
    at or past ``lengths[b]`` masked with -1e30, an f32 softmax, and
    zeros for a sequence of length 0.  Returns [B, Nq, D] in q's
    dtype."""
    b, nq, d = q.shape
    s_max, nkv = k_cache.shape[1], k_cache.shape[2]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bngd,bsnd->bngs", qg.float(),
                          k_cache.float()) * scale
    lengths = lengths.to(q.device)
    mask = (torch.arange(s_max, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v_cache.float())
    out = torch.where(lengths[:, None, None, None] > 0, out, 0.0)
    return out.reshape(b, nq, d).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(_NAME).decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_cache, v_cache, lengths):
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "lengths": lengths}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q, k_cache and v_cache must share one dtype, got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32")
    if (q.dim() != 3 or k_cache.dim() != 4
            or k_cache.shape != v_cache.shape):
        raise ValueError(f"expected q [B, Nq, D] and caches "
                         f"[B, S_max, Nkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, nq, d = q.shape
    bk, s_max, nkv, dk = k_cache.shape
    if bk != b or dk != d or lengths.shape != (b,):
        raise ValueError("inconsistent batch, head_dim or lengths shape")
    if not supports(s_max, d, nq, nkv):
        raise ValueError(f"shape not supported by the CUDA kernel: "
                         f"S_max={s_max}, Nq={nq}, Nkv={nkv}, D={d}")
    for name in ("q", "k_cache", "v_cache"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch the kernel on the current stream -> [B, Nq, D] in q's
    dtype.  Raises ValueError for inputs the kernel does not take and
    RuntimeError if the launch fails; never falls back."""
    global launches
    _check(q, k_cache, v_cache, lengths)
    b, nq, d = q.shape
    s_max, nkv = k_cache.shape[1], k_cache.shape[2]
    splits = split_plan(s_max)
    out = torch.empty_like(q)      # the combine writes every element
    part_acc = torch.empty(b * nq * splits * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(b * nq * splits * 2, dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(),
                       part_acc.data_ptr(), part_ml.data_ptr(),
                       _DTYPES[q.dtype], b, s_max, nq, nkv, d, splits, stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out
