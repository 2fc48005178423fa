"""Flash attention, forward and backward — the hand-written CUDA kernels'
wrappers and the autograd function that joins them.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's
Pallas kernels ``ops/pallas/attention_kernel.py``: ``_flash_fwd`` (B2)
and the two passes of ``_flash_bwd`` (B3a dq, B3b dk/dv), wired there
as a ``jax.custom_vjp`` and here as a ``torch.autograd.Function``.
The public layout is ``flash_attention_pallas``'s ``[B, S, N, H]``;
q, k and v are read in place through their strides (the last dim
contiguous), so the views of a ``[B, S, 3, N, H]`` projection cost no
transpose.

bf16 runs on the tensor-core kernels, f32 on the SIMT kernels (the
source note says why).  ``fwd_launches`` counts launches of the forward
kernel and ``bwd_launches`` launches of the backward pair (dq, which
also computes ``delta = rowsum(dO * O)``, then dk/dv), each incremented
once per launch and nowhere else.  The wrappers take CUDA tensors only
and raise on anything the kernels do not take.  The plain versions
beside them are the dispatcher's composition
``ops/attention.py::attention_plain`` with its lse
(``flash_fwd_plain``) and its gradient from a given out and lse, as
the backward kernels take them (``flash_bwd_plain``).
"""

import ctypes
import math

import torch

from . import _build

# incremented once per kernel launch, nowhere else
fwd_launches = 0
bwd_launches = 0

_NAME = "flash_attention"
_MAX_D = 128      # kMaxD in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def supports(seq_q, seq_k, head_dim, dtype=torch.float32, causal=False):
    """What the CUDA kernels need: any sequence lengths, a head_dim that
    is a multiple of 8 (16-byte loads) up to 128, f32 or bf16, and for
    causal attention seq_q == seq_k (the kernels align the mask to the
    top left, the plain composition to the bottom right: they agree
    only on square scores).  The TPU rule that a block size divide the
    sequence (``attention_kernel.py::supports``) is tiling there; these
    kernels mask any tail."""
    return (seq_q >= 1 and seq_k >= 1 and head_dim % 8 == 0
            and 8 <= head_dim <= _MAX_D and dtype in _DTYPES
            and (not causal or seq_q == seq_k))


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(_NAME), name)
        n_ptr = 5 if name == "flash_attention_fwd" else 10
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _strides(tensors):
    """(batch, seq, head) element strides of each [B, S, N, H] tensor, as
    a C array of int64 the launch reads on the host."""
    flat = [int(s) for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(named, causal, seq_k_names=()):
    """Rank, shapes and ``supports``, then device, dtype, layout and
    alignment of every tensor."""
    q = named["q"]
    for name, x in named.items():
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{name} must be a [B, S, N, H] tensor")
    b, sq, n, d = q.shape
    sk = named["k"].shape[1]
    for name, x in named.items():
        want = (b, sk if name in seq_k_names else sq, n, d)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want}")
    if not supports(sq, sk, d, q.dtype, causal):
        raise ValueError(f"shape not supported by the CUDA kernels: "
                         f"seq_q={sq}, seq_k={sk}, head_dim={d}, "
                         f"dtype={q.dtype}, causal={bool(causal)} (causal "
                         f"attention needs seq_q == seq_k)")
    for name, x in named.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and 16-byte "
                             f"alignment, got strides {x.stride()}")


def flash_attention_fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel on the current stream: q [B, Sq, N, H],
    k and v [B, Sk, N, H] -> (out [B, Sq, N, H] in q's dtype, lse
    [B, N, Sq] f32).  Raises ValueError for inputs the kernel does not
    take (causal with Sq != Sk among them) and RuntimeError if the
    launch fails; never falls back."""
    global fwd_launches
    _check({"q": q, "k": k, "v": v}, causal, seq_k_names=("k", "v"))
    b, sq, n, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel("flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], b, n, sq, sk, d,
            _strides((q, k, v, out)), int(bool(causal)), float(scale),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {rc}")
    fwd_launches += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    """Launch the backward pair on the current stream -> (dq, dk, dv),
    each [B, S, N, H] in q's dtype.  ``delta = rowsum(dout * out)``,
    which the JAX package leaves to XLA (``attention_kernel.py:211-213``),
    is computed on the card into a [B, N, Sq] f32 scratch (by the bf16 dq
    kernel itself; by a row kernel before the f32 pair).  Raises like
    the forward."""
    global bwd_launches
    _check({"q": q, "k": k, "v": v, "out": out, "dout": dout}, causal,
           seq_k_names=("k", "v"))
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, n, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be a contiguous f32 [B, N, Sq] CUDA "
                         "tensor on q's device")
    delta = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel("flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, n, sq, sk, d,
            _strides((q, k, v, dout, dq, dk, dv, out)), int(bool(causal)),
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The ``jax.custom_vjp`` of ``attention_kernel.py:259-351``: the
    forward kernel saves ``q, k, v, out, lse``; the backward launches
    the dq and dk/dv kernels from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, is_causal=False):
    """Differentiable flash attention on CUDA tensors [B, S, N, H] with
    scale 1/sqrt(H); raises for anything the kernels do not take."""
    return FlashAttention.apply(q, k, v, bool(is_causal),
                                1.0 / math.sqrt(q.shape[-1]))


# ------------------------------------------------------- plain versions --
def flash_fwd_plain(q, k, v, causal, scale):
    """The forward kernel's contract in plain PyTorch: ``(out, lse)``
    with ``lse [B, N, Sq]`` f32 from the f32 logits ``attention_plain``
    computed for ``out``."""
    from ..attention import attention_plain_with_logits
    out, logits = attention_plain_with_logits(q, k, v, is_causal=causal,
                                              scale=scale)
    return out, torch.logsumexp(logits, dim=-1)


def flash_bwd_plain(q, k, v, out, lse, dout, causal, scale):
    """The backward pair's contract in plain PyTorch, from the ``out``
    and ``lse`` it is given, as the kernels take them: ``P = exp(S -
    lse)``, ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO * out)) *
    scale``, ``dQ = dS K``, ``dK = dS^T Q``, in f32 from the inputs'
    values, cast to q's dtype.  From ``flash_fwd_plain``'s out and lse
    it is autograd through ``attention_plain``."""
    from ..attention import causal_logits
    p = torch.exp(causal_logits(q, k, causal, scale) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)
    dv = torch.einsum("bnts,btnh->bsnh", p, do)
    dp = torch.einsum("btnh,bsnh->bnts", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bnts,bsnh->btnh", ds, k.float())
    dk = torch.einsum("bnts,btnh->bsnh", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
