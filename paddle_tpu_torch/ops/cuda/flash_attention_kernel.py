"""Flash attention, forward and backward — the hand-written CUDA kernels'
wrappers and the op whose registered gradient joins them.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's
Pallas kernels ``ops/pallas/attention_kernel.py``: ``_flash_fwd`` (B2)
and the two passes of ``_flash_bwd`` (B3a dq, B3b dk/dv), wired there
as a ``jax.custom_vjp`` and here as the forward op's registered
autograd, which saves ``q, k, v, out, lse``.
The public layout is ``flash_attention_pallas``'s ``[B, S, N, H]``;
q, k and v are read in place through their strides (the last dim
contiguous), so the views of a ``[B, S, 3, N, H]`` projection cost no
transpose.

bf16 and f16 run on the tensor-core kernels (one template, two
instances), f32 on the SIMT kernels (the source note says why).  As in
the JAX kernels, which take any floating dtype and compute in f32, the
accumulators, lse and delta are f32 whatever the inputs' dtype.  ``fwd_launches`` counts launches of the forward
kernel and ``bwd_launches`` launches of the backward pair (dq, which
also computes ``delta = rowsum(dO * O)``, then dk/dv), each incremented
once per launch and nowhere else.  The wrappers take CUDA tensors only
and raise on anything the kernels do not take.  The plain versions
beside them are the dispatcher's composition
``ops/attention.py::attention_plain`` with its lse
(``flash_fwd_plain``) and its gradient from a given out and lse, as
the backward kernels take them (``flash_bwd_plain``).

The forward and the backward pair are also the ``torch.library`` ops
``paddle_tpu_torch::flash_attention_fwd`` and ``..._bwd``
(:data:`flash_fwd_op`, :data:`flash_bwd_op`): the wrappers on CUDA
tensors, the plain versions on CPU ones, fakes for their shapes.  The
forward op's gradient calls the backward op, so one backward serves the
eager entry :func:`flash_attention_cuda` and a traced program alike.  :func:`flash_fwd_cost` and
:func:`flash_bwd_cost` price a call.
"""

import ctypes
import math

import torch
from torch import Tensor

from . import _build

# incremented once per kernel launch, nowhere else
fwd_launches = 0
bwd_launches = 0

_NAME = "flash_attention"
_MAX_D = 128      # kMaxD in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns = {}


def supports(seq_q, seq_k, head_dim, dtype=torch.float32, causal=False):
    """What the CUDA kernels need: any sequence lengths, any head_dim
    from 1 to 128 (the JAX kernel's ``head_dim <= 128``; the kernels
    zero-fill the padded tile and pick each tensor's copy width from its
    alignment), f32, bf16 or f16, and for causal attention seq_q == seq_k
    (the kernels align the mask to the top left, the plain composition
    to the bottom right: they agree only on square scores).  The TPU
    rule that a block size divide the sequence
    (``attention_kernel.py::supports``) is tiling there; these kernels
    mask any tail."""
    return (seq_q >= 1 and seq_k >= 1 and 1 <= head_dim <= _MAX_D
            and dtype in _DTYPES and (not causal or seq_q == seq_k))


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
    """Rank, shapes and ``supports``, then device, dtype and a contiguous
    last dim of every tensor (the launch picks each tensor's copy width
    from its address and strides)."""
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
                         f"dtype={q.dtype}, causal={bool(causal)} (causal "  # noqa: H001 (causal is a Python attribute of the launch)
                         f"attention needs seq_q == seq_k)")
    for name, x in named.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.stride(-1) != 1 and x.shape[-1] > 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {x.stride()}")


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
            _strides((q, k, v, out)), int(bool(causal)), float(scale),  # noqa: H001 (causal and scale are Python attributes of the launch)
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
            _strides((q, k, v, dout, dq, dk, dv, out)), int(bool(causal)),  # noqa: H001 (causal is a Python attribute of the launch)
            float(scale), stream)  # noqa: H001 (scale is a Python attribute of the launch)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_cuda(q, k, v, is_causal=False):
    """Differentiable flash attention on CUDA tensors [B, S, N, H] with
    scale 1/sqrt(H); raises for anything the kernels do not take (the
    ops would run their plain versions on CPU tensors: this entry is the
    kernels')."""
    _check({"q": q, "k": k, "v": v}, is_causal, seq_k_names=("k", "v"))
    return flash_fwd_op(q, k, v, bool(is_causal),
                        1.0 / math.sqrt(q.shape[-1]))[0]


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


# ------------------------------------------------------------------ ops --
@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                 scale: float) -> tuple[Tensor, Tensor]:
    """B2 as an op: :func:`flash_attention_fwd_cuda` on CUDA tensors,
    :func:`flash_fwd_plain` on CPU ones."""
    return flash_attention_fwd_cuda(q, k, v, causal, scale)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_bwd",
                         mutates_args=(), device_types="cuda")
def flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                 dout: Tensor, causal: bool,
                 scale: float) -> tuple[Tensor, Tensor, Tensor]:
    """B3 as an op: :func:`flash_attention_bwd_cuda` on CUDA tensors,
    :func:`flash_bwd_plain` on CPU ones."""
    return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale)


flash_fwd_op.register_kernel("cpu")(flash_fwd_plain)
flash_bwd_op.register_kernel("cpu")(flash_bwd_plain)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    b, sq, n, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, n, sq), dtype=torch.float32))


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, dout, causal, scale):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_fwd_backward(ctx, dout, dlse):
    # the ``jax.custom_vjp`` of ``attention_kernel.py:259-351``: B3 from
    # the out and lse the forward saved (lse carries no gradient)
    q, k, v, out, lse = ctx.saved_tensors
    if dout.stride(-1) != 1 and dout.shape[-1] > 1:
        dout = dout.contiguous()
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, dout, ctx.causal,
                              ctx.scale)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_fwd_backward,
                               setup_context=_flash_fwd_setup)


# ----------------------------------------------------------------- cost --
def _attention_pairs(q, k, causal):
    """Visible (query, key) pairs of one call, over batch and heads."""
    b, sq, n, _ = q.shape
    sk = k.shape[1]
    return n * b * (sq * (sq + 1) // 2 if causal else sq * sk)


def flash_fwd_cost(q, k, v, causal, scale):
    """``{"flops", "bytes"}`` of a forward call: q, k, v read and out
    and lse written once, with 4*D FLOPs per visible (query, key) pair
    (QK^T and PV)."""
    b, sq, n, d = q.shape
    elems = b * sq * n * d
    kv = 2 * k.numel() * k.element_size()
    return {"flops": 4.0 * d * _attention_pairs(q, k, causal),
            "bytes": float(2 * elems * q.element_size() + kv
                           + 4 * b * n * sq)}


def flash_bwd_cost(q, k, v, out, lse, dout, causal, scale):
    """``{"flops", "bytes"}`` of a backward call: q, k, v, out, dO and
    lse read, dq, dk, dv written, with 10*D FLOPs per visible pair (S,
    dP, dV, dK, dQ)."""
    b, sq, n, d = q.shape
    elems = b * sq * n * d
    kv = 2 * k.numel() * k.element_size()
    return {"flops": 10.0 * d * _attention_pairs(q, k, causal),
            "bytes": float(4 * elems * q.element_size() + 2 * kv
                           + 4 * b * n * sq)}
