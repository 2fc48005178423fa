"""Row LayerNorm, forward and backward — the hand-written CUDA kernels'
wrappers and the autograd function that joins them.

The kernels (``csrc/layernorm.cu``) replace the JAX package's Pallas
kernels ``ops/pallas/layernorm_kernel.py``: ``_ln_fwd`` (B4a) and
``_ln_bwd`` (B4b), wired there as a ``jax.custom_vjp`` and here as a
``torch.autograd.Function`` that saves ``x, gamma, mu, rstd`` and
returns dgamma/dbeta cast to gamma's dtype.  The backward's row pass
runs in one wave (:func:`bwd_plan`), each block writing one f32 partial
row of dgamma and dbeta that a second kernel sums in a fixed order, so
they are deterministic.

``fwd_launches`` counts forward launches and ``bwd_launches`` backward
launches (the row pass and its partials reduction together), each
incremented once per launch and nowhere else.  The wrappers take CUDA
tensors only and raise on anything the kernels do not take; the plain
versions beside them (``layernorm_fwd_plain``, ``layernorm_bwd_plain``)
are built on ``layer_norm_plain``, the composition that
``nn/functional.py::layer_norm`` runs off the kernels.

The forward and the backward are also the ``torch.library`` ops
``paddle_tpu_torch::layernorm_fwd`` and ``..._bwd`` (:data:`ln_fwd_op`,
:data:`ln_bwd_op`), which the autograd function calls: the launches on
CUDA tensors, the plain versions on CPU ones, fakes for their shapes.
An op's outputs may not alias one another, so the backward op returns
dgamma and dbeta as the one f32 ``[2, C]`` tensor the kernel writes.
:func:`ln_fwd_cost` and :func:`ln_bwd_cost` price a call.
"""

import ctypes

import torch
from torch import Tensor

from . import _build

# incremented once per kernel launch, nowhere else
fwd_launches = 0
bwd_launches = 0

_NAME = "layernorm"
_MAX_C = 2048         # 256 * kMaxVec in the .cu
BWD_WARPS = 8         # kBwdWarps in the .cu: warps (rows in flight) a block
RED_COLS = 8          # kRedCols in the .cu: columns a reduce block sums
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INFO = ("registers", "local_bytes", "blocks_per_sm", "sms", "smem_bytes",
         "ring_slots")
_fns = {}
_bwd_info = {}


def supports(rows, channels, dtype=torch.float32):
    """What the CUDA kernels need: any row count, a channel count that
    is a multiple of 8 (16-byte loads) up to 2048, f32 or bf16.  The
    TPU's ``C % 128`` and row-block rules (``layernorm_kernel.py:25-33``)
    are its tiling, not the kernels'."""
    return (rows >= 1 and channels % 8 == 0 and 8 <= channels <= _MAX_C
            and dtype in _DTYPES)


def bwd_plan(rows, channels, slots):
    """The backward's launch plan -> (row-pass blocks, reduce blocks).

    The row pass runs in one wave: as many blocks as fit on the card at
    once (``slots``: blocks per SM times SMs, :func:`bwd_kernel_info`),
    but no more than one per ``BWD_WARPS`` rows.  Block b owns rows
    [b * rows // grid, (b + 1) * rows // grid) and writes one partial
    row, so the grid is also the partial count.  The reduce kernel sums
    the partials, ``RED_COLS`` of the 2 * C columns (dgamma, then dbeta)
    a block.  One shape on one card always gets the same plan."""
    grid = max(1, min(slots, -(-rows // BWD_WARPS)))
    return grid, 2 * channels // RED_COLS


def bwd_kernel_info(dtype, channels, device):
    """The backward row kernel for ``channels`` columns of ``dtype`` on
    CUDA ``device``, read from the card once per kernel and cached:
    registers a thread, local (spill) bytes a thread, blocks resident
    per SM, the SM count, dynamic shared bytes and the row slots in each
    warp's ring."""
    key = (dtype, -(-channels // 256), device.index)
    info = _bwd_info.get(key)
    if info is None:
        out = (ctypes.c_int * len(_INFO))()
        with torch.cuda.device(device):
            rc = _kernel("layernorm_bwd_info")(_DTYPES[dtype], channels, out)
        if rc != 0:
            raise RuntimeError(f"layernorm backward info failed: CUDA "
                               f"error {rc}")
        info = _bwd_info[key] = dict(zip(_INFO, out))
    return info


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(_NAME), name)
        if name == "layernorm_fwd":
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_float, ctypes.c_void_p]
        elif name == "layernorm_bwd_info":
            fn.argtypes = [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(x2d, gamma, others=()):
    for name, t in (("x", x2d), ("gamma", gamma)) + tuple(others):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if x2d.dim() != 2:
        raise ValueError(f"x must be [rows, C], got {tuple(x2d.shape)}")
    rows, c = x2d.shape
    if gamma.dtype != x2d.dtype or tuple(gamma.shape) != (c,):
        raise ValueError(f"gamma must be [{c}] in x's dtype {x2d.dtype}, "
                         f"got {tuple(gamma.shape)} {gamma.dtype}")
    if not supports(rows, c, x2d.dtype):
        raise ValueError(f"shape not supported by the CUDA kernels: "
                         f"rows={rows}, C={c}, dtype={x2d.dtype}")


def layernorm_fwd_cuda(x2d, gamma, beta, eps):
    """Launch the forward kernel on the current stream: x [rows, C] ->
    (y [rows, C] in x's dtype, mu [rows] f32, rstd [rows] f32).  Raises
    ValueError for inputs the kernel does not take and RuntimeError if
    the launch fails; never falls back."""
    global fwd_launches
    _check(x2d, gamma, (("beta", beta),))
    if beta.dtype != x2d.dtype or beta.shape != gamma.shape:
        raise ValueError("beta must match gamma's shape and x's dtype")
    rows, c = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    rstd = torch.empty_like(mu)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        rc = _kernel("layernorm_fwd")(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), _DTYPES[x2d.dtype], rows, c,
            float(eps), stream)  # noqa: H001 (eps is a Python attribute of the launch)
    if rc != 0:
        raise RuntimeError(f"layernorm forward launch failed: CUDA error "
                           f"{rc}")
    fwd_launches += 1
    return y, mu, rstd


def layernorm_bwd_cuda(x2d, gamma, mu, rstd, dy):
    """Launch the backward row pass and its partials reduction on the
    current stream, planned by :func:`bwd_plan` -> (dx [rows, C] in x's
    dtype, dgamma [C] f32, dbeta [C] f32).  Raises like the forward."""
    dx, dgdb = _layernorm_bwd_launch(x2d, gamma, mu, rstd, dy)
    return dx, dgdb[0], dgdb[1]


def _layernorm_bwd_launch(x2d, gamma, mu, rstd, dy):
    """:func:`layernorm_bwd_cuda` with dgamma and dbeta as the rows of
    the one [2, C] f32 tensor the kernel writes (the backward op's CUDA
    implementation)."""
    global bwd_launches
    _check(x2d, gamma, (("dy", dy), ("mu", mu), ("rstd", rstd)))
    rows, c = x2d.shape
    if dy.dtype != x2d.dtype or dy.shape != x2d.shape:
        raise ValueError("dy must match x's shape and dtype")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,):
            raise ValueError(f"{name} must be f32 [{rows}]")
    info = bwd_kernel_info(x2d.dtype, c, x2d.device)
    nparts, _ = bwd_plan(rows, c, info["blocks_per_sm"] * info["sms"])
    dx = torch.empty_like(x2d)
    partials = torch.empty((nparts, 2, c), dtype=torch.float32,
                           device=x2d.device)
    dgdb = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    with torch.cuda.device(x2d.device):
        rc = _kernel("layernorm_bwd")(
            x2d.data_ptr(), gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), partials.data_ptr(),
            dgdb.data_ptr(), _DTYPES[x2d.dtype], rows, c, nparts, stream)
    if rc != 0:
        raise RuntimeError(f"layernorm backward launch failed: CUDA error "
                           f"{rc}")
    bwd_launches += 1
    return dx, dgdb


class LayerNorm(torch.autograd.Function):
    """The ``jax.custom_vjp`` of ``layernorm_kernel.py:127-145``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        y, mu, rstd = ln_fwd_op(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mu, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mu, rstd = ctx.saved_tensors
        dx, dgdb = ln_bwd_op(x2d, gamma, mu, rstd,
                             dy.reshape(x2d.shape).contiguous())
        return (dx.view(dy.shape), dgdb[0].to(gamma.dtype),
                dgdb[1].to(gamma.dtype), None)


def layernorm_cuda(x, gamma, beta, eps=1e-5):
    """Differentiable LayerNorm over the last dim on CUDA tensors; raises
    for anything the kernels do not take (the ops would run their plain
    versions on CPU tensors: this entry is the kernels')."""
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    return LayerNorm.apply(x, gamma, beta, float(eps))


# ------------------------------------------------------- plain versions --
def layer_norm_plain(x, normalized_shape, weight, bias, epsilon):
    """The JAX package's ``F.layer_norm`` composition, in x's dtype: mean,
    centred variance, rsqrt, then the affine.  ``nn.functional.
    layer_norm`` runs it wherever the kernels do not; the kernels' plain
    versions below are built on it."""
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layernorm_fwd_plain(x2d, gamma, beta, eps):
    """The forward kernel's contract in plain PyTorch: ``y`` from
    :func:`layer_norm_plain`, with the row stats ``mu`` and ``rstd`` the
    kernel saves computed beside it in f32."""
    y = layer_norm_plain(x2d, (x2d.shape[-1],), gamma, beta, eps)
    x = x2d.float()
    mu = x.mean(-1)
    rstd = torch.rsqrt(((x - mu[:, None]) ** 2).mean(-1) + eps)
    return y, mu, rstd


def layernorm_bwd_plain(x2d, gamma, mu, rstd, dy, eps=1e-5):
    """The backward kernel's contract in plain PyTorch: the vector-Jacobian
    product of :func:`layer_norm_plain` (``torch.func.vjp``, the same
    derivative formulas as autograd, and usable inside the op's CPU
    implementation, where autograd does not record), which recomputes
    the forward (the saved stats are not read, so its time holds a
    forward's); dgamma and dbeta come back in f32 as the kernel gives
    them."""
    def forward(x, g, b):
        return layer_norm_plain(x, (x.shape[-1],), g, b, eps)

    _, vjp = torch.func.vjp(forward, x2d, gamma, torch.zeros_like(gamma))
    dx, dg, db = vjp(dy)
    return dx, dg.float(), db.float()


# ------------------------------------------------------------------ ops --
@torch.library.custom_op("paddle_tpu_torch::layernorm_fwd", mutates_args=(),
                         device_types="cuda")
def ln_fwd_op(x2d: Tensor, gamma: Tensor, beta: Tensor,
              eps: float) -> tuple[Tensor, Tensor, Tensor]:
    """B4a as an op: :func:`layernorm_fwd_cuda` on CUDA tensors,
    :func:`layernorm_fwd_plain` on CPU ones."""
    return layernorm_fwd_cuda(x2d, gamma, beta, eps)


@torch.library.custom_op("paddle_tpu_torch::layernorm_bwd", mutates_args=(),
                         device_types="cuda")
def ln_bwd_op(x2d: Tensor, gamma: Tensor, mu: Tensor, rstd: Tensor,
              dy: Tensor) -> tuple[Tensor, Tensor]:
    """B4b as an op -> (dx, [dgamma; dbeta] f32 [2, C]): the kernel pair
    on CUDA tensors, :func:`layernorm_bwd_plain` on CPU ones."""
    return _layernorm_bwd_launch(x2d, gamma, mu, rstd, dy)


@ln_bwd_op.register_kernel("cpu")
def _ln_bwd_cpu(x2d, gamma, mu, rstd, dy):
    dx, dg, db = layernorm_bwd_plain(x2d, gamma, mu, rstd, dy)
    return dx, torch.stack((dg, db))


ln_fwd_op.register_kernel("cpu")(layernorm_fwd_plain)


@ln_fwd_op.register_fake
def _ln_fwd_fake(x2d, gamma, beta, eps):
    rows = x2d.shape[0]
    return (torch.empty_like(x2d),
            x2d.new_empty((rows,), dtype=torch.float32),
            x2d.new_empty((rows,), dtype=torch.float32))


@ln_bwd_op.register_fake
def _ln_bwd_fake(x2d, gamma, mu, rstd, dy):
    return (torch.empty_like(x2d),
            x2d.new_empty((2, x2d.shape[1]), dtype=torch.float32))


# ----------------------------------------------------------------- cost --
def ln_fwd_cost(x2d, gamma, beta, eps):
    """``{"flops", "bytes"}`` of a forward call: x, gamma, beta read and
    y, mu, rstd written once, about 7 operations an element."""
    rows, c = x2d.shape
    isz = x2d.element_size()
    return {"flops": 7.0 * rows * c,
            "bytes": float(2 * rows * c * isz + 2 * c * isz + 8 * rows)}


def ln_bwd_cost(x2d, gamma, mu, rstd, dy):
    """``{"flops", "bytes"}`` of a backward call: x, dy, gamma, mu, rstd
    read and dx, dgamma, dbeta written once, about 12 operations an
    element."""
    rows, c = x2d.shape
    isz = x2d.element_size()
    return {"flops": 12.0 * rows * c,
            "bytes": float(3 * rows * c * isz + c * isz + 8 * rows
                           + 8 * c)}
