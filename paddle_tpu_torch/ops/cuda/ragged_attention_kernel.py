"""Ragged paged attention — the hand-written CUDA kernel's wrapper.

The kernel (``csrc/ragged_attention.cu``) replaces the JAX package's
Pallas kernel ``ops/pallas/ragged_attention_kernel.py::
paged_ragged_attention_pallas``: one launch covers every serving phase
of a step (decode rows, prefill chunks, verify rows) over the packed
token batch.  Shapes and the host packing contract are the JAX
kernel's:

    q             [T, Nq, D]        packed query tokens
    k_pages       [NB, bs, Nkv, D]  the paged pool (one layer)
    v_pages       [NB, bs, Nkv, D]
    block_tables  [R, P] int32      page id of row r's p-th page
    row_start     [R]    int32      first flat token of row r
    row_qlen      [R]    int32      query tokens of row r (0: dead row)
    row_pos0      [R]    int32      absolute position of row r's first token

Token i of row r attends over pool positions 0 .. row_pos0[r] + i;
tokens outside every row come back as exact zeros.

The int8 twin (``paged_ragged_attention_quant_cuda``, replacing
``paged_ragged_attention_quant_pallas``) takes int8 pools plus
``k_scales`` / ``v_scales`` [NB, Nkv, bs] f32, one scale per (page, kv
head, slot), and dequantizes each slot row as it loads it.

The wrappers take CUDA tensors only and raise on anything the kernel
does not take; the plain PyTorch versions for CPU tensors are
``inference/llm/paged_attention.py::paged_ragged_attention_plain`` and
``paged_ragged_attention_quant_plain``, in the kernels' per-row
signature as :func:`ragged_plain` and :func:`ragged_quant_plain`.
``launches`` and ``quant_launches`` count each entry's launches (and
nothing else): one per call, which runs the split kernel and its
combine (split-KV flash-decoding, ``split_kv.py``).

Each entry is also a ``torch.library`` op, ``paddle_tpu_torch::
paged_ragged_attention`` and ``..._quant`` (:data:`ragged_op`,
:data:`ragged_quant_op`): the wrapper is its CUDA implementation, the
per-row plain version its CPU one, and a fake gives its output's shape,
so a traced step shows each launch as one node (``framework/
analysis.py::trace_graph``).  :func:`ragged_cost` prices a call.
"""

import ctypes

import numpy as np
import torch
from torch import Tensor

from . import _build, split_kv

# incremented once per launch (split kernel + combine), nowhere else
launches = 0
quant_launches = 0

_NAME = "ragged_attention"
_MAX_D = 128      # kMaxD in split_decode.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def supports(block_size, head_dim, num_q_heads, num_kv_heads, total_tokens):
    """What the CUDA kernel itself needs: any token count and page size,
    whole GQA groups of at most 16 query heads per kv head, and a
    head_dim that is a multiple of 8 up to 128 (rows load 8 elements at
    a time: 16-byte loads of f32/bf16, 8-byte loads of int8 — the same
    rule for both entries).  The TPU kernel's ``T % 8`` and
    ``block_size % 8`` tiling rules do not apply."""
    return (total_tokens >= 1 and block_size >= 1 and num_kv_heads >= 1
            and num_q_heads % num_kv_heads == 0
            and num_q_heads // num_kv_heads <= split_kv.ROWS
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_D)


def split_plan(pages_per_row, block_size):
    """The number of splits for rows of at most ``pages_per_row *
    block_size`` keys (the block tables' width): from shapes alone,
    never from the descriptors on the card."""
    return split_kv.plan(pages_per_row * block_size)


def _kernel(entry="paged_ragged_attention", pointers=10):
    fn = _fns.get(entry)
    if fn is None:
        fn = getattr(_build.load(_NAME), entry)
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def _check(q, k_pages, v_pages, block_tables, row_start, row_qlen,
           row_pos0, scales=None):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "row_start": row_start,
               "row_qlen": row_qlen, "row_pos0": row_pos0}
    if scales is not None:
        tensors.update(k_scales=scales[0], v_scales=scales[1])
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
    pool_dtype = q.dtype if scales is None else torch.int8
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise ValueError(f"k_pages and v_pages must be {pool_dtype} "
                         f"(q is {q.dtype})")
    for name in ("block_tables", "row_start", "row_qlen", "row_pos0"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q [T, Nq, D] and pools [NB, bs, Nkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    t, nq, d = q.shape
    _, bs, nkv, dk = k_pages.shape
    r = block_tables.shape[0]
    if dk != d or block_tables.dim() != 2 or any(
            tensors[n].shape != (r,)
            for n in ("row_start", "row_qlen", "row_pos0")):
        raise ValueError("inconsistent head_dim or row descriptor shapes")
    if scales is not None:
        nb = k_pages.shape[0]
        for name in ("k_scales", "v_scales"):
            if tensors[name].dtype != torch.float32 or \
                    tensors[name].shape != (nb, nkv, bs):
                raise ValueError(f"{name} must be float32 [NB, Nkv, bs] = "
                                 f"{(nb, nkv, bs)}, got "
                                 f"{tensors[name].dtype} "
                                 f"{tuple(tensors[name].shape)}")
    if not supports(bs, d, nq, nkv, t):
        raise ValueError(
            f"shape not supported by the CUDA kernel: T={t}, Nq={nq}, "
            f"Nkv={nkv}, D={d}, block_size={bs}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % (8 if tensors[name].dtype == torch.int8
                                       else 16):
            raise ValueError(f"{name} must be aligned to its row loads")


def _outputs(q, num_rows, pages_per_row, block_size, num_kv_heads):
    """The output and the partials' scratch of one call."""
    t, nq, d = q.shape
    splits = split_plan(pages_per_row, block_size)
    slots = split_kv.ragged_slots(t, num_rows, nq, num_kv_heads, splits, d)
    # the two kernels write every element
    out = torch.empty_like(q)
    part_acc = torch.empty(slots * nq * splits * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(slots * nq * splits * 2, dtype=torch.float32,
                          device=q.device)
    return out, part_acc, part_ml, splits, slots


def paged_ragged_attention_cuda(q, k_pages, v_pages, block_tables,
                                row_start, row_qlen, row_pos0):
    """Launch the kernel on the current stream -> [T, Nq, D] in q's
    dtype.  Raises ValueError for inputs the kernel does not take and
    RuntimeError if the launch fails; never falls back."""
    global launches
    _check(q, k_pages, v_pages, block_tables, row_start, row_qlen,
           row_pos0)
    t, nq, d = q.shape
    _, bs, nkv, _ = k_pages.shape
    r, p = block_tables.shape
    out, part_acc, part_ml, splits, slots = _outputs(q, r, p, bs, nkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       block_tables.data_ptr(), row_start.data_ptr(),
                       row_qlen.data_ptr(), row_pos0.data_ptr(),
                       out.data_ptr(), part_acc.data_ptr(),
                       part_ml.data_ptr(), _DTYPES[q.dtype], t, r, p, nq,
                       nkv, d, bs, splits, slots, stream)
    if rc != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out


def paged_ragged_attention_quant_cuda(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, row_start,
                                      row_qlen, row_pos0):
    """The int8-pool twin: ``k_pages``/``v_pages`` int8 [NB, bs, Nkv, D],
    ``k_scales``/``v_scales`` f32 [NB, Nkv, bs]; q f32 or bf16 ->
    [T, Nq, D] in q's dtype.  Raises as the full-precision entry does;
    never falls back."""
    global quant_launches
    _check(q, k_pages, v_pages, block_tables, row_start, row_qlen,
           row_pos0, scales=(k_scales, v_scales))
    t, nq, d = q.shape
    _, bs, nkv, _ = k_pages.shape
    r, p = block_tables.shape
    out, part_acc, part_ml, splits, slots = _outputs(q, r, p, bs, nkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel("paged_ragged_attention_quant", pointers=12)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), row_start.data_ptr(),
            row_qlen.data_ptr(), row_pos0.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), _DTYPES[q.dtype], t, r,
            p, nq, nkv, d, bs, splits, slots, stream)
    if rc != 0:
        raise RuntimeError(f"int8 ragged attention kernel launch failed: "
                           f"CUDA error {rc}")
    quant_launches += 1
    return out


# ------------------------------------------------------- plain versions --
def ragged_plain(q, k_pages, v_pages, block_tables, row_start, row_qlen,
                 row_pos0):
    """The plain version in the kernel's per-row signature."""
    from ...inference.llm.paged_attention import (
        paged_ragged_attention_plain,
        token_descriptors,
    )
    ctx, rows = token_descriptors(q.shape[0], row_start, row_qlen,
                                  row_pos0)
    return paged_ragged_attention_plain(q, k_pages, v_pages, block_tables,
                                        ctx, rows)


def ragged_quant_plain(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, row_start, row_qlen, row_pos0):
    """The int8 plain version in the kernel's per-row signature."""
    from ...inference.llm.paged_attention import (
        paged_ragged_attention_quant_plain,
        token_descriptors,
    )
    ctx, rows = token_descriptors(q.shape[0], row_start, row_qlen,
                                  row_pos0)
    return paged_ragged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                              v_scales, block_tables, ctx,
                                              rows)


# ------------------------------------------------------------------ ops --
@torch.library.custom_op("paddle_tpu_torch::paged_ragged_attention",
                         mutates_args=(), device_types="cuda")
def ragged_op(q: Tensor, k_pages: Tensor, v_pages: Tensor,
              block_tables: Tensor, row_start: Tensor, row_qlen: Tensor,
              row_pos0: Tensor) -> Tensor:
    """B1 as an op: :func:`paged_ragged_attention_cuda` on CUDA tensors,
    :func:`ragged_plain` on CPU ones."""
    return paged_ragged_attention_cuda(q, k_pages, v_pages, block_tables,
                                       row_start, row_qlen, row_pos0)


@torch.library.custom_op("paddle_tpu_torch::paged_ragged_attention_quant",
                         mutates_args=(), device_types="cuda")
def ragged_quant_op(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                    k_scales: Tensor, v_scales: Tensor, block_tables: Tensor,
                    row_start: Tensor, row_qlen: Tensor,
                    row_pos0: Tensor) -> Tensor:
    """B5 as an op: :func:`paged_ragged_attention_quant_cuda` on CUDA
    tensors, :func:`ragged_quant_plain` on CPU ones."""
    return paged_ragged_attention_quant_cuda(q, k_pages, v_pages, k_scales,
                                             v_scales, block_tables,
                                             row_start, row_qlen, row_pos0)


ragged_op.register_kernel("cpu")(ragged_plain)
ragged_quant_op.register_kernel("cpu")(ragged_quant_plain)


@ragged_op.register_fake
def _ragged_fake(q, k_pages, v_pages, block_tables, row_start, row_qlen,
                 row_pos0):
    return torch.empty_like(q)


@ragged_quant_op.register_fake
def _ragged_quant_fake(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, row_start, row_qlen, row_pos0):
    return torch.empty_like(q)


# ----------------------------------------------------------------- cost --
def has_data(t):
    """Whether ``t`` holds values (not a fake or meta stand-in): a cost
    rule counts data-dependent work only from values."""
    from torch._subclasses.fake_tensor import FakeTensor

    return not isinstance(t, FakeTensor) and t.device.type != "meta"


def ragged_cost(q, k_pages, v_pages, block_tables, row_start, row_qlen,
                row_pos0, k_scales=None, v_scales=None):
    """``{"flops", "bytes"}`` of one call: each input byte read once — q
    of the live tokens, the K/V pages the rows' contexts cover (with an
    int8 pool's f32 scale per (slot, kv head) of those pages), the tables
    and descriptors — and the output written once, against the FLOPs of
    QK^T and PV over each live token's context.  The work depends on
    the descriptors' values; from stand-ins without values (a traced
    graph) it counts what any values need: the tables, the descriptors
    and the output."""
    t, nq, d = q.shape
    _, bs, nkv, _ = k_pages.shape
    isz = q.element_size()
    scale_bytes = 0 if k_scales is None else k_scales.element_size()
    flops, nbytes = 0.0, 4 * (block_tables.numel() + 3 * row_start.numel())
    nbytes += t * nq * d * isz                              # output
    if has_data(row_start):
        rs, rq, rp = (x.cpu().numpy() for x in (row_start, row_qlen,
                                                row_pos0))
        btn = block_tables.cpu().numpy()  # noqa: H001 (cost rule: reads the descriptors' values to count the work, off the step path)
        pages, live = set(), 0
        for r in range(len(rs)):
            if rq[r] == 0:
                continue
            live += int(rq[r])  # noqa: H001 (cost rule: host numpy descriptors)
            npg = -(-int(rp[r] + rq[r]) // bs)  # noqa: H001 (cost rule: host numpy descriptors)
            pages.update(int(p) for p in btn[r, :npg])
            ctx = rp[r] + np.arange(1, rq[r] + 1)
            flops += 4.0 * d * nq * float(ctx.sum())  # noqa: H001 (cost rule: host numpy descriptors)
        nbytes += (live * nq * d * isz                      # q
                   + 2 * len(pages) * bs * nkv * d * k_pages.element_size()
                   + 2 * len(pages) * bs * nkv * scale_bytes)
    return {"flops": flops, "bytes": float(nbytes)}


def ragged_quant_cost(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                      row_start, row_qlen, row_pos0):
    """:func:`ragged_cost` of the int8 entry, scale pools included."""
    return ragged_cost(q, k_pages, v_pages, block_tables, row_start,
                       row_qlen, row_pos0, k_scales, v_scales)
