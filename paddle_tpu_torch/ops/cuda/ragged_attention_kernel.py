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

The wrapper takes CUDA tensors only and raises on anything the kernel
does not take; the plain PyTorch version for CPU tensors is
``inference/llm/paged_attention.py::paged_ragged_attention_plain``.
``launches`` counts the kernel's launches (and nothing else).
"""

import ctypes

import torch

from . import _build

# incremented once per kernel launch, nowhere else
launches = 0

_NAME = "ragged_attention"
_ROWS = 16        # query rows (token x head) per block: kRows in the .cu
_MAX_D = 128      # kMaxD in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def supports(block_size, head_dim, num_q_heads, num_kv_heads, total_tokens):
    """What the CUDA kernel itself needs: any token count and page size,
    whole GQA groups of at most 16 query heads per kv head, and a
    head_dim that is a multiple of 8 (16-byte loads) up to 128.  The
    TPU kernel's ``T % 8`` and ``block_size % 8`` tiling rules do not
    apply."""
    return (total_tokens >= 1 and block_size >= 1 and num_kv_heads >= 1
            and num_q_heads % num_kv_heads == 0
            and num_q_heads // num_kv_heads <= _ROWS
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_D)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(_NAME).paged_ragged_attention
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pages, v_pages, block_tables, row_start, row_qlen,
           row_pos0):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "row_start": row_start,
               "row_qlen": row_qlen, "row_pos0": row_pos0}
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
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one dtype")
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
    if not supports(bs, d, nq, nkv, t):
        raise ValueError(
            f"shape not supported by the CUDA kernel: T={t}, Nq={nq}, "
            f"Nkv={nkv}, D={d}, block_size={bs}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    out = torch.zeros_like(q)      # padding and dead rows stay exact zeros
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       block_tables.data_ptr(), row_start.data_ptr(),
                       row_qlen.data_ptr(), row_pos0.data_ptr(),
                       out.data_ptr(), _DTYPES[q.dtype], t, r, p, nq, nkv,
                       d, bs, stream)
    if rc != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out
