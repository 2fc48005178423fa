"""Paged attention — the one ragged entry point of the serving step.

Every serving phase is the same computation: a query token at absolute
position ``p`` attends over pool positions ``0..p`` through its row's
block table.  A decode row is a one-token chunk, a prefill chunk a
C-token chunk, so the engine calls :func:`paged_ragged_attention` once
per layer over the step's packed query tokens.

Two implementations with one semantics:

- CUDA tensors: the hand-written kernel
  (``ops/cuda/ragged_attention_kernel.py``), which walks exactly the
  pages each row owns through per-row ``(row_start, row_qlen,
  row_pos0)`` descriptors;
- CPU tensors: :func:`paged_ragged_attention_plain`, which gathers each
  token's pages into the dense layout and runs the masked attention
  (f32 softmax, -1e30 mask, 1/sqrt(D) inside, exact zeros for tokens
  outside every row).

The int8-pool twin, :func:`paged_ragged_attention_quant`, takes int8
pools plus one f32 scale per (page, kv head, slot) and dispatches the
same way: the int8 kernel for CUDA tensors, and for CPU tensors
:func:`paged_ragged_attention_quant_plain`, which gathers each token's
pages and scale rows, dequantizes in f32 and runs the same chain.

The JAX package's three per-phase forms stay as thin re-expressions
over the same ragged call — :func:`paged_decode_attention` (one-token
rows), :func:`paged_verify_attention` (a speculative row of T tokens at
consecutive positions sharing one block-table row) and
:func:`paged_prefill_attention` (one sequence's chunk) — each with its
``_plain`` form for CPU tensors.

There is no flag and no shape-based fallback: the CUDA kernel takes any
token count and page size, and raises on what it cannot take.
"""

import math

import torch

from ...ops.cuda import ragged_attention_kernel as _kernel


def paged_ragged_attention_plain(q, k_pages, v_pages, block_tables, ctx,
                                 rows):
    """Plain PyTorch ragged attention, per-token form.

    q [T, Nq, D] packed query tokens; ``rows`` [T] maps each token to
    its block-table row, ``ctx`` [T] is each token's visible context
    length (0 for dead/padding tokens -> exact-zero output)."""
    r, num_pages = block_tables.shape
    _, bs, nkv, d = k_pages.shape
    s_max = num_pages * bs
    bt = block_tables.long()
    rows = rows.long()
    k = k_pages[bt].reshape(r, s_max, nkv, d)[rows]
    v = v_pages[bt].reshape(r, s_max, nkv, d)[rows]
    return _ragged_masked_chain(q, k, v, ctx)


def _ragged_masked_chain(q, k, v, ctx):
    """q [T, Nq, D] against gathered k/v [T, S_max, Nkv, D] with
    per-token visible context ``ctx`` [T]."""
    t, nq, d = q.shape
    s_max, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(t, nkv, g, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("tngd,tsnd->tngs", qg.float(), k.float()) * scale
    mask = (torch.arange(s_max, device=q.device)[None, None, None, :]
            < ctx[:, None, None, None])
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("tngs,tsnd->tngd", p, v.float())
    out = torch.where(ctx[:, None, None, None] > 0, out, 0.0)
    return out.reshape(t, nq, d).to(q.dtype)


def paged_ragged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                       v_scales, block_tables, ctx, rows):
    """Plain PyTorch ragged attention over an int8 pool, per-token form.

    ``k_pages``/``v_pages`` [NB, bs, Nkv, D] int8 and
    ``k_scales``/``v_scales`` [NB, Nkv, bs] float32 — one symmetric
    dequant scale per (page, kv head, slot), as the engine's quantized
    append writes them.  Gathers each token's pages and scale rows,
    dequantizes in f32 (``int8 * scale``, the product the kernel forms
    per loaded slot), then runs the same masked chain as
    :func:`paged_ragged_attention_plain`."""
    r, num_pages = block_tables.shape
    _, bs, nkv, d = k_pages.shape
    s_max = num_pages * bs
    bt = block_tables.long()
    rows = rows.long()

    def deq(pages, scales):
        pg = pages[bt].float()                      # [R, P, bs, Nkv, D]
        sc = scales[bt].float()                     # [R, P, Nkv, bs]
        pg = pg * sc.transpose(2, 3)[..., None]
        return pg.reshape(r, s_max, nkv, d)[rows]

    return _ragged_masked_chain(q, deq(k_pages, k_scales),
                                deq(v_pages, v_scales), ctx)


def token_descriptors(num_tokens, row_start, row_qlen, row_pos0):
    """Per-row descriptors -> the per-token ``(ctx, rows)`` form, on the
    descriptors' device and without a host round trip: token ``i`` of
    row ``r`` gets ``ctx = row_pos0[r] + i + 1``; tokens outside every
    row get ``ctx = 0`` (and row 0)."""
    t = torch.arange(num_tokens, device=row_start.device,
                     dtype=torch.int32)[None, :]
    start = row_start[:, None]
    inside = (t >= start) & (t < start + row_qlen[:, None])     # [R, T]
    ridx = torch.arange(row_start.shape[0], device=row_start.device,
                        dtype=torch.int32)[:, None]
    rows = (inside * ridx).sum(0).to(torch.int32)
    ctx = (inside * (row_pos0[:, None] + t - start + 1)).sum(0)
    return ctx.to(torch.int32), rows


def paged_ragged_attention(q, k_pages, v_pages, block_tables, ctx, rows,
                           row_start, row_qlen, row_pos0):
    """Ragged paged attention over T packed query tokens -> [T, Nq, D].

    Carries both descriptor forms: the plain version is per-token
    (``ctx``, ``rows`` [T]), the kernel per-row (``row_start``,
    ``row_qlen``, ``row_pos0`` [R] against ``block_tables`` [R, P]).
    A CUDA ``q`` launches the kernel (which raises on inputs it does
    not take); a CPU ``q`` runs the plain version."""
    if q.is_cuda:
        return _kernel.paged_ragged_attention_cuda(
            q, k_pages, v_pages, block_tables, row_start, row_qlen,
            row_pos0)
    return paged_ragged_attention_plain(q, k_pages, v_pages, block_tables,
                                        ctx, rows)


def paged_ragged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, ctx, rows, row_start,
                                 row_qlen, row_pos0):
    """The int8-pool twin of :func:`paged_ragged_attention`, with the
    same two descriptor forms plus the two scale pools.  A CUDA ``q``
    launches the int8 kernel (which raises on inputs it does not take);
    a CPU ``q`` runs the plain version."""
    if q.is_cuda:
        return _kernel.paged_ragged_attention_quant_cuda(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            row_start, row_qlen, row_pos0)
    return paged_ragged_attention_quant_plain(q, k_pages, v_pages, k_scales,
                                              v_scales, block_tables, ctx,
                                              rows)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                 lengths):
    """Plain PyTorch decode form: q [B, Nq, D], row ``b`` attends over
    its first ``lengths[b]`` pool positions (0 -> exact zeros)."""
    rows = torch.arange(q.shape[0], device=q.device, dtype=torch.int32)
    return paged_ragged_attention_plain(q, k_pages, v_pages, block_tables,
                                        lengths.to(torch.int32), rows)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q [B, Nq, D] x paged pool -> [B, Nq, D], one token a row: batch
    row ``b`` is the ragged row (start ``b``, qlen 1 if live, pos0
    ``lengths[b] - 1``).  CUDA ``q``: the ragged kernel; CPU ``q``: the
    plain version."""
    if q.is_cuda:
        b = q.shape[0]
        lengths = lengths.to(torch.int32)
        return _kernel.paged_ragged_attention_cuda(
            q, k_pages, v_pages, block_tables,
            torch.arange(b, device=q.device, dtype=torch.int32),
            (lengths > 0).to(torch.int32), (lengths - 1).clamp(min=0))
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                        lengths)


def paged_verify_attention_plain(q, k_pages, v_pages, block_tables, ctx):
    """Plain PyTorch verify form: q [B, T, Nq, D], T query tokens a
    sequence at consecutive positions; ``ctx`` [B, T] is each token's
    visible context (0 -> exact zeros).  The per-token chain over the
    flattened [B * T] tokens, every token gathering its sequence's
    pages: bitwise the flattened one-token decode batch."""
    b, t, nq, d = q.shape
    rows = torch.arange(b, device=q.device,
                        dtype=torch.int32).repeat_interleave(t)
    out = paged_ragged_attention_plain(
        q.reshape(b * t, nq, d), k_pages, v_pages, block_tables,
        ctx.reshape(b * t).to(torch.int32), rows)
    return out.reshape(b, t, nq, d)


def paged_verify_attention(q, k_pages, v_pages, block_tables, ctx):
    """q [B, T, Nq, D] verify rows x paged pool -> [B, T, Nq, D].  CUDA
    ``q``: sequence ``b`` is one ragged row (start ``b * T``, qlen its
    live tokens — always a prefix — pos0 ``ctx[b, 0] - 1``) on one
    block-table row; CPU ``q``: the plain version."""
    b, t, nq, d = q.shape
    if q.is_cuda:
        ctx = ctx.to(torch.int32)
        flat = _kernel.paged_ragged_attention_cuda(
            q.reshape(b * t, nq, d), k_pages, v_pages, block_tables,
            torch.arange(b, device=q.device, dtype=torch.int32) * t,
            (ctx > 0).sum(1, dtype=torch.int32),
            (ctx[:, 0] - 1).clamp(min=0))
        return flat.reshape(b, t, nq, d)
    return paged_verify_attention_plain(q, k_pages, v_pages, block_tables,
                                        ctx)


def paged_prefill_attention_plain(q, k_pages, v_pages, block_table, start):
    """Plain PyTorch prefill form: q [1, C, Nq, D] at positions
    ``start .. start + C - 1``, causal over the pool through the one
    ``block_table`` [P]."""
    c = q.shape[1]
    ctx = (int(start) + 1
           + torch.arange(c, device=q.device, dtype=torch.int32))
    rows = torch.zeros(c, device=q.device, dtype=torch.int32)
    return paged_ragged_attention_plain(q[0], k_pages, v_pages,
                                        block_table[None], ctx, rows)[None]


def paged_prefill_attention(q, k_pages, v_pages, block_table, start):
    """q [1, C, Nq, D] chunk x paged pool -> [1, C, Nq, D]: the single
    ragged row (start 0, qlen C, pos0 ``start``).  CUDA ``q``: the
    ragged kernel; CPU ``q``: the plain version."""
    if q.is_cuda:
        c = q.shape[1]
        one = torch.ones(1, device=q.device, dtype=torch.int32)
        return _kernel.paged_ragged_attention_cuda(
            q[0], k_pages, v_pages, block_table[None], 0 * one, c * one,
            int(start) * one)[None]
    return paged_prefill_attention_plain(q, k_pages, v_pages, block_table,
                                         start)
