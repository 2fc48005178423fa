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
