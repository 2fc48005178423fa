"""Sequence and context parallelism: ring attention, Ulysses, SP marks.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/sequence_parallel.py``.
The JAX functions run inside ``shard_map`` over a mesh axis: ``lax.ppermute``
rotates k/v around the ring, ``lax.all_to_all`` swaps a sequence shard for
a head shard, and AD transposes both.  The port runs one process a rank,
and each function takes the rank's shard and a ``Group`` (the ranks of the
axis, in ring order):

- **Ring attention** (:func:`ring_attention`): each of the group's P steps
  attends the rank's queries to one chunk of keys with running-softmax
  statistics (the JAX ``_block_attn``, f32) and passes k/v on to the next
  rank.  The pass is an autograd function (``_RingPass``: forward sends
  to rank + 1 and receives from rank - 1, backward the reverse), and the
  step body runs under ``torch.utils.checkpoint`` (non-reentrant), as
  the JAX step under ``jax.checkpoint``, so the backward recomputes each
  block instead of keeping P score matrices.  Every step runs on every
  rank, a causal chunk entirely after the rank's queries too (its
  weights are exp(-1e30 - m) = 0 in the merge, as in JAX): each pass's
  output then has a user on every rank, so each rank's backward runs
  every pass's exchange and the ranks' exchanges pair up.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all trades the
  sequence shard for a head shard, dense attention runs over the whole
  sequence with N/P heads, and a second all-to-all swaps back; both are
  autograd functions whose backward is the inverse all-to-all.  Heads
  not divisible by P raise the JAX ``ValueError``.
- :func:`context_parallel_attention` keeps the JAX contract: global
  ``[B, T, N, H]`` q/k/v in, the global output out.  Each rank takes its
  sequence chunk (``mark_sequence_sharded``: backward all-gathers, so
  the gradient of the replicated q, k and v is the dense one on every
  rank), runs the ring or Ulysses over the mesh axis's group and gathers
  the output back (``mark_replicated``: backward keeps the rank's chunk).
- ``mark_sequence_sharded`` / ``mark_replicated``: the JAX sharding
  constraints, as the scatter/gather pair over the active mesh's axis
  (the identity without a mesh or on an axis of one rank).

The ring and Ulysses are torch compositions, as the JAX functions are
XLA compositions (no Pallas kernel): the dense attention inside Ulysses
is ``_block_attn`` itself.
"""

import torch
from torch.utils.checkpoint import checkpoint

from . import mp_layers

_MASK_VALUE = -1e30


def _block_attn(q, k, v, q_offset, k_offset, causal, scale):
    """Unnormalized block attention with running-softmax stats.

    q: [B, Tq, N, H]; k/v: [B, Tk, N, H].  Returns (o_unnorm [B,Tq,N,H] f32,
    m [B,Tq,N] rowmax f32, l [B,Tq,N] rowsum f32) for cross-block merging.
    """
    qf, kf = q.float(), k.float()
    s = torch.einsum("btnh,bsnh->bnts", qf, kf) * scale     # [B,N,Tq,Tk]
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        rows = q_offset + torch.arange(tq, device=q.device)[:, None]
        cols = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, _MASK_VALUE)
    m = s.max(dim=-1).values.clamp(min=_MASK_VALUE)         # [B,N,Tq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bnts,bsnh->btnh", p, v.float())
    return o, m.transpose(1, 2), l.transpose(1, 2)


def _exchange(t, g, send_to, recv_from):
    """``t`` sent to group rank ``send_to`` while the same-shaped tensor
    of group rank ``recv_from`` is received (one batched pair)."""
    from torch import distributed as dist

    buf = mp_layers._stage(g, t)
    got = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, g.ranks[send_to],
                      group=g.process_group),
           dist.P2POp(dist.irecv, got, g.ranks[recv_from],
                      group=g.process_group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(t.device)


class _RingPass(torch.autograd.Function):
    """Forward: send to the next rank, receive from the previous one;
    backward: the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        p, r = g.nranks, g.rank
        return _exchange(x.contiguous(), g, (r + 1) % p, (r - 1) % p)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        p, r = g.nranks, g.rank
        return _exchange(dy.contiguous(), g, (r - 1) % p, (r + 1) % p), None


def _merge(q, kv, o, m, l, q_offset, k_offset, causal, scale):
    """One ring step: attend to the chunk ``kv`` ([2, B, Tk, N, H]) and
    merge into the running (o, m, l)."""
    o_j, m_j, l_j = _block_attn(q, kv[0], kv[1], q_offset, k_offset,
                                causal, scale)
    m_new = torch.maximum(m, m_j)
    alpha = torch.exp(m - m_new)[..., None]
    alpha_j = torch.exp(m_j - m_new)[..., None]
    o = o * alpha + o_j * alpha_j
    l = l * alpha[..., 0] + l_j * alpha_j[..., 0]
    return o, m_new, l


def ring_attention(q, k, v, group, is_causal=False, scale=None):
    """Ring (context-parallel) attention over ``group``.

    q, k, v: this rank's sequence chunks [B, T/P, N, H] (rank i of the
    group holds chunk i).  Returns its output chunk [B, T/P, N, H]."""
    p_size = mp_layers._size(group)
    my = max(group.rank, 0) if group is not None else 0
    b, tl, n, h = q.shape
    if scale is None:
        scale = 1.0 / (h ** 0.5)
    o = q.new_zeros((b, tl, n, h), dtype=torch.float32)
    m = q.new_full((b, tl, n), _MASK_VALUE, dtype=torch.float32)
    l = q.new_zeros((b, tl, n), dtype=torch.float32)
    kv = torch.stack([k, v])
    for j in range(p_size):
        src = (my - j) % p_size
        o, m, l = checkpoint(_merge, q, kv, o, m, l, my * tl, src * tl,
                             is_causal, scale, use_reentrant=False)
        if j + 1 < p_size:
            kv = _RingPass.apply(kv, group)
    l = l.clamp(min=1e-30)
    return (o / l[..., None]).to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """[B, T/P, N, H] -> [B, T, N/P, H] (``to_heads``) or back; the
    backward is the other direction."""

    @staticmethod
    def forward(ctx, x, g, to_heads):
        ctx.g, ctx.to_heads = g, to_heads
        return _all_to_all(x, g, to_heads)

    @staticmethod
    def backward(ctx, dy):
        return _all_to_all(dy, ctx.g, not ctx.to_heads), None, None


def _all_to_all(x, g, to_heads):
    from torch import distributed as dist

    p = g.nranks
    if to_heads:
        # block i of the heads goes to rank i; the received blocks are
        # the ranks' sequence chunks, in rank order
        src = torch.stack(x.chunk(p, dim=2))          # [P, B, T/P, N/P, H]
    else:
        src = torch.stack(x.chunk(p, dim=1))          # [P, B, T/P, N/P, H]
    buf = mp_layers._stage(g, src)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g.process_group)
    out = out.to(x.device)
    parts = list(out.unbind(0))
    return torch.cat(parts, dim=1 if to_heads else 2)


def ulysses_attention(q, k, v, group, is_causal=False, scale=None,
                      attn_fn=None):
    """Ulysses all-to-all attention over ``group``.

    q, k, v: this rank's chunks [B, T/P, N, H] with N divisible by the
    group's size.  Swaps the sequence shard for a head shard, runs
    full-sequence attention locally, and swaps back."""
    p_size = mp_layers._size(group)
    n = q.shape[2]
    if n % p_size != 0:
        raise ValueError(
            f"ulysses needs num_heads ({n}) divisible by sp degree "
            f"({p_size})")

    def seq_gather(x):
        return x if p_size == 1 else _AllToAll.apply(x, group, True)

    def seq_scatter(x):
        return x if p_size == 1 else _AllToAll.apply(x, group, False)

    qg, kg, vg = seq_gather(q), seq_gather(k), seq_gather(v)
    if attn_fn is None:
        h = q.shape[3]
        sc = scale if scale is not None else 1.0 / (h ** 0.5)
        o, _, l = _block_attn(qg, kg, vg, 0, 0, is_causal, sc)
        out = (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    else:
        out = attn_fn(qg, kg, vg, is_causal)
    return seq_scatter(out)


def context_parallel_attention(q, k, v, mesh, axis="sp", mode="ring",
                               is_causal=False):
    """Global q/k/v [B, T, N, H] (the same on every rank of ``axis``) in,
    the global output out: each rank runs its sequence chunk through the
    ring or Ulysses over the axis's group (module docstring)."""
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[mode]
    group = mesh.group(axis)
    qs, ks, vs = (mp_layers.scatter_to_mp(t, group, 1) for t in (q, k, v))
    out = fn(qs, ks, vs, group, is_causal=is_causal)
    return mp_layers.gather_from_mp(out, group, 1)


# ----------------------------- Megatron-style SP (activation sharding) ----

def _axis_group(axis):
    from ..spmd import current_mesh

    mesh = current_mesh()
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return None
    return mesh.group(axis)


def mark_sequence_sharded(x, axis="mp", seq_dim=1):
    """This rank's chunk of ``x``'s sequence dim over the active mesh's
    ``axis`` (backward: the chunks' gradients gathered).  The identity
    without a mesh or when the mesh lacks ``axis``."""
    g = _axis_group(axis)
    return x if g is None else mp_layers.scatter_to_mp(x, g, seq_dim)


def mark_replicated(x, axis="mp", seq_dim=1):
    """The chunks of a sequence-sharded ``x`` gathered back over the
    active mesh's ``axis`` (backward: this rank's chunk of the
    gradient)."""
    g = _axis_group(axis)
    return x if g is None else mp_layers.gather_from_mp(x, g, seq_dim)
