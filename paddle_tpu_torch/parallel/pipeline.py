"""Pipeline parallelism over the ranks of a mesh's ``pp`` axis.

Port of ``paddle_tpu/parallel/pipeline.py``.  The JAX function runs the
schedule inside one XLA program: a ``shard_map`` over the ``pp`` mesh
axis, a ``lax.scan`` over schedule ticks and ``lax.ppermute`` moving
activations stage to stage, with the reverse pipeline falling out of AD
through the scan.  The port runs one process a rank, so each pp rank
holds only its stage's stacked layers (``v`` chunks of them with
``virtual_pp``) and runs the same schedule of ``m*v + pp - 1`` ticks in
Python, skipping the ticks where it is idle:

- tick ``t`` of stage ``s`` is stage-local tick ``u = t - s``, which
  decodes to (chunk ``c``, microbatch ``mb``) exactly as the JAX tick
  does: stage 0 takes a fresh microbatch on its chunk-0 ticks, every
  other input arrives from the previous stage (the last stage's chunk
  ``c`` output wraps to stage 0 as chunk ``c + 1``), and the last stage
  keeps its last chunk's outputs;
- an activation crosses stages by point-to-point messages over the pp
  group inside ``torch.autograd.Function`` s: :class:`_Send` posts it
  (``isend``) and its backward receives the activation's gradient from
  the next stage; :class:`_Recv` receives it and its backward sends the
  gradient back.  Each message carries a tag made from its (microbatch,
  chunk, direction), every send is posted without blocking and only
  receives wait, so the backward order autograd picks cannot deadlock:
  the reverse pipeline falls out of autograd as it falls out of AD;
- the last stage's outputs are broadcast to every stage (the JAX
  masked ``psum``), and the broadcast's backward hands on only the last
  stage's own gradient: every stage differentiates the same loss, and
  the last stage's outputs get its gradient once, not pp times.  The
  broadcast also takes each stage's pending sends, so a stage's backward
  reaches all of them.

A CUDA tensor crosses a gloo group through the host (two ranks sharing
one card cannot form an NCCL group).  Dropout: the JAX package folds the
key per stage and tick and splits it per layer; the port reseeds the
block's generators (``block_fn.generators``, (generator, salt) pairs:
a salt apart for a rank-local generator) per (stage, tick, layer)
from ``rng_key`` (an int or a ``torch.Generator``), so the masks differ
per layer and repeat for one key, but are not the JAX bits.
"""

import numpy as np
import torch

from ..distributed.fleet.meta_parallel import mp_layers

FWD, BWD = 0, 1


def interleave_permutation(n_layers, pp, v):
    """Layer order for the interleaved schedule: position (s, c, l) holds
    layer (c*pp + s)*Lc + l, so a contiguous pp-split gives stage s its v
    round-robin chunks.  Apply once at parameter-placement time; invert with
    ``np.argsort`` to recover the canonical stacked layout."""
    lc = n_layers // (pp * v)
    return np.array([(c * pp + s) * lc + l
                     for s in range(pp) for c in range(v) for l in range(lc)])


def fold_seed(seed, *ints):
    """A 63-bit seed from ``seed`` and ``ints`` (host arithmetic, the same
    on every rank)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 63 - 1)] +
                                [int(i) for i in ints])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def base_seed(rng_key):
    """An int seed from ``rng_key``: an int as it is, a ``torch.Generator``
    by one draw (which advances it), None as None."""
    if rng_key is None or isinstance(rng_key, int):
        return rng_key
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng_key,
                             device=rng_key.device).item())


def _reseed_and_call(block_fn, seed, p, h):
    if seed is not None:
        for g, salt in getattr(block_fn, "generators", ()):
            g.manual_seed(fold_seed(seed, salt) if salt else seed)
    return block_fn(p, h)


def _apply_layer(block_fn, p, h, seed):
    """One layer; under ``block_fn.remat`` its activations are recomputed
    in the backward (``torch.utils.checkpoint``), the generators reseeded
    inside, so the recompute draws the forward's masks."""
    if getattr(block_fn, "remat", False) and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(_reseed_and_call, block_fn, seed, p, h,
                          use_reentrant=False)
    return _reseed_and_call(block_fn, seed, p, h)


def _layer_scan(block_fn, x, stacked_params, rng_key=None):
    """The stacked layers in order, a fresh dropout seed per layer."""
    n = next(iter(stacked_params.values())).shape[0]
    seed = base_seed(rng_key)
    for i in range(n):
        p = {k: v[i] for k, v in stacked_params.items()}
        x = _apply_layer(block_fn, p, x,
                         None if seed is None else fold_seed(seed, i))
    return x


# ------------------------------------------------------------ messages --
class _Link:
    """The pp group of one pipeline call: its process group, this stage
    and its neighbours' global ranks, the sends still in flight."""

    def __init__(self, group, stage, pp):
        self.group, self.stage, self.pp = group, stage, pp
        self.next = group.ranks[(stage + 1) % pp]
        self.prev = group.ranks[(stage - 1) % pp]
        self.gloo = group.backend == "gloo"
        self.pending = []

    def isend(self, t, dst, tag):
        from torch import distributed as dist

        buf = mp_layers._stage(self.group, t)
        self.pending.append((dist.isend(buf, dst, group=self.group
                                        .process_group, tag=tag), buf))

    def recv(self, like, src, tag):
        from torch import distributed as dist

        dev = like.device
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.gloo else dev)
        dist.recv(buf, src, group=self.group.process_group, tag=tag)
        return buf.to(dev)

    def drain(self):
        while self.pending:
            work, _ = self.pending.pop()
            work.wait()


# links whose backward may still post sends; the next pipeline call (or
# ``drain_sends``) waits for them
_LINKS = []


def drain_sends():
    """Wait for every send a pipeline's backward posted (the trainer calls
    it after each backward; a later pipeline call does so first)."""
    while _LINKS:
        _LINKS.pop().drain()


def _tag(mb, c, v, direction):
    return (mb * v + c) * 2 + direction


class _Send(torch.autograd.Function):
    """Send ``x`` to the next stage; the output is a zero token that ties
    the send into the loss, and the backward receives ``x``'s gradient
    from the next stage."""

    @staticmethod
    def forward(ctx, x, link, tag):
        link.isend(x, link.next, tag)
        ctx.link, ctx.tag, ctx.like = link, tag, x.detach()
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = ctx.link.recv(ctx.like, ctx.link.next, ctx.tag + BWD)
        return g, None, None


class _Recv(torch.autograd.Function):
    """Receive an activation shaped like ``like`` from the previous stage
    (``anchor`` puts the receive into the graph); the backward sends its
    gradient back."""

    @staticmethod
    def forward(ctx, anchor, like, link, tag):
        ctx.link, ctx.tag = link, tag
        return link.recv(like, link.prev, tag)

    @staticmethod
    def backward(ctx, g):
        ctx.link.isend(g, ctx.link.prev, ctx.tag + BWD)
        return None, None, None, None


class _Replicate(torch.autograd.Function):
    """The last stage's ``outputs`` broadcast over the pp group; the
    backward hands on the last stage's own gradient only and zeros to
    the send tokens."""

    @staticmethod
    def forward(ctx, outputs, link, *tokens):
        ctx.last = link.stage == link.pp - 1
        ctx.n = len(tokens)
        return mp_layers.broadcast(outputs, link.group, link.pp - 1)

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.last else None, None) +
                tuple(g.new_zeros(()) for _ in range(ctx.n)))


def pipeline_stage(block_fn, local_params, x_micro, *, group, stage, pp,
                   virtual_pp=1, seed=None, like=None):
    """This stage's part of the schedule (module docstring) over its own
    stacked layers ``local_params`` (leaves ``[v * Lc, ...]``, the stage's
    chunks in order) and the microbatched input ``x_micro`` ``[m, mb,
    ...]`` (read on stage 0 only; another stage may pass None with
    ``like``, a tensor of its shape, dtype and device).  Returns the
    outputs ``[m, mb, ...]`` on every stage."""
    v = int(virtual_pp)
    like = x_micro if x_micro is not None else like
    m = like.shape[0]
    n_local = next(iter(local_params.values())).shape[0]
    lc = n_local // v
    ticks_per_stage = m * v
    drain_sends()
    link = _Link(group, stage, pp)
    _LINKS.append(link)
    anchor = torch.zeros((), device=like.device, requires_grad=True)
    chunks = [{k: leaf[c * lc:(c + 1) * lc] for k, leaf in
               local_params.items()} for c in range(v)]
    outputs = [None] * m
    tokens = []
    one = like[0].detach()
    try:
        for t in range(m * v + pp - 1):
            u = t - stage
            if not 0 <= u < ticks_per_stage:
                continue
            r = u % (v * pp)
            c = r // pp
            mb = (u // (v * pp)) * pp + r % pp
            if stage == 0 and c == 0:
                h = x_micro[mb]
            else:
                h = _Recv.apply(anchor, one, link, _tag(mb, c, v, FWD))
            for i in range(lc):
                p = {k: leaf[i] for k, leaf in chunks[c].items()}
                h = _apply_layer(block_fn, p, h, None if seed is None else
                                 fold_seed(seed, stage, t, i))
            if stage == pp - 1 and c == v - 1:
                outputs[mb] = h
            else:
                nc = c + 1 if stage == pp - 1 else c
                tokens.append(_Send.apply(h, link, _tag(mb, nc, v, FWD)))
        out = torch.stack(outputs) if stage == pp - 1 else \
            torch.zeros_like(like)
        return _Replicate.apply(out, link, *tokens)
    finally:
        link.drain()


def spmd_pipeline(block_fn, stacked_params, x, *, mesh, n_microbatches,
                  axis="pp", rng_key=None, activation_spec=None,
                  virtual_pp=1, prepermuted=False):
    """Run ``x`` through the pipeline stages of ``mesh``'s ``axis``.

    Args:
      block_fn: ``(layer_params, hidden) -> hidden`` for ONE layer.
      stacked_params: dict with leaves ``[num_layers, ...]``, the whole
        stack on every rank as the JAX global array is (interleave-
        permuted already when ``prepermuted``); each stage runs its own
        ``num_layers // pp`` layers of it (``virtual_pp`` round-robin
        chunks when > 1) and only those get gradients on its rank.
      x: activations ``[batch, ...]``, the same on every stage (only stage
        0 reads them).
      n_microbatches: must divide batch.
      virtual_pp: the interleaved schedule's v (the JAX docstring's).
      activation_spec: accepted for the JAX signature; a rank holds its
        own activations, so there is no sharding to keep.
    Returns activations after all layers, same shape as x, on every
    stage."""
    pp = mesh.axis_size(axis)
    v = int(virtual_pp)
    assert v >= 1, f"virtual_pp must be >= 1, got {virtual_pp}"
    n_layers = next(iter(stacked_params.values())).shape[0]
    if pp == 1:
        return _layer_scan(block_fn, x, stacked_params, rng_key)
    m = n_microbatches
    batch = x.shape[0]
    assert batch % m == 0, f"batch {batch} not divisible by microbatches {m}"
    assert n_layers % (pp * v) == 0, \
        f"num_layers {n_layers} not divisible by pp*virtual_pp {pp}*{v}"
    if v > 1:
        assert m % pp == 0, \
            (f"interleaved schedule needs n_microbatches ({m}) divisible by "
             f"pp ({pp}) — microbatches advance chunks in groups of pp")
    if v > 1 and not prepermuted:
        perm = torch.as_tensor(interleave_permutation(n_layers, pp, v))
        stacked_params = {k: leaf[perm.to(leaf.device)]
                          for k, leaf in stacked_params.items()}
    stage = mesh.coord(axis)
    n = n_layers // pp
    local = {k: leaf[stage * n:(stage + 1) * n]
             for k, leaf in stacked_params.items()}
    x_micro = x.reshape((m, batch // m) + tuple(x.shape[1:]))
    out = pipeline_stage(block_fn, local, x_micro, group=mesh.group(axis),
                         stage=stage, pp=pp, virtual_pp=v,
                         seed=base_seed(rng_key))
    return out.reshape(x.shape)
