"""Tensor-parallel (mpu) layers: Megatron's collectives, written out.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``
(reference python/paddle/distributed/fleet/layers/mpu/mp_layers.py:35,
173,343,524).  The JAX layers are dense math carrying
``Parameter.mesh_axes``; GSPMD partitions them over the ``mp`` mesh axis
and inserts every collective, and every result is the global one.  The
port runs one process a rank and each rank holds only its block, so the
collectives are written here, forward and backward, as
``torch.autograd.Function`` s over a ``Group``:

- ``copy_to_mp`` (identity; backward all-reduce) and ``reduce_from_mp``
  (all-reduce; backward identity): a column-parallel layer's input and a
  row-parallel layer's output;
- ``scatter_to_mp`` / ``gather_from_mp``: the last dim split and
  concatenated (Paddle's ``input_is_parallel=False`` and
  ``gather_output=True``);
- the sequence-parallel pair on dim 1: ``gather_from_seq`` (all-gather;
  backward reduce-scatter), the input of a column-parallel layer whose
  activations are sequence-sharded, and ``reduce_scatter_to_seq``
  (reduce-scatter; backward all-gather), the output of a row-parallel
  one;
- ``scatter_to_mp`` / ``gather_from_mp`` on dim 1 make a replicated
  tensor sequence-sharded and back (``mark_sequence_sharded`` /
  ``mark_replicated``, context parallelism).

A group of one rank makes each of them the identity.  A gloo group takes
a CUDA tensor through the host.

Both users run these functions: the Paddle-API layers below (port
``Layer`` s over Tensors) and the port's ``torch.nn.Module`` GPT and
Llama.  A parameter keeps its JAX ``mesh_axes``; a packed one (the fused
qkv of GPT and Llama, Llama's gate_up) also names the sizes of its
``mp_parts`` along the sharded dim: each part splits over the ranks on
its own, so rank r's block of GPT's ``[h, 3h]`` qkv holds its heads' q,
k and v columns, not a contiguous third of the columns
(:func:`block_of`, :func:`whole_of`: the function that carries weights
across and its inverse).  :class:`MPContext` is what a sliced model
holds: the mp group, whether it runs sequence parallelism, and the
generator of its rank-local dropout (Megatron's RNG tracker: dropout of
a replicated activation draws from the model's generator, the same
stream on every rank of the group; dropout of a sharded one, the
attention probabilities of the rank's heads or a sequence shard, from a
generator seeded apart for each rank).

``ParallelCrossEntropy`` (:func:`parallel_cross_entropy`) is the
reference's ``c_softmax_with_cross_entropy``: over logits whose vocab is
split over the ranks, the local max and an all-reduce MAX, the local sum
of exponentials and an all-reduce SUM, the target logit and an
all-reduce SUM; the backward is local.  The logits are never gathered.
"""

import numpy as np
import torch

from ....core.tensor import Tensor, _wrap
from ....nn import functional as F
from ....nn.initializer import Normal, XavierUniform
from ....nn.layer_base import Layer

MP_RNG_OFFSET = 2718     # Megatron's tensor-parallel seed offset


# ------------------------------------------------------- collectives --
def _size(g):
    return 1 if g is None else g.nranks


def _stage(g, t):
    """The buffer a collective of ``g`` runs on: contiguous, on the host
    for a gloo group and a CUDA tensor."""
    t = t.detach()
    if g.backend == "gloo" and t.is_cuda:
        return t.to("cpu", copy=True, memory_format=torch.contiguous_format)
    return t.contiguous()


def all_reduce(t, g, op="sum"):
    """``t`` summed (or max-ed) over ``g`` (a new tensor)."""
    from torch import distributed as dist

    if _size(g) == 1:
        return t
    buf = _stage(g, t)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op],
                    group=g.process_group)
    return buf.to(t.device)


def gather_list(t, g):
    """Every rank's ``t`` (one shape), in group order, on ``t``'s
    device."""
    from torch import distributed as dist

    if _size(g) == 1:
        return [t]
    buf = _stage(g, t)
    parts = [torch.empty_like(buf) for _ in range(g.nranks)]
    dist.all_gather(parts, buf, group=g.process_group)
    return [p.to(t.device) for p in parts]


def all_gather(t, g, dim):
    """The ranks' ``t`` concatenated along ``dim`` in group order."""
    if _size(g) == 1:
        return t
    return torch.cat(gather_list(t, g), dim=dim)


def broadcast(t, g, src=0):
    """Group rank ``src``'s ``t`` on every rank of ``g`` (a new tensor
    on ``t``'s device)."""
    from torch import distributed as dist

    if _size(g) == 1:
        return t
    buf = _stage(g, t)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.broadcast(buf, g.ranks[src], group=g.process_group)
    return buf.to(t.device)


def reduce_scatter(t, g, dim):
    """``t`` summed over ``g``, each rank keeping its block of ``dim``."""
    from torch import distributed as dist

    if _size(g) == 1:
        return t
    n = t.shape[dim]
    if n % g.nranks:
        raise ValueError(f"dim {dim} of {n} does not split over "
                         f"{g.nranks} ranks")
    buf = _stage(g, t.movedim(dim, 0))
    out = buf.new_empty((n // g.nranks,) + tuple(buf.shape[1:]))
    dist.reduce_scatter_tensor(out, buf.contiguous(),
                               group=g.process_group)
    return out.to(t.device).movedim(0, dim)


def split(t, g, dim):
    """This rank's block of ``dim`` (a contiguous copy)."""
    if _size(g) == 1:
        return t
    n = t.shape[dim]
    if n % g.nranks:
        raise ValueError(f"dim {dim} of {n} does not split over "
                         f"{g.nranks} ranks")
    return t.chunk(g.nranks, dim=dim)[g.rank].contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.g), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return split(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy.contiguous(), ctx.g, ctx.dim), None, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x.contiguous(), g, dim)

    @staticmethod
    def backward(ctx, dy):
        return split(dy, ctx.g, ctx.dim), None, None


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x.contiguous(), g, dim)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter(dy, ctx.g, ctx.dim), None, None


class _ReduceScatterGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return reduce_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy.contiguous(), ctx.g, ctx.dim), None, None


def copy_to_mp(x, g):
    return x if _size(g) == 1 else _CopyToMP.apply(x, g)


def reduce_from_mp(x, g):
    return x if _size(g) == 1 else _ReduceFromMP.apply(x, g)


def scatter_to_mp(x, g, dim=-1):
    return x if _size(g) == 1 else _ScatterToMP.apply(x, g, dim % x.dim())


def gather_from_mp(x, g, dim=-1):
    return x if _size(g) == 1 else _GatherFromMP.apply(x, g, dim % x.dim())


def gather_from_seq(x, g, dim=1):
    return x if _size(g) == 1 else _GatherReduceScatter.apply(x, g, dim)


def reduce_scatter_to_seq(x, g, dim=1):
    return x if _size(g) == 1 else _ReduceScatterGather.apply(x, g, dim)



# ------------------------------------------ the blocks a rank holds --
def parts_permutation(parts, tp):
    """Index order along a packed dim of ``parts`` (sizes) that puts
    rank r's block (each part's r-th 1/tp) at the r-th 1/tp of the dim."""
    offsets = np.cumsum([0] + list(parts))
    idx = []
    for r in range(tp):
        for off, n in zip(offsets[:-1], parts):
            if n % tp:
                raise ValueError(f"a part of {n} does not split over {tp} "
                                 "ranks")
            k = n // tp
            idx.append(np.arange(off + r * k, off + (r + 1) * k))
    return np.concatenate(idx)


def qkv_head_permutation(num_heads, head_dim, tp):
    """Column permutation taking the fused qkv layout (3, NH, D) to
    (tp, 3, NH/tp, D): a contiguous 1/tp column slice then holds the q, k
    and v projections of one head group, so rank r's plain column shard
    is exactly its heads (the JAX engine's ``_qkv_head_permutation``)."""
    if num_heads % tp:
        raise ValueError(f"{num_heads} heads do not split over {tp} ranks")
    h = num_heads * head_dim
    return parts_permutation((h, h, h), tp)


def mp_dim(axes):
    return None if axes is None or "mp" not in axes else \
        list(axes).index("mp")


def block_of(value, axes, parts, rank, size):
    """Rank ``rank`` of ``size``'s block of the whole ``value`` (numpy or
    torch) of a parameter with ``mesh_axes`` ``axes`` and packed
    ``parts`` (None: one part): the function that carries weights from
    the JAX layout to the ranks.  A value not split over ``mp`` (or a
    size of 1) is returned as it is."""
    dim = mp_dim(axes)
    if dim is None or size == 1:
        return value
    n = value.shape[dim]
    if parts is not None and len(parts) > 1:
        perm = parts_permutation(parts, size)
        value = (np.take(value, perm, axis=dim)
                 if isinstance(value, np.ndarray) else
                 value.index_select(dim, torch.as_tensor(
                     perm, device=value.device)))
    k = n // size
    sl = [slice(None)] * value.ndim
    sl[dim] = slice(rank * k, (rank + 1) * k)
    return value[tuple(sl)]


def whole_of(blocks, axes, parts):
    """The inverse of :func:`block_of`: every rank's block (in rank order)
    back into the whole value in the JAX layout."""
    dim = mp_dim(axes)
    if dim is None or len(blocks) == 1:
        return blocks[0]
    is_np = isinstance(blocks[0], np.ndarray)
    cat = np.concatenate(blocks, axis=dim) if is_np else \
        torch.cat(list(blocks), dim=dim)
    if parts is None or len(parts) == 1:
        return cat
    inv = np.argsort(parts_permutation(parts, len(blocks)))
    return np.take(cat, inv, axis=dim) if is_np else \
        cat.index_select(dim, torch.as_tensor(inv, device=cat.device))


def param_spec(p):
    """(``mesh_axes``, ``mp_parts``) of a parameter (a torch Parameter or
    a port Parameter)."""
    return getattr(p, "mesh_axes", None), getattr(p, "mp_parts", None)


def annotate(p, axes, parts=None):
    """Give parameter ``p`` its JAX ``mesh_axes`` (and packed parts)."""
    p.mesh_axes = tuple(axes)
    if parts is not None:
        p.mp_parts = tuple(int(n) for n in parts)
    return p


def rank_state(state, specs, rank, size):
    """{name: rank's block} of a whole ``state`` ({name: numpy}, the JAX
    model's state dict) under ``specs`` ({name: (axes, parts)})."""
    return {k: block_of(np.asarray(v), *specs.get(k, (None, None)), rank,
                        size) for k, v in state.items()}


def model_specs(model):
    """{name: (mesh_axes, mp_parts)} of a model's parameters."""
    return {n: param_spec(p) for n, p in model.named_parameters()}


# --------------------------------------------------- a sliced model --
class MPContext:
    """What a model sliced over an mp group holds: the group, whether it
    runs sequence parallelism (activations between the column- and
    row-parallel layers sharded on dim 1), and the generator of its
    rank-local dropout (module docstring)."""

    def __init__(self, group, sequence_parallel=False, generator=None):
        self.group = group
        self.rank = max(group.rank, 0)
        self.size = group.nranks
        self.sequence_parallel = bool(sequence_parallel)
        self.generator = generator

    def column_in(self, x):
        """The input of a column-parallel layer: replicated (copy) or,
        under sequence parallelism, gathered from the sequence shards."""
        if self.sequence_parallel:
            return gather_from_seq(x, self.group, 1)
        return copy_to_mp(x, self.group)

    def row_out(self, x):
        """The partial output of a row-parallel layer, summed over the
        ranks (reduce-scattered over the sequence under SP)."""
        if self.sequence_parallel:
            return reduce_scatter_to_seq(x, self.group, 1)
        return reduce_from_mp(x, self.group)

    def seq_chunk(self, n):
        """This rank's slice of a sequence of ``n`` under SP (all of it
        otherwise)."""
        if not self.sequence_parallel:
            return slice(0, n)
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def local_generator(device, seed, rank):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + MP_RNG_OFFSET + int(rank))
    return g


def mp_of(module):
    """The :class:`MPContext` a sliced module holds, or None."""
    return module.__dict__.get("_mp")


def vocab_parallel_embedding(ids, weight, mp):
    """Rows of the rank's vocab block ``weight`` [V/mp, h] at ``ids``
    (global ids), zeros for ids outside it, summed over the ranks
    (reduce-scattered over the sequence under SP); the dense lookup
    when ``mp`` is None (a model that is not sliced)."""
    if mp is None:
        return F.embedding(ids, weight)
    n = weight.shape[0]
    start = mp.rank * n
    outside = (ids < start) | (ids >= start + n)
    local = torch.where(outside, torch.zeros_like(ids), ids - start)
    out = torch.nn.functional.embedding(local, weight)
    out = out.masked_fill(outside[..., None], 0.0)
    return mp.row_out(out)


class _VocabParallelXent(torch.autograd.Function):
    """Per-row softmax cross entropy over vocab-split logits [N, V/mp]
    (f32), labels [N] global ids (rows to ignore carry any id: the
    caller masks them)."""

    @staticmethod
    def forward(ctx, logits, labels, g):
        x = logits.float()
        n = x.shape[-1]
        start = max(g.rank, 0) * n if g is not None else 0
        mx = all_reduce(x.max(dim=-1).values, g, "max")
        shifted = x - mx[:, None]
        e = shifted.exp()
        total = all_reduce(e.sum(dim=-1), g)
        inside = (labels >= start) & (labels < start + n)
        local = torch.where(inside, labels - start, torch.zeros_like(labels))
        picked = shifted.gather(1, local[:, None])[:, 0]
        target = all_reduce(torch.where(inside, picked,
                                        torch.zeros_like(picked)), g)
        ctx.save_for_backward(e, total, local, inside)
        ctx.dtype = logits.dtype
        return total.log() - target

    @staticmethod
    def backward(ctx, dloss):
        e, total, local, inside = ctx.saved_tensors
        grad = e / total[:, None]
        grad.scatter_add_(1, local[:, None],
                          -inside.to(grad.dtype)[:, None])
        return (grad * dloss[:, None]).to(ctx.dtype), None, None


def parallel_cross_entropy(logits, labels, group, ignore_index=-100,
                           reduction="mean"):
    """Cross entropy of vocab-split ``logits`` [..., V/mp] against global
    ``labels`` [...] over the mp ``group``: ``reduction`` "mean" divides by
    the rows whose label is not ``ignore_index`` (at least 1), as the
    port's ``F.cross_entropy``, which a ``group`` of None runs."""
    if group is None:
        return F.cross_entropy(logits, labels, ignore_index=ignore_index,
                               reduction=reduction)
    v = logits.shape[-1]
    flat = logits.reshape(-1, v)
    lbl = labels.reshape(-1).long()
    valid = lbl != ignore_index
    loss = _VocabParallelXent.apply(flat, torch.where(valid, lbl, 0), group)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().float().clamp(min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(labels.shape)


# --------------------------------------- the Paddle-API layers (Layer) --
def _data(x):
    return x._data if isinstance(x, Tensor) else x


def _like(x, out):
    return _wrap(out) if isinstance(x, Tensor) else out


class _ParallelLayer(Layer):
    def _group(self):
        mp = mp_of(self)
        return None if mp is None else mp.group


class ColumnParallelLinear(_ParallelLayer):
    """W sharded on the output (column) dim over 'mp' (reference
    mp_layers.py:173): the input is copied to the ranks, each computes
    its columns, ``gather_output`` concatenates them."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.mesh_axes = (None, "mp")
        if has_bias:
            self.bias = self.create_parameter((out_features,), attr=None,
                                              is_bias=True)
            self.bias.mesh_axes = ("mp",)
        else:
            self.bias = None

    def forward(self, x):
        g = self._group()
        if _size(g) == 1:
            return F.linear(x, self.weight, self.bias)
        out = torch.nn.functional.linear(
            copy_to_mp(_data(x), g), _data(self.weight).T,
            None if self.bias is None else _data(self.bias))
        if self.gather_output:
            out = gather_from_mp(out, g)
        return _like(x, out)


class RowParallelLinear(_ParallelLayer):
    """W sharded on the input (row) dim over 'mp'; the partial products
    are summed over the ranks, then the bias added (reference
    mp_layers.py:343)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=XavierUniform())
        self.weight.mesh_axes = ("mp", None)
        if has_bias:
            self.bias = self.create_parameter((out_features,), attr=None,
                                              is_bias=True)
            self.bias.mesh_axes = (None,)
        else:
            self.bias = None

    def forward(self, x):
        g = self._group()
        if _size(g) == 1:
            return F.linear(x, self.weight, self.bias)
        data = _data(x)
        if not self.input_is_parallel:
            data = scatter_to_mp(data, g)
        out = reduce_from_mp(torch.matmul(data, _data(self.weight)), g)
        if self.bias is not None:
            out = out + _data(self.bias)
        return _like(x, out)


class VocabParallelEmbedding(_ParallelLayer):
    """Embedding table sharded on the vocab dim (reference
    mp_layers.py:35): each rank looks up the ids of its block, zeros
    elsewhere, and the ranks' rows are summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=Normal(0.0, 0.02))
        self.weight.mesh_axes = ("mp", None)

    def forward(self, x):
        mp = mp_of(self)
        if mp is None or mp.size == 1:
            return F.embedding(x, self.weight)
        return _like(x, vocab_parallel_embedding(_data(x).long(),
                                                 _data(self.weight), mp))


class ParallelCrossEntropy(_ParallelLayer):
    """Vocab-split softmax CE (reference mp_layers.py:524 →
    c_softmax_with_cross_entropy): per-row losses (reduction none) of
    the rank's vocab block of the logits against global labels."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        g = self._group()
        if _size(g) == 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        return _like(input, parallel_cross_entropy(
            _data(input), _data(label), g, self.ignore_index, "none"))
