"""FX pattern-rewrite passes over the traced program (port of
``paddle_tpu/framework/ir.py``).

Reference role: the inference/graph IR pass zoo
(paddle/fluid/framework/ir/*_fuse_pass.cc — e.g.
multihead_matmul_fuse_pass recognizes unfused attention subgraphs and
swaps in the fused kernel).  The JAX package matches jaxprs and replays
them with the matched subgraphs replaced; the port matches the aten
graph that ``jit.to_static`` traces (``make_fx(..., pre_dispatch=True)``
over fake tensors: ``aten.matmul``, ``aten.einsum``, ``aten.softmax``,
``aten.where`` ... as the port's ``paddle.matmul``, ``torch.einsum`` and
``F.softmax`` trace) and returns a new ``GraphModule`` with each matched
subgraph replaced by one call.  The passes and their declines are the
JAX ones:

- ``fuse_attention``: ``softmax(mask(scale(q @ k^T))) @ v`` in the 2-D
  and the batched-heads ``[B, N, T, D]`` layouts -> the port's
  ``ops/attention.py::flash_attention`` (the counterpart of
  ``paddle_tpu.ops.pallas.flash_attention``): a proven causal tril
  takes ``is_causal=True`` (B2/B3 on the card), a runtime or other
  mask takes ``attn_mask=`` (the plain route, as in JAX).
- ``decode_attention``: the one-token masked decode over dense caches
  -> ``incubate.nn.functional.ragged_decode_attention`` (B6 on the
  card).
- ``fuse_layernorm``: ``(x - mean) * rsqrt(var + eps) * w + b`` over
  the last axis -> the port's ``nn.functional.layer_norm`` with f32
  statistics and the output in x's dtype (B4a/B4b on the card, whose
  statistics are f32).  The JAX replacement is a composition that XLA
  fuses; here the fusion is the hand-written kernel.
- ``chunk_cross_entropy``: ``gather(log_softmax(logits), labels)`` ->
  the chunked softmax cross entropy (a torch composition, as the JAX
  one is a ``lax.map``).

The matchers look through what the JAX ones look through: dtype
conversions (``to``, ``_to_copy``, ``type_as``), ``clone``,
``contiguous``, ``detach`` and ``view``/``reshape``/``expand``/
``unsqueeze``/``squeeze`` that only add or drop size-1 dims (the JAX
trivial ``broadcast_in_dim``).

    fast = ir.optimize(naive_attention_fn)      # all registered passes
    fast(q, k, v)                               # flash kernel inside
"""

import functools
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.fx as fx
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

aten = torch.ops.aten

PASSES = OrderedDict()


def register_pass(name):
    def deco(fn):
        PASSES[name] = fn
        return fn

    return deco


class Rewrite:
    """One planned substitution: the nodes it consumes, the call that
    replaces them (``target(*args)``) and the node whose value the call
    gives (the pattern's last node, its anchor)."""

    def __init__(self, consumed, target, args, out_node):
        self.consumed = frozenset(consumed)
        self.target = target
        self.args = tuple(args)
        self.out_node = out_node


# ------------------------------------------------------------- matching ----

_CONVERTS = {aten.to.dtype, aten.to.dtype_layout, aten.to.device,
             aten._to_copy.default, aten.type_as.default,
             aten.clone.default, aten.contiguous.default,
             aten.detach.default, aten.detach_.default,
             aten.alias.default, aten.lift_fresh_copy.default}
_RESHAPES = {aten.view.default, aten.reshape.default,
             aten._unsafe_view.default, aten.expand.default,
             aten.unsqueeze.default, aten.squeeze.dim,
             aten.squeeze.default, aten.squeeze.dims, aten.slice.Tensor}
_SOFTMAX = {aten.softmax.int, aten._softmax.default}
_MUL = {aten.mul.Tensor, aten.mul.Scalar, aten.multiply.Tensor}
_DIV = {aten.div.Tensor, aten.div.Scalar, aten.divide.Tensor,
        aten.true_divide.Tensor, aten.true_divide.Scalar}
_ADD = {aten.add.Tensor, aten.add.Scalar}
_SUB = {aten.sub.Tensor, aten.subtract.Tensor}
_TRANSPOSE_2D = {aten.t.default, aten.numpy_T.default}


def _is_node(x):
    return isinstance(x, fx.Node)


def _val(n):
    return n.meta.get("val") if _is_node(n) else None


def _shape(n):
    v = _val(n)
    if isinstance(v, torch.Tensor):
        return tuple(int(d) for d in v.shape)
    return ()


def _dtype(n):
    v = _val(n)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _call(n, targets):
    return _is_node(n) and n.op == "call_function" and n.target in targets


def _squeezed(shape):
    return tuple(d for d in shape if d != 1)


def _unwrap(n):
    """Walk through shape/type-preserving wrappers back to the math;
    returns (node, wrappers walked)."""
    seen = []
    while _is_node(n) and n.op == "call_function":
        if n.target in _CONVERTS:
            seen.append(n)
            n = n.args[0]
        elif n.target in _RESHAPES and _is_node(n.args[0]) and \
                _squeezed(_shape(n.args[0])) == _squeezed(_shape(n)):
            # only size-1 plumbing is transparent; a real size change
            # or a reshape of non-unit dims is math
            seen.append(n)
            n = n.args[0]
        else:
            break
    return n, seen


def _last_axis(dim, nd):
    return dim in (-1, nd - 1)


def _match_softmax(p):
    """``p = softmax(src, dim=-1)``; returns (src, consumed) or None."""
    if not _call(p, _SOFTMAX):
        return None
    if not _last_axis(p.args[1], len(_shape(p.args[0]))):
        return None
    return p.args[0], {p}


def _scalar_value(n, gm):
    """The value of a constant scalar operand: a Python number, or a
    one-element constant tensor (``torch.tensor(c)``, ``full``) behind
    conversions and size-1 plumbing; None if not constant."""
    if isinstance(n, (int, float)):
        return float(n)
    n, _ = _unwrap(n)
    if not _is_node(n):
        return float(n) if isinstance(n, (int, float)) else None
    if n.op == "get_attr":
        t = getattr(gm, n.target, None)
        return float(t.reshape(())) if isinstance(
            t, torch.Tensor) and t.numel() == 1 else None
    if _call(n, {aten.full.default}) and not _shape(n):
        return float(n.args[1])
    if _call(n, {aten.scalar_tensor.default}):
        return float(n.args[0])
    return None


def _neg_fill(n, gm, threshold=-1e8):
    """A scalar <= threshold: an 'effectively -inf' softmax fill.  The
    threshold admits the bf16 rounding of the common -1e9 spelling."""
    v = _scalar_value(n, gm)
    return v is not None and v <= threshold


def _match_where_mask(n, gm, threshold=-1e8):
    """``n = where(pred, scores, fill)`` with a boolean pred and a
    large-negative scalar fill; returns (pred, scores, fill node) or
    None.  The where must not upsize the scores operand."""
    if not _call(n, {aten.where.self, aten.where.ScalarOther}):
        return None
    pred, scores, fill = n.args[:3]
    if _dtype(pred) != torch.bool or not _is_node(scores):
        return None
    if not _neg_fill(fill, gm, threshold):
        return None
    if _shape(n) != _shape(scores):
        return None
    return pred, scores


def _const_eval(node, gm, max_elems=1 << 26, max_nodes=64):
    """Numerically evaluate ``node`` if it depends only on constants and
    calls — no graph input.  Returns a numpy array or None.  Used to
    prove mask structure (a causal tril) at match time; evaluation is
    eager and bounded, every intermediate too."""
    order, seen, stack = [], set(), [node]
    while stack:
        n = stack.pop()
        if not _is_node(n) or n in seen:
            continue
        seen.add(n)
        if n.op == "placeholder":
            return None
        if n.op not in ("get_attr", "call_function"):
            return None
        if _shape(n) and int(np.prod(_shape(n))) > max_elems:
            return None
        order.append(n)
        if len(order) > max_nodes:
            return None
        stack.extend(n.all_input_nodes)
    env = {}
    try:
        for n in sorted(order, key=_index_of(gm)):
            if n.op == "get_attr":
                env[n] = getattr(gm, n.target)
                continue
            args = fx.node.map_arg(n.args, lambda a: env[a])
            kwargs = fx.node.map_arg(n.kwargs, lambda a: env[a])
            env[n] = n.target(*args, **kwargs)
        out = env[node]
        return out.detach().cpu().numpy() if isinstance(
            out, torch.Tensor) else np.asarray(out)
    except Exception:
        return None


def _index_of(gm):
    idx = {n: i for i, n in enumerate(gm.graph.nodes)}
    return idx.__getitem__


def _match_scaled_dot(n, dot_match):
    """An optional scalar ``* c`` / ``/ c`` around a dot that
    ``dot_match`` accepts; returns (dot, mode, scale, consumed) or
    None.  The scale must be a scalar (a number or a 0-d tensor): a
    shaped operand here is a mask or a bias, not a scale."""
    if dot_match(n) is not None:
        return n, None, None, set()
    for mode, ops in (("div", _DIV), ("mul", _MUL)):
        if not _call(n, ops):
            continue
        cand, sk = _unwrap(n.args[0])
        scale = n.args[1]
        if dot_match(cand) is not None and (
                isinstance(scale, (int, float)) or
                (_is_node(scale) and not _shape(scale))):
            return cand, mode, scale, {n} | set(sk)
    return None


def _eq_matches(eq, template):
    """Whether the einsum equation ``eq`` is ``template`` up to a
    renaming of its letters."""
    eq = eq.replace(" ", "")
    if "..." in eq or len(eq) != len(template):
        return False
    fwd, back = {}, {}
    for a, b in zip(eq, template):
        if (a in ",->") != (b in ",->"):
            return False
        if a in ",->":
            if a != b:
                return False
            continue
        if fwd.setdefault(a, b) != b or back.setdefault(b, a) != a:
            return False
    return True


def _einsum(n, template):
    """``(a, b)`` of ``n = einsum(template, a, b)``, or None."""
    if not _call(n, {aten.einsum.default}):
        return None
    eq, ops = n.args[0], n.args[1]
    if len(ops) != 2 or not _eq_matches(eq, template):
        return None
    return ops[0], ops[1]


def _transposed_last_two(n):
    """``k`` if ``n`` is k with its last two dims swapped (``transpose``,
    ``.T`` of a matrix, or the matching ``permute``); returns (k, node)
    or None."""
    if not _is_node(n) or n.op != "call_function":
        return None
    nd = len(_shape(n))
    if n.target == aten.transpose.int:
        dims = sorted(d % nd for d in n.args[1:3])
        if dims == [nd - 2, nd - 1]:
            return n.args[0], n
    elif n.target == aten.permute.default:
        perm = [d % nd for d in n.args[1]]
        if perm == list(range(nd - 2)) + [nd - 1, nd - 2]:
            return n.args[0], n
    elif n.target in _TRANSPOSE_2D and nd == 2:
        return n.args[0], n
    return None


def _scores_dot(n):
    """The attention score product ``q @ k^T``: (layout, q, k, consumed)
    for the 2-D layout (q [T, D], k [S, D]) or the batched heads
    [B, N, T, D], else None."""
    if _call(n, {aten.matmul.default}):
        q, kt = n.args
        tr = _transposed_last_two(kt)
        if tr is None:
            return None
        k, tr_node = tr
        nd = len(_shape(q))
        if nd == 2 and len(_shape(k)) == 2:
            return "2d", q, k, {tr_node}
        if nd == 4 and len(_shape(k)) == 4 and \
                _shape(q)[:2] == _shape(k)[:2]:
            return "bhtd", q, k, {tr_node}
        return None
    for layout, tmpl in (("2d", "td,sd->ts"), ("bhtd", "bntd,bnsd->bnts")):
        ops = _einsum(n, tmpl)
        if ops is not None:
            return layout, ops[0], ops[1], set()
    return None


def _final_dot(n, layout):
    """The context product ``p @ v`` of ``layout``: (p, v) or None."""
    if _call(n, {aten.matmul.default}):
        p, v = n.args
        nd = 2 if layout == "2d" else 4
        if len(_shape(p)) == nd and len(_shape(v)) == nd:
            return p, v
        return None
    return _einsum(n, "ts,sd->td" if layout == "2d" else
                   "bnts,bnsd->bntd")


def _interior_ok(consumed, anchor):
    """True iff nothing outside ``consumed`` (the graph's output
    included) reads a node inside the pattern other than the anchor."""
    return all(u in consumed for c in consumed if c is not anchor
               for u in c.users)


# ---------------------------------------------------------- replacements --

def _scale_of(mode, scale):
    if mode == "div":
        return 1.0 / scale
    if mode == "mul":
        return scale
    return 1.0


def attention_apply(q, k, v, mask, layout, mode, scale, head_dim, causal):
    """``fuse_attention``'s replacement: the matched scale folded into q
    (the kernel's own 1/sqrt(D) then yields the user's scaling), then
    ``ops/attention.py::flash_attention`` in its [B, T, N, D] layout."""
    from ..ops.attention import flash_attention

    q = q * (_scale_of(mode, scale) * math.sqrt(head_dim))
    kw = {}
    if causal:
        kw["is_causal"] = True
    elif mask is not None:
        kw["attn_mask"] = mask
    if layout == "2d":
        out = flash_attention(q[None, :, None, :], k[None, :, None, :],
                              v[None, :, None, :], **kw)
        return out[0, :, 0, :]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def decode_apply(q, k, v, pred, mode, scale, head_dim, out_dtype):
    """``decode_attention``'s replacement: q [B, 1, N, D] over dense
    caches [B, S, Nkv, D] with the prefix mask ``pred`` (proven at match
    time) measured into per-sequence lengths, through
    ``ragged_decode_attention`` (B6 on the card)."""
    from ..incubate.nn.functional import ragged_decode_attention

    q = q * (_scale_of(mode, scale) * math.sqrt(head_dim))
    b = k.shape[0]
    lsum = pred.sum(-1).to(torch.int32)
    if pred.dim() == 4 and pred.shape[0] == b:
        lengths = lsum.reshape(b)
    else:
        lengths = lsum.reshape(-1)[0].expand(b)
    # one element type for the kernel: the caches in q's
    k, v = k.to(q.dtype), v.to(q.dtype)
    out = ragged_decode_attention(q[:, 0].contiguous(), k.contiguous(),
                                  v.contiguous(), lengths.contiguous())
    return out.to(out_dtype)[:, None]


def layernorm_apply(x, w, b, eps):
    """``fuse_layernorm``'s replacement: the port's ``nn.functional.
    layer_norm`` with f32 statistics, output in x's dtype.  On the card
    a width the kernels take runs B4a/B4b in x's dtype (their statistics
    are f32); elsewhere the composition runs on f32 values."""
    from ..nn.functional import layer_norm
    from ..ops.cuda.layernorm_kernel import _DTYPES, takes_channels

    c = x.shape[-1]
    if x.is_cuda and x.dtype in _DTYPES and takes_channels(c):
        return layer_norm(x, [c], w.to(x.dtype), b.to(x.dtype), eps)
    return layer_norm(x.float(), [c], w.float(), b.float(),
                      eps).to(x.dtype)


def xent_apply(logits, labels, out_dtype):
    """``chunk_cross_entropy``'s replacement: the picked log-probability
    ``-loss`` of the chunked softmax cross entropy, [N, 1]."""
    from ..nn.functional import _ChunkedSoftmaxXent

    loss = _ChunkedSoftmaxXent.apply(logits, labels.reshape(-1).long())
    return (-loss).to(out_dtype)[:, None]


# ---------------------------------------------------------------- passes --

@register_pass("fuse_attention")
def fuse_attention(gm):
    """Find softmax(mask(scale(q @ k^T))) @ v chains; plan flash swaps.

    Matches the 2-D single-head layout (q [T, D], k [S, D], v [S, D])
    and the batched-heads layout (q [B, N, T, D] against k
    [B, N, S, D]), as ``paddle.matmul(q, k.transpose)`` or
    ``torch.einsum`` trace them.  The score scaling may be ``/ c`` or
    ``* c`` by a scalar, or absent.  An optional mask between the
    scaled dot and the softmax is matched in both spellings:

    - ``where(pred, scores, -big)``  (boolean mask, fill <= -1e8)
    - ``scores + bias``              (additive mask)

    A compile-time constant mask is evaluated at match time; a proven
    causal tril (T == S) routes to ``is_causal=True``.  Any other
    broadcast-compatible mask goes to ``flash_attention(attn_mask=)``.
    Masks that upsize the scores or do not right-align decline.
    """
    rewrites = []
    for n in gm.graph.nodes:
        for layout in ("2d", "bhtd"):
            fd = _final_dot(n, layout)
            if fd is None:
                continue
            p_node, v = fd
            p_src, skip_a = _unwrap(p_node)
            sm = _match_softmax(p_src)
            if sm is None:
                continue
            scores, sm_consumed = sm
            scores, sk_s = _unwrap(scores)
            sm_consumed = sm_consumed | set(sk_s)
            dot_match = lambda d, _l=layout: (  # noqa: E731
                _scores_dot(d) if _scores_dot(d) is not None and
                _scores_dot(d)[0] == _l else None)
            mask, mask_bool, mask_consumed, sd = None, False, set(), None
            wh = _match_where_mask(scores, gm)
            if wh is not None:
                pred, inner_raw = wh
                inner, sk_m = _unwrap(inner_raw)
                sd = _match_scaled_dot(inner, dot_match)
                if sd is None:
                    continue
                mask, mask_bool = pred, True
                mask_consumed = {scores} | set(sk_m)
            elif _call(scores, _ADD):
                for a, b in ((0, 1), (1, 0)):
                    inner, sk_m = _unwrap(scores.args[a])
                    sd_try = _match_scaled_dot(inner, dot_match)
                    if sd_try is not None and _is_node(scores.args[b]):
                        sd, mask = sd_try, scores.args[b]
                        mask_consumed = {scores} | set(sk_m)
                        break
                if sd is None:
                    continue
            else:
                sd = _match_scaled_dot(scores, dot_match)
                if sd is None:
                    continue
            dot, mode, scale, sd_consumed = sd
            _, q, k, dot_consumed = _scores_dot(dot)
            if len(_shape(v)) != len(_shape(q)) or \
                    _shape(v)[-2] != _shape(k)[-2]:
                continue
            # the mask must right-align with the [.., T, S] scores under
            # broadcasting; a constant causal tril takes is_causal
            causal = False
            if mask is not None:
                score_shape = _shape(dot)
                mshape = _shape(mask)
                if len(mshape) > len(score_shape) or any(
                        md != 1 and md != sd_ for md, sd_ in
                        zip(reversed(mshape), reversed(score_shape))):
                    continue
                t_dim, s_dim = score_shape[-2:]
                mval = _const_eval(mask, gm) if t_dim == s_dim else None
                if mval is not None:
                    mval = np.broadcast_to(mval, mval.shape[:-2] + (
                        t_dim, s_dim)).reshape(-1, t_dim, s_dim)
                    tril = np.tril(np.ones((t_dim, s_dim), bool))
                    if mask_bool:
                        causal = bool(np.all((mval != 0) == tril))
                    else:
                        causal = bool(np.all(np.where(
                            tril, mval == 0, mval <= -1e8)))
            consumed = {n, dot} | sm_consumed | sd_consumed | \
                mask_consumed | dot_consumed | set(skip_a)
            if not _interior_ok(consumed, n):
                continue
            rewrites.append(Rewrite(
                consumed, attention_apply,
                (q, k, v, None if (causal or mask is None) else mask,
                 layout, mode, scale, _shape(q)[-1], causal), n))
            break
    return rewrites


@register_pass("decode_attention")
def decode_attention(gm):
    """Single-token masked decode attention -> the dense decode kernel.

    Matches the KV-cache decode chain FusedMultiTransformer's
    composition writes at T=1:

        logits = einsum('bqnd,bknd->bnqk', q, cache_k) * scale
        logits = where(arange_S <= pos, logits, -big)    # prefix mask
        att    = softmax(logits, dim=-1)
        out    = einsum('bnqk,bknd->bqnd', att, cache_v)

    and swaps in ``ragged_decode_attention``, which reads only
    ``lengths`` cache rows per head instead of S_max.  The prefix mask
    is proven at match time (``le``/``lt`` of an ``arange`` over the
    score axis against a comparand constant along it, uniform across
    heads), then measured at run time (lengths = per-row count).
    """
    rewrites = []
    for n in gm.graph.nodes:
        fd = _einsum(n, "bnqk,bknd->bqnd")
        if fd is None:
            continue
        att_raw, v_raw = fd
        p_src, skip_a = _unwrap(att_raw)
        sm = _match_softmax(p_src)
        if sm is None:
            continue
        masked, sm_consumed = sm
        masked, sk_s = _unwrap(masked)
        sm_consumed = sm_consumed | set(sk_s)
        wh = _match_where_mask(masked, gm, threshold=-1e20)
        if wh is None:
            continue
        pred, scores_raw = wh
        s_max = _shape(masked)[-1]
        # pred must be a PREFIX mask over the score axis, uniform across
        # heads: its last dim is S and every other dim is 1, or only the
        # leading (batch) dim is > 1; the arange side varies only along
        # the last axis; the comparand is constant along it
        ps = _shape(pred)
        if not ps or ps[-1] != s_max:
            continue
        if not (all(d == 1 for d in ps[:-1]) or
                (len(ps) == 4 and all(d == 1 for d in ps[1:-1]))):
            continue
        cmp, _ = _unwrap(pred)
        if not _call(cmp, {aten.le.Tensor, aten.lt.Tensor, aten.le.Scalar,
                           aten.lt.Scalar}):
            continue
        lhs, rhs = cmp.args[:2]
        lhs_shape = _shape(lhs)
        if not lhs_shape or lhs_shape[-1] != s_max or \
                any(d != 1 for d in lhs_shape[:-1]):
            continue
        rhs_shape = _shape(rhs)
        if rhs_shape and rhs_shape[-1] != 1:
            continue
        iota, _ = _unwrap(lhs)
        if not _call(iota, {aten.arange.default, aten.arange.start,
                            aten.arange.start_step}):
            continue
        scores, skip_i = _unwrap(scores_raw)
        sd = _match_scaled_dot(scores, lambda d: _einsum(
            d, "bqnd,bknd->bnqk"))
        if sd is None:
            continue
        dot, mode, scale, sd_consumed = sd
        q, k_raw = _einsum(dot, "bqnd,bknd->bnqk")
        if len(_shape(q)) != 4 or _shape(q)[1] != 1:
            continue        # decode only: a single query token
        k, skip_k = _unwrap(k_raw)
        v, skip_l = _unwrap(v_raw)
        consumed = {n, masked, dot} | sm_consumed | sd_consumed
        consumed.update(skip_a + skip_i + skip_k + skip_l)
        if not _interior_ok(consumed, n):
            continue
        rewrites.append(Rewrite(
            consumed, decode_apply,
            (q, k, v, pred, mode, scale, _shape(q)[-1], _dtype(n)), n))
    return rewrites


def _mean_of(n):
    """``mean(src, dim=-1, keepdim)`` behind trivial wrappers; returns
    (src, consumed) or None.  A ddof-1 variance or any other scaling is
    a different function and does not match."""
    m, sk = _unwrap(n)
    if not _call(m, {aten.mean.dim}):
        return None
    dims = m.args[1]
    nd = len(_shape(m.args[0]))
    if dims is None or len(dims) != 1 or not _last_axis(dims[0], nd):
        return None
    src, sk2 = _unwrap(m.args[0])
    return src, {m} | set(sk) | set(sk2)


def _vec_1d(n):
    """A 1-D vector over the last axis (through trivial wrappers)."""
    if not _is_node(n):
        return None, []
    v, sk = _unwrap(n)
    if _is_node(v) and len(_shape(v)) == 1:
        return v, sk
    return None, []


@register_pass("fuse_layernorm")
def fuse_layernorm(gm):
    """Hand-written layernorm -> one fused normalization in f32.

    Matches ``(x - mean(x)) * rsqrt(mean((x - mean(x)) ** 2) + eps) * w
    + b`` (reductions over the last axis, w and b vectors over it) and
    replaces the chain with :func:`layernorm_apply`, whose statistics
    run in float32 — for bf16 activations a numerics upgrade the
    unfused bf16 chain does not have.  RMS norm (no centering), a
    reused mean and a ddof-1 variance decline.
    """
    rewrites = []
    for n in gm.graph.nodes:
        if not _call(n, _ADD) or len(n.args) < 2:
            continue
        b_vec, skb = _vec_1d(n.args[1])
        if b_vec is None:
            continue
        core, sk0 = _unwrap(n.args[0])
        if not _call(core, _MUL):
            continue
        w_vec, skw = _vec_1d(core.args[1])
        if w_vec is None:
            continue
        norm, sk1 = _unwrap(core.args[0])
        if not _call(norm, _MUL):
            continue
        sub, sk2 = _unwrap(norm.args[0])
        rs, sk3 = _unwrap(norm.args[1])
        if not _call(sub, _SUB) or not _call(rs, {aten.rsqrt.default}):
            continue
        x, skx = _unwrap(sub.args[0])
        mean = _mean_of(sub.args[1])
        if mean is None or mean[0] is not x:
            continue
        va, sk4 = _unwrap(rs.args[0])
        if not _call(va, _ADD) or not isinstance(va.args[1], (int, float)):
            continue
        eps = float(va.args[1])
        var_mean = _mean_of(va.args[0])
        if var_mean is None:
            continue
        sq, sk5 = _unwrap(var_mean[0])
        if not _call(sq, {aten.pow.Tensor_Scalar}) or sq.args[1] != 2:
            continue
        centered, sk6 = _unwrap(sq.args[0])
        if not _call(centered, _SUB):
            continue
        x2, skx2 = _unwrap(centered.args[0])
        if x2 is not x:
            continue
        mean2 = _mean_of(centered.args[1])
        if mean2 is None or mean2[0] is not x:
            continue
        c = _shape(x)[-1] if _shape(x) else None
        if _shape(w_vec) != (c,) or _shape(b_vec) != (c,):
            continue
        consumed = {n, core, norm, sub, rs, va, sq, centered}
        consumed |= mean[1] | var_mean[1] | mean2[1]
        consumed.update(skb + sk0 + skw + sk1 + sk2 + sk3 + sk4 + sk5 +
                        sk6 + skx + skx2)
        if not _interior_ok(consumed, n):
            continue
        rewrites.append(Rewrite(consumed, layernorm_apply,
                                (x, w_vec, b_vec, eps), n))
    return rewrites


@register_pass("chunk_cross_entropy")
def chunk_cross_entropy(gm):
    """log_softmax + gather -> chunked softmax-xent.

    The naive spelling materializes the full [N, V] log-probability
    matrix; the rewrite swaps in the chunked softmax cross entropy,
    keeping only a chunk's rows in f32 at a time.  Matches
    ``gather(log_softmax(logits, -1), 1, labels[:, None])`` and
    ``take_along_dim`` over 2-D logits with [N, 1] integer labels,
    picking along the class axis.
    """
    rewrites = []
    for n in gm.graph.nodes:
        if _call(n, {aten.gather.default}):
            lp_raw, dim, idx = n.args[:3]
        elif _call(n, {aten.take_along_dim.default}):
            lp_raw, idx = n.args[:2]
            dim = n.args[2] if len(n.args) > 2 else n.kwargs.get("dim")
        else:
            continue
        lp, sk0 = _unwrap(lp_raw)
        if not _call(lp, {aten.log_softmax.int, aten._log_softmax.default}):
            continue
        logits = lp.args[0]
        if len(_shape(logits)) != 2 or not _last_axis(lp.args[1], 2):
            continue
        if dim is None or not _last_axis(dim, 2):
            continue
        rows = _shape(logits)[0]
        if _dtype(idx) is None or _dtype(idx).is_floating_point or \
                _shape(idx) != (rows, 1) or _shape(n) != (rows, 1):
            continue
        lbl, sk1 = _unwrap(idx)
        if len(_shape(lbl)) not in (1, 2) or \
                int(np.prod(_shape(lbl))) != rows:
            continue
        consumed = {n, lp} | set(sk0) | set(sk1)
        if not _interior_ok(consumed, n):
            continue
        rewrites.append(Rewrite(consumed, xent_apply,
                                (logits, lbl, _dtype(n)), n))
    return rewrites


# -------------------------------------------------------------- rewrite ----

def rewrite(gm, passes=None):
    """``gm`` with the passes' matches replaced: a new ``GraphModule``
    over the same attributes, with ``rewrites`` (the total) and
    ``rewrites_by_pass`` in its ``meta``.  Overlapping matches go to the
    earlier pass, as in JAX."""
    names = list(PASSES) if passes is None else list(passes)
    plans, taken, by_pass = [], set(), {}
    for name in names:
        got = 0
        for rw in PASSES[name](gm):
            if not (rw.consumed & taken):
                plans.append(rw)
                taken |= rw.consumed
                got += 1
        by_pass[name] = got
    if not plans:
        gm.meta["rewrites"], gm.meta["rewrites_by_pass"] = 0, by_pass
        return gm
    by_anchor = {rw.out_node: rw for rw in plans}
    graph = fx.Graph()
    env = {}
    for n in gm.graph.nodes:
        rw = by_anchor.get(n)
        if rw is not None:
            args = fx.node.map_arg(rw.args, lambda a: env[a])
            env[n] = graph.call_function(rw.target, args)
            continue
        if n in taken:
            continue
        env[n] = graph.node_copy(n, lambda a: env[a])
    out = fx.GraphModule(gm, graph)
    out.graph.eliminate_dead_code()
    out.recompile()
    out.meta["rewrites"], out.meta["rewrites_by_pass"] = len(plans), by_pass
    return out


def optimize(fn, passes=None, static_argnums=()):
    """Return ``fn`` with the registered passes applied.

    ``fn`` takes torch tensors (and static arguments at
    ``static_argnums``).  The trace + pattern match is cached per input
    structure (shapes/dtypes/devices/treedef + static-arg values), so
    eager loops pay it once.  Functions where no pattern matches run
    unchanged.  The wrapper exposes ``last_rewrite_count``.
    """
    names = list(PASSES) if passes is None else list(passes)
    static = set(static_argnums)
    cache = {}

    @functools.wraps(fn)
    def wrapped(*args):
        dyn = [a for i, a in enumerate(args) if i not in static]
        leaves, in_tree = pytree.tree_flatten(tuple(dyn))
        t_pos = [i for i, x in enumerate(leaves)
                 if isinstance(x, torch.Tensor)]
        key = (in_tree, tuple(
            (tuple(x.shape), x.dtype, str(x.device))
            if isinstance(x, torch.Tensor) else x for x in leaves),
            tuple(args[i] for i in sorted(static)))
        entry = cache.get(key)
        if entry is None:
            found = {}

            def flat_fn(*tensors):
                new = list(leaves)
                for i, t in zip(t_pos, tensors):
                    new[i] = t
                d = iter(pytree.tree_unflatten(new, in_tree))
                full = [args[i] if i in static else next(d)
                        for i in range(len(args))]
                outs, found["tree"] = pytree.tree_flatten(fn(*full))
                return tuple(outs)

            # traced as ``jit.to_static`` traces
            gm = make_fx(flat_fn, tracing_mode="fake", pre_dispatch=True,
                         _allow_non_fake_inputs=True)(
                *[leaves[i] for i in t_pos])
            gm = rewrite(gm, names)
            entry = cache[key] = (gm, found["tree"])
        gm, out_tree = entry
        wrapped.last_rewrite_count = gm.meta["rewrites"]
        if not gm.meta["rewrites"]:
            return fn(*args)
        outs = gm(*[leaves[i] for i in t_pos])
        return pytree.tree_unflatten(list(outs), out_tree)

    wrapped.last_rewrite_count = 0
    return wrapped
