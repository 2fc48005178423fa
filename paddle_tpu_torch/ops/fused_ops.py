"""Fused ops: the attention/FFN fusions and the XPU-fused op set.

Port of ``paddle_tpu/ops/fused_ops.py``.  Each op is the JAX package's
composition; the attention core of ``flash_attn``,
``memory_efficient_attention`` and ``fused_attention`` goes through
``ops/attention.py::flash_attention``, which on CUDA tensors with no
mask, no dropout and the default scale launches the hand-written flash
kernels (B2 forward, B3 backward) and otherwise runs the plain
composition.  ``flash_attn_unpadded`` keeps the JAX design (segments
re-packed to a padded batch under a mask), so it always takes the plain
route.  The ``*_xpu`` names are the same compositions as in the JAX
package.  Dropout draws from the global generator of the tensor's
device, or from one seeded with ``seed`` under ``fix_seed``.
"""

import torch

from ..framework.random import generator
from .attention import flash_attention as _attention_impl
from .registry import op, raw

_tF = torch.nn.functional


def _ln(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * torch.as_tensor(scale, device=x.device).float()
    if bias is not None:
        out = out + torch.as_tensor(bias, device=x.device).float()
    return out.to(x.dtype)


def _gelu(v):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return _tF.gelu(v, approximate="tanh")


_ACTS = {"relu": torch.relu, "gelu": _gelu, "sigmoid": torch.sigmoid,
         "tanh": torch.tanh, "linear": lambda v: v}


@op()
def flash_attn(q, k, v, fixed_seed_offset=None, attn_mask=None,
               dropout=0.0, causal=False, return_softmax=False,
               is_test=True, rng_name=""):
    """FlashAttention layout: q/k/v [B, T, N, H] -> out [B, T, N, H]."""
    out = _attention_impl(q, k, v, attn_mask=attn_mask, is_causal=causal,
                          dropout_p=0.0 if is_test else dropout,
                          generator=generator(q.device))
    if return_softmax:
        return out, None
    return out


@op()
def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout=0.0, causal=False,
                        return_softmax=False, is_test=True):
    """Varlen attention: q [total_q, N, H] with cumulative seqlens; the
    segments are re-packed to a padded batch, attended under a mask and
    scattered back, as in the JAX op."""
    nq = cu_seqlens_q.shape[0] - 1
    tq, n, h = q.shape
    mq, mk = int(max_seqlen_q), int(max_seqlen_k)  # noqa: H001 (static seqlen attrs)

    def gather_pad(x, cu, m):
        ar = torch.arange(m, device=x.device)
        starts = cu[:nq].long()
        lens = cu[1:nq + 1].long() - starts
        idx = torch.clamp(starts[:, None] + ar[None, :], 0, x.shape[0] - 1)
        valid = ar[None, :] < lens[:, None]
        xi = x[idx]
        return torch.where(valid[:, :, None, None], xi,
                           torch.zeros_like(xi)), valid

    qp, qv = gather_pad(q, cu_seqlens_q, mq)
    kp, kv = gather_pad(k, cu_seqlens_k, mk)
    vp, _ = gather_pad(v, cu_seqlens_k, mk)
    mask = qv[:, :, None] & kv[:, None, :]
    out = _attention_impl(qp, kp, vp, attn_mask=mask[:, None, :, :],
                          is_causal=causal,
                          dropout_p=0.0 if is_test else dropout,
                          generator=generator(q.device), scale=scale)
    ar = torch.arange(mq, device=q.device)
    starts = cu_seqlens_q[:nq].long()
    lens = cu_seqlens_q[1:nq + 1].long() - starts
    idx = torch.clamp(starts[:, None] + ar[None, :], 0, tq - 1)
    valid = (ar[None, :] < lens[:, None])[:, :, None, None]
    upd = torch.where(valid, out, torch.zeros_like(out))
    res = torch.zeros((tq, n, h), dtype=out.dtype, device=q.device)
    res = res.index_add(0, idx.reshape(-1), upd.reshape(-1, n, h))
    if return_softmax:
        return res, None
    return res


@op()
def memory_efficient_attention(query, key, value, bias=None, cu_seqlens_q=None,
                               cu_seqlens_k=None, causal_diagonal=None,
                               seqlen_k=None, max_seqlen_q=None,
                               max_seqlen_k=None, causal=False, dropout_p=0.0,
                               scale=None, is_test=True):
    """The same flash route as ``flash_attn``."""
    return _attention_impl(query, key, value, attn_mask=bias,
                           is_causal=causal,
                           dropout_p=0.0 if is_test else dropout_p,
                           generator=generator(query.device), scale=scale)


@op()
def fused_attention(x, qkv_weight, qkv_bias, linear_weight, linear_bias,
                    ln_scale=None, ln_bias=None, ln2_scale=None,
                    ln2_bias=None, num_heads=1, pre_layer_norm=False,
                    epsilon=1e-5, epsilon2=None, attn_dropout_rate=0.0,
                    dropout_rate=0.0, is_test=True, attn_mask=None,
                    ring_id=-1):
    """[LN] -> QKV -> MHA -> out-proj -> residual [-> LN]; qkv_weight is
    [3, num_heads, head_dim, C].  The projections run in f32, as in the
    JAX op; the attention core takes the input dtype."""
    b, t, c = x.shape
    residual = x
    inp = _ln(x, ln_scale, ln_bias, epsilon) if pre_layer_norm else x
    qkv = torch.einsum("btc,khdc->btkhd", inp.float(), qkv_weight.float())
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.float()[None, None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    ctx = _attention_impl(q.to(x.dtype), k.to(x.dtype), v.to(x.dtype),
                          attn_mask=attn_mask,
                          dropout_p=0.0 if is_test else attn_dropout_rate,
                          generator=generator(x.device))
    out = ctx.reshape(b, t, c).float() @ linear_weight.float()
    if linear_bias is not None:
        out = out + linear_bias.float()
    out = residual.float() + out
    if not pre_layer_norm:
        out = _ln(out.to(x.dtype), ln2_scale, ln2_bias,
                  epsilon if epsilon2 is None else epsilon2).float()
    return out.to(x.dtype)


@op()
def fused_feedforward(x, linear1_weight, linear1_bias, linear2_weight,
                      linear2_bias, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, pre_layer_norm=False,
                      epsilon1=1e-5, epsilon2=1e-5, act_method="gelu",
                      dropout1_rate=0.0, dropout2_rate=0.0, is_test=True,
                      ring_id=-1):
    residual = x
    inp = _ln(x, ln1_scale, ln1_bias, epsilon1) if pre_layer_norm else x
    h = inp.float() @ linear1_weight.float()
    if linear1_bias is not None:
        h = h + linear1_bias.float()
    h = {"gelu": _gelu, "relu": torch.relu}[act_method](h)
    out = h @ linear2_weight.float()
    if linear2_bias is not None:
        out = out + linear2_bias.float()
    out = residual.float() + out
    if not pre_layer_norm:
        out = _ln(out.to(x.dtype), ln2_scale, ln2_bias, epsilon2).float()
    return out.to(x.dtype)


@op()
def fused_dropout_add(x, y, p=0.5, is_test=True, mode="upscale_in_train",
                      seed=0, fix_seed=False):
    if is_test or p == 0.0:
        return x + y
    if fix_seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    zero = torch.zeros_like(x)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero) + y
    return torch.where(keep, x, zero) + y


@op()
def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True):
    """Grad-accumulation fusion for linear layers (main-grad path)."""
    acc_t = torch.float32 if multi_precision else x.dtype
    dw = torch.einsum("...i,...o->io", x.to(acc_t), dout.to(acc_t))
    if dweight is not None:
        dw = dweight.to(acc_t) + dw
    if not has_bias:
        return dw, None
    db = dout.to(acc_t).reshape(-1, dout.shape[-1]).sum(0)
    if dbias is not None:
        db = dbias.to(acc_t) + db
    return dw, db


# ---------------------------------------------------------- xpu-fused set

@op()
def add_act_xpu(x, y, act_type="relu"):
    return _ACTS[act_type](x + y)


@op()
def fc_xpu(x, w, bias=None, act_type="linear"):
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return _ACTS[act_type](out).to(x.dtype)


@op()
def conv2d_xpu(x, filter, bias=None, scale_max=None, out_max_in=None,
               strides=(1, 1), paddings=(0, 0), dilations=(1, 1), groups=1,
               act_type="linear"):
    out = raw("conv2d")(x, filter, bias=None, stride=list(strides),
                        padding=list(paddings), dilation=list(dilations),
                        groups=groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return _ACTS[act_type](out)


@op()
def embedding_with_eltwise_add_xpu(ids_list, tables_list):
    out = None
    for ids, table in zip(ids_list, tables_list):
        e = table[ids.long()]
        out = e if out is None else out + e
    return out


@op()
def multi_encoder_xpu(x, qkv_weights, qkv_biases, out_weights, out_biases,
                      ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases,
                      ln1_scales, ln1_biases, ln2_scales, ln2_biases,
                      num_heads=1, attn_mask=None):
    """A stacked pre-LN transformer encoder, one composition."""
    h = x
    for i in range(len(qkv_weights)):
        h = fused_attention(
            h, qkv_weights[i], qkv_biases[i], out_weights[i], out_biases[i],
            ln_scale=ln1_scales[i], ln_bias=ln1_biases[i],
            num_heads=num_heads, pre_layer_norm=True, attn_mask=attn_mask)
        h = fused_feedforward(
            h, ffn1_weights[i], ffn1_biases[i], ffn2_weights[i],
            ffn2_biases[i], ln1_scale=ln2_scales[i], ln1_bias=ln2_biases[i],
            pre_layer_norm=True)
    return h


@op()
def fused_multi_transformer_xpu(x, qkv_weights, qkv_biases, out_weights,
                                out_biases, ffn1_weights, ffn1_biases,
                                ffn2_weights, ffn2_biases, ln_scales,
                                ln_biases, ffn_ln_scales, ffn_ln_biases,
                                num_heads=1, attn_mask=None):
    return multi_encoder_xpu(
        x, qkv_weights, qkv_biases, out_weights, out_biases, ffn1_weights,
        ffn1_biases, ffn2_weights, ffn2_biases, ln_scales, ln_biases,
        ffn_ln_scales, ffn_ln_biases, num_heads=num_heads,
        attn_mask=attn_mask)


@op()
def generate_sequence_xpu(x, axis=-1, dtype=None):
    from ..framework.dtype import convert_dtype
    n = x.shape[axis]
    seq = torch.arange(n, dtype=convert_dtype(dtype) or torch.int64,
                       device=x.device)
    shape = [1] * x.dim()
    shape[axis] = n
    return seq.reshape(shape).expand(x.shape)


@op()
def yolo_box_xpu(x, img_size, anchors, class_num, conf_thresh=0.01,
                 downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    from .vision_ops import yolo_box
    return yolo_box(x, img_size, anchors, class_num,
                    conf_thresh=conf_thresh,
                    downsample_ratio=downsample_ratio,
                    clip_bbox=clip_bbox, scale_x_y=scale_x_y)
