"""incubate.nn.functional: the fused-op API surface.

Port of ``paddle_tpu/incubate/nn/functional.py``.  As there, "fused" is
an API, not a kernel: each function is the registered fused op of
``ops/fused_ops.py`` or a composition dispatched through ``apply_op``
(Paddle Tensors in, Tensors out, torch autograd; raw torch tensors run
the body).  The attention core of ``fused_multi_head_attention`` is
``ops/attention.py::flash_attention``, which launches the flash kernels
(B2 forward, B3 backward) on CUDA tensors with no mask and no dropout.
``ragged_decode_attention`` launches the dense-cache decode kernel
(B6) on CUDA tensors.
"""

import torch

from ...core.tensor import Tensor
from ...ops.cuda.decode_attention_kernel import (
    decode_attention_plain,
    decode_op,
)
from ...ops.dispatch import apply_op
from ...ops.registry import OPS, register_external

__all__ = ["fused_matmul_bias", "fused_linear", "fused_feedforward",
           "fused_multi_head_attention", "fused_dropout_add",
           "fused_bias_dropout_residual_layer_norm", "fused_ec_moe",
           "fused_rotary_position_embedding", "swiglu",
           "ragged_decode_attention"]

_tF = torch.nn.functional


def _u(name):
    return OPS[name].user_fn


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """matmul with the bias add folded in (cublasLt's epilogue in the
    reference)."""
    out = _u("matmul")(x, y, transpose_x=transpose_x,
                       transpose_y=transpose_y)
    if bias is not None:
        out = out + bias
    return out


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    return fused_matmul_bias(x, weight, bias, transpose_y=transpose_weight)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, mode=None,
                      name=None):
    """The ``fused_feedforward`` op; its dropout rates are accepted and
    not applied, as in the JAX op."""
    return _u("fused_feedforward")(
        x, linear1_weight, linear1_bias, linear2_weight, linear2_bias,
        ln1_scale=ln1_scale, ln1_bias=ln1_bias, ln2_scale=ln2_scale,
        ln2_bias=ln2_bias, dropout1_rate=dropout1_rate,
        dropout2_rate=dropout2_rate, act_method=activation,
        pre_layer_norm=pre_layer_norm, epsilon1=ln1_epsilon,
        epsilon2=ln2_epsilon, is_test=not training)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode=None, ring_id=-1,
                               add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None):
    """The ``fused_attention`` op: [LN] -> QKV -> attention -> out-proj
    -> residual [-> LN]; qkv_weight [3, num_heads, head_dim, C]."""
    return _u("fused_attention")(
        x, qkv_weight, qkv_bias, linear_weight, linear_bias,
        ln_scale=pre_ln_scale if pre_layer_norm else None,
        ln_bias=pre_ln_bias if pre_layer_norm else None,
        ln2_scale=ln_scale, ln2_bias=ln_bias, num_heads=num_heads,
        pre_layer_norm=pre_layer_norm, epsilon=pre_ln_epsilon,
        epsilon2=ln_epsilon, attn_dropout_rate=attn_dropout_rate,
        dropout_rate=dropout_rate, attn_mask=attn_mask,
        is_test=not training)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y."""
    return _u("fused_dropout_add")(x, y, p=p, is_test=not training,
                                   mode=mode)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True, mode=None,
        name=None):
    """LayerNorm(dropout(x + bias) + residual), the LayerNorm in the
    input dtype (a composition, as in the JAX package)."""
    h = x if bias is None else x + bias
    h = fused_dropout_add(h, residual, p=dropout_rate, training=training)

    def pure(data, scale, shift):
        mu = data.mean(-1, keepdim=True)
        var = ((data - mu) ** 2).mean(-1, keepdim=True)
        out = (data - mu) / torch.sqrt(var + ln_epsilon)
        if scale is not None:
            out = out * scale
        if shift is not None:
            out = out + shift
        return out

    return apply_op("fused_bias_dropout_residual_ln", pure,
                    (h, ln_scale, ln_bias), {})


def fused_ec_moe(x, gate_weight, gate_bias, expert_w1, expert_b1, expert_w2,
                 expert_b2, act_type="gelu", name=None):
    """Expert-choice MoE in one call: softmax gate, each expert's
    two-layer FFN on every token, the gate-weighted sum (dense)."""
    def pure(xx, gw, gb, w1, b1, w2, b2):
        gates = torch.softmax(torch.einsum("bsh,he->bse", xx, gw) + gb, -1)
        h = torch.einsum("bsh,ehm->besm", xx, w1) + b1[None, :, None, :]
        h = {"gelu": lambda v: _tF.gelu(v, approximate="tanh"),
             "relu": torch.relu}[act_type](h)
        h = torch.einsum("besm,emh->besh", h, w2) + b2[None, :, None, :]
        return torch.einsum("besh,bse->bsh", h, gates)

    return apply_op("fused_ec_moe", pure,
                    (x, gate_weight, gate_bias, expert_w1, expert_b1,
                     expert_w2, expert_b2), {})


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True, name=None):
    """RoPE on q/k/v [B, S, N, D]: interleaved pairs (``neox`` style) or
    halves, from ``position_ids`` or the first S rows of a sin/cos
    cache."""
    def d(t):
        return t._data if isinstance(t, Tensor) else torch.as_tensor(t)

    def rope_pure(tt):
        b, s, _, hd = tt.shape
        dev = tt.device
        if sin is None or cos is None:
            if position_ids is not None:
                pos = d(position_ids).to(dev).reshape(b, s).float()
            else:
                pos = torch.arange(s, dtype=torch.float32,
                                   device=dev).expand(b, s)
            inv = 1.0 / (10000 ** (torch.arange(0, hd, 2, device=dev) / hd))
            ang = pos[..., None] * inv[None, None, :]
            sn, cs = torch.sin(ang), torch.cos(ang)
        else:
            sn_full = d(sin).to(dev).reshape(-1, hd)[:s]
            cs_full = d(cos).to(dev).reshape(-1, hd)[:s]
            if use_neox_rotary_style:
                sn, cs = sn_full[:, 0::2], cs_full[:, 0::2]
            else:
                sn, cs = sn_full[:, :hd // 2], cs_full[:, :hd // 2]
            if position_ids is not None:
                raise ValueError(
                    "pass either position_ids or precomputed sin/cos "
                    "(gather the cache by position yourself)")
            sn = sn[None].expand(b, s, hd // 2)
            cs = cs[None].expand(b, s, hd // 2)
        sn, cs = sn[:, :, None, :], cs[:, :, None, :]
        if use_neox_rotary_style:
            x1, x2 = tt[..., 0::2], tt[..., 1::2]
            return torch.stack([x1 * cs - x2 * sn, x2 * cs + x1 * sn],
                               dim=-1).reshape(tt.shape)
        half = hd // 2
        x1, x2 = tt[..., :half], tt[..., half:]
        return torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn], dim=-1)

    return tuple(apply_op("fused_rope", rope_pure, (t,), {})
                 if t is not None else None for t in (q, k, v))


def swiglu(x, y=None, name=None):
    """SwiGLU: ``silu(a) * b`` with ``(a, b)`` the two halves of ``x``'s
    last dim, or ``(x, y)`` when ``y`` is given."""
    def pure(xx, yy):
        if yy is None:
            xx, yy = xx.chunk(2, dim=-1)
        return _tF.silu(xx) * yy

    return apply_op("swiglu", pure, (x, y), {})


def ragged_decode_attention(q, k_cache, v_cache, lengths, use_pallas=None):
    """Single-token decode attention over a ragged dense KV cache.

    q [B, Nq, D]; k_cache / v_cache [B, S_max, Nkv, D] with Nq % Nkv == 0
    (query heads grouped contiguously per kv head); lengths [B] int32,
    the valid prefix of each sequence (0 gives zeros).  CUDA tensors
    launch the decode kernel through its op
    (``ops/cuda/decode_attention_kernel.py``), which raises on what it
    does not take; CPU tensors run its plain
    version.  ``use_pallas=False`` is the caller's explicit opt-out of
    the kernel, as in the JAX package, and takes the plain version on
    any device; the default never does."""
    if q.is_cuda and use_pallas is not False:
        return decode_op(q, k_cache, v_cache, lengths)
    return decode_attention_plain(q, k_cache, v_cache, lengths)


# registry entries for the dispatched fused functions (their public entry
# points live here), as in the JAX package
for _name, _fn in [("swiglu", swiglu),
                   ("fused_rotary_position_embedding",
                    fused_rotary_position_embedding),
                   ("fused_ec_moe", fused_ec_moe),
                   ("fused_bias_dropout_residual_layer_norm",
                    fused_bias_dropout_residual_layer_norm),
                   ("ragged_decode_attention", ragged_decode_attention)]:
    register_external(_name, _fn, tags=("fused",))
