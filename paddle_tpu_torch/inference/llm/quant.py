"""Serving-side int8 quantization — weights and the paged K/V pool.

Port of ``paddle_tpu/inference/llm/quant.py``.  Two independent halves
behind one ``LLMEngine(quantize=)`` knob:

- **Weight-only int8 GEMM**: the four block matmul leaves of the
  stacked params (``attn.qkv.weight``, ``attn.proj.weight``,
  ``mlp.fc_in.weight``, ``mlp.fc_out.weight``) are stored int8 with
  per-output-channel float32 scales as sibling leaves
  (``<key>_scale``, shape [L, 1, out]).  Each step dequantizes at the
  GEMM operand load in the activation dtype; the int8 tensor is the
  only resident copy.
- **Int8 paged K/V pool**: the pool stores int8 slots with one float32
  scale per (layer, page, head, slot), quantized at append time per
  written token row (absmax over head_dim / 127) and dequantized at
  read time inside the ragged attention kernel.  A slot costs
  head_dim + 4 bytes instead of head_dim * itemsize.

The results are bitwise the JAX package's: the scale divides (``v / s``,
not a multiply by its reciprocal), ``torch.round`` rounds half to even
as ``jnp.round`` does, and the clip runs in f32 before the int8 cast.
Int8 KV is approximate; ``quality.py`` measures the delta.
"""

import torch

QMAX = 127.0
# smallest representable scale: keeps all-zero rows well-defined
# (q = 0 / eps = 0) without ever dividing by zero
_EPS = 1e-9

# the stacked-block weight leaves that quantize (the four GEMMs);
# embeddings (tied to the head gather), layernorms and biases stay in
# the activation dtype
QUANT_BLOCK_LEAVES = (
    "attn.qkv.weight",
    "attn.proj.weight",
    "mlp.fc_in.weight",
    "mlp.fc_out.weight",
)


def scale_key(key):
    """Sibling leaf name holding a quantized weight's dequant scales."""
    return key + "_scale"


class ServingQuantConfig:
    """Resolved form of ``LLMEngine(quantize=)``.

    Accepts ``None`` (off), the string ``"int8"`` (weights + KV pool),
    a dict (``{"weights": bool, "kv_cache": bool}``), another
    ServingQuantConfig, or a QAT/PTQ ``QuantConfig``-like object (any
    object with ``factory_for``), which serving reads as "quantize
    weights and KV cache int8"."""

    def __init__(self, weights=True, kv_cache=True, bits=8):
        if int(bits) != 8:
            raise ValueError(
                f"serving quantization is int8-only, got bits={bits!r}")
        self.weights = bool(weights)
        self.kv_cache = bool(kv_cache)
        self.bits = 8
        if not (self.weights or self.kv_cache):
            raise ValueError(
                "quantize= resolved to a no-op config (weights=False, "
                "kv_cache=False) — pass None to disable quantization")

    @classmethod
    def resolve(cls, spec):
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if spec.lower() != "int8":
                raise ValueError(
                    f"unknown quantize= mode {spec!r} (only 'int8')")
            return cls()
        if isinstance(spec, dict):
            return cls(**spec)
        if hasattr(spec, "factory_for"):
            return cls(weights=True, kv_cache=True)
        raise TypeError(
            f"quantize= accepts None, 'int8', a dict, a "
            f"ServingQuantConfig, or a QuantConfig; got {type(spec)}")

    def __repr__(self):
        return (f"ServingQuantConfig(weights={self.weights}, "
                f"kv_cache={self.kv_cache}, bits={self.bits})")


def _quantize(v32, dim):
    """Symmetric absmax int8 over ``dim`` of an f32 tensor -> (int8,
    f32 scales with ``dim`` kept)."""
    s = torch.clamp(v32.abs().amax(dim=dim, keepdim=True), min=_EPS) / QMAX
    q = torch.clamp(torch.round(v32 / s), -QMAX, QMAX).to(torch.int8)
    return q, s


def quantize_weight(w):
    """Per-output-channel symmetric int8: ``w`` [..., in, out] -> (int8
    qweight, float32 scales [..., 1, out]) with ``q * s ~= w``.  The
    absmax runs over the input axis, so each output column owns one
    scale."""
    return _quantize(w.float(), -2)


def quantize_block_weights(blocks, keys=QUANT_BLOCK_LEAVES):
    """Quantize the GEMM leaves of the stacked block params (a copy of
    the dict), adding ``<key>_scale`` sibling leaves."""
    out = dict(blocks)
    for key in keys:
        q, s = quantize_weight(out[key])
        out[key] = q
        out[scale_key(key)] = s
    return out


def quantize_kv_rows(values):
    """Quantize K/V rows at append time: ``values`` [..., D] -> (int8
    [..., D], float32 scales [...]), one symmetric absmax scale per
    (token, head) row.  All-zero rows quantize to exact zeros."""
    q, s = _quantize(values.float(), -1)
    return q, s.squeeze(-1)


def dequantize_kv_rows(q, s):
    """Read-side inverse of :func:`quantize_kv_rows` (float32)."""
    return q.float() * s.float()[..., None]
