"""Llama family — RMSNorm + RoPE + GQA + SwiGLU decoder.

Port of ``paddle_tpu/models/llama.py``.  Parameters keep the JAX
package's state-dict names and Paddle's ``[in, out]`` Linear layout
(packed ``qkv`` and ``gate_up`` projections, no biases, an untied
``lm_head`` by default), so weights carry across from the JAX model by
name (:meth:`LlamaForCausalLM.set_state_dict`).

``forward`` is the dense causal forward: RMSNorm, half-split RoPE from
the same float32 numpy tables, the kv heads broadcast to the query
heads, ``F.scaled_dot_product_attention(is_causal=True)`` (the flash
kernel on the card), SwiGLU and the LM head.  ``decode_step`` is
one-token generation against a preallocated cache: it writes the
token's k/v in place and attends through ``ragged_decode_attention``,
which reads the compact ``[B, S, Nkv, D]`` cache with the native GQA
grouping (the dense-cache decode kernel on the card).
"""

import math

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device
from ..incubate.nn.functional import ragged_decode_attention, swiglu
from ..nn import RMSNorm
from ..nn import functional as F
from .gpt import Embedding, Linear


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_attention_heads=12, num_key_value_heads=None,
                 intermediate_size=None, max_position_embeddings=2048,
                 rope_theta=10000.0, rms_norm_eps=1e-6,
                 initializer_range=0.02, sequence_parallel=False,
                 tie_word_embeddings=False):
        if sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel is not ported yet: it comes with the "
                "tensor-parallel slice")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        # llama MLP sizing: 2/3 * 4h rounded to a multiple of 256
        if intermediate_size is None:
            intermediate_size = int(8 * hidden_size / 3)
            intermediate_size = 256 * ((intermediate_size + 255) // 256)
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.rope_theta = rope_theta
        self.rms_norm_eps = rms_norm_eps
        self.initializer_range = initializer_range
        self.sequence_parallel = sequence_parallel
        self.tie_word_embeddings = tie_word_embeddings

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _rope_tables(head_dim, max_len, theta):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(max_len)
    freqs = np.outer(t, inv)  # [T, D/2]
    return (np.cos(freqs).astype(np.float32),
            np.sin(freqs).astype(np.float32))


def _rotate(x, cos, sin):
    """Half-split RoPE of x [..., D] with cos/sin broadcastable to
    [..., D/2], in the promoted dtype of the operands."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h = config.hidden_size
        std = config.initializer_range
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        # packed q + k + v projection
        self.qkv = Linear(h, h + 2 * kv_out, std, has_bias=False, **kw)
        self.o_proj = Linear(h, h, std / math.sqrt(2 * config.num_layers),
                             has_bias=False, **kw)
        cos, sin = _rope_tables(self.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("_cos", torch.from_numpy(cos).to(kw["device"]),
                             persistent=False)
        self.register_buffer("_sin", torch.from_numpy(sin).to(kw["device"]),
                             persistent=False)

    def split(self, qkv):
        """Packed projection [B, T, (Nq + 2 Nkv) D] -> q, k, v."""
        b, t, _ = qkv.shape
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = qkv[..., :nq * hd].reshape(b, t, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, t, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(b, t, nkv, hd)
        return q, k, v

    def forward(self, x):
        b, t, _ = x.shape
        nq, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = self.split(self.qkv(x))
        cos = self._cos[:t][None, :, None, :]
        sin = self._sin[:t][None, :, None, :]
        # the f32 tables promote; the port keeps the activation dtype
        q = _rotate(q, cos, sin).to(x.dtype)
        k = _rotate(k, cos, sin).to(x.dtype)
        if nkv != nq:
            # GQA: broadcast kv heads to query heads for the dense kernel
            rep = nq // nkv
            k = k[:, :, :, None].expand(b, t, nkv, rep, hd).reshape(
                b, t, nq, hd)
            v = v[:, :, :, None].expand(b, t, nkv, rep, hd).reshape(
                b, t, nq, hd)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, t, nq * hd))


class LlamaMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        # packed gate + up, then down
        self.gate_up = Linear(h, 2 * inter, std, has_bias=False, **kw)
        self.down = Linear(inter, h, std / math.sqrt(2 * config.num_layers),
                           has_bias=False, **kw)
        self._inter = inter

    def forward(self, x):
        gu = self.gate_up(x)
        return self.down(swiglu(gu[..., :self._inter], gu[..., self._inter:]))


class LlamaBlock(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps,
                                       **norm_kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **norm_kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      config.initializer_range, **kw)
        self.layers = nn.ModuleList([LlamaBlock(config, **kw)
                                     for _ in range(config.num_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for blk in self.layers:
            x = blk(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with an (untied by default) LM head; ``forward`` returns
    logits [B, T, V] and ``loss`` is the shifted-label cross entropy.

    Weights are drawn from ``Normal(0, initializer_range)`` (the two
    output projections scaled by ``1/sqrt(2 * num_layers)``) out of a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (``None``:
    cuda, raising when CUDA is missing)."""

    def __init__(self, config, device=None, seed=0, dtype=torch.float32):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.llama = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               config.initializer_range, has_bias=False,
                               **kw))

    @property
    def device(self):
        return self.llama.norm.weight.device

    def _head(self, h):
        if self.lm_head is None:
            return F.linear(h, self.llama.embed_tokens.weight.T)
        return self.lm_head(h)

    def forward(self, input_ids):
        return self._head(self.llama(input_ids))

    def loss(self, logits, labels):
        """Causal LM loss: logits[:, :-1] vs labels[:, 1:]."""
        return F.cross_entropy(
            logits[:, :-1, :].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1))

    def functional_decompose(self):
        raise NotImplementedError(
            "LlamaForCausalLM.functional_decompose is not ported yet: the "
            "stacked-layer form feeds the SPMD pipeline trainer, which "
            "comes with the tensor-parallel and long-tail slices")

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Write a flat state dict (the JAX ``LlamaForCausalLM.
        state_dict()`` names, ``llama.layers.<i>.self_attn.qkv.weight``
        and so on, as numpy arrays or tensors) into the model by name,
        casting to each parameter's dtype and device.  Raises KeyError
        unless the names are exactly the model's."""
        params = dict(self.named_parameters())
        missing = sorted(set(params) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(params))
        if missing or unexpected:
            raise KeyError(f"state dict names differ: missing {missing}, "
                           f"unexpected {unexpected}")
        for name, value in state_dict.items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            params[name].copy_(value)

    # ---- KV-cache decode (the dense-cache decode kernel) ----
    def init_cache(self, batch, max_len):
        """f32 K/V caches [batch, max_len, Nkv, D] per layer (as the JAX
        package makes them) and per-sequence lengths, on the model's
        device."""
        cfg = self.config
        shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        dev = self.device
        return {"k": [torch.zeros(shape, dtype=torch.float32, device=dev)
                      for _ in range(cfg.num_layers)],
                "v": [torch.zeros(shape, dtype=torch.float32, device=dev)
                      for _ in range(cfg.num_layers)],
                "lengths": torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)}

    @torch.no_grad()
    def decode_step(self, input_ids, cache):
        """One-token decode: input_ids [B, 1] -> (logits [B, vocab],
        cache).

        Each layer writes the token's k/v at each sequence's position
        and attends through ``ragged_decode_attention`` over the compact
        GQA cache with ``lengths = position + 1``.  The cache is updated
        in place (its k/v tensors and lengths) and also returned.
        Decoding past the cache's max_len or the rope table raises
        ValueError."""
        cfg = self.config
        b = input_ids.shape[0]
        pos = cache["lengths"]                       # [B] int32
        max_len = cache["k"][0].shape[1]
        hi = int(pos.max())
        if hi >= max_len or hi >= cfg.max_position_embeddings:
            raise ValueError(
                f"decode position {hi} exceeds cache max_len {max_len} / "
                f"max_position_embeddings {cfg.max_position_embeddings} "
                f"— grow init_cache")
        rows = torch.arange(b, device=pos.device)
        pos_l = pos.long()
        x = self.llama.embed_tokens(input_ids)       # [B, 1, H]
        for li, blk in enumerate(self.llama.layers):
            attn = blk.self_attn
            q, k, v = attn.split(attn.qkv(blk.input_layernorm(x)))
            # rope at each sequence's own position
            cos = attn._cos[pos_l][:, None, None, :]
            sin = attn._sin[pos_l][:, None, None, :]
            kc, vc = cache["k"][li], cache["v"][li]
            kc[rows, pos_l] = _rotate(k, cos, sin)[:, 0].to(kc.dtype)
            vc[rows, pos_l] = v[:, 0].to(vc.dtype)
            qd = _rotate(q, cos, sin)[:, 0].to(kc.dtype).contiguous()
            out = ragged_decode_attention(qd, kc, vc, pos + 1)  # [B, Nq, D]
            x = x + attn.o_proj(out.reshape(b, 1, -1).to(x.dtype))
            x = x + blk.mlp(blk.post_attention_layernorm(x))
        logits = self._head(self.llama.norm(x))
        cache["lengths"] = pos + 1
        return logits[:, 0], cache


def llama_tiny(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=4,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=64)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device, seed=seed,
                            dtype=dtype)


def llama_160m(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=32000, hidden_size=768, num_layers=12,
               num_attention_heads=12, num_key_value_heads=4,
               max_position_embeddings=2048)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device, seed=seed,
                            dtype=dtype)


def llama_7b(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
               num_attention_heads=32, num_key_value_heads=32,
               max_position_embeddings=4096)
    cfg.update(kw)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device, seed=seed,
                            dtype=dtype)
