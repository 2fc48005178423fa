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

Parallelism as GPT's (``models/gpt.py``): the JAX ``mesh_axes`` on every
parameter (the packed qkv as its q, k and v parts, gate_up as its two),
so a model sliced over an mp group splits the query heads and the kv
heads over the ranks (GQA: the kv heads must divide too), runs the
column- and row-parallel projections with Megatron's collectives, and
with ``sequence_parallel=True`` keeps its RMSNorms and residuals on the
rank's sequence shard.  ``functional_decompose`` gives the JAX schema:
stacked block parameters, their mesh-axis specs and the four pure
functions.
"""

import math

import numpy as np
import torch
from torch import nn

from ..distributed.fleet.meta_parallel import mp_layers
from ..framework.device import resolve_device
from ..incubate.nn.functional import ragged_decode_attention, swiglu
from ..nn import functional as F
from .gpt import Embedding, Linear, _causal_lm_loss, _column, _row


class LlamaRMSNorm(nn.Module):
    """``y = x * rsqrt(mean(x ** 2) + epsilon) * weight`` over the last
    dim, with ``weight`` [hidden_size] initialised to ones: the Llama
    model's norm, a ``torch.nn.Module`` like the rest of the model (the
    Paddle Layer is ``nn.RMSNorm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_attention_heads=12, num_key_value_heads=None,
                 intermediate_size=None, max_position_embeddings=2048,
                 rope_theta=10000.0, rms_norm_eps=1e-6,
                 initializer_range=0.02, sequence_parallel=False,
                 tie_word_embeddings=False):
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
        mp_layers.annotate(self.qkv.weight, (None, "mp"),
                           (h, kv_out, kv_out))
        mp_layers.annotate(self.o_proj.weight, ("mp", None))
        cos, sin = _rope_tables(self.head_dim,
                                config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("_cos", torch.from_numpy(cos).to(kw["device"]),
                             persistent=False)
        self.register_buffer("_sin", torch.from_numpy(sin).to(kw["device"]),
                             persistent=False)

    def _heads(self):
        """(query heads, kv heads) this rank holds."""
        mp = mp_layers.mp_of(self)
        n = 1 if mp is None else mp.size
        return self.num_heads // n, self.num_kv_heads // n

    def split(self, qkv):
        """Packed projection [B, T, (Nq + 2 Nkv) D] -> q, k, v (the
        rank's heads in a sliced model)."""
        b, t, _ = qkv.shape
        (nq, nkv), hd = self._heads(), self.head_dim
        q = qkv[..., :nq * hd].reshape(b, t, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(b, t, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(b, t, nkv, hd)
        return q, k, v

    def forward(self, x):
        mp = mp_layers.mp_of(self)
        (nq, nkv), hd = self._heads(), self.head_dim
        qkv = _column(mp, x, self.qkv)
        b, t, _ = qkv.shape
        q, k, v = self.split(qkv)
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
        out = out.reshape(b, t, nq * hd)
        return _row(mp, out, self.o_proj)


class LlamaMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        # packed gate + up, then down
        self.gate_up = Linear(h, 2 * inter, std, has_bias=False, **kw)
        self.down = Linear(inter, h, std / math.sqrt(2 * config.num_layers),
                           has_bias=False, **kw)
        mp_layers.annotate(self.gate_up.weight, (None, "mp"), (inter, inter))
        mp_layers.annotate(self.down.weight, ("mp", None))
        self._inter = inter

    def forward(self, x):
        mp = mp_layers.mp_of(self)
        gu = _column(mp, x, self.gate_up)
        half = gu.shape[-1] // 2     # the rank's columns of each part
        return _row(mp, swiglu(gu[..., :half], gu[..., half:]), self.down)


class LlamaBlock(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            epsilon=config.rms_norm_eps,
                                            **norm_kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = LlamaRMSNorm(
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
        mp_layers.annotate(self.embed_tokens.weight, ("mp", None))
        self.layers = nn.ModuleList([LlamaBlock(config, **kw)
                                     for _ in range(config.num_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size,
                                 epsilon=config.rms_norm_eps,
                                 device=kw["device"], dtype=kw["dtype"])

    def forward(self, input_ids):
        x = mp_layers.vocab_parallel_embedding(
            input_ids, self.embed_tokens.weight, mp_layers.mp_of(self))
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
        if self.lm_head is not None:
            mp_layers.annotate(self.lm_head.weight, (None, "mp"))

    @property
    def device(self):
        return self.llama.norm.weight.device

    def _head(self, h):
        mp = mp_layers.mp_of(self)
        if mp is not None:
            # the rank's vocab block of the logits
            h = mp.column_in(h)
        if self.lm_head is None:
            return F.linear(h, self.llama.embed_tokens.weight.T)
        return self.lm_head(h)

    def forward(self, input_ids):
        return self._head(self.llama(input_ids))

    def loss(self, logits, labels):
        """Causal LM loss: logits[:, :-1] vs labels[:, 1:] (the
        vocab-parallel cross entropy in a sliced model)."""
        return _causal_lm_loss(self, logits, labels)

    # ---- functional decomposition (the JAX SpmdTrainStep contract) ----
    def functional_decompose(self):
        """``{"params", "specs", "fns", "num_layers"}``, the JAX schema:
        ``params`` {"embed": {"weight"}, "blocks": the block parameters
        stacked on a leading layer axis, "head": {"norm.weight"(,
        "lm_head.weight")}}, ``specs`` their mesh axes (a block leaf's
        with ``"pp"`` in front), ``fns`` (embed_fn(p, ids), block_fn(p,
        hidden), head_fn(p, hidden, embed_p), loss_fn(logits, labels)),
        each a pure function of its parameters through
        ``torch.func.functional_call``; on a model sliced over mp they
        run the collectives the forward runs (the vocab-split lookup, the
        rank's vocab block of the logits, the vocab-parallel cross
        entropy)."""
        from torch.func import functional_call

        embed = self.llama.embed_tokens
        blocks = list(self.llama.layers)
        template = blocks[0]
        norm = self.llama.norm

        embed_params = {k: v.detach() for k, v in embed.named_parameters()}
        head_params = {"norm." + k: v.detach()
                       for k, v in norm.named_parameters()}
        if self.lm_head is not None:
            head_params.update({"lm_head." + k: v.detach() for k, v in
                                self.lm_head.named_parameters()})
        tparams = dict(template.named_parameters())
        stacked = {n: torch.stack([dict(blk.named_parameters())[n].detach()
                                   for blk in blocks]) for n in tparams}

        def axes_of(p):
            return getattr(p, "mesh_axes", None)

        embed_specs = {k: axes_of(v) for k, v in embed.named_parameters()}
        head_specs = {k: None for k in head_params}
        if self.lm_head is not None:
            for k, v in self.lm_head.named_parameters():
                head_specs["lm_head." + k] = axes_of(v)
        block_specs = {n: ("pp",) + tuple(axes_of(p) or (None,) * p.dim())
                       for n, p in tparams.items()}

        model = self

        def embed_fn(p, input_ids):
            return mp_layers.vocab_parallel_embedding(
                input_ids, p["weight"], mp_layers.mp_of(model))

        def block_fn(p, hidden):
            return functional_call(template, p, (hidden,))

        lm_head = self.lm_head

        def head_fn(p, hidden, embed_p):
            np_ = {k[len("norm."):]: v for k, v in p.items()
                   if k.startswith("norm.")}
            h = functional_call(norm, np_, (hidden,))
            mp = mp_layers.mp_of(model)
            if mp is not None:
                # the rank's vocab block of the logits
                h = mp.column_in(h)
            if lm_head is None:
                return h @ embed_p["weight"].T
            return h @ p["lm_head.weight"]

        def loss_fn(logits, labels):
            # the shifted cross entropy of GPTForCausalLM's decomposition
            # (vocab-parallel over a sliced model's logits)
            return _causal_lm_loss(model, logits, labels)

        return {
            "params": {"embed": embed_params, "blocks": stacked,
                       "head": head_params},
            "specs": {"embed": embed_specs, "blocks": block_specs,
                      "head": head_specs},
            "fns": (embed_fn, block_fn, head_fn, loss_fn),
            "num_layers": len(blocks),
        }

    @torch.no_grad()
    def load_stacked(self, params):
        """Write stacked params (the ``functional_decompose`` schema, as
        numpy arrays or tensors) into the model, casting to each
        parameter's dtype and device (``SpmdTrainStep.sync_to_model``)."""
        def put(p, v):
            p.copy_(torch.as_tensor(v).to(p.device, p.dtype))

        emb = dict(self.llama.embed_tokens.named_parameters())
        for k, v in params["embed"].items():
            put(emb[k], v)
        head = {"norm." + k: p for k, p in self.llama.norm.named_parameters()}
        if self.lm_head is not None:
            head.update({"lm_head." + k: p for k, p in
                         self.lm_head.named_parameters()})
        for k, v in params["head"].items():
            put(head[k], v)
        for i, blk in enumerate(self.llama.layers):
            sd = dict(blk.named_parameters())
            for k, v in params["blocks"].items():
                put(sd[k], v[i])

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
