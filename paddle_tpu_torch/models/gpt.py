"""GPT causal LM — the flagship model, trained and served.

Pre-LN transformer, learned positions, tied LM head.  Parameters keep
the JAX package's state-dict names and Paddle's ``[in, out]`` Linear
weight layout (the engine computes ``hh @ W``), so
``functional_decompose()`` yields exactly the JAX schema, and weights
carry across from the JAX model as numpy arrays: ``load_stacked`` takes
the stacked schema, ``set_state_dict`` the flat state dict by name.

``forward`` is the training forward: attention goes through
``F.scaled_dot_product_attention(is_causal=True)`` and every LayerNorm
through ``F.layer_norm``, which reach the flash-attention and LayerNorm
kernels on the card; dropout applies in ``train()`` mode where the JAX
model applies it, drawing from the model's ``torch.Generator``.
``greedy_decode`` runs the same forward in eval mode without autograd,
as the reference the paged engine is held to.
"""

import math

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device
from ..nn import functional as F


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, initializer_range=0.02,
                 layer_norm_epsilon=1e-5):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _param(shape, device, dtype, generator, std=None, fill=0.0):
    """A trainable parameter: ``Normal(0, std)`` from ``generator``, or
    ``fill`` when ``std`` is None."""
    p = torch.empty(shape, device=device, dtype=dtype)
    if std is None:
        p.fill_(fill)
    else:
        p.normal_(0.0, std, generator=generator)
    return nn.Parameter(p)


class Linear(nn.Module):
    """y = x @ weight + bias with weight [in, out] (Paddle layout);
    ``has_bias=False`` leaves the bias out."""

    def __init__(self, din, dout, std, has_bias=True, **kw):
        super().__init__()
        self.weight = _param((din, dout), std=std, **kw)
        self.bias = _param((dout,), **kw) if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, h, eps, **kw):
        super().__init__()
        self.eps = eps
        self.weight = _param((h,), fill=1.0, **kw)
        self.bias = _param((h,), **kw)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias, self.eps)


class Embedding(nn.Module):
    def __init__(self, n, h, std, **kw):
        super().__init__()
        self.weight = _param((n, h), std=std, **kw)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """``upscale_in_train`` dropout drawing from the model's generator."""

    def __init__(self, p, generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)


class GPTAttention(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h = config.hidden_size
        std = config.initializer_range
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.qkv = Linear(h, 3 * h, std, **kw)
        self.proj = Linear(h, h, std / math.sqrt(2 * config.num_layers),
                           **kw)
        self.dropout_p = config.attention_probs_dropout_prob
        self.generator = kw["generator"]
        self.resid_drop = Dropout(config.hidden_dropout_prob, kw["generator"])

    def forward(self, x):
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout_p,
            training=self.training, generator=self.generator)
        out = out.reshape(b, t, self.num_heads * self.head_dim)
        return self.resid_drop(self.proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        self.fc_in = Linear(h, inter, std, **kw)
        self.fc_out = Linear(inter, h,
                             std / math.sqrt(2 * config.num_layers), **kw)
        self.drop = Dropout(config.hidden_dropout_prob, kw["generator"])

    def forward(self, x):
        return self.drop(self.fc_out(F.gelu(self.fc_in(x), approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **kw)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        std = config.initializer_range
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, std, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, std, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, kw["generator"])

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(pos))


class GPTModel(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.embeddings = GPTEmbeddings(config, **kw)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              config.layer_norm_epsilon, **kw)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with a tied LM head; ``forward`` returns logits [B, T, V] and
    ``loss`` is the shifted-label cross entropy.

    Weights are drawn from ``Normal(0, initializer_range)`` (the two
    output projections scaled by ``1/sqrt(2 * num_layers)``) out of an
    explicit ``torch.Generator`` seeded with ``seed``, on ``device``
    (``None``: cuda, raising when CUDA is missing); dropout draws from
    the same generator afterwards."""

    def __init__(self, config, device=None, seed=0, dtype=torch.float32):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.gpt = GPTModel(config, device=dev, dtype=dtype, generator=gen)

    @property
    def device(self):
        return self.gpt.ln_f.weight.device

    def forward(self, input_ids):
        hidden = self.gpt(input_ids)
        return F.linear(hidden, self.gpt.embeddings.word_embeddings.weight.T)

    def loss(self, logits, labels):
        """Causal LM loss: logits[:, :-1] vs labels[:, 1:]."""
        return F.cross_entropy(
            logits[:, :-1, :].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1))

    @torch.no_grad()
    def greedy_decode(self, prompt_ids, max_new_tokens):
        """Greedy decoding by re-running the dense forward over the whole
        sequence each step (no cache, eval mode) — the reference the
        paged engine is held to token for token.  Returns prompt + new
        as int64."""
        ids = torch.as_tensor(np.asarray(prompt_ids, np.int64),
                              device=self.device)[None]
        was_training = self.training
        self.eval()
        try:
            for _ in range(max_new_tokens):
                nxt = self.forward(ids)[0, -1].argmax()
                ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
        finally:
            self.train(was_training)
        return ids[0].cpu().numpy()

    # ---- the stacked form the serving engine consumes ----
    def functional_decompose(self):
        """``{"params": {"embed", "blocks", "head"}, "num_layers"}`` with
        per-layer block params stacked on a leading axis — the JAX
        package's schema (``blocks`` keys are the block state-dict
        names, ``head`` is the final LayerNorm; the LM head is tied to
        ``embed["word_embeddings.weight"]``)."""
        emb = self.gpt.embeddings
        blocks = list(self.gpt.h)
        stacked = {name: torch.stack([dict(b.named_parameters())[name]
                                      .detach() for b in blocks])
                   for name, _ in blocks[0].named_parameters()}
        return {
            "params": {
                "embed": {k: v.detach()
                          for k, v in emb.named_parameters()},
                "blocks": stacked,
                "head": {k: v.detach()
                         for k, v in self.gpt.ln_f.named_parameters()},
            },
            "num_layers": len(blocks),
        }

    @torch.no_grad()
    def load_stacked(self, params):
        """Write stacked params (the ``functional_decompose`` schema, as
        numpy arrays or tensors) into the model, casting to each
        parameter's dtype and device."""
        def put(p, v):
            p.copy_(torch.as_tensor(v).to(p.device, p.dtype))

        emb = dict(self.gpt.embeddings.named_parameters())
        for k, v in params["embed"].items():
            put(emb[k], v)
        head = dict(self.gpt.ln_f.named_parameters())
        for k, v in params["head"].items():
            put(head[k], v)
        for i, blk in enumerate(self.gpt.h):
            sd = dict(blk.named_parameters())
            for k, v in params["blocks"].items():
                put(sd[k], v[i])

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Write a flat state dict (the JAX ``GPTForCausalLM.state_dict()``
        names, ``gpt.h.<i>.ln_1.weight`` and so on, as numpy arrays or
        tensors) into the model by name, casting to each parameter's
        dtype and device.  Raises KeyError unless the names are exactly
        the model's."""
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


def gpt_tiny(device=None, seed=0, dtype=torch.float32, **kw):
    """Test config: a few tiny layers, no dropout."""
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=4,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)


def gpt_124m(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=50304, hidden_size=768, num_layers=12,
               num_attention_heads=12, max_position_embeddings=1024)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)
