"""GPT causal LM — the flagship model, as the serving engine consumes it.

Pre-LN transformer, learned positions, tied LM head.  Parameters keep
the JAX package's state-dict names and Paddle's ``[in, out]`` Linear
weight layout (the engine computes ``hh @ W``), so
``functional_decompose()`` yields exactly the JAX schema and
``load_stacked`` carries weights across from it as numpy arrays.

``forward`` is a dense causal forward used as a reference (tests, the
chip smoke's exactness phase).  Its attention is the plain masked
composition (einsum, f32 softmax); it becomes the flash-attention
kernel path with the training slice.
"""

import math

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device
from ..incubate.nn import _layernorm


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, initializer_range=0.02,
                 layer_norm_epsilon=1e-5):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _param(shape, device, dtype, generator, std=None, fill=0.0):
    """A frozen parameter: ``Normal(0, std)`` from ``generator``, or
    ``fill`` when ``std`` is None."""
    p = torch.empty(shape, device=device, dtype=dtype)
    if std is None:
        p.fill_(fill)
    else:
        p.normal_(0.0, std, generator=generator)
    return nn.Parameter(p, requires_grad=False)


class Linear(nn.Module):
    """y = x @ weight + bias with weight [in, out] (Paddle layout)."""

    def __init__(self, din, dout, std, **kw):
        super().__init__()
        self.weight = _param((din, dout), std=std, **kw)
        self.bias = _param((dout,), **kw)

    def forward(self, x):
        return x @ self.weight + self.bias


class LayerNorm(nn.Module):
    def __init__(self, h, eps, **kw):
        super().__init__()
        self.eps = eps
        self.weight = _param((h,), fill=1.0, **kw)
        self.bias = _param((h,), **kw)

    def forward(self, x):
        return _layernorm(x, self.weight, self.bias, self.eps)


class Embedding(nn.Module):
    def __init__(self, n, h, std, **kw):
        super().__init__()
        self.weight = _param((n, h), std=std, **kw)

    def forward(self, ids):
        return self.weight[ids]


def _dense_attention(q, k, v):
    """Causal attention on [B, T, N, H]: scores and context accumulate
    in f32 from the input dtype's values, the softmax runs in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    t, s = logits.shape[-2], logits.shape[-1]
    causal = torch.ones((t, s), dtype=torch.bool,
                        device=q.device).tril(diagonal=s - t)
    logits = torch.where(causal, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bsnh->btnh", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


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

    def forward(self, x):
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, self.head_dim)
        out = _dense_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, t, self.num_heads * self.head_dim))


class GPTMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        self.fc_in = Linear(h, inter, std, **kw)
        self.fc_out = Linear(inter, h,
                             std / math.sqrt(2 * config.num_layers), **kw)

    def forward(self, x):
        return self.fc_out(nn.functional.gelu(self.fc_in(x),
                                              approximate="tanh"))


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

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        return (self.word_embeddings(input_ids)
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
    """GPT with a tied LM head; ``forward`` returns logits [B, T, V].

    Weights are drawn from ``Normal(0, initializer_range)`` (the two
    output projections scaled by ``1/sqrt(2 * num_layers)``) out of an
    explicit ``torch.Generator`` seeded with ``seed``, on ``device``
    (``None``: cuda, raising when CUDA is missing)."""

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

    @torch.no_grad()
    def forward(self, input_ids):
        hidden = self.gpt(input_ids)
        return hidden @ self.gpt.embeddings.word_embeddings.weight.T

    @torch.no_grad()
    def greedy_decode(self, prompt_ids, max_new_tokens):
        """Greedy decoding by re-running the dense forward over the whole
        sequence each step (no cache) — the reference the paged engine
        is held to token for token.  Returns prompt + new as int64."""
        ids = torch.as_tensor(np.asarray(prompt_ids, np.int64),
                              device=self.device)[None]
        for _ in range(max_new_tokens):
            nxt = self.forward(ids)[0, -1].argmax()
            ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
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


def gpt_tiny(device=None, seed=0, dtype=torch.float32, **kw):
    """Test config: a few tiny layers."""
    cfg = dict(vocab_size=128, hidden_size=64, num_layers=4,
               num_attention_heads=4, max_position_embeddings=64)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)


def gpt_124m(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=50304, hidden_size=768, num_layers=12,
               num_attention_heads=12, max_position_embeddings=1024)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)
