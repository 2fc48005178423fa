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

**Parallelism** (``distributed/fleet``).  Each parameter carries its JAX
``mesh_axes`` (the fused qkv its three parts).  Sliced over an mp group
(``fleet.distributed_model`` / ``TensorParallel``, or
``spmd.shard_parameters(model, mesh)``), every module holds the
``MPContext`` and runs Megatron's layers: the vocab-split embedding, the
column-parallel qkv and fc_in over the rank's heads and columns, the
row-parallel proj and fc_out whose partial sums are all-reduced before
their bias, and a head whose logits are the rank's vocab block, which
``loss`` takes through the vocab-parallel cross entropy.  With
``sequence_parallel=True`` the LayerNorms, biases, residuals and hidden
dropout run on the rank's sequence shard, between an all-gather before
each column-parallel layer and a reduce-scatter after each row-parallel
one.  Dropout of a replicated activation draws from the model's
generator (the same stream on every rank of the group); dropout of a
sharded one (the attention of the rank's heads, a sequence shard) from
the group rank's own (``mp_generator``).  ``cp_mode`` ("ring" or
"ulysses") runs the attention through ``context_parallel_attention``
over the ``sep`` axis of the active mesh (``spmd.use_mesh``) where the
JAX model does: with attention dropout 0 or in eval, and a mesh with a
``sep`` axis.  A model that is not sliced runs the dense forward.
"""

import math

import numpy as np
import torch
from torch import nn

from ..distributed.fleet.meta_parallel import mp_layers
from ..framework.device import resolve_device
from ..nn import functional as F


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, initializer_range=0.02,
                 layer_norm_epsilon=1e-5, sequence_parallel=False,
                 use_flash_attention=True, cp_mode=None):
        # the JAX config's keywords: use_flash_attention is stored and
        # read nowhere, as there; the other two select the sequence- and
        # context-parallel paths (module docstring)
        self.sequence_parallel = sequence_parallel
        self.use_flash_attention = use_flash_attention
        self.cp_mode = cp_mode
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
    """``upscale_in_train`` dropout drawing from the model's generator
    (from the mp rank's own when the input is a sequence shard)."""

    def __init__(self, p, generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        mp = mp_layers.mp_of(self)
        gen = self.generator
        if mp is not None and mp.sequence_parallel:
            gen = mp.generator
        return F.dropout(x, self.p, training=self.training, generator=gen)


def _column(mp, x, linear):
    """A column-parallel layer: the input copied to (or, under SP,
    gathered over) the group, the rank's columns; the dense ``linear``
    in a model that is not sliced (``mp`` None)."""
    if mp is None:
        return linear(x)
    return F.linear(mp.column_in(x), linear.weight, linear.bias)


def _row(mp, x, linear):
    """A row-parallel layer: the rank's partial product summed over the
    group (reduce-scattered under SP), then the bias; the dense
    ``linear`` in a model that is not sliced."""
    if mp is None:
        return linear(x)
    out = mp.row_out(torch.matmul(x, linear.weight))
    return out if linear.bias is None else out + linear.bias


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
        mp_layers.annotate(self.qkv.weight, (None, "mp"), (h, h, h))
        mp_layers.annotate(self.qkv.bias, ("mp",), (h, h, h))
        mp_layers.annotate(self.proj.weight, ("mp", None))
        mp_layers.annotate(self.proj.bias, (None,))
        self.dropout_p = config.attention_probs_dropout_prob
        self.generator = kw["generator"]
        self.resid_drop = Dropout(config.hidden_dropout_prob, kw["generator"])
        self.cp_mode = config.cp_mode

    def _attend(self, q, k, v, generator):
        # attention dropout is inactive in eval, so cp only yields to the
        # dense path when dropout would actually be applied
        if self.cp_mode and (self.dropout_p == 0.0 or not self.training):
            from ..distributed.fleet.meta_parallel import \
                context_parallel_attention
            from ..distributed.fleet.spmd import current_mesh

            mesh = current_mesh()
            if mesh is not None and "sep" in mesh.axis_names:
                return context_parallel_attention(
                    q, k, v, mesh, axis="sep", mode=self.cp_mode,
                    is_causal=True)
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout_p,
            training=self.training, generator=generator)

    def forward(self, x):
        mp = mp_layers.mp_of(self)
        heads = self.num_heads if mp is None else self.num_heads // mp.size
        qkv = _column(mp, x, self.qkv)
        b, t, _ = qkv.shape
        q, k, v = qkv.reshape(b, t, 3, heads, self.head_dim).unbind(dim=2)
        out = self._attend(q, k, v,
                           self.generator if mp is None else mp.generator)
        out = out.reshape(b, t, heads * self.head_dim)
        return self.resid_drop(_row(mp, out, self.proj))


class GPTMLP(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        std = config.initializer_range
        self.fc_in = Linear(h, inter, std, **kw)
        self.fc_out = Linear(inter, h,
                             std / math.sqrt(2 * config.num_layers), **kw)
        mp_layers.annotate(self.fc_in.weight, (None, "mp"))
        mp_layers.annotate(self.fc_in.bias, ("mp",))
        mp_layers.annotate(self.fc_out.weight, ("mp", None))
        mp_layers.annotate(self.fc_out.bias, (None,))
        self.drop = Dropout(config.hidden_dropout_prob, kw["generator"])

    def forward(self, x):
        mp = mp_layers.mp_of(self)
        h = F.gelu(_column(mp, x, self.fc_in), approximate=True)
        return self.drop(_row(mp, h, self.fc_out))


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
        mp_layers.annotate(self.word_embeddings.weight, ("mp", None))
        self.dropout = Dropout(config.hidden_dropout_prob, kw["generator"])

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        mp = mp_layers.mp_of(self)
        words = mp_layers.vocab_parallel_embedding(
            input_ids, self.word_embeddings.weight, mp)
        if mp is not None:
            pos = pos[mp.seq_chunk(pos.shape[0])]
        return self.dropout(words + self.position_embeddings(pos))


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
        w = self.gpt.embeddings.word_embeddings.weight
        mp = mp_layers.mp_of(self)
        # a sliced model's logits are the rank's vocab block
        return F.linear(hidden if mp is None else mp.column_in(hidden), w.T)

    def loss(self, logits, labels):
        """Causal LM loss: logits[:, :-1] vs labels[:, 1:] (over the
        vocab-split logits of a sliced model, the vocab-parallel cross
        entropy)."""
        return _causal_lm_loss(self, logits, labels)

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

    # ---- functional decomposition (the JAX SpmdTrainStep contract) ----
    def functional_decompose(self):
        """``{"params", "specs", "fns", "num_layers"}``, the JAX schema:
        ``params`` {"embed": the embeddings' parameters, "blocks": the
        block parameters stacked on a leading layer axis (the block
        state-dict names), "head": the final LayerNorm's}, ``specs``
        their mesh axes (a block leaf's with ``"pp"`` in front), ``fns``
        (embed_fn(p, ids), block_fn(p, hidden), head_fn(p, hidden,
        embed_p), loss_fn(logits, labels)), each a pure function of its
        parameters through ``torch.func.functional_call``.  The LM head
        is tied: ``head_fn`` multiplies by ``embed_p["word_embeddings.
        weight"]``'s transpose.  ``block_fn`` runs the first block as the
        template in the mode the model is in now and restores the
        template's own mode after; its ``generators`` are the dropout
        generators a caller reseeds per layer, (generator, salt) pairs
        (``parallel.pipeline``).
        On a model sliced over mp the functions run the Megatron
        collectives the forward does and the logits are the rank's vocab
        block, which ``loss_fn`` takes through the vocab-parallel cross
        entropy.  The serving engine reads ``params``."""
        from torch.func import functional_call

        emb = self.gpt.embeddings
        blocks = list(self.gpt.h)
        template = blocks[0]
        ln_f = self.gpt.ln_f
        tparams = dict(template.named_parameters())
        stacked = {name: torch.stack([dict(b.named_parameters())[name]
                                      .detach() for b in blocks])
                   for name in tparams}

        def axes_of(p):
            return getattr(p, "mesh_axes", None)

        training = self.training
        model = self

        def embed_fn(p, input_ids):
            return functional_call(emb, p, (input_ids,))

        def block_fn(p, hidden):
            prev = template.training
            template.train(training)
            try:
                return functional_call(template, p, (hidden,))
            finally:
                template.train(prev)

        mp = mp_layers.mp_of(self)
        block_fn.generators = [(g, 0) for g in {
            id(m.generator): m.generator for m in template.modules()
            if isinstance(getattr(m, "generator", None),
                          torch.Generator)}.values()]
        if mp is not None and mp.generator is not None:
            block_fn.generators.append((mp.generator, 1 + mp.rank))

        def head_fn(p, hidden, embed_p):
            h = functional_call(ln_f, p, (hidden,))
            w = embed_p["word_embeddings.weight"]
            mp_ = mp_layers.mp_of(model)
            return F.linear(h if mp_ is None else mp_.column_in(h), w.T)

        def loss_fn(logits, labels):
            return _causal_lm_loss(model, logits, labels)

        return {
            "params": {
                "embed": {k: v.detach()
                          for k, v in emb.named_parameters()},
                "blocks": stacked,
                "head": {k: v.detach()
                         for k, v in ln_f.named_parameters()},
            },
            "specs": {
                "embed": {k: axes_of(v) for k, v in emb.named_parameters()},
                "blocks": {n: ("pp",) + tuple(axes_of(p) or
                                              (None,) * p.dim())
                           for n, p in tparams.items()},
                "head": {k: None for k, _ in ln_f.named_parameters()},
            },
            "fns": (embed_fn, block_fn, head_fn, loss_fn),
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


def _causal_lm_loss(model, logits, labels):
    """The shifted-label cross entropy of GPT and Llama."""
    flat = logits[:, :-1, :].reshape(-1, logits.shape[-1])
    shifted = labels[:, 1:].reshape(-1)
    mp = mp_layers.mp_of(model)
    return mp_layers.parallel_cross_entropy(
        flat, shifted, None if mp is None else mp.group)


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


def gpt_350m(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_attention_heads=16, max_position_embeddings=1024)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)


def gpt_1_3b(device=None, seed=0, dtype=torch.float32, **kw):
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_attention_heads=32, max_position_embeddings=2048)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)


def gpt_6_7b(device=None, seed=0, dtype=torch.float32, **kw):
    """The JAX package's north-star pretrain config (hidden 4096: its
    LayerNorms take the wide-row kernels, its attention D 128)."""
    cfg = dict(vocab_size=50304, hidden_size=4096, num_layers=32,
               num_attention_heads=32, max_position_embeddings=2048)
    cfg.update(kw)
    return GPTForCausalLM(GPTConfig(**cfg), device=device, seed=seed,
                          dtype=dtype)
