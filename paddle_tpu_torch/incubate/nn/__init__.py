"""incubate.nn — the fused inference transformer (KV-cache decode).

Port of ``paddle_tpu/incubate/nn/__init__.py``.  ``FusedMultiTransformer``
runs the decoder stack of a GPT model over dense per-layer K/V caches
``[L, B, max_length, nh, hd]`` updated in place.  A prefill chunk
(T > 1) is the masked composition ``_block_chunk``; a one-token decode
step (``_block_decode``) calls ``ragged_decode_attention`` with
``lengths = offset + 1``, which reaches the dense-cache decode kernel on
the card.  That is the port's counterpart of the JAX program, where the
``decode_attention`` IR pass (``framework/ir.py``) swaps the T = 1
attention for the same kernel; the IR pass machinery itself is
tooling-slice work.

The decode step takes its offset as a device tensor, as the JAX
``_decode`` traces it, so one step body serves every position: on CUDA
``generate`` captures it once per batch size as a CUDA graph
(``jit/graphs.py``) over caches the FMT keeps per batch size (the
counterpart of the JAX ``_decode`` donating its caches) and replays it
every decode step; the CPU runs the same body eagerly.  Prefill runs
eagerly, once per call.

``_layernorm`` is the LayerNorm composition the serving engine shares
and the head runs.  The block's two LayerNorms are ``_fused_layernorm``,
which computes as the JAX program does once its ``fuse_layernorm`` IR
pass has replaced them: statistics and affine in f32, then a cast back
to the activation dtype (in f32 the two agree).
"""

import math

import numpy as np
import torch

from ...framework.device import resolve_device
from ...jit.graphs import StepGraphs
from . import functional  # noqa: F401
from .functional import ragged_decode_attention

__all__ = ["FusedMultiTransformer", "functional"]

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, torch.float32: torch.float32,
           torch.bfloat16: torch.bfloat16}


def _layernorm(x, w, b, eps):
    """LayerNorm over the last dim as the serving step composes it:
    mean, then ``mean((x - mu) ** 2)``, then ``rsqrt``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _fused_layernorm(x, w, b, eps):
    """LayerNorm over the last dim as ``fuse_layernorm``'s ``apply``
    (``paddle_tpu/framework/ir.py``) computes it: x, w and b upcast to
    f32, mean, ``mean((x - mu) ** 2)``, ``rsqrt``, the affine, then cast
    back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _qkv(p, x, num_heads, eps):
    """A block's first LayerNorm and QKV projection -> q, k, v, each
    [B, T, nh, hd] views."""
    b, t, h = x.shape
    hh = _fused_layernorm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = hh @ p["attn.qkv.weight"] + p["attn.qkv.bias"]
    qkv = qkv.reshape(b, t, 3, num_heads, h // num_heads)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _block_tail(p, x, out, eps):
    """The attention output projection, residual and MLP of a block."""
    x = x + out @ p["attn.proj.weight"] + p["attn.proj.bias"]
    h2 = _fused_layernorm(x, p["ln_2.weight"], p["ln_2.bias"], eps)
    ff = torch.nn.functional.gelu(h2 @ p["mlp.fc_in.weight"]
                                  + p["mlp.fc_in.bias"], approximate="tanh")
    return x + ff @ p["mlp.fc_out.weight"] + p["mlp.fc_out.bias"]


def _block_chunk(p, x, ck, cv, offset, num_heads, eps):
    """One decoder block over a chunk, in place on the caches.

    x [B, T, H]; ck / cv [B, S_max, nh, hd]; ``offset`` (an int) tokens
    are already cached.  The chunk's k/v land at [offset:offset+T]; T > 1
    attends densely over every cached position with future and unwritten
    slots masked, T == 1 is :func:`_block_decode` at ``offset``."""
    b, t, h = x.shape
    if t == 1:
        off = torch.full((1,), offset, dtype=torch.int64, device=x.device)
        return _block_decode(p, x, ck, cv, off, num_heads, eps)
    hd = h // num_heads
    s_max = ck.shape[1]
    q, k, v = _qkv(p, x, num_heads, eps)
    ck[:, offset:offset + t] = k.to(ck.dtype)
    cv[:, offset:offset + t] = v.to(cv.dtype)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqnd,bknd->bnqk", q, ck.to(x.dtype)) * scale
    q_pos = offset + torch.arange(t, device=x.device)[:, None]
    k_pos = torch.arange(s_max, device=x.device)[None, :]
    mask = (k_pos <= q_pos)[None, None]
    logits = torch.where(mask, logits,
                         torch.tensor(-1e30, dtype=x.dtype,
                                      device=x.device))
    att = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", att, cv.to(x.dtype))
    return _block_tail(p, x, out.reshape(b, t, h), eps)


def _block_decode(p, x, ck, cv, off, num_heads, eps):
    """One decoder block over one token a sequence, in place on the
    caches, at the device offset ``off`` (int64 [1]): k/v land by
    ``index_copy_`` at ``off`` and ``lengths = off + 1`` is formed on the
    device, so no host int enters (the form a CUDA graph captures)."""
    b, _, h = x.shape
    q, k, v = _qkv(p, x, num_heads, eps)
    ck.index_copy_(1, off, k.to(ck.dtype))
    cv.index_copy_(1, off, v.to(cv.dtype))
    lengths = (off + 1).to(torch.int32).expand(b).contiguous()
    out = ragged_decode_attention(q[:, 0].contiguous(), ck, cv, lengths)
    return _block_tail(p, x, out.to(x.dtype).reshape(b, 1, h), eps)


class FusedMultiTransformer:
    """KV-cache decoder over a GPTForCausalLM (anything with
    ``functional_decompose`` and ``config``).

    >>> fmt = FusedMultiTransformer(model, max_length=256)
    >>> out_ids = fmt.generate(input_ids, max_new_tokens=64)

    ``device=None`` runs on CUDA and raises when it is missing;
    ``device="cpu"`` runs the plain PyTorch path.  ``dtype`` (float32 by
    default, or bfloat16) is the params', activations' and caches'.
    ``decode_steps`` counts the one-token steps run so far.  On CUDA each
    batch size's first decode step captures the step as a CUDA graph and
    later ones replay it.
    """

    def __init__(self, model, max_length=1024, dtype=None, device=None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32 or bfloat16, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.dtype = _DTYPES[dtype]
        d = model.functional_decompose()
        cfg = model.config
        self.num_layers = d["num_layers"]
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.hidden = cfg.hidden_size
        self.eps = cfg.layer_norm_epsilon
        self.max_length = int(min(max_length, cfg.max_position_embeddings))

        def cast(x):
            x = x.detach().to(self.device)
            return x.to(self.dtype) if x.is_floating_point() else x

        self.params = {g: {k: cast(v) for k, v in sub.items()}
                       for g, sub in d["params"].items()}
        blocks = self.params["blocks"]
        self._layers = [{k: v[i] for k, v in blocks.items()}
                        for i in range(self.num_layers)]
        self.decode_steps = 0
        # batch size -> (k cache, v cache) the decode graphs write
        self._caches = {}
        # one captured graph of the decode step per batch size (CUDA)
        self._graphs = StepGraphs(self._decode_body, self.device)

    def init_cache(self, batch):
        """Zeroed K and V caches [L, batch, max_length, nh, hd]."""
        shape = (self.num_layers, batch, self.max_length, self.num_heads,
                 self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def _cache(self, batch):
        """The zeroed caches owned for ``batch``: allocated at its first
        use, then reused, so a captured decode graph keeps its
        addresses."""
        if batch not in self._caches:
            self._caches[batch] = self.init_cache(batch)
        else:
            for c in self._caches[batch]:
                c.zero_()
        return self._caches[batch]

    @torch.no_grad()
    def _forward_chunk(self, ids, ck, cv, offset):
        """ids [B, T] at positions offset..offset+T-1 (``offset`` an int)
        -> logits of the last token [B, V]; the chunk's k/v are written
        into the caches."""
        emb = self.params["embed"]
        pos = torch.arange(offset, offset + ids.shape[1], device=self.device)
        x = (emb["word_embeddings.weight"][ids]
             + emb["position_embeddings.weight"][pos][None])
        x = x.to(self.dtype)
        for i, p_l in enumerate(self._layers):
            x = _block_chunk(p_l, x, ck[i], cv[i], offset, self.num_heads,
                             self.eps)
        return self._head(x)

    def _head(self, x):
        emb = self.params["embed"]
        x = _layernorm(x, self.params["head"]["weight"],
                       self.params["head"]["bias"], self.eps)
        return x[:, -1] @ emb["word_embeddings.weight"].T.to(self.dtype)

    @torch.no_grad()
    def _decode_body(self, buf):
        """The decode step body: ``buf`` int64 [B + 1] on the device holds
        the B tokens, then the offset they sit at; runs one token a
        sequence through the caches owned for B -> logits [B, V].

        What a CUDA graph captures per batch size and the CPU runs as it
        is: device tensors only, no host int, no counter."""
        b = buf.shape[0] - 1
        ids, off = buf[:b, None], buf[b:]
        ck, cv = self._caches[b]
        emb = self.params["embed"]
        x = (emb["word_embeddings.weight"][ids]
             + emb["position_embeddings.weight"][off][None])
        x = x.to(self.dtype)
        for i, p_l in enumerate(self._layers):
            x = _block_decode(p_l, x, ck[i], cv[i], off, self.num_heads,
                              self.eps)
        return self._head(x)

    def _decode_step(self, tokens, offset):
        """One decode step of the caches owned for ``len(tokens)``: the
        host tokens [B] at position ``offset`` -> logits [B, V].  On CUDA
        the logits are the graph's static outputs, which the next replay
        overwrites: read them before the next step."""
        buf = np.append(np.asarray(tokens, np.int64), np.int64(offset))
        self.decode_steps += 1
        if self.device.type == "cuda":
            self._graphs.stage(len(tokens), buf)
            return self._graphs.run(len(tokens))
        return self._decode_body(torch.from_numpy(buf))

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, seed=0, eos_token_id=None):
        """Greedy (temperature 0) or top-k sampled generation.

        input_ids: [B, T] (or [T]) ints as numpy, a list or a tensor;
        returns a numpy array [B, T + new] of the input's integer dtype.
        Sampling draws from a ``torch.Generator`` seeded with ``seed``
        on the engine's device; a row that emitted ``eos_token_id``
        repeats it, and generation stops once every row has."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        b, t = ids.shape
        if t + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt {t} + new {max_new_tokens} exceeds max_length "
                f"{self.max_length}")
        ck, cv = self._cache(b)
        if t == 1:
            logits = self._decode_step(ids[:, 0], 0)
        else:
            logits = self._forward_chunk(
                torch.as_tensor(ids.astype(np.int64), device=self.device),
                ck, cv, 0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        out = [ids]
        finished = np.zeros(b, bool)
        for step in range(max_new_tokens):
            if temperature and temperature > 0.0:
                lg = logits.float() / temperature
                if top_k:
                    kth = torch.sort(lg, dim=-1).values[:, -int(top_k)]
                    lg = torch.where(lg < kth[:, None], -1e30, lg)
                cur = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                        generator=gen)[:, 0]
            else:
                cur = logits.argmax(dim=-1)
            cur_np = cur.cpu().numpy().astype(ids.dtype)
            if eos_token_id is not None:
                cur_np = np.where(finished, eos_token_id, cur_np)
                finished |= cur_np == eos_token_id
            out.append(cur_np[:, None])
            if step + 1 == max_new_tokens or (
                    eos_token_id is not None and finished.all()):
                break
            # the sampled tokens came to the host above, so the replay
            # may overwrite the last step's logits now
            logits = self._decode_step(cur_np, t + step)
        return np.concatenate(out, axis=1)
