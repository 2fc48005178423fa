"""incubate.nn — the fused inference transformer (KV-cache decode).

Port of ``paddle_tpu/incubate/nn/__init__.py``.  ``FusedMultiTransformer``
runs the decoder stack of a GPT model over dense per-layer K/V caches
``[L, B, max_length, nh, hd]`` updated in place.  A prefill chunk
(T > 1) is the masked composition ``_block_chunk``; a one-token decode
step calls ``ragged_decode_attention`` with ``lengths = offset + 1``,
which reaches the dense-cache decode kernel on the card.  That is the
port's counterpart of the JAX program, where the ``decode_attention``
IR pass (``framework/ir.py``) swaps the T = 1 attention for the same
kernel; the IR pass machinery itself is tooling-slice work.

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


def _block_chunk(p, x, ck, cv, offset, num_heads, eps):
    """One decoder block over a chunk, in place on the caches.

    x [B, T, H]; ck / cv [B, S_max, nh, hd]; ``offset`` tokens are
    already cached.  The chunk's k/v land at [offset:offset+T]; T > 1
    attends densely over every cached position with future and unwritten
    slots masked, T == 1 goes through ``ragged_decode_attention``."""
    b, t, h = x.shape
    hd = h // num_heads
    s_max = ck.shape[1]

    hh = _fused_layernorm(x, p["ln_1.weight"], p["ln_1.bias"], eps)
    qkv = hh @ p["attn.qkv.weight"] + p["attn.qkv.bias"]
    qkv = qkv.reshape(b, t, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    ck[:, offset:offset + t] = k.to(ck.dtype)
    cv[:, offset:offset + t] = v.to(cv.dtype)

    if t == 1:
        lengths = torch.full((b,), offset + 1, dtype=torch.int32,
                             device=x.device)
        out = ragged_decode_attention(q[:, 0].contiguous(), ck, cv, lengths)
        out = out.to(x.dtype).reshape(b, 1, h)
    else:
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
        out = out.reshape(b, t, h)
    x = x + out @ p["attn.proj.weight"] + p["attn.proj.bias"]

    h2 = _fused_layernorm(x, p["ln_2.weight"], p["ln_2.bias"], eps)
    ff = torch.nn.functional.gelu(h2 @ p["mlp.fc_in.weight"]
                                  + p["mlp.fc_in.bias"], approximate="tanh")
    return x + ff @ p["mlp.fc_out.weight"] + p["mlp.fc_out.bias"]


class FusedMultiTransformer:
    """KV-cache decoder over a GPTForCausalLM (anything with
    ``functional_decompose`` and ``config``).

    >>> fmt = FusedMultiTransformer(model, max_length=256)
    >>> out_ids = fmt.generate(input_ids, max_new_tokens=64)

    ``device=None`` runs on CUDA and raises when it is missing;
    ``device="cpu"`` runs the plain PyTorch path.  ``dtype`` (float32 by
    default, or bfloat16) is the params', activations' and caches'.
    ``decode_steps`` counts the one-token steps run so far.
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

    def init_cache(self, batch):
        """Zeroed K and V caches [L, batch, max_length, nh, hd]."""
        shape = (self.num_layers, batch, self.max_length, self.num_heads,
                 self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    @torch.no_grad()
    def _forward_chunk(self, ids, ck, cv, offset):
        """ids [B, T] at positions offset..offset+T-1 -> logits of the
        last token [B, V]; the chunk's k/v are written into the caches."""
        emb = self.params["embed"]
        pos = torch.arange(offset, offset + ids.shape[1], device=self.device)
        x = (emb["word_embeddings.weight"][ids]
             + emb["position_embeddings.weight"][pos][None])
        x = x.to(self.dtype)
        for i, p_l in enumerate(self._layers):
            x = _block_chunk(p_l, x, ck[i], cv[i], offset, self.num_heads,
                             self.eps)
        if ids.shape[1] == 1:
            self.decode_steps += 1
        x = _layernorm(x, self.params["head"]["weight"],
                       self.params["head"]["bias"], self.eps)
        return x[:, -1] @ emb["word_embeddings.weight"].T.to(self.dtype)

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
        ck, cv = self.init_cache(b)
        logits = self._forward_chunk(
            torch.as_tensor(ids.astype(np.int64), device=self.device), ck,
            cv, 0)
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
            logits = self._forward_chunk(
                torch.as_tensor(cur_np[:, None].astype(np.int64),
                                device=self.device), ck, cv, t + step)
        return np.concatenate(out, axis=1)
