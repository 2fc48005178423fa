"""Quality gate for approximate serving modes (int8 KV cache).

Port of ``paddle_tpu/inference/llm/quality.py``.  Weight-only int8
keeps the matmul in the activation dtype, but an int8 K/V pool changes
what attention reads, so its output is not token-exact against the
full-precision engine.  This module measures the gap:

- :func:`engine_logits` — dense teacher-forced forward straight over
  ``engine.params`` (dequantizing ``<key>_scale`` weight leaves and
  applying the pool's per-(token, head) int8 round trip to k and v when
  the engine's KV cache is quantized), so two engines score the same
  token sequence with their own numerics;
- :func:`quality_report` — greedy agreement over real ``generate``
  runs, plus teacher-forced perplexity and top-1/top-k next-token
  agreement between a reference engine and a test engine.

It runs on the engine's own device; the results come back to the host
as numpy.
"""

# noqa-module: H001 (the quality report is an offline harness by design —
# it pulls logits and token ids to the host to score them; nothing here
# runs on the serving step path)

import numpy as np
import torch

from ...incubate.nn import _layernorm
from .quant import dequantize_kv_rows, quantize_kv_rows


@torch.no_grad()
def engine_logits(engine, token_ids):
    """Teacher-forced logits [T, V] (f32 numpy) for one token sequence,
    computed densely from ``engine.params`` with the engine's numerics:
    quantized weights dequantize at the operand load (the engine's own
    ``_wmat``) and, when the engine runs an int8 KV pool, k/v pass
    through the per-(token, head) int8 round trip the pool applies, so
    the dense score reflects what the paged kernel attends over.  It
    runs on tp=1 engines only, as the JAX one does: a tensor-parallel
    engine's params are rank 0's shard."""
    if getattr(engine, "tp", 1) != 1:
        raise ValueError("engine_logits runs on tp=1 engines")
    params = engine.params
    blocks, emb = params["blocks"], params["embed"]
    dtype, eps, wmat = engine.dtype, engine.eps, engine._wmat
    nh, hd = engine.num_heads, engine.head_dim
    dev = emb["word_embeddings.weight"].device
    ids = torch.as_tensor(np.asarray(token_ids, np.int64), device=dev)
    t = ids.shape[0]

    x = (emb["word_embeddings.weight"][ids]
         + emb["position_embeddings.weight"][torch.arange(t, device=dev)])
    x = x.to(dtype)[None]                             # [1, T, hidden]
    scale = 1.0 / float(np.sqrt(np.float32(hd)))
    mask = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    for li in range(engine.num_layers):
        p_l = {k: v[li] for k, v in blocks.items()}
        hh = _layernorm(x, p_l["ln_1.weight"], p_l["ln_1.bias"], eps)
        qkv = hh @ wmat(p_l, "attn.qkv.weight") \
            + p_l["attn.qkv.bias"]
        qkv = qkv.reshape(1, t, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if engine._kv_quant:
            k = dequantize_kv_rows(*quantize_kv_rows(k)).to(k.dtype)
            v = dequantize_kv_rows(*quantize_kv_rows(v)).to(v.dtype)
        logits = torch.einsum("btnd,bsnd->bnts", q.float(),
                              k.float()) * scale
        logits = torch.where(mask[None, None], logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        att = torch.einsum("bnts,bsnd->btnd", p, v.float())
        att = att.reshape(1, t, nh * hd).to(dtype)
        x = x + att @ wmat(p_l, "attn.proj.weight") \
            + p_l["attn.proj.bias"]
        h2 = _layernorm(x, p_l["ln_2.weight"], p_l["ln_2.bias"], eps)
        ff = torch.nn.functional.gelu(
            h2 @ wmat(p_l, "mlp.fc_in.weight")
            + p_l["mlp.fc_in.bias"], approximate="tanh")
        x = x + ff @ wmat(p_l, "mlp.fc_out.weight") \
            + p_l["mlp.fc_out.bias"]

    x = _layernorm(x, params["head"]["weight"], params["head"]["bias"], eps)
    w = emb["word_embeddings.weight"]
    return (x @ w.T.to(dtype))[0].float().cpu().numpy()


def _perplexity(logits, ids):
    """exp(mean NLL) of each next token under the previous position's
    logits — scored over positions 1..T-1."""
    lp = torch.log_softmax(torch.as_tensor(logits[:-1], dtype=torch.float32),
                           dim=-1)
    nll = -lp[torch.arange(len(ids) - 1),
              torch.as_tensor(np.asarray(ids[1:], np.int64))]
    return float(torch.exp(nll.mean()))


def quality_report(ref_engine, test_engine, prompts, *, max_new_tokens=16,
                   top_k=5):
    """Compare a quantized engine against its full-precision twin.

    Three views, all over the same prompts:

    - ``greedy_agreement``: both engines ``generate`` greedily; the
      fraction of generated positions where the tokens match;
    - ``perplexity_ref`` / ``perplexity_test`` / ``perplexity_delta``:
      teacher-forced over the reference continuations, so both engines
      score identical sequences (delta = test - ref);
    - ``top1_agreement`` / ``topk_agreement``: per-position argmax
      match, and the fraction of positions where the reference argmax
      is in the test engine's top ``top_k``.
    """
    ref_out = ref_engine.generate(prompts, max_new_tokens=max_new_tokens)
    test_out = test_engine.generate(prompts, max_new_tokens=max_new_tokens)

    greedy_hits = greedy_total = 0
    ppl_ref, ppl_test = [], []
    top1_hits = topk_hits = pos_total = 0
    for prompt, ro, to in zip(prompts, ref_out, test_out):
        ro, to = np.asarray(ro), np.asarray(to)
        gen_r, gen_t = ro[len(prompt):], to[len(prompt):]
        n = min(len(gen_r), len(gen_t))
        greedy_hits += int(np.sum(gen_r[:n] == gen_t[:n]))
        greedy_total += n

        lr = engine_logits(ref_engine, ro)
        lt = engine_logits(test_engine, ro)
        ppl_ref.append(_perplexity(lr, ro))
        ppl_test.append(_perplexity(lt, ro))
        # the generated region: positions whose next token was
        # generated, logits rows len(prompt)-1 .. len(ro)-2
        rows = np.arange(len(prompt) - 1, len(ro) - 1)
        ref_arg = np.argmax(lr[rows], -1)
        test_arg = np.argmax(lt[rows], -1)
        top1_hits += int(np.sum(ref_arg == test_arg))
        order = np.argsort(lt[rows], -1)[:, ::-1][:, :top_k]
        topk_hits += int(np.sum(order == ref_arg[:, None]))
        pos_total += len(rows)

    pr, pt = float(np.mean(ppl_ref)), float(np.mean(ppl_test))
    return {
        "prompts": len(prompts),
        "positions": int(pos_total),
        "greedy_agreement": greedy_hits / max(greedy_total, 1),
        "perplexity_ref": pr,
        "perplexity_test": pt,
        "perplexity_delta": pt - pr,
        "top1_agreement": top1_hits / max(pos_total, 1),
        "topk_agreement": topk_hits / max(pos_total, 1),
        "top_k": int(top_k),
    }
