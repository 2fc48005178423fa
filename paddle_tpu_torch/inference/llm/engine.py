"""LLMEngine — continuous-batching generation over a paged KV cache.

The KV cache is one paged pool ([L, num_blocks, block_size, Nh, D] per
K and V) shared by every in-flight request.  Each step, the scheduler's
work — decode rows and prefill chunks alike — is packed back to back
into one flat token batch padded to a power-of-two token bucket (floor
8, cap token_budget), with per-row ``(row_start, row_qlen, row_pos0)``
descriptors saying which tokens belong to whom.  One call of
:meth:`LLMEngine._ragged_fn` runs the whole step: each layer writes
the step's K/V through the rows' block tables and then attends over
every earlier position through the pool with the ragged paged
attention kernel (plain PyTorch for CPU tensors).  A decode row is a
one-token chunk, so one step genuinely mixes phases: decodes keep
flowing inside the same step that advances a long prompt's chunks.

Prefix caching rides on the block manager: every page a sequence
completes is registered under its prefix-chain hash, and admission
adopts matching pages at zero compute.

The pools are updated in place — the port's counterpart of the JAX
engine's buffer donation.  The only host sync of a step is the pull of
the step's argmax vector (plus the logits rows of requests that sample
with a temperature).

Host sampling stays on numpy ``RandomState`` streams exactly as in the
JAX engine (an engine stream from ``seed=``, one stream per request
``seed=``), so seeded output is comparable across the two packages.
"""

import time

import numpy as np
import torch

from ...framework.device import resolve_device
from ...incubate.nn import _layernorm
from .block_manager import BlockManager
from .faults import FinishReason
from .paged_attention import paged_ragged_attention
from .sampling import (
    apply_logits_pipeline,
    neutral_row_params,
    token_counts,
    validate_sampling,
)
from .scheduler import FINISHED, Request, Scheduler, bucket_size

_LIFECYCLE = "the serving-breadth slice (faults and request lifecycle)"
# JAX-engine keywords a later slice ports -> that slice
_LATER_ENGINE = {
    "tensor_parallel": "the tensor-parallel serving slice",
    "mesh": "the tensor-parallel serving slice",
    "speculative": "the serving-breadth slice (speculative decoding)",
    "quantize": "the serving-breadth slice (int8 serving)",
    "lora": "the serving-breadth slice (multi-LoRA)",
    "faults": _LIFECYCLE,
    "retry": _LIFECYCLE,
    "step_timeout_s": _LIFECYCLE,
    "max_queue": _LIFECYCLE,
    "record_step_gauges": _LIFECYCLE,
    "kv_tier": "the serving-breadth slice (hierarchical KV)",
    "lookahead": "the serving-breadth slice (async lookahead)",
    "memory_budget": "the tooling slice (memory model)",
    "clock": "the serving-breadth slice (simulator)",
    "detokenizer": "the serving-breadth slice (stop strings)",
}
_LATER_REQUEST = {
    "deadline_ms": _LIFECYCLE,
    "logprobs": "the serving-breadth slice (logprobs)",
    "stop": "the serving-breadth slice (stop strings)",
    "grammar": "the serving-breadth slice (structured decoding)",
    "n": "the serving-breadth slice (parallel sampling)",
    "adapter_id": "the serving-breadth slice (multi-LoRA)",
}
# the value of each later keyword that asks for nothing
_OFF = {"logprobs": 0, "n": 1, "lookahead": False,
        "record_step_gauges": False}
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, torch.float32: torch.float32,
           torch.bfloat16: torch.bfloat16}


def _reject_later(kwargs, table, where):
    for key, value in kwargs.items():
        if key not in table:
            raise TypeError(f"{where}() got an unexpected keyword "
                            f"argument {key!r}")
        if value != _OFF.get(key) and value is not None:
            raise NotImplementedError(
                f"{where}({key}=...) is not ported yet: it comes with "
                f"{table[key]}")


class RequestOutput:
    """One finished request: ids are numpy on the host.

    ``metrics`` holds host ``time.perf_counter`` stamps of the request's
    arrival, first emitted token and finish."""

    def __init__(self, request_id, prompt_ids, output_ids, finish_reason,
                 num_preemptions, metrics=None):
        self.request_id = request_id
        self.prompt_ids = np.asarray(prompt_ids)
        self.output_ids = np.asarray(output_ids)
        self.finish_reason = finish_reason
        self.num_preemptions = num_preemptions
        self.metrics = metrics or {}

    @property
    def ok(self):
        return FinishReason.is_done(self.finish_reason)

    @property
    def all_ids(self):
        if self.output_ids.size == 0:
            return np.array(self.prompt_ids)
        return np.concatenate([self.prompt_ids, self.output_ids])


class LLMEngine:
    """add_request()/step()/generate() over a GPTForCausalLM-compatible
    model (anything with ``functional_decompose`` and ``config``).

    >>> eng = LLMEngine(model, block_size=16, max_batch=8)
    >>> rid = eng.add_request([5, 6, 7], max_new_tokens=16)
    >>> while eng.has_unfinished():
    ...     for out in eng.step():
    ...         print(out.request_id, out.output_ids)

    ``device=None`` runs on CUDA and raises when it is missing;
    ``device="cpu"`` runs the plain PyTorch path.  ``dtype`` is float32
    (default) or bfloat16 for the params, activations and pools.
    ``seed=`` seeds the engine sampling stream (temperature > 0); a
    request's own ``seed=`` gives it an independent stream.
    """

    def __init__(self, model, *, block_size=16, num_blocks=None,
                 max_model_len=None, max_batch=8, dtype=None,
                 enable_prefix_caching=True, token_budget=64, seed=None,
                 device=None, **later):
        _reject_later(later, _LATER_ENGINE, "LLMEngine")
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
        self.eps = cfg.layer_norm_epsilon
        self.vocab_size = int(cfg.vocab_size)
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.max_model_len = int(min(max_model_len
                                     or cfg.max_position_embeddings,
                                     cfg.max_position_embeddings))
        self.max_pages = -(-self.max_model_len // self.block_size)
        if num_blocks is None:
            # default: the full batch at full length fits -> no preemption
            num_blocks = self.max_batch * self.max_pages
        if num_blocks < self.max_pages:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one max_model_len "
                f"sequence ({self.max_pages} pages)")
        self.num_blocks = int(num_blocks)
        # one decode token per running sequence must fit in the budget
        self.token_budget = max(int(token_budget), self.max_batch)
        self.block_manager = BlockManager(
            self.num_blocks, self.block_size,
            enable_prefix_caching=enable_prefix_caching)
        self.scheduler = Scheduler(self.block_manager,
                                   max_batch=self.max_batch,
                                   token_budget=self.token_budget)

        def cast(x):
            x = x.detach().to(self.device)
            return x.to(self.dtype) if x.is_floating_point() else x

        self.params = {g: {k: cast(v) for k, v in sub.items()}
                       for g, sub in d["params"].items()}
        blocks = self.params["blocks"]
        self._layers = [{k: v[i] for k, v in blocks.items()}
                        for i in range(self.num_layers)]
        cache_shape = (self.num_layers, self.num_blocks, self.block_size,
                       self.num_heads, self.head_dim)
        self._kc = torch.zeros(cache_shape, dtype=self.dtype,
                               device=self.device)
        self._vc = torch.zeros(cache_shape, dtype=self.dtype,
                               device=self.device)

        self._requests = {}
        self._next_id = 0
        self._first_token_at = {}
        self.seed = 0 if seed is None else int(seed)
        self._rng = np.random.RandomState(self.seed)
        # "launches" counts _ragged_fn calls, warmup included
        self.stats = {"steps": 0, "prefill_steps": 0, "decode_steps": 0,
                      "chunk_launches": 0, "tokens_generated": 0,
                      "mixed_steps": 0, "launches": 0}

    # ----------------------------------------------------------- requests --
    def add_request(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                    temperature=0.0, request_id=None, seed=None, top_k=0,
                    top_p=1.0, min_p=0.0, repetition_penalty=1.0,
                    presence_penalty=0.0, frequency_penalty=0.0,
                    logit_bias=None, **later):
        _reject_later(later, _LATER_REQUEST, "add_request")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        logit_bias, _ = validate_sampling(
            top_k, top_p, min_p, repetition_penalty, presence_penalty,
            frequency_penalty, logit_bias, 0, None, 1,
            vocab_size=self.vocab_size)
        if len(prompt) + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt {len(prompt)} + new {max_new_tokens} exceeds "
                f"max_model_len {self.max_model_len}")
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        req = Request(request_id=request_id, prompt_ids=tuple(prompt),
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      temperature=float(temperature),
                      seed=None if seed is None else int(seed),
                      top_k=int(top_k), top_p=float(top_p),
                      min_p=float(min_p),
                      repetition_penalty=float(repetition_penalty),
                      presence_penalty=float(presence_penalty),
                      frequency_penalty=float(frequency_penalty),
                      logit_bias=logit_bias,
                      arrival_time=time.perf_counter())
        self._requests[request_id] = req
        self.scheduler.add(req)
        return request_id

    def has_unfinished(self):
        return self.scheduler.has_unfinished()

    def prefix_cache_stats(self):
        """Host-side prefix-cache counters."""
        sch, bm = self.scheduler, self.block_manager
        hit = sch.prefix_hit_tokens
        return {"prompt_tokens": sch.prompt_tokens,
                "prefix_hit_tokens": hit,
                "hit_rate": hit / sch.prompt_tokens
                if sch.prompt_tokens else 0.0,
                "reused_blocks": bm.prefix_reused_blocks,
                "evictions": bm.prefix_evictions,
                "cached_blocks": bm.num_cached_blocks}

    # ------------------------------------------------------ device step --
    def _bucket_grid(self):
        """Every (kind, token bucket) a step can launch: powers of two
        from 8 up to the token budget."""
        tb = min(8, self.token_budget)
        while True:
            yield ("ragged", tb)
            if tb >= self.token_budget:
                break
            tb = min(tb * 2, self.token_budget)

    def _to_device(self, arr):
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.no_grad()
    def _ragged_fn(self, pk):
        """One ragged step over the packed operands ``pk`` (see
        :meth:`_pack_rows`).  Updates the K/V pools in place and returns
        (argmax [Tb], logits [Tb, V]) on the device.

        Padding tokens carry position -1; live tokens are packed at the
        head of the token axis, so the K/V writes take the first
        ``total`` tokens (a host int) and padding is never scattered.
        Every query's K/V lands before attention reads the pool."""
        tb, rmax, total = pk["tb"], self.max_batch, pk["total"]
        ints = self._to_device(pk["ints"])
        ids, positions, rows = ints[:tb], ints[tb:2 * tb], ints[2 * tb:3 * tb]
        desc = ints[3 * tb:]
        row_start, row_qlen, row_pos0 = (desc[:rmax], desc[rmax:2 * rmax],
                                         desc[2 * rmax:3 * rmax])
        tables = desc[3 * rmax:].view(rmax, self.max_pages)
        # the pools are written in place: the port's counterpart of the
        # JAX engine donating them to the step
        kc, vc = self._kc, self._vc
        if pk["cows"]:
            # copy-on-write page payloads before this step's writes land
            cow = torch.as_tensor(np.asarray(pk["cows"], np.int64).T,
                                  device=self.device)
            kc[:, cow[1]] = kc[:, cow[0]]
            vc[:, cow[1]] = vc[:, cow[0]]

        nb, bs, nh, hd = (self.num_blocks, self.block_size, self.num_heads,
                          self.head_dim)
        emb = self.params["embed"]
        p_safe = positions.clamp(min=0).long()
        x = (emb["word_embeddings.weight"][ids.long()]
             + emb["position_embeddings.weight"][p_safe])
        rows_l = rows.long()
        slots = (tables[rows_l[:total], p_safe[:total] // bs].long() * bs
                 + p_safe[:total] % bs)
        ctx = (p_safe + (positions >= 0)).to(torch.int32)
        for i, p_l in enumerate(self._layers):
            hh = _layernorm(x, p_l["ln_1.weight"], p_l["ln_1.bias"],
                            self.eps)
            qkv = (hh @ p_l["attn.qkv.weight"]
                   + p_l["attn.qkv.bias"]).view(tb, 3, nh, hd)
            kc[i].view(nb * bs, nh, hd)[slots] = qkv[:total, 1]
            vc[i].view(nb * bs, nh, hd)[slots] = qkv[:total, 2]
            out = paged_ragged_attention(qkv[:, 0].contiguous(), kc[i],
                                         vc[i], tables, ctx, rows,
                                         row_start, row_qlen, row_pos0)
            out = out.to(x.dtype).reshape(tb, nh * hd)
            x = x + out @ p_l["attn.proj.weight"] + p_l["attn.proj.bias"]
            h2 = _layernorm(x, p_l["ln_2.weight"], p_l["ln_2.bias"],
                            self.eps)
            pre = h2 @ p_l["mlp.fc_in.weight"] + p_l["mlp.fc_in.bias"]
            ff = torch.nn.functional.gelu(pre, approximate="tanh")
            x = x + ff @ p_l["mlp.fc_out.weight"] + p_l["mlp.fc_out.bias"]
        x = _layernorm(x, self.params["head"]["weight"],
                       self.params["head"]["bias"], self.eps)
        logits = x @ emb["word_embeddings.weight"].T
        if pk["pipeline"] is not None:
            # neutral knobs are exact identities, so a step without a
            # pipeline row skips the pipeline instead of running it
            knobs, bias, counts = pk["pipeline"]
            logits = apply_logits_pipeline(
                logits, rows, *(self._to_device(k) for k in knobs),
                self._to_device(bias), self._to_device(counts))
        self.stats["launches"] += 1
        return logits.argmax(-1), logits

    def warmup(self):
        """Run every token bucket once with dead rows (no page is
        written) so allocator pools and the kernel library are ready
        before traffic; returns ``{"ragged[<bucket>]": ms}``."""
        timings = {}
        for kind, tb in self._bucket_grid():
            t0 = time.perf_counter()
            self._ragged_fn(self._pack_rows([], tb))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[f"{kind}[{tb}]"] = (time.perf_counter() - t0) * 1e3
        return timings

    # ---------------------------------------------------------------- step --
    def step(self):
        """Run one scheduling iteration; returns the RequestOutputs
        finished by this step (possibly empty)."""
        finished = []
        batch = self.scheduler.schedule()
        if batch.kind == "idle":
            return finished
        self.stats["steps"] += 1
        self._ragged_step(batch, finished)
        return finished

    def _ragged_step(self, batch, finished):
        """One launch for the whole scheduled step: decode rows and
        prefill chunks pack into a single flat token batch; commits run
        decode rows in scheduler order first, then chunks in schedule
        order (the order seeded streams depend on)."""
        rows = [row for row in batch.rows
                if row.request.status != FINISHED]
        if not rows:
            return
        has_decode = any(row.kind != "chunk" for row in rows)
        has_chunk = any(row.kind == "chunk" for row in rows)
        if has_decode:
            self.stats["decode_steps"] += 1
        if has_chunk:
            self.stats["prefill_steps"] += 1
            self.stats["chunk_launches"] += \
                sum(1 for row in rows if row.kind == "chunk")
        if has_decode and has_chunk:
            self.stats["mixed_steps"] += 1
        self._launch_packed(rows, self._pack_ragged(rows, batch.cows),
                            finished)

    def _pack_rows(self, entries, tb, cows=()):
        """Pack ``(tokens, pos0, block_table)`` rows into one int32 host
        buffer: ids, positions, token->row map (``tb`` each), then
        row_start, row_qlen, row_pos0 (``max_batch`` each), then the
        ``[max_batch, max_pages]`` block tables — one host-to-device
        copy per step.  Unused tokens carry position -1, unused rows
        qlen 0."""
        rmax, pmax = self.max_batch, self.max_pages
        buf = np.zeros(3 * tb + 3 * rmax + rmax * pmax, np.int32)
        ids, positions, tok_rows = (buf[:tb], buf[tb:2 * tb],
                                    buf[2 * tb:3 * tb])
        d = 3 * tb
        row_start, row_qlen, row_pos0 = (buf[d:d + rmax],
                                         buf[d + rmax:d + 2 * rmax],
                                         buf[d + 2 * rmax:d + 3 * rmax])
        tables = buf[d + 3 * rmax:].reshape(rmax, pmax)
        positions[:] = -1
        starts, s = [], 0
        for ri, (toks, pos0, bt) in enumerate(entries):
            n = len(toks)
            starts.append(s)
            ids[s:s + n] = toks
            positions[s:s + n] = np.arange(pos0, pos0 + n)
            tok_rows[s:s + n] = ri
            tables[ri, :len(bt)] = bt
            row_start[ri] = s
            row_qlen[ri] = n
            row_pos0[ri] = pos0
            s += n
        return {"tb": tb, "total": s, "starts": starts, "ints": buf,
                "cows": list(cows), "pipeline": None}

    def _pack_ragged(self, rows, cows):
        """Pack one step's RaggedRows into host operands, plus the
        sampling pipeline's operands when a row uses it."""
        total = sum(row.length for row in rows)
        tb = bucket_size(total, self.token_budget, floor=8)
        entries = []
        for row in rows:
            req = row.request
            if row.kind == "chunk":
                toks = req.all_ids[row.start:row.start + row.length]
            else:
                toks = [req.all_ids[-1]]
            entries.append((toks, row.start,
                            self.block_manager.block_table(req.request_id)))
        pk = self._pack_rows(entries, tb, cows)
        pipe_rows = [(ri, row) for ri, row in enumerate(rows)
                     if row.request.uses_pipeline]
        if pipe_rows:
            v = self.vocab_size
            knobs = neutral_row_params(self.max_batch)
            top_k, top_p, min_p, rep_pen, pres_pen, freq_pen = knobs
            bias = np.zeros((tb, v), np.float32)
            counts = np.zeros((tb, v), np.float32)
            for ri, row in pipe_rows:
                req = row.request
                top_k[ri] = req.top_k
                top_p[ri] = req.top_p
                min_p[ri] = req.min_p
                rep_pen[ri] = req.repetition_penalty
                pres_pen[ri] = req.presence_penalty
                freq_pen[ri] = req.frequency_penalty
                if row.kind == "chunk" and not row.chunk.is_final:
                    continue           # no position samples this step
                p = pk["starts"][ri] + row.length - 1
                if (req.repetition_penalty != 1.0
                        or req.presence_penalty != 0.0
                        or req.frequency_penalty != 0.0):
                    counts[p] = token_counts(req.all_ids, v)
                for t, b in (req.logit_bias or {}).items():
                    bias[p, t] += b
            pk["pipeline"] = (knobs, bias, counts)
        return pk

    def _launch_packed(self, rows, pk, finished):
        """Launch one packed step and commit its tokens."""
        starts = pk["starts"]
        argmax, logits = self._ragged_fn(pk)
        nxt = argmax.cpu().numpy()          # the one host pull per step
        row_logits = self._fetch_sampling_rows(rows, starts, logits)
        # commit phase A: decode rows, in scheduler order
        entries = []
        for ri, row in enumerate(rows):
            if row.kind == "chunk":
                continue
            req = row.request
            req.num_cached += 1
            if req.num_cached % self.block_size == 0:
                self._register_full_blocks(req)
            lg = row_logits.get(ri)
            entries.append((req, nxt[starts[ri]],
                            None if lg is None else lg[0]))
        if entries:
            self._commit_tokens(entries, finished)
        # commit phase B: chunks in schedule order; only a final chunk's
        # last token emits
        for ri, row in enumerate(rows):
            if row.kind != "chunk":
                continue
            req, ch = row.request, row.chunk
            req.num_cached = ch.start + ch.length
            self._register_full_blocks(req)
            if ch.is_final:
                lg = row_logits.get(ri)
                self._commit_tokens(
                    [(req, nxt[starts[ri] + row.length - 1],
                      None if lg is None else lg[0])], finished)

    def _fetch_sampling_rows(self, rows, starts, logits):
        """Fetch only the logits rows of tokens that sample with a
        temperature: a greedy batch transfers just the argmax vector.
        Returns {row_index: [1, V] host array}."""
        idx, spans = [], {}
        for ri, row in enumerate(rows):
            if row.request.temperature <= 0.0:
                continue
            if row.kind == "chunk":
                if not row.chunk.is_final:
                    continue
                lo = starts[ri] + row.length - 1
            else:
                lo = starts[ri]
            spans[ri] = len(idx)
            idx.append(lo)
        if not spans:
            return {}
        sel = logits[torch.as_tensor(idx, device=logits.device)]
        sel = sel.float().cpu().numpy()
        return {ri: sel[o:o + 1] for ri, o in spans.items()}

    # --------------------------------------------------------- commits --
    def _register_full_blocks(self, req):
        """Make every completed full page of ``req`` hash-addressable."""
        bm = self.block_manager
        if not bm.enable_prefix_caching:
            return
        hashes = bm.prefix_chain_hashes(
            req.all_ids, limit=req.num_cached // self.block_size)
        for i, h in enumerate(hashes):
            bm.register_full_block(req.request_id, i, h)

    def _sample_token(self, req, logits):
        """Gumbel-max sample of one host logits row from the request's
        stream (``seed=``) or the engine stream."""
        z = np.asarray(logits, np.float64) / req.temperature
        if req.seed is not None:
            if req._sample_rng is None:
                req._sample_rng = np.random.RandomState(req.seed)
            rng = req._sample_rng
        else:
            rng = self._rng
        return int(np.argmax(z + rng.gumbel(size=z.shape)))

    def _commit_tokens(self, entries, finished):
        """Commit one token per (req, argmax, logits) entry, in order.
        Engine-stream sampling rows share one vectorized gumbel draw
        (bitwise the sequential per-row draws); per-request streams draw
        row by row."""
        eng_rows = [j for j, (r, _t, _lg) in enumerate(entries)
                    if r.temperature > 0.0 and r.seed is None]
        picked = {}
        if eng_rows:
            z = np.stack([np.asarray(entries[j][2], np.float64)
                          / entries[j][0].temperature for j in eng_rows])
            g = self._rng.gumbel(size=z.shape)
            for j, t in zip(eng_rows, np.argmax(z + g, axis=-1)):
                picked[j] = int(t)
        now = time.perf_counter()
        for j, (req, argmax_token, logits) in enumerate(entries):
            if req.temperature > 0.0:
                tok = picked[j] if j in picked \
                    else self._sample_token(req, logits)
            else:
                tok = int(argmax_token)
            req.output_ids.append(tok)
            if len(req.output_ids) == 1:
                self._first_token_at[req.request_id] = now
            self.stats["tokens_generated"] += 1
            if req.eos_token_id is not None and tok == req.eos_token_id:
                self._finish(req, FinishReason.STOP, finished)
            elif len(req.output_ids) >= req.max_new_tokens:
                self._finish(req, FinishReason.LENGTH, finished)

    def _finish(self, req, reason, finished):
        self.scheduler.remove_running(req)
        req.status = FINISHED
        req.finish_reason = reason
        del self._requests[req.request_id]
        metrics = {"arrival": req.arrival_time,
                   "first_token": self._first_token_at.pop(
                       req.request_id, None),
                   "finished": time.perf_counter()}
        finished.append(RequestOutput(
            req.request_id, req.prompt_ids, req.output_ids, reason,
            req.num_preemptions, metrics=metrics))

    # ----------------------------------------------------------- generate --
    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, seed=None, top_k=0, top_p=1.0,
                 min_p=0.0, repetition_penalty=1.0, presence_penalty=0.0,
                 frequency_penalty=0.0, logit_bias=None, **later):
        """Batch convenience: returns one [T+new] int64 array per prompt
        (request order preserved).  ``seed`` gives every request of this
        call its own deterministic sampling stream."""
        _reject_later(later, _LATER_REQUEST, "generate")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        validate_sampling(top_k, top_p, min_p, repetition_penalty,
                          presence_penalty, frequency_penalty, logit_bias,
                          0, None, 1, vocab_size=self.vocab_size)
        if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
            prompts = list(prompts)
        elif not isinstance(prompts, (list, tuple)):
            prompts = [prompts]
        order = [self.add_request(p, max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  temperature=temperature, seed=seed,
                                  top_k=top_k, top_p=top_p, min_p=min_p,
                                  repetition_penalty=repetition_penalty,
                                  presence_penalty=presence_penalty,
                                  frequency_penalty=frequency_penalty,
                                  logit_bias=logit_bias)
                 for p in prompts]
        outs = {}
        while self.has_unfinished():
            for fo in self.step():
                outs[fo.request_id] = fo
        return [outs[rid].all_ids.astype(np.int64) for rid in order]
