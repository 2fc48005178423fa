"""LLMEngine — continuous-batching generation over a paged KV cache.

The KV cache is one paged pool ([L, num_blocks, block_size, Nh, D] per
K and V) shared by every in-flight request.  Each step, the scheduler's
work — decode rows and prefill chunks alike — is packed back to back
into one flat token batch padded to a power-of-two token bucket (floor
8, cap token_budget), with per-row ``(row_start, row_qlen, row_pos0)``
descriptors saying which tokens belong to whom.  One call of the step
body :meth:`LLMEngine._ragged_body` runs the whole step: each layer
writes the step's K/V through the rows' block tables and then attends
over every earlier position through the pool with the ragged paged
attention kernel (plain PyTorch for CPU tensors).  A decode row is a
one-token chunk, so one step genuinely mixes phases: decodes keep
flowing inside the same step that advances a long prompt's chunks.

On CUDA the body is captured once per token bucket as a CUDA graph
(``jit/graphs.py``) — at :meth:`LLMEngine.warmup`, or at the bucket's
first step — and every step copies its packed operands into the
bucket's static buffer and replays the graph: the port's counterpart
of the JAX engine's one compiled executable per bucket.  On the CPU
the same body runs eagerly.  ``warmup()`` returns a ``CaptureWatcher``
over the step graphs, and ``executable_grid()`` yields each bucket's body
and operands for the analysis tools (``framework/analysis.py``,
``cost.py``, ``kernel_lint.py``), which trace it over fake tensors.

Prefix caching rides on the block manager: every page a sequence
completes is registered under its prefix-chain hash, and admission
adopts matching pages at zero compute.

With an int8 KV cache (``quantize=``) the pools are int8 with f32
scale pools beside them: each layer quantizes the step's live K/V rows
per (token, head) as it writes them, and attention runs the int8 twin
of the kernel, which dequantizes at the load.

The pools are updated in place — the port's counterpart of the JAX
engine's buffer donation.  Every token of a bucket writes its K/V, as in
the JAX step: a padding token's slot is a sink row past each layer's
visible pool (the JAX step's out-of-range slot, dropped there), so the
visible pools only ever hold live tokens.  The only host sync of a step
is the pull of the step's argmax vector (plus the logits rows of
requests that sample with a temperature or report logprobs).

Host sampling stays on numpy ``RandomState`` streams exactly as in the
JAX engine (an engine stream from ``seed=``, one stream per request
``seed=``), so seeded output is comparable across the two packages.

The request lifecycle is the JAX engine's: ``abort_request`` in any
state, ``deadline_ms`` on the engine's injectable clock, bounded
admission (``max_queue=``, shedding past it and while draining),
``drain``, and step isolation (:meth:`LLMEngine._launch`): injected
faults fire before the step touches the device, a retry policy absorbs
transient failures, a watchdog times each launch, and a launch that
still fails quarantines its request(s) with ``FinishReason.error``
while the rest keep serving.  Since the pools are written in place,
a failure after the step's first pool write cannot be retried into:
it raises :class:`~.faults.PoolLostError`.  :class:`AsyncLLMEngine`
steps an engine from one worker thread for servers
(``http_server.py``).

Speculative decoding (``speculative=``, ``spec.py``) is the JAX
engine's: a drafter proposes up to K tokens a decode row, the row
becomes a verify row ``[last] + drafts`` of the same ragged step, and
:meth:`LLMEngine._commit_verified` keeps the longest accepted prefix
plus the target's own token — token-exact against plain decode, one
gumbel draw per emitted token.  ``method="draft-model"`` / ``"tree"``
drafts with the target's first ``draft_layers`` blocks over draft pools
of their own (the same step body over a shorter layer list, captured by
a second :class:`~paddle_tpu_torch.jit.graphs.StepGraphs`); a tree row
scores the draft's runner-up first token on a copy-on-write fork.
``lookahead=True`` plans and packs step N+1 on the host while step N
runs on the card (:meth:`LLMEngine._stage_next`), between the replay's
dispatch and the blocking pull; the plan stays on the host until
:meth:`LLMEngine._claim_staged` validates it and patches in the query
tokens step N committed.

Multi-LoRA (``lora=``, ``lora.py``) is the JAX engine's: many tenants'
rank-r adapters share one mixed batch.  The adapter pools are stacked
block leaves allocated before :meth:`LLMEngine.warmup` and written only
in place, slot by slot, as the LRU of :class:`~.lora.AdapterManager`
loads an adapter a step needs; each row's slot rides the step's int32
operands, so the captured graphs serve every adapter.

The host-RAM KV tier (``kv_tier=``, ``kv_tier.py``) is the JAX engine's
too: a preempted request's page chain demotes to a bounded host pool and
swaps back in at re-admission instead of re-prefilling, and full pages
evicted from the prefix cache promote into a content-addressed host
store that admission adopts from.  Pages move by eager index ops on the
in-place pools, on the step's stream, and are synchronous host copies.

KV-page migration is the JAX engine's too, over the same page moves:
:meth:`LLMEngine.export_request` reads a running request's chain and
pages (read-only), :meth:`LLMEngine.import_request` writes them into
fresh pages of another engine's pools in place and resumes the request
mid-generation, :meth:`LLMEngine.release_request` forgets it on the
source, and :meth:`LLMEngine.adopt_waiting` takes a request into the
waiting queue (the fleet's tier reroute).  ``fleet.py`` builds replicas,
failover, drains and disaggregated prefill/decode on them;
``last_launches`` records each step's ``(kind, bucket)`` launches for the
simulator's clock (``paddle_tpu_torch/sim``).

Tensor parallelism (``tensor_parallel=`` / ``mesh=``,
``tensor_parallel.py``) is the JAX engine's Megatron layout over ranks
that are processes: this process is rank 0 and keeps the scheduler, the
BlockManager and sampling; each worker holds its shard of the weights
and pools of ``nh / tp`` heads.  Every step's packed operands go to
every rank, each runs the same step body (:class:`_StepShard`) with its
two all-reduces a layer, and rank 0 alone computes the head.  A tp > 1
step runs eagerly on every rank: no step graph is captured.  The tier's
and migration's page moves gather every rank's head slice to rank 0 and
scatter it back over the command channel, so their payloads hold the
global layout, and a request moves between engines of any tp.
"""

import copy
import math
import threading
import time
import warnings
import weakref
from collections import namedtuple

import numpy as np
import torch

from ...framework.cost import (
    derive_max_batch,
    engine_memory_model,
    page_bytes,
    params_bytes,
    parse_bytes,
)
from ...framework.analysis import CaptureWatcher
from ...incubate.nn import _layernorm
from ...jit.graphs import StepGraphs
from .block_manager import BlockManager, NoFreeBlocksError
from .faults import (
    FinishReason,
    InjectedFault,
    MigrationError,
    PoolLostError,
    RetryPolicy,
    StepWatchdog,
)
from .interleave import interleave_point, interleave_wait, masked
from .kv_tier import KVTierConfig
from .lora import AdapterManager, LoRAConfig, init_adapter_pools, lora_key
from .paged_attention import (
    paged_ragged_attention,
    paged_ragged_attention_quant,
)
from .quant import (
    ServingQuantConfig,
    quantize_block_weights,
    quantize_kv_rows,
    scale_key,
)
from .sampling import (
    StopStringWatcher,
    apply_logits_pipeline,
    neutral_row_params,
    token_counts,
    top_logprobs,
    validate_sampling,
)
from .scheduler import (
    FINISHED,
    RUNNING,
    WAITING,
    RaggedRow,
    Request,
    Scheduler,
    bucket_size,
)
from .spec import (
    DraftModelDrafter,
    NgramDrafter,
    SpeculativeConfig,
    rollback_draft_reservation,
)
from .structured import ConstraintState
from .tensor_parallel import (
    OP_DRAFT,
    OP_STEP,
    PAGES_KV,
    PAGES_SCALES,
    RankLostError,
    TPGroup,
    adapter_half_shard,
    pack_bytes,
    permute_qkv,
    qkv_head_permutation,
    rank_stats,
    resolve_mesh,
    shard_params,
    traced_psum,
    unpack_bytes,
)

# one model's paged K/V pools (LLMEngine._alloc_pools): the slot rows
# with their sink, the page views of them, and the int8 pool's scales
_Pools = namedtuple("_Pools", "k_rows v_rows kc vc ks_flat vs_flat ks vs")
# the head axis of a page move's pages: K/V [L, n, bs, Nh, D], scales
# [L, n, Nh, bs]
_HEAD_AXIS = {PAGES_KV: 3, PAGES_SCALES: 2}
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           torch.float32: torch.float32, torch.bfloat16: torch.bfloat16,
           torch.float16: torch.float16}


def alloc_pools(num_layers, num_blocks, block_size, num_heads, head_dim,
                kv_dtype, kv_quant, device):
    """Zeroed K/V pools of ``num_layers`` layers -> :data:`_Pools`
    (k_rows, v_rows, kc, vc, ks_flat, vs_flat, ks, vs).  Each layer's
    slots are ``[NB * bs + 1, Nh, D]``: the last row is the sink that
    padding tokens write; ``kc`` / ``vc`` ``[L, NB, bs, Nh, D]`` view the
    rest, so a layer's pool stays contiguous for the kernel.  An int8
    pool has per-(layer, page, head, slot) dequant scales, flat ``[L,
    (NB + 1) * Nh * bs]``: the sink slot's scale index lands on page NB,
    which ``ks`` / ``vs`` ``[L, NB, Nh, bs]`` leave out (None for a float
    pool).  ``Nh`` is a rank's heads under tensor parallelism."""
    nl, nb, bs, nh, hd = (num_layers, num_blocks, block_size, num_heads,
                          head_dim)
    k_rows, v_rows = (
        torch.zeros((nl, nb * bs + 1, nh, hd), dtype=kv_dtype,
                    device=device) for _ in range(2))
    ks_flat = vs_flat = None
    if kv_quant:
        ks_flat, vs_flat = (
            torch.zeros((nl, (nb + 1) * nh * bs), dtype=torch.float32,
                        device=device) for _ in range(2))
    return pool_views(k_rows, v_rows, ks_flat, vs_flat, num_blocks=nb,
                      block_size=bs)


def pool_views(k_rows, v_rows, ks_flat=None, vs_flat=None, *, num_blocks,
               block_size):
    """:data:`_Pools` over the slot rows (and an int8 pool's flat
    scales): the page views ``kc`` / ``vc`` and ``ks`` / ``vs`` of
    :func:`alloc_pools`, taken again (``executable_grid``'s bodies take
    the pools as inputs)."""
    nl, _, nh, hd = k_rows.shape
    nb, bs = num_blocks, block_size
    kc, vc = (rows[:, :nb * bs].view(nl, nb, bs, nh, hd)
              for rows in (k_rows, v_rows))
    ks = vs = None
    if ks_flat is not None:
        ks, vs = (flat.view(nl, nb + 1, nh, bs)[:, :nb]
                  for flat in (ks_flat, vs_flat))
    return _Pools(k_rows, v_rows, kc, vc, ks_flat, vs_flat, ks, vs)


def host_pages(t):
    """A host tensor of pages as the numpy array a page payload holds:
    bfloat16 pages as their int16 bit patterns (numpy has no bfloat16),
    float16 pages as numpy float16."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()  # noqa: H001 (tier / migration page moves are synchronous host copies by design)


def lora_delta(p_l, key, x, onehot):
    """Batched per-token adapter delta of one target GEMM: each token's
    ``(x @ A_s) @ B_s`` for its row's slot s, with the alpha/rank scale
    folded into the stored B — the JAX engine's ``lora_delta`` in another
    form: ``x`` against every slot's A half at once ([Tb, A, r]), zeroed
    outside each token's slot by ``onehot`` [Tb, A, 1], then one GEMM
    against the pool's B halves flattened to [A * r, out].  The zeroed
    slots add exact zeros, and no [Tb, in, r] gather of A or B is made.
    Slot 0 is all-zero, so base rows add exact float zeros."""
    a = p_l[lora_key(key, "A")]               # [A, in, r]
    b = p_l[lora_key(key, "B")]               # [A, r, out]
    h = torch.einsum("ti,air->tar", x, a) * onehot
    return h.reshape(x.shape[0], -1) @ b.reshape(-1, b.shape[-1])


class _StepShard:
    """What one rank's step body reads: its params (``{group: {key:
    tensor}}``, its shard under tensor parallelism), the per-layer views
    of the stacked block leaves, its K/V pools (and a draft model's), and
    the engine's dims and options from ``spec`` (see
    ``LLMEngine._shard_spec``).  The engine's rank 0 and every worker of
    ``tensor_parallel.py`` run :meth:`body` over one of these.

    ``psum`` is the row-parallel reduction (None at tp = 1, where the
    body is the one-card body unchanged); ``head`` whether the body
    computes the tied head's logits and argmax (rank 0 only)."""

    def __init__(self, params, pools, spec, device, psum=None, head=True):
        self.params = params
        self.pools = pools
        self.device = device
        self.psum = psum
        self.head = head
        self.rank, self.tp, self.perm = spec["rank"], spec["tp"], spec["perm"]
        self.num_blocks = spec["num_blocks"]
        self.block_size = spec["block_size"]
        self.num_heads = spec["num_heads"]
        self.head_dim = spec["head_dim"]
        self.eps = spec["eps"]
        self.max_batch = spec["max_batch"]
        self.max_pages = spec["max_pages"]
        self.dtype = spec["dtype"]
        self.w_quant = spec["w_quant"]
        self.kv_quant = spec["kv_quant"]
        self.lora = spec["lora"]
        blocks = params["blocks"]
        self.layers = [{k: v[i] for k, v in blocks.items()}
                       for i in range(spec["num_layers"])]
        self.draft_layers = self.draft_pools = None

    def set_draft(self, draft_layers, pools):
        """The draft model: the first ``draft_layers`` blocks over
        ``pools`` of their own."""
        self.draft_layers = self.layers[:draft_layers]
        self.draft_pools = pools

    def wmat(self, p_l, key):
        """A block GEMM's weight operand.  An int8 leaf dequantizes at the
        operand load in the activation dtype (``w8 * scale``, as the JAX
        engine's ``wmat``); the product is a transient of this step, and
        the int8 leaf stays the only resident copy."""
        w = p_l[key]
        if self.w_quant:
            return w.to(self.dtype) * p_l[scale_key(key)].to(self.dtype)
        return w

    @torch.no_grad()
    def body(self, ints, layers=None, pools=None, lora=True):
        """The step body: one ragged step over the packed int32 operands
        ``ints`` on the shard's device -> (argmax [Tb], logits [Tb, V]),
        through the blocks ``layers`` over the pools ``pools`` (by
        default the target's; the draft model passes its own).  On a LoRA
        engine with ``lora`` true the operands end with the rows' adapter
        slots, and each block GEMM adds its rows' adapter deltas
        (:func:`lora_delta`); the draft model runs without them, as the
        JAX draft runs on slot 0.

        What a CUDA graph captures per bucket and the CPU runs as it is:
        it reads device tensors only, takes every length from shapes (the
        bucket from ``ints``' length), copies nothing from the host and
        counts nothing.  Every token writes its K/V before attention
        reads the pool; padding tokens (position -1) write each layer's
        sink row (slot ``NB * bs``, the JAX step's dropped slot), so the
        visible pools see live tokens only.

        Under tensor parallelism the shard's qkv columns are its head
        group, its pools hold its heads, and the proj and fc_out partials
        (with a row target's adapter delta) are summed by ``psum`` before
        the bias, added once; a shard without the head returns (None,
        None)."""
        layers = self.layers if layers is None else layers
        k_rows, v_rows, kc, vc, ks_flat, vs_flat, ks, vs = (
            self.pools if pools is None else pools)
        lora = lora and self.lora is not None
        rmax, pmax = self.max_batch, self.max_pages
        tb = (ints.shape[0] - rmax * (3 + pmax + lora)) // 3
        ids, positions, rows = ints[:tb], ints[tb:2 * tb], ints[2 * tb:3 * tb]
        desc = ints[3 * tb:]
        row_start, row_qlen, row_pos0 = (desc[:rmax], desc[rmax:2 * rmax],
                                         desc[2 * rmax:3 * rmax])
        tables = desc[3 * rmax:3 * rmax + rmax * pmax].view(rmax, pmax)

        nb, bs, nh, hd = (self.num_blocks, self.block_size, self.num_heads,
                          self.head_dim)
        emb = self.params["embed"]
        live = positions >= 0
        p_safe = positions.clamp(min=0).long()
        x = (emb["word_embeddings.weight"][ids.long()]
             + emb["position_embeddings.weight"][p_safe])
        slots = torch.where(
            live, tables[rows.long(), p_safe // bs].long() * bs + p_safe % bs,
            nb * bs)
        targets = self.lora.targets if lora else ()
        onehot = None
        if lora:
            # each token's adapter slot as a one-hot over the pool's
            # slots (padding tokens on slot 0, the all-zero base slot)
            adapter_rows = desc[3 * rmax + rmax * pmax:]
            slots_t = torch.where(live, adapter_rows[rows.long()], 0)
            onehot = (slots_t[:, None] == torch.arange(
                self.lora.max_adapters, device=ints.device))[..., None]
            onehot = onehot.to(self.dtype)
        if self.kv_quant:
            # scale index of (slot, head): page * (Nkv * bs) + head * bs
            # + offset, in the [NB + 1, Nkv, bs] flat scale layout
            sidx = ((slots // bs)[:, None] * (nh * bs)
                    + torch.arange(nh, device=ints.device)[None, :] * bs
                    + (slots % bs)[:, None])
        wmat, psum = self.wmat, self.psum

        def delta(y, p_l, key, x_in):
            if key not in targets:
                return y
            return y + lora_delta(p_l, key, x_in, onehot)

        for i, p_l in enumerate(layers):
            hh = _layernorm(x, p_l["ln_1.weight"], p_l["ln_1.bias"],
                            self.eps)
            qkv = delta(hh @ wmat(p_l, "attn.qkv.weight")
                        + p_l["attn.qkv.bias"], p_l, "attn.qkv.weight", hh)
            qkv = qkv.view(tb, 3, nh, hd)
            q = qkv[:, 0].contiguous()
            if self.kv_quant:
                # quantize at append, per (token, head) row
                for rows_i, scales, val in (
                        (k_rows[i], ks_flat[i], qkv[:, 1]),
                        (v_rows[i], vs_flat[i], qkv[:, 2])):
                    q8, s = quantize_kv_rows(val)
                    rows_i[slots] = q8
                    scales[sidx] = s
                out = paged_ragged_attention_quant(
                    q, kc[i], vc[i], ks[i], vs[i], tables, None, None,
                    row_start, row_qlen, row_pos0)
            else:
                k_rows[i][slots] = qkv[:, 1]
                v_rows[i][slots] = qkv[:, 2]
                out = paged_ragged_attention(q, kc[i], vc[i], tables, None,
                                             None, row_start, row_qlen,
                                             row_pos0)
            out = out.to(x.dtype).reshape(tb, nh * hd)
            part = delta(out @ wmat(p_l, "attn.proj.weight"), p_l,
                         "attn.proj.weight", out)
            if psum is not None:
                part = psum(part)
            x = x + part + p_l["attn.proj.bias"]
            h2 = _layernorm(x, p_l["ln_2.weight"], p_l["ln_2.bias"],
                            self.eps)
            pre = delta(h2 @ wmat(p_l, "mlp.fc_in.weight")
                        + p_l["mlp.fc_in.bias"], p_l, "mlp.fc_in.weight", h2)
            ff = torch.nn.functional.gelu(pre, approximate="tanh")
            part = delta(ff @ wmat(p_l, "mlp.fc_out.weight"), p_l,
                         "mlp.fc_out.weight", ff)
            if psum is not None:
                part = psum(part)
            x = x + part + p_l["mlp.fc_out.bias"]
        if not self.head:
            return None, None
        x = _layernorm(x, self.params["head"]["weight"],
                       self.params["head"]["bias"], self.eps)
        logits = x @ emb["word_embeddings.weight"].T
        return logits.argmax(-1), logits

    def draft_body(self, ints):
        """The draft model's step body: :meth:`body` over the first
        ``draft_layers`` blocks and the draft pools, without adapters."""
        return self.body(ints, self.draft_layers, self.draft_pools,
                         lora=False)

    def page_pools(self, which):
        """The pools a page move of ``which`` reads and writes: the K and
        V pages [L, NB, bs, Nh, D] (:data:`PAGES_KV`) or an int8 pool's
        scale pages [L, NB, Nh, bs] (:data:`PAGES_SCALES`), Nh this
        rank's heads."""
        p = self.pools
        return (p.kc, p.vc) if which == PAGES_KV else (p.ks, p.vs)

    def page_move_shapes(self, which, n):
        """The shapes of this rank's slices of ``n`` pages of each pool
        of :meth:`page_pools`."""
        return [(pool.shape[0], n, *pool.shape[2:])
                for pool in self.page_pools(which)]

    def page_move_bytes(self, which, n):
        """Bytes of this rank's slice of ``n`` pages (:meth:`read_pages`)."""
        size = self.page_pools(which)[0].element_size()
        return size * sum(math.prod(shape)
                          for shape in self.page_move_shapes(which, n))

    def read_pages(self, which, block_ids):
        """This rank's slice of pages ``block_ids`` of each pool of
        :meth:`page_pools`, in ``block_ids`` order, as one host byte
        tensor: an index select on the device, then a synchronous copy of
        just those rows (queued after the step in flight)."""
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),  # noqa: H001 (block ids are a host list)
                              device=self.device)
        return pack_bytes([pool[:, idx].cpu()  # noqa: H001 (tier / migration page moves are synchronous host copies by design)
                           for pool in self.page_pools(which)])

    def write_pages(self, which, block_ids, buf):
        """Write this rank's slice of pages ``block_ids`` from the host
        bytes ``buf`` (as :meth:`read_pages` lays them out) into its
        pools in place, on the step's stream: a pool is never rebound."""
        pools = self.page_pools(which)
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),  # noqa: H001 (block ids are a host list)
                              device=self.device)
        vals = unpack_bytes(buf, self.page_move_shapes(which, len(idx)),
                            pools[0].dtype)
        for pool, v in zip(pools, vals):
            pool[:, idx] = v.to(pool.device)

    def copy_on_write(self, cows):
        """Copy each ``(src, dst)`` page's payload (and scales) in every
        layer, on the step's stream."""
        cow = torch.as_tensor(np.asarray(cows, np.int64).T,  # noqa: H001 (page pairs are a host list of ints)
                              device=self.device)
        for pool in (self.pools.kc, self.pools.vc, self.pools.ks,
                     self.pools.vs):
            if pool is not None:
                pool[:, cow[1]] = pool[:, cow[0]]

    def write_adapter_slot(self, slot, weights):
        """Write one adapter's host halves (this rank's part of each, see
        ``tensor_parallel.adapter_half_shard``) into pool slot ``slot`` of
        every layer, in place: ``copy_`` into the existing pool tensors
        on the engine's stream, so the write lands after every step
        already queued (one that still reads the evicted adapter) and
        before the next.  A pool tensor is never replaced: the captured
        graphs read it by address."""
        blocks = self.params["blocks"]
        for key, (a_h, b_h) in weights.items():
            for side, val in (("A", a_h), ("B", b_h)):
                if self.tp > 1:
                    val = adapter_half_shard(key, side, val, self.rank,
                                             self.tp, self.perm)
                pool = blocks[lora_key(key, side)]
                pool[:, slot].copy_(torch.from_numpy(val).to(pool.dtype))


def _check_deadline(deadline_ms):
    if deadline_ms is not None and (
            isinstance(deadline_ms, bool)
            or not isinstance(deadline_ms, (int, float, np.integer,
                                            np.floating))
            or deadline_ms <= 0):
        raise ValueError(f"deadline_ms must be a positive number of "
                         f"milliseconds, got {deadline_ms!r}")


class RequestOutput:
    """One finished request: ids are numpy on the host.

    ``finish_reason`` is one of :data:`~.faults.FinishReason.ALL`;
    ``ok`` is True for the "done" family (stop/length).  Aborted,
    deadline-missed, shed and quarantined requests carry a truncated
    (possibly empty) ``output_ids`` and, for ``error``, the failing
    step's message in ``error``.  ``logprobs`` holds per-token
    ``(chosen_logprob, [(tid, lp), ...])`` when the request asked for
    them; ``matched_stop`` the stop string that ended it.  ``metrics``
    holds the engine clock's stamps of the request's arrival, first
    emitted token (None before one) and finish."""

    def __init__(self, request_id, prompt_ids, output_ids, finish_reason,
                 num_preemptions, error=None, logprobs=None,
                 matched_stop=None, metrics=None):
        self.request_id = request_id
        self.prompt_ids = np.asarray(prompt_ids)  # noqa: H001 (RequestOutput holds host arrays by contract)
        self.output_ids = np.asarray(output_ids)  # noqa: H001 (RequestOutput holds host arrays by contract)
        self.finish_reason = finish_reason
        self.num_preemptions = num_preemptions
        self.error = error
        self.logprobs = logprobs
        self.matched_stop = matched_stop
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
    (default), bfloat16 or float16 for the params, activations and
    pools.
    ``seed=`` seeds the engine sampling stream (temperature > 0); a
    request's own ``seed=`` gives it an independent stream.

    ``quantize="int8"`` (or a dict / ServingQuantConfig) turns on int8
    serving: the four block GEMM weights are stored int8 with
    per-output-channel scales and dequantize at the operand load, and
    the paged K/V pool stores int8 slots with per-(page, head, slot)
    scales that the int8 ragged attention kernel dequantizes as it
    loads them.  ``{"weights": True, "kv_cache": False}`` keeps the
    float pools (and the full-precision kernel); ``{"weights": False,
    "kv_cache": True}`` keeps float weights.  ``memory_budget=`` (bytes
    or '16GiB'-style) derives the admissible ``max_batch`` from the
    memory model (:meth:`memory_model`) and clamps the requested one.

    Lifecycle: ``faults=`` (a :class:`~.faults.FaultInjector`),
    ``retry=`` (a RetryPolicy, its dict, or a max attempt count),
    ``step_timeout_s=`` (the watchdog's threshold), ``max_queue=`` (the
    waiting-queue depth past which requests are shed),
    ``record_step_gauges=`` (per-step cumulative counters in
    :meth:`lifecycle_stats`) and ``clock=`` (a callable giving seconds,
    optionally with ``sleep``: deadlines, retry backoff and the watchdog
    read it).  ``detokenizer=`` (ids -> str) enables ``stop=`` strings.

    ``speculative=`` (K, a method string, a dict or a
    :class:`~.spec.SpeculativeConfig`) turns on speculative decoding;
    ``lookahead=True`` plans each next step under the current one's
    device time (see the module docstring).

    ``lora=`` (max_adapters, a dict or a :class:`~.lora.LoRAConfig`)
    serves LoRA adapters registered with :meth:`add_adapter` to requests
    that name one (``add_request(adapter_id=)``).  ``kv_tier=`` (bytes,
    a dict or a :class:`~.kv_tier.KVTierConfig`) adds the host-RAM page
    tier; :meth:`tier_stats` reads it and :meth:`check_invariants`
    conserves pages across every tier after each step.

    ``tensor_parallel=N`` serves the model over N ranks, Megatron-sharded
    (``tensor_parallel.py``): on ``cuda:0..N-1``, or with ``device="cpu"``
    N ranks on the host; ``mesh=`` names each rank's device instead
    (``["cuda:0", "cuda:0"]`` puts two ranks on one card).  The
    attention heads and the MLP width must divide by N.  The host tier,
    migration, the analysis tools and fleets serve at tp > 1 as at
    tp = 1: a page payload is the global layout at every tp, and the
    tier's bytes are the global payload's (``page_bytes * tp``).
    """

    def __init__(self, model, *, block_size=16, num_blocks=None,
                 max_model_len=None, max_batch=8, dtype=None,
                 enable_prefix_caching=True, token_budget=64, seed=None,
                 memory_budget=None, quantize=None, faults=None,
                 retry=None, max_queue=None, step_timeout_s=None,
                 clock=None, record_step_gauges=False, detokenizer=None,
                 speculative=None, lookahead=False, lora=None, kv_tier=None,
                 device=None, tensor_parallel=None, mesh=None):
        # the ranks' devices (rank 0's is this engine's), before anything
        # is built or spawned
        devices = resolve_mesh(tensor_parallel, mesh, device)
        self.tp = len(devices)
        self._tp = None
        # lifecycle knobs first: a bad config fails at construction
        if max_queue is not None:
            if not isinstance(max_queue, (int, np.integer)) \
                    or isinstance(max_queue, bool) or max_queue < 1:
                raise ValueError(
                    f"max_queue must be a positive int (waiting-queue "
                    f"depth before load-shedding), got {max_queue!r}")
            max_queue = int(max_queue)
        self.max_queue = max_queue
        self.faults = faults
        self.retry = RetryPolicy.resolve(retry)
        if step_timeout_s is not None and (
                isinstance(step_timeout_s, bool)
                or not isinstance(step_timeout_s,
                                  (int, float, np.integer, np.floating))
                or step_timeout_s <= 0):
            raise ValueError(
                f"step_timeout_s must be a positive number of "
                f"seconds, got {step_timeout_s!r}")
        if detokenizer is not None and not callable(detokenizer):
            raise ValueError(
                f"detokenizer must be a callable(ids) -> str, "
                f"got {detokenizer!r}")
        self.detokenizer = detokenizer
        # deadlines and request stamps read _clock; step timing, retry
        # backoff and the watchdog read _timer and sleep on _sleep —
        # all the injected clock when one is given
        self._clock = clock if clock is not None else time.monotonic
        self._timer = clock if clock is not None else time.perf_counter
        self._sleep = getattr(clock, "sleep", time.sleep)
        if self.faults is not None:
            # injected delays stall on the clock the watchdog reads
            self.faults.sleep = self._sleep
        self.watchdog = (StepWatchdog(step_timeout_s, clock=self._timer)
                         if step_timeout_s is not None else None)
        self._early = []         # outputs finished without a device step
        self._draining = False
        self._step_index = -1
        # deterministic event log: (step, kind, *detail) tuples with no
        # wall time (events.py holds the record schema)
        self.events = []
        self.record_step_gauges = bool(record_step_gauges)
        self.step_gauges = []
        # bumped by every mutation that changes what the next schedule
        # would pick (admission, abort, finish, fork, quarantine)
        self._plan_epoch = 0
        # set once a launch attempt has written the pools (see _launch)
        self._writes_began = False
        # the wall-clock gauges are read from other threads (/healthz)
        # while the stepping thread writes them: a leaf lock of their own
        self._gauge_lock = threading.Lock()
        self._last_step_ms = None
        self._host_plan_s = 0.0
        self._step_wall_s = 0.0
        # target and draft launches (measured_host_overhead_s)
        self._launch_count = 0
        # (kind, bucket) of every launch the current step issued, target
        # and draft alike: the simulator's virtual clock advances by the
        # step-time model's estimate of exactly these
        self.last_launches = []
        # speculative decoding: the n-gram drafter, or for
        # method="draft-model"/"tree" the hybrid model drafter whose
        # pools come up in _init_draft_model below
        self.spec = SpeculativeConfig.resolve(speculative)
        if self.spec is None:
            self.drafter = None
        elif self.spec.uses_draft_model:
            self.drafter = DraftModelDrafter(self.spec)
        else:
            self.drafter = NgramDrafter(self.spec)
        # async lookahead: the next step's plan, staged on the host
        # under this step's device time (_stage_next / _claim_staged)
        self.lookahead = bool(lookahead)
        self._staged = None          # (plan_rows, packed operands)
        self._staged_epoch = -1

        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32, bfloat16 or "
                             f"float16, got {dtype!r}")
        self.device = devices[0]
        self.dtype = _DTYPES[dtype]
        # int8 serving: weight-only int8 GEMM and/or the int8 KV pool
        self.quant = ServingQuantConfig.resolve(quantize)
        self._w_quant = bool(self.quant and self.quant.weights)
        self._kv_quant = bool(self.quant and self.quant.kv_cache)
        d = model.functional_decompose()
        cfg = model.config
        self.num_layers = d["num_layers"]
        self.num_heads = cfg.num_attention_heads
        inter = d["params"]["blocks"]["mlp.fc_in.weight"].shape[-1]
        if self.num_heads % self.tp:
            raise ValueError(
                f"num_attention_heads {self.num_heads} not divisible by "
                f"tensor_parallel {self.tp} (head-axis sharding)")
        if inter % self.tp:
            raise ValueError(f"intermediate_size {inter} not divisible by "
                             f"tensor_parallel {self.tp}")
        # heads on each rank (all of them at tp = 1)
        self._nh_local = self.num_heads // self.tp
        self.head_dim = cfg.head_dim
        self.eps = cfg.layer_norm_epsilon
        self.vocab_size = int(cfg.vocab_size)  # noqa: H001 (config value, a Python int)
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.max_model_len = int(min(max_model_len  # noqa: H001 (config value, a Python int)
                                     or cfg.max_position_embeddings,
                                     cfg.max_position_embeddings))
        self.max_pages = -(-self.max_model_len // self.block_size)

        def cast(x):
            x = x.detach().to(self.device)
            return x.to(self.dtype) if x.is_floating_point() else x

        params = {g: {k: cast(v) for k, v in sub.items()}
                  for g, sub in d["params"].items()}
        if self._w_quant:
            # int8 storage before the budget math below, so the
            # admissible batch prices 1 byte/param (+ the f32 scales)
            params["blocks"] = quantize_block_weights(params["blocks"])
        # multi-LoRA: the adapter pools join the block leaves before the
        # budget math below, so adapter residency is priced into the
        # admissible batch and the memory model; they are allocated once
        # here and written in place (the captured graphs read them by
        # address), and all-zero pools make every slot the base identity
        # until an adapter is loaded into it
        self.lora = LoRAConfig.resolve(lora)
        self._lora_mgr = None
        if self.lora is not None:
            self._lora_shapes = {k: tuple(params["blocks"][k].shape)
                                 for k in self.lora.targets}
            params["blocks"].update(init_adapter_pools(
                params["blocks"], self.lora, self.dtype))
            self._lora_mgr = AdapterManager(self.lora, self._lora_shapes)
        # tensor parallelism, in the JAX engine's order: cast, int8
        # quantization (above: a row-parallel weight's per-column scale
        # is taken over all its rows), the head-major qkv permutation,
        # then the Megatron shard — this rank's stays on the device,
        # the workers' go to the host for their start
        self._qkv_perm = None
        worker_shards = []
        if self.tp > 1:
            self._qkv_perm = qkv_head_permutation(self.num_heads,
                                                  self.head_dim, self.tp)
            params = {**params,
                      "blocks": permute_qkv(params["blocks"],
                                            self._qkv_perm)}
            worker_shards = [shard_params(params, r, self.tp,
                                          torch.device("cpu"))
                             for r in range(1, self.tp)]
            params = shard_params(params, 0, self.tp, self.device)
        self.params = params

        # pages + weights bound max_batch: under a declared budget the
        # admissible batch is derived from the memory model first, and
        # the defaulted page pool is sized for that batch
        self.memory_budget = parse_bytes(memory_budget)
        # per chip: this rank's shard, and a page's bytes of its heads
        # (the global payload of a page is page_bytes * tp)
        weights_bytes = params_bytes(self.params)
        self.page_bytes = page_bytes(self.num_layers, self.block_size,
                                     self._nh_local, self.head_dim,
                                     self.dtype.itemsize, self._kv_quant)
        if self.memory_budget is not None:
            admissible = derive_max_batch(self.memory_budget, weights_bytes,
                                          self.max_pages * self.page_bytes)
            self.max_batch = min(self.max_batch, admissible)
        if num_blocks is None:
            # default: the full batch at full length fits -> no preemption
            num_blocks = self.max_batch * self.max_pages
        if num_blocks < self.max_pages:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold one max_model_len "
                f"sequence ({self.max_pages} pages)")
        self.num_blocks = int(num_blocks)
        if self.memory_budget is not None and (
                weights_bytes + self.num_blocks * self.page_bytes
                > self.memory_budget):
            raise ValueError(
                f"num_blocks {self.num_blocks} puts the paged pool "
                f"({self.num_blocks * self.page_bytes} bytes) plus weights "
                f"({weights_bytes} bytes) over memory_budget "
                f"{self.memory_budget}")
        # one decode token per running sequence must fit in the budget
        self.token_budget = max(int(token_budget), self.max_batch)
        self.block_manager = BlockManager(
            self.num_blocks, self.block_size,
            enable_prefix_caching=enable_prefix_caching)
        self.block_manager.fault_hook = self.faults
        self.scheduler = Scheduler(
            self.block_manager, max_batch=self.max_batch,
            token_budget=self.token_budget, drafter=self.drafter,
            lora_slots=(self.lora.max_adapters - 1
                        if self.lora is not None else None))
        # the host-RAM tier (kv_tier.py): preemption demotes chains to a
        # bounded host pool, re-admission swaps them back in, and full
        # pages evicted from the prefix cache promote into a host store
        # admission adopts from; a TierPolicy prices bytes vs FLOPs
        self.kv_tier = KVTierConfig.resolve(kv_tier)
        self.host_pool = None
        self.prefix_store = None
        self.tier_policy = None
        # host bytes moved by this step's tier traffic (demote, swap-in,
        # promote and store adoption)
        self.last_tier_bytes = 0
        if self.kv_tier is not None:
            self.host_pool, self.prefix_store = self.kv_tier.build()
            self.tier_policy = self.kv_tier.policy
            if self.host_pool is not None:
                self.scheduler.demote_hook = self._tier_demote
                self.scheduler.swap_in_hook = self._tier_swap_in
            if self.prefix_store is not None:
                self.scheduler.prefix_fetch_hook = self._tier_prefix_fetch
                self.block_manager.evict_hook = self._promote_evicted

        (self._k_rows, self._v_rows, self._kc, self._vc, self._ks_flat,
         self._vs_flat, self._ks, self._vs) = self._pools = \
            self._alloc_pools(self.num_layers)
        # this rank's step state; the workers build theirs from the same
        # spec (tensor_parallel._worker_main)
        self._shard = _StepShard(self.params, self._pools,
                                 self._shard_spec(0), self.device,
                                 psum=None, head=True)
        self._layers = self._shard.layers
        # one captured graph of the step body per token bucket (CUDA at
        # tp = 1; a tp > 1 step runs eagerly on every rank)
        self._capture = self.device.type == "cuda" and self.tp == 1
        self._graphs = StepGraphs(self._ragged_body, self.device)
        # model drafting: the target's first draft_layers blocks over
        # draft pools and a draft BlockManager of their own
        self._draft_bm = None
        self._draft_graphs = None
        if self.spec is not None and self.spec.uses_draft_model:
            self._init_draft_model()
        if self.tp > 1:
            # the workers, joined to both groups, then this rank's
            # reduction: the group (not the engine) is what the
            # finalizer shuts down
            self._tp = TPGroup(devices, self._shard_spec(None),
                               worker_shards)
            self._shard.psum = self._tp.channel.all_reduce
            self._tp_finalizer = weakref.finalize(self, self._tp.close)
            del worker_shards

        self._requests = {}
        self._next_id = 0
        self._first_token_at = {}
        self.seed = 0 if seed is None else int(seed)
        self._rng = np.random.RandomState(self.seed)
        # "launches" / "draft_launches" count target / draft step-body
        # runs, eager or replayed, warmup included
        self.stats = {"steps": 0, "prefill_steps": 0, "decode_steps": 0,
                      "chunk_launches": 0, "tokens_generated": 0,
                      "spec_steps": 0, "draft_tokens": 0,
                      "accepted_tokens": 0, "mixed_steps": 0,
                      # async lookahead: plans staged under device
                      # time / staged plans that survived to launch
                      "staged_steps": 0, "staged_hits": 0,
                      # tree speculation: sibling branches taken
                      "tree_hits": 0, "launches": 0, "draft_launches": 0,
                      # lifecycle counters (lifecycle_stats())
                      "aborted": 0, "deadline_missed": 0, "shed": 0,
                      "retries": 0, "quarantined": 0, "step_faults": 0}
        # D001: the address of every tensor the step reads by address,
        # recorded as it is built (framework/analysis.py)
        self._state_ptrs = {}
        self._note_captured_state()

    def _alloc_pools(self, num_layers):
        """Zeroed K/V pools of ``num_layers`` layers of this rank's heads
        on the engine's device (see :func:`alloc_pools`)."""
        return alloc_pools(num_layers, self.num_blocks, self.block_size,
                           self._nh_local, self.head_dim,
                           torch.int8 if self._kv_quant else self.dtype,
                           self._kv_quant, self.device)

    def _shard_spec(self, rank):
        """The dims and options a rank's :class:`_StepShard` reads (for
        the workers ``rank`` None: each fills in its own), plus what a
        worker builds its pools and adapter writes from."""
        return {"rank": rank, "tp": self.tp, "perm": self._qkv_perm,
                "num_layers": self.num_layers,
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "num_heads": self._nh_local, "head_dim": self.head_dim,
                "eps": self.eps, "max_batch": self.max_batch,
                "max_pages": self.max_pages, "dtype": self.dtype,
                "kv_dtype": torch.int8 if self._kv_quant else self.dtype,
                "w_quant": self._w_quant, "kv_quant": self._kv_quant,
                "lora": self.lora,
                "lora_shapes": getattr(self, "_lora_shapes", None),
                "draft_layers": (len(self._draft_layers)
                                 if getattr(self, "_draft_bm", None)
                                 is not None else 0)}

    def _init_draft_model(self):
        """The draft model: the target's first ``draft_layers`` blocks
        (the same weight tensors), the shared embedding and head, over
        draft pools of ``draft_layers`` layers with their own sink rows,
        and a draft BlockManager with prefix caching off (draft state is
        disposable).  The JAX engine pads the draft to full depth with
        zero blocks, each an exact identity (``x + 0``), to ride its one
        executable; running only the first blocks is the same function.
        The draft body is captured by a second StepGraphs, one graph a
        token bucket in a pool of its own."""
        dl = min(int(self.spec.draft_layers), self.num_layers)
        self._shard.set_draft(dl, self._alloc_pools(dl))
        self._draft_layers = self._shard.draft_layers
        self._draft_pools = self._shard.draft_pools
        self._draft_bm = BlockManager(self.num_blocks, self.block_size,
                                      enable_prefix_caching=False)
        self._draft_graphs = StepGraphs(self._draft_body, self.device)
        self.events.append((self._step_index, "draft_model_load", dl,
                            self.num_blocks))

    def _rank_stats(self, detail=False):
        """Every rank's report (``tensor_parallel.rank_stats``: kernel
        launch counts, device bytes, pool shapes, weight bytes, channel
        timers, the JAX modules it imported, with ``detail`` each leaf's
        sum), rank 0 first; one entry at tp = 1."""
        channel = None if self._tp is None else self._tp.channel
        local = rank_stats(self._shard, channel, detail)
        return [local] if self._tp is None else self._tp.stats(local,
                                                                detail)

    def memory_model(self, memory_budget=None):
        """Weights, pages and pool bytes, and the admissible batch under
        a budget (this engine's own or an override); see
        :func:`paddle_tpu_torch.framework.cost.engine_memory_model`."""
        return engine_memory_model(self, memory_budget=memory_budget)

    # ----------------------------------------------------------- requests --
    def add_request(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                    temperature=0.0, request_id=None, seed=None,
                    deadline_ms=None, top_k=0, top_p=1.0, min_p=0.0,
                    repetition_penalty=1.0, presence_penalty=0.0,
                    frequency_penalty=0.0, logit_bias=None, logprobs=0,
                    stop=None, grammar=None, n=1, adapter_id=None):
        """Queue one request (host work only: safe from any thread an
        :class:`AsyncLLMEngine` serves).  Every parameter is validated
        before anything is queued, the adapter first, so an unknown one
        leaves the engine untouched.  Past ``max_queue`` waiting
        requests, while draining, or past its adapter's
        ``tenant_quota`` of live requests, the request is shed: it
        finishes at once with ``FinishReason.shed``, delivered by the
        next :meth:`step`."""
        interleave_point("add")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]  # noqa: H001 (prompt ids arrive as host data)
        if not prompt:
            raise ValueError("empty prompt")
        if adapter_id is not None:
            if self.lora is None:
                raise ValueError(
                    "adapter_id= needs a LoRA-enabled engine — "
                    "construct with lora=LoRAConfig(...)")
            if not self._lora_mgr.known(adapter_id):
                raise ValueError(
                    f"unknown adapter {adapter_id!r} — register it "
                    f"with add_adapter() first")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        logit_bias, stop = validate_sampling(
            top_k, top_p, min_p, repetition_penalty, presence_penalty,
            frequency_penalty, logit_bias, logprobs, stop, n,
            vocab_size=self.vocab_size)
        if stop and self.detokenizer is None:
            raise ValueError(
                "stop strings need a detokenizer — construct the "
                "engine with detokenizer=callable(ids) -> str")
        if grammar is not None and not all(
                hasattr(grammar, a)
                for a in ("start_state", "allowed", "advance")):
            raise ValueError(
                f"grammar must implement start_state/allowed/advance "
                f"(see inference.llm.structured.Grammar), "
                f"got {grammar!r}")
        if n > 1:
            if seed is None:
                raise ValueError(
                    "n > 1 parallel sampling needs an explicit seed — "
                    "each fork k samples under seed + k, which is what "
                    "makes fork-vs-replay exactness checkable")
            if n > self.max_batch:
                raise ValueError(
                    f"n={n} exceeds max_batch {self.max_batch}: the "
                    f"whole fork family must fit one running set")
        _check_deadline(deadline_ms)
        if len(prompt) + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt {len(prompt)} + new {max_new_tokens} exceeds "
                f"max_model_len {self.max_model_len}")
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        now = self._clock()
        req = Request(request_id=request_id, prompt_ids=tuple(prompt),
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      temperature=float(temperature),
                      seed=None if seed is None else int(seed),
                      deadline=(None if deadline_ms is None
                                else now + float(deadline_ms) / 1e3),
                      top_k=int(top_k), top_p=float(top_p),
                      min_p=float(min_p),
                      repetition_penalty=float(repetition_penalty),
                      presence_penalty=float(presence_penalty),
                      frequency_penalty=float(frequency_penalty),
                      logit_bias=logit_bias, logprobs=int(logprobs),
                      stop=stop, grammar=grammar, n=int(n),
                      adapter_id=adapter_id, arrival_time=now)
        if grammar is not None:
            req._constraint = ConstraintState(grammar)
        quota = self.lora.tenant_quota if self.lora is not None else None
        over_quota = (
            quota is not None and adapter_id is not None
            and sum(1 for r in self._requests.values()
                    if r.adapter_id == adapter_id) >= quota)
        if over_quota or self._draining or (
                self.max_queue is not None
                and self.scheduler.queue_depth() >= self.max_queue):
            self.stats["shed"] += 1
            self.events.append((self._step_index, "shed", request_id))
            req.status = FINISHED
            req.finish_reason = FinishReason.SHED
            self._early.append(RequestOutput(
                request_id, req.prompt_ids, req.output_ids,
                FinishReason.SHED, 0, metrics=self._metrics(req)))
            return request_id
        self._requests[request_id] = req
        self.scheduler.add(req)
        self._invalidate_plan()
        self.events.append((self._step_index, "add", request_id))
        return request_id

    def abort_request(self, request_id):
        """Cancel a request in any state — waiting, chunk-prefilling,
        decoding, preempted or forked — reclaiming its pages
        refcount-correctly (prefix-cache registrations survive on the
        LRU list).  Its RequestOutput (``FinishReason.aborted``, with
        whatever tokens it emitted) comes with the next :meth:`step`.
        Returns True if the request was live and is now aborted."""
        interleave_point("abort")
        req = self._requests.get(request_id)
        if req is None or req.status == FINISHED:
            return False
        rollback_draft_reservation(self.block_manager, req)
        self.scheduler.abort(req)
        self.stats["aborted"] += 1
        self.events.append((self._step_index, "abort", request_id))
        self._finish_early(req, FinishReason.ABORTED)
        return True

    def _finish_early(self, req, reason, error=None):
        """Terminal bookkeeping of a request that exits without a device
        step (abort, deadline, quarantine); the caller has reclaimed its
        pages.  The output joins the next step()'s finished list."""
        self._invalidate_plan()
        self._drafter_forget(req.request_id)
        self._tier_forget(req.request_id)
        req.status = FINISHED
        req.finish_reason = reason
        self._requests.pop(req.request_id, None)
        self._early.append(RequestOutput(
            req.request_id, req.prompt_ids, req.output_ids, reason,
            req.num_preemptions, error=error,
            logprobs=req.logprobs_content if req.logprobs else None,
            matched_stop=req.matched_stop, metrics=self._metrics(req)))

    def _expire_deadlines(self, finished):
        """Pop every request past its ``deadline_ms`` (waiting or
        running; pages freed either way) with ``FinishReason.deadline``."""
        expired = self.scheduler.expire_deadlines(self._clock())
        for req in expired:
            self.stats["deadline_missed"] += 1
            self.events.append(
                (self._step_index, "deadline", req.request_id))
            self._finish_early(req, FinishReason.DEADLINE)
        if expired:
            finished.extend(self._drain_early())

    def _drain_early(self):
        early, self._early = self._early, []
        return early

    def _invalidate_plan(self):
        """Mark any plan made for the next step stale: every lifecycle
        mutation that could change what the scheduler picks bumps the
        epoch."""
        self._plan_epoch += 1

    def has_unfinished(self):
        return bool(self._early) or self.scheduler.has_unfinished()

    def drain(self, timeout_s=None):
        """Graceful shutdown: stop admitting (new requests are shed),
        step until every in-flight request finishes, and return their
        outputs.  ``timeout_s`` bounds the wait on the engine clock:
        requests still running when it expires are aborted, so drain()
        always ends with no page leaked."""
        self._draining = True
        deadline = (None if timeout_s is None
                    else self._clock() + float(timeout_s))
        outs = []
        try:
            while self.has_unfinished():
                if deadline is not None and self._clock() >= deadline:
                    for rid in list(self._requests):
                        self.abort_request(rid)
                outs.extend(self.step())
        finally:
            self._draining = False
        return outs

    def lifecycle_stats(self):
        """Failure-path counters plus the live gauges a health check
        polls between steps: ``queue_depth`` (admitted, not yet
        running), ``inflight`` (running), ``free_pages`` (allocatable
        now, LRU-parked cached pages included), ``last_step_ms`` (the
        latest step()'s time on the engine timer; None before the first
        step), the lookahead counters ``staged_steps`` (plans staged
        under a step's device time) and ``staged_hits`` (staged plans
        claimed), ``host_plan_s`` (critical-path time spent scheduling,
        packing and validating a claim) and ``host_overhead_fraction``
        (its share of all step time; None before a step).  The
        wall-clock values never enter ``events``."""
        s = self.stats
        with self._gauge_lock:
            last_step_ms = self._last_step_ms
            host_plan_s = self._host_plan_s
            step_wall_s = self._step_wall_s
        return {"aborted": s["aborted"],
                "deadline_missed": s["deadline_missed"],
                "shed": s["shed"], "retries": s["retries"],
                "quarantined": s["quarantined"],
                "step_faults": s["step_faults"],
                "preemptions": self.scheduler.num_preemptions,
                "wedged_steps": (self.watchdog.num_wedged
                                 if self.watchdog else 0),
                "queue_depth": self.scheduler.queue_depth(),
                "inflight": len(self.scheduler.running),
                "free_pages": self.block_manager.num_free_blocks,
                "last_step_ms": last_step_ms,
                "staged_steps": s["staged_steps"],
                "staged_hits": s["staged_hits"],
                "host_plan_s": host_plan_s,
                "host_overhead_fraction": (
                    host_plan_s / step_wall_s if step_wall_s > 0 else None),
                "step_gauges": self.step_gauges}

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

    def _stage(self, pk):
        """Copy a packed step's operands to the device: the int32 buffer
        (on CUDA into the bucket's static buffer) and, for a step with a
        sampling-pipeline row, the pipeline's operands.  Writes no pool."""
        if self._capture:
            ints = self._graphs.stage(pk["tb"], pk["ints"])
        else:
            ints = self._to_device(pk["ints"])
        pipe = None
        if pk["pipeline"] is not None:
            knobs, bias, counts = pk["pipeline"]
            pipe = tuple(self._to_device(a) for a in (*knobs, bias, counts))
        return ints, pipe

    @torch.no_grad()
    def _ragged_fn(self, pk):
        """Run one packed step (see :meth:`_pack_rows`) -> (argmax [Tb],
        logits [Tb, V]) on the device; the K/V pools are updated in place.

        The operands are staged first (:meth:`_stage`).  Then the pools
        are written: copy-on-write page copies, eagerly, so they land
        before the step's writes, then the step body: on the CPU
        directly, on CUDA as a replay of the bucket's graph (a bucket's
        first step runs the body eagerly and captures it,
        ``jit/graphs.py``).  ``_writes_began`` marks the boundary for
        :meth:`_launch`.  A step with a sampling-pipeline row runs the
        pipeline eagerly on the step's logits and takes the argmax again.
        At tp > 1 the step (operands and copy-on-write pairs) goes to
        every worker first, and every rank runs the body eagerly.

        On CUDA the returned tensors may be the graph's static outputs,
        which the next replay overwrites: the caller reads them before
        the next step, as :meth:`_launch_packed` does."""
        ints, pipe = self._stage(pk)
        self._writes_began = True
        tb = pk["tb"]
        if self._tp is not None:
            self._tp.step(OP_STEP, tb, pk["ints"], pk["cows"])
        if pk["cows"]:
            self._copy_on_write(pk["cows"])
        if self._capture:
            argmax, logits = self._graphs.run(tb)
        else:
            argmax, logits = self._ragged_body(ints)
        self.stats["launches"] += 1
        if pipe is not None:
            # neutral knobs are exact identities, so a step without a
            # pipeline row skips the pipeline instead of running it
            logits = apply_logits_pipeline(logits, ints[2 * tb:3 * tb],
                                           *pipe)
            argmax = logits.argmax(-1)
        return argmax, logits

    def _copy_on_write(self, cows):
        """Copy each ``(src, dst)`` page's payload (and scales) in every
        layer, on the step's stream."""
        self._shard.copy_on_write(cows)

    def _ragged_body(self, ints, layers=None, pools=None, lora=True):
        """The step body, :meth:`_StepShard.body` of this rank's shard:
        one ragged step over the packed int32 operands ``ints`` on the
        engine's device -> (argmax [Tb], logits [Tb, V]), through the
        blocks ``layers`` over the pools ``pools`` (see
        :meth:`_alloc_pools`; by default the target's, the draft model
        passes its own), with the rows' adapter deltas when ``lora``."""
        return self._shard.body(ints, layers, pools, lora)

    def _draft_body(self, ints):
        """The draft model's step body: :meth:`_ragged_body` over the
        target's first ``draft_layers`` blocks and the draft pools,
        without adapters."""
        return self._ragged_body(ints, self._draft_layers,
                                 self._draft_pools, lora=False)

    def _draft_run(self, pk):
        """Run one packed draft step -> (argmax [Tb], logits [Tb, V]) on
        the device, the draft pools updated in place: on CUDA a replay
        of the draft graphs' bucket (captured at its first step), whose
        outputs the next draft replay overwrites; on the CPU, and on
        every rank at tp > 1, the body."""
        tb = pk["tb"]
        if self._capture:
            self._draft_graphs.stage(tb, pk["ints"])
            out = self._draft_graphs.run(tb)
        else:
            if self._tp is not None:
                self._tp.step(OP_DRAFT, tb, pk["ints"])
            out = self._draft_body(self._to_device(pk["ints"]))
        self.stats["draft_launches"] += 1
        return out

    def _wmat(self, p_l, key):
        """A block GEMM's weight operand (:meth:`_StepShard.wmat`): an
        int8 leaf dequantizes at the operand load."""
        return self._shard.wmat(p_l, key)

    def warmup(self):
        """Run every token bucket once with dead rows (only the sink rows
        are written) so the kernel libraries and allocator are ready
        before traffic; on CUDA that run captures the bucket's graph,
        largest bucket first so the smaller captures reuse the shared
        pool's memory, and steady serving captures nothing new.  A
        draft model's body runs (and is captured) the same way, over the
        draft pools.  A server calls it before its worker thread starts,
        so no capture runs while another thread may call into CUDA.

        Returns a :class:`~paddle_tpu_torch.framework.analysis.
        CaptureWatcher` armed over the target's (and the draft's) step
        graphs, so callers can assert the serving window captures
        nothing; its ``compile_ms`` is ``{"ragged[<bucket>]": ms}`` in
        bucket order for the target's runs, captures included, mirrored
        on ``engine.warmup_compile_ms`` (the draft's capture times are
        the draft StepGraphs' ``capture_ms``)::

            watcher = eng.warmup()
            serve_traffic()
            watcher.assert_no_new_captures()
        """
        timings = {}
        dead = (None if self.lora is None
                else np.zeros(self.max_batch, np.int32))
        for kind, tb in sorted(self._bucket_grid(), key=lambda b: -b[1]):
            t0 = time.perf_counter()
            self._ragged_fn(self._pack_rows([], tb, adapter_rows=dead))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # noqa: H001 (warmup timing sync — never on the serving step path)
            timings[f"{kind}[{tb}]"] = (time.perf_counter() - t0) * 1e3
        if self._draft_bm is not None:
            for _kind, tb in sorted(self._bucket_grid(),
                                    key=lambda b: -b[1]):
                self._draft_run(self._pack_rows([], tb))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # noqa: H001 (warmup sync — never on the serving step path)
        self._note_captured_state()
        self.warmup_compile_ms = {
            key: timings[key]
            for key in (f"{k}[{tb}]" for k, tb in self._bucket_grid())}
        graphs = [("ragged", self._graphs)]
        if self._draft_graphs is not None:
            graphs.append(("draft", self._draft_graphs))
        watcher = CaptureWatcher(*(g for _, g in graphs),
                                 labels=[lbl for lbl, _ in graphs])
        watcher.compile_ms = dict(self.warmup_compile_ms)
        return watcher

    def executable_grid(self):
        """Yield ``(kind, bucket, body, operands)`` for every entry of
        :meth:`_bucket_grid`: ``body(ints, *pools)`` is the step body
        (:meth:`_ragged_body`) over the pools passed as inputs
        (:func:`pool_views` takes their page views again), and
        ``operands`` are a dead-row packed buffer of the bucket on the
        engine's device (:meth:`_pack_rows` with no rows; on a LoRA
        engine every row on adapter slot 0) followed by the pool
        tensors.  ``framework/analysis.py`` and ``framework/cost.py``
        trace these over fake tensors: nothing runs and no pool is
        written.  At tp > 1 the body is rank 0's shard over its pools,
        its all-reduces bound to the traceable stand-in
        ``tensor_parallel.mp_all_reduce`` (one node each in the graph,
        nothing sent and no worker involved; the served step keeps its
        channel)."""
        pools = tuple(t for t in (self._k_rows, self._v_rows,
                                  self._ks_flat, self._vs_flat)
                      if t is not None)
        nb, bs = self.num_blocks, self.block_size
        step = self._ragged_body
        if self.tp > 1:
            shard = copy.copy(self._shard)
            shard.psum = traced_psum
            step = shard.body

        def body(ints, *pools):
            return step(ints, pools=pool_views(*pools, num_blocks=nb,
                                               block_size=bs))

        dead = (None if self.lora is None
                else np.zeros(self.max_batch, np.int32))
        for kind, tb in self._bucket_grid():
            ints = torch.from_numpy(
                self._pack_rows([], tb, adapter_rows=dead)["ints"])
            yield kind, tb, body, (ints.to(self.device), *pools)

    def _captured_state(self):
        """``{name: tensor}`` of every tensor the step reads by address,
        which a captured graph keeps reading at the address it had: the
        target's and the draft's pools (their sinks and scales), the
        weights with the adapter pools, the per-layer views of them, and
        the step graphs' static operand buffers (D001,
        ``framework/analysis.py::check_captured_state``)."""
        state = {}
        for prefix, pools in (("pools", self._shard.pools),
                              ("draft_pools", self._shard.draft_pools)):
            if pools is not None:
                state.update((f"{prefix}.{field}", t)
                             for field, t in pools._asdict().items()
                             if t is not None)
        for group, sub in self._shard.params.items():
            state.update((f"params.{group}.{key}", t)
                         for key, t in sub.items())
        for i, layer in enumerate(self._shard.layers):
            state.update((f"layers[{i}].{key}", t)
                         for key, t in layer.items())
        for label, graphs in (("ragged", self._graphs),
                              ("draft", self._draft_graphs)):
            if graphs is not None:
                state.update((f"{label}.static[{key}]", entry[1])
                             for key, entry in graphs._inputs.items())
        return state

    def _note_captured_state(self):
        """Record the address of each tensor of :meth:`_captured_state`
        not recorded yet (at construction, and what ``warmup()``
        allocated)."""
        for name, t in self._captured_state().items():
            self._state_ptrs.setdefault(name, t.data_ptr())

    # ---------------------------------------------------------------- step --
    def step(self):
        """Run one scheduling iteration; returns the RequestOutputs
        finished by this step (possibly empty), including requests that
        left through a failure path (aborted, deadline, shed, error)
        since the previous step."""
        t0 = self._timer()
        try:
            return self._step_impl()
        finally:
            dt = self._timer() - t0
            with self._gauge_lock:
                self._step_wall_s += dt
                self._last_step_ms = dt * 1e3

    def _step_impl(self):
        interleave_point("step")
        self._step_index += 1
        self.last_launches = []
        self.last_tier_bytes = 0
        if self.faults is not None:
            self.faults.begin_step(self._step_index)
        finished = self._drain_early()
        self._expire_deadlines(finished)
        staged = self._claim_staged()
        if staged is not None:
            # this step's plan and pack ran under the previous step's
            # device time; only the claim's validation was on this step's
            # critical path
            plan_rows, pk = staged
            self.stats["steps"] += 1
            self.stats["staged_hits"] += 1
            self.stats["decode_steps"] += 1
            self._launch_packed(plan_rows, pk, finished)
        else:
            if isinstance(self.drafter, DraftModelDrafter):
                self._draft_phase()
            t0 = self._timer()
            pre_preempt = self.scheduler.num_preemptions
            batch = self.scheduler.schedule()
            if self.scheduler.num_preemptions > pre_preempt:
                self.events.append(
                    (self._step_index, "preempt",
                     self.scheduler.num_preemptions - pre_preempt))
            if batch.kind == "idle":
                with self._gauge_lock:
                    self._host_plan_s += self._timer() - t0
                self._record_step_gauges()
                return finished
            self.stats["steps"] += 1
            self._ragged_step(batch, finished, t0)
        if self.tp > 1 or self.kv_tier is not None:
            # one host allocator drives every rank's pool shard, so page
            # accounting must hold after each TP step; and zero page
            # leaks across the tiers is the tier's contract: HBM, host
            # pool and prefix store books balance every step
            self.check_invariants()
        finished.extend(self._drain_early())
        self._record_step_gauges()
        return finished

    def _record_step_gauges(self):
        """Per-step cumulative lifecycle counters (``record_step_gauges=``),
        wall-clock free, in ``lifecycle_stats()["step_gauges"]``."""
        if not self.record_step_gauges:
            return
        s = self.stats
        self.step_gauges.append({
            "step": self._step_index,
            "preemptions": self.scheduler.num_preemptions,
            "shed": s["shed"], "aborted": s["aborted"],
            "deadline_missed": s["deadline_missed"],
            "retries": s["retries"], "quarantined": s["quarantined"],
            "queue_depth": self.scheduler.queue_depth(),
            "inflight": len(self.scheduler.running),
            "free_pages": self.block_manager.num_free_blocks,
        })

    def _ragged_step(self, batch, finished, t_sched):
        """One launch for the whole scheduled step: decode rows and
        prefill chunks pack into a single flat token batch; commits run
        decode rows in scheduler order first, then chunks in schedule
        order (the order seeded streams depend on).  Scheduling and
        packing from ``t_sched`` on count as host planning time."""
        rows = [row for row in batch.rows
                if row.request.status != FINISHED]
        if not rows:
            with self._gauge_lock:
                self._host_plan_s += self._timer() - t_sched
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
        pk = self._pack_ragged(rows, batch.cows)
        with self._gauge_lock:
            self._host_plan_s += self._timer() - t_sched
        self._launch_packed(rows, pk, finished)

    # ----------------------------------------------------- step isolation --
    def _launch(self, kind, reqs, launch):
        """Run one launch behind the isolation boundary and return its
        outputs, or None after a quarantine (the caller skips its
        commit).  An injected fault fires first, before the step stages
        or writes anything; the retry policy absorbs failures with
        seeded backoff, repeating the whole launch (a page copy is
        idempotent); the watchdog clocks each attempt — on CUDA a replay
        returns before the card finishes, so it times the dispatch, as
        the JAX engine's watchdog times an asynchronous dispatch.  A
        launch that fails after it began writing the pools, with a CUDA
        error (sticky: the context is unusable) or with a lost rank
        (:class:`~.tensor_parallel.RankLostError`) raises PoolLostError,
        and a tensor-parallel engine's workers are shut down with it (the
        ranks are out of step); one that still fails after every retry
        is quarantined."""
        attempt = 0
        while True:
            t0 = (self.watchdog.started()
                  if self.watchdog is not None else None)
            self._writes_began = False
            try:
                if self.faults is not None:
                    self.faults.device_step(kind)
                return launch()
            except Exception as e:   # noqa: BLE001 — isolation boundary
                self.stats["step_faults"] += 1
                if self._pool_lost(e):
                    if self._tp is not None:
                        self._tp.close(kill=True)
                    raise PoolLostError(
                        f"device step failed after writing the KV pools "
                        f"in place; cache unrecoverable: {e}") from e
                attempt += 1
                if attempt < self.retry.max_attempts:
                    self.stats["retries"] += 1
                    self.events.append(
                        (self._step_index, "retry", kind, attempt))
                    delay = self.retry.backoff(attempt - 1)
                    if delay > 0:
                        self._sleep(delay)
                    continue
                self._quarantine(kind, reqs, e)
                return None
            finally:
                if self.watchdog is not None:
                    self.watchdog.observe_since(self._step_index, kind,
                                                t0)

    def _pool_lost(self, exc):
        """Whether a failed launch left the pools unusable: it had begun
        writing them, it raised a CUDA error, or a rank is gone (its pool
        shard with it, whatever point the launch had reached)."""
        return self._writes_began or isinstance(
            exc, (torch.AcceleratorError, RankLostError))

    def _quarantine(self, kind, reqs, exc):
        """A launch failed after every retry: finish the responsible
        request(s) with ``FinishReason.error`` instead of failing the
        batch.  An injected fault names its victim row; a real failure
        quarantines every row of the launch.  The other rows give back
        their step reservation and stay running — the launch wrote
        nothing, so their K/V is intact and the next step re-launches
        them token-exactly."""
        self._invalidate_plan()
        victim = getattr(exc, "victim", None)
        victims = (list(reqs) if victim is None or not reqs
                   else [reqs[victim % len(reqs)]])
        msg = f"{type(exc).__name__}: {exc}"
        warnings.warn(f"quarantining {len(victims)} request(s) after "
                      f"failed {kind} step: {msg}", RuntimeWarning,
                      stacklevel=3)
        for req in reqs:
            rollback_draft_reservation(self.block_manager, req)
        for req in victims:
            self.scheduler.abort(req)
            self.stats["quarantined"] += 1
            self.events.append(
                (self._step_index, "quarantine", req.request_id))
            self._finish_early(req, FinishReason.ERROR, error=msg)

    # ------------------------------------------------------------ packing --
    def _pack_rows(self, entries, tb, cows=(), adapter_rows=None):
        """Pack ``(tokens, pos0, block_table)`` rows into one int32 host
        buffer: ids, positions, token->row map (``tb`` each), then
        row_start, row_qlen, row_pos0 (``max_batch`` each), then the
        ``[max_batch, max_pages]`` block tables, then, for a LoRA
        target step, ``adapter_rows`` (each row's adapter slot,
        ``max_batch``) — one host-to-device copy per step.  Unused
        tokens carry position -1, unused rows qlen 0."""
        rmax, pmax = self.max_batch, self.max_pages
        extra = 0 if adapter_rows is None else rmax
        buf = np.zeros(3 * tb + 3 * rmax + rmax * pmax + extra, np.int32)
        ids, positions, tok_rows = (buf[:tb], buf[tb:2 * tb],
                                    buf[2 * tb:3 * tb])
        d = 3 * tb
        row_start, row_qlen, row_pos0 = (buf[d:d + rmax],
                                         buf[d + rmax:d + 2 * rmax],
                                         buf[d + 2 * rmax:d + 3 * rmax])
        tables = buf[d + 3 * rmax:d + 3 * rmax + rmax * pmax].reshape(rmax,
                                                                      pmax)
        if adapter_rows is not None:
            buf[d + 3 * rmax + rmax * pmax:] = adapter_rows
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
        sampling pipeline's operands when a row uses it: six per-row knob
        vectors and two ``[tb, V]`` f32 channels, the additive bias
        (logit bias and a grammar's mask) and the penalties' token
        counts, filled at each sampling position.  A verify row is
        ``[last] + drafts``, a tree row ``[last, sibling]`` on its fork's
        table.  Host work only, shared by the step and the lookahead
        stager, so a staged launch is operand-identical to a sync one."""
        total = sum(row.length for row in rows)
        tb = bucket_size(total, self.token_budget, floor=8)
        entries = []
        for row in rows:
            req = row.request
            if row.kind == "chunk":
                toks = req.all_ids[row.start:row.start + row.length]
            elif row.kind == "tree":
                # sibling branch: re-write position T-1's K/V on the
                # fork's own chain, then score the runner-up first token
                # at position T
                toks = [req.all_ids[-1], row.sibling]
            else:
                toks = [req.all_ids[-1]] + list(req.draft_tokens)
            entries.append((toks, row.start, self.block_manager.block_table(
                req.request_id if row.table_id is None else row.table_id)))
        # LoRA residency: each row's adapter in a resident pool slot
        # (loading, and evicting by LRU, as needed), with the adapters
        # this step indexes pinned; the scheduler's distinct-adapter
        # admission gate guarantees they fit
        adapter_rows = None
        if self.lora is not None:
            adapter_rows = np.zeros(self.max_batch, np.int32)
            pinned = {row.request.adapter_id for row in rows
                      if row.request.adapter_id is not None}
            for ri, row in enumerate(rows):
                adapter_rows[ri] = self._lora_slot(row.request, pinned)
        pk = self._pack_rows(entries, tb, cows, adapter_rows)
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
                if row.kind == "chunk":
                    if not row.chunk.is_final:
                        continue       # no position samples this step
                    qpos = [pk["starts"][ri] + row.length - 1]
                    prefixes = [()]
                else:
                    # verify position j sees drafts[:j] as generated
                    # text: counts and grammar state advance per position
                    drafts = list(req.draft_tokens)
                    qpos = list(range(pk["starts"][ri],
                                      pk["starts"][ri] + row.length))
                    prefixes = [tuple(drafts[:j]) for j in range(len(qpos))]
                penal = (req.repetition_penalty != 1.0
                         or req.presence_penalty != 0.0
                         or req.frequency_penalty != 0.0)
                states = None
                if req._constraint is not None and len(qpos) > 1:
                    states = req._constraint.peek(prefixes[-1])
                for j, p in enumerate(qpos):
                    if penal:
                        counts[p] = token_counts(
                            list(req.all_ids) + list(prefixes[j]), v)
                    for t, b in (req.logit_bias or {}).items():
                        bias[p, t] += b
                    if req._constraint is not None:
                        st = req._constraint.state if j == 0 \
                            else states[j - 1]
                        if st is not None:
                            req._constraint.bias_row(bias[p], state=st)
            pk["pipeline"] = (knobs, bias, counts)
        return pk

    def _launch_packed(self, rows, pk, finished):
        """Launch one packed step behind the isolation boundary, pull its
        tokens and commit them: the back half of the sync step and of a
        claimed lookahead plan.  With lookahead the next step is staged
        between the dispatch and the blocking pull, so its planning runs
        under this step's device time.  The pull follows the step's pool
        writes, so a failure there raises PoolLostError."""
        self.last_launches.append(("ragged", pk["tb"]))
        self._launch_count += 1
        out = self._launch("ragged", [row.request for row in rows],
                           lambda: self._ragged_fn(pk))
        if out is None:
            # quarantined, reservations rolled back: free the tree fork
            # chains this step scheduled
            for row in rows:
                if row.kind == "tree" and \
                        self.block_manager.has_seq(row.table_id):
                    self.block_manager.free(row.table_id)
            return
        self._stage_next(rows)
        # a staged plan exists but is not yet claimed: where stage-vs-
        # abort races live
        interleave_point("staged")
        # on CUDA these are the graph's static outputs: read before the
        # next replay overwrites them
        try:
            nxt, row_logits = self._pull(rows, pk["starts"], *out)
        except Exception as e:   # noqa: BLE001 — the pools are written
            raise PoolLostError(
                f"device step failed after writing the KV pools in "
                f"place; cache unrecoverable: {e}") from e
        self._commit(rows, pk["starts"], nxt, row_logits, finished)

    def _pull(self, rows, starts, argmax, logits):
        """The one host pull per step: the argmax vector, plus the logits
        rows of tokens that sample or report logprobs."""
        return (argmax.cpu().numpy(),  # noqa: H001 (the step's argmax pull — the one sync a step makes by design)
                self._fetch_sampling_rows(rows, starts, logits))

    def _commit(self, rows, starts, nxt, row_logits, finished):
        """Commit one step's tokens on the host."""
        # commit phase A: decode and verify rows, in scheduler order —
        # every row through _commit_verified when any carries drafts,
        # else one vectorized commit (the gumbel draw order seeded
        # output depends on); a tree row is walked with its main row
        nonchunk = [(ri, row) for ri, row in enumerate(rows)
                    if row.kind not in ("chunk", "tree")]
        tree_rows = {row.request.request_id: (ri, row)
                     for ri, row in enumerate(rows) if row.kind == "tree"}
        if any(row.request.draft_tokens for _, row in nonchunk):
            self.stats["spec_steps"] += 1
            for ri, row in nonchunk:
                s0 = starts[ri]
                tree = None
                tr = tree_rows.pop(row.request.request_id, None)
                if tr is not None:
                    tri, trow = tr
                    ts = starts[tri]
                    tree = (trow.table_id, trow.sibling, nxt[ts:ts + 2],
                            row_logits.get(tri))
                self._commit_verified(row.request, nxt[s0:s0 + row.length],
                                      row_logits.get(ri), finished,
                                      tree=tree)
            for _tri, trow in tree_rows.values():
                # a sibling row whose main row is gone
                if self.block_manager.has_seq(trow.table_id):
                    self.block_manager.free(trow.table_id)
        elif nonchunk:
            entries = []
            for ri, row in nonchunk:
                req = row.request
                req.num_cached += 1
                if req.num_cached % self.block_size == 0:
                    self._register_full_blocks(req)
                lg = row_logits.get(ri)
                entries.append((req, nxt[starts[ri]],
                                None if lg is None else lg[0]))
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
                # n > 1 forks split here, prompt cached and before the
                # first token commits: every member samples its first
                # token from this final-chunk row under its own stream
                tok = nxt[starts[ri] + row.length - 1]
                self._commit_tokens(
                    [(r, tok, None if lg is None else lg[0])
                     for r in self._fork_family(req)], finished)

    def _fetch_sampling_rows(self, rows, starts, logits):
        """Fetch only the logits rows of tokens that sample with a
        temperature or report logprobs: a greedy batch transfers just the
        argmax vector.  Returns {row_index: [n, V] host array} — a decode
        row's one token, a verify row's 1 + K, a tree row's 2, a final
        chunk's last token."""
        idx, spans = [], {}
        for ri, row in enumerate(rows):
            req = row.request
            if req.temperature <= 0.0 and not req.logprobs:
                continue
            if row.kind == "chunk":
                if not row.chunk.is_final:
                    continue
                lo, n = starts[ri] + row.length - 1, 1
            else:
                lo, n = starts[ri], row.length
            spans[ri] = (len(idx), n)
            idx.extend(range(lo, lo + n))
        if not spans:
            return {}
        sel = logits[torch.as_tensor(idx, device=logits.device)]
        sel = sel.float().cpu().numpy()  # noqa: H001 (the sampling and logprobs rows' logits, pulled once a step by design)
        return {ri: sel[o:o + n] for ri, (o, n) in spans.items()}

    # --------------------------------------------------------- commits --
    def _register_full_blocks(self, req):
        """Make every completed full page of ``req`` hash-addressable."""
        bm = self.block_manager
        if not bm.enable_prefix_caching:
            return
        hashes = bm.prefix_chain_hashes(
            req.all_ids, limit=req.num_cached // self.block_size,
            salt=req.adapter_id)
        for i, h in enumerate(hashes):
            bm.register_full_block(req.request_id, i, h)

    def _sample_token(self, req, logits):
        """Gumbel-max sample of one host logits row from the request's
        stream (``seed=``) or the engine stream."""
        z = np.asarray(logits, np.float64) / req.temperature  # noqa: H001 (host sampling over the pulled logits row)
        if req.seed is not None:
            if req._sample_rng is None:
                req._sample_rng = np.random.RandomState(req.seed)
            rng = req._sample_rng
        else:
            rng = self._rng
        return int(np.argmax(z + rng.gumbel(size=z.shape)))  # noqa: H001 (host sampling over the pulled logits row)

    def _check_stop(self, req):
        """Stop-string check after an emitted token: the matched string
        (also recorded on the request) or None."""
        if not req.stop:
            return None
        if req._stop_watcher is None:
            req._stop_watcher = StopStringWatcher(req.stop,
                                                  self.detokenizer)
        hit = req._stop_watcher.check(req.output_ids)
        if hit is not None:
            req.matched_stop = hit
        return hit

    def _fork_family(self, req):
        """Split an ``n > 1`` request into its fork family, returning the
        members in sampling order (parent first).  Called at final-chunk
        commit: ``BlockManager.fork`` shares the parent's pages by
        refcount (a child's first private page is a copy-on-write pair
        of a later step), and child ``k`` samples under ``seed + k`` —
        the stream an independent request with that seed would use."""
        if req.n <= 1 or req._forked:
            return [req]
        req._forked = True
        self._invalidate_plan()
        fam = [req]
        for k in range(1, req.n):
            cid = f"{req.request_id}.{k}"
            self.block_manager.fork(req.request_id, cid)
            child = Request(
                request_id=cid, prompt_ids=req.prompt_ids,
                max_new_tokens=req.max_new_tokens,
                eos_token_id=req.eos_token_id,
                temperature=req.temperature,
                seed=req.seed + k, deadline=req.deadline,
                top_k=req.top_k, top_p=req.top_p, min_p=req.min_p,
                repetition_penalty=req.repetition_penalty,
                presence_penalty=req.presence_penalty,
                frequency_penalty=req.frequency_penalty,
                logit_bias=req.logit_bias, logprobs=req.logprobs,
                stop=req.stop, grammar=req.grammar,
                n=1, parent_id=req.request_id, fork_index=k,
                adapter_id=req.adapter_id,
                arrival_time=req.arrival_time,
                num_cached=req.num_cached,
                num_prefill_tokens=req.num_prefill_tokens,
                status=RUNNING)
            if req.grammar is not None:
                child._constraint = ConstraintState(req.grammar)
            self._requests[cid] = child
            self.scheduler.running.append(child)
            self.events.append(
                (self._step_index, "fork", req.request_id, cid))
            fam.append(child)
        return fam

    def _commit_tokens(self, entries, finished):
        """Commit one token per (req, argmax, logits) entry, in order.
        Engine-stream sampling rows share one vectorized gumbel draw
        (bitwise the sequential per-row draws); per-request streams draw
        row by row.  Then each token's logprobs, grammar advance and
        stop checks (stop string, eos, length, in that order)."""
        eng_rows = [j for j, (r, _t, _lg) in enumerate(entries)
                    if r.temperature > 0.0 and r.seed is None]
        picked = {}
        if eng_rows:
            z = np.stack([np.asarray(entries[j][2], np.float64)  # noqa: H001 (host sampling over the pulled logits rows)
                          / entries[j][0].temperature for j in eng_rows])
            g = self._rng.gumbel(size=z.shape)
            for j, t in zip(eng_rows, np.argmax(z + g, axis=-1)):
                picked[j] = int(t)  # noqa: H001 (host numpy token)
        now = self._clock()
        for j, (req, argmax_token, logits) in enumerate(entries):
            if req.temperature > 0.0:
                tok = picked[j] if j in picked \
                    else self._sample_token(req, logits)
            else:
                tok = int(argmax_token)  # noqa: H001 (host numpy token)
            req.output_ids.append(tok)
            if len(req.output_ids) == 1:
                self._first_token_at[req.request_id] = now
            self.stats["tokens_generated"] += 1
            if req.logprobs and logits is not None:
                req.logprobs_content.append(
                    top_logprobs(logits, req.logprobs, tok))
            if req._constraint is not None:
                req._constraint.advance(tok)
            if self._check_stop(req) is not None:
                self._finish(req, FinishReason.STOP, finished)
            elif req.eos_token_id is not None and tok == req.eos_token_id:
                self._finish(req, FinishReason.STOP, finished)
            elif len(req.output_ids) >= req.max_new_tokens:
                self._finish(req, FinishReason.LENGTH, finished)

    def _commit_verified(self, req, argmax_row, logits_row, finished,
                         tree=None):
        """Acceptance and commit of one verify row.

        Tokens emit in position order; a sampled request takes exactly
        one gumbel draw per emitted token (the draft is a point-mass
        proposal, so sample-and-match is exact rejection sampling), so
        its stream stays bitwise aligned with the non-speculative
        engine.  Unaccepted slots roll back before prefix-cache
        registration, so the cache only sees pages of accepted tokens.

        ``tree`` — ``(tmp_id, sibling_token, sib_argmax, sib_logits)`` —
        is the request's 2-token sibling row: if the first emitted token
        misses the chain's draft but equals the sibling, the fork chain
        already holds that branch's K/V and next-token scores, so a
        second token commits from them (one more draw) and the fork is
        promoted to be the request's table.  Any other outcome frees the
        fork; either way the books end as a non-tree commit of the same
        emitted count."""
        drafts = req.draft_tokens
        req.draft_tokens = []
        d = len(drafts)
        self.stats["draft_tokens"] += d
        tmp_id = sib_tok = sib_argmax = sib_logits = None
        if tree is not None:
            tmp_id, sib_tok, sib_argmax, sib_logits = tree
            self.stats["draft_tokens"] += 1      # the sibling proposal
        promoted = False
        reason = None
        emitted = 0
        for j in range(d + 1):
            if req.temperature > 0.0:
                tok = self._sample_token(req, logits_row[j])
            else:
                tok = int(argmax_row[j])  # noqa: H001 (host numpy argmax row)
            req.output_ids.append(tok)
            emitted += 1
            self.stats["tokens_generated"] += 1
            if req.logprobs and logits_row is not None:
                req.logprobs_content.append(
                    top_logprobs(logits_row[j], req.logprobs, tok))
            if req._constraint is not None:
                # position j's mask was packed from the state after
                # drafts[:j], the path walked so far
                req._constraint.advance(tok)
            matched = j < d and tok == drafts[j]
            if matched:
                self.stats["accepted_tokens"] += 1
            if self._check_stop(req) is not None:
                reason = FinishReason.STOP
                break
            if req.eos_token_id is not None and tok == req.eos_token_id:
                reason = FinishReason.STOP
                break
            if len(req.output_ids) >= req.max_new_tokens:
                reason = FinishReason.LENGTH
                break
            if not matched:
                if j == 0 and tmp_id is not None and tok == sib_tok:
                    # tree hit: the target's first token is the sibling
                    # branch, whose K/V and scores are on the fork chain
                    self.stats["accepted_tokens"] += 1
                    self.stats["tree_hits"] += 1
                    promoted = True
                    if req.temperature > 0.0:
                        tok2 = self._sample_token(req, sib_logits[1])
                    else:
                        tok2 = int(sib_argmax[1])
                    req.output_ids.append(tok2)
                    emitted += 1
                    self.stats["tokens_generated"] += 1
                    if req.logprobs and sib_logits is not None:
                        req.logprobs_content.append(top_logprobs(
                            sib_logits[1], req.logprobs, tok2))
                    if self._check_stop(req) is not None:
                        reason = FinishReason.STOP
                    elif req.eos_token_id is not None \
                            and tok2 == req.eos_token_id:
                        reason = FinishReason.STOP
                    elif len(req.output_ids) >= req.max_new_tokens:
                        reason = FinishReason.LENGTH
                break
        pages_before = req.num_cached // self.block_size
        req.num_cached += emitted
        if promoted:
            # the fork chain holds the branch's K/V for positions
            # 0..num_cached-1 and carries exactly num_cached slots:
            # adopt it and drop the main chain with its reservation
            self.block_manager.promote_fork(req.request_id, tmp_id)
        else:
            # the scheduler reserved 1 + d slots; keep the emitted ones
            # (every kept position's token matched its draft)
            self.block_manager.rollback_slots(req.request_id,
                                              1 + d - emitted)
            if tmp_id is not None and self.block_manager.has_seq(tmp_id):
                self.block_manager.free(tmp_id)
        if req.num_cached // self.block_size > pages_before:
            self._register_full_blocks(req)
        if reason is not None:
            self._finish(req, reason, finished)

    def spec_stats(self):
        """Speculative-decoding counters (acceptance rate for benches)."""
        s = self.stats
        prop = s["draft_tokens"]
        out = {"spec_steps": s["spec_steps"],
               "draft_tokens": prop,
               "accepted_tokens": s["accepted_tokens"],
               "acceptance_rate":
                   s["accepted_tokens"] / prop if prop else 0.0}
        if self.spec is not None:
            out["method"] = self.spec.method
        if isinstance(self.drafter, DraftModelDrafter):
            out["model_drafts"] = self.drafter.model_drafts
            out["ngram_drafts"] = self.drafter.ngram_drafts
            out["tree_hits"] = s["tree_hits"]
        return out

    def _drafter_forget(self, request_id):
        """Drop model-drafter state (and the draft pool's pages) of a
        request leaving the engine by any path."""
        if isinstance(self.drafter, DraftModelDrafter):
            self.drafter.forget(request_id)
            if self._draft_bm is not None \
                    and self._draft_bm.has_seq(request_id):
                self._draft_bm.free(request_id)

    # ---------------------------------------------------------- multi-LoRA --
    def add_adapter(self, adapter_id, weights):
        """Register one tenant adapter: ``weights`` maps each configured
        target leaf to ``(A [L, in, r], B [L, r, out])``.  Host-only —
        the device pool slot is written the first time a step batches
        the adapter."""
        if self.lora is None:
            raise ValueError(
                "add_adapter() needs a LoRA-enabled engine — "
                "construct with lora=LoRAConfig(...)")
        self._lora_mgr.register(adapter_id, weights)
        self.events.append((self._step_index, "adapter_register",
                            adapter_id))

    def lora_stats(self):
        """Host-side adapter residency counters: loads, evictions and
        hits plus the registered, resident and slot gauges."""
        if self.lora is None:
            raise ValueError("lora_stats() needs a LoRA-enabled engine")
        return self._lora_mgr.lora_stats()

    def _lora_slot(self, req, pinned):
        """Resident pool slot for one row's adapter, loading it into a
        (possibly LRU-evicted) slot first when absent."""
        slot, weights = self._lora_mgr.acquire(req.adapter_id,
                                               pinned=pinned)
        if weights is not None:
            self._load_adapter_slot(slot, weights)
            self.events.append((self._step_index, "adapter_load",
                                req.adapter_id, slot))
        return slot

    def _load_adapter_slot(self, slot, weights):
        """Write one adapter's host halves into pool slot ``slot`` of
        every layer, in place: ``copy_`` into the existing pool tensors
        on the engine's stream, so the write lands after every step
        already queued (one that still reads the evicted adapter) and
        before the next.  A pool tensor is never replaced: the captured
        graphs read it by address.  The write is idempotent — the
        manager's books say what the slot holds.  At tp > 1 the halves go
        to every worker, and each rank writes its part (a column target's
        B columns, a row target's A rows, a qkv B permuted first)."""
        interleave_point("adapter-load")
        if self._tp is not None:
            self._tp.load_adapter(slot, weights, self.lora.targets)
        self._shard.write_adapter_slot(slot, weights)

    # --------------------------------------------------------- page moves --
    def _gather_pool(self, pool, block_ids):
        """Page rows ``[:, block_ids]`` of one pool as a host numpy array
        in ``block_ids`` order: an index select on the device, then a
        synchronous copy of just those rows (queued after the step in
        flight, complete before the payload is stored), as
        :func:`host_pages` lays it out."""
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),  # noqa: H001 (block ids are a host list)
                              device=pool.device)
        return host_pages(pool[:, idx].cpu())  # noqa: H001 (tier / migration page moves are synchronous host copies by design)

    @staticmethod
    def _payload_tensor(pool, pages):
        """Host pages (as :meth:`_gather_pool` made them) as a tensor of
        the pool's dtype; a payload of another dtype raises."""
        vals = torch.from_numpy(np.ascontiguousarray(pages))
        if pool.dtype == torch.bfloat16:
            vals = vals.view(torch.bfloat16)
        if vals.dtype != pool.dtype:
            raise ValueError(f"page payload {vals.dtype} does not match "
                             f"the pool's {pool.dtype}")
        return vals

    def _scatter_pool(self, pool, block_ids, pages):
        """Write host page rows ``pages`` (as :meth:`_gather_pool` made
        them) into ``pool[:, block_ids]`` in place, on the step's
        stream."""
        vals = self._payload_tensor(pool, pages)
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),  # noqa: H001 (block ids are a host list)
                              device=pool.device)
        pool[:, idx] = vals.to(pool.device)

    def _gather_pair(self, which, block_ids):
        """The pages ``block_ids`` of both pools of ``which`` (K and V,
        or their scales) as host numpy arrays in the global layout.  At
        tp > 1 every rank sends its head slice to rank 0
        (``OP_GATHER``), which joins them on the head axis: the heads in
        the model's own order, as the head-major permutation gives each
        rank a contiguous group."""
        pools = self._shard.page_pools(which)
        if self._tp is None:
            return tuple(self._gather_pool(pool, block_ids)
                         for pool in pools)
        bufs = self._tp.gather_pages(
            which, block_ids, self._shard.read_pages(which, block_ids))
        shapes = self._shard.page_move_shapes(which, len(block_ids))
        ranks = [unpack_bytes(buf, shapes, pools[0].dtype) for buf in bufs]
        return tuple(host_pages(torch.cat([r[i] for r in ranks],
                                          _HEAD_AXIS[which]))
                     for i in range(len(pools)))

    def _scatter_pair(self, which, block_ids, pages):
        """Write the global host ``pages`` of both pools of ``which``
        into the pool rows ``block_ids`` in place.  At tp > 1 every
        payload's dtype is checked before anything is sent, then rank 0
        splits the heads and scatters each rank its slice
        (``OP_SCATTER``), which it writes into its own pools."""
        pools = self._shard.page_pools(which)
        if self._tp is None:
            for pool, p in zip(pools, pages):
                self._scatter_pool(pool, block_ids, p)
            return
        vals = [self._payload_tensor(pool, p) for pool, p in zip(pools,
                                                                 pages)]
        n, axis = self._nh_local, _HEAD_AXIS[which]
        parts = [pack_bytes([v.narrow(axis, r * n, n) for v in vals])
                 for r in range(self.tp)]
        self._shard.write_pages(which, block_ids, self._tp.scatter_pages(
            which, block_ids, parts))

    def _gather_pages(self, block_ids):
        """Host-staged page gather -> (k_pages, v_pages), each [L, n, bs,
        Nh, D] numpy in ``block_ids`` order: the JAX engine's layout, the
        global one at every tp (``Nh`` all the model's heads).  Nothing
        compiles, so the JAX engine's power-of-two padding of the page
        count is left out."""
        return self._gather_pair(PAGES_KV, block_ids)

    def _gather_scale_pages(self, block_ids):
        """Scale-pool counterpart of :meth:`_gather_pages` for the int8
        pool: [L, n, Nh, bs] f32 numpy in ``block_ids`` order."""
        return self._gather_pair(PAGES_SCALES, block_ids)

    def _scatter_pages(self, block_ids, k_pages, v_pages):
        """Host-staged page scatter: the payload's pages into the pool
        rows ``block_ids``, in place (unpadded, as the gather)."""
        self._scatter_pair(PAGES_KV, block_ids, (k_pages, v_pages))

    def _scatter_scale_pages(self, block_ids, k_scales, v_scales):
        """Scale-pool counterpart of :meth:`_scatter_pages`."""
        self._scatter_pair(PAGES_SCALES, block_ids, (k_scales, v_scales))

    # ----------------------------------------------------------- migration --
    def export_request(self, request_id):
        """Serialize one RUNNING request for migration to a peer engine:
        the live Request object, the BlockManager's page-chain export and
        the host-gathered K/V page payload (with the scale pages of an
        int8 pool).  Read-only: the request keeps serving here until
        :meth:`release_request`, so a failed import on the destination
        costs nothing.  The payload is the global layout at every tp, so
        engines of different tp exchange requests."""
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(f"unknown request {request_id!r}")
        if req.status != RUNNING or \
                not self.block_manager.has_seq(request_id):
            raise ValueError(
                f"request {request_id!r} is {req.status}; only running "
                f"sequences with resident pages export (waiting/"
                f"preempted ones requeue from scratch instead)")
        seq = self.block_manager.export_seq(request_id)
        k, v = self._gather_pages(seq["block_ids"])
        self.events.append((self._step_index, "export", request_id,
                            len(seq["block_ids"])))
        state = {"request": req, "seq": seq, "k_pages": k, "v_pages": v}
        if self._kv_quant:
            ks, vs = self._gather_scale_pages(seq["block_ids"])
            state["k_scales"] = ks
            state["v_scales"] = vs
        return state

    def import_request(self, req, seq, k_pages, v_pages,
                       fault_hook=None, k_scales=None, v_scales=None):
        """Adopt a migrated-in request mid-generation: allocate a private
        page chain, write the payload into this engine's pools in place
        (on the step's stream, never rebinding a pool the graphs read),
        re-register its full pages in this prefix cache, and insert the
        request into the running set — decode resumes next step,
        token-exactly (``num_cached``, ``output_ids`` and the per-request
        sampling stream ride the Request object).  A lookahead plan
        staged here is invalidated.

        Guards, in order: the running set has room (MigrationError
        "capacity"), the adapter is servable here (MigrationError
        "adapter"), the payload's shape, then the scale payload, then
        every payload's dtype — all before anything is allocated.
        All-or-nothing after that: any failure (``fault_hook``, the
        injected mid-import fault, anything) frees exactly the pages
        allocated here and re-raises, leaving this engine untouched.  The
        pages are written last, after every guard and the fault hook, so
        no rank's pools hold a page the books do not own."""
        rid = req.request_id
        if rid in self._requests:
            raise ValueError(f"request {rid!r} already live here")
        if len(self.scheduler.running) >= self.max_batch:
            raise MigrationError(
                f"destination running set is full "
                f"({self.max_batch} sequences)", reason="capacity")
        aid = getattr(req, "adapter_id", None)
        if aid is not None and (
                self.lora is None or not self._lora_mgr.known(aid)):
            raise MigrationError(
                f"destination cannot serve adapter {aid!r} — "
                f"{'no lora= configured' if self.lora is None else 'adapter not registered'}",
                reason="adapter")
        expect = (self.num_layers, len(seq["block_ids"]),
                  self.block_size, self.num_heads, self.head_dim)
        if tuple(k_pages.shape) != expect or \
                tuple(v_pages.shape) != expect:
            raise ValueError(
                f"page payload {k_pages.shape} does not fit this pool "
                f"(expected {expect}) — migration requires identically "
                f"configured engines")
        if self._kv_quant:
            if k_scales is None or v_scales is None:
                raise ValueError(
                    "this engine's KV pool is int8 — the migration "
                    "payload must carry k_scales/v_scales (export from "
                    "an identically quantized engine)")
            sexpect = (self.num_layers, len(seq["block_ids"]),
                       self.num_heads, self.block_size)
            if tuple(k_scales.shape) != sexpect or \
                    tuple(v_scales.shape) != sexpect:
                raise ValueError(
                    f"scale payload {k_scales.shape} does not fit this "
                    f"pool (expected {sexpect})")
        elif k_scales is not None or v_scales is not None:
            raise ValueError(
                "scale payload offered to a full-precision pool — "
                "migration requires identically configured engines")
        for which, pages in ((PAGES_KV, (k_pages, v_pages)),
                             (PAGES_SCALES, (k_scales, v_scales))):
            if pages[0] is not None:
                for pool, p in zip(self._shard.page_pools(which), pages):
                    self._payload_tensor(pool, p)
        table = self.block_manager.import_seq(rid, seq)
        try:
            if fault_hook is not None:
                fault_hook()
            self._scatter_pages(table, k_pages, v_pages)
            if self._kv_quant:
                self._scatter_scale_pages(table, k_scales, v_scales)
            self.block_manager.register_imported(rid, seq["hashes"])
        except BaseException:
            # exact reclamation: every page import_seq allocated goes
            # back; nothing was registered before the payload landed
            self.block_manager.free(rid)
            raise
        req.status = RUNNING
        req.draft_tokens = []
        self._requests[rid] = req
        self.scheduler.running.append(req)
        self._invalidate_plan()
        self.events.append((self._step_index, "import", rid,
                            len(table)))

    def release_request(self, request_id):
        """Forget a migrated-away request without emitting an output: its
        pages are reclaimed refcount-correctly (prefix-cache
        registrations survive on the LRU list), model-drafter state and
        any demoted chain dropped, and ownership is now the importing
        engine's.  The mirror of :meth:`import_request`: call it only
        after the import succeeded."""
        req = self._requests.pop(request_id)
        self.scheduler.abort(req)
        self._invalidate_plan()
        self._drafter_forget(request_id)
        self._tier_forget(request_id)
        self.events.append((self._step_index, "release", request_id))

    # ---------------------------------------------------- hierarchical KV --
    def _tier_demote(self, victim):
        """Scheduler preempt hook: stage the victim's page chain into the
        host pool before its pages are freed, so re-admission swaps it
        back in instead of re-prefilling.  Gated three ways — the chain
        must be fully committed, the TierPolicy must price the swap
        under the replay, and the chain must fit the pool budget.  A
        demote-site fault stores nothing (both tiers as before), and the
        preemption falls back to plain recompute.  Never raises."""
        rid = victim.request_id
        pool, bm = self.host_pool, self.block_manager
        if not victim.prefill_done or victim.num_cached <= 0 or \
                bm.num_tokens(rid) != victim.num_cached:
            return
        seq = bm.export_seq(rid)
        npages = len(seq["block_ids"])
        # the global payload: every rank's heads
        nbytes = npages * self.page_bytes * self.tp
        if rid in pool or not pool.fits(nbytes):
            return
        if self.tier_policy.decide(self, victim.num_cached,
                                   npages) != "swap":
            return
        try:
            if self.faults is not None:
                self.faults.tier_fault("demote")
            k, v = self._gather_pages(seq["block_ids"])
        except InjectedFault:
            return
        entry = {"seq": seq, "k_pages": k, "v_pages": v,
                 "k_scales": None, "v_scales": None}
        if self._kv_quant:
            ks, vs = self._gather_scale_pages(seq["block_ids"])
            entry["k_scales"], entry["v_scales"] = ks, vs
        for old in pool.put(rid, entry):
            # chains LRU-evicted to make room lose their swap-in, but
            # their full pages still promote into the prefix store
            self._promote_chain(old)
        self.last_tier_bytes += nbytes
        self.events.append((self._step_index, "demote", rid, npages))

    def _tier_swap_in(self, req, margin):
        """Scheduler admission hook: swap a demoted chain back in.
        Returns None when the request has no demoted chain (normal
        admission follows), "retry" when it has one that cannot land
        this step (capacity, or an injected promote fault — the chain
        stays demoted), or the swapped-in token count.

        Pages still in the prefix cache are adopted instead of
        re-scattered, so only the evicted suffix moves.  The scatter
        writes only pages allocated here, after the ``promote`` fault
        site, and registration comes strictly after it, so a fault
        never exposes a garbage page through the prefix cache."""
        pool, bm = self.host_pool, self.block_manager
        rid = req.request_id
        entry = pool.get(rid)
        if entry is None:
            return None
        seq = entry["seq"]
        n = len(req.all_ids)
        cached = int(seq["num_tokens"])  # noqa: H001 (host sequence record)
        if not 0 < cached < n:
            # a stale chain (the forget paths should have dropped it):
            # recompute from scratch
            self._promote_chain(pool.pop(rid))
            return None
        hashes = bm.prefix_chain_hashes(
            req.all_ids, limit=(n - 1) // bm.block_size,
            salt=req.adapter_id)
        k = bm.match_prefix(hashes)
        if not bm.can_allocate(n, margin=margin,
                               cached_hashes=hashes[:k]):
            return "retry"
        try:
            table = bm.allocate(rid, n, cached_hashes=hashes[:k])
        except NoFreeBlocksError:
            return "retry"
        npay = len(seq["block_ids"])
        moved = max(0, npay - k)
        try:
            if self.faults is not None:
                self.faults.tier_fault("promote")
            if moved:
                self._scatter_pages(table[k:npay],
                                    entry["k_pages"][:, k:npay],
                                    entry["v_pages"][:, k:npay])
                if self._kv_quant:
                    self._scatter_scale_pages(
                        table[k:npay], entry["k_scales"][:, k:npay],
                        entry["v_scales"][:, k:npay])
            bm.register_imported(rid, seq["hashes"])
        except BaseException:
            # exact reclamation: every page allocated above goes back
            # (adopted pages re-park with their contents untouched), and
            # the chain stays demoted for the next attempt
            bm.free(rid)
            return "retry"
        pool.pop(rid, swapped=True)
        req.num_cached = cached
        self.last_tier_bytes += moved * self.page_bytes * self.tp
        self.events.append((self._step_index, "swap_in", rid, moved))
        return cached

    def _tier_prefix_fetch(self, req, hashes, k):
        """Scheduler admission hook: after a normal admission adopted
        ``k`` cached pages, fetch the longest store-resident run of the
        remaining hashes into the allocated table and return its page
        count (the caller extends ``num_cached``).  Policy-gated like a
        demote; a fault (or any failure) mid-fetch returns 0 with the
        fetched pages left unregistered, so prefill recomputes them."""
        store, bm = self.prefix_store, self.block_manager
        run = store.match(hashes[k:])
        if not run:
            return 0
        if self.tier_policy.decide(self, run * bm.block_size,
                                   run) != "swap":
            return 0
        rid = req.request_id
        table = bm.block_table(rid)
        entries = [store.get(h) for h in hashes[k:k + run]]
        try:
            if self.faults is not None:
                self.faults.tier_fault("promote")
            kp = np.concatenate([e["k_pages"] for e in entries], axis=1)
            vp = np.concatenate([e["v_pages"] for e in entries], axis=1)
            self._scatter_pages(table[k:k + run], kp, vp)
            if self._kv_quant:
                ks = np.concatenate([e["k_scales"] for e in entries],
                                    axis=1)
                vs = np.concatenate([e["v_scales"] for e in entries],
                                    axis=1)
                self._scatter_scale_pages(table[k:k + run], ks, vs)
            for i, h in enumerate(hashes[k:k + run]):
                bm.register_full_block(rid, k + i, h)
        except BaseException:
            return 0
        self.last_tier_bytes += sum(
            e["k_pages"].nbytes + e["v_pages"].nbytes for e in entries)
        self.events.append((self._step_index, "store_adopt", rid, run))
        return run

    def _promote_evicted(self, blk, block_hash):
        """BlockManager evict hook: a full page is leaving the prefix
        cache — promote its contents into the host store before the
        block is reused (no-op when its hash is already stored).  The
        pools are written in place, never donated, so unlike the JAX
        engine's hook there is no in-flight state to skip: the gather
        queues behind the step in flight (under lookahead, an eviction
        in ``_stage_next``), which never writes a free page."""
        store = self.prefix_store
        if block_hash in store:
            return
        k, v = self._gather_pages([blk])
        entry = {"seq": {"block_ids": [blk]}, "k_pages": k, "v_pages": v,
                 "k_scales": None, "v_scales": None}
        if self._kv_quant:
            ks, vs = self._gather_scale_pages([blk])
            entry["k_scales"], entry["v_scales"] = ks, vs
        store.put(block_hash, entry)
        self.last_tier_bytes += self.page_bytes * self.tp
        self.events.append((self._step_index, "promote", 1))

    def _promote_chain(self, entry):
        """Promote every registered full page of one demoted chain into
        the prefix store (chain eviction or request exit: the swap-in
        is lost, the prefill work its full pages hold need not be)."""
        store = self.prefix_store
        if store is None or entry is None:
            return
        seq = entry["seq"]
        promoted = 0
        for i, h in enumerate(seq.get("hashes", ())):
            if h is None or h in store:
                continue
            page = {"seq": {"block_ids": [seq["block_ids"][i]]},
                    "k_pages": entry["k_pages"][:, i:i + 1],
                    "v_pages": entry["v_pages"][:, i:i + 1],
                    "k_scales": None, "v_scales": None}
            if entry.get("k_scales") is not None:
                page["k_scales"] = entry["k_scales"][:, i:i + 1]
                page["v_scales"] = entry["v_scales"][:, i:i + 1]
            store.put(h, page)
            promoted += 1
        if promoted:
            self.last_tier_bytes += promoted * self.page_bytes * self.tp
            self.events.append((self._step_index, "promote", promoted))

    def _tier_forget(self, request_id):
        """Drop a request's demoted chain (abort, deadline, quarantine):
        its swap-in can never happen, but its full pages still promote
        into the prefix store."""
        if self.host_pool is not None:
            self._promote_chain(self.host_pool.pop(request_id))

    def adopt_waiting(self, req):
        """Adopt a foreign Request into this engine's waiting queue — the
        fleet's tier-reroute drain path: the source demoted the chain
        into the shared host pool, and this engine's next admission swaps
        it in (or re-prefills ``all_ids`` from scratch if the pool
        evicted it first — token-exact either way).  Unlike
        :meth:`import_request` this needs no free pages now, so a drain
        never waits on destination headroom."""
        rid = req.request_id
        if rid in self._requests:
            raise ValueError(f"request {rid!r} already live here")
        aid = getattr(req, "adapter_id", None)
        if aid is not None and (
                self.lora is None or not self._lora_mgr.known(aid)):
            raise MigrationError(
                f"destination cannot serve adapter {aid!r} — "
                f"{'no lora= configured' if self.lora is None else 'adapter not registered'}",
                reason="adapter")
        req.status = WAITING
        req.num_cached = 0
        req.draft_tokens = []
        self._requests[rid] = req
        self.scheduler.add(req)
        self._invalidate_plan()
        self.events.append((self._step_index, "add", rid))

    def check_invariants(self):
        """Page conservation across every tier: the scheduler's and the
        BlockManager's books, the host pool's and the prefix store's,
        and the cross-tier exclusion that a demoted chain's request owns
        no device pages.  Run after every step when a tier is set."""
        self.scheduler.check_invariants()
        if self.host_pool is not None:
            self.host_pool.check_invariants()
            for rid in self.host_pool._chains:
                if self.block_manager.has_seq(rid):
                    raise RuntimeError(
                        f"request {rid} owns HBM pages AND a demoted "
                        f"host-tier chain")
        if self.prefix_store is not None:
            self.prefix_store.check_invariants()

    def tier_stats(self):
        """Host-tier counters: each tier's residency and traffic plus the
        scheduler's swapped-in token total."""
        if self.kv_tier is None:
            raise ValueError("tier_stats() needs a kv_tier= engine")
        return {
            "swapped_in_tokens": self.scheduler.swapped_in_tokens,
            "host_pool": (self.host_pool.stats()
                          if self.host_pool is not None else None),
            "prefix_store": (self.prefix_store.stats()
                             if self.prefix_store is not None else None),
        }

    # --------------------------------------------------- async lookahead --
    def _stage_next(self, rows):
        """Plan and pack step N+1 on the host while step N runs on the
        card: between the replay's dispatch and the blocking pull.

        Staging fires only when the next step is provably a plain
        all-decode step whose schedule cannot depend on step N's
        outcome: ``lookahead=True``, no fault injector (its per-step
        schedules would misalign) and no model drafter (its draft phase
        launches per step); nothing waiting, every running request
        prefilled with no drafts and no sampling-pipeline row, this step
        all-decode, and no append that would copy on write.  One slot
        per running request is claimed now; the plan stays host-side
        operands until :meth:`_claim_staged` validates it and patches in
        the query tokens step N commits, or :meth:`_discard_staged` rolls
        the claims back exactly."""
        if not self.lookahead or self.faults is not None \
                or self._draft_bm is not None:
            return
        sch = self.scheduler
        running = sch.running
        if sch.waiting or not running:
            return
        for row in rows:
            if row.kind != "decode":
                return
        bm = self.block_manager
        for r in running:
            if not r.prefill_done or r.uses_pipeline \
                    or r.draft_tokens or bm.would_cow(r.request_id):
                return
        plan_rows, claimed = [], []
        try:
            for r in running:
                bm.append_slot(r.request_id)
                claimed.append(r)
                plan_rows.append(RaggedRow(
                    r, "decode", bm.num_tokens(r.request_id) - 1, 1))
        except NoFreeBlocksError:
            # exact inverse, newest claim first: the LIFO free list ends
            # as if nothing was staged
            for r in reversed(claimed):
                bm.rollback_slots(r.request_id, 1)
            return
        pk = self._pack_ragged(plan_rows, [])
        self._staged = (plan_rows, pk)
        self._staged_epoch = self._plan_epoch
        self.stats["staged_steps"] += 1
        self.events.append(
            (self._step_index, "step_staged", len(plan_rows)))

    def _claim_staged(self):
        """Validate and take the staged plan, or discard it.  The plan
        epoch catches every lifecycle mutation since staging; the row
        checks pin the running set and its books to what the stager
        assumed; a drafter's non-empty re-proposal means the sync
        scheduler would build a verify row, so the plan goes.  On
        success each row's query token, committed by the previous step,
        is patched into the packed ids."""
        staged, self._staged = self._staged, None
        if staged is None:
            return None
        t0 = self._timer()
        try:
            plan_rows, pk = staged
            running = self.scheduler.running
            valid = (self._staged_epoch == self._plan_epoch
                     and not self.scheduler.waiting
                     and len(running) == len(plan_rows))
            if valid:
                for row, r in zip(plan_rows, running):
                    if row.request is not r or r.status != RUNNING \
                            or not r.prefill_done or r.draft_tokens \
                            or r.uses_pipeline \
                            or row.start != r.num_cached:
                        valid = False
                        break
            if valid and self.drafter is not None:
                spare = self.token_budget - len(running)
                if spare > 0:
                    for r in running:
                        cap = min(spare, r.max_new_tokens
                                  - len(r.output_ids) - 1)
                        if cap > 0 and self.drafter.propose(
                                r.all_ids, cap,
                                request_id=r.request_id):
                            valid = False
                            break
            if not valid:
                self._discard_staged(plan_rows)
                return None
            for ri, row in enumerate(plan_rows):
                pk["ints"][pk["starts"][ri]] = row.request.all_ids[-1]
            return plan_rows, pk
        finally:
            with self._gauge_lock:
                self._host_plan_s += self._timer() - t0

    def _discard_staged(self, plan_rows):
        """Roll back the staged slot claims exactly, one slot per live
        staged row, newest first (the LIFO free list's inverse), so the
        sync schedule allocates the pages a never-staged engine would."""
        bm = self.block_manager
        for row in reversed(plan_rows):
            req = row.request
            if req.status == RUNNING and req.prefill_done \
                    and bm.has_seq(req.request_id):
                extra = bm.num_tokens(req.request_id) - req.num_cached
                if extra > 0:
                    bm.rollback_slots(req.request_id, extra)

    # ---------------------------------------------------- model drafting --
    def _draft_phase(self):
        """Fill the model drafter's proposals for this step, before
        scheduling.  For every prefilled running request whose n-gram
        draft comes up empty (n-gram hits are free and win), the draft
        model runs over its own pools:

        1. catch-up — the valid draft K/V prefix is the longest common
           prefix of the drafter's fed history and the real ``all_ids``
           (K/V at p depends on tokens [0, p] only); the rest is re-fed
           in token_budget-bounded chunks, and the final fed position's
           argmax is the first draft token (for ``method="tree"`` the
           runner-up of that logits row is the sibling);
        2. chain — up to ``min(K, cap) - 1`` batched one-token greedy
           launches extend every candidate's chain in lockstep.

        A draft-pool OOM skips drafting the request this step; plain
        decode never depends on this phase."""
        dr = self.drafter
        dbm = self._draft_bm
        k_max = self.spec.num_tokens
        dr.proposals = {}
        dr.siblings = {}
        live = {r.request_id for r in self.scheduler.running}
        live.update(r.request_id for r in self.scheduler.waiting)
        for rid in [r for r in dr.history if r not in live]:
            dr.forget(rid)
            if dbm.has_seq(rid):
                dbm.free(rid)
        cands = []
        for r in self.scheduler.running:
            if not r.prefill_done:
                continue
            cap = min(k_max, r.max_new_tokens - len(r.output_ids) - 1)
            if cap <= 0:
                continue
            if dr._ngram.propose(r.all_ids, cap):
                continue            # the free n-gram draft wins this row
            cands.append((r, cap))
        if not cands:
            return
        # draft-pool books and the catch-up work list
        feeds = []
        for r, cap in cands:
            rid = r.request_id
            hist_ids = r.all_ids
            hist = dr.history.get(rid, [])
            lcp = 0
            hmax = min(len(hist), len(hist_ids) - 1)
            while lcp < hmax and hist[lcp] == hist_ids[lcp]:
                lcp += 1
            try:
                if not dbm.has_seq(rid):
                    lcp = 0
                    dbm.allocate(rid, len(hist_ids))
                else:
                    extra = dbm.num_tokens(rid) - lcp
                    if extra > 0:
                        dbm.rollback_slots(rid, extra)
                    dbm.append_slots(rid, len(hist_ids) - lcp)
            except NoFreeBlocksError:
                if dbm.has_seq(rid):
                    dbm.free(rid)
                dr.history.pop(rid, None)
                continue
            feeds.append((r, cap, lcp, hist_ids))
            dr.history[rid] = list(hist_ids)
        if not feeds:
            return
        # catch-up launches: each pending feed chunked through the token
        # budget; a row's final fed position yields the first draft
        # token (and, for trees, the runner-up sibling)
        chains = {}
        want_sib = self.spec.method == "tree"
        work = [[r, cap, lcp, ids] for r, cap, lcp, ids in feeds]
        while work:
            entries, meta, used = [], [], 0
            for w in work:
                if len(entries) >= self.max_batch \
                        or used >= self.token_budget:
                    break
                r, cap, start, ids = w
                c = min(len(ids) - start, self.token_budget - used)
                entries.append((r.request_id, ids[start:start + c], start))
                w[2] = start + c
                used += c
                meta.append((r, w[2] == len(ids)))
            work = [w for w in work if w[2] < len(w[3])]
            nxt, logits, starts = self._draft_launch(entries)
            done = [(i, starts[i] + len(entries[i][1]) - 1)
                    for i, (_r, fin) in enumerate(meta) if fin]
            lg = None
            if want_sib and done:
                # read before the next draft replay overwrites them
                lg = logits[torch.as_tensor([p for _i, p in done],
                                            device=logits.device)]
                lg = lg.float().cpu().numpy()
            for k, (i, p) in enumerate(done):
                r = meta[i][0]
                g0 = int(nxt[p])
                chains[r.request_id] = [g0]
                if lg is not None:
                    row = np.array(lg[k], np.float64)
                    row[g0] = -np.inf
                    dr.siblings[r.request_id] = int(np.argmax(row))
        # the greedy chain: K - 1 batched one-token launches
        act = [(r, cap) for r, cap, _lcp, _ids in feeds
               if chains.get(r.request_id)]
        for _depth in range(1, k_max):
            act = [(r, cap) for r, cap in act
                   if len(chains[r.request_id]) < cap]
            if not act:
                break
            entries, kept = [], []
            for r, cap in act:
                rid = r.request_id
                try:
                    dbm.append_slot(rid)
                except NoFreeBlocksError:
                    continue        # freeze this chain at its depth
                entries.append((rid, [chains[rid][-1]],
                                dbm.num_tokens(rid) - 1))
                kept.append((r, cap))
            if not entries:
                break
            nxt, _logits, starts = self._draft_launch(entries)
            for i, (r, _cap) in enumerate(kept):
                chains[r.request_id].append(int(nxt[starts[i]]))
            act = kept
        # the last chain token was predicted but never fed, so the
        # history (what the draft pool encodes) leaves it out
        for r, cap, _lcp, ids in feeds:
            rid = r.request_id
            chain = chains.get(rid)
            if not chain:
                continue
            dr.proposals[rid] = list(chain[:cap])
            dr.history[rid] = list(ids) + chain[:-1]

    def _draft_launch(self, entries):
        """One launch of the draft model over ``(seq_id, tokens, pos0)``
        rows on the draft BlockManager's tables (no copy-on-write, no
        sampling pipeline) -> (argmax numpy [Tb], logits [Tb, V] on the
        device, row starts).  On CUDA the logits are the draft graph's
        static output: read them before the next draft launch."""
        total = sum(len(toks) for _sid, toks, _p in entries)
        tb = bucket_size(total, self.token_budget, floor=8)
        pk = self._pack_rows(
            [(toks, p0, self._draft_bm.block_table(sid))
             for sid, toks, p0 in entries], tb)
        self.last_launches.append(("ragged", tb))
        self._launch_count += 1
        argmax, logits = self._draft_run(pk)
        return argmax.cpu().numpy(), logits, pk["starts"]  # noqa: H001 (the draft chain's argmax pull — one sync a draft launch by design)

    def _metrics(self, req):
        return {"arrival": req.arrival_time,
                "first_token": self._first_token_at.pop(req.request_id,
                                                        None),
                "finished": self._clock()}

    def _finish(self, req, reason, finished):
        self._invalidate_plan()
        self._drafter_forget(req.request_id)
        self.scheduler.remove_running(req)
        req.status = FINISHED
        req.finish_reason = reason
        del self._requests[req.request_id]
        self.events.append(
            (self._step_index, "finish", req.request_id, reason))
        finished.append(RequestOutput(
            req.request_id, req.prompt_ids, req.output_ids, reason,
            req.num_preemptions,
            logprobs=req.logprobs_content if req.logprobs else None,
            matched_stop=req.matched_stop, metrics=self._metrics(req)))

    # ----------------------------------------------------------- generate --
    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, seed=None, deadline_ms=None, top_k=0,
                 top_p=1.0, min_p=0.0, repetition_penalty=1.0,
                 presence_penalty=0.0, frequency_penalty=0.0,
                 logit_bias=None, logprobs=0, stop=None, grammar=None, n=1,
                 adapter_id=None):
        """Batch convenience: returns one [T+new] int64 array per prompt
        (request order preserved) — or, for ``n > 1``, one list of n
        arrays per prompt (parent first, then forks 1..n-1).  ``seed``
        gives every request of this call its own deterministic sampling
        stream; every other knob applies to each request of the call.
        Shared knobs are validated before any request is queued."""
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        _check_deadline(deadline_ms)
        validate_sampling(top_k, top_p, min_p, repetition_penalty,
                          presence_penalty, frequency_penalty, logit_bias,
                          logprobs, stop, n, vocab_size=self.vocab_size)
        if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
            prompts = list(prompts)
        elif not isinstance(prompts, (list, tuple)):
            prompts = [prompts]
        order = [self.add_request(p, max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  temperature=temperature, seed=seed,
                                  deadline_ms=deadline_ms,
                                  top_k=top_k, top_p=top_p, min_p=min_p,
                                  repetition_penalty=repetition_penalty,
                                  presence_penalty=presence_penalty,
                                  frequency_penalty=frequency_penalty,
                                  logit_bias=logit_bias,
                                  logprobs=logprobs, stop=stop,
                                  grammar=grammar, n=n,
                                  adapter_id=adapter_id)
                 for p in prompts]
        outs = {}
        while self.has_unfinished():
            for fo in self.step():
                outs[fo.request_id] = fo
        if n == 1:
            return [outs[rid].all_ids.astype(np.int64) for rid in order]
        fams = []
        for rid in order:
            group = [outs[rid].all_ids.astype(np.int64)]
            for k in range(1, n):
                cid = f"{rid}.{k}"
                if cid in outs:        # absent only if shed before the fork
                    group.append(outs[cid].all_ids.astype(np.int64))
            fams.append(group)
        return fams


class AsyncLLMEngine:
    """Thread-safe front of an LLMEngine: callers submit from any thread
    (one per HTTP connection in ``HttpLLMServer``) and block on their own
    result while one worker thread steps the engine, so concurrent
    callers batch into the same steps.

    The step runs outside the condition lock, so ``submit()`` returns
    while a step is in flight; the next schedule() admits the request.
    That is safe because ``add_request`` only appends to the scheduler's
    waiting queue and the request dict, and touches no device; all other
    engine state, and every CUDA call, belongs to the worker thread.  On
    CUDA, call ``engine.warmup()`` before constructing this, so every
    bucket's graph is captured on the caller's thread; a bucket missed
    there is captured by the worker, the only thread on the device.

    Lifecycle: ``abort(request_id)`` queues a cancel the worker applies
    between steps; ``result(timeout=)`` expiring aborts the request (a
    caller that gave up must not leave it holding pages);
    ``drain(timeout_s=)`` quiesces without stopping (racing submits are
    shed, so each still gets a terminal output) and reopens admission
    on return; ``close()`` aborts what is in flight, joins the worker,
    and raises if the thread survives.  Timeouts read the engine's
    injected clock.
    """

    _worker_seq = 0     # deterministic worker thread names (interleave)

    def __init__(self, engine):
        self.engine = engine
        self._clock = getattr(engine, "_clock", time.monotonic)
        self._cond = threading.Condition()
        self._results = {}          # request_id -> RequestOutput
        self._aborts = set()        # rids to cancel, applied by the loop
        self._abandoned = set()     # rids whose caller gave up (timeout)
        self._draining = False
        self._stopped = False
        AsyncLLMEngine._worker_seq += 1
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"llm-async-worker-{AsyncLLMEngine._worker_seq}")
        self._thread.start()

    def _loop(self):
        while True:
            with self._cond:
                while not self._stopped and not self._aborts and \
                        not self.engine.has_unfinished():
                    interleave_wait(self._cond, 0.5)
                if self._stopped:
                    break
                aborts, self._aborts = self._aborts, set()
            # engine state is touched only on this thread: queued aborts
            # apply here, between steps
            interleave_point("loop")
            for rid in aborts:
                self.engine.abort_request(rid)
            finished = self.engine.step()    # lock not held
            self._publish(finished)
        # stopped: abort what is still in flight so pages are reclaimed
        # and blocked result() callers get a terminal output (stub
        # engines without the lifecycle surface just stop stepping)
        abort = getattr(self.engine, "abort_request", None)
        if abort is not None:
            for rid in list(getattr(self.engine, "_requests", ())):
                abort(rid)
            while self.engine.has_unfinished():
                self._publish(self.engine.step())
        with self._cond:
            self._cond.notify_all()

    def _publish(self, finished):
        if not finished:
            return
        with self._cond:
            for fo in finished:
                if fo.request_id in self._abandoned:
                    self._abandoned.discard(fo.request_id)
                    continue        # caller timed out and walked away
                self._results[fo.request_id] = fo
            self._cond.notify_all()

    def submit(self, prompt_ids, **kwargs):
        interleave_point("submit")
        with self._cond:
            if self._stopped:
                raise RuntimeError("engine stopped")
            # masked: points inside add_request must not deschedule a
            # thread that holds _cond
            with masked():
                rid = self.engine.add_request(prompt_ids, **kwargs)
            self._cond.notify_all()
            return rid

    def abort(self, request_id):
        """Queue a cancel for ``request_id``; the worker applies it
        before its next step and the aborted output
        (``FinishReason.aborted``) arrives like any other result."""
        interleave_point("abort-queue")
        with self._cond:
            self._aborts.add(request_id)
            self._cond.notify_all()

    def result(self, request_id, timeout=None):
        """Block until the request finishes; returns its RequestOutput.
        On timeout the request is aborted (pages reclaimed, output
        discarded) before TimeoutError is raised."""
        with self._cond:
            deadline = (None if timeout is None
                        else self._clock() + float(timeout))
            while not (request_id in self._results or self._stopped):
                if deadline is not None and self._clock() >= deadline:
                    break
                chunk = 0.1 if deadline is None else \
                    max(0.0, min(0.1, deadline - self._clock()))
                interleave_wait(self._cond, chunk)
            ok = request_id in self._results or self._stopped
            if not ok:
                self._abandoned.add(request_id)
                self._aborts.add(request_id)
                self._cond.notify_all()
                raise TimeoutError(
                    f"request {request_id} timed out and was aborted")
            if request_id in self._results:
                return self._results.pop(request_id)
            raise RuntimeError("engine stopped")

    def generate(self, prompt_ids, timeout=None, **kwargs):
        return self.result(self.submit(prompt_ids, **kwargs),
                           timeout=timeout)

    def drain(self, timeout_s=None):
        """Quiesce without stopping the worker: admission closes (the
        engine sheds, so a submit racing the drain still gets
        ``FinishReason.shed``), every in-flight request completes, and
        admission reopens on return.  ``timeout_s`` bounds the wait:
        requests still running then are aborted, so drain() always ends
        with no page leaked.  Safe from any thread."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("engine stopped")
            self._draining = True
            self.engine._draining = True
            self._cond.notify_all()
        deadline = (None if timeout_s is None
                    else self._clock() + float(timeout_s))
        try:
            with self._cond:
                while not self._stopped:
                    if not self._aborts and \
                            not self.engine.has_unfinished():
                        break
                    if deadline is not None and \
                            self._clock() >= deadline:
                        deadline = None     # abort once, then wait
                        for rid in list(getattr(self.engine,
                                                "_requests", ())):
                            self._aborts.add(rid)
                        self._cond.notify_all()
                        continue
                    interleave_wait(self._cond, 0.02)
        finally:
            with self._cond:
                self.engine._draining = False
                self._draining = False

    def close(self, join_timeout=5.0):
        """Stop the worker: pending requests are aborted (pages
        reclaimed, outputs published with ``FinishReason.aborted``), the
        thread is joined, and a worker that outlives the join raises —
        a stopped engine must not keep calling the device."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            warnings.warn(
                "AsyncLLMEngine worker thread survived close(); a device "
                "step is wedged", RuntimeWarning, stacklevel=2)
            raise RuntimeError(
                f"AsyncLLMEngine worker thread failed to stop within "
                f"{join_timeout}s (wedged device step?)")

    # the JAX package's name for close()
    stop = close
