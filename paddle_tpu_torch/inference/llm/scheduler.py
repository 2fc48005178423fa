"""Continuous-batching scheduler with chunked prefill.

Iteration-level scheduling (Orca / vLLM policy, the serving half of the
Gemma-on-TPU comparison in arxiv 2605.25645): requests join and leave
the batch between steps, and a sequence that cannot get a page is
preempted (pages freed, sequence recomputed later) rather than
deadlocking the pool.

Every step schedules against a fixed TOKEN BUDGET: each running decode
costs one token, and whatever budget remains goes to prefill CHUNKS —
slices of at most ``token_budget`` prompt tokens.  A long prompt
therefore spreads across several steps instead of monopolizing one, and
decodes keep flowing between its chunks (no inter-token latency spike
while a 4k-token prompt prefills).  Admission consults the prefix cache
first: pages whose chain hash is already resident are adopted at zero
compute, so only the un-cached suffix consumes budget.

Shape discipline for XLA: the step's work — decode rows, speculative
verify rows, prefill chunks alike — packs into ONE ragged token batch
(each row a ``RaggedRow`` descriptor), and a jitted executable exists
per TOTAL-TOKEN bucket only: totals are bucketed to powers of two
capped by the token budget, so warmup compiles O(log(token_budget))
programs and steady state recompiles nothing.  Because the executable
no longer encodes the phase, a single device step genuinely mixes
prefill chunks with decode/verify rows instead of segregating them.
"""
# noqa-module: H001 (iteration-level scheduling is host-side by design —
# the scheduler reads finished-token counts and page availability between
# device steps; nothing here runs under jit)

import time
from dataclasses import dataclass, field

from .block_manager import NoFreeBlocksError

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


def bucket_size(n, cap, floor=1):
    """Smallest power of two >= n (>= floor), capped at ``cap``."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return min(b, int(cap))


@dataclass
class Request:
    """One generation request and its mutable scheduling state."""
    request_id: int
    prompt_ids: tuple
    max_new_tokens: int
    eos_token_id: int = None
    temperature: float = 0.0
    seed: int = None            # per-request sampling stream (None: engine RNG)
    deadline: float = None      # absolute clock() deadline (None: no limit)
    # ----- request-surface knobs (inference/llm/sampling.py) -----
    # neutral defaults are exact identities in the device pipeline, so
    # a request that sets none of them is bitwise the legacy request
    top_k: int = 0              # 0 disables
    top_p: float = 1.0          # 1.0 disables
    min_p: float = 0.0          # 0.0 disables
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: dict = None     # {token_id: additive bias} or None
    logprobs: int = 0           # top-N alternatives per emitted token
    stop: tuple = ()            # stop strings (need a detokenizer)
    grammar: object = None      # structured.Grammar (constrained decoding)
    n: int = 1                  # parallel samples (COW fork after prefill)
    parent_id: object = None    # fork family root (None for the parent)
    fork_index: int = 0         # 0 for the parent, 1..n-1 for children
    adapter_id: object = None   # LoRA adapter (None: the base model)
    # stamped by the engine on ITS injected clock (add_request passes
    # arrival_time=self._clock()); -1.0 = never stamped.  No wall-clock
    # default factory — a Request built under VirtualClock must not mix
    # time.monotonic into virtual seconds.
    arrival_time: float = -1.0
    output_ids: list = field(default_factory=list)
    num_cached: int = 0         # tokens whose K/V sit in the paged cache
    num_prefill_tokens: int = 0  # prefill target (len(all_ids) at admission)
    num_preemptions: int = 0
    status: str = WAITING
    finish_reason: str = None
    # draft tokens proposed for THIS step's verify launch (speculative
    # decoding); empty means the row rides the plain decode executable
    draft_tokens: list = field(default_factory=list)
    # per-token logprobs content [(chosen_lp, [(tid, lp), ...]), ...]
    logprobs_content: list = field(default_factory=list)
    matched_stop: str = None    # the stop string that finished us
    _sample_rng: object = field(default=None, repr=False, compare=False)
    _constraint: object = field(default=None, repr=False, compare=False)
    _stop_watcher: object = field(default=None, repr=False, compare=False)
    _forked: bool = field(default=False, repr=False, compare=False)

    @property
    def all_ids(self):
        """prompt + generated so far (the recompute unit after preempt)."""
        return list(self.prompt_ids) + self.output_ids

    @property
    def uses_pipeline(self):
        """True when this request needs non-neutral device pipeline
        operands packed (any filter/penalty/bias/constraint active)."""
        return (self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0
                or self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or bool(self.logit_bias)
                or self._constraint is not None)

    @property
    def prefill_done(self):
        """True once every token known at admission has K/V in the cache
        (in steady decode the newest token's K/V is written BY the next
        decode step, so num_cached stays one behind len(all_ids))."""
        return self.num_cached >= self.num_prefill_tokens


@dataclass
class PrefillChunk:
    """One slice of one request's prefill: compute K/V for tokens
    [start, start + length) this step.  The final chunk (start + length
    == len(all_ids)) also yields the request's next token."""
    request: object
    start: int
    length: int

    @property
    def is_final(self):
        return self.start + self.length >= self.request.num_prefill_tokens


@dataclass
class RaggedRow:
    """One row of the step's ragged token batch: ``length`` query
    tokens for ``request`` at absolute positions [start, start +
    length).  kind is "decode" (length 1), "verify" (1 + K drafts),
    "chunk" (a PrefillChunk slice, carried in ``chunk``), or "tree"
    (a 2-token sibling row verifying the draft model's second-best
    first token on a COW fork chain — ``table_id`` names the fork's
    temporary sequence, ``sibling`` the alternative token)."""
    request: object
    kind: str                   # "decode" | "verify" | "chunk" | "tree"
    start: int
    length: int
    chunk: object = None        # the PrefillChunk for kind == "chunk"
    table_id: object = None     # block-table key (tree fork rows only)
    sibling: int = None         # the tree branch's first-position token


@dataclass
class ScheduledBatch:
    kind: str                   # "mixed" | "decode" | "idle"
    requests: list              # decode/verify rows this step
    chunks: list = field(default_factory=list)   # PrefillChunks this step
    # the same work as one ragged token batch: decode/verify rows first
    # (in ``requests`` order), then chunk rows (in ``chunks`` order) —
    # the commit order the engine's RNG-stream exactness depends on
    rows: list = field(default_factory=list)
    # copy-on-write (src_block, dst_block) pairs this step's appends
    # triggered (a fork sibling diverging off a shared partial tail
    # page) — the engine copies the page CONTENTS inside the launch
    cows: list = field(default_factory=list)


class Scheduler:
    """Admission queue + running set + preempt-on-OOM policy."""

    def __init__(self, block_manager, max_batch=8, watermark_blocks=1,
                 token_budget=64, drafter=None, lora_slots=None):
        self.block_manager = block_manager
        self.max_batch = int(max_batch)
        # multi-LoRA: at most this many DISTINCT non-base adapters may
        # be live in the running set at once (the engine passes
        # max_adapters - 1 — pool slots minus the reserved base slot),
        # so every launch's slot acquisition is guaranteed to succeed
        # without evicting an adapter the same launch indexes
        self.lora_slots = None if lora_slots is None else int(lora_slots)
        self.watermark_blocks = int(watermark_blocks)
        # the budget must cover one decode token per running sequence,
        # or a full batch would starve every waiting prefill forever
        self.token_budget = max(int(token_budget), self.max_batch)
        # speculative decoding: a drafter proposes up to K draft tokens
        # per decode row; drafts are charged against the SAME token
        # budget (a verify row costs 1 + len(drafts) tokens), so
        # speculation and chunked prefill share the step fairly
        self.drafter = drafter
        self.waiting = []       # FIFO; preempted sequences rejoin at the head
        self.running = []       # arrival order == preemption priority
        self.num_preemptions = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        # hierarchical KV (engine-provided, kv_tier.py): demote_hook
        # runs inside _preempt between table removal and page free (the
        # chain is still resident — last chance to stage it to the host
        # tier); swap_in_hook runs at admission for requests whose
        # chain is demoted (swap pages back instead of re-prefilling);
        # prefix_fetch_hook runs after a normal admission to adopt
        # store pages beyond the HBM prefix hit.  All None on a
        # tier-less engine — the legacy paths are byte-identical.
        self.demote_hook = None
        self.swap_in_hook = None
        self.prefix_fetch_hook = None
        self.swapped_in_tokens = 0

    def add(self, request):
        self.waiting.append(request)

    def has_unfinished(self):
        return bool(self.waiting or self.running)

    def queue_depth(self):
        """Requests admitted but not yet running (the load-shed gauge)."""
        return len(self.waiting)

    def remove_running(self, request):
        self.running.remove(request)
        self.block_manager.free(request.request_id)

    def abort(self, request):
        """Remove ``request`` from whichever queue holds it, reclaiming
        pages refcount-correctly in every state: waiting (no pages),
        preempted (re-queued at the waiting head, pages already freed),
        chunk-prefilling or decoding (running: the block table is freed,
        shared/COW pages drop one reference, and prefix-cache
        registrations survive on the LRU list).  Pending draft tokens
        are dropped.  Returns True when the request was queued here."""
        request.draft_tokens = []
        if request in self.running:
            self.running.remove(request)
            self.block_manager.free(request.request_id)
            return True
        if request in self.waiting:
            self.waiting.remove(request)
            if self.block_manager.has_seq(request.request_id):
                # defensive: waiting sequences own no pages (preemption
                # frees them), but never leak if that ever changes
                self.block_manager.free(request.request_id)
            return True
        return False

    def expire_deadlines(self, now):
        """Pop every request whose ``deadline`` has passed (waiting OR
        running — a deadline miss mid-generation still frees its pages).
        Returns the expired requests; the engine assigns the
        FinishReason and emits their outputs."""
        expired = [r for r in self.waiting
                   if r.deadline is not None and now >= r.deadline]
        expired += [r for r in self.running
                    if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self.abort(req)
        return expired

    # ------------------------------------------------------------ policy --
    def schedule(self):
        """Pick one step's work: decode every fully-prefilled running
        sequence (preempting the newest arrival on page OOM), then spend
        the remaining token budget on prefill chunks — first continuing
        mid-prefill sequences, then admitting waiting requests whose
        pages fit (prefix-cached pages are adopted, not recomputed).
        The watermark keeps a reserve of pages so a fresh admission
        can't immediately preempt the running set."""
        bm = self.block_manager
        budget = self.token_budget
        decodes, chunks = [], []
        # COW pairs keyed by request id: a fork sibling's first private
        # append off a shared partial tail page.  Keyed (not a flat
        # list) so a later preemption in this same pass can revoke the
        # victim's pair — its dst page went back to the pool and could
        # be re-allocated this very step.
        cowmap = {}

        # -- decode phase: one slot per fully-prefilled running sequence,
        # plus up to K draft slots each when a drafter is attached.  One
        # decode token per pending sequence is reserved UP FRONT, so a
        # greedy drafter can spend only the spare budget and never
        # starves another sequence's decode slot.
        spare = budget - sum(1 for r in self.running if r.prefill_done)
        trees = {}              # request_id -> (tmp_id, sibling_token)
        i = 0
        while i < len(self.running):
            req = self.running[i]
            if not req.prefill_done:
                i += 1
                continue        # mid-prefill: the chunk phase feeds it
            drafts = []
            if self.drafter is not None and spare > 0:
                # the bonus token always lands, so draft at most
                # max_new - generated - 1 (a draft past the length cap
                # could never be accepted into the output)
                cap = min(spare,
                          req.max_new_tokens - len(req.output_ids) - 1)
                if cap > 0:
                    drafts = self.drafter.propose(
                        req.all_ids, cap, request_id=req.request_id)
            tmp_id = sib = None
            try:
                if drafts:
                    sib = (self.drafter.sibling_token(req.request_id)
                           if hasattr(self.drafter, "sibling_token")
                           else None)
                if sib is not None and spare - len(drafts) >= 2 \
                        and not self.waiting \
                        and not req.uses_pipeline \
                        and len(self.running) + len(trees) \
                        < self.max_batch:
                    # tree branch: fork BEFORE the parent's own
                    # reservation, so the 2-token sibling row COWs off
                    # the shared partial tail and the parent appends on
                    # a now-private chain — the two writes of position
                    # T-1 land on different pages.  Row-count gate: the
                    # descriptor batch is FIXED at max_batch rows, and
                    # with no admissions pending, decode + chunk rows
                    # are bounded by len(running).
                    tmp_id = (req.request_id, "tree")
                    try:
                        bm.fork(req.request_id, tmp_id)
                        _s, tcws = bm.append_slots(tmp_id, 2)
                        if tcws:
                            cowmap[tmp_id] = tcws[0]
                    except NoFreeBlocksError:
                        if bm.has_seq(tmp_id):
                            bm.free(tmp_id)
                        cowmap.pop(tmp_id, None)
                        tmp_id = None
                if drafts:
                    try:
                        _slots, cws = bm.append_slots(
                            req.request_id, 1 + len(drafts))
                        if cws:
                            cowmap[req.request_id] = cws[0]
                    except NoFreeBlocksError:
                        drafts = []   # degrade to plain decode first
                        if tmp_id is not None:
                            bm.free(tmp_id)
                            cowmap.pop(tmp_id, None)
                            tmp_id = None
                if not drafts:
                    _slot, cw = bm.append_slot(req.request_id)
                    if cw is not None:
                        cowmap[req.request_id] = cw
            except NoFreeBlocksError as e:
                if tmp_id is not None:
                    bm.free(tmp_id)
                    cowmap.pop(tmp_id, None)
                victim = self.running[-1]
                if victim is req and len(self.running) == 1 and \
                        not getattr(e, "injected", False):
                    # a REAL pool too small for one sequence can never
                    # make progress; an injected OOM fires once per
                    # step, so self-preempt + recompute recovers
                    raise RuntimeError(
                        "KV cache cannot hold a single sequence — "
                        "raise num_blocks or lower max_model_len")
                if victim.prefill_done:
                    spare += 1  # its reserved decode token is freed
                cowmap.pop(victim.request_id, None)
                self._preempt(victim)
                continue        # retry req (or fall off the end)
            req.draft_tokens = drafts
            spare -= len(drafts)
            if tmp_id is not None:
                trees[req.request_id] = (tmp_id, sib)
                spare -= 2      # the sibling row's two query tokens
            decodes.append(req)
            i += 1
        budget = spare

        # -- chunk phase: continue sequences already mid-prefill
        for req in self.running:
            if budget <= 0:
                break
            if req.prefill_done:
                continue
            n = len(req.all_ids)
            c = min(budget, n - req.num_cached)
            chunks.append(PrefillChunk(req, req.num_cached, c))
            budget -= c

        # -- admission: waiting requests, prefix cache consulted first.
        # Un-forked n>1 parents in the running set RESERVE their n-1
        # future fork slots here, so the fork (which bypasses
        # admission) can never push the running set past max_batch.
        reserved = sum(r.n - 1 for r in self.running
                       if r.n > 1 and not r._forked)
        # multi-LoRA admission gate: the DISTINCT adapters of the
        # running set must fit the device pool's non-base slots, so a
        # head-of-line request bringing a NEW adapter waits (FIFO, like
        # the capacity breaks below) until a tenant drains
        live_adapters = {r.adapter_id for r in self.running
                         if r.adapter_id is not None}
        while self.waiting and budget > 0:
            req = self.waiting[0]
            if len(self.running) + reserved + req.n > self.max_batch:
                break
            if (self.lora_slots is not None
                    and req.adapter_id is not None
                    and req.adapter_id not in live_adapters
                    and len(live_adapters) >= self.lora_slots):
                break
            n = len(req.all_ids)
            margin = self.watermark_blocks if self.running else 0
            # hierarchical KV: a chain demoted to the host tier swaps
            # back in instead of re-prefilling.  The hook returns None
            # (not demoted — fall through to the normal path), "retry"
            # (demoted but cannot land this step: no room, or the
            # attempt faulted — FIFO head-of-line, like the capacity
            # breaks), or the swapped-in token count (pages allocated,
            # payload scattered, num_cached already set).
            if self.swap_in_hook is not None:
                swapped = self.swap_in_hook(req, margin)
                if swapped == "retry":
                    break
                if swapped is not None:
                    self.waiting.pop(0)
                    req.num_prefill_tokens = n
                    req.status = RUNNING
                    self.running.append(req)
                    if req.adapter_id is not None:
                        live_adapters.add(req.adapter_id)
                    if req.n > 1 and not req._forked:
                        reserved += req.n - 1
                    self.prompt_tokens += n
                    self.swapped_in_tokens += int(swapped)
                    # the swapped chain covers n-1 tokens; the final
                    # chunk recomputes only the last position, whose
                    # logits seed the next token (token-exact, same as
                    # a full-prefix-hit admission)
                    c = min(budget, n - req.num_cached)
                    chunks.append(PrefillChunk(req, req.num_cached, c))
                    budget -= c
                    continue
            # at least the last token must be computed (its logits seed
            # the first generated token), so cap reuse at n-1 tokens
            hashes = bm.prefix_chain_hashes(
                req.all_ids, limit=(n - 1) // bm.block_size,
                salt=req.adapter_id)
            k = bm.match_prefix(hashes)
            if not bm.can_allocate(n, margin=margin,
                                   cached_hashes=hashes[:k]):
                break
            self.waiting.pop(0)
            try:
                bm.allocate(req.request_id, n, cached_hashes=hashes[:k])
            except NoFreeBlocksError:
                # can_allocate said yes but allocate refused (an
                # injected fault, or pressure from a racing path):
                # re-queue at the head and stop admitting this step
                self.waiting.insert(0, req)
                break
            req.num_cached = k * bm.block_size
            if self.prefix_fetch_hook is not None:
                # fleet-wide prefix store: adopt full pages beyond the
                # HBM hit run (payload scattered + registered by the
                # engine; returns the page count, 0 on a faulted or
                # policy-refused fetch — those pages just prefill)
                req.num_cached += self.prefix_fetch_hook(
                    req, hashes, k) * bm.block_size
            req.num_prefill_tokens = n
            req.status = RUNNING
            self.running.append(req)
            if req.adapter_id is not None:
                live_adapters.add(req.adapter_id)
            if req.n > 1 and not req._forked:
                reserved += req.n - 1
            self.prompt_tokens += n
            # HBM-resident hits only — store adoptions count in the
            # engine's tier_stats, not the legacy hit rate
            self.prefix_hit_tokens += k * bm.block_size
            c = min(budget, n - req.num_cached)
            chunks.append(PrefillChunk(req, req.num_cached, c))
            budget -= c

        rows = []
        for r in decodes:
            rows.append(RaggedRow(
                r, "verify" if r.draft_tokens else "decode",
                r.num_cached, 1 + len(r.draft_tokens)))
            if r.request_id in trees:
                tmp_id, sib = trees[r.request_id]
                rows.append(RaggedRow(r, "tree", r.num_cached, 2,
                                      table_id=tmp_id, sibling=sib))
        rows += [RaggedRow(ch.request, "chunk", ch.start, ch.length,
                           chunk=ch) for ch in chunks]
        cows = [cowmap[r.request_id] for r in decodes
                if r.request_id in cowmap]
        cows += [cowmap[t] for t, _sib in trees.values() if t in cowmap]
        if chunks:
            return ScheduledBatch("mixed", decodes, chunks, rows,
                                  cows=cows)
        if decodes:
            return ScheduledBatch("decode", decodes, rows=rows,
                                  cows=cows)
        return ScheduledBatch("idle", [])

    def check_invariants(self):
        """Assert the host-side books balance: every running sequence
        owns a table, every waiting one owns none, and the block
        manager's page accounting is self-consistent.

        Scheduling is pure host state, so under tensor parallelism the
        SAME tables/decisions drive every shard — there is exactly one
        allocator no matter how many devices execute the step.  The TP
        engine calls this after each step to pin that down: if the
        books balance, every shard saw identical page traffic.
        """
        bm = self.block_manager
        for req in self.running:
            if not bm.has_seq(req.request_id):
                raise RuntimeError(
                    f"running request {req.request_id} owns no block table")
        for req in self.waiting:
            if bm.has_seq(req.request_id):
                raise RuntimeError(
                    f"waiting request {req.request_id} still owns pages")
        bm.check_invariants()

    def _preempt(self, victim):
        """Recompute-style preemption: drop the pages, queue the sequence
        (prompt + generated so far) for a fresh prefill.  With prefix
        caching on, the dropped pages stay hash-addressable until memory
        pressure actually evicts them, so the recompute usually re-adopts
        most of its own work."""
        self.running.remove(victim)
        if self.demote_hook is not None:
            # hierarchical KV: the chain is out of the running set but
            # still resident — the engine stages it to the host tier
            # here (policy- and fault-gated; never raises), so the
            # free below demotes instead of discarding
            self.demote_hook(victim)
        self.block_manager.free(victim.request_id)
        victim.num_cached = 0
        victim.draft_tokens = []
        victim.num_preemptions += 1
        victim.status = WAITING
        self.num_preemptions += 1
        self.waiting.insert(0, victim)
