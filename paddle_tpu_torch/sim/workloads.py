"""Named, seeded, replayable workload traces.

Every trace is a pure function of its arguments — one
``np.random.RandomState(seed)`` drives all draws in a fixed order, so
the same call yields byte-identical arrays forever (the golden
regression tests pin this).  All traces emit the request-tuple schema
``benchmarks/bench_serving.py`` replays:

    (arrivals, prompts, new_tokens)

- ``arrivals``   float64 array of absolute arrival times in seconds
- ``prompts``    list of int32 token-id arrays (vocab 0..127, matching
                 the bench's gpt_tiny)
- ``new_tokens`` list of ints: max_new_tokens per request

(:func:`mixed_trace` is the one schema exception — it models an
everything-at-t=0 burst and returns ``(prompts, new_tokens)`` only,
exactly as the bench's ``--mixed`` mode consumes it.)

The first five builders are verbatim moves of the constructors that
used to be inlined in ``bench_serving.py`` (which now re-imports
them); the rest are the product-shaped scenarios the discrete-event
simulator (:mod:`.simulator`) sweeps at 100+-replica scale: diurnal
traffic, bursty agentic sessions, thousand-tenant prefix mixes,
long-document RAG prefill storms, and a hot-tenant skew for router
policy experiments.  :data:`TRACES` is the registry behind
``bench_serving.py --trace NAME`` and ``build_trace``.
"""

import numpy as np

__all__ = [
    "poisson_trace", "shared_prefix_trace", "repetitive_trace",
    "mixed_trace", "fleet_trace", "diurnal_trace", "agentic_trace",
    "thousand_tenant_trace", "thousand_tenant_lora_trace", "rag_trace",
    "hot_tenant_trace", "structured_output_trace", "TRACES",
    "build_trace",
]


# --------------------------------------------------------------------------
# the five builders extracted verbatim from benchmarks/bench_serving.py
# (draw ORDER against the seeded RandomState is the byte-identity
# contract — do not reorder or refactor the rng calls)
# --------------------------------------------------------------------------
def poisson_trace(n_requests, rate, max_new, seed=0):
    """Memoryless arrivals, mixed short prompts — the default bench
    workload (was ``bench_serving._trace``)."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prompts = [rng.randint(0, 128, (int(rng.randint(2, 14)),))
               .astype(np.int32) for _ in range(n_requests)]
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def shared_prefix_trace(n_requests, rate, max_new, prefix_len, seed=0):
    """Every request = one common system prompt + a short unique tail."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefix = rng.randint(0, 128, (prefix_len,)).astype(np.int32)
    prompts = [np.concatenate(
        [prefix, rng.randint(0, 128, (int(rng.randint(4, 13)),))
         .astype(np.int32)]) for _ in range(n_requests)]
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def repetitive_trace(n_requests, rate, max_new, seed=0):
    """Agentic-style workload for speculative decoding: every prompt is
    a short template pattern repeated (tool-call loops, boilerplate
    edits), so the n-gram drafter has history to look up from step one
    and greedy decode settles into drafable cycles."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prompts = []
    for _ in range(n_requests):
        pat = rng.randint(0, 128, (int(rng.randint(3, 7)),))
        reps = int(rng.randint(2, 4))
        prompts.append(np.tile(pat, reps).astype(np.int32))
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def mixed_trace(n_requests, max_new, seed=0):
    """Trace engineered for mixed ragged steps: long and short prompts
    alternate and everything arrives at t=0, so under a small token
    budget the long prompts chunk across several device steps while the
    short ones race ahead into decode — steps that carry a prefill
    chunk AND decode rows are guaranteed, not incidental."""
    rng = np.random.RandomState(seed)
    prompts = []
    for i in range(n_requests):
        n = (40 + int(rng.randint(8))) if i % 2 == 0 \
            else (3 + int(rng.randint(5)))
        prompts.append(rng.randint(0, 128, (n,)).astype(np.int32))
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return prompts, new_tokens


def fleet_trace(n_requests, rate, max_new, seed=0, tenants=4,
                prefix_len=16):
    """Multi-tenant workload for the fleet router: each request is one
    of ``tenants`` shared tenant prefixes (system prompts, 2 pages at
    block_size=8) plus a short unique tail, so prefix-affinity routing
    has real structure to exploit — same-tenant traffic concentrating
    on one replica turns the shared pages into cache hits instead of
    recomputes on every replica."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefixes = [rng.randint(0, 128, (prefix_len,)).astype(np.int32)
                for _ in range(tenants)]
    prompts = [np.concatenate(
        [prefixes[int(rng.randint(tenants))],
         rng.randint(0, 128, (int(rng.randint(4, 13)),))
         .astype(np.int32)]) for _ in range(n_requests)]
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


# --------------------------------------------------------------------------
# product-scale scenario traces (new; simulator sweeps + --trace rows)
# --------------------------------------------------------------------------
def diurnal_trace(n_requests, rate, max_new, seed=0, period_s=None,
                  trough=0.2):
    """Nonhomogeneous Poisson with a sinusoidal rate — a day of traffic
    compressed into the trace: the instantaneous rate swings between
    ``trough * rate`` and ``rate`` over one ``period_s`` cycle
    (default: sized so the trace spans ~two cycles).  Arrivals are
    drawn by thinning a homogeneous Poisson at the peak rate, which
    keeps the draw count data-independent for a given ``n_requests``."""
    rng = np.random.RandomState(seed)
    if period_s is None:
        period_s = 0.5 * n_requests / rate
    arrivals = []
    t = 0.0
    while len(arrivals) < n_requests:
        t += float(rng.exponential(1.0 / rate))
        phase = 2.0 * np.pi * t / period_s
        lam = trough + (1.0 - trough) * 0.5 * (1.0 + np.sin(phase))
        if rng.uniform() < lam:
            arrivals.append(t)
    arrivals = np.asarray(arrivals)
    prompts = [rng.randint(0, 128, (int(rng.randint(2, 14)),))
               .astype(np.int32) for _ in range(n_requests)]
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def agentic_trace(n_requests, rate, max_new, seed=0, burst=4,
                  prefix_len=16):
    """Bursty agentic loops: sessions arrive Poisson, each firing a
    burst of short follow-up requests in quick succession that all
    share the session's growing prefix (the conversation so far).
    Speculation-friendly — follow-ups are short, repetitive, and
    prefix-cached — and bursty enough to exercise admission control."""
    rng = np.random.RandomState(seed)
    arrivals, prompts = [], []
    t = 0.0
    while len(prompts) < n_requests:
        t += float(rng.exponential(burst / rate))
        session = rng.randint(0, 128, (prefix_len,)).astype(np.int32)
        n_turns = int(rng.randint(1, burst + 1))
        for turn in range(n_turns):
            if len(prompts) >= n_requests:
                break
            tail = rng.randint(0, 128, (int(rng.randint(2, 6)),)) \
                .astype(np.int32)
            session = np.concatenate([session, tail])
            arrivals.append(t + 0.002 * turn)
            prompts.append(session.copy())
    arrivals = np.asarray(arrivals)
    new_tokens = [int(rng.randint(2, max(3, max_new // 2)))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def thousand_tenant_trace(n_requests, rate, max_new, seed=0,
                          tenants=1000, prefix_len=16, alpha=1.1):
    """Shared-prefix mix over many tenants with a Zipf-distributed
    tenant draw — a handful of tenants dominate, the long tail is
    cold.  The scaled-up sibling of :func:`fleet_trace`: router warm
    affinity must pay off on the head without starving the tail."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefixes = {}

    def tenant_prefix(tid):
        if tid not in prefixes:
            trng = np.random.RandomState((seed * 7919 + tid) & 0x7FFFFFFF)
            prefixes[tid] = trng.randint(0, 128, (prefix_len,)) \
                .astype(np.int32)
        return prefixes[tid]

    prompts = []
    for _ in range(n_requests):
        tid = int(rng.zipf(alpha)) % tenants
        prompts.append(np.concatenate(
            [tenant_prefix(tid),
             rng.randint(0, 128, (int(rng.randint(4, 13)),))
             .astype(np.int32)]))
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def thousand_tenant_lora_trace(n_requests, rate, max_new, seed=0,
                               tenants=1000, prefix_len=16, alpha=1.1,
                               adapters=4):
    """:func:`thousand_tenant_trace` plus per-request LoRA
    ``adapter_id``s — the multi-LoRA fleet replay schema
    ``(arrivals, prompts, new_tokens, adapter_ids)``.

    The first three elements are BYTE-IDENTICAL to
    ``thousand_tenant_trace(...)`` with the same arguments: the rng
    draw order is unchanged and the adapter assignment consumes no
    extra draws (``adapter_ids[i] = "adapter-<tid % adapters>"``,
    derived from the same Zipf tenant draw that picked the prefix), so
    a LoRA replay serves exactly the tenant/arrival mix the plain
    trace's goldens pin.  Adapter 0's tenants map to ``None`` — the
    base model — so every replay mixes base and adapter rows in one
    batch.  NOT in :data:`TRACES` (different schema; the bench's
    ``--lora`` mode builds it directly)."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefixes = {}

    def tenant_prefix(tid):
        if tid not in prefixes:
            trng = np.random.RandomState((seed * 7919 + tid) & 0x7FFFFFFF)
            prefixes[tid] = trng.randint(0, 128, (prefix_len,)) \
                .astype(np.int32)
        return prefixes[tid]

    prompts, adapter_ids = [], []
    for _ in range(n_requests):
        tid = int(rng.zipf(alpha)) % tenants
        prompts.append(np.concatenate(
            [tenant_prefix(tid),
             rng.randint(0, 128, (int(rng.randint(4, 13)),))
             .astype(np.int32)]))
        aidx = tid % adapters
        adapter_ids.append(None if aidx == 0 else f"adapter-{aidx}")
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens, adapter_ids


def rag_trace(n_requests, rate, max_new, seed=0, doc_len=48):
    """Long-document RAG prefill storm: every prompt is dominated by a
    retrieved document (``doc_len`` tokens, unique per request — no
    prefix-cache rescue) with a short question tail, and generations
    are tiny.  Chunked prefill and the token budget are the whole
    story; decode is an afterthought."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prompts = [np.concatenate(
        [rng.randint(0, 128, (doc_len,)).astype(np.int32),
         rng.randint(0, 128, (int(rng.randint(3, 8)),))
         .astype(np.int32)]) for _ in range(n_requests)]
    new_tokens = [int(rng.randint(2, max(3, max_new // 4)))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def structured_output_trace(n_requests, rate, max_new, seed=0,
                            prefix_len=8, max_items=4):
    """Structured-output traffic (ROADMAP item 6's explicit leftover):
    every request is a short instruction prompt whose completion is a
    grammar-constrained JSON array — ``[ item (, item)* ] eos`` with
    1..``max_items`` items.  ``new_tokens`` is sized to the exact
    constrained emission length (2 * items + 2: bracket, items with
    separators, closing bracket, eos), so the bench's
    ``--trace structured`` row replays the token economics of
    constrained decoding — short bursts, tight budgets — and the
    per-request ``items`` draw is recoverable from ``new_tokens``.
    The grammar itself lives with the bench/engine
    (:func:`paddle_tpu.inference.llm.structured.json_array_grammar`);
    a trace stays a pure arrival/prompt/length schedule."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prompts = [rng.randint(0, 128, (prefix_len
                                    + int(rng.randint(2, 8)),))
               .astype(np.int32) for _ in range(n_requests)]
    new_tokens = [2 * int(rng.randint(1, max_items + 1)) + 2
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


def hot_tenant_trace(n_requests, rate, max_new, seed=0, tenants=4,
                     prefix_len=16, hot_frac=0.9):
    """Pathological tenant skew for router policy experiments: one hot
    tenant takes ``hot_frac`` of the traffic, the rest split the
    remainder.  Pure warm-affinity routing herds the hot tenant onto
    one replica and overloads it; a load-aware cap should spill the
    excess while keeping the cold tenants warm."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefixes = [rng.randint(0, 128, (prefix_len,)).astype(np.int32)
                for _ in range(tenants)]
    prompts = []
    for _ in range(n_requests):
        if rng.uniform() < hot_frac or tenants == 1:
            tid = 0
        else:
            tid = 1 + int(rng.randint(tenants - 1))
        prompts.append(np.concatenate(
            [prefixes[tid],
             rng.randint(0, 128, (int(rng.randint(4, 13)),))
             .astype(np.int32)]))
    new_tokens = [int(rng.randint(max(2, max_new // 2), max_new + 1))
                  for _ in range(n_requests)]
    return arrivals, prompts, new_tokens


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
# name -> builder taking (n_requests, rate, max_new, seed, **kw) and
# returning (arrivals, prompts, new_tokens).  mixed_trace is excluded
# (different schema: a t=0 burst with no arrivals array).
TRACES = {
    "poisson": poisson_trace,
    "shared_prefix": shared_prefix_trace,
    "repetitive": repetitive_trace,
    "fleet": fleet_trace,
    "diurnal": diurnal_trace,
    "agentic": agentic_trace,
    "thousand_tenant": thousand_tenant_trace,
    "rag": rag_trace,
    "hot_tenant": hot_tenant_trace,
    "structured_output": structured_output_trace,
}

# ``--trace structured`` reads better on the bench command line; both
# names build the identical trace
TRACES["structured"] = structured_output_trace


def build_trace(name, n_requests, rate, max_new, seed=0, **kw):
    """Build a registered trace by name.

    ``shared_prefix`` needs ``prefix_len`` (default 256, the bench's
    ``--prefix-len`` default); every other builder takes the uniform
    ``(n_requests, rate, max_new, seed)`` signature plus its own
    keyword knobs passed through ``**kw``.
    """
    if name not in TRACES:
        raise ValueError(
            f"unknown trace {name!r} — available: "
            f"{', '.join(sorted(TRACES))}")
    fn = TRACES[name]
    if name == "shared_prefix":
        kw.setdefault("prefix_len", 256)
        return fn(n_requests, rate, max_new, kw.pop("prefix_len"),
                  seed=seed, **kw)
    return fn(n_requests, rate, max_new, seed=seed, **kw)
