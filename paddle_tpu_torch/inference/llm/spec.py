"""Model-free speculative decoding: prompt-lookup n-gram drafting.

Decode throughput at small batch is launch-latency-bound on TPU — the
device finishes a one-token step long before the host can schedule the
next one.  Speculative decoding amortizes that: a cheap DRAFTER guesses
the next K tokens of each running sequence and one jitted VERIFY step
scores all K+1 positions through the paged pool at once (the verify
executable is the decode body over a flattened [B*(K+1)] row batch —
see LLMEngine).  Accepted tokens commit in bulk; the first mismatch
falls back to the target model's own token, so output is exactly what
step-by-step decode would have produced.

The drafter here is prompt lookup (model-free n-gram matching, the
"assisted generation without a draft model" trick): the last few tokens
of a sequence are searched for earlier in its own prompt+output history,
and the continuation of the most recent previous occurrence becomes the
draft.  Repetitive workloads — agentic tool loops, code edits, extractive
summaries, shared boilerplate — hit constantly; free-form prose rarely
matches and the engine transparently degrades to plain decode (a
sequence with no draft costs exactly one decode slot, as before).

Acceptance rule (per sequence, drafts d_0..d_{K-1}, verify row gives the
target distribution at every position):

- greedy: commit the longest prefix with d_j == argmax_j, plus the
  target's own argmax at the first mismatch (the "bonus" token) —
  bitwise identical to non-speculative greedy by construction;
- temperature > 0: walk the positions in order, drawing ONE gumbel
  sample from the request's stream per emitted token; while the sample
  equals the draft, keep going.  Each emitted token is an exact sample
  from the target softmax (the draft proposes a point mass, so
  sample-and-match IS rejection sampling for that proposal), and the
  draw count equals the emit count — per-request seeded streams stay
  bitwise identical to the non-speculative engine.
"""
# noqa-module: H001 (the n-gram drafter scans host token histories by
# design — drafting must not cost a device launch; the jitted verify
# executable lives in engine.py)

from dataclasses import dataclass


def rollback_draft_reservation(block_manager, request):
    """Return every speculative slot reserved for ``request`` that has
    not been committed: the scheduler claims ``1 + K`` slots up front
    (append_slots) for a verify launch, so an abort or a quarantined
    step between reservation and commit must shrink the reservation
    back to ``num_cached`` before the pages are counted or freed —
    otherwise the books show phantom tokens on a request that never
    emitted them.  Drops the pending draft list too.  No-op for a
    request with no outstanding reservation (plain decode rows roll
    back their single slot through the same arithmetic)."""
    request.draft_tokens = []
    if not block_manager.has_seq(request.request_id) \
            or not request.prefill_done:
        # mid-prefill rows hold their PROMPT allocation, not a
        # speculative reservation — nothing to roll back
        return 0
    extra = block_manager.num_tokens(request.request_id) \
        - request.num_cached
    if extra > 0:
        block_manager.rollback_slots(request.request_id, extra)
    return max(extra, 0)


@dataclass
class SpeculativeConfig:
    """Knobs for speculative decoding.

    num_tokens: max draft length K per sequence per step (the verify
        executable family is bucketed over powers of two up to K).
    max_ngram / min_ngram: the drafter matches the longest suffix of the
        history between these lengths (longer matches first — a 3-gram
        hit is a stronger signal than a 1-gram hit).
    method: "ngram" (model-free prompt lookup, the default), or
        "draft-model" / "tree" — a tiny draft MODEL served through the
        same engine: the target's first ``draft_layers`` transformer
        blocks plus zero-padded identity blocks ride the SAME ragged
        executable family against a second set of paged pools, drafted
        greedily K deep.  "tree" additionally verifies the draft
        model's second-best first token on a 2-token COW fork row, so
        a first-position miss can still commit two tokens.  Both are
        HYBRID: prompt-lookup hits are proposed first (they are free),
        the model drafts only the misses — acceptance is therefore
        never below the plain n-gram drafter's.
    draft_layers: how many leading target layers the draft model keeps
        (the rest are exact-identity zero blocks, so the draft shares
        the target's executable, leaf shapes and compile census).
    """
    num_tokens: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    method: str = "ngram"
    draft_layers: int = 1

    METHODS = ("ngram", "draft-model", "tree")

    def __post_init__(self):
        if self.num_tokens < 1:
            raise ValueError("speculative num_tokens must be >= 1")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{self.min_ngram}..{self.max_ngram}")
        if self.method not in self.METHODS:
            raise ValueError(
                f"speculative method must be one of {self.METHODS}, "
                f"got {self.method!r}")
        if self.draft_layers < 1:
            raise ValueError("draft_layers must be >= 1")

    @property
    def uses_draft_model(self):
        return self.method in ("draft-model", "tree")

    @classmethod
    def resolve(cls, spec):
        """Engine-kwarg sugar: None | K | method str | dict |
        SpeculativeConfig."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, bool):      # speculative=True: defaults
            return cls() if spec else None
        if isinstance(spec, int):
            return cls(num_tokens=spec)
        if isinstance(spec, str):
            return cls(method=spec)
        if isinstance(spec, dict):
            return cls(**spec)
        raise TypeError(
            f"speculative= takes None/bool/int/str/dict/"
            f"SpeculativeConfig, got {type(spec).__name__}")


class NgramDrafter:
    """Prompt-lookup drafting over a sequence's own token history.

    ``propose`` scans for the most recent earlier occurrence of the
    history's trailing n-gram (longest n first) and returns the tokens
    that followed it.  Pure host-side; O(len(history) * max_ngram) per
    call on lists of python ints — negligible next to a device step.
    """

    def __init__(self, config):
        self.config = config

    def propose(self, token_ids, max_tokens, request_id=None):
        """Draft up to ``max_tokens`` next tokens for ``token_ids``
        (prompt + output so far).  Returns [] when no n-gram of length
        min_ngram..max_ngram recurs, or when the budget is 0.
        ``request_id`` is accepted for drafter-protocol uniformity
        (the model-based drafter keys its per-request cache by it)."""
        cfg = self.config
        n_hist = len(token_ids)
        max_tokens = min(int(max_tokens), cfg.num_tokens)
        if max_tokens <= 0 or n_hist <= cfg.min_ngram:
            return []
        for n in range(min(cfg.max_ngram, n_hist - 1), cfg.min_ngram - 1,
                       -1):
            tail = token_ids[n_hist - n:]
            # most recent earlier occurrence wins (recency beats the
            # prompt: the sequence's own output is the better predictor)
            for start in range(n_hist - n - 1, -1, -1):
                if token_ids[start:start + n] == tail:
                    cont = token_ids[start + n:start + n + max_tokens]
                    if cont:
                        return list(cont)
        return []


class DraftModelDrafter:
    """Model-based drafting through the serving engine itself.

    The drafter half is pure host state: per-request model proposals
    (and, for ``method="tree"``, the second-best first-round token)
    filled by the engine's batched draft phase each step — the engine
    owns the draft params/pools and issues the launches, this object
    owns the books.  ``propose`` is HYBRID: a prompt-lookup hit is
    returned first (a free draft the model could only tie), so
    acceptance is bounded below by the plain :class:`NgramDrafter`.

    ``history`` maps request id -> the token list the DRAFT paged pool
    currently encodes (real tokens plus greedily-fed drafts).  The
    valid draft-KV prefix of a sequence is the longest common prefix
    of its history entry and its real ``all_ids`` — K/V at position p
    depends on tokens [0, p] only, so everything past the first
    divergence is stale and the engine's catch-up chunk re-feeds it.
    """

    def __init__(self, config):
        self.config = config
        self._ngram = NgramDrafter(config)
        self.proposals = {}     # rid -> model-drafted greedy chain
        self.siblings = {}      # rid -> 2nd-best first token ("tree")
        self.history = {}       # rid -> tokens encoded in the draft pool
        # counters for spec_stats/bench: how many scheduled drafts came
        # from the model vs the free n-gram path
        self.model_drafts = 0
        self.ngram_drafts = 0

    def propose(self, token_ids, max_tokens, request_id=None):
        """Scheduler hook: n-gram hit first, else this step's cached
        model proposal (filled by the engine's draft phase).  A
        returned n-gram draft drops the request's tree sibling — the
        sibling is an alternative to the MODEL chain's first token and
        must never pair with a lookup chain."""
        ng = self._ngram.propose(token_ids, max_tokens)
        if ng:
            self.siblings.pop(request_id, None)
            self.ngram_drafts += len(ng)
            return ng
        cap = min(int(max_tokens), self.config.num_tokens)
        prop = self.proposals.get(request_id, [])[:max(cap, 0)]
        if not prop:
            self.siblings.pop(request_id, None)
            return []
        self.model_drafts += len(prop)
        return list(prop)

    def sibling_token(self, request_id):
        """The tree-branch alternative for this request's first draft
        position, or None (ngram chain, no model proposal, or
        method="draft-model")."""
        if self.config.method != "tree":
            return None
        return self.siblings.get(request_id)

    def forget(self, request_id):
        """Drop all per-request state (finished/aborted/released)."""
        self.proposals.pop(request_id, None)
        self.siblings.pop(request_id, None)
        self.history.pop(request_id, None)
