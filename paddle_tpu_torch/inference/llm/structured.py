"""Grammar/JSON-constrained decoding as a vocab-mask logit hook.

Constrained decoding rides the sampling pipeline's bias channel
(sampling.py): for each scheduled query position the engine asks the
request's :class:`ConstraintState` for the allowed-token mask of the
CURRENT grammar state, writes ``FILTERED`` into the bias row of every
disallowed token, and the one ragged executable applies it like any
other logit bias — no new executables, no host sync inside the step.
The split of labor:

- mask COMPILATION is host work, once per grammar STATE: a grammar's
  ``allowed(state)`` boolean vocab vector is computed lazily and
  cached on the grammar object, so every request (and every step)
  sharing a state reuses the same mask;
- mask APPLICATION is device work, inside the jitted step, through the
  ``[Tb, V]`` bias operand that buckets with the token axis;
- state ADVANCE is host work again, in the commit phase, driven by the
  emitted token — intentional host-side control flow, tagged where it
  touches fetched values.

Composition with speculative decoding is exact by construction: a
verify row's position ``j`` is masked with the state reached through
the draft prefix ``drafts[:j]`` (the engine walks the states while
packing), and acceptance compares the draft against the argmax of the
MASKED logits — so an illegal draft token can never be accepted, and
the accepted prefix is bitwise the sequence the non-speculative masked
run would have produced.  A draft prefix that leaves the grammar (no
transition) dead-ends: later positions pack unconstrained, but
acceptance already stopped at the first illegal token, so they are
never committed.

Constraints apply to GENERATED tokens only — the prompt is the
client's text, so prefix caching (prompt pages) composes trivially.
"""
# noqa-module: H001 (grammar compilation and state advance are
# host-side by contract; the masks they produce are applied on DEVICE
# through the ragged step's bias operand)

import numpy as np

from .sampling import FILTERED

__all__ = [
    "Grammar", "DfaTokenGrammar", "json_array_grammar",
    "grammar_from_spec", "ConstraintState",
]


class Grammar:
    """Interface a constraint grammar implements (token-level).

    ``start_state()`` returns the initial state; ``allowed(state)``
    returns a bool [V] numpy mask of legal next tokens (the engine
    caches nothing — grammars own their caches); ``advance(state,
    token)`` returns the successor state, or None when the token has
    no transition (a dead end — only reachable through speculative
    draft prefixes, never through committed tokens, because committed
    tokens are sampled under the mask)."""

    def start_state(self):
        raise NotImplementedError

    def allowed(self, state):
        raise NotImplementedError

    def advance(self, state, token):
        raise NotImplementedError


class DfaTokenGrammar(Grammar):
    """Explicit DFA over token ids: ``transitions[state][token] ->
    state``.  The allowed-mask of each state is compiled on first use
    and cached — "compiled per grammar state on the host", shared by
    every request using this grammar instance."""

    def __init__(self, vocab_size, transitions, start=0):
        self.vocab_size = int(vocab_size)
        self.transitions = {
            int(s): {int(t): int(d) for t, d in edges.items()}
            for s, edges in transitions.items()}
        self.start = int(start)
        self._masks = {}
        for s, edges in self.transitions.items():
            for t in edges:
                if not 0 <= t < self.vocab_size:
                    raise ValueError(
                        f"grammar transition on token {t} outside the "
                        f"vocab [0, {self.vocab_size})")

    def start_state(self):
        return self.start

    def allowed(self, state):
        mask = self._masks.get(state)
        if mask is None:
            mask = np.zeros(self.vocab_size, bool)
            for t in self.transitions.get(state, ()):
                mask[t] = True
            self._masks[state] = mask
        return mask

    def advance(self, state, token):
        return self.transitions.get(state, {}).get(int(token))

    def to_spec(self):
        """The JSON-able wire form (:func:`grammar_from_spec`)."""
        return {"kind": "dfa", "vocab_size": self.vocab_size,
                "start": self.start,
                "transitions": {str(s): {str(t): d
                                         for t, d in e.items()}
                                for s, e in self.transitions.items()}}


def json_array_grammar(vocab_size, open_id, close_id, comma_id,
                       item_ids, eos_id, max_items=None):
    """A tiny JSON-array grammar over token ids:
    ``[ item (, item)* ] eos`` — the structured-output shape the
    bench's ``structured_output`` trace replays.  ``eos_id`` gets an
    absorbing final state, so the allowed set is never empty while the
    request lives (the engine's eos handling finishes the request the
    moment eos is emitted).  ``max_items`` bounds the list length by
    chaining item states instead of looping them."""
    item_ids = [int(t) for t in item_ids]
    if not item_ids:
        raise ValueError("json_array_grammar needs at least one item id")
    # states: 0 expect '['; then per slot i: 2i+1 expect item,
    # 2i+2 expect ',' or ']'; final: expect eos; absorbing eos loop
    if max_items is None:
        trans = {
            0: {open_id: 1},
            1: {t: 2 for t in item_ids},
            2: {comma_id: 1, close_id: 3},
            3: {eos_id: 4},
            4: {eos_id: 4},
        }
    else:
        if max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        trans = {0: {open_id: 1}}
        final = 2 * max_items + 1
        for i in range(max_items):
            trans[2 * i + 1] = {t: 2 * i + 2 for t in item_ids}
            nxt = {close_id: final}
            if i + 1 < max_items:
                nxt[comma_id] = 2 * i + 3
            trans[2 * i + 2] = nxt
        trans[final] = {eos_id: final + 1}
        trans[final + 1] = {eos_id: final + 1}
    return DfaTokenGrammar(vocab_size, trans, start=0)


def grammar_from_spec(spec, vocab_size=None):
    """Decode the HTTP wire form of a constraint into a Grammar.

    Two kinds: ``{"kind": "dfa", "vocab_size", "start",
    "transitions"}`` (the generic DFA, :meth:`DfaTokenGrammar.to_spec`
    round-trips it) and ``{"kind": "json_array", "open", "close",
    "comma", "items", "eos", "max_items"?}``.  ``vocab_size`` from the
    serving engine overrides/validates the spec's."""
    if not isinstance(spec, dict) or "kind" not in spec:
        raise ValueError(f"grammar spec must be a dict with a 'kind', "
                         f"got {spec!r}")
    kind = spec["kind"]
    if kind == "dfa":
        v = spec.get("vocab_size", vocab_size)
        if v is None:
            raise ValueError("dfa grammar spec needs vocab_size")
        return DfaTokenGrammar(v, spec["transitions"],
                               start=spec.get("start", 0))
    if kind == "json_array":
        v = spec.get("vocab_size", vocab_size)
        if v is None:
            raise ValueError("json_array grammar spec needs vocab_size")
        return json_array_grammar(
            v, int(spec["open"]), int(spec["close"]),
            int(spec["comma"]), spec["items"], int(spec["eos"]),
            max_items=spec.get("max_items"))
    raise ValueError(f"unknown grammar kind {kind!r} "
                     f"(expected 'dfa' or 'json_array')")


class ConstraintState:
    """One request's live grammar cursor.

    ``bias_row(out)`` writes ``FILTERED`` into the disallowed entries
    of a ``[V]`` f32 bias row for the CURRENT state; ``peek(tokens)``
    walks a draft prefix without moving (speculative packing);
    ``advance(token)`` moves on a committed token.  An empty allowed
    set is a grammar bug (terminal states must carry an eos loop) and
    raises rather than silently un-constraining."""

    def __init__(self, grammar):
        self.grammar = grammar
        self.state = grammar.start_state()

    def _mask(self, state):
        mask = self.grammar.allowed(state)
        if not mask.any():
            raise RuntimeError(
                f"grammar state {state!r} allows no tokens — terminal "
                f"states must loop on eos so generation can end")
        return mask

    def bias_row(self, out, state=None):
        """Add the state's mask into one [V] f32 bias row in place.
        ``state=None`` means the live state; a dead state (None, from
        an illegal draft prefix) writes nothing — those positions are
        unreachable through acceptance."""
        if state is None:
            state = self.state
        out[~self._mask(state)] = FILTERED
        return out

    def peek(self, tokens):
        """States reached by consuming ``tokens`` from the live state,
        one per token consumed (None once the prefix leaves the
        grammar).  Does not move the cursor."""
        states, s = [], self.state
        for t in tokens:
            s = None if s is None else self.grammar.advance(s, t)
            states.append(s)
        return states

    def advance(self, token):
        """Move on a committed (emitted) token.  Committed tokens are
        sampled under the mask, so the transition always exists."""
        nxt = self.grammar.advance(self.state, token)
        if nxt is None:
            raise RuntimeError(
                f"committed token {token} has no transition from "
                f"grammar state {self.state!r} — the mask was not "
                f"applied to the step that emitted it")
        self.state = nxt
