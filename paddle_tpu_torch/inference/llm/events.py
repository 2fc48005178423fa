"""Frozen engine/fleet event-log record schema.

``LLMEngine.events`` and ``Fleet.events`` are append-only lists of
``(step, kind, *detail)`` tuples with NO wall-clock values, so two
replays of the same seeds produce identical logs — the chaos
determinism contract, and the property the discrete-event simulator's
calibration gate diffs against.  This module freezes that contract:

- :data:`SCHEMA_VERSION` and per-kind NAMED detail fields
  (:data:`EVENT_FIELDS`) — adding a field or kind bumps the version;
- :func:`to_records` turns raw tuples into named-field dicts (the
  shape benches/artifacts serialize), REJECTING unknown kinds and
  arity mismatches, so an engine emitting an event the schema doesn't
  know fails a golden test instead of silently forking the format;
- :func:`assert_wall_clock_free` — every field value must be an int,
  str, or None (floats are how wall time sneaks in).

Sim and real engines share the emitting code paths, so both sides of
a calibration run produce records of exactly this shape and a plain
``==`` over the record lists is the decisions-exact gate.
"""
# noqa-module: H001 (event records are host bookkeeping by design —
# the tuples hold python ints/strs the emitting host code already
# owns; nothing here touches a device value)

__all__ = [
    "SCHEMA_VERSION", "ENGINE_EVENT_FIELDS", "FLEET_EVENT_FIELDS",
    "EVENT_FIELDS", "to_records", "assert_wall_clock_free",
]

# v2 added the "fork" kind (n>1 parallel sampling splits a request
# into its COW fork family at final-chunk commit); v3 added the
# multi-LoRA kinds "adapter_register" (host registry) and
# "adapter_load" (device pool slot swap); v4 added the lookahead
# kinds "step_staged" (the engine planned+packed step N+1 under step
# N's device time) and "draft_model_load" (a model-based drafter's
# zero-padded block leaves + paged pools came up at engine init);
# v5 added the hierarchical-KV kinds "demote" / "swap_in" (host-RAM
# page tier), "promote" / "store_adopt" (fleet-wide prefix store) and
# the fleet-level "tier_reroute" (drain handed a running sequence to
# a peer THROUGH the host tier)
SCHEMA_VERSION = 5

# detail-field names per engine event kind, in tuple order after
# (step, kind).  Frozen: changing arity or adding kinds bumps
# SCHEMA_VERSION (tests/test_events_schema.py is the golden guard).
ENGINE_EVENT_FIELDS = {
    "add": ("request_id",),
    "shed": ("request_id",),
    "abort": ("request_id",),
    "deadline": ("request_id",),
    "preempt": ("count",),
    "retry": ("launch_kind", "attempt"),
    "quarantine": ("request_id",),
    "finish": ("request_id", "reason"),
    "export": ("request_id", "pages"),
    "import": ("request_id", "pages"),
    "release": ("request_id",),
    "fork": ("request_id", "child_id"),
    # multi-LoRA: registration is host-only; a load names the device
    # pool slot the adapter was swapped into (LRU evictions show up as
    # a later load re-claiming the slot — no separate evict event, the
    # slot column tells the story wall-clock-free)
    "adapter_register": ("adapter_id",),
    "adapter_load": ("adapter_id", "slot"),
    # async lookahead: step N staged (planned + packed) this many
    # decode rows for step N+1 under step N's device window.  The
    # count is the STAGED row count, not the claimed one — a discard
    # (plan invalidated) shows up as a staged event with no
    # corresponding skipped schedule, which is exactly how a replay
    # diff localizes a lost pipeline window.  Wall-clock-free.
    "step_staged": ("rows",),
    # model-based speculative decoding: the draft model's block
    # leaves (live layers + zero-padded identities) and paged pools
    # came up.  Emitted once at construction (step -1).
    "draft_model_load": ("layers", "pages"),
    # hierarchical KV (inference/llm/kv_tier.py): a preempted/drained
    # sequence's page chain moved HBM -> host pool ("demote"), came
    # back at re-admission ("swap_in"), a prefix-cache-evicted full
    # page moved into the content-addressed host store ("promote"),
    # or admission adopted store pages beyond the HBM prefix hit
    # ("store_adopt").  Page counts only — deterministic ints, and the
    # simulator replays the same decisions to the same counts.
    "demote": ("request_id", "pages"),
    "swap_in": ("request_id", "pages"),
    "promote": ("pages",),
    "store_adopt": ("request_id", "pages"),
}

# fleet event kinds ("shed"/"finish" are shared with the engine and
# carry identical fields at both levels)
FLEET_EVENT_FIELDS = {
    "shed": ("request_id",),
    "finish": ("request_id", "reason"),
    "route": ("request_id", "replica", "score"),
    "degraded": ("replica", "cause"),
    "recovered": ("replica",),
    "dead": ("replica", "cause"),
    "failover": ("request_id", "src", "dst"),
    "lost": ("request_id",),
    "migrate": ("request_id", "src", "dst", "pages"),
    "migrate_skip": ("request_id", "reason"),
    "migrate_fail": ("request_id", "src", "dst", "reason"),
    "draining": ("replica",),
    "drained": ("replica",),
    "reroute": ("request_id", "src", "dst"),
    "restart": ("replica",),
    # hierarchical KV: a drain handed a RUNNING sequence to a peer
    # THROUGH the shared host tier (demote on src, swap-in on dst at
    # its own admission) — the fallback when direct migration can't
    # land (e.g. the destination has no free pages right now)
    "tier_reroute": ("request_id", "src", "dst", "pages"),
}

EVENT_FIELDS = {**ENGINE_EVENT_FIELDS, **FLEET_EVENT_FIELDS}


def to_records(events):
    """Named-field records for a raw event list.

    Each ``(step, kind, *detail)`` tuple becomes
    ``{"schema_version", "step", "kind", <named fields>}``.  Unknown
    kinds and detail-arity mismatches raise — the schema is frozen,
    and an emitter drifting from it must fail loudly."""
    records = []
    for ev in events:
        step, kind, detail = ev[0], ev[1], ev[2:]
        fields = EVENT_FIELDS.get(kind)
        if fields is None:
            raise ValueError(
                f"event kind {kind!r} is not in the frozen schema "
                f"(v{SCHEMA_VERSION}) — add it to EVENT_FIELDS and "
                f"bump SCHEMA_VERSION")
        if len(detail) != len(fields):
            raise ValueError(
                f"event {ev!r} carries {len(detail)} detail values; "
                f"schema v{SCHEMA_VERSION} declares {len(fields)} "
                f"({', '.join(fields)}) for kind {kind!r}")
        rec = {"schema_version": SCHEMA_VERSION, "step": int(step),
               "kind": kind}
        rec.update(zip(fields, detail))
        records.append(rec)
    return records


def assert_wall_clock_free(records):
    """Raise AssertionError if any record field could carry wall time:
    every value must be an int, str, or None.  (Floats are the
    tell — every wall-clock gauge in the engine is a float, and the
    deterministic-replay contract keeps them OUT of the event log.)"""
    for rec in records:
        for key, val in rec.items():
            if isinstance(val, bool) or not \
                    isinstance(val, (int, str, type(None))):
                raise AssertionError(
                    f"event record field {key}={val!r} "
                    f"({type(val).__name__}) is not int/str/None — "
                    f"wall-clock (or otherwise non-replayable) data "
                    f"leaked into the event log: {rec}")
