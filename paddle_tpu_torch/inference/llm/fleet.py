# noqa-module: H001 (fleet orchestration is host-side by design — the
# router, health checker and failover logic run between engine steps;
# nothing here runs under jit)
"""Fleet — health-checked replica router with token-exact failover.

One LLMEngine serves one chip group; a *fleet* is N of them behind a
router, and it is only worth running if it survives a replica dying
mid-decode.  Everything here builds on two invariants the single-engine
stack already proved:

- **Exactness**: a request's output is fully determined by (prompt,
  seed, sampling params) — greedy and per-request-seeded streams are
  batch-order independent — so replaying a dead replica's requests from
  scratch on a survivor reproduces the SAME tokens.  Failover is a
  bitwise guarantee, not best-effort.
- **Determinism**: engine event logs are wall-clock-free and fault
  schedules are materialized data (faults.py), so a seeded fleet-chaos
  run (kill replica k at step s, miss heartbeats, partial drains)
  replays to an identical fleet event log.

Design:

- **Each replica captures its own step graphs.**  Every replica is its
  own LLMEngine — own scheduler, own BlockManager, own K/V pools, and
  its own ``StepGraphs``: a captured CUDA graph reads the pools it was
  captured over by address, so a graph set shared between replicas
  would replay into the first replica's pools.  A replica is warmed as
  it is built, on the building thread (on CUDA it captures its token
  buckets there), so no bucket is ever captured in a stepping thread
  while another thread launches (a capture in the global error mode is
  invalidated by a launch from any thread, and ``parallel_step=True``
  steps replicas in threads).  ``warmup()`` returns one CaptureWatcher
  over every replica's graphs with those timings as its ``compile_ms``,
  and the fleet's gate is zero captures after construction on every
  replica (``engine._graphs.captures``, and the draft graphs' where
  there is a draft model).  All
  replicas of one process share one CUDA context and, by default, one
  stream: their replays do not overlap on the card, and a sticky
  device error poisons every replica, not only the one that raised.
  A model already on the card in the engine's dtype is not copied, so
  its replicas share the weight tensors.
- **Prefix-cache affinity routing** (Router): a prompt's affinity keys
  are its page-aligned prefix-chain hashes from
  ``BlockManager.prefix_chain_hashes`` — the SAME hashes the cache
  registers pages under, capped at ``(n-1)//block_size`` exactly like
  scheduler admission.  Routing scores each candidate by the longest
  leading run of keys it has warm (a shadow set of dispatched hashes,
  floored by the live ``match_prefix`` residency), routes to the
  highest score, and falls back least-loaded (queue depth + running
  set) with lowest-index tie-breaks — fully deterministic.
- **Health checking** (three states + hysteresis): every fleet step
  each live replica emits a heartbeat derived from data the engine
  already exposes — ``lifecycle_stats()`` gauges, StepWatchdog wedge
  counts, injected "heartbeat" faults — and a replica transitions
  healthy -> degraded after ``degraded_after`` consecutive misses,
  degraded -> dead after ``dead_after``, degraded -> healthy after
  ``recover_after`` consecutive beats.  One slow step never flaps a
  replica out of rotation.  A replica whose step() RAISES
  (PoolLostError, an unabsorbed injected fault) is dead immediately.
- **Token-exact failover**: a dead replica's in-flight and queued
  requests are requeued (original prompt + kwargs, same request id)
  onto survivors and replayed from scratch; the dead engine is never
  touched again (process-death semantics).  Outputs are forwarded only
  while the emitting replica still owns the request, so stale outputs
  from a rerouted request are swallowed, and the fleet-level request
  id IS the replica-level id (no mapping to corrupt).
- **Bounded admission + rolling drain**: ``max_queue`` sheds at the
  fleet level when capacity drops (FinishReason.shed, immediately);
  ``drain_replica(i)`` reroutes the victim's waiting requests,
  migrates its running ones to peers (policy-gated; finish-in-place
  fallback), and parks it ``drained`` for a zero-downtime
  ``restart_replica(i)`` (a dead replica restarts with a fresh engine
  that captures its own graphs; the dead engine's pools and graph pool
  are released first).
- **KV page migration** (``_migrate``): a RUNNING sequence's page
  chain moves between replicas mid-generation — host-staged
  gathers and scatters of the source pages into fresh private
  pages on the destination (engine.export_request/import_request), the
  live Request object transplanted so ``output_ids`` / ``num_cached``
  / the per-request sampling stream ride along and decode resumes
  token-exactly with zero new captures.  ``MigrationPolicy`` picks
  migrate-vs-recompute from framework/cost.py's bytes-moved vs
  tokens-recomputed estimate; any migration fault falls back to the
  pre-migration behavior (from-scratch replay on failover, finish in
  place on drain) with exact page reclamation on BOTH pools.  Drain
  and *engine-alive* failover (health-signal death: the engine object
  still holds its pages) migrate; process death still replays from
  scratch — pages die with the process.
- **Disaggregated prefill/decode** (``disaggregate=True``): low
  replica indices specialize as prefill-role, the rest decode-role.
  New requests route to prefill replicas; the moment a sequence
  crosses the prefill→decode boundary (final chunk committed) it hands
  off to a decode replica via the SAME migration path.  With no
  routable replica of the wanted role the fleet degrades to unified
  serving rather than stalling — specialization is a placement
  preference, never a correctness constraint.

``parallel_step=True`` steps live replicas in one thread each (real
overlap of their host work on multi-core hosts; the GIL serializes
the Python side and the card runs the replays one after another).
Results are COLLECTED in replica-index order either way, so the fleet
event log is identical in both modes.
"""

import threading
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from .engine import LLMEngine, RequestOutput
from .interleave import interleave_point
from .faults import FinishReason, MigrationError
from .kv_tier import KVTierConfig
from .scheduler import RUNNING

# replica lifecycle states (three-state health machine + drain states)
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DRAINED = "drained"
DEAD = "dead"


@dataclass
class HealthConfig:
    """Hysteresis thresholds for the replica health state machine.

    ``degraded_after`` consecutive missed heartbeats demote healthy ->
    degraded (no new routing; in-flight work continues);
    ``dead_after`` consecutive misses kill a degraded replica
    (failover); ``recover_after`` consecutive good beats promote
    degraded -> healthy.  ``slow_step_ms`` (optional) additionally
    counts a step slower than the threshold as a miss — a WALL-CLOCK
    signal, so leave it None (default) when replaying seeded chaos
    schedules that must produce identical event logs."""

    degraded_after: int = 2
    dead_after: int = 4
    recover_after: int = 2
    slow_step_ms: float = None

    def __post_init__(self):
        if not (1 <= self.degraded_after < self.dead_after):
            raise ValueError(
                f"need 1 <= degraded_after < dead_after, got "
                f"{self.degraded_after} / {self.dead_after}")
        if self.recover_after < 1:
            raise ValueError(
                f"recover_after must be >= 1, got {self.recover_after}")
        if self.slow_step_ms is not None and self.slow_step_ms <= 0:
            raise ValueError(
                f"slow_step_ms must be > 0, got {self.slow_step_ms}")

    @classmethod
    def resolve(cls, health):
        """Fleet-kwarg sugar: None | dict | HealthConfig."""
        if health is None:
            return cls()
        if isinstance(health, cls):
            return health
        if isinstance(health, dict):
            return cls(**health)
        raise TypeError(
            f"health= takes None/dict/HealthConfig, "
            f"got {type(health).__name__}")


@dataclass
class MigrationPolicy:
    """Migrate-vs-recompute for one running sequence's KV handoff.

    ``mode``
        "auto" (default) compares framework/cost.py's
        ``migration_estimate`` — the sequence's page bytes over the
        replica-to-replica link vs a fresh prefill of its
        ``num_cached`` tokens through the weights — and picks the
        cheaper side; "always" / "never" force the choice.
    ``profile``
        DEVICE_PROFILES key converting byte/FLOP counts to seconds
        (default "cpu" — what the serving stack runs on today).
    ``link_gbps``
        Replica-to-replica bandwidth in GB/s for the transfer term;
        None uses the profile's ICI rate.

    Failure handling is NOT a knob: a migration that faults always
    falls back to the pre-migration behavior (from-scratch replay on
    failover, finish-in-place on drain, retry-next-step on the
    disaggregated handoff) — both pools exactly as before the attempt.
    """

    mode: str = "auto"
    profile: str = "cpu"
    link_gbps: float = None

    def __post_init__(self):
        if self.mode not in ("auto", "always", "never"):
            raise ValueError(
                f"mode must be 'auto'|'always'|'never', got "
                f"{self.mode!r}")
        from ...framework.cost import DEVICE_PROFILES
        if self.profile not in DEVICE_PROFILES:
            raise ValueError(
                f"unknown device profile {self.profile!r} "
                f"(one of {sorted(DEVICE_PROFILES)})")
        if self.link_gbps is not None and not float(self.link_gbps) > 0:
            raise ValueError(
                f"link_gbps must be > 0, got {self.link_gbps!r}")

    @classmethod
    def resolve(cls, migration):
        """Fleet-kwarg sugar: None | mode str | dict |
        MigrationPolicy."""
        if migration is None:
            return cls()
        if isinstance(migration, cls):
            return migration
        if isinstance(migration, str):
            return cls(mode=migration)
        if isinstance(migration, dict):
            return cls(**migration)
        raise TypeError(
            f"migration= takes None/str/dict/MigrationPolicy, "
            f"got {type(migration).__name__}")

    def estimate(self, engine, request):
        """The cost model's view of migrating ``request`` off
        ``engine`` right now (bytes moved, recompute FLOPs, seconds
        under the profile, and which side it prefers)."""
        from ...framework.cost import migration_estimate
        pages = len(engine.block_manager.block_table(request.request_id))
        return migration_estimate(
            engine, num_tokens=request.num_cached, num_pages=pages,
            profile=self.profile,
            link_bytes_per_s=(None if self.link_gbps is None
                              else float(self.link_gbps) * 1e9))

    def decide(self, engine, request):
        """"migrate" or "recompute" for one RUNNING request."""
        if self.mode != "auto":
            return "migrate" if self.mode == "always" else "recompute"
        return self.estimate(engine, request)["prefer"]


class Replica:
    """One engine plus its fleet-side health and affinity state."""

    def __init__(self, index, engine):
        self.index = index
        self.engine = engine
        self.state = HEALTHY
        self.role = None         # "prefill"/"decode" when disaggregated
        self.miss_streak = 0
        self.ok_streak = 0
        # shadow LRU of prefix-chain hashes dispatched to this replica:
        # routing must see pages that are still PREFILLING (the live
        # cache only knows completed pages), at the cost of counting
        # pages the cache may since have evicted — affinity is a
        # placement heuristic, correctness never depends on it.  An
        # OrderedDict (value-less) so Router.touch can bound it LRU-
        # style instead of growing without limit across long replays.
        self.warm_hashes = OrderedDict()
        self._last_wedged = 0

    @property
    def routable(self):
        return self.state in (HEALTHY, DEGRADED)

    @property
    def live(self):
        """Still stepped by the fleet (draining replicas finish their
        in-place work; drained/dead ones are never stepped)."""
        return self.state in (HEALTHY, DEGRADED, DRAINING)

    def load(self):
        """Logical load for least-loaded routing: admitted-but-waiting
        plus running.  Pure scheduler state — deterministic."""
        sch = self.engine.scheduler
        return sch.queue_depth() + len(sch.running)


class Router:
    """Prefix-affinity placement with deterministic least-loaded
    fallback (see the module docstring for the policy)."""

    def __init__(self, replicas, warm_cap=4096, load_cap=None,
                 prefix_store=None):
        if not isinstance(warm_cap, (int, np.integer)) or \
                isinstance(warm_cap, bool) or warm_cap < 1:
            raise ValueError(
                f"warm_cap must be a positive int, got {warm_cap!r}")
        if load_cap is not None and (
                not isinstance(load_cap, (int, np.integer))
                or isinstance(load_cap, bool) or load_cap < 0):
            raise ValueError(
                f"load_cap must be None or a non-negative int, "
                f"got {load_cap!r}")
        self.replicas = replicas
        self.warm_cap = int(warm_cap)
        # load-capped warm affinity (None = pure affinity-first, the
        # historical policy, byte-identical routing): with a cap, a
        # replica more than ``load_cap`` requests above the pool's
        # least-loaded one scores 0 — hot-tenant traffic spills to
        # idle replicas instead of herding onto one warm replica
        # (policy finding from the discrete-event simulator; see
        # docs/SIMULATOR.md)
        self.load_cap = None if load_cap is None else int(load_cap)
        # fleet-wide prefix store (hierarchical KV): store-resident
        # pages are adoptable from ANY replica, so they score the same
        # everywhere — ties fall through to least-loaded, which stops
        # a store-warm prefix from herding onto one replica
        self.prefix_store = prefix_store
        self.routed = 0
        self.affinity_hits = 0

    def affinity_keys(self, prompt_ids):
        """The prompt's page-aligned prefix-chain hashes — EXACTLY the
        hashes scheduler admission matches and the cache registers
        pages under (one hashing authority: BlockManager), capped at
        ``(n - 1) // block_size`` like admission (the last token is
        always recomputed for its logits)."""
        bm = self.replicas[0].engine.block_manager
        n = len(prompt_ids)
        return bm.prefix_chain_hashes(prompt_ids,
                                      limit=(n - 1) // bm.block_size)

    def score(self, replica, keys):
        """Warm-page affinity: longest leading run of ``keys`` this
        replica has seen dispatched, floored by the pages actually
        resident in its cache right now, and by the pages any replica
        can adopt from the fleet-wide prefix store."""
        run = 0
        for h in keys:
            if h not in replica.warm_hashes:
                break
            run += 1
        score = max(run,
                    replica.engine.block_manager.match_prefix(keys))
        if self.prefix_store is not None:
            score = max(score, self.prefix_store.match(keys))
        return score

    def pick(self, keys, pool):
        """Highest affinity score wins; ties (including the score-0
        cold case) fall back to least-loaded, then lowest index.
        Returns (replica, score); pool must be non-empty."""
        best = best_key = None
        floor = (min(r.load() for r in pool)
                 if self.load_cap is not None else 0)
        for r in pool:
            load = r.load()
            score = self.score(r, keys)
            if self.load_cap is not None and \
                    load - floor > self.load_cap:
                score = 0        # overloaded: no warm-affinity credit
            k = (-score, load, r.index)
            if best is None or k < best_key:
                best, best_key = r, k
        return best, -best_key[0]

    def touch(self, replica, keys):
        """Mark ``keys`` warm on ``replica`` (most-recent position).
        The warm map is an LRU bounded at ``warm_cap`` hashes — the
        same content hashes the prefix cache keys pages on — so a
        long replay holds a few pools' worth of history, not every
        prompt it ever routed."""
        warm = replica.warm_hashes
        for h in keys:
            if h in warm:
                warm.move_to_end(h)
            else:
                warm[h] = None
        while len(warm) > self.warm_cap:
            warm.popitem(last=False)

    def record(self, replica, keys, hit):
        self.routed += 1
        if hit:
            self.affinity_hits += 1
        self.touch(replica, keys)

    def forget(self, replica):
        """Drop the replica's affinity state (death / drain / restart
        — its warm pages are gone or about to be)."""
        replica.warm_hashes.clear()

    def stats(self):
        return {"routed": self.routed,
                "affinity_hits": self.affinity_hits,
                "affinity_hit_rate": (self.affinity_hits / self.routed
                                      if self.routed else 0.0)}


@dataclass
class _FleetRequest:
    """Fleet-side record of one live request: everything needed to
    replay it from scratch on a survivor, plus current ownership."""

    prompt_ids: tuple
    kwargs: dict
    replica: int
    requeues: int = 0
    # set by Fleet.abort_request BEFORE the engine emits the aborted
    # output: a failover/drain/migration racing the abort sees the
    # claim and neither resurrects the request on a peer nor
    # double-finishes it
    aborting: bool = False


class Fleet:
    """N LLMEngine replicas behind a health-checked affinity router.

    >>> fleet = Fleet(model, replicas=3, block_size=16, max_batch=8)
    >>> watcher = fleet.warmup()          # one compile set, N replicas
    >>> rid = fleet.add_request([5, 6, 7], max_new_tokens=16)
    >>> while fleet.has_unfinished():
    ...     for out in fleet.step():
    ...         print(out.request_id, out.output_ids)

    The engine surface is mirrored (``add_request`` / ``step`` /
    ``generate`` / ``abort_request`` / ``drain`` / ``has_unfinished`` /
    ``lifecycle_stats`` / ``prefix_cache_stats`` / ``spec_stats``), so
    AsyncLLMEngine, PredictorServer (``fleet=``) and the serving bench
    drive a fleet exactly like a single engine.

    ``faults=`` takes a FaultInjector whose "replica"-site schedule the
    fleet consumes at each step boundary (kill / heartbeat / drain),
    and whose "migration"-site schedule fires against migration
    attempts (fail mid-export / mid-import / delay);
    ``engine_faults=`` optionally gives each replica its own injector
    for engine-level chaos.  ``max_queue`` bounds TOTAL waiting depth
    across routable replicas — past it (or with no routable replica
    left) requests shed at the fleet gate.  ``migration=`` takes a
    MigrationPolicy (or mode str / dict) gating KV page handoff on
    drain and engine-alive failover; ``disaggregate=True`` splits the
    fleet into prefill-role and decode-role replicas with migration-
    based handoff at the prefill→decode boundary.
    ``router_load_cap=N`` caps warm-affinity routing: a replica more
    than N requests above the pool's least-loaded loses its affinity
    credit, so hot-tenant skew spills instead of herding (None keeps
    the historical pure-affinity policy, routing-identical).
    ``engine_factory=`` substitutes the per-replica engine constructor
    (the discrete-event simulator's SimEngine seam).  All remaining
    keyword arguments are forwarded to every replica's engine.
    """

    def __init__(self, model, replicas=2, *, health=None, faults=None,
                 max_queue=None, parallel_step=False, engine_faults=None,
                 migration=None, disaggregate=False,
                 router_load_cap=None, engine_factory=None,
                 **engine_kwargs):
        if not isinstance(replicas, (int, np.integer)) or \
                isinstance(replicas, bool) or replicas < 1:
            raise ValueError(
                f"replicas must be a positive int, got {replicas!r}")
        if disaggregate and int(replicas) < 2:
            raise ValueError(
                "disaggregate=True needs at least 2 replicas (one "
                "prefill-role, one decode-role)")
        if max_queue is not None:
            if not isinstance(max_queue, (int, np.integer)) \
                    or isinstance(max_queue, bool) or max_queue < 1:
                raise ValueError(
                    f"max_queue must be a positive int (total waiting "
                    f"depth before load-shedding), got {max_queue!r}")
            max_queue = int(max_queue)
        if engine_faults is None:
            engine_faults = [None] * int(replicas)
        elif len(engine_faults) != int(replicas):
            raise ValueError(
                f"engine_faults needs one entry per replica "
                f"({replicas}), got {len(engine_faults)}")
        self.health = HealthConfig.resolve(health)
        self.migration = MigrationPolicy.resolve(migration)
        self.disaggregate = bool(disaggregate)
        self.faults = faults
        self.max_queue = max_queue
        self.parallel_step = bool(parallel_step)
        self._model = model
        self._engine_kwargs = dict(engine_kwargs)
        self._engine_faults = list(engine_faults)
        # hierarchical KV (inference/llm/kv_tier.py): the host page
        # pool and the content-addressed prefix store are FLEET-wide —
        # resolve the config once, build the tier instances once, and
        # hand every replica engine the same objects, so a chain
        # demoted by one replica can swap in on another and a page
        # promoted anywhere warms admission everywhere
        self.kv_tier = KVTierConfig.resolve(
            self._engine_kwargs.pop("kv_tier", None))
        self.host_pool = self.prefix_store = None
        if self.kv_tier is not None:
            self.host_pool, self.prefix_store = self.kv_tier.build()
            self._engine_kwargs["kv_tier"] = KVTierConfig(
                host_bytes=self.kv_tier.host_bytes,
                store_bytes=self.kv_tier.store_bytes,
                policy=self.kv_tier.policy,
                host_pool=self.host_pool, store=self.prefix_store)
        # the fleet's own waits and timers ride the engines' injected
        # clock when one is given (simulator runs on a VirtualClock);
        # wall serving keeps monotonic/perf_counter/sleep
        clk = engine_kwargs.get("clock")
        self._clock = clk if clk is not None else time.monotonic
        self._timer = clk if clk is not None else time.perf_counter
        self._sleep = getattr(clk, "sleep", time.sleep)
        # engine construction seam: the simulator substitutes its
        # SimEngine subclass without the fleet knowing the difference
        self._engine_factory = (engine_factory if engine_factory
                                is not None else LLMEngine)
        self._warmup_ms = {}
        self.replicas = [Replica(i, self._build_engine(i))
                         for i in range(int(replicas))]
        if self.disaggregate:
            # low indices take prefill (they see every new prompt and
            # keep the warm prefix caches); the rest decode
            n_prefill = max(1, int(replicas) // 2)
            for r in self.replicas:
                r.role = "prefill" if r.index < n_prefill else "decode"
        self.router = Router(self.replicas, load_cap=router_load_cap,
                             prefix_store=self.prefix_store)
        self._live = {}          # fleet rid -> _FleetRequest
        self._adapters = {}      # adapter_id -> weights (LoRA re-reg)
        self._early = []         # outputs finished without a step
        self._next_id = 0
        self._step_index = -1
        self._draining = False
        self._hb_missed = set()  # replica indices missing THIS beat
        # deterministic fleet event log — same contract as the engine's:
        # (step, kind, *detail) tuples, no wall times, so seed replays
        # of a chaos schedule compare equal
        self.events = []
        self.stats = {"requeued": 0, "killed": 0, "drains": 0,
                      "restarts": 0, "shed": 0, "lost": 0,
                      "migrated": 0, "migration_recomputed": 0,
                      "migration_failed": 0, "migrated_bytes": 0,
                      "tier_rerouted": 0}
        # wall-clock handoff latencies (ms) — benches read this; it
        # never enters the event log, so seed replays stay identical
        self.migration_ms = []
        # fleet-side per-step cumulative gauges, recorded when the
        # replica engines record theirs (record_step_gauges=True)
        self.record_step_gauges = bool(
            engine_kwargs.get("record_step_gauges"))
        self.step_gauges = []

    # ----------------------------------------------------------- replicas --
    def _build_engine(self, index):
        """Construct one replica engine and warm it on the building
        thread.  Each engine owns its pools and captures its own step
        graphs over them here, so every bucket is captured before any
        thread steps it; the timings are kept for :meth:`warmup`.  A
        fleet of tensor-parallel replicas is not ported yet (ROADMAP
        A20b)."""
        kw = self._engine_kwargs
        if (kw.get("tensor_parallel") or 1) > 1 or (
                kw.get("mesh") is not None and len(kw["mesh"]) > 1):
            raise NotImplementedError(
                "Fleet(tensor_parallel=...) is not ported yet: a fleet of "
                "tensor-parallel replicas comes with A20b (ROADMAP)")
        eng = self._engine_factory(
            self._model, faults=self._engine_faults[index],
            **self._engine_kwargs)
        self._warmup_ms[index] = eng.warmup().compile_ms
        return eng

    def warmup(self):
        """ONE armed :class:`~paddle_tpu_torch.framework.analysis.
        CaptureWatcher` over every replica's step graphs (target and
        draft), whose ``compile_ms`` is ``{replica index: that engine's
        warmup() timings}``.  Every replica was warmed as it was built
        (on CUDA each captured its own token buckets then), so serving
        captures nothing: ``assert_no_new_captures()`` certifies the
        whole fleet."""
        from ...framework.analysis import CaptureWatcher

        graphs, labels = [], []
        for r in self.replicas:
            for kind, g in (("ragged", r.engine._graphs),
                            ("draft", r.engine._draft_graphs)):
                if g is not None:
                    graphs.append(g)
                    labels.append(f"replica{r.index}.{kind}")
        watcher = CaptureWatcher(*graphs, labels=labels)
        watcher.compile_ms = {r.index: self._warmup_ms[r.index]
                              for r in self.replicas}
        return watcher

    def replica_states(self):
        return {r.index: r.state for r in self.replicas}

    def roles(self):
        """{replica index: role} — "prefill"/"decode" under
        ``disaggregate=True``, None for every replica otherwise."""
        return {r.index: r.role for r in self.replicas}

    def _routable(self, exclude=None, role=None):
        """Routing pool: healthy replicas; if none, degraded ones (a
        degraded fleet sheds only when it must).  Never includes
        ``exclude`` or draining/drained/dead replicas.  ``role``
        prefers replicas of that role (disaggregated mode) but falls
        back to ANY routable replica when the role has none left —
        specialization degrades to unified serving, never to an
        outage."""
        wants = ((role, None) if role is not None else (None,))
        for want in wants:
            for state in (HEALTHY, DEGRADED):
                pool = [r for r in self.replicas
                        if r.state == state and r is not exclude
                        and (want is None or r.role == want)]
                if pool:
                    return pool
        return []

    # ----------------------------------------------------------- requests --
    def add_request(self, prompt_ids, max_new_tokens=16,
                    eos_token_id=None, temperature=0.0, request_id=None,
                    seed=None, deadline_ms=None, top_k=0, top_p=1.0,
                    min_p=0.0, repetition_penalty=1.0,
                    presence_penalty=0.0, frequency_penalty=0.0,
                    logit_bias=None, logprobs=0, stop=None,
                    grammar=None, n=1, adapter_id=None):
        """Route one request to a replica (affinity first, least-loaded
        fallback).  Sheds at the fleet gate — FinishReason.shed, output
        delivered by the next step() — while draining, when no replica
        is routable, or past ``max_queue`` total waiting depth.

        The full sampling suite rides through to the owning engine and
        SURVIVES failover: the kwargs are kept verbatim (grammar as the
        stateless Grammar object), so resubmission on a peer rebuilds a
        fresh request — constraint state replays from the start along
        with the tokens.  ``n > 1`` is engine-level (a fork family
        can't failover atomically) and is rejected here."""
        if n != 1:
            raise ValueError(
                "n>1 parallel sampling is engine-level (COW forks "
                "can't migrate as a family); submit to an engine, or "
                "n separate seeded fleet requests")
        prompt = tuple(int(t) for t in np.asarray(prompt_ids).reshape(-1))
        if request_id is None:
            request_id = self._next_id
            self._next_id += 1
        # disaggregated fleets prefill where the prompt work belongs;
        # the handoff to a decode replica happens at the boundary
        pool = self._routable(
            role="prefill" if self.disaggregate else None)
        depth = sum(r.engine.scheduler.queue_depth() for r in pool)
        if self._draining or not pool or \
                (self.max_queue is not None and depth >= self.max_queue):
            self.stats["shed"] += 1
            self.events.append((self._step_index, "shed", request_id))
            self._early.append(RequestOutput(
                request_id, prompt, [], FinishReason.SHED, 0))
            return request_id
        kwargs = dict(max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, temperature=temperature,
                      seed=seed, deadline_ms=deadline_ms,
                      top_k=top_k, top_p=top_p, min_p=min_p,
                      repetition_penalty=repetition_penalty,
                      presence_penalty=presence_penalty,
                      frequency_penalty=frequency_penalty,
                      logit_bias=logit_bias, logprobs=logprobs,
                      stop=stop, grammar=grammar,
                      adapter_id=adapter_id)
        keys = self.router.affinity_keys(prompt)
        target, score = self.router.pick(keys, pool)
        # the replica-level id IS the fleet-level id: a validation error
        # propagates from the engine with nothing half-recorded here
        target.engine.add_request(prompt, request_id=request_id, **kwargs)
        self.router.record(target, keys, score > 0)
        self._live[request_id] = _FleetRequest(prompt, kwargs,
                                               target.index)
        self.events.append((self._step_index, "route", request_id,
                            target.index, score))
        return request_id

    def add_adapter(self, adapter_id, weights):
        """Register one tenant adapter on EVERY replica (LoRA fleets
        only — the engines raise without ``lora=``).  The fleet keeps
        the host weight copies so a replica rebuilt after a kill is
        re-registered before it rejoins the pool: failover resubmission
        of an ``adapter_id`` request always lands on an engine that
        knows the tenant."""
        if adapter_id in self._adapters:
            raise ValueError(
                f"adapter {adapter_id!r} is already registered")
        for r in self.replicas:
            r.engine.add_adapter(adapter_id, weights)
        self._adapters[adapter_id] = weights

    def abort_request(self, request_id):
        """Cancel a live request wherever it currently runs; the
        aborted output is forwarded by a following step().  Ownership
        is claimed HERE, before the owning engine can emit: once
        ``aborting`` is set, a racing ``_failover``/``drain_replica``
        neither requeues the request on a peer (which would resurrect
        cancelled work) nor lets it finish twice — if the owner dies
        before delivering, the fleet emits the one terminal ABORTED
        output itself."""
        fr = self._live.get(request_id)
        if fr is None or fr.aborting:
            return False
        ok = self.replicas[fr.replica].engine.abort_request(request_id)
        if ok:
            fr.aborting = True
        return ok

    def has_unfinished(self):
        return bool(self._early) or bool(self._live)

    # --------------------------------------------------------------- step --
    def step(self):
        """One fleet iteration: consume due replica-site faults, step
        every live replica (threads under ``parallel_step``), forward
        outputs still owned by their emitting replica, update health
        beats, hand prefilled sequences to decode replicas (in
        disaggregated mode), and promote emptied draining replicas to
        drained.
        Returns the finished RequestOutputs (fleet-shed and failover
        casualties included)."""
        interleave_point("fleet-step")
        self._step_index += 1
        if self.faults is not None:
            self.faults.begin_step(self._step_index)
            for f in self.faults.replica_faults():
                self._apply_fault(f)
        finished = self._early
        self._early = []
        live = [r for r in self.replicas if r.live]
        results = self._step_replicas(live)
        for r in live:
            status, payload = results[r.index]
            if status == "err":
                # a step that RAISES is instant death — PoolLostError
                # and unabsorbed faults mean this engine cannot serve
                self._mark_dead(r, tag=type(payload).__name__,
                                detail=str(payload))
                continue
            for fo in payload:
                fr = self._live.get(fo.request_id)
                if fr is None or fr.replica != r.index:
                    continue     # stale output of a rerouted request
                del self._live[fo.request_id]
                self.events.append((self._step_index, "finish",
                                    fo.request_id, fo.finish_reason))
                finished.append(fo)
            if r.state in (HEALTHY, DEGRADED):
                self._beat(r)
        if self.disaggregate:
            self._handoff_prefilled()
        for r in self.replicas:
            if r.state == DRAINING and not r.engine.has_unfinished():
                r.state = DRAINED
                self.events.append(
                    (self._step_index, "drained", r.index))
        self._hb_missed.clear()
        finished.extend(self._early)
        self._early = []
        self._record_step_gauges()
        return finished

    def _record_step_gauges(self):
        """Fleet counterpart of the engine's per-step cumulative
        gauges: one wall-clock-free snapshot of the fleet counters
        (migration/requeue/shed trajectories) per fleet step."""
        if not self.record_step_gauges:
            return
        s = self.stats
        self.step_gauges.append({
            "step": self._step_index,
            "migrated": s["migrated"], "requeued": s["requeued"],
            "shed": s["shed"], "killed": s["killed"],
            "lost": s["lost"],
            "preemptions": sum(r.engine.scheduler.num_preemptions
                               for r in self.replicas),
            "replicas_live": sum(1 for r in self.replicas if r.live),
        })

    def _step_replicas(self, live):
        """Step each live replica, catching per-replica failures.
        Threaded mode overlaps replica steps (each engine's state is
        touched only by its own thread); results are keyed by replica
        index and consumed in index order, so both modes produce the
        same event log."""
        results = {}

        def one(r):
            try:
                results[r.index] = ("ok", r.engine.step())
            except Exception as e:  # noqa: BLE001 — replica isolation
                results[r.index] = ("err", e)

        if self.parallel_step and len(live) > 1:
            threads = [threading.Thread(target=one, args=(r,))
                       for r in live]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for r in live:
                one(r)
        return results

    # ------------------------------------------------------------- health --
    def _beat(self, r):
        """One heartbeat for a routable replica: injected misses and
        watchdog wedges are data signals (replay-safe); the optional
        ``slow_step_ms`` wall-clock gauge is opt-in.  Streak counters
        give the hysteresis — one slow step never flaps."""
        miss = None
        if r.index in self._hb_missed:
            miss = "heartbeat"
        else:
            wd = r.engine.watchdog
            if wd is not None and wd.num_wedged > r._last_wedged:
                miss = "wedged"
            elif self.health.slow_step_ms is not None:
                # the gauge is written by the replica's stepping thread
                # (parallel_step) — read it under the engine's gauge lock
                with r.engine._gauge_lock:
                    last_ms = r.engine._last_step_ms
                if (last_ms or 0.0) > self.health.slow_step_ms:
                    miss = "slow"
        if r.engine.watchdog is not None:
            r._last_wedged = r.engine.watchdog.num_wedged
        if miss is not None:
            r.miss_streak += 1
            r.ok_streak = 0
            if r.state == HEALTHY and \
                    r.miss_streak >= self.health.degraded_after:
                r.state = DEGRADED
                self.events.append((self._step_index, "degraded",
                                    r.index, miss))
            elif r.state == DEGRADED and \
                    r.miss_streak >= self.health.dead_after:
                # health-signal death: the engine OBJECT still holds
                # its pages (its steps were completing — only the
                # heartbeat failed), so failover may migrate them
                # instead of replaying every sequence from scratch
                self._mark_dead(r, tag=miss, engine_alive=True)
        else:
            r.ok_streak += 1
            r.miss_streak = 0
            if r.state == DEGRADED and \
                    r.ok_streak >= self.health.recover_after:
                r.state = HEALTHY
                self.events.append(
                    (self._step_index, "recovered", r.index))

    def _apply_fault(self, f):
        idx = (0 if f.victim is None else int(f.victim)) \
            % len(self.replicas)
        if f.kind == "kill":
            r = self.replicas[idx]
            if r.state != DEAD:
                self._mark_dead(r, tag="kill")
        elif f.kind == "drain":
            self.drain_replica(idx)
        elif f.kind == "heartbeat":
            self._hb_missed.add(idx)
        else:
            raise ValueError(f"unknown replica fault kind {f.kind!r}")

    # ----------------------------------------------------------- failover --
    def _mark_dead(self, r, tag, detail=None, engine_alive=False):
        """Take a replica out of service and fail its requests over.
        ``engine_alive=False`` is process-death semantics: the engine
        is never touched again (its pages die with it) and every
        request replays from scratch.  ``engine_alive=True`` (health-
        signal death: the object still holds its pages) lets failover
        migrate running sequences' KV pages to survivors first."""
        if r.state == DEAD:
            return
        r.state = DEAD
        self.stats["killed"] += 1
        self.router.forget(r)
        self.events.append((self._step_index, "dead", r.index, tag))
        warnings.warn(
            f"fleet replica {r.index} died ({tag})"
            + (f": {detail}" if detail else ""),
            RuntimeWarning, stacklevel=3)
        self._failover(r, engine_alive=engine_alive)

    def _failover(self, dead, engine_alive=False):
        """Move every request the dead replica owned to a survivor.

        Per victim, in order: (1) a request already claimed by
        ``abort_request`` finishes ABORTED at the fleet level — the
        dead engine can no longer deliver its queued aborted output,
        and cancelled work is never resurrected on a peer; (2) with
        ``engine_alive`` and the MigrationPolicy agreeing, its RUNNING
        sequences MIGRATE — pages move, zero tokens recompute; (3)
        everything else requeues from scratch — original prompt,
        original kwargs (seed included), SAME request id.  Exactness
        either way: migration transplants the exact KV pages and
        Request state, and replay leans on the engine's batch-order-
        independence guarantee (greedy and per-request-seeded outputs
        do not depend on which batch or replica computes them).  With
        no routable survivor the request finishes FinishReason.error."""
        victims = [rid for rid, fr in self._live.items()
                   if fr.replica == dead.index]
        for rid in victims:
            fr = self._live[rid]
            if fr.aborting:
                del self._live[rid]
                self.events.append((self._step_index, "finish", rid,
                                    FinishReason.ABORTED))
                self._early.append(RequestOutput(
                    rid, fr.prompt_ids, [], FinishReason.ABORTED, 0))
                continue
            if engine_alive and self._try_migrate(rid, dead):
                continue
            pool = self._routable(
                role="prefill" if self.disaggregate else None)
            if not pool:
                del self._live[rid]
                self.stats["lost"] += 1
                self.events.append((self._step_index, "lost", rid))
                self._early.append(RequestOutput(
                    rid, fr.prompt_ids, [], FinishReason.ERROR, 0,
                    error=f"replica {dead.index} died with no "
                          f"routable survivor"))
                continue
            keys = self.router.affinity_keys(fr.prompt_ids)
            target, score = self.router.pick(keys, pool)
            target.engine.add_request(fr.prompt_ids, request_id=rid,
                                      **fr.kwargs)
            self.router.record(target, keys, score > 0)
            fr.replica = target.index
            fr.requeues += 1
            self.stats["requeued"] += 1
            self.events.append((self._step_index, "failover", rid,
                                dead.index, target.index))

    # ---------------------------------------------------------- migration --
    def _pick_migration_target(self, src, fr, req, role=None):
        """Destination for one migrating sequence, or None.  Strict
        ``role`` pools (the disaggregated handoff wants decode-role
        specifically); otherwise the routing pool with a same-role
        preference.  Candidates are pre-filtered on capacity — a full
        running set or a pool without enough free pages can never
        import — then the Router breaks ties (affinity, least-loaded,
        lowest index: deterministic)."""
        if role is not None:
            pool = [d for d in self.replicas
                    if d.role == role and d.routable and d is not src]
        else:
            pool = self._routable(exclude=src)
            if self.disaggregate:
                same = [d for d in pool if d.role == src.role]
                pool = same or pool
        need = len(src.engine.block_manager.block_table(req.request_id))
        pool = [d for d in pool
                if len(d.engine.scheduler.running) < d.engine.max_batch
                and d.engine.block_manager.num_free_blocks >= need]
        if not pool:
            return None
        keys = self.router.affinity_keys(fr.prompt_ids)
        target, _ = self.router.pick(keys, pool)
        return target

    def _try_migrate(self, rid, src, use_policy=True, role=None):
        """Policy-gated migration of one request off ``src``.  Returns
        True when the request now lives on a peer; False means the
        caller falls back to its pre-migration behavior (requeue from
        scratch, finish in place, or retry next step).  Only RUNNING
        sequences with resident pages migrate — waiting/preempted ones
        have no pages to move."""
        fr = self._live.get(rid)
        if fr is None or fr.replica != src.index or fr.aborting:
            return False
        req = src.engine._requests.get(rid)
        if req is None or req.status != RUNNING or \
                not src.engine.block_manager.has_seq(rid):
            return False
        if use_policy and self.migration.decide(src.engine, req) \
                == "recompute":
            self.stats["migration_recomputed"] += 1
            self.events.append((self._step_index, "migrate_skip", rid,
                                "recompute"))
            return False
        dst = self._pick_migration_target(src, fr, req, role=role)
        if dst is None:
            return False
        try:
            self._migrate(rid, src, dst)
        except MigrationError as e:
            self.stats["migration_failed"] += 1
            self.events.append((self._step_index, "migrate_fail", rid,
                                src.index, dst.index, e.reason))
            return False
        return True

    def _migrate(self, rid, src, dst):
        """Move one RUNNING sequence's KV pages ``src`` -> ``dst`` and
        resume decode mid-generation, token-exactly: the page payload,
        ``num_cached``, ``output_ids`` and the per-request sampling
        stream all ride along, so not one token recomputes and not one
        changes.  The transfer is host-staged device_get/device_put —
        no jit anywhere on the path, so an armed CompileWatcher sees
        zero new compiles.

        Raises MigrationError on any failure with BOTH pools exactly
        as before the call: export is read-only (the sequence keeps
        serving on ``src`` until release), and the destination's
        import is all-or-nothing.  Due "migration"-site faults are
        consumed here — at most one fires per fleet step, against the
        first migration attempted."""
        fr = self._live[rid]
        due = {}
        if self.faults is not None:
            due = {f.kind: f for f in self.faults.migration_faults()}
        t0 = self._timer()
        delay = due.get("delay")
        if delay is not None and delay.delay_s:
            self._sleep(delay.delay_s)
        if "export" in due:
            raise MigrationError(
                f"injected migration fault (export) for request {rid}",
                reason="export")
        state = src.engine.export_request(rid)
        hook = None
        if "import" in due:
            def hook():
                raise MigrationError(
                    f"injected migration fault (import) for request "
                    f"{rid}", reason="import")
        try:
            dst.engine.import_request(state["request"], state["seq"],
                                      state["k_pages"],
                                      state["v_pages"],
                                      fault_hook=hook,
                                      k_scales=state.get("k_scales"),
                                      v_scales=state.get("v_scales"))
        except MigrationError:
            raise
        except Exception as e:   # NoFreeBlocks, injected OOM, shape --
            raise MigrationError(
                f"import on replica {dst.index} failed: {e}",
                reason=type(e).__name__) from e
        src.engine.release_request(rid)
        pages = len(state["seq"]["block_ids"])
        nbytes = pages * src.engine.page_bytes * src.engine.tp
        fr.replica = dst.index
        self.stats["migrated"] += 1
        self.stats["migrated_bytes"] += nbytes
        self.migration_ms.append((self._timer() - t0) * 1e3)
        self.router.touch(dst, self.router.affinity_keys(fr.prompt_ids))
        self.events.append((self._step_index, "migrate", rid,
                            src.index, dst.index, pages))

    def _tier_reroute(self, rid, src):
        """Drain fallback when direct migration didn't land: demote
        the RUNNING sequence's chain into the SHARED host pool and
        hand the request to a peer's waiting queue.  The peer swaps
        the chain in at its own admission, so the handoff never waits
        on destination HBM headroom — the reason direct migration most
        often fails during a drain.  Policy-gated like any demote;
        returns True when the request now lives on a peer.  On any
        refusal both engines and both tiers are exactly as before (the
        sequence finishes in place on ``src``)."""
        if self.host_pool is None:
            return False
        fr = self._live.get(rid)
        if fr is None or fr.replica != src.index or fr.aborting:
            return False
        eng = src.engine
        req = eng._requests.get(rid)
        if req is None or req.status != RUNNING or \
                not eng.block_manager.has_seq(rid):
            return False
        # same committed-chain gate as the engine's demote path: only
        # a decode-ready chain (every resident token committed) swaps
        # token-exactly
        if not req.prefill_done or req.num_cached <= 0 or \
                eng.block_manager.num_tokens(rid) != req.num_cached:
            return False
        npages = len(eng.block_manager.block_table(rid))
        nbytes = npages * eng.page_bytes * eng.tp
        if rid in self.host_pool or not self.host_pool.fits(nbytes):
            return False
        if self.kv_tier.policy.decide(eng, req.num_cached, npages) \
                != "swap":
            return False
        pool = self._routable(exclude=src)
        if not pool:
            return False
        keys = self.router.affinity_keys(fr.prompt_ids)
        dst, _ = self.router.pick(keys, pool)
        # export is read-only; adopt validates (adapter known, id
        # free) BEFORE src releases anything, so a refusal here leaves
        # the sequence serving on src untouched
        state = eng.export_request(rid)
        try:
            dst.engine.adopt_waiting(req)
        except (MigrationError, ValueError):
            return False
        eng.release_request(rid)
        # insert the chain LAST — release's tier cleanup must not see
        # (and drop) the entry the peer is about to swap in
        entry = {"seq": state["seq"], "k_pages": state["k_pages"],
                 "v_pages": state["v_pages"],
                 "k_scales": state.get("k_scales"),
                 "v_scales": state.get("v_scales")}
        for old in self.host_pool.put(rid, entry):
            dst.engine._promote_chain(old)
        fr.replica = dst.index
        self.stats["tier_rerouted"] += 1
        self.router.touch(dst, keys)
        self.events.append((self._step_index, "tier_reroute", rid,
                            src.index, dst.index, npages))
        return True

    def _handoff_prefilled(self):
        """Disaggregated mode: every sequence on a prefill replica
        that has crossed the prefill→decode boundary (final chunk
        committed, first token emitted) hands off to a decode replica
        via the migration path — no policy gate, the role split IS the
        policy.  A sequence that cannot move right now (no routable
        decode replica, destination full, injected fault) simply
        retries next step while decoding where it is: specialization
        degrades to unified serving rather than stalling."""
        for r in self.replicas:
            if r.role != "prefill" or not r.live:
                continue
            for req in list(r.engine.scheduler.running):
                if not req.prefill_done:
                    continue
                self._try_migrate(req.request_id, r, use_policy=False,
                                  role="decode")

    def kill_replica(self, index):
        """Simulate replica process death (the chaos surface behind
        "replica"/"kill" faults).  Returns False if already dead."""
        r = self.replicas[index]
        if r.state == DEAD:
            return False
        self._mark_dead(r, tag="kill")
        return True

    # -------------------------------------------------------------- drain --
    def drain_replica(self, index):
        """Rolling drain for zero-downtime restart: the replica leaves
        the routing pool, its WAITING requests reroute to peers (their
        pages were never computed — nothing is lost), its RUNNING ones
        MIGRATE to peers (policy-gated KV page handoff — drain latency
        stops being proportional to the longest running generation),
        and once empty it parks ``drained``.  A sequence that cannot
        migrate (policy says recompute, no peer has room, the attempt
        faults) finishes in place; with no routable peer the waiting
        requests stay put too and the drain just takes longer — a
        drain never drops work.  Returns False if the replica is dead
        or already drained."""
        r = self.replicas[index]
        if r.state in (DEAD, DRAINED):
            return False
        if r.state == DRAINING:
            return True
        r.state = DRAINING
        self.stats["drains"] += 1
        self.router.forget(r)
        self.events.append((self._step_index, "draining", r.index))
        waiting = [req.request_id
                   for req in list(r.engine.scheduler.waiting)]
        for rid in waiting:
            fr = self._live.get(rid)
            if fr is None or fr.replica != r.index or fr.aborting:
                continue
            pool = self._routable(
                exclude=r, role="prefill" if self.disaggregate else None)
            if not pool:
                break            # no peer: the drain serves them itself
            # reassign ownership FIRST, then abort the old copy — the
            # draining replica's aborted output arrives at its next
            # step and is swallowed by the ownership check
            keys = self.router.affinity_keys(fr.prompt_ids)
            target, score = self.router.pick(keys, pool)
            # a demoted chain in the SHARED host pool must survive the
            # abort (whose cleanup would otherwise drop it) — stash it
            # and re-insert once the request lives on the target, so
            # the target's admission swaps it in instead of prefilling
            stash = (self.host_pool.pop(rid)
                     if self.host_pool is not None else None)
            r.engine.abort_request(rid)
            target.engine.add_request(fr.prompt_ids, request_id=rid,
                                      **fr.kwargs)
            if stash is not None:
                for old in self.host_pool.put(rid, stash):
                    target.engine._promote_chain(old)
            self.router.record(target, keys, score > 0)
            fr.replica = target.index
            fr.requeues += 1
            self.stats["requeued"] += 1
            self.events.append((self._step_index, "reroute", rid,
                                r.index, target.index))
        for req in list(r.engine.scheduler.running):
            if self._try_migrate(req.request_id, r):
                continue
            self._tier_reroute(req.request_id, r)
        return True

    def restart_replica(self, index):
        """Return a drained or dead replica to service.  A drained
        replica keeps its engine (and its still-warm prefix cache); a
        dead one gets a fresh engine that captures its own graphs as it
        is built.  The dead engine is dropped and collected first
        (its requests were failed over already), so its pools and graph
        pool are free before the new ones are allocated: a restart never
        holds one replica more on the card."""
        r = self.replicas[index]
        if r.state not in (DRAINED, DEAD):
            raise RuntimeError(
                f"replica {index} is {r.state}; only drained or dead "
                f"replicas restart")
        if r.state == DEAD:
            import gc

            # an engine's graphs hold its step body, a bound method: the
            # cycle is freed by the collector, not by the refcount
            r.engine = None
            gc.collect()
            r.engine = self._build_engine(index)
            # a rebuilt replica must serve every tenant the fleet
            # knows: re-register the host adapter copies (device slots
            # refill lazily on first use — nothing is captured)
            for aid, weights in self._adapters.items():
                r.engine.add_adapter(aid, weights)
            self.router.forget(r)
        r.state = HEALTHY
        r.miss_streak = r.ok_streak = 0
        r._last_wedged = 0
        self.stats["restarts"] += 1
        self.events.append((self._step_index, "restart", r.index))

    def drain(self, timeout_s=None):
        """Fleet-wide graceful quiesce (mirrors LLMEngine.drain): new
        requests shed, every in-flight request runs to completion (or
        aborts at ``timeout_s``), outputs are returned.  Admission
        reopens on return."""
        self._draining = True
        deadline = (None if timeout_s is None
                    else self._clock() + float(timeout_s))
        outs = []
        try:
            while self.has_unfinished():
                if deadline is not None and \
                        self._clock() >= deadline:
                    for rid in list(self._live):
                        self.abort_request(rid)
                outs.extend(self.step())
        finally:
            self._draining = False
        return outs

    # ----------------------------------------------------------- generate --
    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 temperature=0.0, seed=None, deadline_ms=None):
        """Batch convenience mirroring LLMEngine.generate: one [T+new]
        int array per prompt, request order preserved — whatever
        replica served (or re-served) each request."""
        if isinstance(prompts, np.ndarray) and prompts.ndim == 2:
            prompts = list(prompts)
        elif not isinstance(prompts, (list, tuple)):
            prompts = [prompts]
        order = [self.add_request(p, max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  temperature=temperature, seed=seed,
                                  deadline_ms=deadline_ms)
                 for p in prompts]
        outs = {}
        while self.has_unfinished():
            for fo in self.step():
                outs[fo.request_id] = fo
        return [outs[rid].all_ids.astype(np.int64) for rid in order]

    # -------------------------------------------------------------- stats --
    @property
    def _requests(self):
        """Live requests as {rid: scheduler.Request} — the bench/driver
        surface a single engine exposes (rebuilt per call; rids whose
        owning engine hasn't admitted them yet are simply absent)."""
        out = {}
        for rid, fr in self._live.items():
            req = self.replicas[fr.replica].engine._requests.get(rid)
            if req is not None:
                out[rid] = req
        return out

    def lifecycle_stats(self):
        """Aggregate lifecycle view: engine counters summed over every
        replica (dead ones keep their history), live gauges summed over
        live replicas, ``last_step_ms`` the slowest live replica's, and
        the fleet-level routing/failover counters on top."""
        agg = {}
        slowest = None
        for r in self.replicas:
            ls = r.engine.lifecycle_stats()
            if r.live:
                ms = ls["last_step_ms"]
                if ms is not None:
                    slowest = ms if slowest is None else max(slowest, ms)
            for k, v in ls.items():
                if k in ("last_step_ms", "step_gauges",
                         "host_overhead_fraction"):
                    continue     # not summable; recomputed below
                if k in ("queue_depth", "inflight", "free_pages") \
                        and not r.live:
                    continue     # gauges of a dead replica are gone
                agg[k] = agg.get(k, 0) + v
        agg["last_step_ms"] = slowest
        # a ratio can't be summed: rebuild it from the fleet-wide
        # numerator (host_plan_s, summed above) over summed step wall
        wall = 0.0
        for r in self.replicas:
            with r.engine._gauge_lock:
                wall += r.engine._step_wall_s
        agg["host_overhead_fraction"] = (
            agg.get("host_plan_s", 0.0) / wall if wall > 0 else None)
        agg["step_gauges"] = self.step_gauges
        agg["shed"] = agg.get("shed", 0) + self.stats["shed"]
        agg.update(self.router.stats())
        agg.update(requeued=self.stats["requeued"],
                   killed=self.stats["killed"],
                   drains=self.stats["drains"],
                   restarts=self.stats["restarts"],
                   lost=self.stats["lost"],
                   migrated=self.stats["migrated"],
                   migration_recomputed=self.stats[
                       "migration_recomputed"],
                   migration_failed=self.stats["migration_failed"],
                   migrated_bytes=self.stats["migrated_bytes"],
                   tier_rerouted=self.stats["tier_rerouted"],
                   replicas=len(self.replicas),
                   replicas_live=sum(1 for r in self.replicas if r.live))
        return agg

    def prefix_cache_stats(self):
        keys = ("prompt_tokens", "prefix_hit_tokens", "reused_blocks",
                "evictions", "cached_blocks")
        agg = {k: 0 for k in keys}
        for r in self.replicas:
            if not r.live:
                continue
            pc = r.engine.prefix_cache_stats()
            for k in keys:
                agg[k] += pc[k]
        agg["hit_rate"] = (agg["prefix_hit_tokens"] / agg["prompt_tokens"]
                           if agg["prompt_tokens"] else 0.0)
        return agg

    def spec_stats(self):
        keys = ("spec_steps", "draft_tokens", "accepted_tokens")
        agg = {k: 0 for k in keys}
        for r in self.replicas:
            if not r.live:
                continue
            sp = r.engine.spec_stats()
            for k in keys:
                agg[k] += sp[k]
        agg["acceptance_rate"] = (
            agg["accepted_tokens"] / agg["draft_tokens"]
            if agg["draft_tokens"] else 0.0)
        return agg

    def check_invariants(self):
        """Page books of every live replica must balance — across
        every tier: the engine-level check covers HBM plus the SHARED
        host pool and prefix store, so pages are conserved globally
        (one replica's demote is never double-resident anywhere)."""
        for r in self.replicas:
            if r.live:
                r.engine.check_invariants()

    def tier_stats(self):
        """Fleet view of the hierarchical-KV tiers: the SHARED pool
        and store books (counted once — every replica holds the same
        objects) plus the per-replica swapped-in token totals."""
        if self.kv_tier is None:
            raise ValueError("tier_stats() needs a kv_tier= fleet")
        return {
            "swapped_in_tokens": sum(
                r.engine.scheduler.swapped_in_tokens
                for r in self.replicas),
            "tier_rerouted": self.stats["tier_rerouted"],
            "host_pool": (self.host_pool.stats()
                          if self.host_pool is not None else None),
            "prefix_store": (self.prefix_store.stats()
                             if self.prefix_store is not None else None),
        }
