"""Request-lifecycle vocabulary + deterministic fault injection.

A fleet is only as reliable as each replica's failure behavior, and a
failure path that cannot be *tested* has no defined behavior at all.
This module gives the serving engine both halves:

- the lifecycle vocabulary (:class:`FinishReason`) every request exits
  through — ``stop``/``length`` (the "done" family), ``aborted``
  (client cancel), ``deadline`` (per-request ``deadline_ms`` missed),
  ``shed`` (bounded admission rejected it), ``error`` (a device step
  failed and the request was quarantined);
- a seeded, deterministic :class:`FaultInjector` the engine and
  PredictorServer consult at their injection points: the device-step
  boundary (raise / delay / transient-then-succeed), the page
  allocator (forced OOM at step N — exercises the preempt/recompute
  path), and the socket layer (disconnect, partial-frame write).
  Every fault schedule is MATERIALIZED AS DATA at construction
  (:meth:`FaultInjector.random` draws it once from the seed), so
  replaying the same seed replays byte-identical fault timing — the
  chaos soak's determinism contract;
- :class:`RetryPolicy` (exponential backoff + seeded jitter, bounded
  attempts) absorbing transient step faults, and :class:`StepWatchdog`
  flagging wedged device steps that exceed a wall-clock threshold.

Faults raise BEFORE the jitted call launches, so the donated K/V pool
is never half-consumed by an injected failure — retry re-launches with
valid buffers, and a quarantined step leaves the pool exactly as the
previous step committed it.  (A *real* in-flight XLA failure can lose
donated buffers; the engine detects that and raises
:class:`PoolLostError` instead of limping on with a dead cache.)
"""
# noqa-module: H001 (host-side fault scheduling by design — the injector
# decides between device steps; nothing here runs under jit)

import time
from dataclasses import dataclass, field

import numpy as np


class FinishReason:
    """Terminal states of a request.  ``stop`` and ``length`` are the
    "done" family (generation ran to completion); everything else names
    the failure path that ended the request early."""

    STOP = "stop"          # hit eos_token_id
    LENGTH = "length"      # hit max_new_tokens
    ABORTED = "aborted"    # abort_request() / client vanished
    DEADLINE = "deadline"  # missed its deadline_ms
    SHED = "shed"          # bounded admission rejected it (queue full)
    ERROR = "error"        # device step failed; request quarantined

    DONE = (STOP, LENGTH)
    ALL = (STOP, LENGTH, ABORTED, DEADLINE, SHED, ERROR)

    @staticmethod
    def is_done(reason):
        """True when generation completed normally (survivors of a
        chaos replay must be token-exact; other reasons end early)."""
        return reason in FinishReason.DONE


class InjectedFault(RuntimeError):
    """Raised by the injector at the device-step boundary.  Carries the
    scheduled victim so quarantine can blame the responsible request
    instead of killing the whole batch."""

    def __init__(self, message, victim=None):
        super().__init__(message)
        self.victim = victim


class PoolLostError(RuntimeError):
    """A device step failed AFTER consuming the donated K/V pool — the
    cache is gone and the engine cannot recover in place."""


class MigrationError(RuntimeError):
    """A KV page migration attempt failed mid-flight (injected or
    real).  The contract is exact reclamation on BOTH pools: the source
    sequence is untouched and still serving, and any pages the
    destination allocated are freed — so the fleet can always fall back
    to the pre-migration behavior (from-scratch replay on failover,
    finish-in-place on drain) without leaking a page on either side.
    ``reason`` tags the failure point ("export" | "import" | the
    wrapped exception's class name) for deterministic event logs."""

    def __init__(self, message, reason="migration"):
        super().__init__(message)
        self.reason = reason


@dataclass
class Fault:
    """One scheduled fault.

    site:   "step" (device-step boundary), "alloc" (page allocator),
            "socket" (PredictorServer response path), "client"
            (driver-level: abort a request — consumed by chaos
            drivers, not the engine), "replica" (fleet-level:
            consumed by inference.llm.fleet.Fleet at its step
            boundary, never by a single engine).
    kind:   step:   "raise" (fails every attempt -> quarantine),
                    "transient" (fails ``count`` attempts, then
                    succeeds -> absorbed by RetryPolicy),
                    "delay" (sleep delay_s, then proceed -> exercises
                    the StepWatchdog);
            alloc:  "oom" (NoFreeBlocksError -> preempt/recompute);
            socket: "disconnect" (drop the connection before the
                    response), "partial" (write half a frame, then
                    drop);
            client: "abort";
            replica: "kill" (the victim replica dies; its requests
                    fail over), "heartbeat" (the victim misses this
                    fleet step's heartbeat — a DATA signal, no real
                    sleep, so replays stay wall-clock-free),
                    "drain" (rolling drain of the victim begins);
            migration: "export" (the page gather fails before any
                    state moves — source keeps serving), "import"
                    (the destination fails AFTER allocating pages —
                    it must reclaim them exactly; the source is
                    untouched), "delay" (sleep delay_s inside the
                    handoff window — exercises handoff-latency
                    accounting; 0 by default so replays stay
                    wall-clock-free).  Consumed by Fleet._migrate,
                    at most one fault per fleet step.
            tier:   "demote" (the HBM -> host-pool page gather fails
                    BEFORE the chain is stored — the preemption falls
                    back to plain recompute, both tiers untouched),
                    "promote" (the host-pool -> HBM swap-in fails
                    AFTER pages were allocated — they are reclaimed
                    exactly and the chain STAYS in the host pool for
                    the next attempt; register-after-scatter means a
                    mid-swap fault never exposes garbage via the
                    prefix cache), "delay" (sleep delay_s inside the
                    tier window).  Consumed by the engine's tier
                    hooks, at most one per (step, kind).
    step:   engine step index ("step"/"alloc"/"client"/"tier" sites),
            fleet step index ("replica"/"migration" sites), or
            response index ("socket" site) the fault fires at.
    count:  "transient" only — how many attempts fail before success.
    delay_s: "delay" only — injected stall length.
    victim: "raise" — index into the launch's request rows; the
            quarantined request is ``reqs[victim % len(reqs)]``; None
            quarantines every row of the failing launch.  "replica"
            site — the replica index (mod fleet size).
    """

    site: str
    kind: str
    step: int
    count: int = 1
    delay_s: float = 0.0
    victim: int = None


class FaultInjector:
    """Deterministic fault schedule + the counters to replay it.

    Build one explicitly::

        fi = FaultInjector(schedule=[
            Fault("step", "transient", step=3),   # retry absorbs it
            Fault("alloc", "oom", step=5),        # forces a preemption
            Fault("step", "raise", step=8, victim=0),
        ])
        eng = LLMEngine(model, faults=fi)

    or draw a randomized-but-seeded one (the chaos soak)::

        fi = FaultInjector.random(seed=7, steps=200, p_step=0.02)

    or a fleet-chaos one ("replica"-site kills / heartbeat misses /
    rolling drains, consumed by inference.llm.fleet.Fleet)::

        fi = FaultInjector.random_fleet(seed=7, steps=256, replicas=3,
                                        p_kill=0.02, p_heartbeat=0.05)

    The schedule is plain data; ``events`` records every fault that
    actually fired as ``(step, site, kind, attempt)`` tuples, so two
    runs from the same seed produce identical event logs.
    """

    def __init__(self, schedule=(), seed=0):
        self.seed = int(seed)
        # "delay" step faults stall via this; the owning engine rebinds
        # it to ITS injected clock's sleep (see LLMEngine.__init__), so
        # a VirtualClock run pays virtual — not wall — seconds
        self.sleep = time.sleep
        self.schedule = list(schedule)
        for f in self.schedule:
            if f.site not in ("step", "alloc", "socket", "client",
                              "replica", "migration", "tier"):
                raise ValueError(f"unknown fault site {f.site!r}")
            if f.site == "replica" and \
                    f.kind not in ("kill", "heartbeat", "drain"):
                raise ValueError(
                    f"unknown replica fault kind {f.kind!r} "
                    f"(kill | heartbeat | drain)")
            if f.site == "migration" and \
                    f.kind not in ("export", "import", "delay"):
                raise ValueError(
                    f"unknown migration fault kind {f.kind!r} "
                    f"(export | import | delay)")
            if f.site == "tier" and \
                    f.kind not in ("demote", "promote", "delay"):
                raise ValueError(
                    f"unknown tier fault kind {f.kind!r} "
                    f"(demote | promote | delay)")
        self.events = []
        self._step = -1          # current engine step index
        self._attempts = {}      # (site, step) -> attempts so far
        self._socket_idx = -1    # response counter (socket site)
        self._by_site = {}
        for f in self.schedule:
            self._by_site.setdefault((f.site, f.step), []).append(f)

    @classmethod
    def random(cls, seed, steps=128, *, p_step=0.0, p_transient=0.0,
               p_oom=0.0, p_delay=0.0, p_abort=0.0, p_tier=0.0,
               delay_s=0.0, max_victim=8):
        """Materialize a randomized schedule from ``seed`` — one
        Bernoulli draw per (site, step) in a fixed order, so the same
        seed always yields the same schedule (replayable by data, not
        by accident of interleaving).  ``p_tier`` draws hierarchical-KV
        faults (demote / promote / delay, uniformly) from a SEPARATE
        stream derived from the same seed, so adding tier chaos never
        perturbs the schedule an existing seed pins down."""
        rng = np.random.RandomState(int(seed))
        trng = np.random.RandomState((int(seed) ^ 0x517CC1B7)
                                     & 0x7FFFFFFF)
        schedule = []
        for s in range(int(steps)):
            draws = rng.uniform(size=5)
            tdraw = trng.uniform()
            tkind = ("demote", "promote", "delay")[int(trng.randint(3))]
            if draws[0] < p_step:
                schedule.append(Fault("step", "raise", step=s,
                                      victim=int(rng.randint(max_victim))))
            if draws[1] < p_transient:
                schedule.append(Fault("step", "transient", step=s,
                                      count=1))
            if draws[2] < p_oom:
                schedule.append(Fault("alloc", "oom", step=s))
            if draws[3] < p_delay:
                schedule.append(Fault("step", "delay", step=s,
                                      delay_s=delay_s))
            if draws[4] < p_abort:
                schedule.append(Fault("client", "abort", step=s))
            if tdraw < p_tier:
                schedule.append(Fault("tier", tkind, step=s,
                                      delay_s=delay_s))
        return cls(schedule=schedule, seed=seed)

    @classmethod
    def random_fleet(cls, seed, steps=256, *, replicas, p_kill=0.0,
                     p_heartbeat=0.0, p_drain=0.0, p_migration=0.0,
                     max_kills=None, max_drains=1, migration_delay_s=0.0):
        """Materialize a seeded fleet-chaos schedule ("replica"-site
        faults plus "migration"-site handoff faults): per fleet step,
        Bernoulli draws for a replica kill, a missed heartbeat, and a
        rolling drain, each with a uniformly drawn victim.  Victims are
        drawn unconditionally so the schedule is a pure function of
        ``seed`` regardless of the caps.  ``max_kills`` defaults to
        ``replicas - 1`` — a chaos schedule that can kill every replica
        has no survivors left to assert token-exactness on.
        ``p_migration`` draws migration faults (export / import /
        delay, uniformly) from a SEPARATE stream derived from the same
        seed, so adding migration chaos never perturbs the replica
        schedule an existing seed pins down."""
        if int(replicas) < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_kills is None:
            max_kills = max(0, int(replicas) - 1)
        rng = np.random.RandomState(int(seed))
        mrng = np.random.RandomState((int(seed) ^ 0x9E3779B9) & 0x7FFFFFFF)
        schedule = []
        kills = drains = 0
        for s in range(int(steps)):
            draws = rng.uniform(size=3)
            victims = rng.randint(int(replicas), size=3)
            mdraw = mrng.uniform()
            mkind = ("export", "import", "delay")[int(mrng.randint(3))]
            if draws[0] < p_kill and kills < max_kills:
                kills += 1
                schedule.append(Fault("replica", "kill", step=s,
                                      victim=int(victims[0])))
            if draws[1] < p_heartbeat:
                schedule.append(Fault("replica", "heartbeat", step=s,
                                      victim=int(victims[1])))
            if draws[2] < p_drain and drains < max_drains:
                drains += 1
                schedule.append(Fault("replica", "drain", step=s,
                                      victim=int(victims[2])))
            if mdraw < p_migration:
                schedule.append(Fault("migration", mkind, step=s,
                                      delay_s=migration_delay_s))
        return cls(schedule=schedule, seed=seed)

    # ------------------------------------------------------- engine hooks --
    def begin_step(self, step_index):
        """Engine calls this at the top of every step()."""
        self._step = int(step_index)

    def scheduled(self, site, step=None):
        """Faults scheduled for ``site`` at ``step`` (default: the
        current one).  Chaos drivers read the "client" site from here."""
        key = (site, self._step if step is None else int(step))
        return list(self._by_site.get(key, ()))

    def device_step(self, kind):
        """Consulted once per launch ATTEMPT at the device-step
        boundary, before the jitted call.  Raises InjectedFault for
        "raise"/"transient" faults, sleeps for "delay" faults."""
        for f in self.scheduled("step"):
            key = ("step", self._step, f.kind)
            attempt = self._attempts.get(key, 0)
            if f.kind == "delay":
                if attempt == 0:
                    self._attempts[key] = 1
                    self.events.append((self._step, "step", "delay", 0))
                    self.sleep(f.delay_s)
                continue
            if f.kind == "transient" and attempt >= f.count:
                continue        # absorbed: this attempt succeeds
            self._attempts[key] = attempt + 1
            self.events.append((self._step, "step", f.kind, attempt))
            raise InjectedFault(
                f"injected {f.kind} fault at step {self._step} "
                f"({kind} launch, attempt {attempt})", victim=f.victim)

    def replica_faults(self, step=None):
        """Fleet hook: the "replica"-site faults due at ``step``
        (default: the current one), each consumed — and recorded in
        ``events`` as ``(step, "replica", kind, victim)`` — exactly
        once, so a drained schedule replays to an identical log."""
        s = self._step if step is None else int(step)
        fired = []
        for f in self._by_site.get(("replica", s), ()):
            key = ("replica", s, f.kind, f.victim)
            if self._attempts.get(key):
                continue
            self._attempts[key] = 1
            self.events.append((s, "replica", f.kind, f.victim))
            fired.append(f)
        return fired

    def migration_faults(self, step=None):
        """Fleet hook: the "migration"-site faults due at ``step``
        (default: the current fleet step), each consumed — and recorded
        in ``events`` as ``(step, "migration", kind, 0)`` — exactly
        once, so only the FIRST migration attempted at a faulted step
        is hit and a drained schedule replays to an identical log.  A
        scheduled fault at a step with no migration attempt never
        fires (the handoff it targeted did not exist)."""
        s = self._step if step is None else int(step)
        fired = []
        for f in self._by_site.get(("migration", s), ()):
            key = ("migration", s, f.kind)
            if self._attempts.get(key):
                continue
            self._attempts[key] = 1
            self.events.append((s, "migration", f.kind, 0))
            fired.append(f)
        return fired

    def tier_fault(self, kind):
        """Engine hook at the hierarchical-KV boundaries.  ``kind`` is
        "demote" (consulted before a chain is stored in the host pool)
        or "promote" (consulted inside the swap-in window, after pages
        were allocated).  A due fault of that kind raises InjectedFault
        — consumed, and recorded in ``events`` as ``(step, "tier",
        kind, 0)``, exactly once, so a drained schedule replays to an
        identical log.  A due "delay" fault sleeps (on the engine's
        injected clock) once per step before either kind proceeds."""
        for f in self.scheduled("tier"):
            key = ("tier", self._step, f.kind)
            if self._attempts.get(key):
                continue
            if f.kind == "delay":
                self._attempts[key] = 1
                self.events.append((self._step, "tier", "delay", 0))
                self.sleep(f.delay_s)
                continue
            if f.kind != kind:
                continue
            self._attempts[key] = 1
            self.events.append((self._step, "tier", f.kind, 0))
            raise InjectedFault(
                f"injected tier fault ({f.kind}) at step {self._step}")

    def alloc(self, what):
        """Consulted by the page allocator's entry points.  Returns
        True exactly once per scheduled step when a forced OOM should
        fire (the caller raises its own NoFreeBlocksError so the
        scheduler's preempt path sees the genuine article)."""
        for f in self.scheduled("alloc"):
            key = ("alloc", self._step)
            if f.kind == "oom" and not self._attempts.get(key):
                self._attempts[key] = 1
                self.events.append((self._step, "alloc", "oom", 0))
                return True
        return False

    def socket_fault(self):
        """Consulted by PredictorServer once per response; returns
        "disconnect" | "partial" | None for this response index."""
        self._socket_idx += 1
        for f in self._by_site.get(("socket", self._socket_idx), ()):
            self.events.append(
                (self._socket_idx, "socket", f.kind, 0))
            return f.kind
        return None


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff + seeded jitter.

    ``max_attempts`` counts launches (1 = no retry).  Backoff for
    attempt ``a`` (0-based retry index) is
    ``min(max_delay_s, base_delay_s * 2**a) * (1 + jitter * u)`` with
    ``u ~ Uniform(-1, 1)`` from a private seeded stream — deterministic
    per policy instance, so chaos replays sleep identical schedules.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    jitter: float = 0.1
    seed: int = 0
    _rng: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        self._rng = np.random.RandomState(int(self.seed))

    @classmethod
    def resolve(cls, retry):
        """Engine-kwarg sugar: None | attempts | dict | RetryPolicy."""
        if retry is None:
            return cls()
        if isinstance(retry, cls):
            return retry
        if isinstance(retry, bool):
            raise TypeError("retry= takes None/int/dict/RetryPolicy")
        if isinstance(retry, int):
            return cls(max_attempts=retry)
        if isinstance(retry, dict):
            return cls(**retry)
        raise TypeError(
            f"retry= takes None/int/dict/RetryPolicy, "
            f"got {type(retry).__name__}")

    def backoff(self, attempt):
        """Delay (seconds) before retry ``attempt`` (0-based)."""
        base = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        return base * (1.0 + self.jitter * self._rng.uniform(-1.0, 1.0))


class StepWatchdog:
    """Flags device steps that exceed a clock threshold.

    The engine cannot interrupt a wedged XLA launch, but it CAN report
    one: every launch's elapsed time is observed, and launches past
    ``threshold_s`` are recorded in ``wedged`` (and counted), so an
    operator (or the chaos bench artifact) sees the stall without the
    step having to finish inside a profiler window.

    ``clock`` is any :class:`~paddle_tpu.sim.clock.Clock` — a zero-arg
    callable returning seconds (default ``time.perf_counter``).  The
    engine injects its own clock, so under a simulator's VirtualClock
    the watchdog measures VIRTUAL step time — injected delay faults
    trip it without any wall-clock waiting.  Callers time a launch on
    the watchdog's clock via ``t0 = wd.started()`` ...
    ``wd.observe_since(step, kind, t0)``.
    """

    def __init__(self, threshold_s, clock=None):
        if threshold_s <= 0:
            raise ValueError(
                f"watchdog threshold must be > 0, got {threshold_s}")
        self.threshold_s = float(threshold_s)
        self.clock = clock if clock is not None else time.perf_counter
        self.wedged = []          # (step_index, kind, elapsed_s)
        self.num_wedged = 0

    def started(self):
        """Timestamp on the watchdog's own clock; pass the value to
        :meth:`observe_since` when the launch returns."""
        return self.clock()

    def observe_since(self, step_index, kind, t0):
        return self.observe(step_index, kind, self.clock() - t0)

    def observe(self, step_index, kind, elapsed_s):
        if elapsed_s > self.threshold_s:
            self.num_wedged += 1
            self.wedged.append((int(step_index), kind, float(elapsed_s)))
            return True
        return False
