"""Seeded deterministic interleaving scheduler for the async serving host.

The static half (framework/concurrency_lint.py) proves lock discipline on
paper; this is the runtime half: a cooperative-checkpoint scheduler that
serializes the AsyncLLMEngine / Fleet threads and drives them through
ADVERSARIAL interleavings chosen by a seeded RNG — submit-vs-drain,
abort-vs-failover, adapter-load-vs-step, stage-vs-abort — while the test
harness asserts token-exactness, zero leaked pages, and zero new compiles
per explored schedule.  Replayable from its seed, exactly like
``FaultInjector``: same seed -> same grant sequence -> same event log.

How it works
------------
At most ONE participating thread runs at a time.  Participants hit
*interleave points* (cheap no-ops when no scheduler is active) sprinkled
through the engine's lock-free sites; at a point the thread parks, the
seeded RNG picks which READY thread runs next, and the grant sequence is
recorded in ``schedule_log``.  Because execution is fully serialized, the
point sequence each thread emits is a deterministic function of the seed.

Three rules keep the token protocol deadlock-free:

- points are only placed at LOCK-FREE sites.  Code that calls into the
  engine while holding a real lock (``AsyncLLMEngine.submit`` under
  ``_cond``) wraps the call in :func:`masked`, which turns inner points
  into no-ops — a parked thread can never own a real lock another
  participant needs.
- a thread idling in ``Condition.wait`` participates via
  :func:`interleave_wait`, which RELEASES the real condition before
  parking and reacquires it after the grant — the scheduler never holds a
  participant inside a real critical section.
- unknown threads (pytest's main thread calling a sync engine, XLA's
  internal pools) pass through untouched: only threads the scheduler
  spawned — or whose name matches an ``adopt`` prefix, like the
  ``llm-async-worker-N`` stepping thread — take part.

Cookbook::

    sched = InterleavingScheduler(seed=7, adopt=("llm-async-worker",))
    aeng = AsyncLLMEngine(engine)          # worker adopted at its wait
    sched.spawn("submitter", lambda: [aeng.submit(p) for p in prompts])
    sched.spawn("drainer", lambda: aeng.drain(timeout_s=30))
    sched.run()                            # drive to completion
    sched.schedule_log                     # the replayable evidence

Same seed, same actors -> identical ``schedule_log`` and engine event
logs; a different seed explores a different interleaving.  See
tests/test_interleaving.py for the token-exactness / leak / compile
assertions layered on top.
"""

from __future__ import annotations

import threading
import time

__all__ = [
    "InterleavingScheduler", "interleave_point", "interleave_wait",
    "masked",
]

# The active scheduler (at most one per process — interleaving tests are
# process-global by construction, like jit caches).
_ACTIVE = None
_TLS = threading.local()


def _masked_depth():
    return getattr(_TLS, "mask_depth", 0)


class masked:
    """Context manager: interleave points inside are no-ops for this
    thread.  Wrap engine calls made while holding a real lock."""

    def __enter__(self):
        _TLS.mask_depth = _masked_depth() + 1
        return self

    def __exit__(self, *exc):
        _TLS.mask_depth = _masked_depth() - 1
        return False


def interleave_point(label=""):
    """Cooperative checkpoint.  No-op unless an InterleavingScheduler is
    active AND the calling thread participates AND the point is not
    masked.  Place ONLY at lock-free sites."""
    s = _ACTIVE
    if s is None or _masked_depth():
        return
    s._point(label)


def interleave_wait(cond, timeout=None):
    """``cond.wait(timeout)`` that participates in the active schedule.

    With no scheduler active this IS ``cond.wait(timeout)``.  Under a
    scheduler the real condition is released around the park, so other
    participants can take it while this thread is descheduled.  Returns
    True (caller loops re-checking its predicate, the only correct CV
    idiom anyway)."""
    s = _ACTIVE
    if s is None or _masked_depth():
        return cond.wait(timeout=timeout)
    if not s._participates():
        return cond.wait(timeout=timeout)
    cond.release()
    try:
        s._point("wait")
    finally:
        cond.acquire()
    return True


class _Actor:
    __slots__ = ("name", "fn", "thread", "error")

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn
        self.thread = None
        self.error = None


class InterleavingScheduler:
    """Seeded deterministic scheduler over cooperative checkpoints.

    Parameters
    ----------
    seed:
        Drives every grant decision.  Same seed + same actors = same
        ``schedule_log`` (the FaultInjector replay contract).
    adopt:
        Thread-name prefixes to adopt as participants when they reach
        their first interleave point / wait (the AsyncLLMEngine worker:
        ``("llm-async-worker",)``).
    deadline_s:
        Real-time safety net: a wedged schedule raises with the log so
        far instead of hanging the test run forever.
    """

    def __init__(self, seed=0, adopt=(), deadline_s=60.0):
        self.seed = int(seed)
        self.adopt = tuple(adopt)
        self.deadline_s = float(deadline_s)
        # Grant decisions come from a tiny deterministic LCG (no
        # numpy dependency, no global RNG state): xorshift64*.
        self._rng_state = (self.seed * 2654435761 + 1) & 0xFFFFFFFFFFFFFFFF
        self._cv = threading.Condition()
        self._states = {}        # alias -> "ready"|"running"|"done"
        self._granted = None     # alias currently allowed to run
        self._active = False
        self._quorum = 0         # check-ins required before ANY grant
        self._actors = []
        # real thread name -> canonical alias: adopted threads carry a
        # process-global counter in their name (llm-async-worker-7), so
        # the log aliases them per-schedule (llm-async-worker#0) to keep
        # replays byte-identical across runs in one process
        self._alias = {}
        self.schedule_log = []   # (label, granted-alias) decisions

    # ------------------------------------------------------------- RNG --
    def _rand(self, n):
        x = self._rng_state
        x ^= (x >> 12) & 0xFFFFFFFFFFFFFFFF
        x ^= (x << 25) & 0xFFFFFFFFFFFFFFFF
        x ^= (x >> 27) & 0xFFFFFFFFFFFFFFFF
        self._rng_state = x
        return ((x * 2685821657736338717) & 0xFFFFFFFFFFFFFFFF) % n

    # ------------------------------------------------------- membership --
    def _participates(self):
        name = threading.current_thread().name
        # GIL-snapshot membership probe: a thread's own registration
        # cannot race with itself, and adopt-prefix matching is pure
        if name in self._alias:     # noqa: R001 (own-thread membership snapshot)
            return True
        return any(name.startswith(p) for p in self.adopt)

    def _checkin_locked(self, name):  # guarded-by: _cv
        """Register the calling thread; returns its canonical alias."""
        alias = self._alias.get(name)
        if alias is None:
            alias = name
            for p in self.adopt:
                if name.startswith(p):
                    n = sum(1 for a in self._alias.values()
                            if a.startswith(p + "#"))
                    alias = f"{p}#{n}"
                    break
            self._alias[name] = alias
            self._states[alias] = "ready"
            self._cv.notify_all()
        return alias

    # ------------------------------------------------------------ token --
    def _grant_locked(self, label):  # guarded-by: _cv
        """Pick the next runner among READY threads (seeded).  The
        token is EXCLUSIVE: no grant while any thread is still running
        (a granted thread that has not re-parked yet) — two concurrent
        runners would make the interleaving wall-clock-dependent."""
        if self._granted is not None:
            return
        if any(st == "running" for st in self._states.values()):
            return
        # no grant before every expected participant has parked once:
        # pre-quorum grants would depend on thread-startup timing, not
        # on the seed
        if len(self._states) < self._quorum:
            return
        # schedule over (every actor done): stop granting — the tail
        # would otherwise spin adopted threads for a timing-dependent
        # number of turns until run() notices and deactivates
        if self._actors and all(
                self._states.get(a.name) == "done"
                for a in self._actors):
            return
        ready = sorted(n for n, st in self._states.items()
                       if st == "ready")
        if not ready:
            return
        pick = ready[self._rand(len(ready))]
        self._granted = pick
        self.schedule_log.append((label, pick))
        self._cv.notify_all()

    def _point(self, label):
        name = threading.current_thread().name
        deadline = time.monotonic() + self.deadline_s
        with self._cv:
            if not self._active:
                return
            alias = self._checkin_locked(name)
            self._states[alias] = "ready"
            if self._granted == alias:
                self._granted = None
            self._grant_locked(label)
            while self._active and self._granted != alias:
                self._cv.wait(timeout=0.05)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"interleave point wedged in {alias!r} "
                        f"(label={label!r}); log so far: "
                        f"{self.schedule_log}")
            if self._active:
                self._states[alias] = "running"

    # ----------------------------------------------------------- actors --
    def spawn(self, name, fn):
        """Register an actor (not started until :meth:`run`)."""
        if any(a.name == name for a in self._actors):
            raise ValueError(f"duplicate actor name {name!r}")
        self._actors.append(_Actor(name, fn))
        return self

    def _actor_main(self, actor):
        try:
            interleave_point("start")
            actor.fn()
        except Exception as e:     # surfaced by run()
            actor.error = e
        finally:
            with self._cv:
                alias = self._alias.get(actor.name, actor.name)
                self._states[alias] = "done"
                if self._granted == alias:
                    self._granted = None
                self._grant_locked("exit")
                self._cv.notify_all()

    # -------------------------------------------------------------- run --
    def run(self, expect_adopted=0):
        """Start every spawned actor, drive the schedule to completion,
        deactivate, and re-raise the first actor error (if any).

        ``expect_adopted``: number of adopt-prefix threads that must
        check in (reach a point) before the first grant — makes the
        initial READY set, and therefore the whole schedule, a
        deterministic function of the seed."""
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("another InterleavingScheduler is active")
        deadline = time.monotonic() + self.deadline_s
        _ACTIVE = self
        with self._cv:
            self._active = True
            self._quorum = len(self._actors) + int(expect_adopted)
        try:
            for a in self._actors:
                a.thread = threading.Thread(
                    target=self._actor_main, args=(a,),
                    name=a.name, daemon=True)
                a.thread.start()
            want = len(self._actors) + int(expect_adopted)
            with self._cv:
                while len(self._states) < want:
                    self._cv.wait(timeout=0.05)
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"only {sorted(self._states)} of {want} "
                            f"participants checked in")
                self._grant_locked("go")
                while not all(self._states.get(a.name) == "done"
                              for a in self._actors):
                    self._cv.wait(timeout=0.05)
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"schedule wedged; states={self._states}, "
                            f"granted={self._granted!r}, "
                            f"log={self.schedule_log}")
        finally:
            with self._cv:
                self._active = False
                self._granted = None
                self._cv.notify_all()
            _ACTIVE = None
        for a in self._actors:
            a.thread.join(timeout=self.deadline_s)
        for a in self._actors:
            if a.error is not None:
                raise a.error
        # quiescent: scheduler deactivated and every actor joined above
        return self.schedule_log    # noqa: R001 (post-join quiescent read)
