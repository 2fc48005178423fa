"""Clock protocol and the simulator's virtual clock.

Every host-side component that measures or waits on time — the
engine's deadline expiry and step timing, the retry backoff sleeps,
the ``StepWatchdog``, the fleet's drain loop and migration timer —
takes an injectable clock instead of reaching for ``time.monotonic``
directly.  A clock is just a zero-argument callable returning seconds
(``time.monotonic`` itself satisfies the protocol); clocks that can
*wait* additionally expose ``sleep(dt)``, and callers that need to
block fall back to ``time.sleep`` when the injected clock has none.

:class:`VirtualClock` is the discrete-event simulator's time source:
it only moves when told to (``advance``), and ``sleep`` advances it
instead of blocking, so a retry backoff or an injected delay fault
costs virtual seconds and zero wall time.  Running the *real* engine
under a VirtualClock is also meaningful — deadlines and arrival
ordering become a pure function of the trace, independent of host
speed — and is exactly how the calibration harness produces the
reference run the simulator is diffed against.
"""

import time

__all__ = ["Clock", "VirtualClock", "SYSTEM_CLOCK"]


class Clock:
    """Protocol: a clock is a zero-arg callable returning seconds.

    ``time.monotonic`` and ``time.perf_counter`` satisfy it as-is.
    Clocks may optionally provide ``sleep(dt)``; callers use
    ``getattr(clock, "sleep", time.sleep)`` so plain callables work.
    """

    def __call__(self):  # pragma: no cover - protocol stub
        raise NotImplementedError

    def sleep(self, dt):  # pragma: no cover - protocol stub
        raise NotImplementedError


#: The default wall clock (module-level so tests can identity-check it).
SYSTEM_CLOCK = time.monotonic


class VirtualClock:
    """Deterministic, manually-advanced clock for discrete-event runs.

    >>> clk = VirtualClock()
    >>> clk()
    0.0
    >>> clk.advance(2.5)
    2.5
    >>> clk.sleep(0.5)      # advances instead of blocking
    >>> clk.now
    3.0
    """

    def __init__(self, start=0.0):
        self.now = float(start)

    def __call__(self):
        return self.now

    def advance(self, dt):
        if dt < 0:
            raise ValueError(f"cannot advance a clock by {dt!r} seconds")
        self.now += float(dt)
        return self.now

    def sleep(self, dt):
        if dt > 0:
            self.advance(dt)

    def __repr__(self):
        return f"VirtualClock(now={self.now:.6f})"
