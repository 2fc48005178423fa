"""Throughput/section timers (reference
python/paddle/distributed/fleet/utils/timer_helper.py: _Timer/_Timers with
start/stop/elapsed and a log() aggregator — the training-loop
instrumentation hybrid trainers print each interval)."""

import time

__all__ = ["get_timers", "set_timers"]


class _Timer:
    def __init__(self, name):
        self.name = name
        self._elapsed = 0.0
        self._started = False
        self._start_time = None

    def start(self):
        assert not self._started, f"timer {self.name} already started"
        self._start_time = time.perf_counter()
        self._started = True

    def stop(self):
        assert self._started, f"timer {self.name} is not started"
        self._elapsed += time.perf_counter() - self._start_time
        self._started = False

    def reset(self):
        self._elapsed = 0.0
        self._started = False

    def elapsed(self, reset=True):
        started = self._started
        if started:
            self.stop()
        total = self._elapsed
        if reset:
            self.reset()
        if started:
            self.start()
        return total


class _Timers:
    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def log(self, names=None, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                el = self.timers[name].elapsed(reset=reset)
                parts.append(f"{name}: {el * 1000.0 / normalizer:.2f}ms")
        line = "time (ms) | " + " | ".join(parts)
        print(line)
        return line


_GLOBAL_TIMERS = None


def get_timers():
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = _Timers()
    return _GLOBAL_TIMERS


def set_timers(timers=None):
    global _GLOBAL_TIMERS
    _GLOBAL_TIMERS = timers if timers is not None else _Timers()
    return _GLOBAL_TIMERS
