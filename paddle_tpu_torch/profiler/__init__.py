"""paddle.profiler (port of ``paddle_tpu/profiler/__init__.py``) over
``torch.profiler``.

Reference: python/paddle/profiler/profiler.py:340 (Profiler with
scheduler states :79, chrome-trace export, summary tables in
profiler_statistic.py); RecordEvent hooks are generated into every
ad_func (eager_gen.py template).

The host side is the JAX package's: ``RecordEvent`` spans and one event
per op the dispatcher runs (``ops/dispatch.py``) while a profiler
records, aggregated into the reference's summary-table shape.  The
device side is ``torch.profiler`` in place of ``jax.profiler``: while
the scheduler says RECORD, a ``torch.profiler.profile`` runs with the
CPU activity and, for ``ProfilerTarget.GPU`` on a CUDA machine, the CUDA
activity; ``RecordEvent`` spans also enter ``record_function`` so they
show in its trace.  The hand-written kernels appear there under their
``torch.library`` op names (``paddle_tpu_torch::flash_attention_fwd``
and so on) and their CUDA kernel names.  ``summary`` prints the host
table and, after a device trace, each op's and each CUDA kernel's calls
and times (:meth:`Profiler.op_stats`); ``export`` writes the torch chrome
trace when there is one, else the host events, in the chrome-tracing
JSON shape.  ``timer_only=True`` records host events only.
"""

import contextlib
import json
import os
import threading
import time
from enum import Enum

import torch


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Reference profiler.make_scheduler: step -> ProfilerState."""
    cycle = closed + ready + record
    if cycle <= 0:
        raise ValueError("scheduler cycle must be positive")

    def schedule(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


class _HostEvents(threading.local):
    def __init__(self):
        self.active = False
        self.records = []   # (name, start, dur)


_events = _HostEvents()


class RecordEvent:
    """Host event span (reference platform/profiler RecordEvent); also a
    ``torch.profiler.record_function`` range, so spans appear in the
    torch trace."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._range = None
        self._t0 = None

    def begin(self):
        if _events.active:
            self._t0 = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._t0 is not None and _events.active:
            _events.records.append(
                (self.name, self._t0, time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def record_host_event(name, start, dur):
    if _events.active:
        _events.records.append((name, start, dur))


def host_events_active():
    return _events.active


def _device_us(evt):
    """An aggregate's device time in µs, under either name torch gives
    it."""
    return float(getattr(evt, "device_time_total", None)
                 or getattr(evt, "cuda_time_total", 0.0) or 0.0)


class Profiler:
    """paddle.profiler.Profiler API shape.

    >>> p = Profiler(targets=[ProfilerTarget.CPU], timer_only=True)
    >>> p.start()
    ... train ...
    >>> p.step()
    >>> p.stop()
    >>> p.summary()
    """

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, trace_dir=None):
        self.targets = targets or [ProfilerTarget.CPU]
        if isinstance(scheduler, tuple):
            start, end = scheduler
            scheduler = make_scheduler(closed=start, ready=0,
                                       record=end - start, repeat=1)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.step_num = 0
        self._prof = None        # the running torch profile
        self._last = None        # the last finished one
        self._trace_dir = trace_dir
        self._running = False

    # ------------------------------------------------------------ control --
    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self.targets and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _start_device_trace(self):
        if self.timer_only or self._prof is not None:
            return
        self._prof = torch.profiler.profile(
            activities=self._activities(), record_shapes=self.record_shapes,
            profile_memory=self.profile_memory)
        self._prof.__enter__()

    def _stop_device_trace(self):
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._last, self._prof = self._prof, None

    def _apply_state(self, state):
        recording = state in (ProfilerState.RECORD,
                              ProfilerState.RECORD_AND_RETURN)
        _events.active = recording
        if recording:
            self._start_device_trace()
        else:
            self._stop_device_trace()
        if state == ProfilerState.RECORD_AND_RETURN and \
                self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def start(self):
        self._running = True
        _events.records = []
        if self.scheduler is not None:
            self._apply_state(self.scheduler(self.step_num))
        else:
            _events.active = True
            self._start_device_trace()

    def stop(self):
        if not self._running:
            return
        self._stop_device_trace()
        _events.active = False
        self._running = False
        if self.on_trace_ready is not None and self.scheduler is None:
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        self.step_num += 1
        if self._running and self.scheduler is not None:
            self._apply_state(self.scheduler(self.step_num))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ reports --
    def aggregated_events(self):
        agg = {}
        for name, _, dur in _events.records:
            tot, cnt, mx = agg.get(name, (0.0, 0, 0.0))
            agg[name] = (tot + dur, cnt + 1, max(mx, dur))
        return agg

    def op_stats(self):
        """{name: (calls, host ms, device ms)} of every operator, range
        and CUDA kernel of the last device trace ({} without one)."""
        if self._last is None:
            return {}
        return {e.key: (int(e.count), e.cpu_time_total / 1e3,
                        _device_us(e) / 1e3)
                for e in self._last.key_averages()}

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Reference summary table (profiler_statistic.py) — host op times,
        then, after a device trace, each operator's and kernel's calls
        and times."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        agg = sorted(self.aggregated_events().items(),
                     key=lambda kv: -kv[1][0])
        lines = [f"{'Name':<40} {'Calls':>8} {'Total(' + time_unit + ')':>14} "
                 f"{'Avg(' + time_unit + ')':>12} {'Max(' + time_unit + ')':>12}"]
        lines.append("-" * len(lines[0]))
        for name, (tot, cnt, mx) in agg:
            lines.append(f"{name[:40]:<40} {cnt:>8} {tot * unit:>14.4f} "
                         f"{tot / cnt * unit:>12.4f} {mx * unit:>12.4f}")
        ops = self.op_stats()
        if ops:
            head = (f"{'Operator / kernel':<60} {'Calls':>8} "
                    f"{'Host(' + time_unit + ')':>14} "
                    f"{'Device(' + time_unit + ')':>14}")
            lines += ["", head, "-" * len(head)]
            for name, (cnt, host_ms, dev_ms) in sorted(
                    ops.items(), key=lambda kv: -kv[1][2]):
                lines.append(f"{name[:60]:<60} {cnt:>8} "
                             f"{host_ms / 1e3 * unit:>14.4f} "
                             f"{dev_ms / 1e3 * unit:>14.4f}")
        table = "\n".join(lines)
        print(table)
        return table

    def export_chrome_tracing(self, path):
        """Write the last device trace (torch's chrome trace, with the
        RecordEvent ranges in it), or without one the host events, as a
        chrome://tracing JSON file (the reference's
        chrometracing_logger.cc output shape)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self._last is not None:
            self._last.export_chrome_trace(path)
            return path
        events = []
        for name, start, dur in _events.records:
            events.append({"name": name, "ph": "X", "pid": os.getpid(),
                           "tid": 0, "ts": start * 1e6, "dur": dur * 1e6})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return path

    def export(self, path, format="json"):
        return self.export_chrome_tracing(path)


@contextlib.contextmanager
def profiler_guard(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()
