"""``profiler``, ``framework/memory`` and ``amp.debugging`` on the port
against the JAX package, on the CPU.

The scheduler's states and the host events (RecordEvent spans, one event
an op while recording) follow the JAX module; the device side is
``torch.profiler`` (here its CPU activity only).  Memory: on the CPU
both packages read the native host counters, so they report the same
numbers.  The tensor checker names the op that made a NaN or an Inf, on
the Tensor path and on the raw torch path GPT and TrainStep take.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import profiler as jprof
from paddle_tpu.amp import debugging as jdebug
from paddle_tpu.framework import memory as jmem

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn, profiler
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.framework import memory

F32 = np.float32


@pytest.fixture(autouse=True)
def _cpu():
    paddle.set_device("cpu")


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=2),
    dict(closed=0, ready=0, record=1),
    dict(closed=2, ready=1, record=3, repeat=1, skip_first=3),
])
def test_scheduler_states_match(kw):
    ps, js = profiler.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [ps(i).name for i in range(20)] == [js(i).name
                                               for i in range(20)]
    with pytest.raises(ValueError):
        profiler.make_scheduler(closed=0, ready=0, record=0)


def test_host_events_summary_and_export(tmp_path):
    model = nn.Linear(8, 8)
    x = paddle.to_tensor(np.random.RandomState(0).randn(4, 8).astype(F32))
    p = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU],
                          timer_only=True)
    with p:
        with profiler.RecordEvent("user_span"):
            for _ in range(3):
                model(x)
        torch.matmul(torch.ones(2, 2), torch.ones(2, 2))   # not an op
        nn.functional.linear(torch.ones(2, 8), model.weight._data)  # raw
    agg = p.aggregated_events()
    assert agg["user_span"][1] == 1
    assert agg["linear"][1] == 4    # three Tensor calls and the raw one
    assert "user_span" in p.summary()
    out = p.export(str(tmp_path / "trace.json"))
    with open(out) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"user_span", "linear"} <= names
    assert p.op_stats() == {}          # timer_only: no device trace
    model(x)                           # not recording: nothing added
    assert p.aggregated_events()["linear"][1] == 4


def test_scheduler_gates_recording_like_the_reference():
    runs = []
    for prof, lib, m in ((profiler, paddle, nn.Linear(4, 4)),
                         (jprof, jpaddle, jpaddle.nn.Linear(4, 4))):
        x = lib.to_tensor(np.ones((2, 4), F32))
        ready = []
        p = prof.Profiler(timer_only=True, scheduler=(2, 4),
                          on_trace_ready=lambda pr: ready.append(
                              pr.step_num))
        p.start()
        seen = []
        for step in range(6):
            with prof.RecordEvent(f"step{step}"):
                m(x)
            seen.append(f"step{step}" in p.aggregated_events())
            p.step()
        p.stop()
        runs.append((seen, ready))
    assert runs[0] == runs[1]


def test_device_trace_counts_the_operators(tmp_path):
    """Without timer_only a torch profile runs while recording; its
    operators (the port's registered ones dispatch torch ops) show with
    their calls, and export writes torch's chrome trace."""
    x = torch.ones(16, 16)
    with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                    profiler.ProfilerTarget.GPU]) as p:
        for _ in range(3):
            with profiler.RecordEvent("mm_span"):
                torch.mm(x, x)
    stats = p.op_stats()
    assert stats["aten::mm"][0] == 3 and stats["mm_span"][0] == 3
    table = p.summary()
    assert "aten::mm" in table and "mm_span" in table
    with open(p.export(str(tmp_path / "t.json"))) as f:
        assert any(e.get("name") == "mm_span"
                   for e in json.load(f)["traceEvents"])


def test_memory_on_the_cpu_reports_as_the_reference():
    """No CUDA device: both packages read the native host counters, the
    same library, so they report the same numbers."""
    memory.host_stat_update("Allocated", 4096)
    assert memory.host_stat_current("Allocated") >= 4096
    for fn in ("memory_allocated", "max_memory_allocated",
               "memory_reserved", "max_memory_reserved"):
        got, want = getattr(memory, fn)(), getattr(jmem, fn)()
        assert isinstance(got, int) and got == want, fn
    assert memory.max_memory_allocated() >= memory.memory_allocated()
    memory.reset_peak_memory_stats()
    assert memory.host_stat_peak("Allocated") == \
        memory.host_stat_current("Allocated")
    assert paddle.framework.memory is memory   # the JAX package's path


def test_tensor_checker_names_the_op():
    cfg = debugging.TensorCheckerConfig(enable=True)
    x = paddle.to_tensor(np.array([1.0, 0.0], F32))
    debugging.enable_tensor_checker(cfg)
    try:
        paddle.exp(x)                                 # finite: passes
        with pytest.raises(FloatingPointError, match="'log'"):
            paddle.log(x)                             # log(0) = -inf
        with pytest.raises(FloatingPointError, match="'linear'"):
            nn.functional.linear(torch.tensor([[np.inf]]), torch.ones(1, 1))
    finally:
        debugging.disable_tensor_checker()
    paddle.log(x)                                     # off again
    report = debugging.TensorCheckerConfig(
        enable=True, debug_mode=debugging.DebugMode.CHECK_NAN_INF,
        skipped_op_list=["exp"])
    debugging.enable_tensor_checker(report)
    try:
        paddle.log(x)                                 # prints, no raise
    finally:
        debugging.disable_tensor_checker()
    assert debugging.current_checker() is None


def test_operator_stats_match_the_reference():
    tables = []
    for lib, dbg in ((paddle, debugging), (jpaddle, jdebug)):
        x = lib.to_tensor(np.array([1.0, 0.0, 4.0], F32))
        with dbg.collect_operator_stats():
            lib.sqrt(x)
            lib.log(x)
            lib.log(x)
            x.astype("float16")
        stats = dbg._op_stats
        dbg.enable_operator_stats_collection()
        lib.exp(x)
        tables.append(dbg.disable_operator_stats_collection().table)
        assert stats is None
    assert tables[0] == tables[1]
