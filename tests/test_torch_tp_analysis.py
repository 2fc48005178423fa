"""The graph tools over a tensor-parallel engine: ``analyze_engine``,
``run_census``, C001 and ``StepTimeModel.from_engine`` at tp=2, and the
``graph-lint`` CLI's ``engine --tp 2`` runs.

At tp > 1 ``executable_grid()`` yields rank 0's shard body with each
row-parallel all-reduce bound to the traceable stand-in
``paddle_tpu_torch::mp_all_reduce``: nothing is sent and no worker takes
part.  Held here on ``gpt_tiny(num_layers=2)`` in f32 (the JAX package's
own tp=2 analysis tests fail under the installed jax, so the facts are
the JAX tests' and the counts are derived from the body): no findings
from ``analyze_engine`` (plain, int8, n-gram speculation); a clean census
whose every bucket moves two all-reduces a layer of ``[Tb, hidden]``
partials, twice their bytes, on the ``mp`` axis; the shard's FLOPs below
tp=1's; C001 firing on a seeded back-to-back all-reduce and on nothing
else; the step-time model pricing the comms term; the served engine
untouched by the tracing; and the CLI's two runs exiting 0 with
``0 error(s), 0 warning(s)``.
"""

import numpy as np
import pytest
import torch
from torch_tp_helpers import ENGINE, close_all

from paddle_tpu_torch.framework import analysis, cost
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.inference.llm.tensor_parallel import (
    mp_all_reduce,
    traced_psum,
)
from paddle_tpu_torch.models.gpt import gpt_tiny


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread (the workers take rank 0's count)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(device="cpu", num_layers=2, seed=0).eval()


@pytest.fixture(scope="module")
def spawned():
    built = []
    yield built
    close_all(built)


@pytest.fixture(scope="module")
def tp2(model, spawned):
    eng = LLMEngine(model, device="cpu", tensor_parallel=2, **ENGINE)
    spawned.append(eng)
    return eng


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"speculative": 2}],
                         ids=["f32", "int8", "spec"])
def test_analyze_engine_tp2_zero_findings(model, spawned, tp2, kw):
    eng = tp2 if not kw else LLMEngine(model, device="cpu",
                                       tensor_parallel=2,
                                       **{**ENGINE, **kw})
    if eng is not tp2:
        spawned.append(eng)
    eng.warmup()
    findings = analysis.analyze_engine(eng)
    assert findings == [], [f.format() for f in findings]


def test_grid_bodies_trace_the_stand_in_and_leave_the_engine(tp2):
    """Each bucket's graph holds two stand-in all-reduces a layer over
    ``[Tb, hidden]`` and L B1 nodes over rank 0's heads; tracing sends
    nothing (the channel's counters stand still) and the served engine
    keeps its channel's all-reduce."""
    ch = tp2._tp.channel
    marks = (ch.bcasts, ch.allreduces)
    reduce_op = mp_all_reduce._opoverload
    for kind, bucket, body, operands in tp2.executable_grid():
        gm = analysis.trace_graph(body, *operands)
        nodes = [n for n in gm.graph.nodes if n.target == reduce_op]
        assert len(nodes) == 2 * tp2.num_layers, (kind, bucket)
        assert {tuple(n.meta["val"].shape) for n in nodes} == \
            {(bucket, tp2.num_heads * tp2.head_dim)}
        assert {n.args[1] for n in nodes} == {"mp"}
    assert (ch.bcasts, ch.allreduces) == marks
    assert tp2._shard.psum == ch.all_reduce
    with pytest.raises(RuntimeError, match="stands in"):
        mp_all_reduce(torch.zeros(2), "mp")


def test_census_tp2_clean_with_derived_collective_bytes(model, tp2):
    """``test_cost.py::TestCensus::test_census_tp2_clean`` with the
    count: every bucket's ``collective_bytes["mp"]`` is two all-reduces
    a layer x L x Tb x hidden x 4 bytes (f32) x 2, the totals sum them,
    and the shard's FLOPs sit below the tp=1 engine's bucket by bucket."""
    census = cost.run_census(tp2, profile="cpu")
    assert census.findings == [], [f.format() for f in census.findings]
    assert census.families == {"ragged": 2} and census.compile_count == 2
    hidden = tp2.num_heads * tp2.head_dim
    for e in census.entries:
        want = 2 * tp2.num_layers * e["bucket"] * hidden * 4 * 2
        assert e["cost"]["collective_bytes"] == {"mp": want}, e["label"]
    assert census.totals["collective_bytes"] == {"mp": sum(
        e["cost"]["collective_bytes"]["mp"] for e in census.entries)}
    one = cost.run_census(LLMEngine(model, device="cpu", **ENGINE),
                          profile="cpu")
    for e1, e2 in zip(one.entries, census.entries):
        assert e1["cost"]["collective_bytes"] == {}
        assert e2["cost"]["flops"] < e1["cost"]["flops"]
        assert e2["cost"]["kernels"] == e1["cost"]["kernels"]


def test_c001_fires_on_back_to_back_all_reduces():
    """A seeded back-to-back all-reduce on one axis fires C001 once; a
    sum of two fresh partials, and an all-reduce over another axis of an
    ``mp`` result, stay clean."""
    x = torch.zeros(4, 8)
    bad = analysis.trace_graph(lambda y: traced_psum(traced_psum(y)), x)
    findings = cost.check_collectives(bad, label="seeded")
    assert [f.rule for f in findings] == ["C001"]
    assert findings[0].where.startswith("seeded/")
    assert "identical all-reduce" in findings[0].message
    fine = analysis.trace_graph(
        lambda y: traced_psum(y * 2) + traced_psum(y + 1), x)
    assert cost.check_collectives(fine) == []
    other = analysis.trace_graph(
        lambda y: mp_all_reduce(traced_psum(y), "dp"), x)
    assert cost.check_collectives(other) == []


def test_step_time_model_tp2_prices_comms(tp2):
    """``StepTimeModel.from_engine`` at tp=2: each bucket's time is the
    largest of its compute, HBM and comms terms, and comms is the
    census's collective bytes over the profile's link rate."""
    model = cost.StepTimeModel.from_engine(tp2, profile="cpu")
    census = cost.run_census(tp2, profile="cpu")
    link = cost.DEVICE_PROFILES["cpu"]["ici_bytes_per_s"]
    for e in census.entries:
        est = cost.estimate_fn(*_grid_entry(tp2, e["bucket"]))
        times = est.roofline("cpu")["times_s"]
        assert times["comms"] == e["cost"]["collective_bytes"]["mp"] / link
        assert times["comms"] > 0
        assert model.times_s[("ragged", e["bucket"])] == \
            max(times.values()) == e["roofline_s"]


def _grid_entry(eng, bucket):
    for _kind, b, body, operands in eng.executable_grid():
        if b == bucket:
            return (body, *operands)
    raise KeyError(bucket)


@pytest.mark.parametrize("spec", [[], ["--spec", "2"]], ids=["plain", "spec"])
def test_cli_engine_tp2_clean(spec, capsys):
    """``test_analysis.py::TestGraphLintCLI::test_cli_engine_grid_clean``
    and ``::test_cli_engine_spec_grid_clean`` on the port, on the CPU."""
    rc = analysis.main(["engine", "--tp", "2", "--layers", "2",
                        "--device", "cpu", *spec])
    out = capsys.readouterr().out
    assert rc == 0 and "0 error(s), 0 warning(s)" in out, out


def test_served_tp2_engine_still_token_exact(model, tp2):
    """The engine the tools traced serves as before: greedy tokens equal
    the tp=1 engine's."""
    prompts = [np.arange(3, 12, dtype=np.int32),
               np.arange(20, 26, dtype=np.int32)]
    want = LLMEngine(model, device="cpu", **ENGINE).generate(
        prompts, max_new_tokens=6)
    got = tp2.generate(prompts, max_new_tokens=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
