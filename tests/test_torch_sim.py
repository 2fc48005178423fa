"""The port's discrete-event fleet simulator (``paddle_tpu_torch.sim``).

The cases of ``tests/test_sim.py`` on ``gpt_tiny(num_layers=2)`` in f32:
the virtual clock, deadlines and the watchdog on it, the greedy-only
SimEngine, oracle determinism; ``calibrate`` decision-exact and
token-exact against the real port engine on the CPU, one engine and a
2-replica fleet (frozen event records of the fleet and of every engine
equal, outputs equal), with the simulated leg's host pools never
touching a device; per-step gauges against the event log; the
load-capped affinity finding on the hot-tenant trace; a fault-injected
fleet simulation replaying identically without leaking a page.  Beside
them, the port's simulator against the JAX package's on the same traces
(one engine, the hot-tenant fleet, a fleet with a drain that migrates
and a kill), with one SyntheticOracle and a StepTimeModel over the same
times on both sides: fleet and engine event records, outputs, virtual
time, the latency summaries and ``lifecycle_stats()`` equal; the copied
parts of ``simulator.py`` held to the JAX module's text; the SimEngines
of one fleet sharing one host copy of the weights; and the port's
``StepTimeModel``: one roofline estimate a token bucket from the
engine's shapes under ``"h100"``, rising with the bucket.  The
100-replica sweep stays in the slow tier, as in the JAX file.
"""

import ast
import inspect
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.sim as jax_sim
from paddle_tpu.framework.cost import StepTimeModel as JaxStepTimeModel
from paddle_tpu.inference.llm import to_records as jax_records
from paddle_tpu.inference.llm.faults import Fault as JaxFault
from paddle_tpu.inference.llm.faults import FaultInjector as JaxInjector
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.sim import simulator as jax_sim_mod
from paddle_tpu_torch.framework import cost
from paddle_tpu_torch.inference.llm import (
    Fault,
    FaultInjector,
    FinishReason,
    Fleet,
    LLMEngine,
    StepWatchdog,
    to_records,
)
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.sim import (
    ReplayOracle,
    SimEngine,
    SyntheticOracle,
    VirtualClock,
    calibrate,
    hot_tenant_trace,
    poisson_trace,
    run_virtual,
    sim_engine_factory,
    simulate,
    thousand_tenant_trace,
)
from paddle_tpu_torch.sim import simulator as port_sim_mod

TIMING_BAND = 0.05   # the JAX package's calibration band


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(device="cpu", num_layers=2, seed=0,
                    initializer_range=0.1)


def _ek(**kw):
    ek = dict(block_size=8, max_batch=4, max_model_len=64,
              token_budget=16, device="cpu")
    ek.update(kw)
    return ek


# ----------------------------------------------------------------------
# virtual clock
# ----------------------------------------------------------------------
def test_virtual_clock_advances_and_rejects_negative():
    clk = VirtualClock()
    assert clk.now == 0.0
    assert clk() == 0.0
    clk.advance(1.5)
    clk.sleep(0.25)
    assert clk() == pytest.approx(1.75)
    with pytest.raises(ValueError):
        clk.advance(-0.1)


def test_deadlines_expire_in_virtual_time(model):
    clk = VirtualClock()
    eng = SimEngine(model, clock=clk, **_ek())
    rng = np.random.RandomState(0)
    rid = eng.add_request(rng.randint(0, 128, (40,)).astype(np.int32),
                          max_new_tokens=8, deadline_ms=50.0)
    clk.advance(0.2)
    outs = eng.step()
    assert [o.request_id for o in outs] == [rid]
    assert outs[0].finish_reason == FinishReason.DEADLINE
    assert any(e[1] == "deadline" for e in eng.events)


def test_watchdog_flags_wedges_on_the_virtual_clock():
    clk = VirtualClock()
    wd = StepWatchdog(0.5, clock=clk)
    t0 = wd.started()
    clk.advance(0.1)
    assert not wd.observe_since(0, "ragged", t0)
    t1 = wd.started()
    clk.advance(2.0)
    assert wd.observe_since(1, "ragged", t1)
    assert wd.num_wedged == 1
    assert wd.wedged[0][2] == pytest.approx(2.0)


def test_sim_engine_is_greedy_only_and_host_resident(model):
    eng = SimEngine(model, **_ek(device="cuda"))
    assert eng.device.type == "cpu"          # forced, whatever is asked
    assert eng.warmup().compile_ms == {}
    with pytest.raises(ValueError, match="greedy"):
        eng.add_request(np.arange(4, dtype=np.int32), temperature=0.7)
    with pytest.raises(ValueError, match="logits pipeline"):
        eng.add_request(np.arange(4, dtype=np.int32), logprobs=2)
    with pytest.raises(ValueError, match="virtual device"):
        SimEngine(model, tensor_parallel=2, **_ek())


def test_sim_pools_match_the_engine_layout(model):
    """The host pools have the real engine's layout and dtypes (f32,
    bf16 as int16 zero pages, int8 with scales) and start zeroed."""
    for kw in ({}, {"dtype": "bfloat16"}, {"quantize": "int8"}):
        sim, real = SimEngine(model, **_ek(**kw)), LLMEngine(model,
                                                             **_ek(**kw))
        for a, b in zip(sim._pools, real._pools):
            if b is None:
                assert a is None
                continue
            assert a.shape == b.shape and a.dtype == b.dtype
            assert not a.any()


def test_oracles_are_deterministic():
    class _Req:
        request_id = 7

    o1 = SyntheticOracle(avoid=(3,))
    o2 = SyntheticOracle(avoid=(3,))
    toks = [o1.next_token(_Req, p) for p in range(32)]
    assert toks == [o2.next_token(_Req, p) for p in range(32)]
    assert all(0 <= t < 128 and t != 3 for t in toks)
    ro = ReplayOracle({7: [10, 11, 12]})
    assert ro.next_token(_Req, 0) == 11
    assert ro.next_token(_Req, 1) == 12
    assert ro.next_token(_Req, 5) == 0


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------
def test_single_engine_calibration_is_decision_exact(model):
    trace = poisson_trace(24, 400.0, 8, seed=0)
    cal = calibrate(model, trace, engine_kwargs=_ek(num_blocks=24))
    assert cal["tokens_exact"]
    assert cal["decisions_exact"]
    assert cal["timing_err"] <= TIMING_BAND
    assert cal["events_real"] == cal["events_sim"] > 0
    assert cal["real"]["requests"] == cal["sim"]["requests"] == 24
    assert cal["step_time_model"]["profile"] == "h100"


def test_fleet_calibration_smoke_2_replicas_200_requests(model):
    trace = thousand_tenant_trace(200, 2000.0, 4, seed=1)
    cal = calibrate(model, trace, replicas=2,
                    engine_kwargs=_ek(max_batch=8, token_budget=64),
                    fleet_kwargs=dict(router_load_cap=2))
    assert cal["tokens_exact"]
    assert cal["decisions_exact"]
    assert cal["timing_err"] <= TIMING_BAND
    assert cal["real"]["requests"] == cal["sim"]["requests"] == 200
    assert cal["sim"]["wall_s"] < cal["real"]["wall_s"]


def test_calibration_through_a_migrating_drain(model):
    """The calibration legs by hand, through a drain that migrates
    running sequences: the simulated leg's page moves over its host
    pools make the real engines' decisions, record for record."""
    _arrivals, prompts, new = poisson_trace(8, 100.0, 10, seed=4)
    trace = (np.zeros(8), prompts, new)      # one burst: all running

    def leg(factory=None):
        clk = VirtualClock()
        fi = FaultInjector(schedule=[Fault("replica", "drain", step=3,
                                           victim=1)])
        kw = {} if factory is None else {"engine_factory": factory}
        fleet = Fleet(model, replicas=2, clock=clk, faults=fi,
                      migration="always", **kw, **_ek(max_batch=8))
        stm = cost.StepTimeModel.from_engine(fleet.replicas[0].engine)
        res = run_virtual(fleet, *trace, step_time_model=stm, clock=clk)
        logs = [to_records(fleet.events)] + \
            [to_records(r.engine.events) for r in fleet.replicas]
        return res, fleet, logs

    real, fleet, logs_real = leg()
    oracle = ReplayOracle.from_outputs(real["outputs"])
    sim, _, logs_sim = leg(sim_engine_factory(oracle))
    assert fleet.stats["migrated"] >= 1
    assert logs_sim == logs_real
    assert {o.request_id: tuple(o.output_ids) for o in sim["outputs"]} == \
        {o.request_id: tuple(o.output_ids) for o in real["outputs"]}
    assert sim["virtual_s"] == real["virtual_s"]


# ----------------------------------------------------------------------
# per-step gauges are event-log exact
# ----------------------------------------------------------------------
def test_step_gauges_match_the_event_log_exactly(model):
    clk = VirtualClock()
    eng = SimEngine(model, clock=clk, record_step_gauges=True,
                    **_ek(num_blocks=9, max_queue=3))
    rng = np.random.RandomState(2)
    for _ in range(10):
        eng.add_request(rng.randint(0, 128, (12,)).astype(np.int32),
                        max_new_tokens=14)
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
    gauges = eng.lifecycle_stats()["step_gauges"]
    assert len(gauges) == steps
    recs = to_records(eng.events)
    assert sum(1 for r in recs if r["kind"] == "shed") > 0
    assert any(r["kind"] == "preempt" for r in recs)
    for g in gauges:
        upto = [r for r in recs if r["step"] <= g["step"]]
        assert g["preemptions"] == sum(r["count"] for r in upto
                                       if r["kind"] == "preempt")
        assert g["shed"] == sum(1 for r in upto if r["kind"] == "shed")
        assert g["aborted"] == sum(1 for r in upto
                                   if r["kind"] == "abort")
        assert g["deadline_missed"] == sum(1 for r in upto
                                           if r["kind"] == "deadline")


# ----------------------------------------------------------------------
# policy experiments
# ----------------------------------------------------------------------
def _route_counts(target):
    counts = {}
    for r in to_records(target.events):
        if r["kind"] == "route":
            counts[r["replica"]] = counts.get(r["replica"], 0) + 1
    return counts


def test_load_capped_affinity_beats_herding_on_hot_tenant(model):
    trace = hot_tenant_trace(300, 20000.0, 12, seed=0)
    ek = _ek(token_budget=32)
    res_aff, t_aff = simulate(model, trace, replicas=4, engine_kwargs=ek)
    res_cap, t_cap = simulate(model, trace, replicas=4, engine_kwargs=ek,
                              fleet_kwargs=dict(router_load_cap=2))
    assert res_aff["requests"] == res_cap["requests"] == 300
    assert max(_route_counts(t_cap).values()) < \
        0.5 * max(_route_counts(t_aff).values())
    assert res_cap["ttft_ms"]["p95"] < 0.5 * res_aff["ttft_ms"]["p95"]
    assert res_cap["virtual_s"] < res_aff["virtual_s"]


def test_chaos_runs_are_deterministic_and_leak_free(model):
    trace = poisson_trace(40, 2000.0, 6, seed=3)

    def run():
        fi = FaultInjector(schedule=[
            Fault("replica", "drain", step=6, victim=1),
            Fault("replica", "kill", step=14, victim=2)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res, fleet = simulate(
                model, trace, replicas=3,
                engine_kwargs=_ek(max_batch=8, token_budget=64),
                fleet_kwargs=dict(faults=fi, migration="always"),
                invariants_every=4)
        logs = [to_records(fleet.events)] + \
            [to_records(r.engine.events) for r in fleet.replicas]
        return res, fleet, logs

    res1, fleet1, logs1 = run()
    res2, _, logs2 = run()
    assert logs1 == logs2
    kinds = {r["kind"] for lg in logs1 for r in lg}
    assert "dead" in kinds and "draining" in kinds
    assert {"export", "import"} & kinds or "reroute" in kinds
    assert res1["requests"] == res2["requests"] == 40
    for r in fleet1.replicas:
        if r.live:
            eng = r.engine
            assert eng.block_manager.num_free_blocks == eng.num_blocks


# ----------------------------------------------------------------------
# the port's simulator against the JAX package's
# ----------------------------------------------------------------------
# lifecycle_stats() values read off the wall clock: never compared
_WALL_KEYS = {"last_step_ms", "host_plan_s", "host_overhead_fraction"}


def _chaos_faults(fault, injector):
    return injector(schedule=[fault("replica", "drain", step=6, victim=1),
                              fault("replica", "kill", step=14, victim=2)])


# name -> (trace, replicas, engine kwargs, fleet kwargs(Fault, Injector))
_SIM_CASES = {
    "engine": (lambda: poisson_trace(24, 400.0, 8, seed=0), 0,
               dict(num_blocks=24), lambda f, i: {}),
    "hot_tenant": (lambda: hot_tenant_trace(60, 20000.0, 12, seed=0), 3,
                   dict(token_budget=32),
                   lambda f, i: dict(router_load_cap=2)),
    "chaos": (lambda: poisson_trace(40, 2000.0, 6, seed=3), 3,
              dict(max_batch=8, token_budget=64),
              lambda f, i: dict(faults=_chaos_faults(f, i),
                                migration="always")),
}


@pytest.mark.parametrize("case", sorted(_SIM_CASES))
def test_simulate_matches_the_jax_simulator(model, case):
    """One trace through the port's ``simulate`` and the JAX package's,
    each over its own SimEngines with the same SyntheticOracle and a
    StepTimeModel over the same per-bucket times: the fleet's and every
    engine's event records, outputs, virtual time, steps, launches, the
    latency summaries and ``lifecycle_stats()`` must be equal."""
    make_trace, replicas, ek, fleet_kw = _SIM_CASES[case]
    trace = make_trace()
    buckets = SimEngine(model, **_ek(**ek))._bucket_grid()
    times = {b: 1e-4 * (1.0 + 0.37 * b[1]) for b in buckets}
    profile = dict(cost.DEVICE_PROFILES["h100"])
    avoid = (0,)
    jm = jax_gpt_tiny(num_layers=2, initializer_range=0.1)
    assert {k: getattr(jm.config, k) for k in vars(model.config)} == \
        vars(model.config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pres, pt = simulate(
            model, trace, replicas=replicas,
            oracle=SyntheticOracle(128, avoid=avoid), engine_kwargs=_ek(**ek),
            fleet_kwargs=fleet_kw(Fault, FaultInjector),
            step_time_model=cost.StepTimeModel(times, profile, 2e-4),
            invariants_every=4)
        jek = {k: v for k, v in _ek(**ek).items() if k != "device"}
        jres, jt = jax_sim.simulate(
            jm, trace, replicas=replicas,
            oracle=jax_sim.SyntheticOracle(128, avoid=avoid),
            engine_kwargs=jek,
            fleet_kwargs=fleet_kw(JaxFault, JaxInjector),
            step_time_model=JaxStepTimeModel(times, profile, 2e-4),
            invariants_every=4)
    assert to_records(pt.events) == jax_records(jt.events)
    if replicas:
        assert len(pt.replicas) == len(jt.replicas) == replicas
        for pr, jr in zip(pt.replicas, jt.replicas):
            assert to_records(pr.engine.events) == \
                jax_records(jr.engine.events), f"replica {pr.index}"
        assert pt.stats == jt.stats
    assert [(o.request_id, o.finish_reason, list(o.all_ids))
            for o in pres["outputs"]] == \
        [(o.request_id, o.finish_reason, [int(t) for t in o.all_ids])
         for o in jres["outputs"]]
    for key in ("requests", "tokens", "steps", "launches", "virtual_s",
                "ttft_ms", "tpot_ms", "e2e_ms", "step_time_model"):
        assert pres[key] == jres[key], key
    pls, jls = pt.lifecycle_stats(), jt.lifecycle_stats()
    shared = (set(pls) & set(jls)) - _WALL_KEYS
    assert {"preemptions", "free_pages"} <= shared
    for key in sorted(shared):
        assert pls[key] == jls[key], key
    kinds = {r["kind"] for r in to_records(pt.events)}
    if case == "chaos":
        assert {"dead", "draining", "migrate"} <= kinds
    if case == "hot_tenant":
        assert max(_route_counts(pt).values()) < 60


def _function_text(src, node):
    """A top-level function's source without its docstring."""
    text = ast.get_source_segment(src, node)
    doc = node.body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value.value, str)
    return text.replace(ast.get_source_segment(src, doc), "")


# where simulator.py may differ from the JAX module: the module docstring,
# the imports, SimEngine (rewritten over the port's seams) and the two
# helpers the port adds for it; simulate and calibrate only in their
# docstrings and the default device profile
_SIM_PORT_ONLY = {"_SharedWeights", "_HOST_DTYPES"}
_SIM_DEFAULT_PROFILE = ('profile="tpu-v4"', 'profile="h100"')
_SHARED_WEIGHTS = (
    '        dtype = _DTYPES.get(kwargs.get("dtype"))\n'
    '        if dtype is not None:     # else the engine rejects the dtype\n'
    '            model = _SharedWeights(model, weights, dtype)\n')


def test_simulator_module_differs_only_where_the_port_forces():
    """The oracles, ``sim_engine_factory``'s call, the harness
    (``run_virtual`` and its helpers), ``simulate`` and ``calibrate``
    are the JAX module's text."""
    def top(mod):
        src = inspect.getsource(mod)
        body = ast.parse(src).body
        assert isinstance(body[0], ast.Expr)      # the module docstring
        nodes = {}
        for n in body[1:]:
            if not isinstance(n, (ast.Import, ast.ImportFrom)):
                name = getattr(n, "name", None) or ast.unparse(n.targets[0])
                nodes[name] = n
        return src, nodes

    jsrc, jnodes = top(jax_sim_mod)
    psrc, pnodes = top(port_sim_mod)
    assert [k for k in pnodes if k not in _SIM_PORT_ONLY] == list(jnodes)
    held = set()
    for name, jn in jnodes.items():
        pn = pnodes[name]
        if name == "SimEngine":
            continue
        if name in ("simulate", "calibrate"):
            jtext = _function_text(jsrc, jn)
            assert jtext.count(_SIM_DEFAULT_PROFILE[0]) == 1
            assert jtext.replace(*_SIM_DEFAULT_PROFILE) == \
                _function_text(psrc, pn), name
        elif name == "sim_engine_factory":
            # the factory hands every SimEngine the one weight cache
            assert _function_text(jsrc, jn).replace(
                "    def factory", "    weights = {}\n\n    def factory"
            ).replace("    def factory(model, **kwargs):\n",
                      "    def factory(model, **kwargs):\n"
                      + _SHARED_WEIGHTS) == _function_text(psrc, pn)
        else:
            assert ast.get_source_segment(jsrc, jn) == \
                ast.get_source_segment(psrc, pn), name
        held.add(name)
    assert {"SyntheticOracle", "ReplayOracle", "run_virtual", "simulate",
            "calibrate", "_engines", "_next_deadline", "_pct",
            "_check_invariants", "__all__"} <= held


def test_sim_fleet_replicas_share_one_host_copy_of_the_weights(model):
    """A simulated fleet's SimEngines hold the same weight tensors, made
    once in the engines' dtype; the memory model prices them as a real
    engine does."""
    for dtype in ("float32", "bfloat16"):
        fleet = Fleet(model, replicas=3, engine_factory=sim_engine_factory(),
                      **_ek(dtype=dtype))
        engines = [r.engine for r in fleet.replicas]
        for g, sub in engines[0].params.items():
            for k, w in sub.items():
                assert w.device.type == "cpu"
                assert w.dtype == getattr(torch, dtype)
                assert all(e.params[g][k].data_ptr() == w.data_ptr()
                           for e in engines[1:]), (g, k)
        real = LLMEngine(model, **_ek(dtype=dtype))
        assert cost.params_bytes(engines[0].params) == \
            cost.params_bytes(real.params)
        for g, sub in real.params.items():
            for k, w in sub.items():
                assert torch.equal(engines[0].params[g][k], w), (g, k)
    # a second model through the same factory gets weights of its own
    other = gpt_tiny(device="cpu", num_layers=2, seed=1)
    factory = sim_engine_factory()
    a, b = factory(model, **_ek()), factory(other, **_ek())
    assert not torch.equal(a.params["embed"]["word_embeddings.weight"],
                           b.params["embed"]["word_embeddings.weight"])


# ----------------------------------------------------------------------
# the step-time model
# ----------------------------------------------------------------------
def test_step_time_model_is_a_per_bucket_roofline(model):
    eng = LLMEngine(model, **_ek(token_budget=64))
    stm = cost.StepTimeModel.from_engine(eng)
    assert stm.profile == "h100"
    buckets = [tb for _k, tb in eng._bucket_grid()]
    assert buckets == [8, 16, 32, 64]
    times = [stm.step_seconds("ragged", tb) for tb in buckets]
    assert all(a < b for a, b in zip(times, times[1:]))
    # each estimate is the larger of the two roofline terms of the census
    # walker's count of that bucket's step graph
    prof = cost.DEVICE_PROFILES["h100"]
    for (_kind, tb, body, operands), t in zip(eng.executable_grid(),
                                               times):
        est = cost.estimate_fn(body, *operands)
        assert est.flops > 0 and est.hbm_bytes > 0
        assert t == max(est.flops / prof["flops_per_s"],
                        est.hbm_bytes / prof["hbm_bytes_per_s"])
    assert stm.launches_seconds([("ragged", 8), ("ragged", 64)]) == \
        times[0] + times[-1]
    with pytest.raises(KeyError, match="no step-time estimate"):
        stm.step_seconds("ragged", 128)
    assert stm.tier_seconds(0) == 0.0
    assert stm.tier_seconds(10**9) == 10**9 / prof["ici_bytes_per_s"]
    assert sorted(stm.to_dict()["times_s"]) == sorted(
        f"ragged[{tb}]" for tb in buckets)
    cpu = cost.StepTimeModel.from_engine(eng, profile="cpu",
                                         host_overhead_s=1e-4)
    assert cpu.step_seconds("ragged", 8) > times[0] + 1e-4


# ----------------------------------------------------------------------
# scale — slow tier
# ----------------------------------------------------------------------
@pytest.mark.slow
def test_hundred_replica_hundred_thousand_request_sweep(model):
    import time as _time

    trace = thousand_tenant_trace(100_000, 400_000.0, 4, seed=7)
    t0 = _time.perf_counter()
    res, fleet = simulate(
        model, trace, replicas=100,
        engine_kwargs=_ek(max_batch=8, token_budget=64),
        fleet_kwargs=dict(router_load_cap=2),
        latency=False, invariants_every=256)
    wall = _time.perf_counter() - t0
    assert res["requests"] == 100_000
    assert wall < 60.0, f"sweep took {wall:.1f}s"
    for r in fleet.replicas:
        assert r.engine.block_manager.num_free_blocks == \
            r.engine.num_blocks
    assert fleet.lifecycle_stats()["replicas_live"] == 100
