"""The port's replica fleet (``paddle_tpu_torch.inference.llm.Fleet``)
against the JAX package's.

The bodies of ``tests/test_fleet.py`` on ``gpt_tiny(num_layers=2)`` in f32
with seeded random weights carried to both packages as numpy arrays: the
prefix-affinity router keys on the prefix cache's own hashes, the health
state machine's hysteresis, token-exact failover, the rolling drain and
restart, fleet-level admission, and a seeded fleet-chaos schedule that
replays to identical logs with serial and thread-parallel stepping.
Beside them, the port's fleet against the JAX fleet on the same prompts
and fault schedule: ``fleet.events`` and every replica's
``to_records(engine.events)`` equal, outputs token-exact, and
``lifecycle_stats()`` equal on the keys both sides have (the wall-clock
gauges left out).  ``fleet.py`` is the JAX module but for four places,
held by ``test_fleet_module_differs_only_where_the_port_forces``.

Where the port differs: a replica owns its step graphs (a captured graph
reads its own pools by address), so the JAX
``test_replicas_share_one_executable_set`` becomes
``test_replicas_own_distinct_pools``; a replica is warmed as it is
built, ``warmup()`` returns one timing dict a replica, and a dead
replica's engine is collected before its restart.  Left out: the bench
smoke (``benchmarks/`` waits for the benchmark slice) and
``TestFleetServing`` (``PredictorServer`` comes with the long tail).
"""

import ast
import gc
import inspect
import warnings
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import fleet as jax_fleet_mod
from paddle_tpu.inference.llm import to_records as jax_records
from paddle_tpu.inference.llm.block_manager import (
    prefix_block_hashes as jax_prefix_block_hashes,
)
from paddle_tpu.inference.llm.faults import Fault as JaxFault
from paddle_tpu.inference.llm.faults import FaultInjector as JaxInjector
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    BlockManager,
    Fault,
    FaultInjector,
    FinishReason,
    Fleet,
    HealthConfig,
    InterleavingScheduler,
    LLMEngine,
    PoolLostError,
    prefix_block_hashes,
    to_records,
)
from paddle_tpu_torch.inference.llm import fleet as port_fleet_mod
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
# lifecycle_stats() values read off the wall clock: never compared
_WALL_KEYS = {"last_step_ms", "host_plan_s", "host_overhead_fraction"}


def _randomized(params, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for g, sub in params.items():
        out[g] = {}
        for k, v in sub.items():
            noise = rng.randn(*np.shape(v)).astype(np.float32)
            if k.startswith("ln_") or g == "head":
                val = (1.0 if k.endswith("weight") else 0.0) + 0.1 * noise
            elif k.endswith("bias"):
                val = 0.05 * noise
            else:
                val = 0.1 * noise
            out[g][k] = val.astype(np.float32)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the tiny CPU steps gain nothing from more, and
    idle intra-op threads spinning beside other test processes slow the
    JAX compiles several-fold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with the same seeded f32 weights."""
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    params = _randomized(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in jm.functional_decompose()["params"].items()},
        seed=5)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.load_stacked(params)
    return jm, pm


def _fleet(models, replicas=2, **kw):
    return Fleet(models[1], replicas=replicas, device="cpu",
                 **{**ENGINE, **kw})


def _jax_fleet(models, replicas=2, **kw):
    return JaxFleet(models[0], replicas=replicas, **{**ENGINE, **kw})


def _engine(models, **kw):
    return LLMEngine(models[1], device="cpu", **{**ENGINE, **kw})


def _drive(fleet):
    """Step a fleet to completion (invariants checked every step);
    returns {rid: RequestOutput}."""
    outs = {}
    while fleet.has_unfinished():
        for fo in fleet.step():
            outs[fo.request_id] = fo
        fleet.check_invariants()
    return outs


def _prompts(seed=0, n=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (int(rng.randint(4, 14)),))
            .astype(np.int32) for _ in range(n)]


def _reference(models, prompts, new):
    """{index: all_ids} of a fault-free single port engine."""
    return dict(enumerate(_engine(models).generate(prompts,
                                                   max_new_tokens=new)))


def assert_fleets_agree(port, jax, pouts, jouts):
    """The comparison standard: fleet events, every replica's event
    records, token-exact outputs with equal finish reasons, and
    lifecycle_stats() on the shared keys."""
    assert port.events == jax.events
    assert len(port.replicas) == len(jax.replicas)
    for pr, jr in zip(port.replicas, jax.replicas):
        assert to_records(pr.engine.events) == \
            jax_records(jr.engine.events), f"replica {pr.index}"
    assert sorted(pouts) == sorted(jouts)
    for rid, po in pouts.items():
        jo = jouts[rid]
        assert po.finish_reason == jo.finish_reason, rid
        np.testing.assert_array_equal(po.all_ids, np.asarray(jo.all_ids))
    pls, jls = port.lifecycle_stats(), jax.lifecycle_stats()
    shared = (set(pls) & set(jls)) - _WALL_KEYS
    assert {"migrated", "requeued", "killed", "preemptions"} <= shared
    for key in sorted(shared):
        assert pls[key] == jls[key], key
    assert port.stats == jax.stats


def _both(models, scenario, **kw):
    """Run ``scenario(fleet, fault_cls, injector_cls) -> outputs`` on a
    port fleet and on a JAX fleet built alike (``kw``), and hold the two
    runs equal."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pf = _fleet(models, **kw)
        pouts = scenario(pf, Fault, FaultInjector)
        jf = _jax_fleet(models, **kw)
        jouts = scenario(jf, JaxFault, JaxInjector)
    assert_fleets_agree(pf, jf, pouts, jouts)
    return pf, pouts


# ---------------------------------------------------------------------------
class TestRouterAffinity:
    def test_affinity_keys_equal_registered_cache_hashes(self, models):
        """The router keys prefix affinity on exactly the content hashes
        the cache registers pages under — and the JAX package's."""
        fleet = _fleet(models)
        prompt = list(range(20))           # 2 full pages + a tail
        keys = fleet.router.affinity_keys(prompt)
        bm = fleet.replicas[0].engine.block_manager
        assert keys == bm.prefix_chain_hashes(prompt, limit=2)
        assert keys == prefix_block_hashes(prompt, 8, limit=2)
        assert keys == jax_prefix_block_hashes(prompt, 8, limit=2)
        assert len(keys) == 2
        eng = _engine(models)
        eng.add_request(prompt, max_new_tokens=4)
        while eng.has_unfinished():
            eng.step()
        assert eng.block_manager.match_prefix(keys) == len(keys)

    def test_prefix_chain_hashes_respects_limit_and_page_size(self):
        bm = BlockManager(num_blocks=8, block_size=4)
        toks = list(range(13))             # 3 full pages + 1 token
        assert len(bm.prefix_chain_hashes(toks)) == 3
        assert bm.prefix_chain_hashes(toks, limit=1) == \
            bm.prefix_chain_hashes(toks)[:1]
        assert bm.prefix_chain_hashes(toks[:3]) == []

    def test_same_prefix_traffic_routes_to_the_warm_replica(self, models):
        fleet = _fleet(models, replicas=3)
        rng = np.random.RandomState(1)
        prefix = rng.randint(0, 128, (16,)).astype(np.int32)

        def mk():
            return np.concatenate(
                [prefix, rng.randint(0, 128, (5,)).astype(np.int32)])

        r0 = fleet.add_request(mk(), max_new_tokens=2)
        r1 = fleet.add_request(mk(), max_new_tokens=2)
        r2 = fleet.add_request(mk(), max_new_tokens=2)
        routes = {e[2]: (e[3], e[4]) for e in fleet.events
                  if e[1] == "route"}
        assert routes[r0][1] == 0
        assert routes[r1] == (routes[r0][0], 2)
        assert routes[r2] == (routes[r0][0], 2)
        assert fleet.router.affinity_hits == 2
        _drive(fleet)

    def test_cold_traffic_falls_back_least_loaded(self, models):
        fleet = _fleet(models, replicas=2)
        rids = [fleet.add_request(p, max_new_tokens=2)
                for p in _prompts(n=4)]
        routes = [e[3] for e in fleet.events if e[1] == "route"]
        assert routes == [0, 1, 0, 1]
        outs = _drive(fleet)
        assert all(outs[r].ok for r in rids)


# ---------------------------------------------------------------------------
class TestHealthChecker:
    def test_one_missed_heartbeat_never_flaps(self, models):
        fi = FaultInjector(schedule=[
            Fault("replica", "heartbeat", step=1, victim=1)])
        fleet = _fleet(models, faults=fi)
        for p in _prompts(n=2):
            fleet.add_request(p, max_new_tokens=6)
        _drive(fleet)
        assert fleet.replica_states() == {0: "healthy", 1: "healthy"}
        assert not any(e[1] in ("degraded", "dead")
                       for e in fleet.events)

    def test_sustained_misses_degrade_then_recover(self, models):
        fi = FaultInjector(schedule=[
            Fault("replica", "heartbeat", step=s, victim=1)
            for s in (1, 2)])
        fleet = _fleet(models, faults=fi)
        for p in _prompts(n=2):
            fleet.add_request(p, max_new_tokens=8)
        _drive(fleet)
        kinds = [e[1] for e in fleet.events
                 if e[1] in ("degraded", "recovered", "dead")]
        assert kinds == ["degraded", "recovered"]
        assert fleet.replica_states()[1] == "healthy"

    def test_dead_after_misses_kills_and_fails_over(self, models):
        """Heartbeat death is engine-alive: running sequences migrate,
        never-admitted ones replay — the same decisions as the JAX
        fleet, step for step."""
        prompts = _prompts(n=4)

        def scenario(fleet, fault, injector):
            fleet.faults = injector(schedule=[
                fault("replica", "heartbeat", step=s, victim=1)
                for s in range(4)])
            rids = [fleet.add_request(p, max_new_tokens=10)
                    for p in prompts]
            outs = _drive(fleet)
            assert [outs[r].ok for r in rids] == [True] * 4
            return outs

        fleet, _ = _both(models, scenario)
        assert fleet.replica_states()[1] == "dead"
        assert fleet.stats["migrated"] >= 1
        kinds = [e[1] for e in fleet.events
                 if e[1] in ("degraded", "dead")]
        assert kinds == ["degraded", "dead"]

    def test_health_config_validation(self):
        with pytest.raises(ValueError, match="degraded_after"):
            HealthConfig(degraded_after=3, dead_after=3)
        with pytest.raises(ValueError, match="recover_after"):
            HealthConfig(recover_after=0)
        with pytest.raises(TypeError, match="health="):
            HealthConfig.resolve(7)
        assert HealthConfig.resolve({"dead_after": 9}).dead_after == 9


# ---------------------------------------------------------------------------
class TestFailover:
    def test_kill_mid_flight_is_token_exact(self, models):
        """Kill a replica while its requests are mid-decode: the
        survivors' replays equal a fault-free single port engine
        bitwise, and the JAX fleet's run of the same schedule."""
        prompts = _prompts(n=6)
        want = _reference(models, prompts, 8)

        def scenario(fleet, fault, injector):
            rids = [fleet.add_request(p, max_new_tokens=8)
                    for p in prompts]
            for _ in range(3):
                fleet.step()               # mid-generation
            assert fleet.kill_replica(1) is True
            outs = _drive(fleet)
            assert fleet.kill_replica(1) is False
            assert rids == list(range(6))
            return outs

        fleet, outs = _both(models, scenario)
        assert fleet.stats["requeued"] > 0
        for i, w in want.items():
            assert outs[i].ok
            np.testing.assert_array_equal(outs[i].all_ids, w)
        surv = fleet.replicas[0].engine
        assert surv.block_manager.num_free_blocks == surv.num_blocks

    def test_no_survivors_finishes_requests_with_error(self, models):
        fleet = _fleet(models)
        rids = [fleet.add_request(p, max_new_tokens=10)
                for p in _prompts(n=3)]
        fleet.step()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.kill_replica(0)
            fleet.kill_replica(1)
        outs = _drive(fleet)
        assert {outs[r].finish_reason for r in rids} == \
            {FinishReason.ERROR}
        assert fleet.stats["lost"] == 3
        rid = fleet.add_request([1, 2, 3])
        out = {o.request_id: o for o in fleet.step()}[rid]
        assert out.finish_reason == FinishReason.SHED

    def test_step_exception_kills_only_the_raising_replica(self, models):
        """An engine whose step raises — here a launch that fails after
        writing the pools in place, so the engine raises PoolLostError —
        dies at once; its peer keeps serving and its requests replay
        there, token-exactly."""
        prompts = _prompts(n=4)
        want = _reference(models, prompts, 8)
        fleet = _fleet(models)
        rids = [fleet.add_request(p, max_new_tokens=8) for p in prompts]
        fleet.step()                       # both replicas mid-flight
        eng = fleet.replicas[1].engine

        def lost_pools(pk):
            eng._writes_began = True
            raise RuntimeError("device step failed mid-write")

        eng._ragged_fn = lost_pools
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = _drive(fleet)
        assert fleet.replica_states() == {0: "healthy", 1: "dead"}
        assert any(e[1] == "dead" and e[3] == PoolLostError.__name__
                   for e in fleet.events)
        assert fleet.stats["requeued"] >= 1
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(outs[rid].all_ids, want[i])


# ---------------------------------------------------------------------------
class TestRollingDrain:
    def test_drain_reroutes_waiting_and_parks_drained(self, models):
        fleet = _fleet(models, max_batch=1)
        rids = [fleet.add_request(p, max_new_tokens=6)
                for p in _prompts(n=6)]
        fleet.step()                       # one running per replica
        assert fleet.drain_replica(1) is True
        assert fleet.replica_states()[1] == "draining"
        rerouted = [e for e in fleet.events if e[1] == "reroute"]
        assert rerouted and all(e[3] == 1 and e[4] == 0
                                for e in rerouted)
        outs = _drive(fleet)
        assert all(outs[r].ok for r in rids)
        assert fleet.replica_states()[1] == "drained"
        for r in fleet.replicas:
            assert r.engine.block_manager.num_free_blocks == \
                r.engine.num_blocks
        assert fleet.drain_replica(1) is False

    def test_restart_after_drain_and_after_death(self, models):
        """A drained replica restarts with its engine; a dead one with a
        fresh engine of its own, built after the dead one was collected
        (its pools and graphs are released before the new ones exist),
        warmed, and serving token-exactly with nothing captured after
        the fleet's warmup."""
        fleet = _fleet(models)
        timings = fleet.warmup()
        assert sorted(timings) == [0, 1]
        fleet.drain_replica(1)
        fleet.step()                       # empty -> drained at once
        kept = fleet.replicas[1].engine
        fleet.restart_replica(1)
        assert fleet.replicas[1].engine is kept
        assert fleet.replica_states()[1] == "healthy"
        dead = weakref.ref(kept)
        built = []
        real_build = fleet._build_engine

        def build(index):
            gc.collect()
            built.append(dead() is None)   # the dead engine is gone
            return real_build(index)

        fleet._build_engine = build
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.kill_replica(1)
            del kept
            fleet.restart_replica(1)
        assert built == [True]
        assert dead() is None
        assert sorted(fleet.warmup()[1]) == ["ragged[16]", "ragged[8]"]
        assert fleet.replica_states()[1] == "healthy"
        fresh = fleet.replicas[1].engine
        assert fresh._kc.data_ptr() != \
            fleet.replicas[0].engine._kc.data_ptr()
        captures = [r.engine._graphs.captures for r in fleet.replicas]
        prompt = [1, 2, 3, 4]
        rid = fleet.add_request(prompt, max_new_tokens=4)
        outs = _drive(fleet)
        np.testing.assert_array_equal(
            outs[rid].all_ids, _reference(models, [prompt], 4)[0])
        assert [r.engine._graphs.captures
                for r in fleet.replicas] == captures
        assert fleet.stats["restarts"] == 2
        with pytest.raises(RuntimeError, match="only drained or dead"):
            fleet.restart_replica(0)

    def test_replicas_own_distinct_pools(self, models):
        """Each replica owns its pools and its step graphs (a captured
        graph reads its own pools by address), and warmup() returns one
        entry a replica, each over the engine's token buckets."""
        fleet = _fleet(models, replicas=3)
        engines = [r.engine for r in fleet.replicas]
        assert len({id(e._graphs) for e in engines}) == 3
        assert len({e._kc.data_ptr() for e in engines}) == 3
        assert len({e._vc.data_ptr() for e in engines}) == 3
        timings = fleet.warmup()
        assert sorted(timings) == [0, 1, 2]
        for t in timings.values():
            assert sorted(t) == ["ragged[16]", "ragged[8]"]
        for p in _prompts(n=4):
            fleet.add_request(p, max_new_tokens=4)
        _drive(fleet)
        assert all(e._graphs.captures == 0 for e in engines)


# ---------------------------------------------------------------------------
class TestFleetAdmission:
    def test_max_queue_sheds_at_the_fleet_gate(self, models):
        fleet = _fleet(models, max_queue=2)
        rids = [fleet.add_request([1, 2, i], max_new_tokens=2)
                for i in range(4)]
        outs = _drive(fleet)
        reasons = [outs[r].finish_reason for r in rids]
        assert reasons[:2] == ["length", "length"]
        assert reasons[2:] == [FinishReason.SHED, FinishReason.SHED]
        assert fleet.stats["shed"] == 2
        assert fleet.lifecycle_stats()["shed"] == 2

    def test_fleet_drain_quiesces_and_reopens(self, models):
        fleet = _fleet(models)
        rids = [fleet.add_request(p, max_new_tokens=4)
                for p in _prompts(n=3)]
        outs = {o.request_id: o for o in fleet.drain()}
        assert all(outs[r].ok for r in rids)
        assert not fleet.has_unfinished()
        rid = fleet.add_request([5, 6, 7], max_new_tokens=3)
        assert _drive(fleet)[rid].ok

    def test_validation(self, models):
        with pytest.raises(ValueError, match="replicas"):
            Fleet(models[1], replicas=0, device="cpu")
        with pytest.raises(ValueError, match="max_queue"):
            _fleet(models, max_queue=0)
        with pytest.raises(ValueError, match="engine_faults"):
            _fleet(models, engine_faults=[None])


# ---------------------------------------------------------------------------
class _InterleavedFleet(Fleet):
    """A fleet whose replicas step as actors of a seeded
    InterleavingScheduler: at every interleave point inside the engines'
    steps the seed picks which replica runs on, an adversarial
    interleaving of the replica threads ``parallel_step`` starts (the
    threads the harness can adopt must end at a point; the fleet's own
    stepping threads do not)."""

    seed = 0

    def _step_replicas(self, live):
        results = {}

        def one(r):
            try:
                results[r.index] = ("ok", r.engine.step())
            except Exception as e:  # noqa: BLE001 — replica isolation
                results[r.index] = ("err", e)

        sched = InterleavingScheduler(seed=self.seed * 1000
                                      + self._step_index)
        for r in live:
            sched.spawn(f"replica-{r.index}", lambda r=r: one(r))
        sched.run()
        return results


class TestFleetDeterminism:
    def _run(self, models, seed, parallel, fleet_cls=None,
             package="port"):
        if package == "port":
            fi = FaultInjector.random_fleet(
                seed, steps=64, replicas=2, p_kill=0.03, p_heartbeat=0.1)
            cls = fleet_cls or Fleet
            fleet = cls(models[1], replicas=2, faults=fi,
                        parallel_step=parallel, device="cpu", **ENGINE)
        else:
            fi = JaxInjector.random_fleet(
                seed, steps=64, replicas=2, p_kill=0.03, p_heartbeat=0.1)
            fleet = _jax_fleet(models, faults=fi, parallel_step=parallel)
        outs = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for p in _prompts(seed=3, n=5):
                fleet.add_request(p, max_new_tokens=6)
                outs.update({o.request_id: o for o in fleet.step()})
            outs.update(_drive(fleet))
        return fleet, fi, outs

    def test_seed_replay_identical_logs_serial_and_parallel(self, models):
        fa, ia, oa = self._run(models, seed=5, parallel=False)
        fb, ib, ob = self._run(models, seed=5, parallel=False)
        fp, ip, op = self._run(models, seed=5, parallel=True)
        assert ia.events == ib.events == ip.events
        assert fa.events == fb.events == fp.events
        assert {r: o.finish_reason for r, o in oa.items()} == \
               {r: o.finish_reason for r, o in ob.items()} == \
               {r: o.finish_reason for r, o in op.items()}
        for rid, o in oa.items():
            np.testing.assert_array_equal(o.all_ids, op[rid].all_ids)
        # the JAX fleet on the same seed makes the same decisions
        fj, ij, oj = self._run(models, seed=5, parallel=False,
                               package="jax")
        assert ij.events == ia.events
        assert_fleets_agree(fa, fj, oa, oj)

    @pytest.mark.parametrize("seed", [1, 2])
    def test_interleaved_replica_steps_match_serial(self, models, seed):
        """Replica steps interleaved at every engine interleave point, in
        a seeded adversarial order, produce the serial run's fleet and
        engine logs and outputs; the schedule replays from its seed."""
        fs, _, os_ = self._run(models, seed=5, parallel=False)
        logs = []
        for _ in range(2):
            _InterleavedFleet.seed = seed
            fi, _, oi = self._run(models, seed=5, parallel=False,
                                  fleet_cls=_InterleavedFleet)
            assert fi.events == fs.events
            for a, b in zip(fi.replicas, fs.replicas):
                assert to_records(a.engine.events) == \
                    to_records(b.engine.events)
            for rid, o in os_.items():
                np.testing.assert_array_equal(o.all_ids,
                                              oi[rid].all_ids)
            logs.append(fi.events)
        assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
@pytest.mark.slow
class TestFleetChaosSoak:
    """3 replicas, 256-step seeded chaos schedule: survivors token-exact
    vs a fault-free single engine, zero leaked pages on live replicas,
    nothing captured after warmup, and the seed replays to identical
    fleet and injector logs."""

    SEED = 95         # kill(step 10, victim 0), drain(step 19, victim 2)

    def _workload(self, seed=11, n=16):
        rng = np.random.RandomState(seed)
        return [rng.randint(0, 128, (int(rng.randint(4, 14)),))
                .astype(np.int32) for _ in range(n)]

    def _chaos(self, models, prompts):
        fi = FaultInjector.random_fleet(
            self.SEED, steps=256, replicas=3, p_kill=0.02,
            p_heartbeat=0.06, p_drain=0.01)
        fleet = _fleet(models, replicas=3, faults=fi)
        fleet.warmup()
        outs = {}
        rids = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            i = 0
            while i < len(prompts) or fleet.has_unfinished():
                if i < len(prompts):
                    for p in prompts[i:i + 2]:
                        rids.append(
                            fleet.add_request(p, max_new_tokens=10))
                    i += 2
                for _ in range(4):
                    for fo in fleet.step():
                        outs[fo.request_id] = fo
                    fleet.check_invariants()
        assert all(r.engine._graphs.captures == 0
                   for r in fleet.replicas)
        return fleet, fi, rids, outs

    def test_soak(self, models):
        prompts = self._workload()
        want = _reference(models, prompts, 10)
        fleet, fi, rids, outs = self._chaos(models, prompts)
        assert fleet.stats["killed"] >= 1
        assert fleet.stats["requeued"] >= 1
        assert fleet.stats["drains"] >= 1
        assert len(outs) == len(prompts)
        assert any(outs[r].ok for r in rids)
        for i, rid in enumerate(rids):
            if outs[rid].ok:
                np.testing.assert_array_equal(outs[rid].all_ids, want[i])
        for r in fleet.replicas:
            if r.live:
                assert r.engine.block_manager.num_free_blocks == \
                    r.engine.num_blocks
        fleet_b, fi_b, _, outs_b = self._chaos(models, prompts)
        assert fi.events == fi_b.events
        assert fleet.events == fleet_b.events
        assert {r: o.finish_reason for r, o in outs.items()} == \
               {r: o.finish_reason for r, o in outs_b.items()}


# ---------------------------------------------------------------------------
# where fleet.py may differ from the JAX module: the module docstring, the
# engine seam and what comes of it
_PORTED_METHODS = {"_build_engine", "warmup", "restart_replica"}
# the JAX __init__'s shared-executable slot, which becomes the port's
# record of each replica's warmup timings (taken as it is built)
_JAX_ONLY_LINE = "self._shared_fns = None"
_PORT_ONLY_LINE = "self._warmup_ms = {}"


def _top_level(mod):
    src = inspect.getsource(mod)
    body = ast.parse(src).body
    assert isinstance(body[0], ast.Expr)          # the module docstring
    return src, body[1:]


def test_fleet_module_differs_only_where_the_port_forces():
    """fleet.py is the JAX module but for the module docstring,
    ``_build_engine``, ``warmup``, ``restart_replica`` and the
    shared-executable line of ``__init__``, which becomes the record of
    the replicas' warmup timings."""
    jsrc, jbody = _top_level(jax_fleet_mod)
    psrc, pbody = _top_level(port_fleet_mod)
    assert jsrc[:jsrc.index('"""')] == psrc[:psrc.index('"""')]
    assert [type(n) for n in jbody] == [type(n) for n in pbody]
    for jn, pn in zip(jbody, pbody):
        if not (isinstance(jn, ast.ClassDef) and jn.name == "Fleet"):
            assert ast.get_source_segment(jsrc, jn) == \
                ast.get_source_segment(psrc, pn)
            continue
        assert [getattr(n, "name", None) for n in jn.body] == \
            [getattr(n, "name", None) for n in pn.body]
        for a, b in zip(jn.body, pn.body):
            name = getattr(a, "name", None)
            if name in _PORTED_METHODS:
                continue
            ja = ast.get_source_segment(jsrc, a).splitlines()
            pb = ast.get_source_segment(psrc, b).splitlines()
            if name == "__init__":
                assert [ln.strip() for ln in ja].count(_JAX_ONLY_LINE) == 1
                ja = [ln.replace(_JAX_ONLY_LINE, _PORT_ONLY_LINE)
                      for ln in ja]
            assert ja == pb, name
