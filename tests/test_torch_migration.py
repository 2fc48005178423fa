"""KV-page migration in the port (``export_request`` / ``import_request``
/ ``release_request`` / ``adopt_waiting`` and the fleet's handoffs)
against the JAX package.

The bodies of ``tests/test_migration.py`` on ``gpt_tiny(num_layers=2)``
in f32 with seeded random weights carried to both packages as numpy
arrays: the copied BlockManager's export/import round trips; an engine
handing a RUNNING request to another mid-decode, token-exact against an
unmigrated engine, with the capacity, adapter, shape and scale guards
before any allocation and exact page reclamation after a mid-import
fault; the cost-model MigrationPolicy; drain and engine-alive failover
migrating instead of recomputing; disaggregated prefill/decode with
prefix caching and n-gram speculation; the Router's bounded warm map;
the abort-vs-failover race; and the migration fault site.  The fleet
scenarios run on the JAX fleet too, on the same prompts and fault
schedule, with ``fleet.events``, every replica's event records, the
outputs and ``lifecycle_stats()`` equal (the wall-clock gauges left
out).  Pages move by index ops on the in-place pools (never rebinding a
pool a captured graph reads), so the destination's pools keep their
addresses through an import.

Left out: ``test_disagg_bench_smoke`` (it drives ``benchmarks/``, which
waits for the benchmark slice).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm import to_records as jax_records
from paddle_tpu.inference.llm.faults import Fault as JaxFault
from paddle_tpu.inference.llm.faults import FaultInjector as JaxInjector
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    BlockManager,
    Fault,
    FaultInjector,
    FinishReason,
    Fleet,
    LLMEngine,
    MigrationError,
    MigrationPolicy,
    NoFreeBlocksError,
    Router,
    to_records,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
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
        seed=6)
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


def _jax_engine(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def _drive(fleet):
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


def _assert_no_leaks(fleet):
    for r in fleet.replicas:
        if r.live:
            assert r.engine.block_manager.num_free_blocks == \
                r.engine.num_blocks, f"replica {r.index} leaked pages"


def assert_fleets_agree(port, jax, pouts, jouts):
    """Fleet events, every replica's event records, token-exact outputs
    with equal finish reasons, lifecycle_stats() on the shared keys."""
    assert port.events == jax.events
    for pr, jr in zip(port.replicas, jax.replicas):
        assert to_records(pr.engine.events) == \
            jax_records(jr.engine.events), f"replica {pr.index}"
    assert sorted(pouts) == sorted(jouts)
    for rid, po in pouts.items():
        assert po.finish_reason == jouts[rid].finish_reason, rid
        np.testing.assert_array_equal(po.all_ids,
                                      np.asarray(jouts[rid].all_ids))
    pls, jls = port.lifecycle_stats(), jax.lifecycle_stats()
    for key in sorted((set(pls) & set(jls)) - _WALL_KEYS):
        assert pls[key] == jls[key], key
    assert port.stats == jax.stats
    assert len(port.migration_ms) == len(jax.migration_ms)


def _both(models, scenario, **kw):
    """``scenario(fleet, fault_cls, injector_cls) -> outputs`` on a port
    and a JAX fleet built alike; the two runs must agree."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pf = _fleet(models, **kw)
        pouts = scenario(pf, Fault, FaultInjector)
        jf = _jax_fleet(models, **kw)
        jouts = scenario(jf, JaxFault, JaxInjector)
    assert_fleets_agree(pf, jf, pouts, jouts)
    return pf, pouts


def _drain_at(step_at, index=1):
    """A scenario body: the prompts in, drain replica ``index`` after
    fleet step ``step_at``, run to completion."""
    def run(fleet, prompts, new):
        for p in prompts:
            fleet.add_request(p, max_new_tokens=new)
        outs, step = {}, 0
        while fleet.has_unfinished():
            for fo in fleet.step():
                outs[fo.request_id] = fo
            if step == step_at:
                fleet.drain_replica(index)
            fleet.check_invariants()
            step += 1
        return outs
    return run


# ---------------------------------------------------------------------------
class TestBlockManagerExportImport:
    def _pool(self, num_blocks=16, block_size=8):
        return BlockManager(num_blocks, block_size,
                            enable_prefix_caching=True)

    def _seed_seq(self, bm, seq_id, tokens):
        bm.allocate(seq_id, len(tokens))
        hashes = bm.prefix_chain_hashes(tokens)
        for i, h in enumerate(hashes[:len(tokens) // bm.block_size]):
            bm.register_full_block(seq_id, i, h)
        return hashes

    def test_round_trip_partially_full_tail(self):
        src, dst = self._pool(), self._pool()
        self._seed_seq(src, "s", list(range(20)))
        exp = src.export_seq("s")
        assert exp["num_tokens"] == 20
        assert exp["page_tokens"] == [8, 8, 4]
        assert exp["hashes"][2] is None and exp["hashes"][0] is not None
        table = dst.import_seq("s", exp)
        assert len(table) == 3 and dst.num_tokens("s") == 20
        dst.register_imported("s", exp["hashes"])
        src.check_invariants()
        dst.check_invariants()
        assert dst.match_prefix(exp["hashes"][:2]) == 2
        assert src.has_seq("s") and src.num_tokens("s") == 20

    def test_import_collapses_shared_refcounts(self):
        src, dst = self._pool(), self._pool()
        self._seed_seq(src, "a", list(range(16)))
        src.fork("a", "b")
        exp = src.export_seq("a")
        dst.import_seq("a", exp)
        dst.register_imported("a", exp["hashes"])
        dst.check_invariants()
        assert all(dst._ref[blk] == 1 for blk in dst.block_table("a"))
        dst.free("a")
        assert dst.num_free_blocks == dst.num_blocks

    def test_cow_forked_tail_round_trips(self):
        src, dst = self._pool(), self._pool()
        self._seed_seq(src, "p", list(range(12)))
        src.fork("p", "c")
        src.append_slot("c")
        exp = src.export_seq("c")
        assert exp["num_tokens"] == 13
        dst.import_seq("c", exp)
        dst.register_imported("c", exp["hashes"])
        src.check_invariants()
        dst.check_invariants()
        assert dst.num_tokens("c") == 13

    def test_corrupt_export_rejected(self):
        src, dst = self._pool(), self._pool()
        self._seed_seq(src, "s", list(range(20)))
        exp = src.export_seq("s")
        exp["block_ids"] = exp["block_ids"][:-1]
        before = dst.num_free_blocks
        with pytest.raises(ValueError, match="corrupt export"):
            dst.import_seq("s", exp)
        assert dst.num_free_blocks == before and not dst.has_seq("s")

    def test_import_all_or_nothing_on_exhausted_pool(self):
        src, dst = self._pool(), self._pool(num_blocks=2)
        self._seed_seq(src, "s", list(range(20)))
        exp = src.export_seq("s")
        with pytest.raises(NoFreeBlocksError):
            dst.import_seq("s", exp)
        assert dst.num_free_blocks == 2 and not dst.has_seq("s")
        dst.check_invariants()

    def test_invariants_and_growth_on_imported_pool(self):
        src, dst = self._pool(), self._pool()
        self._seed_seq(src, "s", list(range(20)))
        exp = src.export_seq("s")
        dst.import_seq("s", exp)
        dst.register_imported("s", exp["hashes"])
        for _ in range(8):
            dst.append_slot("s")
        dst.check_invariants()
        assert dst.num_tokens("s") == 28
        assert len(dst.block_table("s")) == 4
        dst.free("s")
        dst.check_invariants()
        assert dst.num_free_blocks == dst.num_blocks

    def test_export_unknown_seq_raises(self):
        with pytest.raises(KeyError, match="owns no pages"):
            self._pool().export_seq("ghost")


# ---------------------------------------------------------------------------
def _handoff(e0, e1, prompts, new, mover=1, steps=4):
    """Run ``prompts`` on ``e0``, move request ``mover`` to ``e1``
    mid-decode, finish both; returns {rid: output}."""
    rids = [e0.add_request(p, max_new_tokens=new) for p in prompts]
    outs = {}
    for _ in range(steps):
        for fo in e0.step():
            outs[fo.request_id] = fo
    rid = rids[mover]
    assert len(e0._requests[rid].output_ids) >= 1
    state = e0.export_request(rid)
    e1.import_request(state["request"], state["seq"], state["k_pages"],
                      state["v_pages"], k_scales=state.get("k_scales"),
                      v_scales=state.get("v_scales"))
    e0.release_request(rid)
    e0.scheduler.check_invariants()
    e1.scheduler.check_invariants()
    while e0.has_unfinished() or e1.has_unfinished():
        for fo in e0.step() + e1.step():
            outs[fo.request_id] = fo
    return outs


class TestEngineMigration:
    def test_export_import_resumes_token_exact(self, models):
        """A RUNNING request moved between two engines mid-decode: the
        merged outputs equal one unmigrated engine bitwise, the engines'
        event records equal the JAX engines' doing the same, and the
        destination's pools keep their addresses."""
        prompts = _prompts(n=3)
        want = _engine(models).generate(prompts, max_new_tokens=10)
        e0, e1 = _engine(models), _engine(models)
        ptrs = (e1._kc.data_ptr(), e1._vc.data_ptr())
        outs = _handoff(e0, e1, prompts, 10)
        for rid, w in enumerate(want):
            np.testing.assert_array_equal(outs[rid].all_ids, w)
        assert (e1._kc.data_ptr(), e1._vc.data_ptr()) == ptrs
        j0, j1 = _jax_engine(models), _jax_engine(models)
        jouts = _handoff(j0, j1, prompts, 10)
        for rid in outs:
            np.testing.assert_array_equal(outs[rid].all_ids,
                                          np.asarray(jouts[rid].all_ids))
        assert to_records(e0.events) == jax_records(j0.events)
        assert to_records(e1.events) == jax_records(j1.events)
        kinds = [r["kind"] for r in to_records(e0.events)]
        assert "export" in kinds and "release" in kinds
        assert "import" in [r["kind"] for r in to_records(e1.events)]

    def test_export_payload_matches_jax(self, models):
        """The exported chain and page payload equal the JAX engine's
        (f32 pages at 1e-5: the two steps' K/V differ in rounding)."""
        prompt = _prompts(n=1)[0]
        p, j = _engine(models), _jax_engine(models)
        for eng in (p, j):
            eng.add_request(prompt, max_new_tokens=8, request_id="r")
            for _ in range(3):
                eng.step()
        ps, js = p.export_request("r"), j.export_request("r")
        assert ps["seq"] == js["seq"]
        for key in ("k_pages", "v_pages"):
            assert ps[key].shape == np.asarray(js[key]).shape
            np.testing.assert_allclose(ps[key], np.asarray(js[key]),
                                       rtol=1e-5, atol=1e-5)

    def test_import_capacity_and_shape_guards(self, models):
        e0, e1 = _engine(models, max_batch=1), _engine(models, max_batch=1)
        r0 = e0.add_request(_prompts(n=1)[0], max_new_tokens=8,
                            request_id="mover")
        r1 = e1.add_request(_prompts(seed=1, n=1)[0], max_new_tokens=8,
                            request_id="homebody")
        for _ in range(3):
            e0.step()
            e1.step()
        state = e0.export_request(r0)
        before = e1.block_manager.num_free_blocks
        with pytest.raises(MigrationError) as ei:
            e1.import_request(state["request"], state["seq"],
                              state["k_pages"], state["v_pages"])
        assert ei.value.reason == "capacity"
        assert e1.block_manager.num_free_blocks == before
        assert r1 in e1._requests
        while e1.has_unfinished():
            e1.step()
        before = e1.block_manager.num_free_blocks
        with pytest.raises(ValueError, match="payload"):
            e1.import_request(state["request"], state["seq"],
                              state["k_pages"][:, :, :4],
                              state["v_pages"][:, :, :4])
        assert e1.block_manager.num_free_blocks == before
        with pytest.raises(ValueError, match="already live"):
            e0.import_request(state["request"], state["seq"],
                              state["k_pages"], state["v_pages"])

    def test_import_fault_reclaims_exactly(self, models):
        e0, e1 = _engine(models), _engine(models)
        rid = e0.add_request(_prompts(n=1)[0], max_new_tokens=8)
        for _ in range(3):
            e0.step()
        state = e0.export_request(rid)
        before = e1.block_manager.num_free_blocks
        kc_before = e1._kc.clone()

        def boom():
            raise RuntimeError("mid-import fault")

        with pytest.raises(RuntimeError, match="mid-import"):
            e1.import_request(state["request"], state["seq"],
                              state["k_pages"], state["v_pages"],
                              fault_hook=boom)
        assert e1.block_manager.num_free_blocks == before
        assert rid not in e1._requests
        assert not e1.block_manager.has_seq(rid)
        assert torch.equal(e1._kc, kc_before)
        e1.scheduler.check_invariants()
        assert e0.block_manager.has_seq(rid)
        while e0.has_unfinished():
            e0.step()
        e0.scheduler.check_invariants()

    def test_export_guards(self, models):
        eng = _engine(models)
        with pytest.raises(KeyError, match="unknown request"):
            eng.export_request("ghost")
        rid = eng.add_request(_prompts(n=1)[0], max_new_tokens=4)
        with pytest.raises(ValueError, match="only running"):
            eng.export_request(rid)
        while eng.has_unfinished():
            eng.step()

    def test_import_invalidates_a_staged_plan(self, models):
        """An import changes what the destination's next step runs: a
        lookahead plan staged there is dropped, and the outputs stay
        token-exact."""
        prompts = _prompts(n=3)
        want = _engine(models).generate(prompts, max_new_tokens=10)
        e0, e1 = _engine(models), _engine(models, lookahead=True)
        e1.add_request(prompts[0], max_new_tokens=10, request_id="x")
        for _ in range(3):
            e1.step()
        assert e1._staged is not None
        epoch = e1._plan_epoch
        e0.add_request(prompts[1], max_new_tokens=10, request_id="y")
        for _ in range(3):
            e0.step()
        state = e0.export_request("y")
        e1.import_request(state["request"], state["seq"],
                          state["k_pages"], state["v_pages"])
        e0.release_request("y")
        assert e1._plan_epoch > epoch
        outs = {}
        while e1.has_unfinished():
            for fo in e1.step():
                outs[fo.request_id] = fo
        np.testing.assert_array_equal(outs["x"].all_ids, want[0])
        np.testing.assert_array_equal(outs["y"].all_ids, want[1])
        assert e1.block_manager.num_free_blocks == e1.num_blocks


# ---------------------------------------------------------------------------
class TestMigrationPolicy:
    def test_validation_and_resolve(self):
        with pytest.raises(ValueError, match="mode"):
            MigrationPolicy(mode="sometimes")
        with pytest.raises(ValueError, match="profile"):
            MigrationPolicy(profile="tpu-v4")
        with pytest.raises(ValueError, match="link_gbps"):
            MigrationPolicy(link_gbps=0)
        with pytest.raises(TypeError, match="migration="):
            MigrationPolicy.resolve(7)
        assert MigrationPolicy.resolve(None).mode == "auto"
        assert MigrationPolicy.resolve(None).profile == "cpu"
        assert MigrationPolicy.resolve("never").mode == "never"
        assert MigrationPolicy.resolve(
            {"mode": "always", "link_gbps": 2.5}).link_gbps == 2.5
        p = MigrationPolicy()
        assert MigrationPolicy.resolve(p) is p

    def test_estimate_and_decide(self, models):
        """The estimate is the JAX one under the shared "cpu" profile;
        "h100" is accepted."""
        from paddle_tpu.inference.llm import MigrationPolicy as JaxPolicy

        eng, jeng = _engine(models), _jax_engine(models)
        prompt = np.arange(10, dtype=np.int32)
        for e in (eng, jeng):
            e.add_request(prompt, max_new_tokens=6, request_id="r")
            for _ in range(3):
                e.step()
        pol = MigrationPolicy()
        est = pol.estimate(eng, eng._requests["r"])
        jest = JaxPolicy().estimate(jeng, jeng._requests["r"])
        assert est["bytes_moved"] == jest["bytes_moved"] > 0
        assert est["recompute_flops"] == jest["recompute_flops"] > 0
        assert est["prefer"] == jest["prefer"] == "migrate"
        assert pol.decide(eng, eng._requests["r"]) == "migrate"
        assert MigrationPolicy(mode="never").decide(
            eng, eng._requests["r"]) == "recompute"
        assert MigrationPolicy(mode="always").decide(
            eng, eng._requests["r"]) == "migrate"
        h100 = MigrationPolicy(profile="h100").estimate(
            eng, eng._requests["r"])
        assert h100["bytes_moved"] == est["bytes_moved"]
        while eng.has_unfinished():
            eng.step()


# ---------------------------------------------------------------------------
class TestFleetMigration:
    def test_drain_migrates_running_token_exact(self, models):
        """Drain mid-decode: running sequences move to the peer (zero
        recompute), every output bitwise the single engine's, and the
        JAX fleet's run of the same drain agrees."""
        prompts = _prompts(n=6)
        want = _engine(models).generate(prompts, max_new_tokens=10)
        fleet, outs = _both(
            models, lambda f, *_: _drain_at(3)(f, prompts, 10))
        for rid, w in enumerate(want):
            np.testing.assert_array_equal(outs[rid].all_ids, w)
        assert fleet.stats["migrated"] >= 1
        assert fleet.stats["requeued"] == 0
        assert fleet.stats["migrated_bytes"] == sum(
            e[5] for e in fleet.events if e[1] == "migrate") \
            * fleet.replicas[0].engine.page_bytes
        assert fleet.replica_states()[1] == "drained"
        assert len(fleet.migration_ms) == fleet.stats["migrated"]
        _assert_no_leaks(fleet)

    def test_engine_alive_failover_migrates_without_recompute(self,
                                                              models):
        prompts = _prompts(n=4)
        want = _engine(models).generate(prompts, max_new_tokens=10)

        def scenario(fleet, fault, injector):
            fleet.faults = injector(schedule=[
                fault("replica", "heartbeat", step=s, victim=1)
                for s in range(6)])
            for p in prompts:
                fleet.add_request(p, max_new_tokens=10)
            return _drive(fleet)

        fleet, outs = _both(models, scenario)
        assert fleet.replica_states()[1] == "dead"
        migrated = {e[2] for e in fleet.events if e[1] == "migrate"}
        requeued = {e[2] for e in fleet.events if e[1] == "failover"}
        assert migrated and not migrated & requeued
        for rid, w in enumerate(want):
            np.testing.assert_array_equal(outs[rid].all_ids, w)
        _assert_no_leaks(fleet)

    def test_policy_never_falls_back_to_finish_in_place(self, models):
        fleet = _fleet(models, migration="never")
        outs = _drain_at(3)(fleet, _prompts(n=4), 8)
        assert fleet.stats["migrated"] == 0
        assert fleet.stats["migration_recomputed"] >= 1
        assert any(e[1] == "migrate_skip" for e in fleet.events)
        assert all(o.ok for o in outs.values())
        _assert_no_leaks(fleet)

    def test_lifecycle_stats_migration_counters(self, models):
        ls = _fleet(models).lifecycle_stats()
        for key in ("migrated", "migration_recomputed",
                    "migration_failed", "migrated_bytes"):
            assert ls[key] == 0


# ---------------------------------------------------------------------------
class TestDisaggregated:
    def test_token_exact_with_prefix_cache_and_spec(self, models):
        """Disaggregated serving is invisible to outputs — prefix-cache
        adoption on the prefill side and n-gram speculation on the
        decode side included — and makes the JAX fleet's decisions."""
        rng = np.random.RandomState(7)
        shared = rng.randint(0, 128, (16,)).astype(np.int32)
        pat = rng.randint(0, 128, (5,)).astype(np.int32)
        prompts = [np.concatenate([shared, np.tile(pat, 2),
                                   rng.randint(0, 128, (i + 2,))
                                   .astype(np.int32)])
                   for i in range(5)]
        want = _engine(models, speculative=2).generate(prompts,
                                                       max_new_tokens=10)

        def scenario(fleet, *_):
            assert fleet.roles() == {0: "prefill", 1: "decode"}
            for p in prompts:
                fleet.add_request(p, max_new_tokens=10)
            return _drive(fleet)

        fleet, outs = _both(models, scenario, disaggregate=True,
                            speculative=2)
        for rid, w in enumerate(want):
            np.testing.assert_array_equal(outs[rid].all_ids, w)
        assert fleet.stats["migrated"] == len(prompts)
        assert all(e[3] == 0 and e[4] == 1
                   for e in fleet.events if e[1] == "migrate")
        assert fleet.prefix_cache_stats()["prefix_hit_tokens"] > 0
        assert fleet.spec_stats()["draft_tokens"] > 0
        _assert_no_leaks(fleet)

    def test_degrades_to_unified_without_decode_replicas(self, models):
        fleet = _fleet(models, disaggregate=True)
        rids = [fleet.add_request(p, max_new_tokens=8)
                for p in _prompts(n=4)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.step()
            fleet.kill_replica(1)
            outs = _drive(fleet)
        assert all(outs[r].ok for r in rids)
        _assert_no_leaks(fleet)

    def test_validation(self, models):
        with pytest.raises(ValueError, match="disaggregate"):
            _fleet(models, replicas=1, disaggregate=True)


# ---------------------------------------------------------------------------
class TestRouterWarmLRU:
    def test_10k_request_trace_memory_bounded(self, models):
        fleet = _fleet(models)
        router, replica = fleet.router, fleet.replicas[0]
        for i in range(10_000):
            router.record(replica, (("t", i, 0), ("t", i, 1),
                                    ("t", i, 2)), hit=False)
        assert len(replica.warm_hashes) == router.warm_cap == 4096
        assert ("t", 9_999, 2) in replica.warm_hashes
        assert ("t", 0, 0) not in replica.warm_hashes
        survivor = next(iter(replica.warm_hashes))
        router.touch(replica, [survivor])
        router.record(replica, [("fresh", i) for i in range(4095)],
                      hit=False)
        assert survivor in replica.warm_hashes

    def test_warm_cap_validation(self):
        with pytest.raises(ValueError, match="warm_cap"):
            Router([], warm_cap=0)


# ---------------------------------------------------------------------------
class TestAbortFailoverRace:
    def test_abort_then_death_single_terminal_output(self, models):
        fleet = _fleet(models)
        rids = [fleet.add_request(p, max_new_tokens=10)
                for p in _prompts(n=4)]
        fleet.step()
        victim = next(rid for rid in rids
                      if fleet._live[rid].replica == 1)
        assert fleet.abort_request(victim) is True
        assert fleet.abort_request(victim) is False
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet.kill_replica(1)
            outs = []
            while fleet.has_unfinished():
                outs.extend(fleet.step())
        mine = [o for o in outs if o.request_id == victim]
        assert len(mine) == 1
        assert mine[0].finish_reason == FinishReason.ABORTED
        assert not any(e[1] in ("failover", "migrate") and e[2] == victim
                       for e in fleet.events)
        assert len([e for e in fleet.events
                    if e[1] == "finish" and e[2] == victim]) == 1
        assert all(o.ok for o in outs if o.request_id != victim)

    def test_abort_before_drain_not_rerouted(self, models):
        fleet = _fleet(models, max_batch=1)
        rids = [fleet.add_request(p, max_new_tokens=8)
                for p in _prompts(n=4)]
        fleet.step()
        waiting = {q.request_id
                   for q in fleet.replicas[1].engine.scheduler.waiting}
        victim = next(rid for rid in rids
                      if fleet._live[rid].replica == 1 and rid in waiting)
        fleet.abort_request(victim)
        fleet.drain_replica(1)
        assert not any(e[1] == "reroute" and e[2] == victim
                       for e in fleet.events)
        assert _drive(fleet)[victim].finish_reason == FinishReason.ABORTED


# ---------------------------------------------------------------------------
class TestMigrationFaults:
    def test_export_fault_falls_back(self, models):
        prompts = _prompts(n=6)
        want = _engine(models).generate(prompts, max_new_tokens=10)
        injectors = []

        def scenario(fleet, fault, injector):
            fleet.faults = injector(schedule=[
                fault("migration", "export", step=3)])
            injectors.append(fleet.faults)
            return _drain_at(3)(fleet, prompts, 10)

        fleet, outs = _both(models, scenario)
        assert fleet.stats["migration_failed"] == 1
        fails = [e for e in fleet.events if e[1] == "migrate_fail"]
        assert fails and fails[0][5] == "export"
        assert injectors[0].events == injectors[1].events == \
            [(3, "migration", "export", 0)]
        for rid, w in enumerate(want):
            np.testing.assert_array_equal(outs[rid].all_ids, w)
        _assert_no_leaks(fleet)

    def test_import_fault_exact_reclamation_both_pools(self, models):
        fi = FaultInjector(schedule=[Fault("migration", "import",
                                           step=3)])
        fleet = _fleet(models, faults=fi)
        rids = [fleet.add_request(p, max_new_tokens=10)
                for p in _prompts(n=4)]
        outs = {}
        for _ in range(4):
            for fo in fleet.step():
                outs[fo.request_id] = fo
        src = fleet.replicas[1].engine
        dst = fleet.replicas[0].engine
        src_before = src.block_manager.num_free_blocks
        dst_before = dst.block_manager.num_free_blocks
        pages_of = {rid: len(src.block_manager.block_table(rid))
                    for rid in src.block_manager._tables}
        fleet.drain_replica(1)
        fails = [e for e in fleet.events if e[1] == "migrate_fail"]
        moved = [e for e in fleet.events if e[1] == "migrate"]
        assert fleet.stats["migration_failed"] >= 1
        assert fails[0][5] == "import"
        faulted = fails[0][2]
        assert dst.block_manager.num_free_blocks == \
            dst_before - sum(e[5] for e in moved)
        assert src.block_manager.num_free_blocks == \
            src_before + sum(pages_of[e[2]] for e in moved)
        assert len(src.block_manager.block_table(faulted)) == \
            pages_of[faulted]
        assert not dst.block_manager.has_seq(faulted)
        fleet.check_invariants()
        outs.update(_drive(fleet))
        assert all(outs[r].ok for r in rids)
        _assert_no_leaks(fleet)

    def test_delay_fault_only_slows(self, models):
        fi = FaultInjector(schedule=[
            Fault("migration", "delay", step=3, delay_s=0.01)])
        fleet = _fleet(models, faults=fi)
        outs = _drain_at(3)(fleet, _prompts(n=4), 8)
        assert fleet.stats["migration_failed"] == 0
        if fleet.stats["migrated"]:
            assert max(fleet.migration_ms) >= 10.0
        assert all(o.ok for o in outs.values())

    def test_migration_site_validation(self):
        with pytest.raises(ValueError, match="migration"):
            FaultInjector(schedule=[Fault("migration", "bogus", step=0)])

    def test_random_fleet_migration_stream_is_independent(self):
        base = FaultInjector.random_fleet(
            95, steps=256, replicas=3, p_kill=0.02, p_heartbeat=0.06,
            p_drain=0.01)
        plus = FaultInjector.random_fleet(
            95, steps=256, replicas=3, p_kill=0.02, p_heartbeat=0.06,
            p_drain=0.01, p_migration=0.3)

        def pick(fi):
            return [(f.kind, f.step, f.victim) for f in fi.schedule
                    if f.site == "replica"]

        assert pick(base) == pick(plus)
        assert any(f.site == "migration" for f in plus.schedule)

    def test_seeded_migration_chaos_matches_jax(self, models):
        """A disaggregated 3-replica fleet under a seeded schedule of
        heartbeat misses, drains and migration faults: every pool
        balanced at every step, and fleet events, engine records and
        outputs equal to the JAX fleet's under the same seed."""
        prompts = _prompts(seed=11, n=8)
        injectors = []

        def scenario(fleet, fault, injector):
            fleet.faults = injector.random_fleet(
                29, steps=96, replicas=3, p_heartbeat=0.04,
                p_drain=0.01, p_migration=0.3)
            injectors.append(fleet.faults)
            outs, i = {}, 0
            while i < len(prompts) or fleet.has_unfinished():
                if i < len(prompts):
                    for p in prompts[i:i + 2]:
                        fleet.add_request(p, max_new_tokens=10)
                    i += 2
                for _ in range(4):
                    for fo in fleet.step():
                        outs[fo.request_id] = fo
                    fleet.check_invariants()
            return outs

        fleet, outs = _both(models, scenario, replicas=3,
                            disaggregate=True)
        assert injectors[0].events == injectors[1].events
        assert fleet.stats["migrated"] >= len(prompts) // 2
        assert fleet.stats["migration_failed"] >= 1
        assert fleet.stats["drains"] >= 1
        assert len(outs) == len(prompts)
