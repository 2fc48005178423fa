"""The port's host-RAM KV tier (``LLMEngine(kv_tier=)``) against the JAX
package's.

The bodies of ``tests/test_kv_tier.py`` on ``gpt_tiny(num_layers=2)`` in
f32 with seeded random weights carried to both packages as numpy arrays:
the copied ``kv_tier.py`` (policy and config sugar, the host pool's and
the prefix store's books); an HBM-starved engine (``num_blocks=12``,
``policy="always"``) producing bitwise the outputs of an unconstrained
one while chains demote and swap back in, with ``check_invariants()``
after every step; full pages evicted from the prefix cache promoted into
the store and adopted back; the tier faults falling back exactly; the
host tier in the memory model.  Beside them, the port against the JAX
engine on the same starved schedule: outputs, ``tier_stats()`` and the
event records (demote, swap_in, promote, store_adopt among them) equal,
the demoted payloads allclose in f32 and equal in layout, in f32 and
with the int8 pool (scale pages moving with the pages), and under the
seeded tier-fault schedules; ``migration_estimate`` equal to the JAX
one under the shared ``"cpu"`` profile.

The fleet side (``TestFleetTier``): replicas share one host pool and
one prefix store, store residency scores for every replica, and a drain
whose peer has no free pages demotes the running chain into the shared
pool for the peer to swap in — token-exact, and with the JAX fleet's
events and records.  The simulator over the tier (``TestSimTier``):
calibration decision-exact with the tier on, and the virtual clock
charging tier traffic.

Left out, with the item that brings them: the census cases (A22) and
the bench smoke (A8).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import cost as jax_cost
from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm.faults import FaultInjector as JaxInjector
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.framework import cost
from paddle_tpu_torch.inference.llm import (
    Fault,
    FaultInjector,
    Fleet,
    LLMEngine,
    MigrationError,
    assert_wall_clock_free,
    to_records,
)
from paddle_tpu_torch.inference.llm.kv_tier import (
    HostPagePool,
    KVTierConfig,
    PrefixStore,
    TierPolicy,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
_PROMPTS = [list(range(3, 19)), list(range(5, 21)), list(range(7, 23))]
_TIER = {"host_bytes": "8MiB", "store_bytes": "8MiB",
         "policy": "always"}


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
        seed=9)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.load_stacked(params)
    return jm, pm


def _tiny_engine(models, **kw):
    return LLMEngine(models[1], device="cpu", **{**ENGINE, **kw})


def _jax_engine(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def _drive(eng):
    """Step an engine to completion with the tier-aware invariant
    check (HBM + host pool + prefix store) after EVERY step."""
    outs = {}
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.request_id] = fo
        eng.check_invariants()
    return outs


# ---------------------------------------------------------------------------
# config sugar + policy
# ---------------------------------------------------------------------------
class TestTierConfig:
    def test_policy_resolve_and_validate(self):
        assert TierPolicy.resolve(None).mode == "auto"
        assert TierPolicy.resolve("never").mode == "never"
        p = TierPolicy.resolve({"mode": "always", "profile": "cpu"})
        assert (p.mode, p.profile) == ("always", "cpu")
        assert TierPolicy.resolve(p) is p
        with pytest.raises(ValueError, match="mode"):
            TierPolicy(mode="sometimes")
        with pytest.raises(ValueError, match="profile"):
            TierPolicy(profile="abacus")
        with pytest.raises(ValueError, match="link_gbps"):
            TierPolicy(link_gbps=0)
        with pytest.raises(TypeError):
            TierPolicy.resolve(3.14)

    def test_no_tpu_profile_in_the_port(self):
        assert sorted(cost.DEVICE_PROFILES) == ["cpu", "h100"]
        for key in ("flops_per_s", "hbm_bytes_per_s", "ici_bytes_per_s"):
            assert cost.DEVICE_PROFILES["cpu"][key] == \
                jax_cost.DEVICE_PROFILES["cpu"][key]
        with pytest.raises(ValueError, match="profile"):
            TierPolicy(profile="tpu-v4")

    def test_config_scalar_splits_evenly(self):
        cfg = KVTierConfig.resolve("64KiB")
        assert cfg.host_bytes == 32768 and cfg.store_bytes == 32768
        cfg = KVTierConfig.resolve(2**20 + 1)
        assert cfg.host_bytes + cfg.store_bytes == 2**20 + 1
        assert KVTierConfig.resolve(None) is None
        with pytest.raises(TypeError):
            KVTierConfig.resolve(True)
        with pytest.raises(ValueError):
            KVTierConfig.resolve(0)

    def test_policy_decide_modes(self, models):
        eng = _tiny_engine(models)
        always = TierPolicy(mode="always")
        never = TierPolicy(mode="never")
        auto = TierPolicy(mode="auto", profile="cpu")
        assert always.decide(eng, 16, 2) == "swap"
        assert never.decide(eng, 16, 2) == "recompute"
        est = auto.estimate(eng, 16, 2)
        want = "swap" if est["prefer"] == "migrate" else "recompute"
        assert auto.decide(eng, 16, 2) == want
        # the estimate prices REAL quantities: moving 2 tiny pages is
        # far cheaper than re-prefilling 16 tokens through the weights
        assert est["bytes_moved"] == 2 * eng.page_bytes
        assert est["recompute_flops"] > est["bytes_moved"]

    @pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                    {"lora": dict(rank=4, max_adapters=3)}],
                             ids=["f32", "int8", "lora"])
    def test_migration_estimate_matches_jax(self, models, kw):
        pe, je = _tiny_engine(models, **kw), _jax_engine(models, **kw)
        for tokens, pages in ((16, 2), (40, 5)):
            assert cost.migration_estimate(pe, tokens, pages,
                                           profile="cpu") == \
                jax_cost.migration_estimate(je, tokens, pages,
                                            profile="cpu")


# ---------------------------------------------------------------------------
# tier data structures
# ---------------------------------------------------------------------------
def _entry(rid, npages, bs=8, page_payload=64):
    """A fake demoted-chain entry: npages pages of page_payload bytes
    total (k + v)."""
    half = page_payload // 2
    return {"seq": {"num_tokens": npages * bs - 1,
                    "block_ids": list(range(npages)),
                    "page_tokens": [], "hashes": [None] * npages},
            "k_pages": np.zeros((1, npages, half), dtype=np.uint8),
            "v_pages": np.zeros((1, npages, half), dtype=np.uint8),
            "k_scales": None, "v_scales": None}


class TestHostPagePool:
    def test_books_and_lru_eviction(self):
        pool = HostPagePool(256)          # four 64-byte chains
        for rid in range(4):
            assert pool.put(rid, _entry(rid, 1)) == []
        pool.check_invariants()
        assert len(pool) == 4 and pool.nbytes == 256 and pool.pages == 4
        # a fifth chain evicts the OLDEST, which put() returns
        evicted = pool.put(4, _entry(4, 1))
        assert len(evicted) == 1
        assert 0 not in pool and 4 in pool
        assert pool.evicted_chains == 1
        pool.check_invariants()
        # pop balances the books; swapped= counts separately
        assert pool.pop(1, swapped=True) is not None
        assert pool.pop(1) is None
        assert pool.swapped_in_chains == 1
        pool.check_invariants()

    def test_refusals(self):
        pool = HostPagePool(100)
        pool.put("a", _entry("a", 1))
        with pytest.raises(ValueError, match="already demoted"):
            pool.put("a", _entry("a", 1))
        assert not pool.fits(101)
        with pytest.raises(ValueError, match="exceeds"):
            pool.put("b", _entry("b", 2))     # 128 bytes > 100
        with pytest.raises(ValueError):
            HostPagePool(0)


class TestPrefixStore:
    def test_first_writer_wins_and_match(self):
        store = PrefixStore(256)
        e1, e2 = _entry(0, 1), _entry(1, 1)
        store.put("h0", e1)
        store.put("h0", e2)               # refused: h0 already present
        assert store.get("h0") is e1
        store.put("h1", _entry(2, 1))
        assert store.match(["h0", "h1", "h2"]) == 2
        assert store.match(["h2", "h0"]) == 0
        assert store.adopted_pages == 1   # get() counted the adoption
        store.check_invariants()

    def test_lru_in_bytes_and_oversize_refusal(self):
        store = PrefixStore(256)
        for i in range(4):
            store.put(f"h{i}", _entry(i, 1))
        store.put("big", _entry(9, 1, page_payload=512))  # > budget: no-op
        assert "big" not in store and len(store) == 4
        store.get("h0")                   # touch: h0 is now newest
        store.put("h4", _entry(4, 1))     # evicts h1, not h0
        assert "h0" in store and "h1" not in store
        assert store.evicted_pages == 1
        store.check_invariants()
        with pytest.raises(ValueError):
            PrefixStore(-1)


# ---------------------------------------------------------------------------
# engine: demote -> swap-in, token-exact
# ---------------------------------------------------------------------------
class TestEngineTier:
    def test_swap_in_token_exact_vs_unconstrained(self, models):
        tiered = _tiny_engine(models, num_blocks=12, kv_tier=_TIER)
        ref = _tiny_engine(models, num_blocks=64)
        out_t = tiered.generate(_PROMPTS, max_new_tokens=24)
        out_r = ref.generate(_PROMPTS, max_new_tokens=24)
        for a, b in zip(out_t, out_r):
            assert np.array_equal(a, b)
        ts = tiered.tier_stats()
        # the starved pool preempted, and the tier turned at least one
        # preemption into a swap instead of a re-prefill
        assert tiered.scheduler.num_preemptions > 0
        assert ts["host_pool"]["demoted_chains"] > 0
        assert ts["host_pool"]["swapped_in_chains"] > 0
        assert ts["swapped_in_tokens"] > 0
        # drained engine: every chain left the pool (finish promotes)
        assert ts["host_pool"]["chains"] == 0
        tiered.check_invariants()
        kinds = {e[1] for e in tiered.events}
        assert "demote" in kinds and "swap_in" in kinds

    def test_tier_events_fit_frozen_schema(self, models):
        eng = _tiny_engine(models, num_blocks=12, kv_tier=_TIER)
        eng.generate(_PROMPTS, max_new_tokens=24)
        recs = to_records(eng.events)
        assert_wall_clock_free(recs)
        assert any(r["kind"] == "demote" for r in recs)

    def test_never_policy_disables_swapping(self, models):
        eng = _tiny_engine(models, num_blocks=12,
                           kv_tier=dict(_TIER, policy="never"))
        ref = _tiny_engine(models, num_blocks=12)
        out = eng.generate(_PROMPTS, max_new_tokens=24)
        out_r = ref.generate(_PROMPTS, max_new_tokens=24)
        for a, b in zip(out, out_r):
            assert np.array_equal(a, b)
        assert eng.tier_stats()["host_pool"]["demoted_chains"] == 0

    def test_int8_kv_halves_tier_footprint(self, models):
        fp = _tiny_engine(models, num_blocks=16)
        q = _tiny_engine(models, num_blocks=16, quantize="int8")
        # int8 pages: head_dim + 4 bytes/slot vs head_dim * 4 (f32) —
        # the tier stores whatever page_bytes the engine serves, so an
        # int8 pool's host-tier footprint shrinks by the same ratio
        assert q.page_bytes < fp.page_bytes / 2
        tiered = _tiny_engine(models, num_blocks=12, quantize="int8",
                              kv_tier=_TIER)
        ref = _tiny_engine(models, num_blocks=64, quantize="int8")
        out_t = tiered.generate(_PROMPTS, max_new_tokens=24)
        out_r = ref.generate(_PROMPTS, max_new_tokens=24)
        for a, b in zip(out_t, out_r):
            assert np.array_equal(a, b)
        ts = tiered.tier_stats()
        assert ts["host_pool"]["demoted_chains"] > 0
        # byte books price exactly npages * page_bytes — scales
        # included (the +4/slot term), nothing estimated
        store = tiered.prefix_store
        assert len(store) > 0
        assert store.nbytes == len(store) * tiered.page_bytes

    def test_store_readmission_after_eviction(self, models):
        """Full pages evicted from the HBM prefix cache promote into
        the store; a later admission of the same prefix adopts them
        back instead of re-prefilling (store_adopt), token-exactly."""
        eng = _tiny_engine(models, num_blocks=10, kv_tier=_TIER)
        ref = _tiny_engine(models, num_blocks=64)
        p0 = list(range(3, 27))            # 24 tokens = 3 full pages
        out0 = eng.generate([p0], max_new_tokens=8)[0]
        # churn the cache until p0's pages are LRU-evicted (promoted)
        for i in range(4):
            eng.generate([list(range(30 + 8 * i, 54 + 8 * i))],
                         max_new_tokens=8)
        assert eng.prefix_store.stats()["promoted_pages"] > 0
        out1 = eng.generate([p0], max_new_tokens=8)[0]
        assert np.array_equal(out0, out1)
        assert np.array_equal(out0, ref.generate(
            [p0], max_new_tokens=8)[0])
        assert eng.prefix_store.stats()["adopted_pages"] > 0
        assert any(e[1] == "store_adopt" for e in eng.events)
        eng.check_invariants()

    def test_cross_tier_double_residency_is_caught(self, models):
        eng = _tiny_engine(models, num_blocks=16, kv_tier=_TIER)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=8)
        eng.step()
        # forge a pool entry for a request that still owns HBM pages
        eng.host_pool.put(rid, _entry(rid, 1))
        with pytest.raises(RuntimeError, match="demoted"):
            eng.check_invariants()


# ---------------------------------------------------------------------------
# the port against the JAX engine on the same starved schedule
# ---------------------------------------------------------------------------
def _recorded_demotes(eng):
    """Record every chain the engine's host pool takes: [(rid, entry)]."""
    got = []
    put = eng.host_pool.put

    def spy(rid, entry):
        got.append((rid, entry))
        return put(rid, entry)

    eng.host_pool.put = spy
    return got


def _starved_pair(models, quantize=None, prompts=_PROMPTS, new=24, **kw):
    runs = []
    for build in (_tiny_engine, _jax_engine):
        eng = build(models, num_blocks=12, kv_tier=_TIER,
                    quantize=quantize, **kw)
        demotes = _recorded_demotes(eng)
        for p in prompts:
            eng.add_request(p, max_new_tokens=new)
        outs = _drive(eng)
        runs.append((eng, outs, demotes))
    return runs


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_starved_schedule_matches_jax(models, quantize):
    (pe, pouts, pdem), (je, jouts, jdem) = _starved_pair(models, quantize)
    assert sorted(pouts) == sorted(jouts)
    for rid in pouts:
        np.testing.assert_array_equal(pouts[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
    assert pe.tier_stats() == je.tier_stats()
    assert pe.tier_stats()["host_pool"]["swapped_in_chains"] > 0
    recs = to_records(pe.events)
    assert recs == to_records(je.events)
    kinds = {r["kind"] for r in recs}
    assert {"demote", "swap_in", "promote"} <= kinds
    assert [rid for rid, _ in pdem] == [rid for rid, _ in jdem]
    keys = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                     if quantize else [])
    for (_, pe_entry), (_, je_entry) in zip(pdem, jdem):
        assert pe_entry["seq"] == je_entry["seq"]
        for key in keys:
            got, want = pe_entry[key], np.asarray(je_entry[key])
            assert got.shape == want.shape and got.dtype == want.dtype
            if quantize and key.endswith("pages"):
                # int8 codes: a half-way value may round either way
                assert np.abs(got.astype(np.int32)
                              - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-5)
        if not quantize:
            assert pe_entry["k_scales"] is None


def test_store_adoption_matches_jax(models):
    """The store-readmission schedule through both engines: the same
    store_adopt and promote records and outputs."""
    p0 = list(range(3, 27))
    runs = []
    for build in (_tiny_engine, _jax_engine):
        eng = build(models, num_blocks=10, kv_tier=_TIER)
        outs = [eng.generate([p0], max_new_tokens=8)[0]]
        for i in range(4):
            outs.append(eng.generate([list(range(30 + 8 * i, 54 + 8 * i))],
                                     max_new_tokens=8)[0])
        outs.append(eng.generate([p0], max_new_tokens=8)[0])
        runs.append((eng, outs))
    (pe, pouts), (je, jouts) = runs
    for a, b in zip(pouts, jouts):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert to_records(pe.events) == to_records(je.events)
    assert any(e[1] == "store_adopt" for e in pe.events)
    assert pe.tier_stats() == je.tier_stats()


# ---------------------------------------------------------------------------
# tier faults: exact fallback, register-after-scatter
# ---------------------------------------------------------------------------
class TestTierFaults:
    def test_demote_fault_falls_back_to_recompute(self, models):
        # every early step's demote faults: the gather fails BEFORE
        # anything is stored — both tiers stay empty, generation falls
        # back to plain preempt-recompute and stays token-exact
        fi = FaultInjector(schedule=[Fault("tier", "demote", step=s)
                                     for s in range(200)])
        eng = _tiny_engine(models, num_blocks=12, kv_tier=_TIER, faults=fi)
        ref = _tiny_engine(models, num_blocks=64)
        out = eng.generate(_PROMPTS, max_new_tokens=24)
        out_r = ref.generate(_PROMPTS, max_new_tokens=24)
        for a, b in zip(out, out_r):
            assert np.array_equal(a, b)
        assert eng.scheduler.num_preemptions > 0
        assert eng.tier_stats()["host_pool"]["demoted_chains"] == 0
        assert any(e[1] == "tier" and e[2] == "demote"
                   for e in fi.events)
        eng.check_invariants()

    def test_promote_fault_reclaims_pages_exactly(self, models):
        # promote faults fire on a band of steps: swap-ins inside it
        # fail AFTER allocation — the pages must be reclaimed exactly
        # (invariants in _drive check every step) and the chain stays
        # in the pool for the retry once the band passes
        fi = FaultInjector(schedule=[Fault("tier", "promote", step=s)
                                     for s in range(30)])
        eng = _tiny_engine(models, num_blocks=12, kv_tier=_TIER, faults=fi)
        ref = _tiny_engine(models, num_blocks=64)
        for p in _PROMPTS:
            eng.add_request(p, max_new_tokens=24)
        outs = _drive(eng)
        out_r = ref.generate(_PROMPTS, max_new_tokens=24)
        for rid, b in zip(sorted(outs), out_r):
            got = np.concatenate([outs[rid].prompt_ids,
                                  outs[rid].output_ids])
            assert np.array_equal(got, b)
        eng.check_invariants()
        # register-after-scatter: no half-swapped chain ever exposed
        # garbage via the prefix cache — the books still balance and
        # every request drained clean
        assert eng.block_manager.num_free_blocks == 12
        assert any(e[1] == "tier" and e[2] == "promote"
                   for e in fi.events)

    def test_seeded_tier_chaos_replays_identically(self, models):
        def run():
            fi = FaultInjector.random(seed=11, steps=300, p_tier=0.5,
                                      p_oom=0.1)
            eng = _tiny_engine(models, num_blocks=12, kv_tier=_TIER,
                               faults=fi)
            for p in _PROMPTS:
                eng.add_request(p, max_new_tokens=24)
            outs = _drive(eng)
            return eng.events, fi.events, {
                rid: tuple(o.output_ids) for rid, o in outs.items()}

        ev1, fev1, out1 = run()
        ev2, fev2, out2 = run()
        assert ev1 == ev2 and fev1 == fev2 and out1 == out2

    def test_tier_stream_independent_of_existing_sites(self):
        base = FaultInjector.random(seed=3, steps=100, p_oom=0.3)
        with_tier = FaultInjector.random(seed=3, steps=100, p_oom=0.3,
                                         p_tier=0.5)
        skim = [f for f in with_tier.schedule if f.site != "tier"]
        assert [(f.site, f.kind, f.step) for f in base.schedule] == \
            [(f.site, f.kind, f.step) for f in skim]
        assert any(f.site == "tier" for f in with_tier.schedule)


@pytest.mark.parametrize("kind", ["demote", "promote", "chaos"])
def test_tier_faults_match_jax(models, kind):
    """Each fault schedule of TestTierFaults through both engines: the
    same outputs, event records, fault records and tier books."""
    runs = []
    for build, injector in ((_tiny_engine, FaultInjector),
                            (_jax_engine, JaxInjector)):
        if kind == "chaos":
            fi = injector.random(seed=11, steps=300, p_tier=0.5, p_oom=0.1)
        else:
            steps = 200 if kind == "demote" else 30
            fi = injector(schedule=[_fault(build, kind, s)
                                    for s in range(steps)])
        eng = build(models, num_blocks=12, kv_tier=_TIER, faults=fi)
        for p in _PROMPTS:
            eng.add_request(p, max_new_tokens=24)
        outs = _drive(eng)
        runs.append((eng, fi, outs))
    (pe, pfi, pouts), (je, jfi, jouts) = runs
    for rid in pouts:
        np.testing.assert_array_equal(pouts[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
        assert pouts[rid].finish_reason == jouts[rid].finish_reason
    assert to_records(pe.events) == to_records(je.events)
    assert pfi.events == jfi.events and pfi.events
    assert pe.tier_stats() == je.tier_stats()
    assert pe.block_manager.num_free_blocks == pe.num_blocks


def _fault(build, kind, step):
    if build is _tiny_engine:
        return Fault("tier", kind, step=step)
    from paddle_tpu.inference.llm.faults import Fault as JaxFault
    return JaxFault("tier", kind, step=step)


# ---------------------------------------------------------------------------
# the fleet's shared tier
# ---------------------------------------------------------------------------
def _tiny_fleet(models, replicas=2, **kw):
    return Fleet(models[1], replicas=replicas, device="cpu",
                 **{**ENGINE, **kw})


def _drive_fleet(fl):
    outs = {}
    while fl.has_unfinished():
        for fo in fl.step():
            outs[fo.request_id] = fo
        fl.check_invariants()
    return outs


class TestFleetTier:
    def test_replicas_share_one_pool_and_store(self, models):
        fl = _tiny_fleet(models, kv_tier="16MiB", num_blocks=16)
        e0, e1 = fl.replicas[0].engine, fl.replicas[1].engine
        assert e0.host_pool is e1.host_pool is fl.host_pool
        assert e0.prefix_store is e1.prefix_store is fl.prefix_store
        assert fl.router.prefix_store is fl.prefix_store
        for p in _PROMPTS:
            fl.add_request(p, max_new_tokens=8)
        _drive_fleet(fl)
        assert fl.tier_stats()["host_pool"]["chains"] == 0

    def test_store_match_feeds_router_score(self, models):
        fl = _tiny_fleet(models, kv_tier=_TIER, num_blocks=16)
        keys = ["h0", "h1"]
        assert fl.router.score(fl.replicas[0], keys) == 0
        fl.prefix_store.put("h0", _entry(0, 1))
        fl.prefix_store.put("h1", _entry(1, 1))
        assert fl.router.score(fl.replicas[0], keys) == 2
        assert fl.router.score(fl.replicas[1], keys) == 2

    def test_drain_reroutes_running_through_tier(self, models):
        """The peer has no free pages for a direct migration: the drain
        demotes the chain into the shared pool and the peer swaps it in
        at its own admission — token-exactly, and with the JAX fleet's
        decisions."""
        prompts = [list(range(3, 27)), list(range(40, 64))]
        runs = []
        for build in (_tiny_fleet, None):
            kw = dict(kv_tier=_TIER, num_blocks=6, max_model_len=48)
            fl = build(models, **kw) if build else \
                JaxFleet(models[0], replicas=2, **{**ENGINE, **kw})
            for p in prompts:
                fl.add_request(p, max_new_tokens=16)
            for _ in range(3):
                fl.step()
                fl.check_invariants()
            assert fl.drain_replica(0)
            fl.check_invariants()
            runs.append((fl, _drive_fleet(fl)))
        (fl, outs), (jfl, jouts) = runs
        assert any(e[1] == "tier_reroute" for e in fl.events)
        assert fl.stats["tier_rerouted"] >= 1
        ref = _tiny_engine(models, num_blocks=64, max_model_len=48)
        out_r = ref.generate(prompts, max_new_tokens=16)
        for rid, b in zip(sorted(outs), out_r):
            np.testing.assert_array_equal(outs[rid].all_ids, b)
            np.testing.assert_array_equal(
                outs[rid].all_ids, np.asarray(jouts[rid].all_ids))
        assert fl.events == jfl.events
        for a, b in zip(fl.replicas, jfl.replicas):
            assert to_records(a.engine.events) == \
                to_records(b.engine.events)
        assert fl.tier_stats() == jfl.tier_stats()

    def test_adopt_waiting_validates(self, models):
        eng = _tiny_engine(models, num_blocks=16, kv_tier=_TIER)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=4)
        req = eng._requests[rid]
        with pytest.raises(ValueError, match="already live"):
            eng.adopt_waiting(req)
        other = _tiny_engine(models, num_blocks=16)
        req.adapter_id = "tenant-x"
        with pytest.raises(MigrationError, match="adapter"):
            other.adopt_waiting(req)


# ---------------------------------------------------------------------------
# the simulator over the tier
# ---------------------------------------------------------------------------
class TestSimTier:
    def test_calibrate_decisions_exact_with_tier(self, models):
        from paddle_tpu_torch.sim.simulator import calibrate

        arrivals = [0.0, 0.0, 0.01, 0.02]
        prompts = _PROMPTS + [list(range(9, 25))]
        kw = dict(ENGINE, num_blocks=12, kv_tier=_TIER, device="cpu")
        r = calibrate(models[1], (arrivals, prompts, [16] * 4),
                      engine_kwargs=kw, profile="cpu")
        assert r["decisions_exact"] and r["tokens_exact"]
        assert r["real"]["steps"] > 0

    def test_sim_clock_charges_tier_traffic(self, models):
        from paddle_tpu_torch.sim.simulator import simulate

        base = dict(ENGINE, num_blocks=12, device="cpu")
        res_t, tgt = simulate(
            models[1], ([0.0] * 3, _PROMPTS, [24] * 3), profile="cpu",
            engine_kwargs=dict(base, kv_tier=_TIER))
        assert any(e[1] == "demote" for e in tgt.events)
        assert res_t["virtual_s"] > 0


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
class TestTierCostModel:
    def test_memory_model_prices_host_tier(self, models):
        eng = _tiny_engine(models, num_blocks=16, kv_tier="64KiB")
        mem = cost.engine_memory_model(eng, host_budget="32KiB")
        assert mem["host_pool_bytes"] == 32768
        assert mem["prefix_store_bytes"] == 32768
        assert mem["host_page_bytes"] == eng.page_bytes
        assert mem["host_tier_pages"] == 65536 // mem["host_page_bytes"]
        assert mem["host_budget"] == 32768
        assert mem["host_budget_pages"] == \
            32768 // mem["host_page_bytes"]
        plain = cost.engine_memory_model(_tiny_engine(models,
                                                      num_blocks=16))
        assert plain["host_pool_bytes"] == 0
        assert plain["host_budget"] is None
        want = jax_cost.engine_memory_model(
            _jax_engine(models, num_blocks=16, kv_tier="64KiB"),
            host_budget="32KiB")
        assert set(mem) <= set(want)
        assert {k: want[k] for k in mem} == mem
