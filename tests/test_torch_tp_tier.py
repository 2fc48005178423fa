"""The host-RAM KV tier of a tensor-parallel engine (``LLMEngine(
tensor_parallel=2, kv_tier=...)``) against the port's tp=1 engine and the
JAX package's tp=1 engine.

The JAX engine's own tensor-parallel tests fail under the installed jax
(``shard_map``'s ``check_rep``), so each tp=2 result here is held to the
tp=1 engines of both packages on ``gpt_tiny(num_layers=2)`` in f32 with
the same seeded weights: the starved schedule of
``test_torch_kv_tier.py`` (``num_blocks=12``, ``policy="always"``) in f32
and with the int8 pool — outputs, ``tier_stats()`` key for key, the
event records and the host bytes moved equal, and every demoted payload
in the global layout, its heads in the model's order, within 1e-5 of
tp=1's (int8 codes within 1); a host pool too small for some chains'
global payload refusing the same demotes as tp=1; the three tier-fault
schedules; and a fleet drain over tp=2 replicas rerouting a running
request through the shared tier, with the JAX fleet's decisions.
"""

import numpy as np
import pytest
import torch
from torch_tp_helpers import (
    ENGINE,
    assert_pages_close,
    close_all,
    drive,
    recorded_demotes,
    seeded_models,
    tier_bytes,
)

from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm.faults import Fault as JaxFault
from paddle_tpu.inference.llm.faults import FaultInjector as JaxInjector
from paddle_tpu_torch.inference.llm import (
    Fault,
    FaultInjector,
    Fleet,
    LLMEngine,
    to_records,
)

_PROMPTS = [list(range(3, 19)), list(range(5, 21)), list(range(7, 23))]
_TIER = {"host_bytes": "8MiB", "store_bytes": "8MiB", "policy": "always"}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread (the workers take rank 0's count): the tiny CPU
    steps gain nothing from more, and idle intra-op threads spinning
    beside other test processes slow the JAX compiles several-fold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    return seeded_models(9)


@pytest.fixture(scope="module")
def spawned():
    """Closes every tensor-parallel engine and fleet a test of this
    module built, at the module's end."""
    built = []
    yield built
    close_all(built)


def _port(models, spawned, tp, **kw):
    eng = LLMEngine(models[1], device="cpu", tensor_parallel=tp,
                    **{**ENGINE, **kw})
    if tp > 1:
        spawned.append(eng)
    return eng


def _jax(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def _starved(eng, new=24):
    demotes = recorded_demotes(eng)
    for p in _PROMPTS:
        eng.add_request(p, max_new_tokens=new)
    outs, moved = tier_bytes(eng)
    return outs, demotes, moved


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_starved_schedule_matches_tp1_and_jax(models, spawned, quantize):
    kw = dict(num_blocks=12, kv_tier=_TIER, quantize=quantize)
    two = _port(models, spawned, 2, **kw)
    outs2, dem2, moved2 = _starved(two)
    one = _port(models, spawned, 1, **kw)
    outs1, dem1, moved1 = _starved(one)
    je = _jax(models, **kw)
    jouts, jdem = _starved_jax(je)
    assert sorted(outs2) == sorted(outs1) == sorted(jouts)
    for rid in outs2:
        np.testing.assert_array_equal(outs2[rid].all_ids, outs1[rid].all_ids)
        np.testing.assert_array_equal(outs2[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
    assert two.tier_stats() == one.tier_stats() == je.tier_stats()
    assert two.tier_stats()["host_pool"]["swapped_in_chains"] > 0
    # the tier's books count the global payload: every rank's heads
    assert moved2 == moved1 > 0
    recs = to_records(two.events)
    assert recs == to_records(je.events)
    assert {"demote", "swap_in", "promote"} <= {r["kind"] for r in recs}
    assert [rid for rid, _ in dem2] == [rid for rid, _ in dem1] == \
        [rid for rid, _ in jdem]
    keys = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                     if quantize else [])
    for (_, e2), (_, e1), (_, je_entry) in zip(dem2, dem1, jdem):
        assert e2["seq"] == e1["seq"] == je_entry["seq"]
        for key in keys:
            codes = bool(quantize) and key.endswith("pages")
            assert_pages_close(e2[key], e1[key], int8_codes=codes)
            assert_pages_close(e2[key], je_entry[key], int8_codes=codes)
        if not quantize:
            assert e2["k_scales"] is None
    assert two.block_manager.num_free_blocks == two.num_blocks


def _starved_jax(je, new=24):
    demotes = recorded_demotes(je)
    for p in _PROMPTS:
        je.add_request(p, max_new_tokens=new)
    return drive(je), demotes


def test_host_budget_under_a_chain_refuses_as_tp1(models, spawned):
    """A host pool of three tp=1 pages (a page's global payload): a chain
    longer than three pages does not fit at tp=2 either, though its
    per-chip bytes would, so both engines demote the same chains, and
    both tiers' books stay within the budget."""
    tier = {"host_bytes": 3 * _port(models, spawned, 1).page_bytes,
            "store_bytes": "8MiB", "policy": "always"}
    runs = []
    for tp in (2, 1):
        eng = _port(models, spawned, tp, num_blocks=12, kv_tier=tier)
        runs.append((eng, *_starved(eng)))
    (two, outs2, dem2, moved2), (one, outs1, dem1, moved1) = runs
    for rid in outs1:
        np.testing.assert_array_equal(outs2[rid].all_ids, outs1[rid].all_ids)
    assert [len(e["seq"]["block_ids"]) for _, e in dem2] == \
        [len(e["seq"]["block_ids"]) for _, e in dem1]
    assert all(len(e["seq"]["block_ids"]) <= 3 for _, e in dem2)
    assert two.tier_stats() == one.tier_stats()
    assert to_records(two.events) == to_records(one.events)
    assert moved2 == moved1
    assert two.scheduler.num_preemptions == one.scheduler.num_preemptions > 0


@pytest.mark.parametrize("kind", ["demote", "promote", "chaos"])
def test_tier_faults_at_tp2_match_tp1_and_jax(models, spawned, kind):
    """``test_torch_kv_tier.py::test_tier_faults_match_jax``'s schedules
    at tp=2: outputs, finish reasons, event and fault records and the
    tier's books equal tp=1's and the JAX engine's; no page leaked."""
    runs = []
    for tp in (2, 1, None):
        injector = JaxInjector if tp is None else FaultInjector
        if kind == "chaos":
            fi = injector.random(seed=11, steps=300, p_tier=0.5, p_oom=0.1)
        else:
            steps = 200 if kind == "demote" else 30
            fi = injector(schedule=[
                (JaxFault if tp is None else Fault)("tier", kind, step=s)
                for s in range(steps)])
        kw = dict(num_blocks=12, kv_tier=_TIER, faults=fi)
        eng = _jax(models, **kw) if tp is None else \
            _port(models, spawned, tp, **kw)
        for p in _PROMPTS:
            eng.add_request(p, max_new_tokens=24)
        runs.append((eng, fi, drive(eng)))
    (two, fi2, outs2), (one, fi1, outs1), (je, jfi, jouts) = runs
    for rid in outs2:
        np.testing.assert_array_equal(outs2[rid].all_ids, outs1[rid].all_ids)
        np.testing.assert_array_equal(outs2[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
        assert outs2[rid].finish_reason == jouts[rid].finish_reason
    assert to_records(two.events) == to_records(one.events) == \
        to_records(je.events)
    assert fi2.events == fi1.events == jfi.events and fi2.events
    assert two.tier_stats() == one.tier_stats() == je.tier_stats()
    assert two.block_manager.num_free_blocks == two.num_blocks


def test_drain_reroutes_running_through_tier_tp2(models, spawned):
    """``TestFleetTier::test_drain_reroutes_running_through_tier`` over
    tp=2 replicas: the peer has no free pages for a direct migration, so
    the drain demotes the running chain into the shared pool and the
    peer swaps it in — token-exact against one tp=1 engine, and with the
    JAX fleet's events, records and tier books."""
    prompts = [list(range(3, 27)), list(range(40, 64))]
    kw = dict(kv_tier=_TIER, num_blocks=6, max_model_len=48)
    runs = []
    for fleet in (Fleet(models[1], replicas=2, device="cpu",
                        tensor_parallel=2, **{**ENGINE, **kw}),
                  JaxFleet(models[0], replicas=2, **{**ENGINE, **kw})):
        if isinstance(fleet, Fleet):
            spawned.append(fleet)
        for p in prompts:
            fleet.add_request(p, max_new_tokens=16)
        for _ in range(3):
            fleet.step()
            fleet.check_invariants()
        assert fleet.drain_replica(0)
        fleet.check_invariants()
        runs.append((fleet, drive(fleet)))
    (fl, outs), (jfl, jouts) = runs
    assert [r.engine.tp for r in fl.replicas] == [2, 2]
    assert any(e[1] == "tier_reroute" for e in fl.events)
    assert fl.stats["tier_rerouted"] >= 1
    want = _port(models, spawned, 1, num_blocks=64,
                 max_model_len=48).generate(prompts, max_new_tokens=16)
    for rid, w in zip(sorted(outs), want):
        np.testing.assert_array_equal(outs[rid].all_ids, w)
        np.testing.assert_array_equal(outs[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
    assert fl.events == jfl.events
    for a, b in zip(fl.replicas, jfl.replicas):
        assert to_records(a.engine.events) == to_records(b.engine.events)
    assert fl.tier_stats() == jfl.tier_stats()
