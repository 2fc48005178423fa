"""KV-page migration with tensor-parallel engines (``export_request`` /
``import_request`` at tp=2, fleets of tp=2 replicas) against the port's
tp=1 engine and the JAX package's tp=1 engine.

The JAX tensor-parallel engine fails under the installed jax, so each
tp=2 result is held to the tp=1 engines of both packages on
``gpt_tiny(num_layers=2)`` in f32 with the same seeded weights: a
running request moved mid-generation 2 -> 1, 1 -> 2 and 2 -> 2,
token-exact against the unmigrated JAX tp=1 run; the exported payload in
the global layout (heads in the model's order) within 1e-5 of tp=1's,
and int8 codes within 1 with their scales; a fault after allocation
reclaiming exactly, every rank's pools unchanged; the disaggregated and
drain scenarios of ``test_torch_migration.py`` over tp=2 replicas with
the JAX fleet's events, records and stats; and ``migration_estimate`` at
tp=2 equal to the JAX formula (bytes of the global payload, the global
parameter count), which is tp=1's.
"""

import warnings

import numpy as np
import pytest
import torch
from torch_tp_helpers import ENGINE, assert_pages_close, close_all, seeded_models

from paddle_tpu.framework import cost as jax_cost
from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm import to_records as jax_records
from paddle_tpu_torch.framework import cost
from paddle_tpu_torch.inference.llm import Fleet, LLMEngine, to_records

_WALL_KEYS = {"last_step_ms", "host_plan_s", "host_overhead_fraction"}


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
    return seeded_models(6)


@pytest.fixture(scope="module")
def spawned():
    """Closes every tensor-parallel engine and fleet a test of this
    module built, at the module's end."""
    built = []
    yield built
    close_all(built)


def _port(models, spawned, tp=1, **kw):
    eng = LLMEngine(models[1], device="cpu", tensor_parallel=tp,
                    **{**ENGINE, **kw})
    if tp > 1:
        spawned.append(eng)
    return eng


def _jax(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def _prompts(seed=0, n=6):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (int(rng.randint(4, 14)),))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_want(models):
    """The unmigrated JAX tp=1 run of the handoff prompts."""
    return _jax(models).generate(_prompts(n=3), max_new_tokens=10)


def _move(e0, e1, rid):
    state = e0.export_request(rid)
    e1.import_request(state["request"], state["seq"], state["k_pages"],
                      state["v_pages"], k_scales=state.get("k_scales"),
                      v_scales=state.get("v_scales"))
    e0.release_request(rid)
    return state


@pytest.mark.parametrize("tps", [(2, 1), (1, 2), (2, 2)],
                         ids=["2to1", "1to2", "2to2"])
def test_handoff_across_tp_token_exact(models, spawned, jax_want, tps):
    """A RUNNING request moved mid-decode between engines of tp
    ``tps``: the merged outputs equal the unmigrated JAX tp=1 run, the
    destination's pools keep their addresses, and both engines' books
    balance with every page back."""
    e0, e1 = (_port(models, spawned, tp) for tp in tps)
    ptrs = (e1._kc.data_ptr(), e1._vc.data_ptr())
    rids = [e0.add_request(p, max_new_tokens=10) for p in _prompts(n=3)]
    outs = {}
    for _ in range(4):
        for fo in e0.step():
            outs[fo.request_id] = fo
    assert len(e0._requests[rids[1]].output_ids) >= 1
    _move(e0, e1, rids[1])
    e0.scheduler.check_invariants()
    e1.scheduler.check_invariants()
    while e0.has_unfinished() or e1.has_unfinished():
        for fo in e0.step() + e1.step():
            outs[fo.request_id] = fo
    for rid, w in zip(rids, jax_want):
        np.testing.assert_array_equal(outs[rid].all_ids, np.asarray(w))
    assert (e1._kc.data_ptr(), e1._vc.data_ptr()) == ptrs
    assert "import" in [r["kind"] for r in to_records(e1.events)]
    for e in (e0, e1):
        assert e.block_manager.num_free_blocks == e.num_blocks


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_payload_global_layout_within_1e5_of_tp1(models, spawned,
                                                 quantize):
    """The same request, three steps in, exported from a tp=2 and a tp=1
    engine: the chain equal and each payload [L, n, bs, Nh, D] (scales
    [L, n, Nh, bs]) with every head where tp=1 has it, within 1e-5 (int8
    codes within 1); the JAX tp=1 engine's payload agrees too."""
    prompt = _prompts(n=1)[0]
    engines = (_port(models, spawned, 2, quantize=quantize),
               _port(models, spawned, 1, quantize=quantize),
               _jax(models, quantize=quantize))
    states = []
    for eng in engines:
        eng.add_request(prompt, max_new_tokens=8, request_id="r")
        for _ in range(3):
            eng.step()
        states.append(eng.export_request("r"))
    two, one, jx = states
    assert two["seq"] == one["seq"] == jx["seq"]
    keys = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                     if quantize else [])
    # rank 1's heads are the model's upper half: a layout that swapped
    # the ranks' halves, or two heads, would differ by far more than 1e-5
    for key in keys:
        codes = bool(quantize) and key.endswith("pages")
        assert_pages_close(two[key], one[key], int8_codes=codes)
        assert_pages_close(two[key], jx[key], int8_codes=codes)
    for e in engines[:2]:
        while e.has_unfinished():
            e.step()


def test_import_fault_reclaims_exactly_on_every_rank(models, spawned):
    """``test_import_fault_reclaims_exactly`` at tp=2: a failure after
    allocation (the fault hook, or a scale payload of the wrong dtype
    for an int8 pool) frees exactly the pages allocated, and no rank's
    pools changed: nothing reached a worker."""
    src = _port(models, spawned, 1, quantize="int8")
    dst = _port(models, spawned, 2, quantize="int8")
    rid = src.add_request(_prompts(n=1)[0], max_new_tokens=8)
    for _ in range(3):
        src.step()
    state = src.export_request(rid)
    before = dst.block_manager.num_free_blocks
    pools = [s["pool_sums"] for s in dst._rank_stats(detail=True)]

    def boom():
        raise RuntimeError("mid-import fault")

    with pytest.raises(RuntimeError, match="mid-import"):
        dst.import_request(state["request"], state["seq"],
                           state["k_pages"], state["v_pages"],
                           fault_hook=boom, k_scales=state["k_scales"],
                           v_scales=state["v_scales"])
    with pytest.raises(ValueError, match="does not match"):
        dst.import_request(state["request"], state["seq"],
                           state["k_pages"], state["v_pages"],
                           k_scales=state["k_scales"].astype(np.float16),
                           v_scales=state["v_scales"])
    assert dst.block_manager.num_free_blocks == before
    assert rid not in dst._requests and not dst.block_manager.has_seq(rid)
    assert [s["pool_sums"] for s in dst._rank_stats(detail=True)] == pools
    dst.scheduler.check_invariants()
    assert src.block_manager.has_seq(rid)
    dst.import_request(state["request"], state["seq"], state["k_pages"],
                       state["v_pages"], k_scales=state["k_scales"],
                       v_scales=state["v_scales"])
    src.release_request(rid)
    want = _jax(models, quantize="int8").generate(
        [_prompts(n=1)[0]], max_new_tokens=8)[0]
    out = {}
    while dst.has_unfinished():
        for fo in dst.step():
            out[fo.request_id] = fo
    np.testing.assert_array_equal(out[rid].all_ids, np.asarray(want))


def _fleets_agree(port, jax, pouts, jouts):
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


def _both(models, spawned, scenario, **kw):
    """``scenario(fleet)`` on a fleet of tp=2 port replicas and on a JAX
    fleet of tp=1 replicas built alike; the runs must agree."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pf = Fleet(models[1], replicas=2, device="cpu", tensor_parallel=2,
                   **{**ENGINE, **kw})
        spawned.append(pf)
        pouts = scenario(pf)
        jf = JaxFleet(models[0], replicas=2, **{**ENGINE, **kw})
        jouts = scenario(jf)
    assert [r.engine.tp for r in pf.replicas] == [2, 2]
    _fleets_agree(pf, jf, pouts, jouts)
    for r in pf.replicas:
        assert r.engine.block_manager.num_free_blocks == r.engine.num_blocks
    return pf, pouts


def _run(fleet, drain_at=None):
    outs, step = {}, 0
    while fleet.has_unfinished():
        for fo in fleet.step():
            outs[fo.request_id] = fo
        if step == drain_at:
            fleet.drain_replica(1)
        fleet.check_invariants()
        step += 1
    return outs


def test_disaggregated_prefix_cache_and_spec_over_tp2(models, spawned):
    """``TestDisaggregated::test_token_exact_with_prefix_cache_and_spec``
    over tp=2 replicas: every prompt prefills on replica 0 (adopting the
    shared prefix's pages) and migrates to replica 1, which decodes with
    n-gram speculation; token-exact against one tp=1 engine."""
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 128, (16,)).astype(np.int32)
    pat = rng.randint(0, 128, (5,)).astype(np.int32)
    prompts = [np.concatenate([shared, np.tile(pat, 2),
                               rng.randint(0, 128, (i + 2,))
                               .astype(np.int32)]) for i in range(5)]
    want = _port(models, spawned, speculative=2).generate(
        prompts, max_new_tokens=10)

    def scenario(fleet):
        assert fleet.roles() == {0: "prefill", 1: "decode"}
        for p in prompts:
            fleet.add_request(p, max_new_tokens=10)
        return _run(fleet)

    fleet, outs = _both(models, spawned, scenario, disaggregate=True,
                        speculative=2)
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(outs[rid].all_ids, w)
    assert fleet.stats["migrated"] == len(prompts)
    assert fleet.prefix_cache_stats()["prefix_hit_tokens"] > 0
    assert fleet.spec_stats()["draft_tokens"] > 0


def test_drain_migrates_running_over_tp2(models, spawned):
    """``TestFleetMigration::test_drain_migrates_running_token_exact``
    over tp=2 replicas: the drained replica's running sequences move to
    its peer, every output the tp=1 engine's, and the bytes moved are
    the global payload (pages x ``page_bytes`` x tp), the JAX tp=1
    fleet's count."""
    prompts = _prompts(n=6)
    want = _port(models, spawned).generate(prompts, max_new_tokens=10)

    def scenario(fleet):
        for p in prompts:
            fleet.add_request(p, max_new_tokens=10)
        return _run(fleet, drain_at=3)

    fleet, outs = _both(models, spawned, scenario)
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(outs[rid].all_ids, w)
    eng = fleet.replicas[0].engine
    assert fleet.stats["migrated"] >= 1 and fleet.stats["requeued"] == 0
    assert fleet.stats["migrated_bytes"] == sum(
        e[5] for e in fleet.events if e[1] == "migrate") \
        * eng.page_bytes * eng.tp
    assert fleet.replica_states()[1] == "drained"


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"lora": dict(rank=4, max_adapters=3)}],
                         ids=["f32", "int8", "lora"])
def test_migration_estimate_tp2_is_the_jax_formula(models, spawned, kw):
    """At tp=2 the estimate moves the global payload and recomputes
    through the global parameters: the JAX tp=1 engine's numbers, and
    the port's tp=1 ones (rank 0's shard alone would halve the bytes
    and undercount the FLOPs)."""
    two, one = _port(models, spawned, 2, **kw), _port(models, spawned, **kw)
    je = _jax(models, **kw)
    for tokens, pages in ((16, 2), (40, 5)):
        want = jax_cost.migration_estimate(je, tokens, pages, profile="cpu")
        assert cost.migration_estimate(two, tokens, pages,
                                       profile="cpu") == want
        assert cost.migration_estimate(one, tokens, pages,
                                       profile="cpu") == want
    assert cost.global_param_count(two) == cost.global_param_count(one)
