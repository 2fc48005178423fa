"""The port's async lookahead (``LLMEngine(lookahead=True)``) against the
JAX package's.

The bodies of ``tests/test_llm_engine.py::TestLookahead`` (its five
prompts, ``block_size=8``, ``max_batch=4``, ``max_model_len=64``,
``token_budget=64``) on ``gpt_tiny(num_layers=2)`` in f32 with seeded
random weights carried to both packages as numpy arrays.  Planning step
N+1 while step N runs must change latency only: every stream equals the
port's ``lookahead=False`` engine and the JAX engine — greedy, staggered
admission, through preemption, seeded sampling with ``n=2`` forks, with
n-gram speculation — while plans are staged and claimed; an abort
between stage and claim and a quarantine of a claimed plan roll every
staged slot back exactly; the event records of a lookahead trace
(``step_staged``) equal the JAX engine's; and under the seeded
interleaving harness aborts that land while a plan is armed leave every
survivor token-exact and no page leaked.

The JAX quarantine case plants its failure in the launch; the port's
pools are written in place, so a failure after the first write raises
``PoolLostError`` — it is planted in ``_stage``, where the port still
quarantines.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.framework.cost import measured_host_overhead_s
from paddle_tpu_torch.inference.llm import (
    AsyncLLMEngine,
    Fault,
    FaultInjector,
    FinishReason,
    InterleavingScheduler,
    LLMEngine,
    to_records,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

LOOK = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=64)


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


def _prompts(n=5, seed=7):
    rng = np.random.RandomState(seed)
    prompts = [np.tile(rng.randint(0, 128, 5), 3).astype(np.int32),
               rng.randint(0, 128, (12,)).astype(np.int32),
               np.tile(rng.randint(0, 128, 4), 4).astype(np.int32),
               rng.randint(0, 128, (3,)).astype(np.int32),
               np.tile(rng.randint(0, 128, 6), 2).astype(np.int32)]
    return prompts[:n]


def _build(models, lookahead, port=True, spec=None, **kw):
    if port:
        return LLMEngine(models[1], device="cpu", speculative=spec,
                         lookahead=lookahead, **LOOK, **kw)
    return JaxEngine(models[0], speculative=spec, lookahead=lookahead,
                     **LOOK, **kw)


def _gen(models, lookahead, port=True, temp=0.0, seed=None, n=1,
         stagger=0, max_new=24, **kw):
    eng = _build(models, lookahead, port, **kw)
    prompts = _prompts()

    def add(i):
        eng.add_request(prompts[i], max_new_tokens=max_new,
                        temperature=temp,
                        seed=None if seed is None else seed + i, n=n)

    nxt = 2 if stagger else len(prompts)
    for i in range(nxt):
        add(i)
    outs = {}
    steps = 0
    while eng.has_unfinished() or nxt < len(prompts):
        steps += 1
        # staggered arrivals invalidate the staged plan at the same
        # logical step in both legs
        if stagger and nxt < len(prompts) and steps % stagger == 0:
            add(nxt)
            nxt += 1
        for r in eng.step():
            outs[r.request_id] = [int(t) for t in r.output_ids]
    eng.block_manager.check_invariants()
    return outs, eng


_JAX_RUNS = {}


def _jax_sync(models, key, **kw):
    """The JAX sync engine's streams for ``key``, once per module."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _gen(models, False, port=False, **kw)[0]
    return _JAX_RUNS[key]


def test_greedy_token_exact_and_pipeline_active(models):
    la, eng = _gen(models, True)
    base, _ = _gen(models, False)
    assert la == base == _jax_sync(models, "greedy")
    st = eng.lifecycle_stats()
    assert st["staged_steps"] > 0 and st["staged_hits"] > 0
    assert st["staged_hits"] <= st["staged_steps"]
    assert 0.0 < st["host_overhead_fraction"] < 1.0
    assert st["host_plan_s"] > 0.0
    assert measured_host_overhead_s(eng) > 0.0
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_lifecycle_keys_are_the_jax_engines(models):
    eng = _build(models, True)
    jeng = _build(models, True, port=False)
    assert list(eng.lifecycle_stats()) == list(jeng.lifecycle_stats())
    assert eng.lifecycle_stats()["host_overhead_fraction"] is None
    assert measured_host_overhead_s(eng) == 0.0


def test_staggered_admission_token_exact(models):
    la, eng = _gen(models, True, stagger=3)
    base, _ = _gen(models, False, stagger=3)
    assert la == base == _jax_sync(models, "stagger", stagger=3)
    assert eng.lifecycle_stats()["staged_steps"] > 0


def test_token_exact_through_preemption(models):
    la, eng = _gen(models, True, num_blocks=18)
    base, beng = _gen(models, False, num_blocks=18)
    assert la == base == _jax_sync(models, "preempt", num_blocks=18)
    assert eng.scheduler.num_preemptions == \
        beng.scheduler.num_preemptions > 0
    assert eng.block_manager.num_free_blocks == 18


def test_seeded_sampling_and_forks_token_exact(models):
    la, eng = _gen(models, True, temp=0.8, seed=123, n=2)
    base, _ = _gen(models, False, temp=0.8, seed=123, n=2)
    assert la == base == _jax_sync(models, "forks", temp=0.8, seed=123,
                                   n=2)
    assert any("." in str(rid) for rid in la)
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_ngram_spec_token_exact(models):
    la, eng = _gen(models, True, spec=4)
    base, _ = _gen(models, False, spec=4)
    plain, _ = _gen(models, False)
    assert la == base == plain == _jax_sync(models, "greedy")
    assert eng.spec_stats()["accepted_tokens"] > 0


def test_no_staging_with_faults_or_a_model_drafter(models):
    fi = FaultInjector([Fault("step", "transient", step=1, count=1)])
    _, eng = _gen(models, True, faults=fi, retry=3)
    assert eng.stats["staged_steps"] == 0
    _, eng = _gen(models, True, spec={"method": "draft-model",
                                      "num_tokens": 2})
    assert eng.stats["staged_steps"] == 0


def test_lookahead_event_records_equal_jax(models):
    _, eng = _gen(models, True, stagger=3)
    _, jeng = _gen(models, True, port=False, stagger=3)
    records = to_records(eng.events)
    assert records == to_records(jeng.events)
    assert any(r["kind"] == "step_staged" for r in records)
    assert eng.stats["staged_hits"] == jeng.stats["staged_hits"]


def test_abort_between_stage_and_launch_rolls_back(models):
    """An abort landing while a staged plan is armed discards the plan
    and rolls back its slot claims exactly: outputs equal a sync engine
    given the same abort schedule, and no page leaks."""
    la = _build(models, True)
    sync = _build(models, False)
    for eng in (la, sync):
        for i, p in enumerate(_prompts(n=3)):
            eng.add_request(p, max_new_tokens=24, request_id=f"r{i}")
    outs = {"la": {}, "sync": {}}
    aborted = False
    steps = 0
    while la.has_unfinished() or sync.has_unfinished():
        steps += 1
        assert steps < 512
        if not aborted and la._staged is not None \
                and any(r.request_id == "r1" for r in la.scheduler.running):
            assert any(row.request.request_id == "r1"
                       for row in la._staged[0])
            la.abort_request("r1")
            sync.abort_request("r1")
            aborted = True
            assert la._staged_epoch != la._plan_epoch
        for eng, key in ((la, "la"), (sync, "sync")):
            if eng.has_unfinished():
                for r in eng.step():
                    outs[key][r.request_id] = r
    assert aborted
    assert set(outs["la"]) == set(outs["sync"])
    for rid, r in outs["la"].items():
        assert list(r.output_ids) == list(outs["sync"][rid].output_ids), rid
        assert r.finish_reason == outs["sync"][rid].finish_reason
    assert outs["la"]["r1"].finish_reason == FinishReason.ABORTED
    for eng in (la, sync):
        eng.block_manager.check_invariants()
        assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_quarantine_of_claimed_plan_rolls_back(models):
    """A claimed plan whose launch fails while staging its operands
    quarantines its rows and rolls back every staged slot: books back to
    ``num_cached``, no page leaked, and the engine keeps serving."""
    eng = _build(models, True, retry={"max_attempts": 1,
                                      "base_delay_s": 0.0, "jitter": 0.0})
    for i, p in enumerate(_prompts(n=3)):
        eng.add_request(p, max_new_tokens=24, request_id=f"r{i}")
    orig = eng._stage
    state = {"armed": False, "fired": False}

    def boom(pk):
        if state["armed"]:
            state["armed"] = False
            state["fired"] = True
            raise RuntimeError("injected launch failure")
        return orig(pk)

    eng._stage = boom
    outs = {}
    steps = 0
    while eng.has_unfinished():
        steps += 1
        assert steps < 512
        armed_now = not state["fired"] and eng._staged is not None
        if armed_now:
            state["armed"] = True      # the next launch is the claim
        before = eng.stats["staged_hits"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for r in eng.step():
                outs[r.request_id] = r
        if armed_now:
            assert state["fired"]
            assert eng.stats["staged_hits"] == before + 1
    assert state["fired"]
    assert eng.stats["quarantined"] == 3
    errs = [r for r in outs.values()
            if r.finish_reason == FinishReason.ERROR]
    assert errs and all("injected launch failure" in r.error for r in errs)
    eng.block_manager.check_invariants()
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    eng.add_request(_prompts(n=1)[0], max_new_tokens=8, request_id="fresh")
    while eng.has_unfinished():
        for r in eng.step():
            outs[r.request_id] = r
    assert outs["fresh"].finish_reason == FinishReason.LENGTH
    assert len(outs["fresh"].output_ids) == 8
    assert eng.block_manager.num_free_blocks == eng.num_blocks


class _ArmedAbortWitness(LLMEngine):
    """Records whether each applied abort found a staged plan armed."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.armed_aborts = 0

    def abort_request(self, request_id):
        if self._staged is not None and request_id in self._requests:
            self.armed_aborts += 1
        return super().abort_request(request_id)


def _interleaved(models, seed, max_new=10):
    eng = _ArmedAbortWitness(models[1], device="cpu", lookahead=True,
                             **LOOK)
    aeng = AsyncLLMEngine(eng)
    sched = InterleavingScheduler(seed=seed, adopt=("llm-async-worker",))
    got = {}
    prompts = _prompts(n=4)

    def submitter():
        # the first request finishes early: the abort that follows it
        # lands while the others still decode under staged plans
        rids = [aeng.submit(p, max_new_tokens=3 if i == 0 else max_new)
                for i, p in enumerate(prompts)]
        for i, r in enumerate(rids):
            out = aeng.result(r)
            got[i] = (out.finish_reason,
                      tuple(int(t) for t in out.output_ids))
            if i == 0:
                aeng.abort(rids[2])

    sched.spawn("submitter", submitter)
    log = sched.run(expect_adopted=1)
    aeng.close()
    return (list(log), eng.num_blocks - eng.block_manager.num_free_blocks,
            got, eng.armed_aborts, eng.stats["staged_hits"])


def test_stage_vs_abort_race_under_interleaving(models):
    """Seeded schedules of a submitter thread against the async worker
    of a lookahead engine: a queued abort is applied between steps,
    while the step before staged a plan (the window
    ``interleave_point("staged")`` opens).  Every schedule leaves no page
    leaked, survivors equal the sync streams, the abort lands on an
    armed plan in some schedule, and a seed replays exactly."""
    sync, _ = _gen(models, False, max_new=10)
    runs = {seed: _interleaved(models, seed) for seed in range(4)}
    for seed, (log, leaked, got, _armed, hits) in runs.items():
        assert leaked == 0, seed
        assert len(log) > 10
        for i, (reason, toks) in got.items():
            if reason == FinishReason.LENGTH:
                assert len(toks) == (3 if i == 0 else 10)
                assert list(toks) == sync[i][:len(toks)], (seed, i)
            else:
                assert i == 2 and reason == FinishReason.ABORTED
        assert hits > 0, seed
    assert any(armed for _l, _f, _g, armed, _h in runs.values())
    assert _interleaved(models, 1) == runs[1]
