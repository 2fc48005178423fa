"""The port's request lifecycle and faults against the JAX package's.

The cases of ``tests/test_faults.py`` that need neither speculation nor
a fleet nor the socket server, run on the port: the copied ``faults.py``
(FinishReason, FaultInjector, RetryPolicy, StepWatchdog) by the same unit
cases; abort in every state, deadlines, shedding, drain, step isolation
(retry, quarantine, watchdog, injected OOM), event-log determinism, the
lifecycle gauges and ``AsyncLLMEngine``'s lifecycle on the port's
engines.  Where a case has survivors, they are token-exact against the
JAX ``LLMEngine`` driven the same way, and the port's event records
(``events.to_records``) equal the JAX engine's for the same fault seed.

Both engines serve ``gpt_tiny(num_layers=2)`` in f32 with the same
weights (carried across as numpy arrays by ``load_stacked``) at
``block_size=8``, ``max_batch=4``, ``max_model_len=64``,
``token_budget=16``.  The port's pools are written in place, so where
the JAX test plants a consumed donated pool, these plant a failure after
the step's first pool write (PoolLostError) and one while staging
(retried, then quarantined), and check that an injected fault leaves the
pools bitwise as the previous step committed them.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    AsyncLLMEngine,
    BlockManager,
    Fault,
    FaultInjector,
    FinishReason,
    InjectedFault,
    LLMEngine,
    PoolLostError,
    RetryPolicy,
    Scheduler,
    StepWatchdog,
    to_records,
)
from paddle_tpu_torch.inference.llm.scheduler import RUNNING, WAITING, Request
from paddle_tpu_torch.models.gpt import gpt_tiny

TINY = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
_FAST_RETRY = {"max_attempts": 3, "base_delay_s": 0.0, "jitter": 0.0}


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


def _port(models, **kw):
    return LLMEngine(models[1], device="cpu", **{**TINY, **kw})


def _jax(models, **kw):
    return JaxEngine(models[0], **{**TINY, **kw})


class _FakeClock:
    """Injectable monotonic clock: deadline tests advance time by hand."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _drive(eng, faults=None):
    """Step an engine to completion, checking the scheduler's invariants
    after every step; applies "client"-site faults (abort the oldest
    live request) as a chaos harness would.  Returns {rid: output}."""
    outs = {}
    while eng.has_unfinished():
        if faults is not None and \
                faults.scheduled("client", eng._step_index + 1):
            live = sorted(eng._requests)
            if live:
                eng.abort_request(live[0])
        for fo in eng.step():
            outs[fo.request_id] = fo
        eng.scheduler.check_invariants()
    return outs


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype(np.int32) for n in lengths]


def _same_outputs(got, want):
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        np.testing.assert_array_equal(got[rid].all_ids, want[rid].all_ids)


# ------------------------------------------------- the copied faults.py --
class TestFinishReason:
    def test_vocabulary_and_done_family(self):
        assert set(FinishReason.ALL) == {"stop", "length", "aborted",
                                         "deadline", "shed", "error"}
        assert FinishReason.is_done("stop") and FinishReason.is_done("length")
        for r in ("aborted", "deadline", "shed", "error"):
            assert not FinishReason.is_done(r)


class TestFaultInjectorUnit:
    def test_random_schedule_is_seed_deterministic(self):
        kw = dict(steps=64, p_step=0.1, p_transient=0.1, p_oom=0.1,
                  p_delay=0.05, p_abort=0.05, delay_s=0.001)
        a = FaultInjector.random(7, **kw)
        b = FaultInjector.random(7, **kw)
        assert a.schedule == b.schedule and a.schedule
        assert FaultInjector.random(8, **kw).schedule != a.schedule

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="site"):
            FaultInjector(schedule=[Fault("gpu", "melt", step=0)])

    def test_transient_fails_count_attempts_then_succeeds(self):
        fi = FaultInjector(schedule=[
            Fault("step", "transient", step=3, count=2)])
        fi.begin_step(2)
        fi.device_step("ragged")            # unscheduled step: no-op
        fi.begin_step(3)
        for _ in range(2):
            with pytest.raises(InjectedFault):
                fi.device_step("ragged")
        fi.device_step("ragged")            # third attempt passes
        assert fi.events == [(3, "step", "transient", 0),
                             (3, "step", "transient", 1)]

    def test_raise_carries_victim_every_attempt(self):
        fi = FaultInjector(schedule=[
            Fault("step", "raise", step=0, victim=2)])
        fi.begin_step(0)
        for _ in range(3):
            with pytest.raises(InjectedFault) as ei:
                fi.device_step("ragged")
            assert ei.value.victim == 2

    def test_alloc_fires_once_per_scheduled_step(self):
        fi = FaultInjector(schedule=[Fault("alloc", "oom", step=5)])
        fi.begin_step(4)
        assert fi.alloc("append_slot") is False
        fi.begin_step(5)
        assert fi.alloc("append_slot") is True
        assert fi.alloc("append_slot") is False    # consumed
        assert fi.events == [(5, "alloc", "oom", 0)]

    def test_socket_faults_index_by_response(self):
        fi = FaultInjector(schedule=[
            Fault("socket", "disconnect", step=0),
            Fault("socket", "partial", step=2)])
        assert [fi.socket_fault() for _ in range(4)] == [
            "disconnect", None, "partial", None]


class TestRetryPolicy:
    def test_resolve_sugar(self):
        assert RetryPolicy.resolve(None).max_attempts == 3
        assert RetryPolicy.resolve(5).max_attempts == 5
        p = RetryPolicy(max_attempts=2)
        assert RetryPolicy.resolve(p) is p
        assert RetryPolicy.resolve(
            {"max_attempts": 4, "jitter": 0.0}).max_attempts == 4
        for bad in (True, "twice"):
            with pytest.raises(TypeError):
                RetryPolicy.resolve(bad)

    def test_backoff_exponential_capped_and_seeded(self):
        p = RetryPolicy(max_attempts=5, base_delay_s=0.1, max_delay_s=0.5,
                        jitter=0.0)
        assert [p.backoff(a) for a in range(4)] == [
            pytest.approx(0.1), pytest.approx(0.2), pytest.approx(0.4),
            pytest.approx(0.5)]
        a = RetryPolicy(jitter=0.5, seed=3)
        b = RetryPolicy(jitter=0.5, seed=3)
        seq_a = [a.backoff(i) for i in range(4)]
        assert seq_a == [b.backoff(i) for i in range(4)]
        for i, d in enumerate(seq_a):
            base = min(1.0, 0.02 * 2 ** i)
            assert 0.5 * base <= d <= 1.5 * base

    def test_validation(self):
        with pytest.raises(ValueError, match="max_attempts"):
            RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError, match="jitter"):
            RetryPolicy(jitter=1.5)
        with pytest.raises(ValueError, match="delays"):
            RetryPolicy(base_delay_s=-1)


class TestStepWatchdog:
    def test_threshold_and_observation(self):
        with pytest.raises(ValueError, match="threshold"):
            StepWatchdog(0)
        wd = StepWatchdog(0.5)
        assert wd.observe(3, "ragged", 0.1) is False
        assert wd.observe(4, "ragged", 0.9) is True
        assert wd.num_wedged == 1 and wd.wedged == [(4, "ragged", 0.9)]


# ------------------------------------------------------------- aborts --
class TestAbortBattery:
    def test_abort_waiting_request(self, models):
        eng = _port(models)
        rid = eng.add_request([1, 2, 3], max_new_tokens=4)
        assert eng.abort_request(rid) is True
        assert eng.abort_request(rid) is False     # already finished
        assert eng.abort_request(99) is False      # unknown
        outs = _drive(eng)
        assert outs[rid].finish_reason == FinishReason.ABORTED
        assert not outs[rid].ok and outs[rid].output_ids.size == 0
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        assert eng.lifecycle_stats()["aborted"] == 1

    def test_abort_mid_chunked_prefill(self, models):
        eng = _port(models)
        rid = eng.add_request(_prompts(0, (40,))[0], max_new_tokens=4)
        eng.step()                       # one 16-token chunk of 40
        req = eng._requests[rid]
        assert not req.prefill_done and req.num_cached == 16
        assert eng.abort_request(rid) is True
        _drive(eng)
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        eng.scheduler.check_invariants()

    def test_abort_one_decoding_request_survivor_token_exact(self, models):
        prompts = _prompts(1, (5, 7))
        runs = {}
        for name, eng in (("jax", _jax(models)), ("port", _port(models))):
            keep = eng.add_request(prompts[0], max_new_tokens=8)
            kill = eng.add_request(prompts[1], max_new_tokens=8)
            eng.step()                   # prefill both
            eng.step()                   # first decode token
            assert eng._requests[kill].output_ids
            assert eng.abort_request(kill) is True
            runs[name] = (_drive(eng), eng.events)
            assert eng.block_manager.num_free_blocks == eng.num_blocks
        outs, events = runs["port"]
        assert outs[kill].finish_reason == FinishReason.ABORTED
        assert len(outs[kill].output_ids) >= 1
        _same_outputs(outs, runs["jax"][0])
        assert to_records(events) == to_records(runs["jax"][1])

    def test_abort_while_preempted(self):
        bm = BlockManager(num_blocks=8, block_size=4,
                          enable_prefix_caching=False)
        sch = Scheduler(bm, max_batch=2, token_budget=8)
        req = Request(request_id=1, prompt_ids=(1, 2, 3, 4, 5),
                      max_new_tokens=4)
        bm.allocate(1, 5)
        req.status = RUNNING
        req.num_cached = 5
        sch.running.append(req)
        sch._preempt(req)
        assert req.status == WAITING and not bm.has_seq(1)
        assert req.num_preemptions == 1
        assert sch.abort(req) is True
        assert req not in sch.waiting and bm.num_free_blocks == 8
        sch.check_invariants()

    def test_abort_mid_cow_fork(self):
        bm = BlockManager(num_blocks=8, block_size=4,
                          enable_prefix_caching=False)
        sch = Scheduler(bm, max_batch=4, token_budget=8)
        parent = Request(request_id="p", prompt_ids=(1,) * 6,
                         max_new_tokens=1)
        child = Request(request_id="c", prompt_ids=(1,) * 6,
                        max_new_tokens=1)
        bm.allocate("p", 6)
        bm.fork("p", "c")
        _slots, cows = bm.append_slots("c", 3)   # COW copy + fresh page
        assert cows
        for r in (parent, child):
            r.status = RUNNING
            sch.running.append(r)
        free_mid_fork = bm.num_free_blocks
        assert sch.abort(child) is True
        bm.check_invariants()
        # the child's COW copy and fresh page come back; the shared
        # first page only drops a refcount
        assert bm.num_free_blocks == free_mid_fork + 2
        assert bm.num_tokens("p") == 6 and bm.has_seq("p")
        assert sch.abort(parent) is True
        assert bm.num_free_blocks == 8
        bm.check_invariants()

    def test_abort_after_prefix_cache_registration_keeps_cache(self, models):
        prefix = _prompts(2, (16,))[0]                  # 2 pages
        eng = _port(models)
        eng.generate([np.concatenate([prefix, [1, 2]])], max_new_tokens=4)
        cached_before = eng.block_manager.num_cached_blocks
        assert cached_before >= 2
        rid = eng.add_request(np.concatenate([prefix, [3, 4, 5]]),
                              max_new_tokens=4)
        eng.step()                                       # adopts the prefix
        assert eng.scheduler.prefix_hit_tokens >= 16
        assert eng.abort_request(rid) is True
        _drive(eng)
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        assert eng.block_manager.num_cached_blocks >= cached_before
        eng.scheduler.check_invariants()


# ------------------------------------------------ deadlines, shedding --
class TestDeadlinesAndShedding:
    def test_deadline_expires_running_request(self, models):
        runs = {}
        for name, make in (("jax", _jax), ("port", _port)):
            clk = _FakeClock()
            eng = make(models, clock=clk)
            rid = eng.add_request([1, 2, 3], max_new_tokens=30,
                                  deadline_ms=50)
            eng.step()                               # prefill, in budget
            eng.step()
            clk.advance(0.1)                         # blow the deadline
            runs[name] = (_drive(eng), eng.events)
            assert eng.block_manager.num_free_blocks == eng.num_blocks
            assert eng.lifecycle_stats()["deadline_missed"] == 1
        outs = runs["port"][0]
        assert outs[rid].finish_reason == FinishReason.DEADLINE
        assert len(outs[rid].output_ids) < 30
        _same_outputs(outs, runs["jax"][0])
        assert to_records(runs["port"][1]) == to_records(runs["jax"][1])

    def test_deadline_expires_waiting_request(self, models):
        clk = _FakeClock()
        eng = _port(models, clock=clk, max_batch=1)
        first = eng.add_request([1, 2, 3], max_new_tokens=4)
        queued = eng.add_request([4, 5, 6], max_new_tokens=4,
                                 deadline_ms=10)
        clk.advance(1.0)
        outs = _drive(eng)
        assert outs[queued].finish_reason == FinishReason.DEADLINE
        assert outs[queued].output_ids.size == 0
        assert outs[first].ok
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_deadline_validation_up_front(self, models):
        eng = _port(models)
        for bad in (0, -5, True, "soon"):
            with pytest.raises(ValueError, match="deadline_ms"):
                eng.add_request([1, 2], deadline_ms=bad)
            with pytest.raises(ValueError, match="deadline_ms"):
                eng.generate([[1, 2]], deadline_ms=bad)
        assert not eng.has_unfinished()

    def test_queue_depth_sheds_past_max_queue(self, models):
        eng = _port(models, max_queue=2)
        rids = [eng.add_request([1, 2, i], max_new_tokens=4)
                for i in range(4)]
        outs = _drive(eng)
        reasons = [outs[r].finish_reason for r in rids]
        assert reasons == ["length", "length", "shed", "shed"]
        assert eng.lifecycle_stats()["shed"] == 2
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_max_queue_validation(self, models):
        for bad in (0, -1, True, 2.5, "deep"):
            with pytest.raises(ValueError, match="max_queue"):
                _port(models, max_queue=bad)

    def test_drain_completes_everything_and_sheds_newcomers(self, models):
        eng = _port(models)
        rids = [eng.add_request([1, 2, i], max_new_tokens=4)
                for i in range(2)]
        outs = {o.request_id: o for o in eng.drain()}
        assert all(outs[r].finish_reason == "length" for r in rids)
        assert not eng.has_unfinished()
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        again = eng.add_request([5, 6], max_new_tokens=2)
        assert _drive(eng)[again].ok            # admission reopened
        eng._draining = True
        try:
            shed = eng.add_request([7, 8], max_new_tokens=2)
        finally:
            eng._draining = False
        assert _drive(eng)[shed].finish_reason == FinishReason.SHED

    def test_drain_timeout_aborts_stragglers(self, models):
        eng = _port(models)
        rid = eng.add_request([1, 2, 3], max_new_tokens=40)
        outs = {o.request_id: o for o in eng.drain(timeout_s=0.0)}
        assert outs[rid].finish_reason == FinishReason.ABORTED
        assert eng.block_manager.num_free_blocks == eng.num_blocks


# ---------------------------------------------------- step isolation --
def _pools(eng):
    return [t.clone() for t in (eng._k_rows, eng._v_rows)]


class TestStepIsolation:
    def test_transient_fault_absorbed_by_retry_token_exact(self, models):
        prompts = _prompts(3, (5, 7))
        faults = lambda: FaultInjector(schedule=[  # noqa: E731
            Fault("step", "transient", step=2, count=1)])
        want = _jax(models, retry=_FAST_RETRY, faults=faults())
        eng = _port(models, retry=_FAST_RETRY, faults=faults())
        ref = want.generate(prompts, max_new_tokens=8)
        for out, w in zip(eng.generate(prompts, max_new_tokens=8), ref):
            np.testing.assert_array_equal(out, w)
        s = eng.lifecycle_stats()
        assert s["retries"] == 1 and s["quarantined"] == 0
        assert s["step_faults"] == 1
        assert to_records(eng.events) == to_records(want.events)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_raise_fault_quarantines_victim_only(self, models):
        prompts = _prompts(4, (5, 7))
        runs = {}
        for name, make in (("jax", _jax), ("port", _port)):
            eng = make(models, retry=1, faults=FaultInjector(schedule=[
                Fault("step", "raise", step=2, victim=1)]))
            keep = eng.add_request(prompts[0], max_new_tokens=8)
            kill = eng.add_request(prompts[1], max_new_tokens=8)
            with pytest.warns(RuntimeWarning, match="quarantin"):
                runs[name] = (_drive(eng), eng.events)
            assert eng.lifecycle_stats()["quarantined"] == 1
            assert eng.block_manager.num_free_blocks == eng.num_blocks
        outs = runs["port"][0]
        assert outs[kill].finish_reason == FinishReason.ERROR
        assert "injected raise" in outs[kill].error
        assert outs[keep].ok
        _same_outputs(outs, runs["jax"][0])
        assert to_records(runs["port"][1]) == to_records(runs["jax"][1])

    def test_injected_fault_leaves_pools_as_committed(self, models):
        """A quarantined step wrote nothing: the pools after it are
        bitwise the pools the previous step committed."""
        eng = _port(models, retry=2, faults=FaultInjector(schedule=[
            Fault("step", "raise", step=2, victim=0)]))
        eng.add_request(_prompts(5, (6,))[0], max_new_tokens=8)
        eng.add_request(_prompts(6, (9,))[0], max_new_tokens=8)
        eng.step()
        eng.step()
        before = _pools(eng)
        with pytest.warns(RuntimeWarning, match="quarantin"):
            eng.step()
        assert eng.lifecycle_stats()["retries"] == 1
        for a, b in zip(before, _pools(eng)):
            assert torch.equal(a, b)
        _drive(eng)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_delay_fault_trips_watchdog(self, models):
        prompt = np.arange(1, 6, dtype=np.int32)
        ref = _port(models).generate([prompt], max_new_tokens=4)[0]
        eng = _port(models, step_timeout_s=0.01,
                    faults=FaultInjector(schedule=[
                        Fault("step", "delay", step=1, delay_s=0.05)]))
        np.testing.assert_array_equal(
            eng.generate([prompt], max_new_tokens=4)[0], ref)
        assert eng.watchdog.num_wedged >= 1
        assert eng.lifecycle_stats()["wedged_steps"] >= 1

    @pytest.mark.parametrize("lengths,new", [((5, 7), 8), ((7,), 6)],
                             ids=["two_sequences", "single_self_preempts"])
    def test_injected_oom_forces_preemption_token_exact(self, models,
                                                        lengths, new):
        prompts = _prompts(5, lengths)
        want = _jax(models, faults=FaultInjector(schedule=[
            Fault("alloc", "oom", step=2)]))
        eng = _port(models, faults=FaultInjector(schedule=[
            Fault("alloc", "oom", step=2)]))
        ref = want.generate(prompts, max_new_tokens=new)
        for out, w in zip(eng.generate(prompts, max_new_tokens=new), ref):
            np.testing.assert_array_equal(out, w)
        assert eng.scheduler.num_preemptions >= 1
        assert to_records(eng.events) == to_records(want.events)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_failure_after_first_pool_write_is_pool_lost(self, models):
        eng = _port(models, retry=3)
        eng.add_request([1, 2, 3], max_new_tokens=4)
        eng.step()                                 # prefill fine
        body = eng._ragged_body

        def fail_after_writes(ints):
            body(ints)                             # the pools are written
            raise RuntimeError("planted failure inside the step")

        eng._ragged_body = fail_after_writes
        with pytest.raises(PoolLostError, match="in place"):
            eng.step()
        assert eng.lifecycle_stats()["retries"] == 0

    @pytest.mark.parametrize("retry,failures", [(3, 1), (1, 1)],
                             ids=["retried", "quarantined"])
    def test_failure_while_staging_is_isolated(self, models, retry,
                                               failures):
        prompt = _prompts(7, (6,))[0]
        ref = _port(models).generate([prompt], max_new_tokens=5)[0]
        eng = _port(models, retry=retry)
        rid = eng.add_request(prompt, max_new_tokens=5)
        eng.step()
        before = _pools(eng)
        stage, left = eng._stage, [failures]

        def flaky(pk):
            if left[0]:
                left[0] -= 1
                raise RuntimeError("planted staging failure")
            return stage(pk)

        eng._stage = flaky
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = _drive(eng)
        s = eng.lifecycle_stats()
        assert s["step_faults"] == 1
        if retry > 1:
            assert s["retries"] == 1 and not caught
            np.testing.assert_array_equal(outs[rid].all_ids, ref)
        else:
            assert s["quarantined"] == 1 and caught
            assert outs[rid].finish_reason == FinishReason.ERROR
            assert "planted staging failure" in outs[rid].error
            for a, b in zip(before, _pools(eng)):
                assert torch.equal(a, b)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_retry_backoff_sleeps_are_bounded(self, models):
        eng = _port(models, retry={"max_attempts": 3, "base_delay_s": 0.001,
                                   "jitter": 0.0},
                    faults=FaultInjector(schedule=[
                        Fault("step", "transient", step=1, count=2)]))
        eng.add_request([1, 2, 3], max_new_tokens=2)
        t0 = time.monotonic()
        _drive(eng)
        assert time.monotonic() - t0 < 30
        assert eng.lifecycle_stats()["retries"] == 2


# ----------------------------------------------- event-log determinism --
class TestEventLogDeterminism:
    """Same fault seed -> identical event logs, on the port twice and
    on the port against the JAX engine."""

    @staticmethod
    def _run(make, models, prompts, seed):
        fi = FaultInjector.random(seed, steps=64, p_transient=0.15,
                                  p_oom=0.1, p_abort=0.08)
        eng = make(models, faults=fi, retry=_FAST_RETRY)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        outs = _drive(eng, faults=fi)
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        return eng, fi, outs

    def test_same_seed_identical_event_logs(self, models):
        prompts = _prompts(6, (4, 9, 6))
        eng_a, fi_a, outs_a = self._run(_port, models, prompts, seed=11)
        eng_b, fi_b, outs_b = self._run(_port, models, prompts, seed=11)
        eng_j, fi_j, outs_j = self._run(_jax, models, prompts, seed=11)
        assert fi_a.events == fi_b.events == fi_j.events and fi_a.events
        assert eng_a.events == eng_b.events
        assert to_records(eng_a.events) == to_records(eng_j.events)
        _same_outputs(outs_a, outs_b)
        _same_outputs(outs_a, outs_j)

    def test_chaos_smoke_survivors_token_exact(self, models):
        prompts = _prompts(7, (4, 9, 6))
        refs = _jax(models).generate(prompts, max_new_tokens=8)
        eng, fi, outs = self._run(_port, models, prompts, seed=11)
        assert fi.events
        for rid, ref in zip(sorted(outs), refs):
            got = outs[rid].all_ids
            if outs[rid].ok:
                np.testing.assert_array_equal(got, ref)
            else:         # a casualty emitted a prefix of the reference
                np.testing.assert_array_equal(got, ref[:len(got)])
        assert eng.lifecycle_stats()["shed"] == 0


# ------------------------------------------------------------- gauges --
class TestLifecycleGauges:
    def test_gauges_track_a_scripted_workload_exactly(self, models):
        eng = _port(models, max_batch=2, record_step_gauges=True)
        total = eng.num_blocks

        def gauges():
            ls = eng.lifecycle_stats()
            return (ls["queue_depth"], ls["inflight"], ls["free_pages"],
                    ls["last_step_ms"])

        assert gauges() == (0, 0, total, None)
        assert eng.lifecycle_stats()["host_overhead_fraction"] is None
        for toks, n in (([1] * 4, 3), ([2] * 5, 3), ([3] * 3, 3)):
            eng.add_request(toks, max_new_tokens=n)
        assert gauges() == (3, 0, total, None)
        eng.step()      # admits exactly max_batch=2; the third waits
        q, infl, free, ms = gauges()
        assert (q, infl, free) == (1, 2, total - 2)
        assert isinstance(ms, float) and ms > 0.0
        eng.step()
        assert gauges()[:3] == (1, 2, total - 2)
        while eng.has_unfinished():
            eng.step()
        assert gauges()[:3] == (0, 0, total)
        ls = eng.lifecycle_stats()
        assert 0.0 < ls["host_overhead_fraction"] < 1.0
        steps = ls["step_gauges"]
        assert [g["step"] for g in steps] == list(range(len(steps)))
        assert steps[0]["inflight"] == 2 and steps[-1]["free_pages"] == total


# ------------------------------------------------------ async lifecycle --
class _WedgedStubEngine:
    """step() blocks until released — probes close()'s join timeout."""

    def __init__(self):
        self.release = threading.Event()
        self._requests = {}

    def add_request(self, prompt_ids, **kwargs):
        self._requests[0] = None
        return 0

    def abort_request(self, rid):
        self._requests.pop(rid, None)
        return True

    def has_unfinished(self):
        return bool(self._requests)

    def step(self):
        self.release.wait(timeout=60)
        self._requests.clear()
        return []


class TestAsyncLifecycle:
    def test_abort_delivers_aborted_output(self, models):
        eng = _port(models)
        a = AsyncLLMEngine(eng)
        try:
            rid = a.submit([1, 2, 3], max_new_tokens=50)
            a.abort(rid)
            out = a.result(rid, timeout=120)
            assert out.finish_reason in (FinishReason.ABORTED, "length")
        finally:
            a.close(join_timeout=120)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_result_timeout_aborts_the_request(self, models):
        eng = _port(models)
        a = AsyncLLMEngine(eng)
        try:
            rid = a.submit([1, 2, 3], max_new_tokens=50)
            with pytest.raises(TimeoutError, match="aborted"):
                a.result(rid, timeout=0.01)
            deadline = time.monotonic() + 120
            while eng.has_unfinished() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert not eng.has_unfinished()
            assert rid not in a._results           # output discarded
        finally:
            a.close(join_timeout=120)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_close_aborts_pending_and_recovers_pages(self, models):
        eng = _port(models)
        a = AsyncLLMEngine(eng)
        rids = [a.submit([1, 2, i], max_new_tokens=50) for i in range(3)]
        a.close(join_timeout=120)
        assert not eng.has_unfinished()
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        for rid in rids:
            assert a.result(rid, timeout=1).finish_reason in ("aborted",
                                                              "length")
        with pytest.raises(RuntimeError, match="stopped"):
            a.submit([9, 9])

    def test_submit_racing_drain_gets_terminal_result(self, models):
        eng = _port(models)
        a = AsyncLLMEngine(eng)
        try:
            r1 = a.submit([1, 2, 3], max_new_tokens=40)
            t = threading.Thread(target=a.drain)
            t.start()
            deadline = time.monotonic() + 30
            while not a._draining and time.monotonic() < deadline:
                time.sleep(0.001)
            assert a._draining
            r2 = a.submit([4, 5, 6], max_new_tokens=4)
            assert a.result(r2, timeout=120).finish_reason == \
                FinishReason.SHED
            assert a.result(r1, timeout=120).ok
            t.join(timeout=120)
            assert not t.is_alive()
            assert a.generate([7, 8, 9], max_new_tokens=3, timeout=120).ok
        finally:
            a.close(join_timeout=120)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_drain_timeout_aborts_stragglers_async(self, models):
        eng = _port(models)
        a = AsyncLLMEngine(eng)
        try:
            rid = a.submit([1, 2, 3], max_new_tokens=50)
            a.drain(timeout_s=0.01)
            assert a.result(rid, timeout=120).finish_reason in ("aborted",
                                                                "length")
            assert not a._draining
        finally:
            a.close(join_timeout=120)
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_close_raises_when_worker_wedges(self):
        stub = _WedgedStubEngine()
        a = AsyncLLMEngine(stub)
        a.submit([1])
        time.sleep(0.2)                    # the loop is inside step()
        try:
            with pytest.warns(RuntimeWarning, match="survived"):
                with pytest.raises(RuntimeError, match="failed to stop"):
                    a.close(join_timeout=0.2)
        finally:
            stub.release.set()
            a._thread.join(timeout=10)
        assert not a._thread.is_alive()
