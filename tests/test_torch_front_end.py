"""The port's serving front end: ``AsyncLLMEngine`` under the seeded
interleaving harness, and ``HttpLLMServer``.

The interleaving cases of ``tests/test_interleaving.py`` that need
neither lookahead nor a fleet, on the port's engine (``lookahead`` is
off on both sides): every explored schedule must produce exactly the
greedy streams of the port's synchronous engine and of the JAX
``LLMEngine`` on the same weights, leak no page, and replay from its
seed; a planted abort-vs-step race must leak on some seed,
reproducibly, and the real engine on none.  The clock-injection and
gauge-lock regressions ride along.  Then the HTTP/SSE server over a
port engine: the full request surface with ``n=2`` and ``/healthz``,
SSE deltas that reassemble the final ids, greedy output equal to the
engine's own, 400s before admission, exactly one backend, and
``fleet=`` not ported yet.
"""

import http.client
import json
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    AsyncLLMEngine,
    Fault,
    FaultInjector,
    FinishReason,
    HttpLLMServer,
    InterleavingScheduler,
    LLMEngine,
    Request,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 10, 11, 12, 13]]
ENGINE = dict(num_blocks=64, block_size=8, max_batch=4, max_model_len=64,
              token_budget=16)


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


def _port(models, cls=LLMEngine, **kw):
    return cls(models[1], device="cpu", **{**ENGINE, **kw})


def _sync_tokens(eng, max_new=8):
    """Greedy streams of a synchronous engine over PROMPTS, sorted."""
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in PROMPTS]
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    return sorted(tuple(int(t) for t in outs[r].output_ids) for r in rids)


@pytest.fixture(scope="module")
def sync_ref(models):
    want = _sync_tokens(JaxEngine(models[0], lookahead=False, **ENGINE))
    assert _sync_tokens(_port(models)) == want
    return want


def _drive_schedule(models, seed, cls=LLMEngine, max_new=8):
    """One seeded schedule: submit PROMPTS from an actor, collect the
    results -> (schedule_log, free blocks, sorted token tuples)."""
    eng = _port(models, cls)
    aeng = AsyncLLMEngine(eng)
    sched = InterleavingScheduler(seed=seed, adopt=("llm-async-worker",))
    got = []

    def submitter():
        rids = [aeng.submit(p, max_new_tokens=max_new) for p in PROMPTS]
        for r in rids:
            got.append(tuple(int(t) for t in aeng.result(r).output_ids))

    sched.spawn("submitter", submitter)
    log = sched.run(expect_adopted=1)
    aeng.close()
    return list(log), eng.block_manager.num_free_blocks, sorted(got)


# ----------------------------------------------- seeded interleavings --
class TestScheduleInvariants:
    def test_schedules_token_exact_no_leaks(self, models, sync_ref):
        for seed in range(6):
            log, free, toks = _drive_schedule(models, seed)
            assert toks == sync_ref, f"seed={seed} diverged"
            assert free == 64, f"seed={seed} leaked {64 - free} page(s)"
            assert len(log) > 10, "schedule did not interleave"

    def test_seeds_explore_different_interleavings(self, models):
        assert _drive_schedule(models, 0)[0] != \
            _drive_schedule(models, 1)[0]

    @pytest.mark.parametrize("seed", [0, 42])
    def test_replay_identical(self, models, seed):
        assert _drive_schedule(models, seed) == \
            _drive_schedule(models, seed)

    def test_submit_vs_drain(self, models):
        eng = _port(models)
        aeng = AsyncLLMEngine(eng)
        sched = InterleavingScheduler(seed=3, adopt=("llm-async-worker",))
        rids = []

        def submitter():
            for p in PROMPTS:
                rids.append(aeng.submit(p, max_new_tokens=6))

        sched.spawn("submitter", submitter)
        sched.spawn("drainer", lambda: aeng.drain(timeout_s=30))
        sched.run(expect_adopted=1)
        outs = [aeng.result(r, timeout=60) for r in rids]
        aeng.close()
        assert eng.block_manager.num_free_blocks == 64
        for o in outs:
            assert o.finish_reason in ("length", "stop", "shed", "aborted")


def test_many_submitters_under_a_short_switch_interval(models):
    """16 threads submit, abort and wait on one AsyncLLMEngine while the
    interpreter switches threads every 10 µs: every request id is
    unique, every result terminal, the greedy ones equal to the sync
    engine's, and no page leaks."""
    want = {tuple(p): tuple(int(t) for t in o[len(p):]) for p, o in zip(
        PROMPTS, _port(models).generate(PROMPTS, max_new_tokens=4))}
    eng = _port(models)
    aeng = AsyncLLMEngine(eng)
    got, errors = [], []

    def client(i):
        try:
            p = PROMPTS[i % len(PROMPTS)]
            rid = aeng.submit(p, max_new_tokens=4)
            if i % 5 == 4:
                aeng.abort(rid)
            got.append((i, rid, tuple(p), aeng.result(rid, timeout=120)))
        except Exception as e:      # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        aeng.close(join_timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len({rid for _, rid, _, _ in got}) == len(got) == 16
    for i, _rid, p, out in got:
        assert out.finish_reason in (("length", "aborted") if i % 5 == 4
                                     else ("length",))
        if out.finish_reason == "length":
            assert tuple(int(t) for t in out.output_ids) == want[p]
    assert eng.block_manager.num_free_blocks == eng.num_blocks


class LeakyAbortEngine(LLMEngine):
    """Planted bug: aborting a running request forgets to free its
    pages — visible only on schedules where the abort lands after the
    request was scheduled."""

    def abort_request(self, request_id):
        req = self._requests.get(request_id)
        if req is not None and req in self.scheduler.running:
            self.scheduler.running.remove(req)
            self._invalidate_plan()
            self._finish_early(req, FinishReason.ABORTED)
            return True
        return super().abort_request(request_id)


class TestInjectedRace:
    @staticmethod
    def _abort_run(models, seed, cls):
        eng = _port(models, cls)
        aeng = AsyncLLMEngine(eng)
        sched = InterleavingScheduler(seed=seed,
                                      adopt=("llm-async-worker",))

        def submitter():
            rids = [aeng.submit(p, max_new_tokens=8) for p in PROMPTS]
            aeng.abort(rids[1])
            for r in rids:
                aeng.result(r)

        sched.spawn("submitter", submitter)
        sched.run(expect_adopted=1)
        aeng.close()
        return 64 - eng.block_manager.num_free_blocks

    def test_race_found_and_reproduced_from_seed(self, models):
        leaks = {seed: self._abort_run(models, seed, LeakyAbortEngine)
                 for seed in range(4)}
        assert any(v > 0 for v in leaks.values()), leaks
        seed = min(s for s, v in leaks.items() if v > 0)
        assert self._abort_run(models, seed, LeakyAbortEngine) == leaks[seed]

    def test_control_engine_never_leaks(self, models):
        for seed in range(2):
            assert self._abort_run(models, seed, LLMEngine) == 0


class TestClockInjectionRegressions:
    class _Tick:
        """A clock that jumps +10 s per reading."""

        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 10.0
            return self.t

    def test_async_result_timeout_uses_engine_clock(self):
        tick = self._Tick()

        class StubEngine:
            _clock = tick

            def has_unfinished(self):
                return False

            def step(self):
                return []

        a = AsyncLLMEngine(StubEngine())
        try:
            with pytest.raises(TimeoutError):
                a.result("nope", timeout=5.0)
        finally:
            a.stop()

    def test_async_drain_deadline_uses_engine_clock(self, models):
        eng = _port(models)
        tick = self._Tick()
        eng._clock = tick
        a = AsyncLLMEngine(eng)
        try:
            before = tick.t
            a.drain(timeout_s=500.0)
            assert tick.t > before
        finally:
            a.stop()

    def test_request_has_no_wall_clock_default(self):
        r = Request(request_id="r0", prompt_ids=(1, 2, 3),
                    max_new_tokens=4)
        assert r.arrival_time == -1.0

    def test_engine_rebinding_covers_injector(self, models):
        fi = FaultInjector([Fault("step", "delay", step=0, delay_s=1.0)])
        eng = _port(models, faults=fi)
        assert fi.sleep is eng._sleep

    def test_gauges_written_under_lock_during_step(self, models):
        eng = _port(models)
        eng.add_request(PROMPTS[0], max_new_tokens=2)
        seen, real_lock = [], eng._gauge_lock

        class Spy:
            def __enter__(self):
                seen.append("acquire")
                return real_lock.__enter__()

            def __exit__(self, *exc):
                return real_lock.__exit__(*exc)

        eng._gauge_lock = Spy()
        while eng.has_unfinished():
            eng.step()
        eng._gauge_lock = real_lock
        assert seen
        assert eng.lifecycle_stats()["last_step_ms"] >= 0.0


# ----------------------------------------------------------- HTTP/SSE --
def _post(addr, body, stream=False):
    host, port = addr
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if not stream:
            return resp.status, json.loads(resp.read())
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        events = []
        for chunk in resp.read().decode().split("\n\n"):
            if chunk.startswith("data: "):
                data = chunk[len("data: "):]
                events.append(data if data == "[DONE]"
                              else json.loads(data))
        return resp.status, events
    finally:
        conn.close()


def _grammar_spec():
    return {"kind": "json_array", "open": 10, "close": 11, "comma": 12,
            "items": [20, 21, 22], "eos": 1, "max_items": 3}


class TestHttpEngineBackend:
    def test_full_surface_n2_stream_and_healthz(self, models):
        p = [int(t) for t in np.random.RandomState(0).randint(0, 128, (6,))]
        want = _port(models).generate([p], max_new_tokens=6)[0][len(p):]
        eng = _port(models)
        srv = HttpLLMServer(engine=eng).start()
        try:
            status, body = _post(srv.address, {
                "prompt_ids": p, "max_new_tokens": 6,
                "temperature": 0.8, "top_k": 30, "top_p": 0.9,
                "min_p": 0.01, "repetition_penalty": 1.1,
                "presence_penalty": 0.2, "frequency_penalty": 0.1,
                "logit_bias": {"9": -1.0}, "logprobs": 2, "seed": 5,
                "n": 2})
            assert status == 200
            comps = body["completions"]
            assert [c["index"] for c in comps] == [0, 1]
            assert comps[1]["request_id"].endswith(".1")
            for c in comps:
                assert c["finish_reason"] == "length"
                assert len(c["output_ids"]) == 6
                assert len(c["logprobs"]) == 6
                assert all(len(t["top"]) == 2 for t in c["logprobs"])
            status, body = _post(srv.address, {
                "prompt_ids": p, "max_new_tokens": 10,
                "eos_token_id": 1, "grammar": _grammar_spec()})
            assert status == 200
            out = body["completions"][0]["output_ids"]
            assert out[0] == 10 and out[-1] == 1
            assert set(out) <= {10, 11, 12, 20, 21, 22, 1}
            # greedy through the wire is the engine's own greedy output
            status, body = _post(srv.address, {"prompt_ids": p,
                                               "max_new_tokens": 6})
            assert body["completions"][0]["output_ids"] == want.tolist()
            status, events = _post(srv.address, {
                "prompt_ids": p, "max_new_tokens": 8, "temperature": 0.7,
                "top_p": 0.95, "seed": 3, "stream": True}, stream=True)
            assert events[-1] == "[DONE]"
            final = events[-2]["completions"][0]
            assert final["finish_reason"] == "length"
            assert [t for e in events[:-2] for t in e["delta_ids"]] \
                == final["output_ids"]

            host, port = srv.address
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            health = json.loads(resp.read())
            conn.close()
            assert resp.status == 200
            assert health["inflight"] == 0 and health["shed"] == 0
            assert health["free_pages"] == eng.num_blocks
        finally:
            srv.close()
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_bad_requests_are_400_before_admission(self, models):
        eng = _port(models, max_batch=2)
        srv = HttpLLMServer(engine=eng).start()
        try:
            p = [1, 2, 3]
            for body, frag in (
                    ({"prompt_ids": p, "tempreature": 1.0}, "unknown"),
                    ({"max_new_tokens": 4}, "prompt_ids"),
                    ({"prompt_ids": p, "top_p": 0.0}, "top_p"),
                    ({"prompt_ids": p, "n": 2}, "seed"),
                    ({"prompt_ids": p, "logit_bias": {"999": 1}},
                     "vocab"),
                    ({"prompt_ids": p, "stop": "END"}, "detokenizer"),
                    ({"prompt_ids": p, "adapter": "t1"}, "adapter"),
                    ({"prompt_ids": p,
                      "grammar": {"kind": "regex"}}, "kind")):
                status, resp = _post(srv.address, body)
                assert status == 400, body
                assert frag in resp["error"], resp
            assert not eng.has_unfinished()
            assert eng.events == []               # nothing was admitted
        finally:
            srv.close()

    def test_exactly_one_backend_and_no_fleet_yet(self, models):
        with pytest.raises(ValueError, match="exactly one"):
            HttpLLMServer()
        eng = _port(models)
        with pytest.raises(ValueError, match="exactly one"):
            HttpLLMServer(engine=eng, fleet=object())
        with pytest.raises(NotImplementedError, match="not ported yet"):
            HttpLLMServer(fleet=object())
