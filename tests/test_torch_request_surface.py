"""The port's request surface against the JAX package's.

The non-speculative cases of ``tests/test_request_surface.py`` on the
port: the host helpers (stop-string watcher, ``top_logprobs``, the
copied ``structured.py``), up-front validation, and the engine's
surface — top-k 1 against greedy, a forcing logit bias, logprobs in a
mixed batch, a stop string straddling a detokenization boundary,
grammar-constrained decoding against a host masked-greedy reference on
the dense forward, and an ``n=3`` fork family against its seeded
replays.  Each engine case also runs on the JAX ``LLMEngine`` with the
same weights and settings: outputs, finish reasons, ``matched_stop``
and the event records must be equal, logprobs within 1e-5 (f32).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    FILTERED,
    ConstraintState,
    DfaTokenGrammar,
    LLMEngine,
    StopStringWatcher,
    grammar_from_spec,
    json_array_grammar,
    to_records,
    top_logprobs,
    validate_sampling,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

TINY = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)


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


def _engines(models, **kw):
    """(JAX engine, port engine) at the same settings."""
    kw = {**TINY, **kw}
    return (JaxEngine(models[0], **kw),
            LLMEngine(models[1], device="cpu", **kw))


def _serve(eng, requests):
    """Queue ``(prompt, kwargs)`` requests, step to the end ->
    {rid: output}."""
    for p, kw in requests:
        eng.add_request(p, **kw)
    outs = {}
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.request_id] = fo
    return outs


def _assert_same(got, want, jax_eng=None, port_eng=None):
    assert got.keys() == want.keys()
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.output_ids, w.output_ids)
        assert (g.finish_reason, g.matched_stop) == (w.finish_reason,
                                                     w.matched_stop)
        assert (g.logprobs is None) == (w.logprobs is None)
        for (g_lp, g_top), (w_lp, w_top) in zip(g.logprobs or (),
                                                w.logprobs or ()):
            assert [t for t, _ in g_top] == [t for t, _ in w_top]
            np.testing.assert_allclose(
                [g_lp] + [lp for _, lp in g_top],
                [w_lp] + [lp for _, lp in w_top], atol=1e-5, rtol=0)
    if jax_eng is not None:
        assert to_records(port_eng.events) == to_records(jax_eng.events)


def _demo_grammar(vocab_size=128):
    return json_array_grammar(vocab_size, open_id=10, close_id=11,
                              comma_id=12, item_ids=(20, 21, 22),
                              eos_id=1, max_items=4)


# -------------------------------------------------------- validation --
class TestValidation:
    def test_each_bad_parameter_raises(self):
        def v(**kw):
            base = dict(top_k=0, top_p=1.0, min_p=0.0,
                        repetition_penalty=1.0, presence_penalty=0.0,
                        frequency_penalty=0.0, logit_bias=None,
                        logprobs=0, stop=None, n=1, vocab_size=128)
            base.update(kw)
            return validate_sampling(**base)

        v()
        for bad in (dict(logprobs=-1), dict(logprobs=True),
                    dict(logprobs=129), dict(stop=""),
                    dict(stop=("ok", "")), dict(n=0), dict(n=True)):
            with pytest.raises(ValueError):
                v(**bad)
        bias, stop = v(logit_bias={"7": 2}, stop="END")
        assert bias == {7: 2.0} and stop == ("END",)

    def test_engine_gates_up_front_and_stays_empty(self, models):
        eng = _engines(models)[1]
        p = np.arange(4, dtype=np.int32)
        with pytest.raises(ValueError, match="top_p"):
            eng.add_request(p, top_p=0.0)
        with pytest.raises(ValueError, match="detokenizer"):
            eng.add_request(p, stop="END")    # no detokenizer wired
        with pytest.raises(ValueError, match="seed"):
            eng.add_request(p, n=2)           # n > 1 needs a seed
        with pytest.raises(ValueError, match="max_batch"):
            eng.add_request(p, n=99, seed=0)
        with pytest.raises(ValueError, match="grammar"):
            eng.add_request(p, grammar=object())
        with pytest.raises(ValueError, match="logit_bias"):
            eng.generate([p], logit_bias={999: 1.0})
        with pytest.raises(ValueError, match="detokenizer"):
            LLMEngine(models[1], device="cpu", detokenizer="abc", **TINY)
        assert not eng.has_unfinished()


# ------------------------------------------------------- host helpers --
class TestHostHelpers:
    def test_stop_watcher_matches_across_token_boundary(self):
        pieces = {20: "ab", 21: "cd", 22: "ef"}
        w = StopStringWatcher(("bc",),
                              lambda ids: "".join(pieces[i] for i in ids))
        assert w.check([20]) is None
        assert w.check([20, 21]) == "bc"          # only in the joint text
        assert w.check([22] * 12 + [20, 21]) == "bc"
        assert w.check([22, 22, 22]) is None

    def test_top_logprobs_deterministic_and_normalized(self):
        row = np.array([2.0, 1.0, 2.0, 0.0], np.float64)
        chosen_lp, alts = top_logprobs(row, 3, chosen=2)
        assert [t for t, _ in alts] == [0, 2, 1]   # tie 0 vs 2 -> lower id
        assert np.isclose(
            sum(np.exp(lp) for _, lp in top_logprobs(row, 4, 0)[1]), 1.0)
        assert np.isclose(chosen_lp, dict(alts)[2])

    def test_grammar_spec_roundtrip_and_legality(self):
        g = _demo_grammar()
        assert grammar_from_spec(g.to_spec()).transitions == g.transitions
        g3 = grammar_from_spec(
            {"kind": "json_array", "open": 10, "close": 11,
             "comma": 12, "items": [20, 21, 22], "eos": 1,
             "max_items": 4}, vocab_size=128)
        assert g3.transitions == g.transitions
        with pytest.raises(ValueError, match="kind"):
            grammar_from_spec({"transitions": {}})
        cs = ConstraintState(g)
        assert [bool(x) for x in g.allowed(0)[[10, 11, 20]]] \
            == [True, False, False]
        cs.advance(10)
        with pytest.raises(RuntimeError, match="no transition"):
            cs.advance(11)
        assert cs.peek([20, 12, 21]) == [2, 3, 4]
        assert cs.peek([11, 20])[-1] is None
        row = np.zeros(128, np.float32)
        cs.bias_row(row)
        assert row[20] == 0.0 and row[10] == FILTERED


# ------------------------------------------------------ engine surface --
def _masked_greedy_reference(model, prompt, grammar, max_new, eos_id):
    """Host reference on the port's dense forward: mask the current
    grammar state's disallowed tokens to FILTERED, argmax, advance."""
    ids, state, out = list(prompt), grammar.start_state(), []
    for _ in range(max_new):
        with torch.no_grad():
            row = model(torch.as_tensor([ids]))[0, -1].double().numpy()
        row[~grammar.allowed(state)] = FILTERED
        tok = int(row.argmax())
        out.append(tok)
        state = grammar.advance(state, tok)
        if tok == eos_id:
            break
        ids.append(tok)
    return out


class TestEngineRequestSurface:
    def test_top_k1_is_greedy_and_bias_forces_tokens(self, models):
        p = np.random.RandomState(0).randint(0, 128, (6,)).astype(np.int32)
        for eng in _engines(models):
            greedy = eng.generate([p], max_new_tokens=6)[0]
            topk1 = eng.generate([p], max_new_tokens=6, temperature=1.0,
                                 top_k=1, seed=7)[0]
            np.testing.assert_array_equal(greedy, topk1)
            forced = eng.generate([p], max_new_tokens=4,
                                  logit_bias={42: 1e9})[0]
            np.testing.assert_array_equal(forced[len(p):], [42] * 4)
            assert eng.block_manager.num_free_blocks == eng.num_blocks
        jax_eng, port_eng = _engines(models)
        np.testing.assert_array_equal(
            port_eng.generate([p], max_new_tokens=6)[0],
            jax_eng.generate([p], max_new_tokens=6)[0])

    def test_logprobs_in_a_mixed_batch_match_jax(self, models):
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
                   for n in (4, 6, 5, 23)]
        requests = [(prompts[0], dict(max_new_tokens=5, logprobs=3)),
                    (prompts[1], dict(max_new_tokens=5, temperature=0.8,
                                      top_p=0.9, seed=3, logprobs=2)),
                    (prompts[2], dict(max_new_tokens=5)),
                    (prompts[3], dict(max_new_tokens=5, logprobs=4,
                                      repetition_penalty=1.3))]
        jax_eng, port_eng = _engines(models)
        want = _serve(jax_eng, requests)
        got = _serve(port_eng, requests)
        _assert_same(got, want, jax_eng, port_eng)
        for rid, n in ((0, 3), (1, 2), (3, 4)):
            fo = got[rid]
            assert len(fo.logprobs) == len(fo.output_ids)
            for tok, (chosen_lp, alts) in zip(fo.output_ids, fo.logprobs):
                assert chosen_lp <= 0.0 and len(alts) == n
                lps = [lp for _, lp in alts]
                assert lps == sorted(lps, reverse=True)
                if rid != 1:        # greedy: the chosen token leads
                    assert alts[0][0] == int(tok)
        assert got[2].logprobs is None

    def test_stop_string_straddles_detokenization_boundary(self, models):
        pieces = {20: "ab", 21: "cd", 22: "ef", 1: ""}

        def detok(ids):
            return "".join(pieces.get(int(i), "?") for i in ids)

        g = DfaTokenGrammar(128, {0: {20: 1}, 1: {21: 2}, 2: {22: 3},
                                  3: {1: 4}, 4: {1: 4}})
        requests = [(np.arange(5, dtype=np.int32),
                     dict(max_new_tokens=8, grammar=g, eos_token_id=1,
                          stop=("bc",)))]
        jax_eng, port_eng = _engines(models, detokenizer=detok)
        got = _serve(port_eng, requests)
        _assert_same(got, _serve(jax_eng, requests), jax_eng, port_eng)
        fo = got[0]
        assert fo.finish_reason == "stop" and fo.matched_stop == "bc"
        np.testing.assert_array_equal(fo.output_ids, [20, 21])
        assert port_eng.block_manager.num_free_blocks == port_eng.num_blocks

    def test_constrained_exact_vs_host_masked_greedy(self, models):
        g = _demo_grammar()
        # two full pages of prompt, so the rerun adopts cached pages
        p = np.random.RandomState(2).randint(0, 128, (18,)).astype(np.int32)
        ref = _masked_greedy_reference(models[1], p, g, 12, eos_id=1)
        jax_eng, eng = _engines(models)
        kw = dict(max_new_tokens=12, grammar=g, eos_token_id=1)
        out = eng.generate([p], **kw)[0]
        np.testing.assert_array_equal(out[len(p):], ref)
        np.testing.assert_array_equal(out, jax_eng.generate([p], **kw)[0])
        s = g.start_state()
        for t in ref:
            s = g.advance(s, int(t))
            assert s is not None
        np.testing.assert_array_equal(eng.generate([p], **kw)[0], out)
        assert eng.prefix_cache_stats()["prefix_hit_tokens"] > 0
        assert eng.block_manager.num_free_blocks == eng.num_blocks

    def test_fork_family_bitwise_equals_seeded_replays(self, models):
        p = np.random.RandomState(3).randint(0, 128, (6,)).astype(np.int32)
        kw = dict(max_new_tokens=10, temperature=0.9, seed=50, n=3)
        # tight pool: 3 members x 2 pages > 4 pages -> the family
        # preempts and recomputes mid-flight
        jax_eng, eng = _engines(models, num_blocks=4, max_batch=3,
                                max_model_len=24)
        fam = eng.generate([p], **kw)[0]
        assert len(fam) == 3
        assert eng.scheduler.num_preemptions > 0
        assert [e[1] for e in eng.events].count("fork") == 2
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        assert not all(np.array_equal(fam[0], f) for f in fam[1:])
        for a, b in zip(fam, jax_eng.generate([p], **kw)[0]):
            np.testing.assert_array_equal(a, b)
        assert to_records(eng.events) == to_records(jax_eng.events)
        replay = LLMEngine(models[1], device="cpu",
                           **{**TINY, "max_model_len": 24})
        outs = _serve(replay, [(p, dict(max_new_tokens=10, temperature=0.9,
                                        seed=50 + k)) for k in range(3)])
        for member, rid in zip(fam, range(3)):
            np.testing.assert_array_equal(member, outs[rid].all_ids)

    def test_mixed_surface_batch_matches_jax(self, models):
        rng = np.random.RandomState(4)
        prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
                   for n in (4, 7, 5, 6)]
        requests = [
            (prompts[0], dict(max_new_tokens=6)),
            (prompts[1], dict(max_new_tokens=6, temperature=0.8, top_k=20,
                              top_p=0.9, min_p=0.05,
                              repetition_penalty=1.2, presence_penalty=0.3,
                              frequency_penalty=0.2, logit_bias={9: -2.0},
                              logprobs=2, seed=9)),
            (prompts[2], dict(max_new_tokens=10, grammar=_demo_grammar(),
                              eos_token_id=1)),
            (prompts[3], dict(max_new_tokens=6, temperature=0.7, seed=11,
                              n=2))]
        jax_eng, port_eng = _engines(models)
        port_eng.warmup()
        got = _serve(port_eng, requests)
        assert len(got) == 5 and all(fo.ok for fo in got.values())
        assert "3.1" in got
        _assert_same(got, _serve(jax_eng, requests), jax_eng, port_eng)
        assert port_eng.block_manager.num_free_blocks == port_eng.num_blocks
