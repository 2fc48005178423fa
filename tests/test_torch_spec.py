"""The port's n-gram speculative decoding against the JAX package's.

``spec.py`` is a verbatim copy (``test_torch_engine.py`` holds the
source equal) and passes the JAX package's own unit cases.  The
per-phase attention forms the JAX package exports over its ragged
kernel: the port's ``_plain`` verify form is bitwise the flattened
one-token decode batch and, like the decode and prefill forms, within
2e-5 of the JAX ``_xla`` fallbacks.

The engine cases are the bodies of ``tests/test_llm_engine.py::
TestSpeculative`` (``block_size=8``, ``max_batch=4``, ``max_model_len=
64``, ``token_budget=64``, its five prompts, three of them tiled so the
n-gram drafter hits) on ``gpt_tiny(num_layers=2)`` in f32 with seeded
random weights carried to both packages as numpy arrays — weights whose
greedy streams vary, where the default initialization repeats one
token.  ``LLMEngine(speculative=K)`` must be token-exact against the
JAX speculative engine and the port's plain engine — greedy, seeded,
through preemption, with ``n=2`` forks, with sampling-pipeline rows
(per-position counts and bias on every verify position), with int8
weights and pools, and under an injected fault schedule — and its
``spec_stats()`` must equal the JAX engine's key for key.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.llm import Fault as JaxFault
from paddle_tpu.inference.llm import FaultInjector as JaxFaultInjector
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm import (
    paged_decode_attention_xla,
    paged_prefill_attention_xla,
    paged_verify_attention_xla,
)
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    BlockManager,
    Fault,
    FaultInjector,
    FinishReason,
    LLMEngine,
    NgramDrafter,
    Request,
    SpeculativeConfig,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_verify_attention,
    paged_verify_attention_plain,
    rollback_draft_reservation,
    to_records,
)
from paddle_tpu_torch.inference.llm.scheduler import RUNNING
from paddle_tpu_torch.models.gpt import gpt_tiny

SPEC = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=64)


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


def _spec_prompts(n=5, seed=7):
    """TestSpeculative's prompts: repetitive (draftable) and random."""
    rng = np.random.RandomState(seed)
    prompts = [np.tile(rng.randint(0, 128, 5), 3).astype(np.int32),
               rng.randint(0, 128, (12,)).astype(np.int32),
               np.tile(rng.randint(0, 128, 4), 4).astype(np.int32),
               rng.randint(0, 128, (3,)).astype(np.int32),
               np.tile(rng.randint(0, 128, 6), 2).astype(np.int32)]
    return prompts[:n]


def _gen(models, spec, port=True, temp=0.0, seed=None, max_new=46,
         request=None, **kw):
    """Serve the prompts on the port (or the JAX) engine -> ({rid:
    output}, engine); ``request`` adds knobs to every request."""
    if port:
        eng = LLMEngine(models[1], device="cpu", speculative=spec,
                        **SPEC, **kw)
    else:
        eng = JaxEngine(models[0], speculative=spec, **SPEC, **kw)
    for i, p in enumerate(_spec_prompts()):
        eng.add_request(p, max_new_tokens=max_new, temperature=temp,
                        seed=None if seed is None else seed + i,
                        **(request or {}))
    outs = {}
    while eng.has_unfinished():
        for r in eng.step():
            outs[r.request_id] = r
    eng.block_manager.check_invariants()
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    return outs, eng


def _ids(outs):
    return {rid: [int(t) for t in o.output_ids] for rid, o in outs.items()}


_JAX_RUNS = {}


def _jax_run(models, key, spec, **kw):
    """The JAX engine's run for ``key``, once per module."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _gen(models, spec, port=False, **kw)
    return _JAX_RUNS[key]


# ------------------------------------------------- the copied spec.py --
def test_ngram_drafter():
    d = NgramDrafter(SpeculativeConfig(num_tokens=4))
    assert d.propose([1, 2, 3, 4, 1, 2], 4) == [3, 4, 1, 2]
    assert d.propose([1, 2, 3, 4, 1, 2], 2) == [3, 4]
    assert d.propose([1, 2, 3, 4, 1, 2], 99) == [3, 4, 1, 2]
    assert d.propose([5, 9, 7, 5, 8, 5], 2) == [8, 5]
    assert d.propose([1, 2, 3, 4, 5], 4) == []
    assert d.propose([1, 2, 1, 2], 0) == []
    assert d.propose([7], 4) == []
    d3 = NgramDrafter(SpeculativeConfig(num_tokens=2, max_ngram=2))
    assert d3.propose([1, 2, 3, 9, 3, 6, 2, 3], 2) == [9, 3]


def test_speculative_config_resolve():
    sc = SpeculativeConfig
    assert sc.resolve(None) is None
    assert sc.resolve(False) is None
    assert sc.resolve(True).num_tokens == 4
    assert sc.resolve(6).num_tokens == 6
    assert sc.resolve({"num_tokens": 2, "max_ngram": 5}).max_ngram == 5
    cfg = sc(num_tokens=3)
    assert sc.resolve(cfg) is cfg
    assert sc.resolve("draft-model").uses_draft_model
    assert sc.resolve("tree").method == "tree"
    assert not sc.resolve(4).uses_draft_model
    with pytest.raises(ValueError, match="num_tokens"):
        sc(num_tokens=0)
    with pytest.raises(ValueError, match="min_ngram"):
        sc(min_ngram=3, max_ngram=2)
    with pytest.raises(ValueError, match="method"):
        sc.resolve("4")
    with pytest.raises(ValueError, match="draft_layers"):
        sc(draft_layers=0)
    with pytest.raises(TypeError, match="speculative"):
        sc.resolve(4.5)


def test_rollback_draft_reservation_returns_slots_and_drops_drafts():
    bm = BlockManager(num_blocks=8, block_size=4)
    req = Request(request_id=1, prompt_ids=(1, 2, 3, 4, 5),
                  max_new_tokens=8)
    bm.allocate(1, 6)
    req.status = RUNNING
    req.num_cached = 5
    req.num_prefill_tokens = 5
    req.output_ids.append(9)
    bm.append_slots(1, 3)              # a verify row: 1 + 2 drafts
    req.draft_tokens = [4, 4]
    assert rollback_draft_reservation(bm, req) == 4
    assert bm.num_tokens(1) == 5 and req.draft_tokens == []
    assert rollback_draft_reservation(bm, req) == 0
    bm.check_invariants()


def test_engine_builds_the_drafter_the_config_names(models):
    eng = LLMEngine(models[1], device="cpu", speculative=3, **SPEC)
    assert isinstance(eng.drafter, NgramDrafter)
    assert eng.scheduler.drafter is eng.drafter
    assert eng.spec.num_tokens == 3 and eng._draft_bm is None
    plain = LLMEngine(models[1], device="cpu", **SPEC)
    assert plain.spec is None and plain.drafter is None
    assert plain.spec_stats() == {"spec_steps": 0, "draft_tokens": 0,
                                  "accepted_tokens": 0,
                                  "acceptance_rate": 0.0}
    with pytest.raises(TypeError, match="speculative"):
        LLMEngine(models[1], device="cpu", speculative=2.5, **SPEC)


# ---------------------------------------------- per-phase attention --
def _pool(seed, nb=8, bs=8, nkv=2, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(nb, bs, nkv, d).astype(np.float32),
            rng.randn(nb, bs, nkv, d).astype(np.float32), rng)


@pytest.mark.parametrize("nq", [2, 4])
def test_verify_plain_is_the_flattened_decode(nq):
    """TestSpeculative.test_verify_attention_matches_flattened_decode on
    the port: bitwise the [B * T] one-token decode batch, and within
    2e-5 of the JAX fallback."""
    kp, vp, rng = _pool(3)
    b, t, d, pages = 2, 3, 16, 4
    q = rng.randn(b, t, nq, d).astype(np.float32)
    tables = rng.permutation(8)[:b * pages].reshape(b, pages).astype(
        np.int32)
    ctx = np.asarray([[5, 6, 7], [0, 1, 2]], np.int32)
    tt = torch.from_numpy
    out = paged_verify_attention_plain(tt(q), tt(kp), tt(vp), tt(tables),
                                       tt(ctx))
    flat = paged_decode_attention_plain(
        tt(q.reshape(b * t, nq, d)), tt(kp), tt(vp),
        tt(np.repeat(tables, t, axis=0)), tt(ctx.reshape(b * t)))
    assert torch.equal(out, flat.reshape(b, t, nq, d))
    assert torch.equal(out, paged_verify_attention(
        tt(q), tt(kp), tt(vp), tt(tables), tt(ctx)))
    assert not out[1, 0].any()               # ctx 0: exact zeros
    want = np.asarray(paged_verify_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx)))
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)


def test_decode_and_prefill_plain_match_the_jax_fallbacks():
    kp, vp, rng = _pool(4)
    tt = torch.from_numpy
    q = rng.randn(3, 4, 16).astype(np.float32)
    tables = rng.permutation(8)[:6].reshape(3, 2).astype(np.int32)
    lengths = np.asarray([9, 0, 16], np.int32)
    got = paged_decode_attention_plain(tt(q), tt(kp), tt(vp), tt(tables),
                                       tt(lengths))
    assert torch.equal(got, paged_decode_attention(
        tt(q), tt(kp), tt(vp), tt(tables), tt(lengths)))
    want = np.asarray(paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert not got[1].any()

    q = rng.randn(1, 5, 4, 16).astype(np.float32)
    table = np.asarray([6, 1, 3], np.int32)
    got = paged_prefill_attention_plain(tt(q), tt(kp), tt(vp), tt(table),
                                        11)
    assert torch.equal(got, paged_prefill_attention(
        tt(q), tt(kp), tt(vp), tt(table), 11))
    want = np.asarray(paged_prefill_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), 11))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------ n-gram engine --
def test_greedy_token_exact(models):
    spec, eng = _gen(models, 4)
    base, _ = _gen(models, None)
    jspec, jeng = _jax_run(models, "greedy", 4)
    assert _ids(spec) == _ids(base) == _ids(jspec)
    st = eng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["draft_tokens"] > 0 and st["accepted_tokens"] > 0
    assert eng.stats["spec_steps"] == st["spec_steps"] > 0
    assert eng.stats["tokens_generated"] == jeng.stats["tokens_generated"]


def test_token_exact_through_preemption(models):
    spec, eng = _gen(models, 4, num_blocks=18)
    base, _ = _gen(models, None)
    jspec, jeng = _jax_run(models, "preempt", 4, num_blocks=18)
    assert _ids(spec) == _ids(base) == _ids(jspec)
    assert eng.scheduler.num_preemptions == \
        jeng.scheduler.num_preemptions > 0
    assert eng.spec_stats() == jeng.spec_stats()


def test_seeded_sampling_token_exact(models):
    spec, eng = _gen(models, 4, temp=0.8, seed=123)
    base, _ = _gen(models, None, temp=0.8, seed=123)
    jspec, jeng = _jax_run(models, "seeded", 4, temp=0.8, seed=123)
    assert _ids(spec) == _ids(base) == _ids(jspec)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_stats()["draft_tokens"] > 0


def test_engine_stream_sampling_matches_jax_and_repeats(models):
    """The shared engine stream cannot match plain decode (multi-token
    commits move the draw order) but must repeat itself and match the
    JAX speculative engine draw for draw."""
    a, eng = _gen(models, 2, temp=0.6)
    b, _ = _gen(models, 2, temp=0.6)
    ja, jeng = _jax_run(models, "engine_stream", 2, temp=0.6)
    assert _ids(a) == _ids(b) == _ids(ja)
    assert eng.spec_stats() == jeng.spec_stats()


def test_n2_forks_token_exact(models):
    req = dict(n=2)
    spec, eng = _gen(models, 4, temp=0.8, seed=40, max_new=20,
                     request=req)
    base, _ = _gen(models, None, temp=0.8, seed=40, max_new=20,
                   request=req)
    jspec, jeng = _jax_run(models, "forks", 4, temp=0.8, seed=40,
                           max_new=20, request=req)
    assert _ids(spec) == _ids(base) == _ids(jspec)
    assert any("." in str(rid) for rid in spec)
    assert eng.spec_stats() == jeng.spec_stats()


def test_pipeline_rows_token_exact_with_logprobs(models):
    """Penalties, a logit bias and top-k on every request: each verify
    position gets the counts and bias of the text before it; logprobs
    come from all 1 + K fetched positions."""
    req = dict(repetition_penalty=1.3, presence_penalty=0.2,
               frequency_penalty=0.1, logit_bias={3: 2.0, 17: -1.5},
               top_k=20, logprobs=2)
    spec, eng = _gen(models, 4, temp=0.7, seed=5, max_new=24, request=req)
    base, _ = _gen(models, None, temp=0.7, seed=5, max_new=24, request=req)
    jspec, jeng = _jax_run(models, "pipeline", 4, temp=0.7, seed=5,
                           max_new=24, request=req)
    assert _ids(spec) == _ids(base) == _ids(jspec)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_stats()["draft_tokens"] > 0
    for rid, o in spec.items():
        for (lp, top), (jlp, jtop) in zip(o.logprobs, jspec[rid].logprobs):
            assert abs(lp - jlp) <= 1e-5
            assert [t for t, _ in top] == [t for t, _ in jtop]
            np.testing.assert_allclose([v for _, v in top],
                                       [v for _, v in jtop], atol=1e-5)


def test_int8_ngram_token_exact_vs_jax(models):
    spec, eng = _gen(models, 4, quantize="int8")
    jspec, jeng = _jax_run(models, "int8", 4, quantize="int8")
    assert _ids(spec) == _ids(jspec)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_stats()["accepted_tokens"] > 0


def _faults(cls_fault, cls_injector):
    return cls_injector(schedule=[
        cls_fault("step", "transient", step=3, count=1),
        cls_fault("step", "raise", step=6, victim=1),
        cls_fault("alloc", "oom", step=9)])


def test_fault_schedule_under_speculation(models):
    """A retried step, a quarantined verify row (its 1 + K reservation
    rolled back) and an injected OOM: the survivors, finish reasons and
    event records equal the JAX speculative engine's for the same
    schedule."""
    kw = dict(retry={"max_attempts": 2, "base_delay_s": 0.0,
                     "jitter": 0.0}, max_new=24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, eng = _gen(models, 4, faults=_faults(Fault, FaultInjector),
                        **kw)
        want, jeng = _gen(models, 4, port=False,
                          faults=_faults(JaxFault, JaxFaultInjector), **kw)
    assert _ids(got) == _ids(want)
    assert {r: o.finish_reason for r, o in got.items()} == \
        {r: o.finish_reason for r, o in want.items()}
    assert FinishReason.ERROR in {o.finish_reason for o in got.values()}
    assert eng.stats["retries"] == jeng.stats["retries"] >= 1
    assert to_records(eng.events) == to_records(jeng.events)
    assert eng.spec_stats() == jeng.spec_stats()
