"""The port's model-based speculation (``method="draft-model"`` and
``"tree"``) against the JAX package's.

The bodies of ``tests/test_llm_engine.py::TestDraftModel`` (its four
random prompts, ``block_size=8``, ``max_batch=4``, ``max_model_len=64``,
``token_budget=64``, the n-gram leg muted so the model path is what gets
verified) on ``gpt_tiny(num_layers=2)`` in f32 with seeded random
weights carried to both packages as numpy arrays.  The JAX draft model
is the target's first ``draft_layers`` blocks padded with zero blocks;
the port's runs only those blocks over draft pools of their own, which
is the same function: token streams and ``spec_stats()`` must equal the
JAX engine's and the port's plain engine's — greedy, seeded, a full-copy
draft (acceptance exactly 1.0), tree through preemption, forced tree
sibling promotion, the hybrid n-gram + model drafter — with every page
and draft page returned and the ``draft_model_load`` event records equal
to the JAX engine's.  A draft pool out of pages only skips drafting.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    BlockManager,
    DraftModelDrafter,
    FinishReason,
    LLMEngine,
    to_records,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

DRAFT = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=64)
MODEL = {"method": "draft-model", "num_tokens": 4, "draft_layers": 1}


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


def _prompts(n=4, seed=19):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (4 + 3 * i,)).astype(np.int32)
            for i in range(n)]


def _engine(models, spec, port=True, **kw):
    if port:
        return LLMEngine(models[1], device="cpu", speculative=spec,
                         **DRAFT, **kw)
    return JaxEngine(models[0], speculative=spec, **DRAFT, **kw)


def _gen(models, spec, port=True, temp=0.0, seed=None, max_new=20,
         mute_ngram=True, n_prompts=4, **kw):
    eng = _engine(models, spec, port, **kw)
    if mute_ngram and eng.spec is not None and eng.spec.uses_draft_model:
        # min_ngram=1 hits often on toy output: silence it so the model
        # path is what gets verified
        eng.drafter._ngram.propose = lambda *a, **k: []
    eng.warmup()
    for i, p in enumerate(_prompts(n=n_prompts)):
        eng.add_request(p, max_new_tokens=max_new, temperature=temp,
                        seed=None if seed is None else seed + i)
    outs = {}
    while eng.has_unfinished():
        for r in eng.step():
            outs[r.request_id] = [int(t) for t in r.output_ids]
    eng.block_manager.check_invariants()
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    if eng._draft_bm is not None:
        eng._draft_bm.check_invariants()
        assert eng._draft_bm.num_free_blocks == eng.num_blocks
    return outs, eng


def test_greedy_token_exact_model_path(models):
    spec, eng = _gen(models, MODEL)
    jspec, jeng = _gen(models, MODEL, port=False)
    base, _ = _gen(models, None)
    assert spec == jspec == base
    st = eng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["method"] == "draft-model"
    assert st["model_drafts"] > 0 and st["draft_tokens"] > 0
    assert isinstance(eng.drafter, DraftModelDrafter)


def test_full_copy_draft_acceptance_is_total(models):
    cfg = {"method": "draft-model", "num_tokens": 3, "draft_layers": 2}
    spec, eng = _gen(models, cfg)
    jspec, jeng = _gen(models, cfg, port=False)
    base, _ = _gen(models, None)
    assert spec == jspec == base
    st = eng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["model_drafts"] > 0
    assert st["acceptance_rate"] == 1.0


def test_seeded_sampling_token_exact(models):
    spec, eng = _gen(models, MODEL, temp=0.8, seed=321)
    jspec, jeng = _gen(models, MODEL, port=False, temp=0.8, seed=321)
    base, _ = _gen(models, None, temp=0.8, seed=321)
    assert spec == jspec == base
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_stats()["model_drafts"] > 0


def test_tree_token_exact_through_preemption(models):
    cfg = {"method": "tree", "num_tokens": 3, "draft_layers": 1}
    spec, eng = _gen(models, cfg, num_blocks=18, max_new=32)
    jspec, jeng = _gen(models, cfg, port=False, num_blocks=18, max_new=32)
    base, beng = _gen(models, None, num_blocks=18, max_new=32)
    assert spec == jspec == base
    assert beng.scheduler.num_preemptions > 0
    assert eng.scheduler.num_preemptions == jeng.scheduler.num_preemptions
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.block_manager.num_free_blocks == 18


def test_hybrid_tree_token_exact(models):
    """n-gram hits first, the model drafts the misses, tree siblings on
    the model's chains."""
    cfg = {"method": "tree", "num_tokens": 3, "draft_layers": 1}
    spec, eng = _gen(models, cfg, mute_ngram=False)
    jspec, jeng = _gen(models, cfg, port=False, mute_ngram=False)
    base, _ = _gen(models, None)
    assert spec == jspec == base
    st = eng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["ngram_drafts"] > 0 and st["model_drafts"] > 0


def _forced_tree(models, port, base):
    """Every step a wrong first draft with the true next token as the
    sibling: each step misses branch one and promotes the fork."""
    eng = _engine(models, {"method": "tree", "num_tokens": 3,
                           "draft_layers": 1}, port)
    dr = eng.drafter
    dr._ngram.propose = lambda *a, **k: []
    eng._draft_phase = lambda: None      # the proposals are injected
    eng.warmup()
    for p in _prompts(n=2):
        eng.add_request(p, max_new_tokens=14)
    outs = {}
    while eng.has_unfinished():
        dr.proposals.clear()
        dr.siblings.clear()
        for req in eng.scheduler.running:
            rid = req.request_id
            done = len(req.output_ids)
            if req.prefill_done and done + 1 < req.max_new_tokens \
                    and done < len(base[rid]):
                correct = int(base[rid][done])
                dr.proposals[rid] = [(correct + 1) % eng.vocab_size]
                dr.siblings[rid] = correct
        for r in eng.step():
            outs[r.request_id] = [int(t) for t in r.output_ids]
    eng.block_manager.check_invariants()
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    return outs, eng


def test_tree_sibling_promotion_exact(models):
    base, _ = _gen(models, None, max_new=14, n_prompts=2)
    got, eng = _forced_tree(models, True, base)
    want, jeng = _forced_tree(models, False, base)
    assert got == want == base
    st = eng.spec_stats()
    assert st == jeng.spec_stats()
    assert st["tree_hits"] > 0


def test_draft_pools_books_and_load_event(models):
    """The draft model keeps ``draft_layers`` layers of pools with their
    own sink rows and separate books (prefix caching off); departed
    requests give back their draft pages; the event log — the
    ``draft_model_load`` record included — equals the JAX engine's."""
    outs, eng = _gen(models, MODEL, max_new=8, n_prompts=2)
    jouts, jeng = _gen(models, MODEL, port=False, max_new=8, n_prompts=2)
    assert outs == jouts
    assert eng._draft_bm is not eng.block_manager
    assert not eng._draft_bm.enable_prefix_caching
    nb, bs = eng.num_blocks, eng.block_size
    pools = eng._draft_pools
    assert pools.k_rows.shape == (1, nb * bs + 1, eng.num_heads,
                                  eng.head_dim)
    assert pools.kc.shape[0] == 1 and pools.ks is None
    assert eng._draft_layers == eng._layers[:1]
    assert eng._draft_layers[0]["attn.qkv.weight"] is \
        eng._layers[0]["attn.qkv.weight"]
    records = to_records(eng.events)
    assert records == to_records(jeng.events)
    assert records[0]["kind"] == "draft_model_load"
    assert eng.stats["draft_launches"] > len(list(eng._bucket_grid()))


def test_abort_frees_draft_pages(models):
    eng = _engine(models, MODEL)
    eng.drafter._ngram.propose = lambda *a, **k: []
    rids = [eng.add_request(p, max_new_tokens=20) for p in _prompts()]
    for _ in range(4):
        eng.step()
    assert eng._draft_bm.num_free_blocks < eng.num_blocks
    for rid in rids:
        eng.abort_request(rid)
    outs = {o.request_id: o for o in eng.step()}
    assert all(o.finish_reason == FinishReason.ABORTED
               for o in outs.values())
    assert eng._draft_bm.num_free_blocks == eng.num_blocks
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    assert not eng.drafter.history


def test_draft_pool_out_of_pages_only_skips_drafting(models):
    base, _ = _gen(models, None)
    eng = _engine(models, MODEL)
    eng.drafter._ngram.propose = lambda *a, **k: []
    eng._draft_bm = BlockManager(3, eng.block_size,
                                 enable_prefix_caching=False)
    for p in _prompts():
        eng.add_request(p, max_new_tokens=20)
    outs = {}
    while eng.has_unfinished():
        for r in eng.step():
            outs[r.request_id] = [int(t) for t in r.output_ids]
    assert outs == base
    assert eng.spec_stats()["model_drafts"] > 0
    assert eng._draft_bm.num_free_blocks == 3
