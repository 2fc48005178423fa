"""The port's multi-LoRA serving (``LLMEngine(lora=)``) against the JAX
package's.

The bodies of ``tests/test_lora_serving.py`` on ``gpt_tiny(num_layers=2)``
in f32 with seeded random weights carried to both packages as numpy
arrays, and the same numpy adapter weights fed to the JAX engine and the
port engine: the copied host modules (``LoRAConfig``, ``AdapterManager``,
the adapter salt of the prefix hashes, the LoRA trace of
``sim/workloads.py``); a mixed batch of base and adapter rows token-exact
per request against the port's merged-dense engine (``W + scale * A @ B``
merged into the block weights) and against the JAX LoRA engine — under
the adapter-salted prefix cache, speculative verify, preempt-recompute
and LRU churn over more adapters than slots — with the event records of
the run equal to the JAX engine's; teacher-forced logits of the paged
step within 1e-4 of the JAX step's in f32, and in bf16 by mean |error|
beside a control without the adapter; admission (unknown adapters
rejected with the engine untouched, ``tenant_quota`` shedding, the
distinct-adapter gate); ``lora_pool_bytes`` equal to the JAX memory
model's; the HTTP ``adapter`` field and ``n=2`` fork families; a
migration refused by a destination that cannot serve the adapter and
resumed token-exact by one that can; a LoRA fleet's failover and the
re-registration of a restarted replica, with the JAX fleet's events.

Left out, with the item that brings them: tensor parallelism (A20), the
census (A22) and the bench smoke (A8).  The JAX compile-watcher cases become the port's capture check on
the card (``chip_smoke.py``'s ``lora_serving`` phase); their token
checks run here.
"""

import http.client
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.llm import Fleet as JaxFleet
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference.llm import (
    FinishReason,
    Fleet,
    HttpLLMServer,
    LLMEngine,
    MigrationError,
    assert_wall_clock_free,
    prefix_block_hashes,
    to_records,
)
from paddle_tpu_torch.inference.llm.lora import (
    LORA_TARGET_LEAVES,
    AdapterManager,
    LoRAConfig,
)
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)


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


def _port(models, **kw):
    return LLMEngine(models[1], device="cpu", **{**ENGINE, **kw})


def _jax(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def _prompts(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (int(rng.randint(4, 12)),))
            .astype(np.int32) for _ in range(n)]


def _weights(eng, seed=0, scale=0.5):
    """One adapter's raw (unscaled-by-alpha) halves for every target."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in eng.lora.targets:
        L, d_in, d_out = eng._lora_shapes[key]
        r = eng.lora.rank
        out[key] = (rng.standard_normal((L, d_in, r))
                    .astype(np.float32) * scale,
                    rng.standard_normal((L, r, d_out))
                    .astype(np.float32) * scale)
    return out


def _merged_ref(models, weights, cfg, **kw):
    """A LoRA-free port engine whose block GEMMs are the dense merge
    ``W + cfg.scale * A @ B``, written in place into the stacked leaves
    the engine's per-layer views read."""
    ref = _port(models, **kw)
    blocks = ref.params["blocks"]
    for key, (a, b) in weights.items():
        delta = torch.einsum("lir,lro->lio", torch.from_numpy(a),
                             torch.from_numpy(b)) * cfg.scale
        blocks[key].copy_((blocks[key].float() + delta).to(
            blocks[key].dtype))
    return ref


def _drive(eng):
    outs = {}
    while eng.has_unfinished():
        for fo in eng.step():
            outs[fo.request_id] = fo
    return outs


def _both(models, adapters, requests, **kw):
    """The same adapters and requests through the port and the JAX
    engine -> (port engine, JAX engine, port outputs, JAX outputs, rids)."""
    pe, je = _port(models, **kw), _jax(models, **kw)
    runs = []
    for eng in (pe, je):
        for aid, w in adapters.items():
            eng.add_adapter(aid, w)
        rids = [eng.add_request(p, **rkw) for p, rkw in requests]
        runs.append((_drive(eng), rids))
    (pouts, rids), (jouts, jrids) = runs
    assert rids == jrids
    return pe, je, pouts, jouts, rids


def _assert_same_tokens(pouts, jouts, rids):
    for rid in rids:
        np.testing.assert_array_equal(pouts[rid].all_ids,
                                      np.asarray(jouts[rid].all_ids))
        assert pouts[rid].finish_reason == jouts[rid].finish_reason


# ---------------------------------------------------------------------------
class TestLoRAConfig:
    def test_resolve_forms(self):
        assert LoRAConfig.resolve(None) is None
        c = LoRAConfig.resolve(4)
        assert c.max_adapters == 4 and c.rank == 8
        c2 = LoRAConfig.resolve({"rank": 2, "max_adapters": 3})
        assert c2.rank == 2 and c2.max_adapters == 3
        assert LoRAConfig.resolve(c) is c
        with pytest.raises(TypeError, match="bool"):
            LoRAConfig.resolve(True)
        with pytest.raises(TypeError):
            LoRAConfig.resolve("rank8")

    def test_validation(self):
        with pytest.raises(ValueError, match="rank"):
            LoRAConfig(rank=0)
        with pytest.raises(ValueError, match="max_adapters"):
            LoRAConfig(max_adapters=1)
        with pytest.raises(ValueError, match="targets"):
            LoRAConfig(targets=())
        with pytest.raises(ValueError, match="targets"):
            LoRAConfig(targets=("embedding.weight",))
        with pytest.raises(ValueError, match="tenant_quota"):
            LoRAConfig(tenant_quota=0)

    def test_scale_is_alpha_over_rank(self):
        assert LoRAConfig(rank=8).scale == 1.0
        assert LoRAConfig(rank=8, alpha=16).scale == 2.0
        # target order is canonicalized to the base-leaf order
        c = LoRAConfig(targets=tuple(reversed(LORA_TARGET_LEAVES)))
        assert c.targets == LORA_TARGET_LEAVES


# ---------------------------------------------------------------------------
class TestAdapterManager:
    def _mgr(self, max_adapters=3, rank=2):
        cfg = LoRAConfig(rank=rank, max_adapters=max_adapters)
        shapes = {k: (2, 8, 8) for k in cfg.targets}
        return cfg, AdapterManager(cfg, shapes)

    def _w(self, cfg, seed=0):
        rng = np.random.RandomState(seed)
        return {k: (rng.randn(2, 8, cfg.rank).astype(np.float32),
                    rng.randn(2, cfg.rank, 8).astype(np.float32))
                for k in cfg.targets}

    def test_register_validation(self):
        cfg, mgr = self._mgr()
        w = self._w(cfg)
        with pytest.raises(ValueError, match="base"):
            mgr.register(None, w)
        with pytest.raises(ValueError, match="hashable"):
            mgr.register(["a"], w)
        mgr.register("a", w)
        with pytest.raises(ValueError, match="already"):
            mgr.register("a", w)
        partial = dict(w)
        partial.pop(cfg.targets[0])
        with pytest.raises(ValueError, match="missing"):
            mgr.register("b", partial)
        bad = dict(w)
        k0 = cfg.targets[0]
        bad[k0] = (w[k0][0][:, :4], w[k0][1])
        with pytest.raises(ValueError, match="expected"):
            mgr.register("b", bad)

    def test_lru_eviction_and_stats(self):
        cfg, mgr = self._mgr(max_adapters=3)       # 2 usable slots
        for aid in ("a", "b", "c"):
            mgr.register(aid, self._w(cfg))
        sa, wa = mgr.acquire("a")
        sb, wb = mgr.acquire("b")
        assert {sa, sb} == {1, 2} and wa is not None and wb is not None
        assert mgr.acquire("a")[1] is None          # hit, bumps LRU
        sc, wc = mgr.acquire("c")                   # evicts b (LRU)
        assert wc is not None and sc == sb
        assert mgr.slot_of("b") is None
        assert mgr.slot_of(None) == 0               # base slot
        st = mgr.lora_stats()
        assert st["loads"] == 3 and st["evictions"] == 1
        assert st["hits"] == 1 and st["registered"] == 3
        assert st["resident"] == 2 and st["slots"] == 3

    def test_pinned_never_evicted(self):
        cfg, mgr = self._mgr(max_adapters=3)
        for aid in ("a", "b", "c"):
            mgr.register(aid, self._w(cfg))
        mgr.acquire("a")
        mgr.acquire("b")
        with pytest.raises(RuntimeError, match="pinned"):
            mgr.acquire("c", pinned=("a", "b"))
        # b evictable once unpinned
        slot, w = mgr.acquire("c", pinned=("a",))
        assert w is not None and mgr.slot_of("b") is None

    def test_scale_folded_into_stored_b(self):
        cfg = LoRAConfig(rank=2, max_adapters=3, alpha=4)   # scale 2.0
        shapes = {k: (2, 8, 8) for k in cfg.targets}
        mgr = AdapterManager(cfg, shapes)
        w = self._w(cfg)
        mgr.register("a", w)
        _, stored = mgr.acquire("a")
        k0 = cfg.targets[0]
        np.testing.assert_allclose(stored[k0][1], w[k0][1] * 2.0,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
class TestPrefixSaltUnit:
    def test_salt_perturbs_block_hashes(self):
        """salt=None is byte-identical to the legacy hash chain; any
        two distinct salts (adapter ids) diverge from it and from each
        other, so tenants can never share cached pages."""
        legacy = prefix_block_hashes(list(range(16)), 8)
        assert prefix_block_hashes(list(range(16)), 8,
                                   salt=None) == legacy
        s1 = prefix_block_hashes(list(range(16)), 8, salt="t1")
        s2 = prefix_block_hashes(list(range(16)), 8, salt="t2")
        assert s1 != legacy and s2 != legacy and s1 != s2

    def test_engine_registers_salted_pages(self, models):
        """A finished adapter request's full pages are registered under
        the adapter-salted chain: a base request of the same prompt
        adopts none of them, the same tenant adopts them."""
        eng = _port(models, lora=dict(rank=2, max_adapters=3))
        eng.add_adapter("t", _weights(eng, seed=1))
        prompt = list(range(3, 27))
        eng.generate([prompt], max_new_tokens=2, adapter_id="t")
        hashes = eng.block_manager.prefix_chain_hashes(prompt, limit=3)
        assert eng.block_manager.match_prefix(hashes) == 0
        salted = eng.block_manager.prefix_chain_hashes(prompt, limit=3,
                                                       salt="t")
        assert eng.block_manager.match_prefix(salted) == 3


# ---------------------------------------------------------------------------
class TestMixedBatchTokenExact:
    def test_mixed_batch_vs_merged_dense(self, models):
        """One continuous batch mixing base rows and two tenants is
        per-request identical to per-adapter merged-dense engines and to
        the JAX LoRA engine, with the JAX engine's event records."""
        probe = _port(models, lora=dict(rank=4, max_adapters=4))
        w1 = _weights(probe, seed=1)
        w2 = _weights(probe, seed=2)
        prompts = _prompts(n=6)
        aids = [None, "t1", "t2", "t1", None, "t2"]
        pe, je, outs, jouts, rids = _both(
            models, {"t1": w1, "t2": w2},
            [(p, dict(max_new_tokens=8, adapter_id=a))
             for p, a in zip(prompts, aids)],
            lora=dict(rank=4, max_adapters=4))
        assert pe.block_manager.num_free_blocks == pe.num_blocks
        _assert_same_tokens(outs, jouts, rids)
        assert to_records(pe.events) == to_records(je.events)
        assert pe.lora_stats() == je.lora_stats()

        base = _port(models)
        refs = {None: base, "t1": _merged_ref(models, w1, pe.lora),
                "t2": _merged_ref(models, w2, pe.lora)}
        for rid, p, a in zip(rids, prompts, aids):
            want = refs[a].generate([p], max_new_tokens=8)[0]
            np.testing.assert_array_equal(outs[rid].all_ids, want)
        # the adapters actually steer: tenant tokens != base tokens
        got1 = outs[rids[1]].all_ids
        got0 = base.generate([prompts[1]], max_new_tokens=8)[0]
        assert not np.array_equal(got1, got0)

    def test_prefix_cache_is_adapter_salted(self, models):
        """Two tenants sharing a token prefix must NOT share cached
        pages (a qkv adapter changes K/V contents); the same tenant
        re-arriving must still hit its own pages."""
        eng = _port(models, lora=dict(rank=4, max_adapters=4),
                    enable_prefix_caching=True)
        w1, w2 = _weights(eng, seed=1), _weights(eng, seed=2)
        eng.add_adapter("t1", w1)
        eng.add_adapter("t2", w2)
        prompt = np.arange(20, dtype=np.int32) % 97
        # serve t1 twice (second run hits t1's cached pages), then t2
        r1 = eng.generate([prompt], max_new_tokens=6, adapter_id="t1")[0]
        r1b = eng.generate([prompt], max_new_tokens=6,
                           adapter_id="t1")[0]
        hits_after_t1 = eng.prefix_cache_stats()["prefix_hit_tokens"]
        assert hits_after_t1 > 0                  # same-tenant reuse
        r2 = eng.generate([prompt], max_new_tokens=6, adapter_id="t2")[0]
        assert eng.prefix_cache_stats()["prefix_hit_tokens"] == \
            hits_after_t1                         # no cross-tenant hit
        np.testing.assert_array_equal(r1, r1b)
        want1 = _merged_ref(models, w1, eng.lora).generate(
            [prompt], max_new_tokens=6)[0]
        want2 = _merged_ref(models, w2, eng.lora).generate(
            [prompt], max_new_tokens=6)[0]
        np.testing.assert_array_equal(r1, want1)
        np.testing.assert_array_equal(r2, want2)

    def test_speculative_verify_token_exact(self, models):
        probe = _port(models, lora=dict(rank=4, max_adapters=3))
        w = _weights(probe, seed=3)
        prompts = [np.array([5, 6, 7, 5, 6, 7, 5, 6], np.int32),
                   _prompts(seed=9, n=1)[0]]
        pe, je, outs, jouts, rids = _both(
            models, {"t": w},
            [(p, dict(max_new_tokens=10, adapter_id="t"))
             for p in prompts],
            lora=dict(rank=4, max_adapters=3), speculative=2)
        _assert_same_tokens(outs, jouts, rids)
        assert pe.spec_stats() == je.spec_stats()
        assert pe.spec_stats()["draft_tokens"] > 0
        want = _merged_ref(models, w, pe.lora).generate(
            prompts, max_new_tokens=10)
        for rid, wnt in zip(rids, want):
            np.testing.assert_array_equal(outs[rid].all_ids, wnt)

    def test_preempt_recompute_token_exact(self, models):
        """A pool too small for the working set forces preemption; the
        recomputed adapter rows still match the merged-dense refs."""
        probe = _port(models, lora=dict(rank=4, max_adapters=3))
        w = _weights(probe, seed=5)
        prompts = _prompts(seed=7, n=3)
        aids = ["t", None, "t"]
        pe, je, outs, jouts, rids = _both(
            models, {"t": w},
            [(p, dict(max_new_tokens=16, adapter_id=a))
             for p, a in zip(prompts, aids)],
            lora=dict(rank=4, max_adapters=3), max_batch=3, num_blocks=8)
        assert pe.lifecycle_stats()["preemptions"] > 0
        assert pe.block_manager.num_free_blocks == pe.num_blocks
        _assert_same_tokens(outs, jouts, rids)
        assert to_records(pe.events) == to_records(je.events)
        refs = {None: _port(models),
                "t": _merged_ref(models, w, pe.lora)}
        for rid, p, a in zip(rids, prompts, aids):
            want = refs[a].generate([p], max_new_tokens=16)[0]
            np.testing.assert_array_equal(outs[rid].all_ids, want)

    def test_lru_churn_token_exact(self, models):
        """Four tenants over two usable slots (``max_adapters=3``): every
        load writes a slot in place, and the outputs equal an engine
        with a slot for every tenant and the JAX engine's."""
        probe = _port(models, lora=dict(rank=2, max_adapters=3))
        ws = {f"t{i}": _weights(probe, seed=10 + i) for i in range(4)}
        prompts = _prompts(seed=3, n=8)
        reqs = [(p, dict(max_new_tokens=4, adapter_id=f"t{i % 4}"))
                for i, p in enumerate(prompts)]
        pe, je, outs, jouts, rids = _both(
            models, ws, reqs, lora=dict(rank=2, max_adapters=3))
        st = pe.lora_stats()
        assert st["loads"] > 2 and st["evictions"] > 0
        assert st == je.lora_stats()
        _assert_same_tokens(outs, jouts, rids)
        roomy = _port(models, lora=dict(rank=2, max_adapters=5))
        for aid, w in ws.items():
            roomy.add_adapter(aid, w)
        rrids = [roomy.add_request(p, **kw) for p, kw in reqs]
        routs = _drive(roomy)
        assert roomy.lora_stats()["evictions"] == 0
        for rid, rrid in zip(rids, rrids):
            np.testing.assert_array_equal(outs[rid].all_ids,
                                          routs[rrid].all_ids)
        assert pe.block_manager.num_free_blocks == pe.num_blocks


# ---------------------------------------------------------------------------
def _step_logits(eng, seq, adapter_id, port):
    """Teacher-forced logits [T, V] (f32 numpy) of ``seq`` through the
    engine's own paged step: ``seq`` as the prompt of one request with one
    new token, the live rows of every launch it takes (a chunk each)."""
    got = []
    name = "_ragged_fn" if port else "_ragged_launch"
    if port:
        orig = eng._ragged_fn

        def spy(pk):
            out = orig(pk)
            got.append(out[1][:pk["total"]].float().numpy().copy())
            return out

        eng._ragged_fn = spy
    else:
        orig = eng._ragged_launch

        def spy(rows, *args):
            out = orig(rows, *args)
            n = sum(row.length for row in rows)
            got.append(np.asarray(out[1][:n].astype(jnp.float32)))
            return out

        eng._ragged_launch = spy
    eng.generate([seq], max_new_tokens=1, adapter_id=adapter_id)
    delattr(eng, name)
    return np.concatenate(got)


def _teacher_forced(models, dtype, adapter, control=False):
    """Per-sequence |port - JAX| logits of the JAX LoRA engine's greedy
    outputs, adapter ``t`` on both (the control: none on the port)."""
    # no prefix caching: every launch recomputes the whole sequence
    kw = dict(lora=dict(rank=4, max_adapters=3), dtype=dtype,
              enable_prefix_caching=False)
    pe, je = _port(models, **kw), _jax(models, **kw)
    w = _weights(pe, seed=21, scale=adapter)
    pe.add_adapter("t", w)
    je.add_adapter("t", w)
    errs = []
    for p in _prompts(seed=4, n=3):
        seq = list(je.generate([p], max_new_tokens=8, adapter_id="t")[0])
        want = _step_logits(je, seq, "t", port=False)
        got = _step_logits(pe, seq, None if control else "t", port=True)
        assert got.shape == want.shape == (len(seq), pe.vocab_size)
        errs.append(np.abs(got - want))
    return errs


# bf16 teacher-forced logits, mean |port - JAX| over every element: both
# engines round at bf16 resolution (2^-9 relative) in different fusion
# and summation orders.  Measured on the CPU: 0.0064 (max 0.038); the
# control, the same run with the adapter left out on the port, reads
# 0.24 (max 1.44).  The bound sits between (f32: max 1.6e-5 against
# the 1e-4 gate).
BF16_LOGITS_MEAN_ABS = 0.02


def test_teacher_forced_logits_match_jax_f32(models):
    err = max(float(e.max()) for e in _teacher_forced(models, None, 0.5))
    assert err <= 1e-4, err


@pytest.mark.parametrize("control", [False, True],
                         ids=["adapter", "control"])
def test_teacher_forced_logits_match_jax_bf16(models, control):
    errs = _teacher_forced(models, "bfloat16", 0.1, control=control)
    err = float(np.mean([e.mean() for e in errs]))
    if control:
        assert err > BF16_LOGITS_MEAN_ABS, err
    else:
        assert err <= BF16_LOGITS_MEAN_ABS, err


# ---------------------------------------------------------------------------
class TestAdmissionAndQuota:
    def test_unknown_adapter_rejected_engine_left_empty(self, models):
        eng = _port(models, lora=dict(rank=2, max_adapters=3))
        with pytest.raises(ValueError, match="unknown adapter"):
            eng.add_request([1, 2, 3], max_new_tokens=4,
                            adapter_id="ghost")
        assert not eng._requests and eng.scheduler.queue_depth() == 0
        assert eng._next_id == 0 and eng.events == []

    def test_adapter_id_needs_lora_engine(self, models):
        eng = _port(models)
        with pytest.raises(ValueError, match="LoRA-enabled"):
            eng.add_request([1, 2, 3], adapter_id="t")
        with pytest.raises(ValueError, match="LoRA-enabled"):
            eng.add_adapter("t", {})
        with pytest.raises(ValueError, match="LoRA-enabled"):
            eng.lora_stats()

    def test_tenant_quota_sheds_with_finish_reason(self, models):
        eng = _port(models, lora=dict(rank=2, max_adapters=4,
                                      tenant_quota=1))
        eng.add_adapter("a", _weights(eng, seed=1))
        eng.add_adapter("b", _weights(eng, seed=2))
        r1 = eng.add_request([1, 2, 3], max_new_tokens=4,
                             adapter_id="a")
        r2 = eng.add_request([4, 5, 6], max_new_tokens=4,
                             adapter_id="a")      # over quota -> shed
        r3 = eng.add_request([7, 8, 9], max_new_tokens=4,
                             adapter_id="b")      # other tenant: fine
        r4 = eng.add_request([1, 2, 3], max_new_tokens=4)  # base: fine
        outs = _drive(eng)
        assert outs[r2].finish_reason == FinishReason.SHED
        assert outs[r1].finish_reason == "length"
        assert outs[r3].finish_reason == "length"
        assert outs[r4].finish_reason == "length"
        assert eng.lifecycle_stats()["shed"] == 1
        # quota frees with the tenant's live request
        r5 = eng.add_request([1, 2, 3], max_new_tokens=4,
                             adapter_id="a")
        assert _drive(eng)[r5].finish_reason == "length"

    def test_distinct_adapter_gate_serializes_past_pool(self, models):
        """Two tenants, ONE usable slot: the admission gate breaks
        head-of-line instead of wedging acquire(); both finish exact,
        with an eviction swapping the slot between them."""
        eng = _port(models, lora=dict(rank=4, max_adapters=2))
        w1, w2 = _weights(eng, seed=1), _weights(eng, seed=2)
        eng.add_adapter("t1", w1)
        eng.add_adapter("t2", w2)
        prompts = _prompts(seed=5, n=2)
        r1 = eng.add_request(prompts[0], max_new_tokens=6,
                             adapter_id="t1")
        r2 = eng.add_request(prompts[1], max_new_tokens=6,
                             adapter_id="t2")
        outs = _drive(eng)
        st = eng.lora_stats()
        assert st["loads"] == 2 and st["evictions"] >= 1
        for rid, p, w in ((r1, prompts[0], w1), (r2, prompts[1], w2)):
            want = _merged_ref(models, w, eng.lora).generate(
                [p], max_new_tokens=6)[0]
            np.testing.assert_array_equal(outs[rid].all_ids, want)


# ---------------------------------------------------------------------------
class TestEventsStatsAndMemory:
    def test_adapter_events_fit_the_frozen_schema(self, models):
        eng = _port(models, lora=dict(rank=2, max_adapters=3))
        eng.add_adapter("t", _weights(eng, seed=1))
        eng.generate([[1, 2, 3]], max_new_tokens=4, adapter_id="t")
        kinds = [e[1] for e in eng.events]
        assert "adapter_register" in kinds and "adapter_load" in kinds
        recs = to_records(eng.events)
        assert_wall_clock_free(recs)
        load = next(r for r in recs if r["kind"] == "adapter_load")
        assert load["adapter_id"] == "t" and load["slot"] >= 1

    @pytest.mark.parametrize("quantize", [None, "int8"])
    def test_memory_model_prices_adapter_pools(self, models, quantize):
        kw = dict(lora=dict(rank=4, max_adapters=4), quantize=quantize)
        base = _port(models, quantize=quantize)
        eng = _port(models, **kw)
        mm = eng.memory_model()
        want = sum(v.numel() * v.element_size()
                   for k, v in eng.params["blocks"].items()
                   if k.startswith("lora."))
        assert mm["lora_pool_bytes"] == want > 0
        assert mm["weights_bytes"] == \
            base.memory_model()["weights_bytes"] + want
        assert base.memory_model()["lora_pool_bytes"] == 0
        jm = _jax(models, **kw).memory_model()
        assert mm["lora_pool_bytes"] == jm["lora_pool_bytes"]
        assert mm["weights_bytes"] == jm["weights_bytes"]

    def test_pools_are_written_in_place(self, models):
        """Loads and evictions write the pool tensors the step's
        per-layer views read; no pool is ever rebound."""
        eng = _port(models, lora=dict(rank=2, max_adapters=2))
        ptrs = {k: v.data_ptr() for k, v in eng.params["blocks"].items()
                if k.startswith("lora.")}
        w1, w2 = _weights(eng, seed=1), _weights(eng, seed=2)
        eng.add_adapter("t1", w1)
        eng.add_adapter("t2", w2)
        eng.generate([[1, 2, 3]], max_new_tokens=2, adapter_id="t1")
        eng.generate([[1, 2, 3]], max_new_tokens=2, adapter_id="t2")
        assert eng.lora_stats()["evictions"] == 1
        blocks = eng.params["blocks"]
        assert {k: blocks[k].data_ptr() for k in ptrs} == ptrs
        key = eng.lora.targets[0]
        a = blocks[f"lora.{key}.A"]
        np.testing.assert_array_equal(a[:, 1].numpy(), w2[key][0])
        assert not a[:, 0].any()
        assert eng._layers[1][f"lora.{key}.A"].data_ptr() == \
            a[1].data_ptr()


# ---------------------------------------------------------------------------
class TestTraceGolden:
    def test_lora_trace_extends_plain_trace_byte_identically(self):
        from paddle_tpu_torch.sim.workloads import (
            TRACES,
            thousand_tenant_lora_trace,
            thousand_tenant_trace,
        )

        t3 = thousand_tenant_trace(16, 3.0, 8, seed=1)
        t4 = thousand_tenant_lora_trace(16, 3.0, 8, seed=1)
        np.testing.assert_array_equal(t3[0], t4[0])
        assert all(np.array_equal(a, b) for a, b in zip(t3[1], t4[1]))
        assert t3[2] == t4[2]
        # pinned adapter assignment — derived from the Zipf draw, no
        # extra rng consumption
        assert t4[3] == ["adapter-1", "adapter-2", "adapter-1",
                         "adapter-2", "adapter-2", None, "adapter-2",
                         "adapter-3", "adapter-2", None, "adapter-2",
                         "adapter-3", "adapter-2", "adapter-1",
                         "adapter-2", "adapter-2"]
        assert round(float(t4[0].sum()), 6) == 22.723298
        assert sum(int(p.sum()) for p in t4[1]) == 24559
        assert sum(t4[2]) == 93
        # different schema -> not in the 3-tuple registry
        assert "thousand_tenant_lora" not in TRACES


# ---------------------------------------------------------------------------
class TestServingSurfaces:
    def test_http_adapter_field(self, models):
        eng = _port(models, lora=dict(rank=2, max_adapters=3))
        w = _weights(eng, seed=1)
        eng.add_adapter("tenant-a", w)
        srv = HttpLLMServer(engine=eng).start()
        try:
            host, port = srv.address

            def post(body):
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=120)
                try:
                    conn.request("POST", "/v1/completions",
                                 json.dumps(body),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    return resp.status, json.loads(resp.read())
                finally:
                    conn.close()

            status, body = post({"prompt_ids": [1, 2, 3],
                                 "max_new_tokens": 4,
                                 "adapter": "tenant-a"})
            assert status == 200
            comp = body["completions"][0]
            assert comp["finish_reason"] == "length"
            assert len(comp["output_ids"]) == 4
            status, body = post({"prompt_ids": [1, 2, 3],
                                 "adapter": "ghost"})
            assert status == 400 and "unknown adapter" in body["error"]
            assert not eng._requests       # rejected before admission
        finally:
            srv.close()
        want = _merged_ref(models, w, eng.lora).generate(
            [[1, 2, 3]], max_new_tokens=4)[0]
        assert comp["output_ids"] == [int(t) for t in want[3:]]

    def test_fork_family_inherits_adapter(self, models):
        eng = _port(models, lora=dict(rank=4, max_adapters=3))
        w = _weights(eng, seed=6)
        eng.add_adapter("t", w)
        p = _prompts(seed=8, n=1)[0]
        rid = eng.add_request(p, max_new_tokens=6, adapter_id="t", n=2,
                              seed=7)
        outs = _drive(eng)
        assert eng._requests == {}
        want = _merged_ref(models, w, eng.lora).generate(
            [p], max_new_tokens=6)[0]
        # greedy forks are identical — both must match the merged ref
        for key in (rid, f"{rid}.1"):
            np.testing.assert_array_equal(outs[key].all_ids, want)


# ---------------------------------------------------------------------------
class TestMigrationAndFleet:
    def test_migration_guards_unknown_destination(self, models):
        src = _port(models, lora=dict(rank=2, max_adapters=3))
        src.add_adapter("t", _weights(src, seed=1))
        p = _prompts(n=1)[0]
        rid = src.add_request(p, max_new_tokens=8, adapter_id="t")
        for _ in range(3):
            src.step()
        assert len(src._requests[rid].output_ids) >= 1
        state = src.export_request(rid)
        for dst in (_port(models),                       # no lora= at all
                    _port(models, lora=dict(rank=2, max_adapters=3))):
            before = dst.block_manager.num_free_blocks
            with pytest.raises(MigrationError) as ei:
                dst.import_request(state["request"], state["seq"],
                                   state["k_pages"], state["v_pages"])
            assert ei.value.reason == "adapter"
            assert dst.block_manager.num_free_blocks == before
        dst = _port(models, lora=dict(rank=2, max_adapters=3))
        dst.add_adapter("t", _weights(dst, seed=1))
        dst.import_request(state["request"], state["seq"],
                           state["k_pages"], state["v_pages"])
        src.release_request(rid)
        out = _drive(dst)[rid]
        ref = _port(models, lora=dict(rank=2, max_adapters=3))
        ref.add_adapter("t", _weights(ref, seed=1))
        want = ref.generate([p], max_new_tokens=8, adapter_id="t")[0]
        np.testing.assert_array_equal(out.all_ids, want)

    def test_fleet_failover_and_restart_reregistration(self, models):
        """A LoRA fleet loses a replica mid-decode: the adapter requests
        replay on the survivor token-exact against one engine, with the
        JAX fleet's events; the restarted replica knows the adapter."""
        lora = dict(rank=4, max_adapters=3)
        ref = _port(models, lora=lora)
        w = _weights(ref, seed=2)
        ref.add_adapter("t", w)
        prompts = _prompts(seed=4, n=4)
        want = ref.generate(prompts, max_new_tokens=8, adapter_id="t")
        runs = []
        for build in (Fleet, JaxFleet):
            model = models[1] if build is Fleet else models[0]
            kw = {"device": "cpu"} if build is Fleet else {}
            fleet = build(model, replicas=2, lora=lora, **ENGINE, **kw)
            fleet.add_adapter("t", w)
            with pytest.raises(ValueError, match="already"):
                fleet.add_adapter("t", w)
            rids = [fleet.add_request(p, max_new_tokens=8, adapter_id="t")
                    for p in prompts]
            for _ in range(3):
                fleet.step()
            outs = {}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                assert fleet.kill_replica(1) is True
                while fleet.has_unfinished():
                    for fo in fleet.step():
                        outs[fo.request_id] = fo
            runs.append((fleet, outs, rids))
        (fleet, outs, rids), (jfleet, jouts, _) = runs
        for rid, wnt in zip(rids, want):
            assert outs[rid].ok
            np.testing.assert_array_equal(outs[rid].all_ids, wnt)
        _assert_same_tokens(outs, jouts, rids)
        assert fleet.events == jfleet.events
        assert to_records(fleet.replicas[0].engine.events) == \
            to_records(jfleet.replicas[0].engine.events)
        fleet.restart_replica(1)
        assert fleet.replicas[1].engine._lora_mgr.known("t")
        eng = fleet.replicas[1].engine
        rid = eng.add_request(prompts[0], max_new_tokens=8, adapter_id="t")
        np.testing.assert_array_equal(_drive(eng)[rid].all_ids, want[0])
