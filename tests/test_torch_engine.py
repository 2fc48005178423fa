"""The port's serving engine against the JAX package's.

Both engines serve ``gpt_tiny(num_layers=2)`` in f32 with the same
weights (carried across as numpy arrays), ``block_size=8``,
``max_batch=4``, ``token_budget=16``.  Greedy and seeded-sampling
``generate`` must be token-exact: the prompts include one longer than
the token budget (chunked prefill, mixed steps) and two that share a
16-token prefix (prefix-cache hits); the host gumbel streams are the
same numpy streams on both sides.  The logits pipeline must match the
JAX one knob by knob on seeded logits (atol 1e-6).  The host modules
the port copies (block manager, scheduler, faults, events, interleave,
structured, spec) must be the JAX package's source verbatim, and the
copied block manager and scheduler must pass a handful of the JAX
package's own allocator and scheduler cases.  Engine and request
keywords the port has are accepted and serve; the JAX engine's others
raise NotImplementedError.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.framework.flags as jax_flags
import paddle_tpu.inference.llm.block_manager as jax_bm
import paddle_tpu.inference.llm.events as jax_events
import paddle_tpu.inference.llm.faults as jax_faults
import paddle_tpu.inference.llm.interleave as jax_interleave
import paddle_tpu.inference.llm.kv_tier as jax_kv_tier
import paddle_tpu.inference.llm.scheduler as jax_sched
import paddle_tpu.inference.llm.spec as jax_spec
import paddle_tpu.inference.llm.structured as jax_structured
import paddle_tpu.ops.inventory as jax_inventory
import paddle_tpu.ops.schema as jax_schema
import paddle_tpu.ops.schema_compat as jax_schema_compat
import paddle_tpu.sim.clock as jax_clock
import paddle_tpu.sim.workloads as jax_workloads
import paddle_tpu.hapi.callbacks as jax_callbacks
import paddle_tpu.io.dataset as jax_dataset
import paddle_tpu.vision.datasets as jax_vision_datasets
import paddle_tpu.core.native as jax_native
import paddle_tpu.strings as jax_strings
import paddle_tpu.geometric as jax_geometric
import paddle_tpu.inference.serving as jax_serving
import paddle_tpu.version as jax_version
import paddle_tpu.distributed.store as jax_store
import paddle_tpu.distributed.spawn as jax_spawn
import paddle_tpu.distributed.rpc as jax_rpc
import paddle_tpu.distributed.fleet.utils.timer_helper as jax_timer_helper
import paddle_tpu.distributed.fleet.distributed_strategy as jax_dist_strategy
import paddle_tpu.distributed.fleet.elastic as jax_elastic
import paddle_tpu.distributed.auto_parallel.strategy as jax_ap_strategy
import paddle_tpu.distributed.launch.main as jax_launch_main
import paddle_tpu.distributed.ps.graph as jax_ps_graph
import paddle_tpu.distributed.ps.service as jax_ps_service
import paddle_tpu.models.deepfm as jax_deepfm
import paddle_tpu.models.wide_deep as jax_wide_deep
import paddle_tpu.io.sampler as jax_sampler
import paddle_tpu.linalg as jax_linalg_ns
import paddle_tpu.nn.pooling as jax_pooling
import paddle_tpu.vision.models.resnet as jax_resnet
import paddle_tpu.vision.models.vit as jax_vit
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm.sampling import (
    apply_logits_pipeline as jax_pipeline,
)
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
import paddle_tpu_torch.framework.flags as port_flags
from paddle_tpu_torch.inference.llm import (
    BlockManager,
    Fault,
    FaultInjector,
    LLMEngine,
    NoFreeBlocksError,
    Request,
    Scheduler,
    apply_logits_pipeline,
    bucket_size,
    json_array_grammar,
)
import paddle_tpu_torch.inference.llm.block_manager as port_bm
import paddle_tpu_torch.inference.llm.events as port_events
import paddle_tpu_torch.inference.llm.faults as port_faults
import paddle_tpu_torch.inference.llm.interleave as port_interleave
import paddle_tpu_torch.inference.llm.kv_tier as port_kv_tier
import paddle_tpu_torch.inference.llm.scheduler as port_sched
import paddle_tpu_torch.inference.llm.spec as port_spec
import paddle_tpu_torch.inference.llm.structured as port_structured
import paddle_tpu_torch.ops.inventory as port_inventory
import paddle_tpu_torch.ops.schema as port_schema
import paddle_tpu_torch.ops.schema_compat as port_schema_compat
import paddle_tpu_torch.sim.clock as port_clock
import paddle_tpu_torch.sim.workloads as port_workloads
import paddle_tpu_torch.hapi.callbacks as port_callbacks
import paddle_tpu_torch.io.dataset as port_dataset
import paddle_tpu_torch.vision.datasets as port_vision_datasets
import paddle_tpu_torch.core.native as port_native
import paddle_tpu_torch.strings as port_strings
import paddle_tpu_torch.geometric as port_geometric
import paddle_tpu_torch.inference.serving as port_serving
import paddle_tpu_torch.version as port_version
import paddle_tpu_torch.distributed.store as port_store
import paddle_tpu_torch.distributed.spawn as port_spawn
import paddle_tpu_torch.distributed.rpc as port_rpc
import paddle_tpu_torch.distributed.fleet.utils.timer_helper as port_timer_helper
import paddle_tpu_torch.distributed.fleet.distributed_strategy as port_dist_strategy
import paddle_tpu_torch.distributed.fleet.elastic as port_elastic
import paddle_tpu_torch.distributed.auto_parallel.strategy as port_ap_strategy
import paddle_tpu_torch.distributed.launch.main as port_launch_main
import paddle_tpu_torch.distributed.ps.graph as port_ps_graph
import paddle_tpu_torch.distributed.ps.service as port_ps_service
import paddle_tpu_torch.models.deepfm as port_deepfm
import paddle_tpu_torch.models.wide_deep as port_wide_deep
import paddle_tpu_torch.io.sampler as port_sampler
import paddle_tpu_torch.linalg as port_linalg_ns
import paddle_tpu_torch.nn.pooling as port_pooling
import paddle_tpu_torch.vision.models.resnet as port_resnet
import paddle_tpu_torch.vision.models.vit as port_vit
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, token_budget=16)
SEED = 7


def _prompts():
    rng = np.random.RandomState(11)
    shared = list(rng.randint(0, 128, 16))
    return [list(rng.randint(0, 128, 5)),
            list(rng.randint(0, 128, 23)),       # > token_budget: chunked
            shared + [7, 9, 2],                  # shared 2-page prefix
            list(rng.randint(0, 128, 9)),
            shared + [4, 4],
            list(rng.randint(0, 128, 2))]


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
def _full_f32_matmuls():
    """TF32 off, as the exactness contract needs on a CUDA device."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture(scope="module")
def models():
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


@pytest.fixture(scope="module")
def jax_engine(models):
    """One JAX engine for every case whose output does not depend on
    the schedule (greedy and per-request seeded streams)."""
    return JaxEngine(models[0], seed=SEED, **ENGINE)


def _port_engine(models):
    return LLMEngine(models[1], device="cpu", seed=SEED, **ENGINE)


GEN_CASES = {
    "greedy": {},
    "seeded_sampling": dict(temperature=0.8, seed=123),
    "greedy_with_pipeline": dict(top_k=5, repetition_penalty=1.3,
                                 presence_penalty=0.2,
                                 frequency_penalty=0.1,
                                 logit_bias={3: 2.0, 17: -1.5}),
    "sampling_with_pipeline": dict(temperature=0.8, seed=5, top_p=0.9,
                                   min_p=0.05),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_token_exact(models, jax_engine, case):
    kw = GEN_CASES[case]
    prompts = _prompts()
    want = jax_engine.generate(prompts, max_new_tokens=10, **kw)
    eng = _port_engine(models)
    got = eng.generate(prompts, max_new_tokens=10, **kw)
    for w, g in zip(want, got):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert eng.stats["mixed_steps"] >= 1
    assert eng.prefix_cache_stats()["prefix_hit_tokens"] >= 16
    assert len({tuple(g[-10:]) for g in got}) > 1
    eng.block_manager.check_invariants()
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_engine_stream_sampling_token_exact(models):
    """temperature > 0 with no request seed: both engines draw from
    their engine stream in commit order, one vectorized gumbel draw
    per step — exact only if the schedules agree step for step."""
    prompts = _prompts()
    want = JaxEngine(models[0], seed=SEED, **ENGINE).generate(
        prompts, max_new_tokens=6, temperature=0.8)
    got = _port_engine(models).generate(prompts, max_new_tokens=6,
                                        temperature=0.8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_preemption_token_exact(models):
    """A pool of 8 pages cannot hold the batch: the newest sequences
    are preempted and recomputed, on both engines alike."""
    small = dict(ENGINE, num_blocks=8)
    prompts = _prompts()
    want = JaxEngine(models[0], seed=SEED, **small).generate(
        prompts, max_new_tokens=16)
    eng = LLMEngine(models[1], device="cpu", seed=SEED, **small)
    got = eng.generate(prompts, max_new_tokens=16)
    assert eng.scheduler.num_preemptions >= 2
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    eng.block_manager.check_invariants()


def test_bfloat16_engine_serves(models):
    eng = LLMEngine(models[1], device="cpu", dtype="bfloat16", **ENGINE)
    assert eng._kc.dtype == torch.bfloat16
    outs = eng.generate(_prompts(), max_new_tokens=4)
    for p, o in zip(_prompts(), outs):
        assert len(o) == len(p) + 4 and ((o >= 0) & (o < 128)).all()


def test_engine_matches_dense_greedy(models):
    eng = _port_engine(models)
    eng.warmup()
    prompts = _prompts()
    for p, out in zip(prompts, eng.generate(prompts, max_new_tokens=6)):
        np.testing.assert_array_equal(out, models[1].greedy_decode(p, 6))


def test_warmup_covers_every_bucket_and_writes_nothing(models):
    eng = _port_engine(models)
    ms = eng.warmup().compile_ms
    assert list(ms) == ["ragged[8]", "ragged[16]"]
    assert eng.stats["launches"] == 2
    assert torch.count_nonzero(eng._kc) == 0
    assert torch.count_nonzero(eng._vc) == 0


def _seeded_logits(tb=6, v=40, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(tb, v) * 3).astype(np.float32)
    counts = rng.poisson(0.4, size=(tb, v)).astype(np.float32)
    bias = np.zeros((tb, v), np.float32)
    bias[:, 3] = 2.5
    bias[1, 7] = -1e30
    rows = np.array([0, 0, 1, 2, 2, 3], np.int32)
    return logits, counts, bias, rows


PIPE_CASES = {
    "neutral": {},
    "top_k": dict(top_k=[3, 1, 0, 40]),
    "top_p": dict(top_p=[0.5, 0.9, 1.0, 0.05]),
    "min_p": dict(min_p=[0.1, 0.0, 0.5, 1.0]),
    "repetition": dict(rep_pen=[1.5, 0.7, 1.0, 2.0]),
    "presence": dict(pres_pen=[0.5, -0.3, 0.0, 1.0]),
    "frequency": dict(freq_pen=[0.25, 0.0, -0.5, 1.0]),
    "bias": dict(bias=True),
    "all_knobs": dict(top_k=[5, 0, 2, 9], top_p=[0.8, 0.95, 1.0, 0.6],
                      min_p=[0.05, 0.1, 0.0, 0.2],
                      rep_pen=[1.2, 1.0, 0.9, 1.1],
                      pres_pen=[0.1, 0.0, 0.3, 0.2],
                      freq_pen=[0.05, 0.2, 0.0, 0.1], bias=True),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_logits_pipeline_matches_jax(case):
    import jax.numpy as jnp

    spec = dict(PIPE_CASES[case])
    logits, counts, bias, rows = _seeded_logits(seed=len(case))
    if not spec.pop("bias", False):
        bias = np.zeros_like(bias)
    if case == "neutral":
        counts = np.zeros_like(counts)
    r = 4
    knobs = [np.asarray(spec.get("top_k", [0] * r), np.int32)] + [
        np.asarray(spec.get(name, [default] * r), np.float32)
        for name, default in (("top_p", 1.0), ("min_p", 0.0),
                              ("rep_pen", 1.0), ("pres_pen", 0.0),
                              ("freq_pen", 0.0))]
    want = np.asarray(jax_pipeline(
        jnp.asarray(logits), jnp.asarray(rows),
        *(jnp.asarray(k) for k in knobs), jnp.asarray(bias),
        jnp.asarray(counts)))
    t = torch.from_numpy
    got = apply_logits_pipeline(t(logits), t(rows), *(t(k) for k in knobs),
                                t(bias), t(counts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if case == "neutral":
        np.testing.assert_array_equal(got, logits)


# keywords that were later work and are ported now (int8 serving, the
# memory model, the request lifecycle, the request surface, multi-LoRA,
# the host-RAM KV tier and tensor parallelism, with the tier; speculation,
# lookahead, LoRA, the tier and tensor parallelism have files of their
# own, test_torch_spec.py, test_torch_draft_model.py,
# test_torch_lookahead.py, test_torch_lora.py, test_torch_kv_tier.py,
# test_torch_tp.py and test_torch_tp_*.py): accepted, and their engines
# serve
PORTED_ENGINE_KWARGS = {
    "tensor_parallel": dict(tensor_parallel=2, kv_tier=1 << 20),
    "mesh": dict(mesh=["cpu", "cpu"], kv_tier=1 << 20),
    "lora": 4, "kv_tier": 1 << 20,
    "quantize": "int8", "memory_budget": "16GiB",
    "faults": lambda: FaultInjector(
        [Fault("step", "transient", step=1, count=1)]),
    "retry": 3, "clock": lambda: _TickClock(), "step_timeout_s": 1.0,
    "max_queue": 4, "record_step_gauges": True,
    "detokenizer": lambda: _detok,
}
PORTED_REQUEST_KWARGS = {
    "adapter_id": dict(adapter_id="t1"),
    "grammar": dict(grammar=json_array_grammar(
        128, open_id=10, close_id=11, comma_id=12, item_ids=(20, 21),
        eos_id=1, max_items=2), eos_token_id=1),
    "stop": dict(stop="zz"), "logprobs": dict(logprobs=2),
    "n": dict(n=2, seed=3), "deadline_ms": dict(deadline_ms=1e6),
}


class _TickClock:
    """An injected clock: one second per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _detok(ids):
    return "".join(chr(97 + int(t) % 26) for t in ids)


@pytest.mark.parametrize("key", list(PORTED_ENGINE_KWARGS))
def test_ported_engine_keywords_accepted(models, key):
    value = PORTED_ENGINE_KWARGS[key]
    value = value() if callable(value) else value
    # the tensor-parallel cases take their keywords with the tier's
    kwargs = value if key in ("tensor_parallel", "mesh") else {key: value}
    eng = LLMEngine(models[1], device="cpu", **kwargs, **ENGINE)
    try:
        out = eng.generate(_prompts()[:2], max_new_tokens=3)
    finally:
        if eng._tp is not None:
            eng._tp.close()
    assert [len(o) for o in out] == [len(p) + 3 for p in _prompts()[:2]]
    assert eng.block_manager.num_free_blocks == eng.num_blocks


@pytest.mark.parametrize("key", list(PORTED_REQUEST_KWARGS))
def test_ported_request_keywords_accepted(models, key):
    eng = LLMEngine(models[1], device="cpu", seed=SEED, detokenizer=_detok,
                    lora=2 if key == "adapter_id" else None, **ENGINE)
    if key == "adapter_id":
        rng = np.random.RandomState(SEED)
        eng.add_adapter("t1", {
            k: (rng.randn(L, d_in, 8).astype(np.float32),
                rng.randn(L, 8, d_out).astype(np.float32))
            for k, (L, d_in, d_out) in eng._lora_shapes.items()})
    out = eng.generate(_prompts()[:2], max_new_tokens=3,
                       **PORTED_REQUEST_KWARGS[key])
    assert len(out) == 2
    for fam, p in zip(out, _prompts()[:2]):
        for o in (fam if key == "n" else [fam]):
            assert len(p) < len(o) <= len(p) + 3
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_request_validation(models):
    eng = _port_engine(models)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request([1], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request([1] * 60, max_new_tokens=10)
    with pytest.raises(ValueError, match="top_p"):
        eng.add_request([1], top_p=0.0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        eng.add_request([1], bogus=1)


def test_eos_stops_early_and_frees(models):
    eng = _port_engine(models)
    prompt = _prompts()[0]
    full = eng.generate([prompt], max_new_tokens=6)[0]
    eos = int(full[len(prompt) + 2])
    rid = eng.add_request(prompt, max_new_tokens=6, eos_token_id=eos)
    outs = []
    while eng.has_unfinished():
        outs.extend(eng.step())
    (out,) = outs
    assert out.request_id == rid and out.finish_reason == "stop"
    assert out.output_ids[-1] == eos and len(out.output_ids) <= 3
    assert out.metrics["first_token"] >= out.metrics["arrival"]
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_default_device_needs_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(models[1], **ENGINE)


# ------------------------------------------------ the copied host modules --
@pytest.mark.parametrize("jax_mod,port_mod", [
    (jax_bm, port_bm), (jax_sched, port_sched),
    (jax_faults, port_faults), (jax_events, port_events),
    (jax_interleave, port_interleave), (jax_structured, port_structured),
    (jax_spec, port_spec), (jax_kv_tier, port_kv_tier),
    (jax_workloads, port_workloads), (jax_clock, port_clock),
    (jax_flags, port_flags), (jax_schema, port_schema),
    (jax_schema_compat, port_schema_compat),
    (jax_inventory, port_inventory),
    (jax_pooling, port_pooling), (jax_linalg_ns, port_linalg_ns),
    (jax_vit, port_vit), (jax_resnet, port_resnet),
    (jax_dataset, port_dataset), (jax_sampler, port_sampler),
    (jax_callbacks, port_callbacks),
    (jax_vision_datasets, port_vision_datasets),
    (jax_native, port_native), (jax_strings, port_strings),
    (jax_geometric, port_geometric), (jax_serving, port_serving),
    (jax_version, port_version),
    (jax_store, port_store),
    (jax_spawn, port_spawn),
    (jax_rpc, port_rpc),
    (jax_timer_helper, port_timer_helper),
    (jax_dist_strategy, port_dist_strategy),
    (jax_elastic, port_elastic),
    (jax_ap_strategy, port_ap_strategy),
    (jax_launch_main, port_launch_main),
    (jax_ps_service, port_ps_service), (jax_ps_graph, port_ps_graph),
    (jax_deepfm, port_deepfm), (jax_wide_deep, port_wide_deep)])
def test_host_modules_are_verbatim_copies(jax_mod, port_mod):
    assert inspect.getsource(port_mod) == inspect.getsource(jax_mod)


class TestBlockManagerCopy:
    def test_alloc_free_roundtrip(self):
        bm = BlockManager(num_blocks=8, block_size=4)
        t = bm.allocate("a", 10)
        assert len(t) == 3 and bm.num_free_blocks == 5
        assert bm.block_table("a") == t and bm.num_tokens("a") == 10
        bm.free("a")
        assert bm.num_free_blocks == 8 and not bm.has_seq("a")

    def test_oom_raises_and_preserves_state(self):
        bm = BlockManager(num_blocks=2, block_size=4)
        bm.allocate("a", 8)
        with pytest.raises(NoFreeBlocksError):
            bm.allocate("b", 1)
        with pytest.raises(NoFreeBlocksError):
            bm.append_slot("a")
        assert bm.num_tokens("a") == 8
        bm.free("a")
        assert bm.num_free_blocks == 2

    def test_append_slots_cow_then_rollback_restores_books(self):
        bm = BlockManager(num_blocks=8, block_size=4)
        bm.allocate("parent", 6)
        bm.fork("parent", "child")
        slots, cows = bm.append_slots("child", 3)
        assert len(cows) == 1 and len(slots) == 3
        src, dst = cows[0]
        assert dst == bm.block_table("child")[-2] and dst != src
        bm.rollback_slots("child", 3)
        assert bm.num_tokens("child") == 6
        assert bm.block_table("child")[-1] == dst
        bm.check_invariants()
        bm.free("parent")
        bm.free("child")
        assert bm.num_free_blocks == 8

    def test_prefix_cache_adopts_and_parks_on_lru(self):
        bm = BlockManager(num_blocks=6, block_size=4,
                          enable_prefix_caching=True)
        ids = list(range(10))
        bm.allocate("a", 10)
        for i, h in enumerate(bm.prefix_chain_hashes(ids)):
            bm.register_full_block("a", i, h)
        bm.free("a")
        assert bm.num_cached_blocks == 2 and bm.num_free_blocks == 6
        hashes = bm.prefix_chain_hashes(ids, limit=2)
        assert bm.match_prefix(hashes) == 2
        table = bm.allocate("b", 10, cached_hashes=hashes)
        assert bm.prefix_reused_blocks == 2 and len(table) == 3
        bm.check_invariants()


class TestSchedulerCopy:
    @staticmethod
    def _req(rid, n_prompt, max_new=8):
        return Request(request_id=rid, prompt_ids=tuple(range(n_prompt)),
                       max_new_tokens=max_new)

    @staticmethod
    def _run_chunks(batch):
        for c in batch.chunks:
            c.request.num_cached = c.start + c.length

    def test_long_prompt_chunks_and_mixes_with_decodes(self):
        bm = BlockManager(16, 4)
        sched = Scheduler(bm, max_batch=2, token_budget=4)
        sched.add(self._req(0, 4))
        b = sched.schedule()
        assert b.kind == "mixed" and b.chunks[0].is_final
        self._run_chunks(b)
        sched.add(self._req(1, 10))
        expect = [(0, 3), (3, 3), (6, 3), (9, 1)]
        for i, (start, length) in enumerate(expect):
            b = sched.schedule()
            assert b.kind == "mixed"
            assert [r.request_id for r in b.requests] == [0]
            c = b.chunks[0]
            assert (c.start, c.length) == (start, length)
            assert c.is_final == (i == len(expect) - 1)
            self._run_chunks(b)
        b = sched.schedule()
        assert b.kind == "decode" and len(b.requests) == 2

    def test_preempt_on_oom_recycles_and_requeues(self):
        bm = BlockManager(5, 4)
        sched = Scheduler(bm, max_batch=2)
        sched.add(self._req(0, 8))
        sched.add(self._req(1, 8))
        b = sched.schedule()
        assert b.kind == "mixed" and len(b.chunks) == 2
        self._run_chunks(b)
        b = sched.schedule()
        assert b.kind == "decode"
        assert [r.request_id for r in b.requests] == [0]
        assert sched.num_preemptions == 1
        victim = sched.waiting[0]
        assert victim.request_id == 1 and victim.num_cached == 0
        assert bm.num_free_blocks == 2

    def test_bucket_size(self):
        assert bucket_size(3, 8) == 4
        assert bucket_size(9, 8) == 8
        assert bucket_size(5, 64, floor=8) == 8
        assert bucket_size(2, 4, floor=8) == 4
