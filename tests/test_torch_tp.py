"""Tensor-parallel serving in the port (``LLMEngine(tensor_parallel=N)``,
``mesh=``) against the port's tp=1 engine and the JAX package's tp=1
engine.

The JAX engine's contract for tensor parallelism is greedy tokens exact
against tp=1 (``paddle_tpu/inference/llm/engine.py``'s module docstring;
``tests/test_llm_engine.py::TestTensorParallel``).  The JAX TP tests
themselves fail under the installed jax (``shard_map``'s ``check_rep``),
but its tp=1 engine runs, so every case here holds the port's tp=2 (and
one tp=4) engine, ranks as gloo processes on the CPU, to the port's tp=1
and the JAX tp=1 engine on ``gpt_tiny(num_layers=2)`` in f32 with the
same seeded weights carried over as numpy: prefix-cache hits, preemption
with recompute, int8 weights and K/V, multi-LoRA (all four targets, so
qkv's permuted B and the row targets' partial deltas, with an eviction),
n-gram, draft-model and tree speculation, lookahead, and the fault soak
of ``tests/test_faults.py::TestChaosSoak`` at tp=2.  The row-parallel
sums round differently from one GEMM, so logits are not bitwise: the
teacher-forced logits of a step at tp=2 sit within 1e-4 of tp=1's.
Beside them: each rank's pool holds ``nh / tp`` heads and its shards are
the permuted slices, the memory model is the JAX engine's
``_params_bytes_per_chip``, the validation errors, the entry points left
for A20b, a killed worker surfacing as ``PoolLostError`` without a hang,
an SSE request through ``HttpLLMServer``, and workers that import no JAX.
"""

import http.client
import json
import os
import signal
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm.engine import (
    _params_bytes_per_chip as jax_params_bytes_per_chip,
)
from paddle_tpu.inference.llm.engine import (
    _qkv_head_permutation as jax_qkv_head_permutation,
)
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.framework.cost import StepTimeModel
from paddle_tpu_torch.inference.llm import (
    FaultInjector,
    Fleet,
    HttpLLMServer,
    LLMEngine,
    PoolLostError,
    to_records,
)
from paddle_tpu_torch.inference.llm import tensor_parallel as tpmod
from paddle_tpu_torch.inference.llm.quality import engine_logits
from paddle_tpu_torch.models.gpt import gpt_tiny

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
SPEC_ENGINE = dict(block_size=8, max_batch=4, max_model_len=64,
                   token_budget=64)
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


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread (the workers take rank 0's count): the tiny
    CPU steps gain nothing from more, and idle intra-op threads spinning
    beside other test processes slow the JAX compiles several-fold."""
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


@pytest.fixture(scope="module")
def spawned():
    """Closes every tensor-parallel engine a test of this module built,
    at the module's end (an engine's finalizer would, once collected)."""
    engines = []
    yield engines
    for eng in engines:
        eng._tp.close()


def _port(models, spawned=None, **kw):
    eng = LLMEngine(models[1], device="cpu", **{**ENGINE, **kw})
    if eng._tp is not None and spawned is not None:
        spawned.append(eng)
    return eng


def _jax(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def tp2(models, spawned):
    """One tp=2 engine at the ENGINE geometry, shared by the cases that
    read its construction or serve through it."""
    return _port(models, spawned, tensor_parallel=2)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype(np.int32) for n in lengths]


def _same(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)


def _lora_weights(eng, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    out = {}
    for key in eng.lora.targets:
        layers, d_in, d_out = eng._lora_shapes[key]
        r = eng.lora.rank
        out[key] = (rng.standard_normal((layers, d_in, r))
                    .astype(np.float32) * scale,
                    rng.standard_normal((layers, r, d_out))
                    .astype(np.float32) * scale)
    return out


# ------------------------------------------------------------ validation --
def test_validation_not_divisible_and_disagrees(models):
    with pytest.raises(ValueError, match="not divisible"):
        _port(models, tensor_parallel=3)        # 4 heads
    odd = gpt_tiny(device="cpu", num_layers=1, intermediate_size=66)
    with pytest.raises(ValueError, match="not divisible"):
        LLMEngine(odd, device="cpu", tensor_parallel=4, **ENGINE)
    with pytest.raises(ValueError, match="disagrees"):
        _port(models, tensor_parallel=2, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="first entry"):
        LLMEngine(models[1], device="cuda:0", mesh=["cpu", "cpu"], **ENGINE)
    with pytest.raises(ValueError, match="sequence of device specs"):
        _port(models, mesh="cpu")
    with pytest.raises(ValueError, match="all CUDA devices or all CPU"):
        tpmod.resolve_mesh(mesh=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="A20b"):
        _port(models, tensor_parallel=2, kv_tier=1 << 20)
    with pytest.raises(NotImplementedError, match="A20b"):
        Fleet(models[1], replicas=2, device="cpu", tensor_parallel=2,
              **ENGINE)


def test_mesh_resolution_and_backend():
    cpu = torch.device("cpu")
    assert tpmod.resolve_mesh(2, None, "cpu") == [cpu, cpu]
    assert tpmod.resolve_mesh(None, ["cpu"] * 4, "cpu") == [cpu] * 4
    assert tpmod.resolve_mesh(1, None, "cpu") == [cpu]
    assert tpmod.mp_backend([cpu, cpu]) == "gloo"
    one_card = [torch.device("cuda", 0)] * 2
    assert tpmod.mp_backend(one_card) == "gloo"
    assert tpmod.mp_backend([torch.device("cuda", 0),
                             torch.device("cuda", 1)]) == "nccl"


def test_permutation_is_the_jax_one():
    for nh, hd, tp in ((4, 16, 2), (4, 16, 4), (12, 64, 2)):
        np.testing.assert_array_equal(
            tpmod.qkv_head_permutation(nh, hd, tp),
            jax_qkv_head_permutation(nh, hd, tp))


# ---------------------------------------------------- the shared engine --
def test_prefix_cache_hits_token_exact(models, tp2):
    """The JAX engine's prefix-hit case: the second prompt adopts the
    first's three full pages, written on every rank by one allocator."""
    rng = np.random.RandomState(10)
    prefix = rng.randint(0, 128, (24,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, 128, (n,))
                               .astype(np.int32)]) for n in (4, 6)]
    jax_eng, one = _jax(models), _port(models)
    want = [jax_eng.generate([p], max_new_tokens=8)[0] for p in prompts]
    _same([one.generate([p], max_new_tokens=8)[0] for p in prompts], want)
    hits0 = tp2.prefix_cache_stats()["prefix_hit_tokens"]
    _same([tp2.generate([p], max_new_tokens=8)[0] for p in prompts], want)
    assert tp2.prefix_cache_stats()["prefix_hit_tokens"] - hits0 == 24
    assert tp2.block_manager.num_free_blocks == tp2.num_blocks
    assert tp2.tp == 2 and tp2._tp.backend == "gloo"


def test_rank_pools_shards_and_imports(models, tp2):
    """Each rank's pool is [L, NB * bs + 1, nh / tp, D]; its shard is
    the head-major permuted global params sliced as TP_BLOCK_SPLITS
    says (rank 0's tensors compared whole, the worker's by each leaf's
    float64 sum); the worker's ``sys.modules`` holds no JAX module and
    nothing of the JAX package."""
    one = _port(models)
    nh, hd, tp = one.num_heads, one.head_dim, 2
    perm = torch.as_tensor(tpmod.qkv_head_permutation(nh, hd, tp))
    stats = tp2._rank_stats(detail=True)
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[1]["pid"] != os.getpid()
    for s in stats:
        assert s["pool_shape"] == [one.num_layers,
                                   one.num_blocks * one.block_size + 1,
                                   nh // tp, hd]
    # this process imported the JAX package for the references; the
    # worker imported only the port
    assert stats[1]["foreign_modules"] == []
    assert tuple(tp2._k_rows.shape) == tuple(stats[0]["pool_shape"])
    blocks = dict(one.params["blocks"])
    for key in ("attn.qkv.weight", "attn.qkv.bias"):
        blocks[key] = blocks[key][..., perm]
    for rank, s in enumerate(stats):
        for key, w in blocks.items():
            dim = tpmod.TP_BLOCK_SPLITS.get(key)
            if dim is not None:
                n = w.shape[dim] // tp
                w = w.narrow(dim, rank * n, n)
            if rank == 0:
                assert torch.equal(tp2.params["blocks"][key], w), key
            assert s["leaf_sums"][f"blocks/{key}"] == \
                float(w.contiguous().double().sum()), (rank, key)


def test_memory_model_is_the_jax_per_chip_model(models, tp2):
    jax_eng = _jax(models)
    mm = tp2.memory_model()
    assert mm["tp"] == 2
    assert mm["weights_bytes"] == jax_params_bytes_per_chip(
        jax_eng.params, 2)
    assert mm["weights_bytes"] == tpmod.params_bytes_per_chip(
        _port(models).params, 2)
    assert mm["page_bytes"] == jax_eng.page_bytes // 2 == tp2.page_bytes
    assert mm["kv_pool_bytes"] == tp2.num_blocks * mm["page_bytes"]
    assert mm["host_page_bytes"] == 2 * mm["page_bytes"]
    stats = tp2._rank_stats()
    assert [s["params_bytes"] for s in stats] == [mm["weights_bytes"]] * 2


def test_entry_points_left_for_a20b(models, tp2):
    with pytest.raises(ValueError, match="tp=1"):
        engine_logits(tp2, [1, 2, 3])
    with pytest.raises(NotImplementedError, match="A20b"):
        StepTimeModel.from_engine(tp2)
    with pytest.raises(NotImplementedError, match="A20b"):
        tp2.export_request(0)
    with pytest.raises(NotImplementedError, match="A20b"):
        tp2.import_request(None, None, None, None)


def _post_stream(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        events = [c[len("data: "):] for c in resp.read().decode()
                  .split("\n\n") if c.startswith("data: ")]
    finally:
        conn.close()
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_http_sse_greedy_equals_tp1_generate(models, tp2):
    """One greedy request streamed over SSE from ``HttpLLMServer`` over
    the tp=2 engine (its worker thread steps rank 0 only) equals the
    tp=1 engine's ``generate``."""
    p = [int(t) for t in np.random.RandomState(3).randint(0, 128, (7,))]
    want = _port(models).generate([p], max_new_tokens=6)[0][len(p):]
    srv = HttpLLMServer(engine=tp2).start()
    try:
        events = _post_stream(srv.address, {
            "prompt_ids": p, "max_new_tokens": 6, "stream": True})
    finally:
        srv.close()
    got = [t for e in events for t in e.get("delta_ids", [])]
    np.testing.assert_array_equal(got, want)
    assert tp2.block_manager.num_free_blocks == tp2.num_blocks


def test_teacher_forced_logits_within_1e4(models, tp2):
    """One packed step over a 20-token chunk on fresh pages: the tp=2
    logits (row-parallel partials summed across the ranks) within
    atol = rtol = 1e-4 of the tp=1 step's."""
    toks = np.random.RandomState(4).randint(0, 128, 20)
    got = []
    for eng in (_port(models), tp2):
        bm = eng.block_manager
        table = bm.allocate("teacher", len(toks))
        try:
            pk = eng._pack_rows([(toks, 0, table)], 32)
            _argmax, logits = eng._ragged_fn(pk)
            got.append(logits[:len(toks)].double().numpy())
        finally:
            bm.free("teacher")
    np.testing.assert_allclose(got[1], got[0], atol=1e-4, rtol=1e-4)
    print(f"tp=2 vs tp=1 teacher-forced max |dlogit| "
          f"{np.abs(got[1] - got[0]).max()}")


# ---------------------------------------------- engines of their own --
def test_preemption_token_exact_tp4(models, spawned):
    """5 pages for 3 sequences of 4 pages each: preempt and recompute
    with every page write fanned out over four pool shards."""
    prompts = _prompts(11, (4, 4, 4))
    kw = dict(block_size=8, num_blocks=5, max_batch=3, max_model_len=40)
    want = JaxEngine(models[0], **kw).generate(prompts, max_new_tokens=28)
    one = LLMEngine(models[1], device="cpu", **kw)
    _same(one.generate(prompts, max_new_tokens=28), want)
    eng = LLMEngine(models[1], device="cpu", tensor_parallel=4, **kw)
    spawned.append(eng)
    _same(eng.generate(prompts, max_new_tokens=28), want)
    assert eng.scheduler.num_preemptions > 0
    assert eng.scheduler.num_preemptions == one.scheduler.num_preemptions
    assert eng.block_manager.num_free_blocks == eng.num_blocks
    assert [s["pool_shape"][2] for s in eng._rank_stats()] == [1] * 4


def test_int8_token_exact(models, spawned):
    """int8 weights (quantized before the shard, so a row-parallel
    weight's scale sees all its rows) and int8 K/V pools whose scales
    shard with the heads."""
    prompts = _prompts(3, (5, 9, 13, 7))
    want = _jax(models, quantize="int8").generate(prompts,
                                                  max_new_tokens=8)
    _same(_port(models, quantize="int8").generate(prompts,
                                                  max_new_tokens=8), want)
    eng = _port(models, spawned, quantize="int8", tensor_parallel=2)
    _same(eng.generate(prompts, max_new_tokens=8), want)
    nb, bs = eng.num_blocks, eng.block_size
    for s in eng._rank_stats():
        assert s["scale_pool_shape"] == [2, (nb + 1) * 2 * bs]
    assert eng.memory_model()["kv_quantized"]


def test_lora_token_exact_with_eviction(models, spawned):
    """Three adapters over two usable slots, every target (qkv's B
    permuted head-major before its column split; proj and fc_out's A
    split on the rows, their partial deltas summed in the all-reduce),
    base rows beside adapter rows."""
    lora = dict(rank=4, max_adapters=3)
    prompts = _prompts(2, (5, 8, 6, 9, 4))
    ids = [None, "a0", "a1", "a2", "a0"]

    def run(eng):
        for i in range(3):
            eng.add_adapter(f"a{i}", _lora_weights(eng, seed=4 + i))
        rids = [eng.add_request(p, max_new_tokens=8, adapter_id=a)
                for p, a in zip(prompts, ids)]
        outs = {}
        while eng.has_unfinished():
            for o in eng.step():
                outs[o.request_id] = o.all_ids
        return [outs[r] for r in rids]

    want = run(_jax(models, lora=lora))
    one = _port(models, lora=lora)
    _same(run(one), want)
    eng = _port(models, spawned, lora=lora, tensor_parallel=2)
    _same(run(eng), want)
    assert eng.lora_stats() == one.lora_stats()
    assert eng.lora_stats()["evictions"] >= 1
    assert to_records(eng.events) == to_records(one.events)


SPEC_CASES = {
    "ngram": dict(speculative=4),
    "draft-model": dict(speculative={"method": "draft-model",
                                     "num_tokens": 4, "draft_layers": 1}),
    "tree": dict(speculative={"method": "tree", "num_tokens": 4,
                              "draft_layers": 1}),
    "lookahead": dict(lookahead=True),
}


@pytest.fixture(scope="module")
def spec_want(models):
    """The plain JAX tp=1 engine's greedy tokens for the speculation
    cases (speculation and lookahead are token-exact against plain
    decode at tp=1)."""
    return _jax(models, **SPEC_ENGINE).generate(_spec_prompts(),
                                                max_new_tokens=16)


def _spec_prompts():
    rng = np.random.RandomState(19)
    unit = list(rng.randint(0, 128, 3))
    return [np.array(unit * 3, np.int32),
            rng.randint(0, 128, 7).astype(np.int32),
            np.array(unit * 2 + [5], np.int32),
            rng.randint(0, 128, 13).astype(np.int32)]


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculation_and_lookahead_token_exact(models, spawned, spec_want,
                                               case):
    kw = {**SPEC_ENGINE, **SPEC_CASES[case]}

    def run(eng):
        if eng.spec is not None and eng.spec.uses_draft_model:
            # the n-gram leg hits constantly on toy prompts: mute it so
            # the draft model is what gets verified (as the JAX tests do)
            eng.drafter._ngram.propose = lambda *a, **k: []
        eng.warmup()
        return eng.generate(_spec_prompts(), max_new_tokens=16)

    one = _port(models, **kw)
    _same(run(one), spec_want)
    eng = _port(models, spawned, tensor_parallel=2, **kw)
    _same(run(eng), spec_want)
    assert eng.spec_stats() == one.spec_stats()
    assert to_records(eng.events) == to_records(one.events)
    if case == "lookahead":
        assert eng.lifecycle_stats()["staged_hits"] > 0
    else:
        assert eng.spec_stats()["accepted_tokens"] > 0
    if eng._draft_bm is not None:
        assert eng._draft_bm.num_free_blocks == eng.num_blocks
        assert [s["draft_pool_shape"][2] for s in eng._rank_stats()] == \
            [2, 2]
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def _drive(eng, faults=None):
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


@pytest.mark.parametrize("spec", [None, 2])
def test_fault_soak_tp2(models, spawned, spec):
    """``tests/test_faults.py``'s soak at tp=2: a seeded random fault
    schedule (transients, OOMs, delays, client aborts) over six
    requests; survivors token-exact against the fault-free JAX tp=1
    run, no page leaked, and the seed replayed at tp=2 and at tp=1
    gives the same fault and event logs."""
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (4, 11, 7, 19, 5, 9)]
    kw = dict(speculative=spec)
    ref = _jax(models, **kw)
    for p in prompts:
        ref.add_request(p, max_new_tokens=10)
    refs = {rid: o.all_ids for rid, o in _drive(ref).items()}

    def chaos(tp):
        fi = FaultInjector.random(
            13, steps=256, p_step=0.03, p_transient=0.1, p_oom=0.08,
            p_delay=0.03, p_abort=0.05, delay_s=0.002)
        eng = _port(models, spawned if tp > 1 else None, faults=fi,
                    retry=_FAST_RETRY, step_timeout_s=0.001,
                    tensor_parallel=tp, **kw)
        eng.warmup()
        for p in prompts:
            eng.add_request(p, max_new_tokens=10)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = _drive(eng, faults=fi)
        assert eng.block_manager.num_free_blocks == eng.num_blocks
        return eng, fi, outs

    eng_a, fi_a, outs_a = chaos(2)
    assert fi_a.events
    for rid, out in outs_a.items():
        if out.ok:
            np.testing.assert_array_equal(out.all_ids, refs[rid])
        elif out.finish_reason != "error":
            got = out.all_ids
            np.testing.assert_array_equal(got, refs[rid][:len(got)])
    eng_b, fi_b, _outs_b = chaos(2)
    eng_c, fi_c, _outs_c = chaos(1)
    assert fi_a.events == fi_b.events == fi_c.events
    assert eng_a.events == eng_b.events == eng_c.events


def test_killed_worker_is_pool_lost_without_hang(models, spawned):
    """SIGKILL the worker mid-generation: the next ``step()`` raises
    PoolLostError (a RankLostError) well within the group timeout, and
    no worker process is left behind."""
    eng = _port(models, spawned, tensor_parallel=2)
    for p in _prompts(5, (6, 9)):
        eng.add_request(p, max_new_tokens=12)
    eng.step()
    eng.step()
    (proc,) = eng._tp.processes
    os.kill(proc.pid, signal.SIGKILL)
    proc.join(timeout=10)
    t0 = time.perf_counter()
    with pytest.raises(PoolLostError, match="rank is gone"):
        while eng.has_unfinished():
            eng.step()
    assert time.perf_counter() - t0 < tpmod.GROUP_TIMEOUT_S
    assert eng._tp.closed
    assert not any(p.is_alive() for p in eng._tp.processes)


def test_wait_on_a_collective_sees_a_dead_worker_at_once():
    """Rank 0's wait on a collective that never completes (a dead peer
    whose socket never fails it) ends as soon as a worker has exited:
    the channel raises RankLostError (after ``on_lost``) well inside
    the group timeout, and a wait that completes returns at once."""
    class Work:
        def __init__(self, done):
            self.done, self.waited = done, False

        def is_completed(self):
            return self.done

        def wait(self):
            self.waited = True

    class Group:
        def __init__(self, work):
            self.work = work

        def broadcast(self, tensors, opts):
            return self.work

    ch = tpmod._Channel.__new__(tpmod._Channel)
    ch.rank, ch.tp, ch.bcast_s, ch.bcasts = 0, 2, 0.0, 0
    lost = []
    ch.on_lost = lambda: lost.append(True)
    exits = iter([None, None, "worker tp-rank-1 (exit code -9)"])
    ch.watch = lambda: next(exits)
    ch.ctrl = Group(Work(done=False))
    t0 = time.perf_counter()
    with pytest.raises(tpmod.RankLostError, match="exit code -9"):
        ch.bcast(torch.zeros(4, dtype=torch.int64))
    assert time.perf_counter() - t0 < 1.0 and lost == [True]
    done = Work(done=True)
    ch.ctrl = Group(done)
    ch.bcast(torch.zeros(4, dtype=torch.int64))
    assert done.waited and ch.bcasts == 1
