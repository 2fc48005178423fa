"""The step bodies that a CUDA graph captures, run eagerly on the CPU.

The serving engine's ragged step and FusedMultiTransformer's decode step
are each one body of device tensors, captured once per token bucket or
batch size on the card (``paddle_tpu_torch/jit/graphs.py``) and run
directly here:

- padding tokens of a bucket write only the sink rows past the visible
  pools (the draft model's body over its own pools too): every slot no
  live token writes keeps its bytes (pools, and the int8 engine's scale
  pools too), and the live slots hold what the JAX
  engine's step writes (f32 at 1e-5; bf16 at 2 bf16 ulps, since the two
  packages round bf16 GEMM sums apart; int8 within one quantization
  step and scales at 1e-5 relative);
- the decode body, its offset a device tensor, equals bitwise the int
  offset composition the FMT ran before (kept below as the reference);
- ``stats["launches"]`` and ``decode_steps`` count step calls, and a
  graph's kernel launches are counted per replay, not per capture.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
import paddle_tpu_torch.incubate.nn as port_nn
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn.functional import ragged_decode_attention
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.jit.graphs import StepGraphs
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import decode_attention_kernel, registry

ENGINE = dict(block_size=8, max_batch=4, token_budget=16)
# two prompts of 5 and 6 tokens: one 11-token step in the 16-token
# bucket, 5 padding tokens
PROMPTS = ([3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46])


@pytest.fixture(scope="module")
def models():
    """The JAX gpt_tiny (``paddle.seed(0)``) and the port's, carrying its
    weights by name."""
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    pm = gpt_tiny(device="cpu", num_layers=2, seed=1)
    pm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, pm


def _noise_like(t, rng):
    if t.dtype == torch.int8:
        return torch.from_numpy(rng.randint(-127, 128, t.shape)
                                .astype(np.int8))
    return torch.from_numpy(rng.randn(*t.shape).astype(np.float32)).to(
        t.dtype)


def _live_slots(eng, nb, bs):
    """[NB, bs] mask of the slots the prompts' tokens occupy."""
    live = torch.zeros(nb, bs, dtype=torch.bool)
    for rid, prompt in enumerate(PROMPTS):
        table = eng.block_manager.block_table(rid)
        for pos in range(len(prompt)):
            live[table[pos // bs], pos % bs] = True
    return live


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_padding_never_reaches_the_visible_pools(models, kind):
    jm, pm = models
    kw = ({"quantize": "int8"} if kind == "int8"
          else {"dtype": kind if kind == "bfloat16" else None})
    je = JaxEngine(jm, **ENGINE, **kw)
    pe = LLMEngine(pm, device="cpu", **ENGINE, **kw)
    names = ["_kc", "_vc"] + (["_ks", "_vs"] if kind == "int8" else [])
    rng = np.random.RandomState(5)
    before = {}
    for name in names:
        getattr(pe, name).copy_(_noise_like(getattr(pe, name), rng))
        before[name] = getattr(pe, name).clone()
    for eng in (je, pe):
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=4)
        eng.step()
    assert pe.stats["launches"] == 1
    nb, bs = pe.num_blocks, pe.block_size
    live = _live_slots(pe, nb, bs)
    assert torch.equal(live, _live_slots(je, nb, bs))
    assert int(live.sum()) == sum(map(len, PROMPTS))
    for name in names:
        got = getattr(pe, name)
        want = torch.from_numpy(np.array(getattr(je, name), np.float32))
        # scale pools are [L, NB, Nh, bs]: the slot mask spans dims 1, 3
        mask = live if name in ("_kc", "_vc") else live[:, None, :].expand(
            nb, pe.num_heads, bs)
        assert torch.equal(got[:, ~mask], before[name][:, ~mask]), name
        got_live, want_live = got[:, mask].float(), want[:, mask]
        if kind == "int8" and name in ("_kc", "_vc"):
            assert float((got_live - want_live).abs().max()) <= 1.0, name
        elif kind == "bfloat16":
            np.testing.assert_allclose(got_live.numpy(), want_live.numpy(),
                                       rtol=2 ** -7, atol=2 ** -7,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got_live.numpy(), want_live.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def _int_offset_decode(fmt, ids, ck, cv, offset):
    """The one-token step as the FMT composed it before its offset became
    a device tensor: slice writes at the int ``offset``, lengths from
    ``torch.full``, positions from ``torch.arange``."""
    emb = fmt.params["embed"]
    pos = torch.arange(offset, offset + 1)
    x = (emb["word_embeddings.weight"][ids]
         + emb["position_embeddings.weight"][pos][None]).to(fmt.dtype)
    for i, p in enumerate(fmt._layers):
        b, t, h = x.shape
        hh = port_nn._fused_layernorm(x, p["ln_1.weight"], p["ln_1.bias"],
                                      fmt.eps)
        qkv = (hh @ p["attn.qkv.weight"] + p["attn.qkv.bias"]).reshape(
            b, t, 3, fmt.num_heads, h // fmt.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ck[i][:, offset:offset + t] = k.to(ck.dtype)
        cv[i][:, offset:offset + t] = v.to(cv.dtype)
        lengths = torch.full((b,), offset + 1, dtype=torch.int32)
        out = ragged_decode_attention(q[:, 0].contiguous(), ck[i], cv[i],
                                      lengths)
        x = (x + out.to(x.dtype).reshape(b, 1, h) @ p["attn.proj.weight"]
             + p["attn.proj.bias"])
        h2 = port_nn._fused_layernorm(x, p["ln_2.weight"], p["ln_2.bias"],
                                      fmt.eps)
        ff = torch.nn.functional.gelu(h2 @ p["mlp.fc_in.weight"]
                                      + p["mlp.fc_in.bias"],
                                      approximate="tanh")
        x = x + ff @ p["mlp.fc_out.weight"] + p["mlp.fc_out.bias"]
    x = port_nn._layernorm(x, fmt.params["head"]["weight"],
                           fmt.params["head"]["bias"], fmt.eps)
    return x[:, -1] @ emb["word_embeddings.weight"].T.to(fmt.dtype)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_draft_body_padding_writes_only_the_draft_sink_rows(models, kind):
    """The draft model's body (the target's first block over draft pools
    of one layer) run eagerly on a padded step: padding tokens write only
    the draft pools' sink rows, every other draft slot keeps its bytes,
    the target's pools are untouched, and the live slots hold bitwise
    what the target's body writes into its first layer for the same
    packed step; the run counts as a draft launch."""
    _, pm = models
    kw = {"quantize": "int8"} if kind == "int8" else {}
    eng = LLMEngine(pm, device="cpu", speculative={
        "method": "draft-model", "num_tokens": 2, "draft_layers": 1},
        **ENGINE, **kw)
    names = [n for n in ("kc", "vc", "ks", "vs")
             if getattr(eng._draft_pools, n) is not None]
    pools = {("draft", n): getattr(eng._draft_pools, n) for n in names}
    pools.update({("target", n): getattr(eng._pools, n) for n in names})
    rng = np.random.RandomState(6)
    before = {}
    for key, t in pools.items():
        t.copy_(_noise_like(t, rng))
        before[key] = t.clone()
    entries = []
    for rid, p in enumerate(PROMPTS):
        eng._draft_bm.allocate(rid, len(p))
        entries.append((p, 0, eng._draft_bm.block_table(rid)))
    pk = eng._pack_rows(entries, 16)
    launches = dict(eng.stats)
    eng._draft_run(pk)
    assert eng.stats["draft_launches"] == launches["draft_launches"] + 1
    assert eng.stats["launches"] == launches["launches"]
    for n in names:
        assert torch.equal(pools["target", n], before["target", n]), n
    nb, bs = eng.num_blocks, eng.block_size
    live = torch.zeros(nb, bs, dtype=torch.bool)
    for rid, p in enumerate(PROMPTS):
        table = eng._draft_bm.block_table(rid)
        for pos in range(len(p)):
            live[table[pos // bs], pos % bs] = True
    eng._ragged_body(torch.from_numpy(pk["ints"]))
    for n in names:
        got = pools["draft", n]
        assert got.shape[0] == 1, n
        mask = live if n in ("kc", "vc") else \
            live[:, None, :].expand(nb, eng.num_heads, bs)
        assert torch.equal(got[:, ~mask], before["draft", n][:, ~mask]), n
        assert torch.equal(got[0][mask], pools["target", n][0][mask]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fmt_tensor_offset_decode_is_the_int_offset_composition(models,
                                                                 dtype):
    _, pm = models
    fmt = FusedMultiTransformer(pm, max_length=64, dtype=dtype,
                                device="cpu")
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, 128, (3, 7))
    ck, cv = fmt._cache(3)
    fmt._forward_chunk(torch.from_numpy(prompt), ck, cv, 0)
    ref_k, ref_v = ck.clone(), cv.clone()
    for step, offset in enumerate((7, 8, 40)):
        toks = rng.randint(0, 128, 3)
        want = _int_offset_decode(fmt, torch.from_numpy(toks)[:, None],
                                  ref_k, ref_v, offset)
        got = fmt._decode_step(toks, offset)
        assert fmt.decode_steps == step + 1
        assert got.dtype == want.dtype and torch.equal(got, want), offset
        assert torch.equal(ck, ref_k) and torch.equal(cv, ref_v), offset


def test_launches_count_step_calls(models, monkeypatch):
    """The engine counts one launch per step-body run (warmup's dead-row
    runs included) and the FMT one decode step per one-token step; the
    bodies themselves count nothing."""
    _, pm = models
    eng = LLMEngine(pm, device="cpu", **ENGINE)
    runs = {"ragged": 0, "decode": 0}
    body = eng._ragged_body

    def counted(ints):
        runs["ragged"] += 1
        return body(ints)

    monkeypatch.setattr(eng, "_ragged_body", counted)
    eng.warmup()
    assert eng.stats["launches"] == runs["ragged"] == 2
    eng.generate([list(p) for p in PROMPTS], max_new_tokens=5)
    assert eng.stats["launches"] == runs["ragged"] > 2
    body(torch.from_numpy(eng._pack_rows([], 8)["ints"]))
    assert eng.stats["launches"] == runs["ragged"]

    fmt = FusedMultiTransformer(pm, max_length=64, device="cpu")
    decode = fmt._decode_body

    def counted_decode(buf):
        runs["decode"] += 1
        return decode(buf)

    monkeypatch.setattr(fmt, "_decode_body", counted_decode)
    fmt.generate(np.asarray([PROMPTS[1]]), max_new_tokens=6)
    assert fmt.decode_steps == runs["decode"] == 5
    decode(torch.tensor([1, 9]))
    assert fmt.decode_steps == 5
    fmt.generate(np.asarray([[7]]), max_new_tokens=3)   # a one-token prompt
    assert fmt.decode_steps == runs["decode"] == 8


class _FakeGraph:
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_graph_launches_count_per_replay_not_per_capture(monkeypatch):
    """A capture records the wrappers' calls and runs no kernel, so it
    leaves the registry's counts as they were; each replay adds the
    launches its capture recorded, through ``registry.add_counts``.  The
    CUDA graph API is replaced by stand-ins that run the body once at
    capture, as the capture traces it."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(decode_attention_kernel, "launches", 5)

    def body(x):
        decode_attention_kernel.launches += 2    # two wrapper calls
        return (x + 1,)

    graphs = StepGraphs(body, torch.device("cpu"))
    before = registry.counts()
    graphs.capture(4, torch.zeros(3))
    assert registry.counts() == before and graphs.captures == 1
    assert 4 in graphs and 8 not in graphs
    for n in range(1, 4):
        (out,) = graphs.replay(4)
        assert registry.counts() == {**before,
                                     "decode_attention": 5 + 2 * n}
    assert graphs.replays == _FakeGraph.replays == 3
    assert torch.equal(out, torch.ones(3))
    with pytest.raises(KeyError):
        graphs.replay(8)
    registry.add_counts({"decode_attention": -6})
    assert registry.counts() == before


def test_capture_runs_with_the_cyclic_collector_off(monkeypatch):
    """No garbage collection may run inside a capture (a finalizer's CUDA
    calls would invalidate it): the body sees the collector off, and
    capture restores it after, also when the body raises."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = []

    def body(x):
        seen.append(gc.isenabled())
        if x.sum() > 0:
            raise RuntimeError("planted capture failure")
        return (x,)

    graphs = StepGraphs(body, torch.device("cpu"))
    assert gc.isenabled()
    graphs.capture(4, torch.zeros(3))
    with pytest.raises(RuntimeError, match="planted"):
        graphs.capture(8, torch.ones(3))
    assert seen == [False, False] and gc.isenabled()
