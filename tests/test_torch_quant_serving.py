"""The port's int8 serving path against the JAX package's.

- ``quant.py``: ``ServingQuantConfig`` forms and errors; the int8
  primitives bitwise against the JAX ones (an all-zero row included).
- The int8 ragged attention: the cases of the JAX package's
  ``TestRaggedAttentionQuant`` battery (mixed batch, pure decode at
  partial pages, GQA 4, rows aliasing pages, a page-straddling chunk)
  go, on the same genuinely quantized pools, through the Pallas kernel
  in interpret mode, through its XLA fallback and through the port's
  plain version, at atol = rtol = 2e-5; padding must be exact zeros.
- The engine: ``gpt_tiny(num_layers=2)`` in f32 with the JAX model's
  weights carried by name, ``block_size=8``, ``max_batch=4``,
  ``max_model_len=64``, ``token_budget=16`` (the JAX test's engine).
  Leaves, pools and scales equal the JAX engine's (int8 weights and
  scales bitwise); ``generate`` is token-exact against the JAX
  ``LLMEngine(quantize=...)`` for "int8", weight-only and KV-only; the
  memory model equals the JAX one key for key, and the same budget
  admits 2 sequences in f32 and at least 4 in int8.
- ``quality.py``: the report's numbers match the JAX report's at 1e-4
  relative (the perplexity delta at 1e-4 of the perplexity), and an
  engine against itself is perfect.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.inference.llm import quality as jax_quality
from paddle_tpu.inference.llm import quant as jax_quant
from paddle_tpu.inference.llm.paged_attention import (
    paged_ragged_attention_quant_xla,
)
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.ragged_attention_kernel import (
    paged_ragged_attention_quant_pallas,
)
from paddle_tpu_torch.framework import cost
from paddle_tpu_torch.inference.llm import LLMEngine, quality, quant
from paddle_tpu_torch.inference.llm import paged_attention as port
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import ragged_attention_kernel as cuda_kernel
from paddle_tpu_torch.ops.cuda import registry

ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)
MODES = {"int8": "int8",
         "weights_only": {"weights": True, "kv_cache": False},
         "kv_only": {"weights": False, "kv_cache": True}}


def _prompts(n=3, seed=0):
    """``tests/test_quant_serving.py::_prompts``."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (int(rng.randint(3, 12)),))
            .astype(np.int32) for _ in range(n)]


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
    """The JAX test's model (``paddle.seed(0)``, default init) and the
    port's, carrying its weights by name."""
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    pm = gpt_tiny(device="cpu", num_layers=2, seed=1)
    pm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, pm


def _engines(models, quantize, **kw):
    jm, pm = models
    return (JaxEngine(jm, quantize=quantize, **{**ENGINE, **kw}),
            LLMEngine(pm, quantize=quantize, device="cpu",
                      **{**ENGINE, **kw}))


# ------------------------------------------------------------- config --
def test_config_forms():
    cfg = quant.ServingQuantConfig
    assert cfg.resolve(None) is None
    c = cfg.resolve("int8")
    assert c.weights and c.kv_cache and c.bits == 8
    c2 = cfg.resolve({"weights": True, "kv_cache": False})
    assert c2.weights and not c2.kv_cache
    assert cfg.resolve(c) is c

    class QuantConfigLike:
        def factory_for(self, layer):
            return None

    c3 = cfg.resolve(QuantConfigLike())
    assert c3.weights and c3.kv_cache
    assert repr(c2) == repr(jax_quant.ServingQuantConfig.resolve(
        {"weights": True, "kv_cache": False}))


def test_config_errors():
    cfg = quant.ServingQuantConfig
    with pytest.raises(ValueError, match="int8"):
        cfg.resolve("fp4")
    with pytest.raises(ValueError, match="no-op"):
        cfg(weights=False, kv_cache=False)
    with pytest.raises(ValueError, match="bits"):
        cfg(bits=4)
    with pytest.raises(TypeError):
        cfg.resolve(17)


# --------------------------------------------------------- primitives --
@pytest.mark.parametrize("shape,std", [((2, 64, 192), 1.0),
                                       ((3, 96, 40), 0.02)])
def test_quantize_weight_bitwise(shape, std):
    w = (np.random.RandomState(0).randn(*shape) * std).astype(np.float32)
    w[0, :, 3] = 0.0                           # an all-zero column
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(w))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (shape[0], 1, shape[2])
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.all(got_q.numpy()[0, :, 3] == 0)


def test_quantize_kv_rows_bitwise_and_zero_rows():
    v = np.random.RandomState(1).randn(5, 4, 16).astype(np.float32)
    v[2] = 0.0                                 # an all-zero token row
    want_q, want_s = jax_quant.quantize_kv_rows(jnp.asarray(v))
    got_q, got_s = quant.quantize_kv_rows(torch.from_numpy(v))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert tuple(got_s.shape) == (5, 4)
    back = quant.dequantize_kv_rows(got_q, got_s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_quant.dequantize_kv_rows(want_q,
                                                              want_s)))
    assert np.all(got_q.numpy()[2] == 0) and np.all(back.numpy()[2] == 0)


# --------------------------------------------------- int8 attention --
def _qpool(nb, bs, nkv, d, seed):
    """K/V pools quantized per (token, head) row, in the engine's pool
    layout: int8 [NB, bs, Nkv, D] and scales [NB, Nkv, bs]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        f = rng.randn(nb, bs, nkv, d).astype(np.float32)
        q, s = jax_quant.quantize_kv_rows(jnp.asarray(f))
        out += [np.array(q), np.array(s).transpose(0, 2, 1).copy()]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


# (name, NB, BS, NQ, NKV, D, T, pool seed, q seed, block tables or None
#  (drawn from the q stream), row_start, row_qlen, row_pos0)
QCASES = [
    ("mixed_batch", 6, 8, 4, 2, 16, 16, 70, 71,
     [[5, 2, 0], [4, 1, 3], [0, 3, 5], [2, 2, 2]],
     [0, 1, 7, 0], [1, 6, 3, 0], [9, 5, 3, 0]),
    ("decode_partial_pages", 6, 8, 4, 2, 16, 8, 72, 73, None,
     list(range(8)), [0, 1, 1, 1, 1, 1, 1, 1], [0, 12, 23, 4, 0, 7, 15, 8]),
    ("gqa_group_of_four", 6, 8, 8, 2, 16, 8, 74, 75,
     [[1, 4, 2], [3, 0, 5]], [0, 3], [3, 5], [6, 0]),
    ("rows_alias_pages", 6, 8, 4, 2, 16, 8, 76, 77,
     [[3, 1, 0], [3, 1, 5]], [0, 4], [4, 4], [10, 17]),
    ("chunk_page_straddle_and_verify", 6, 8, 4, 2, 16, 16, 78, 79,
     [[3, 1, 4, 0], [2, 5, 0, 1]], [0, 10], [10, 4], [5, 12]),
]


def _qinputs(case):
    (_, nb, bs, nq, nkv, d, t, pseed, qseed, bt, rs, rq, rp) = case
    kq, vq, ks, vs = _qpool(nb, bs, nkv, d, pseed)
    qrng = np.random.RandomState(qseed)
    q = qrng.rand(t, nq, d).astype(np.float32)
    if bt is None:
        bt = qrng.randint(0, nb, size=(t, 3))
    return (q, kq, vq, ks, vs, np.asarray(bt, np.int32),
            np.asarray(rs, np.int32), np.asarray(rq, np.int32),
            np.asarray(rp, np.int32))


@pytest.mark.parametrize("case", QCASES, ids=[c[0] for c in QCASES])
def test_quant_plain_matches_pallas_and_xla(case):
    q, kq, vq, ks, vs, bt, rs, rq, rp = _qinputs(case)
    t_ = torch.from_numpy
    ctx, rows = port.token_descriptors(q.shape[0], t_(rs), t_(rq), t_(rp))
    j = jnp.asarray
    pallas = np.asarray(paged_ragged_attention_quant_pallas(
        j(q), j(kq), j(vq), j(ks), j(vs), j(bt), j(rs), j(rq), j(rp),
        interpret=True))
    xla = np.asarray(paged_ragged_attention_quant_xla(
        j(q), j(kq), j(vq), j(ks), j(vs), j(bt), j(ctx.numpy()),
        j(rows.numpy())))
    got = port.paged_ragged_attention_quant(
        t_(q), t_(kq), t_(vq), t_(ks), t_(vs), t_(bt), ctx, rows, t_(rs),
        t_(rq), t_(rp)).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    dead = ctx.numpy() == 0
    assert np.all(got[dead] == 0.0), "padding tokens not exact zero"
    assert np.all(got[~dead] != 0.0)


def test_quant_registry_plain_is_the_dispatch_plain():
    entry = registry.KERNELS["paged_ragged_attention_quant"]
    q, kq, vq, ks, vs, bt, rs, rq, rp = (torch.from_numpy(a)
                                         for a in _qinputs(QCASES[0]))
    ctx, rows = port.token_descriptors(q.shape[0], rs, rq, rp)
    want = port.paged_ragged_attention_quant_plain(q, kq, vq, ks, vs, bt,
                                                   ctx, rows)
    assert torch.equal(entry.plain(q, kq, vq, ks, vs, bt, rs, rq, rp), want)
    assert entry.kernel is cuda_kernel.paged_ragged_attention_quant_cuda
    assert entry.source == "paddle_tpu_torch/csrc/ragged_attention.cu"
    assert entry.replaces == \
        "paddle_tpu/ops/pallas/ragged_attention_kernel.py:322"
    entry.reset()
    assert registry.counts()["paged_ragged_attention_quant"] == 0


def test_quant_cuda_wrapper_raises_on_cpu_tensors():
    args = [torch.from_numpy(a) for a in _qinputs(QCASES[0])]
    before = (cuda_kernel.launches, cuda_kernel.quant_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernel.paged_ragged_attention_quant_cuda(*args)
    assert (cuda_kernel.launches, cuda_kernel.quant_launches) == before


# ------------------------------------------------------------- engine --
def test_engine_leaves_pools_and_scales_match_jax(models):
    je, pe = _engines(models, "int8")
    jblocks = jax.device_get(je.params)["blocks"]
    assert set(pe.params["blocks"]) == set(jblocks)
    for key in jax_quant.QUANT_BLOCK_LEAVES:
        for k in (key, quant.scale_key(key)):
            got = pe.params["blocks"][k].numpy()
            assert got.dtype == jblocks[k].dtype, k
            np.testing.assert_array_equal(got, jblocks[k])
    for name in ("_kc", "_vc", "_ks", "_vs"):
        got, want = getattr(pe, name), getattr(je, name)
        assert tuple(got.shape) == tuple(want.shape), name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    assert pe._kc.dtype == torch.int8 and pe._ks.dtype == torch.float32


@pytest.mark.parametrize("mode", ["weights_only", "none"])
def test_float_pool_modes_keep_no_scale_pools(models, mode):
    je, pe = _engines(models, MODES.get(mode))
    assert pe._ks is None and pe._vs is None
    assert je._ks is None and je._vs is None
    assert pe._kc.dtype == torch.float32
    want = np.int8 if mode == "weights_only" else np.float32
    assert pe.params["blocks"]["attn.qkv.weight"].numpy().dtype == want


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_token_exact_vs_jax(models, mode):
    je, pe = _engines(models, MODES[mode])
    for seed in (0, 3):
        prompts = _prompts(n=4, seed=seed)
        want = je.generate(prompts, max_new_tokens=8)
        got = pe.generate(prompts, max_new_tokens=8)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    pe.block_manager.check_invariants()
    assert pe.block_manager.num_free_blocks == pe.num_blocks


def test_int8_step_goes_through_the_quant_dispatch(models, monkeypatch):
    """Every layer of every int8-KV step calls the int8 dispatcher and
    never the full-precision one; weight-only steps do the reverse."""
    import paddle_tpu_torch.inference.llm.engine as port_engine

    calls = {"quant": 0, "float": 0}
    real_q = port_engine.paged_ragged_attention_quant
    real_f = port_engine.paged_ragged_attention

    def spy_q(*a):
        calls["quant"] += 1
        return real_q(*a)

    def spy_f(*a):
        calls["float"] += 1
        return real_f(*a)

    monkeypatch.setattr(port_engine, "paged_ragged_attention_quant", spy_q)
    monkeypatch.setattr(port_engine, "paged_ragged_attention", spy_f)
    for mode, key in (("int8", "quant"), ("weights_only", "float")):
        _, pe = _engines(models, MODES[mode])
        pe.warmup()
        pe.generate(_prompts(n=2), max_new_tokens=4)
        assert calls == {"quant": 0, "float": 0, key: 2 * pe.stats[
            "launches"]}, mode
        calls.update(quant=0, float=0)


def test_cow_copies_cover_the_scale_pools(models):
    _, pe = _engines(models, "int8")
    ks = torch.arange(pe._ks.numel(), dtype=torch.float32).view(
        pe._ks.shape)
    pe._ks.copy_(ks)
    pe._vs.copy_(-ks)
    pk = pe._pack_rows([], 8, cows=[(3, 5)])
    pe._ragged_fn(pk)
    assert torch.equal(pe._ks[:, 5], ks[:, 3])
    assert torch.equal(pe._vs[:, 5], -ks[:, 3])
    assert torch.equal(pe._ks[:, 4], ks[:, 4])


# ------------------------------------------------------- memory model --
@pytest.mark.parametrize("mode", ["int8", "weights_only", "kv_only",
                                  "none"])
def test_memory_model_matches_jax(models, mode):
    je, pe = _engines(models, MODES.get(mode))
    want, got = je.memory_model(), pe.memory_model()
    assert set(got) <= set(want)
    assert {k: want[k] for k in got} == got
    assert pe.page_bytes == got["page_bytes"]
    budget = got["weights_bytes"] + 3 * got["seq_bytes"]
    assert pe.memory_model(budget)["derived_max_batch"] == \
        je.memory_model(budget)["derived_max_batch"] == 3


def test_same_budget_admits_at_least_double(models):
    jm, pm = models
    mm32 = LLMEngine(pm, device="cpu", **ENGINE).memory_model()
    budget = mm32["weights_bytes"] + int(2.5 * mm32["seq_bytes"])
    kw = {**ENGINE, "max_batch": 64, "memory_budget": budget}
    base = LLMEngine(pm, device="cpu", **kw)
    q8 = LLMEngine(pm, quantize="int8", device="cpu", **kw)
    assert base.max_batch == 2
    assert q8.max_batch >= 2 * base.max_batch
    assert q8.max_batch == JaxEngine(jm, quantize="int8", **kw).max_batch
    assert q8.num_blocks == q8.max_batch * q8.max_pages


def test_budget_errors():
    assert cost.parse_bytes("16GiB") == 16 * 1024 ** 3
    assert cost.parse_bytes("512MB") == 512 * 1000 ** 2
    assert cost.parse_bytes(None) is None and cost.parse_bytes(7.0) == 7
    with pytest.raises(ValueError, match="parse"):
        cost.parse_bytes("lots")
    with pytest.raises(ValueError, match="cannot hold"):
        cost.derive_max_batch(100, 90, 20)
    assert cost.derive_max_batch("1KB", 100, 300) == 3


def test_engine_budget_too_small_or_pool_too_big_raises(models):
    _, pm = models
    mm = LLMEngine(pm, device="cpu", **ENGINE).memory_model()
    with pytest.raises(ValueError, match="cannot hold"):
        LLMEngine(pm, device="cpu", memory_budget=mm["weights_bytes"],
                  **ENGINE)
    with pytest.raises(ValueError, match="over memory_budget"):
        LLMEngine(pm, device="cpu", num_blocks=64,
                  memory_budget=mm["weights_bytes"] + 2 * mm["seq_bytes"],
                  **ENGINE)


# ------------------------------------------------------------ quality --
def test_quality_report_matches_jax(models):
    jref, pref = _engines(models, None)
    jq, pq = _engines(models, "int8")
    prompts = _prompts(n=2, seed=9)
    want = jax_quality.quality_report(jref, jq, prompts, max_new_tokens=6,
                                      top_k=5)
    got = quality.quality_report(pref, pq, prompts, max_new_tokens=6,
                                 top_k=5)
    assert set(got) == set(want)
    # every number at 1e-4 relative; the perplexity delta, a difference
    # of two perplexities, at 1e-4 of the perplexity it moves
    for k, w in want.items():
        atol = 1e-4 * want["perplexity_ref"] if k == "perplexity_delta" \
            else 0.0
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=atol,
                                   err_msg=k)
    toks = np.asarray(jref.generate(prompts[:1], max_new_tokens=8)[0])
    np.testing.assert_allclose(quality.engine_logits(pq, toks),
                               jax_quality.engine_logits(jq, toks),
                               atol=1e-5, rtol=0)


def test_quality_self_report_is_perfect(models):
    _, pe = _engines(models, None)
    rep = quality.quality_report(pe, pe, [[1, 2, 3], [7, 8, 9, 10]],
                                 max_new_tokens=6)
    assert rep["greedy_agreement"] == 1.0
    assert rep["top1_agreement"] == 1.0
    assert rep["perplexity_delta"] == 0.0


def test_dense_logits_match_int8_engine_argmax(models):
    _, pe = _engines(models, "int8")
    prompt = [1, 2, 3, 4]
    out = pe.generate([prompt], max_new_tokens=6)[0]
    logits = quality.engine_logits(pe, out)
    np.testing.assert_array_equal(
        np.argmax(logits[len(prompt) - 1:-1], -1), out[len(prompt):])
