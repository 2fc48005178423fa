"""Float16 serving (ROADMAP C11): the port's FusedMultiTransformer and
LLMEngine take ``dtype="float16"`` as the JAX ones do, and the ragged
(B1/B5) and dense decode (B6) kernels have a float16 instance.

The f16 models run ``gpt_tiny(num_layers=2)`` on the CPU, where the
kernels' plain versions run, against the JAX package's f16 models on
the same weights.  Greedy tokens must be equal over the steps checked;
the teacher-forced f16 logits are held to JAX's within 2e-2 absolute
(f16 rounds at 2^-11 relative, logits reach |3|, and the two packages
sum in different orders).  The kernel rules are read from the wrappers
and the sources.  A sequence of length 0 is a reference caveat: the
JAX FMT's masked softmax fills with ``jnp.asarray(-1e30, float16)``,
which is -inf, and gives NaN; B6's contract (and its plain version)
gives exact zeros.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.inference.llm import LLMEngine as JaxEngine
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas import decode_attention_kernel as jdk
from paddle_tpu.ops.pallas import ragged_attention_kernel as jrk
from paddle_tpu_torch.framework import kernel_lint as kl
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn.functional import ragged_decode_attention
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import decode_attention_kernel as dk
from paddle_tpu_torch.ops.cuda import ragged_attention_kernel as rk

F16 = torch.float16
CSRC = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch" \
    / "csrc"
LOGITS_ATOL = 2e-2
ENGINE = dict(block_size=8, max_batch=4, max_model_len=64, token_budget=16)

torch.set_num_threads(1)


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
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    params = _randomized(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in jm.functional_decompose()["params"].items()},
        seed=13)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.load_stacked(params)
    return jm, pm


def _prompts(n, length, seed):
    return np.random.RandomState(seed).randint(0, 128, (n, length)) \
        .astype(np.int32)


# ------------------------------------------------------------- routes --
def test_fmt_takes_float16_and_decodes_like_jax(models):
    jm, pm = models
    ids = _prompts(2, 7, seed=1)
    want = JaxFMT(jm, max_length=64, dtype="float16").generate(
        ids, max_new_tokens=6)
    fmt = FusedMultiTransformer(pm, max_length=64, dtype="float16",
                                device="cpu")
    assert fmt.dtype == F16
    got = fmt.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    assert fmt.decode_steps == 5
    assert FusedMultiTransformer(pm, max_length=64, dtype=F16,
                                 device="cpu").dtype == F16


def test_fmt_float16_teacher_forced_logits_match_jax(models):
    """Prefill and one decode step of the f16 FMTs on the same tokens."""
    jm, pm = models
    ids = _prompts(2, 7, seed=2)
    jf = JaxFMT(jm, max_length=64, dtype="float16")
    ck, cv = jf.init_cache(2)
    jl, ck, cv = jf._prefill(jf.params, jnp.asarray(ids), ck, cv, 0)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl2, _, _ = jf._decode(jf.params, jnp.asarray(nxt), ck, cv, 7)
    pf = FusedMultiTransformer(pm, max_length=64, dtype="float16",
                               device="cpu")
    pk, pv = pf.init_cache(2)
    pl = pf._forward_chunk(torch.from_numpy(ids.astype(np.int64)), pk, pv,
                           0)
    pl2 = pf._forward_chunk(torch.from_numpy(nxt.astype(np.int64)), pk, pv,
                            7)
    for got, want in ((pl, jl), (pl2, jl2)):
        assert got.dtype == F16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=LOGITS_ATOL, rtol=0)


def test_engine_takes_float16_and_generates_like_jax(models):
    jm, pm = models
    prompts = [p for p in _prompts(3, 6, seed=3)]
    want = JaxEngine(jm, dtype="float16", **ENGINE).generate(
        prompts, max_new_tokens=5)
    eng = LLMEngine(pm, dtype="float16", device="cpu", **ENGINE)
    assert eng.dtype == F16
    got = eng.generate(prompts, max_new_tokens=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_engine_float16_host_pages_are_numpy_float16(models):
    """The host KV tier ships float16 pages as numpy float16 (bf16 pages
    travel as int16 bit patterns)."""
    _, pm = models
    eng = LLMEngine(pm, dtype=torch.float16, device="cpu", **ENGINE)
    pool = torch.randn(2, 5, 3, dtype=F16)
    pages = eng._gather_pool(pool, [4, 1])
    assert pages.dtype == np.float16
    np.testing.assert_array_equal(pages, pool[:, [4, 1]].numpy())
    back = torch.zeros_like(pool)
    eng._scatter_pool(back, [4, 1], pages)
    assert torch.equal(back[:, [4, 1]], pool[:, [4, 1]])


def test_a_dtype_no_route_takes_still_raises():
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        FusedMultiTransformer(gpt_tiny(device="cpu", num_layers=1),
                              dtype="int8", device="cpu")


def test_llama_decodes_in_float16():
    """The port's Llama takes a float16 model: its decode step runs
    (its caches stay f32, as the JAX Llama's) and follows the f32
    model's logits to f16 rounding."""
    from paddle_tpu_torch.models.llama import llama_tiny

    m32 = llama_tiny(device="cpu", seed=3)
    m16 = llama_tiny(device="cpu", seed=3, dtype=F16)
    ids = torch.from_numpy(_prompts(2, 1, seed=4).astype(np.int64))
    c32, c16 = m32.init_cache(2, 16), m16.init_cache(2, 16)
    for _ in range(3):
        l32, c32 = m32.decode_step(ids, c32)
        l16, c16 = m16.decode_step(ids, c16)
        assert l16.dtype == F16 and torch.isfinite(l16).all()
        np.testing.assert_allclose(l16.float().numpy(), l32.numpy(),
                                   atol=LOGITS_ATOL, rtol=0)
        ids = l32.argmax(-1, keepdim=True).long()


# ------------------------------------------------------- kernel rules --
def test_wrappers_take_float16_with_code_2():
    assert rk._DTYPES[F16] == 2 and dk._DTYPES[F16] == 2
    assert kl._DTYPE_CODE[F16] == 2


@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_supports_is_dtype_blind_as_the_reference(d):
    """Neither JAX ``supports`` reads the dtype, and neither does the
    port's: a shape the kernel takes it takes in every float type."""
    assert dk.supports(192, d, 12, 12) == (d % 8 == 0)
    assert rk.supports(16, d, 12, 4, 64) == (d % 8 == 0)
    assert "dtype" not in jdk.supports.__code__.co_varnames
    assert "dtype" not in jrk.supports.__code__.co_varnames


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _card(*shape, dtype=F16):
    return torch.Tensor._make_subclass(_OnCard, torch.ones(*shape,
                                                           dtype=dtype))


def test_float16_operands_pass_the_wrappers_checks():
    """f16 q over f16 pools (B1), f16 q over int8 pools with f32 scales
    (B5), f16 q over f16 caches (B6): the wrappers' checks take them
    (C11: each raised ValueError for float16)."""
    i32 = torch.int32
    rk._check(_card(8, 4, 16), _card(6, 8, 2, 16), _card(6, 8, 2, 16),
              _card(2, 3, dtype=i32), _card(2, dtype=i32),
              _card(2, dtype=i32), _card(2, dtype=i32))
    rk._check(_card(8, 4, 16), _card(6, 8, 2, 16, dtype=torch.int8),
              _card(6, 8, 2, 16, dtype=torch.int8),
              _card(2, 3, dtype=i32), _card(2, dtype=i32),
              _card(2, dtype=i32), _card(2, dtype=i32),
              scales=(_card(6, 2, 8, dtype=torch.float32),
                      _card(6, 2, 8, dtype=torch.float32)))
    dk._check(_card(2, 4, 16), _card(2, 24, 2, 16), _card(2, 24, 2, 16),
              _card(2, dtype=i32))


def test_float16_instances_in_the_sources_and_the_lint():
    ragged = (CSRC / "ragged_attention.cu").read_text()
    decode = (CSRC / "decode_attention.cu").read_text()
    split = (CSRC / "split_decode.cuh").read_text()
    assert "launch<__half, __half>(" in ragged
    assert "launch<__half, int8_t>(" in ragged
    assert "info<__half, __half>(" in ragged
    assert "info<__half, int8_t>(" in ragged
    assert "launch<__half>(" in decode and "info<__half>(" in decode
    assert "if (dtype == 2)" in ragged and "if (dtype == 2)" in decode
    # f16 loads and stores; accumulators and partials stay f32
    assert "__half22float2" in split and "__float2half" in split
    assert "float* __restrict__ part_acc" in decode
    launches, _ = kl.launch_plan(
        "decode_attention", q=((8, 12, 64), F16),
        k_cache=((8, 192, 12, 64), F16))
    assert launches[0].kernel.startswith("decode_split_kernel<f16")
    launches, _ = kl.launch_plan(
        "paged_ragged_attention", q=((64, 12, 64), F16),
        k_pages=((40, 16, 12, 64), F16), block_tables=((8, 8),
                                                       torch.int32))
    assert launches[0].kernel == "ragged_split_kernel<f16,f16,2>"
    assert launches[1].kernel == "ragged_combine<f16>"
    launches, _ = kl.launch_plan(
        "paged_ragged_attention_quant", q=((64, 12, 64), F16),
        k_pages=((40, 16, 12, 64), torch.int8),
        block_tables=((8, 8), torch.int32))
    assert launches[0].kernel == "ragged_split_kernel<f16,int8,2>"
    # D > 64: the float16 instances ask for one block an SM (no spills)
    assert "__launch_bounds__(kThreads, split_min_blocks<T, KV, DL>())\n" \
        "ragged_split_kernel(" in ragged
    assert "std::is_same<T, __half>::value)\n             ? 1" in ragged
    launches, _ = kl.launch_plan(
        "paged_ragged_attention", q=((64, 8, 128), F16),
        k_pages=((40, 16, 8, 128), F16), block_tables=((8, 8),
                                                       torch.int32))
    assert launches[0].kernel == "ragged_split_kernel<f16,f16,4>"


# ------------------------------------------------- length-0 caveat --
def test_length_zero_caveat_jax_nan_port_zero():
    """Reference caveat: a float16 row with length 0.  The JAX FMT's
    masked composition fills with ``jnp.asarray(-1e30, float16)`` (-inf)
    and its softmax gives NaN; the port's B6 route gives exact zeros
    (the kernel's contract, its plain version here).  At lengths >= 1
    the two agree."""
    rng = np.random.RandomState(5)
    q = rng.randn(2, 1, 4, 16).astype(np.float16)
    kc = rng.randn(2, 12, 4, 16).astype(np.float16)
    vc = rng.randn(2, 12, 4, 16).astype(np.float16)
    lengths = np.array([0, 5], np.int32)

    @jax.jit
    def jax_masked(q, kc, vc, lengths):
        # the attention of paddle_tpu/incubate/nn/__init__.py::_block_chunk
        logits = jnp.einsum("bqnd,bknd->bnqk", q, kc) * (
            1.0 / jnp.sqrt(jnp.asarray(16, q.dtype)))
        mask = (jnp.arange(12)[None, :] < lengths[:, None])[:, None, None]
        logits = jnp.where(mask, logits, jnp.asarray(-1e30, q.dtype))
        att = jax.nn.softmax(logits.astype(jnp.float32),
                             axis=-1).astype(q.dtype)
        return jnp.einsum("bnqk,bknd->bqnd", att, vc)

    want = np.asarray(jax_masked(q, kc, vc, lengths), np.float32)[:, 0]
    got = ragged_decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(lengths))
    assert got.dtype == F16
    assert np.isnan(want[0]).all()                   # JAX: NaN
    assert (got[0] == 0).all()                       # port: zeros
    np.testing.assert_allclose(got[1].float().numpy(), want[1],
                               atol=5e-3, rtol=0)
