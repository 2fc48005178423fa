"""The port's FusedMultiTransformer against the JAX package's.

Both decode ``gpt_tiny(num_layers=2)`` in f32 with the same seeded
weights (carried as numpy arrays) over dense caches.  Greedy
``generate`` must be token-exact against the JAX
``FusedMultiTransformer`` for one prompt and for a batch of three; on
the CPU the port's T = 1 step runs the decode kernel's plain version.
The port's paged engine must be token-exact against the port's FMT, the
oracle ``tests/test_llm_engine.py::_fmt_reference`` holds the JAX
engine to.  Sampling draws from a ``torch.Generator``, which cannot
give ``jax.random``'s bits, so it is checked for determinism and for
staying inside the top-k support.

In bf16 the JAX FMT runs its block through ``framework/ir.py::optimize``,
whose ``fuse_layernorm`` pass computes both block LayerNorms in f32 and
casts back; the port's ``_fused_layernorm`` does the same.  One bf16
block and the teacher-forced bf16 logits are held to the JAX package by
mean |error|, each beside a control that runs the block LayerNorms in
the activation dtype (the shared ``_layernorm``) and must exceed the
bound.  Greedy bf16 tokens cannot gate this: the reference's top-2
margins reach 0 at bf16 resolution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.incubate.nn as port_nn
from paddle_tpu.framework import ir as jax_ir
from paddle_tpu.incubate.nn import _block_chunk as jax_block_chunk
from paddle_tpu.incubate.nn import FusedMultiTransformer as JaxFMT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference.llm import LLMEngine
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.ops.cuda import decode_attention_kernel


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
        seed=13)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.load_stacked(params)
    return jm, pm


def _prompts(n, length, seed):
    return np.random.RandomState(seed).randint(0, 128, (n, length)) \
        .astype(np.int32)


@pytest.mark.parametrize("batch,length", [(1, 9), (3, 5)])
def test_greedy_generate_token_exact_vs_jax(models, batch, length):
    jm, pm = models
    ids = _prompts(batch, length, seed=batch)
    want = JaxFMT(jm, max_length=64).generate(ids, max_new_tokens=12)
    fmt = FusedMultiTransformer(pm, max_length=64, device="cpu")
    got = fmt.generate(ids, max_new_tokens=12)
    assert got.dtype == want.dtype and got.shape == (batch, length + 12)
    np.testing.assert_array_equal(got, want)
    assert fmt.decode_steps == 11
    assert len({tuple(r[length:]) for r in got}) == batch


def test_engine_token_exact_vs_port_fmt(models):
    """The port's paged engine against the port's dense-cache decoder,
    one request at a time, as the JAX engine is held to the JAX FMT."""
    _, pm = models
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (5, 11, 3)]
    fmt = FusedMultiTransformer(pm, max_length=64, device="cpu")
    refs = [fmt.generate(p[None], max_new_tokens=8)[0] for p in prompts]
    eng = LLMEngine(pm, block_size=8, max_batch=4, max_model_len=64,
                    device="cpu")
    outs = eng.generate(prompts, max_new_tokens=8)
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    assert eng.block_manager.num_free_blocks == eng.num_blocks


def test_seeded_top_k_sampling_deterministic(models):
    _, pm = models
    ids = _prompts(2, 6, seed=7)
    fmt = FusedMultiTransformer(pm, max_length=64, device="cpu")
    a = fmt.generate(ids, max_new_tokens=10, temperature=1.0, top_k=3,
                     seed=11)
    b = fmt.generate(ids, max_new_tokens=10, temperature=1.0, top_k=3,
                     seed=11)
    np.testing.assert_array_equal(a, b)
    greedy = fmt.generate(ids, max_new_tokens=10)
    assert not np.array_equal(a, greedy)
    # every sampled token lies in the top 3 of the logits it came from
    ck, cv = fmt.init_cache(2)
    logits = fmt._forward_chunk(torch.from_numpy(ids.astype(np.int64)), ck,
                                cv, 0)
    for step in range(10):
        top = logits.topk(3, dim=-1).indices.numpy()
        tok = a[:, 6 + step]
        assert all(t in row for t, row in zip(tok, top))
        logits = fmt._forward_chunk(
            torch.from_numpy(tok[:, None].astype(np.int64)), ck, cv,
            6 + step)


def test_eos_stops_every_row(models):
    jm, pm = models
    ids = _prompts(3, 5, seed=3)
    greedy = FusedMultiTransformer(pm, max_length=64,
                                   device="cpu").generate(
        ids, max_new_tokens=12)
    eos = int(greedy[0, 7])
    want = JaxFMT(jm, max_length=64).generate(ids, max_new_tokens=12,
                                              eos_token_id=eos)
    got = FusedMultiTransformer(pm, max_length=64, device="cpu").generate(
        ids, max_new_tokens=12, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)


def test_decode_goes_through_the_decode_attention_dispatcher(models,
                                                            monkeypatch):
    """Every layer of every T = 1 step calls ``ragged_decode_attention``
    with ``lengths = offset + 1``; the prefill chunk never does."""
    import paddle_tpu_torch.incubate.nn as port_nn

    _, pm = models
    seen = []
    real = port_nn.ragged_decode_attention

    def spy(q, k_cache, v_cache, lengths, use_pallas=None):
        seen.append(lengths.tolist())
        return real(q, k_cache, v_cache, lengths, use_pallas)

    monkeypatch.setattr(port_nn, "ragged_decode_attention", spy)
    fmt = FusedMultiTransformer(pm, max_length=64, device="cpu")
    fmt.generate(_prompts(2, 4, seed=5), max_new_tokens=4)
    assert seen == [[4 + s + 1] * 2 for s in range(3) for _ in range(2)]
    assert decode_attention_kernel.launches == 0


def test_prompt_past_max_length_raises(models):
    _, pm = models
    fmt = FusedMultiTransformer(pm, max_length=16, device="cpu")
    with pytest.raises(ValueError, match="max_length"):
        fmt.generate(_prompts(1, 10, seed=0), max_new_tokens=7)


# bf16 block output and logits: mean |port - JAX| over every element.
# bf16 rounds at 2^-9 relative, so the two frameworks' different fusion
# and summation orders leave ~1e-3 on values of order 1 (block 0.0013,
# logits 0.0051 over |logit| up to 3.4, measured on the CPU); the
# activation-dtype LayerNorm the JAX pass replaces leaves 0.0040-0.0062
# on the block and 0.0069 on the logits.
BLOCK_MEAN_ABS = 3e-3
LOGITS_MEAN_ABS = 6e-3


def _bf16_block_params(h, seed):
    rng = np.random.RandomState(seed)
    shapes = {"ln_1.weight": (h,), "ln_1.bias": (h,),
              "attn.qkv.weight": (h, 3 * h), "attn.qkv.bias": (3 * h,),
              "attn.proj.weight": (h, h), "attn.proj.bias": (h,),
              "ln_2.weight": (h,), "ln_2.bias": (h,),
              "mlp.fc_in.weight": (h, 4 * h), "mlp.fc_in.bias": (4 * h,),
              "mlp.fc_out.weight": (4 * h, h), "mlp.fc_out.bias": (h,)}
    params = {}
    for k, shape in shapes.items():
        noise = rng.randn(*shape).astype(np.float32)
        if k.startswith("ln_"):
            params[k] = (1.0 if k.endswith("weight") else 0.0) + 0.1 * noise
        elif k.endswith("bias"):
            params[k] = 0.1 * noise
        else:
            params[k] = noise / np.sqrt(shape[0])
    return params


@pytest.fixture
def activation_dtype_layernorm(request, monkeypatch):
    """The control: the block LayerNorms in the activation dtype."""
    if request.param:
        monkeypatch.setattr(port_nn, "_fused_layernorm", port_nn._layernorm)
    return request.param


@pytest.mark.parametrize("activation_dtype_layernorm", [False, True],
                         indirect=True, ids=["fused", "control"])
@pytest.mark.parametrize("t,offset,rewrites", [(9, 0, 2), (1, 9, 3)],
                         ids=["prefill", "decode"])
def test_bf16_block_matches_jax_ir_optimized_block(
        activation_dtype_layernorm, t, offset, rewrites):
    """One bf16 block (hidden 64, 4 heads) of the port against the JAX
    ``_ir.optimize(_block_chunk)``: at prefill (T=9) ``fuse_layernorm``
    fires twice, at T=1 after 9 cached tokens ``decode_attention`` too."""
    h, nh, s_max = 64, 4, 16
    params = _bf16_block_params(h, seed=31)
    rng = np.random.RandomState(32 + t)
    x = rng.randn(2, t, h).astype(np.float32)
    ck = np.zeros((2, s_max, nh, h // nh), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :offset] = rng.randn(2, offset, nh, h // nh)
    cv[:, :offset] = rng.randn(2, offset, nh, h // nh)

    block = jax_ir.optimize(lambda p, xx, k, v, off: jax_block_chunk(
        p, xx, k, v, off, nh, 1e-5))
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want, _, _ = block({k: jbf(v) for k, v in params.items()}, jbf(x),
                       jbf(ck), jbf(cv), jnp.asarray(offset, jnp.int32))
    assert block.last_rewrite_count == rewrites
    tbf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = port_nn._block_chunk({k: tbf(v) for k, v in params.items()},
                               tbf(x), tbf(ck), tbf(cv), offset, nh, 1e-5)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).mean()
    if activation_dtype_layernorm:
        assert err > BLOCK_MEAN_ABS
    else:
        assert err <= BLOCK_MEAN_ABS


@pytest.mark.parametrize("activation_dtype_layernorm", [False, True],
                         indirect=True, ids=["fused", "control"])
def test_bf16_teacher_forced_logits_match_jax(models,
                                              activation_dtype_layernorm):
    """bf16 FMT logits over the JAX FMT's greedy tokens (prefill plus 20
    decode steps, 4 prompts of 17), port against JAX."""
    jm, pm = models
    ids = _prompts(4, 17, seed=4)
    b, t = ids.shape
    new = 20
    jfmt = JaxFMT(jm, max_length=64, dtype="bfloat16")
    toks = jfmt.generate(ids, max_new_tokens=new + 1)
    fmt = FusedMultiTransformer(pm, max_length=64, dtype="bfloat16",
                                device="cpu")
    jck, jcv = jfmt.init_cache(b)
    ck, cv = fmt.init_cache(b)
    errs = []
    for step in range(new + 1):
        chunk = ids if step == 0 else toks[:, t + step - 1:t + step]
        offset = 0 if step == 0 else t + step - 1
        fn = jfmt._prefill if step == 0 else jfmt._decode
        want, jck, jcv = fn(jfmt.params, jnp.asarray(chunk), jck, jcv,
                            offset)
        got = fmt._forward_chunk(torch.from_numpy(chunk.astype(np.int64)),
                                 ck, cv, offset)
        errs.append(np.abs(got.float().numpy()
                           - np.asarray(want.astype(jnp.float32))))
    err = float(np.mean(errs))
    if activation_dtype_layernorm:
        assert err > LOGITS_MEAN_ABS
    else:
        assert err <= LOGITS_MEAN_ABS
