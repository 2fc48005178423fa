"""The port's Llama model against the JAX package's.

Both models are ``llama_tiny(num_layers=2)`` (hidden 64, 4 query heads
on 2 kv heads, so GQA groups of 2) in f32 with the same seeded weights,
carried from the JAX model's flat state dict by name (bitwise).  The
dense forward must match the JAX forward to atol 1e-4 (the same
composition, other matmul summation orders); ``decode_step`` logits
must match the JAX ``decode_step`` with the Pallas decode kernel in
interpret mode at each of 6 positions to 1e-4; and the port's decode
must agree with its own dense forward at the JAX test's rtol 2e-3 /
atol 2e-4.  On the CPU the port's decode attention is the kernel's
plain version.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models.llama import llama_tiny
from paddle_tpu_torch.models.llama import LlamaRMSNorm as RMSNorm
from paddle_tpu_torch.nn import functional as F


def _randomized(model, seed):
    """Seeded weights with non-trivial norm gains, as numpy by name."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        noise = rng.randn(*v.shape).astype(np.float32)
        if "norm" in k:
            out[k] = (1.0 + 0.1 * noise).astype(np.float32)
        else:
            out[k] = (0.1 * noise).astype(np.float32)
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
def carried():
    paddle.seed(0)
    jm = jax_llama_tiny(num_layers=2)
    jm.eval()
    sd = _randomized(jm, seed=4)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    pm = llama_tiny(device="cpu", num_layers=2, seed=0)
    pm.set_state_dict(sd)
    return jm, pm, sd


def _ids(b, t, seed):
    return np.random.RandomState(seed).randint(0, 128, (b, t))


def test_state_dict_carries_bitwise_by_name(carried):
    jm, pm, sd = carried
    got = dict(pm.named_parameters())
    assert set(got) == set(sd)
    assert "llama.layers.1.self_attn.qkv.weight" in got
    for name, v in jm.state_dict().items():
        np.testing.assert_array_equal(got[name].detach().numpy(),
                                      np.asarray(v.numpy()))
        assert got[name].dtype == torch.float32
    with pytest.raises(KeyError, match="missing"):
        pm.set_state_dict({k: v for k, v in sd.items()
                           if k != "lm_head.weight"})


def test_gqa_heads_and_shapes(carried):
    _, pm, _ = carried
    attn = pm.llama.layers[0].self_attn
    assert attn.num_heads == 4 and attn.num_kv_heads == 2
    assert tuple(attn.qkv.weight.shape) == (64, 128)
    assert tuple(pm.llama.layers[0].mlp.gate_up.weight.shape) == (64, 512)
    assert attn.qkv.bias is None


@pytest.mark.parametrize("batch,seq", [(1, 7), (2, 16)])
def test_dense_forward_matches_jax(carried, batch, seq):
    jm, pm, _ = carried
    ids = _ids(batch, seq, seed=seq)
    want = jm(paddle.to_tensor(ids.astype(np.int32))).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    assert got.shape == (batch, seq, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_decode_step_matches_jax_interpret(carried):
    """Six decode steps over ragged lengths: the port (plain decode
    attention) against the JAX ``decode_step`` running the Pallas decode
    kernel in interpret mode, logits at every position."""
    jm, pm, _ = carried
    ids = _ids(2, 6, seed=3)
    jcache = jm.init_cache(2, 16)
    pcache = pm.init_cache(2, 16)
    for t in range(6):
        want, jcache = jm.decode_step(
            paddle.to_tensor(ids[:, t:t + 1].astype(np.int32)), jcache,
            interpret=True)
        got, pcache = pm.decode_step(torch.from_numpy(ids[:, t:t + 1]),
                                     pcache)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(pcache["lengths"].numpy(), [6, 6])
    np.testing.assert_allclose(pcache["k"][1].numpy(),
                               np.asarray(jcache["k"][1]), atol=1e-5)


def test_decode_matches_own_dense_forward(carried):
    _, pm, _ = carried
    ids = _ids(2, 6, seed=5)
    with torch.no_grad():
        dense = pm(torch.from_numpy(ids)).numpy()
    cache = pm.init_cache(2, 16)
    for t in range(6):
        step, cache = pm.decode_step(torch.from_numpy(ids[:, t:t + 1]),
                                     cache)
        np.testing.assert_allclose(step.numpy(), dense[:, t], rtol=2e-3,
                                   atol=2e-4)


def test_decode_past_cache_raises(carried):
    _, pm, _ = carried
    cache = pm.init_cache(1, 2)
    tok = torch.tensor([[1]])
    for _ in range(2):
        _, cache = pm.decode_step(tok, cache)
    with pytest.raises(ValueError, match="exceeds cache"):
        pm.decode_step(tok, cache)


def test_rms_norm_matches_jax():
    from paddle_tpu.nn import functional as jax_F

    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = jax_F.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                          epsilon=1e-6).numpy()
    got = F.rms_norm(torch.from_numpy(x), torch.from_numpy(w), epsilon=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    layer = RMSNorm(64, epsilon=1e-6)
    assert torch.equal(layer.weight, torch.ones(64))
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               F.rms_norm(torch.from_numpy(x)).numpy())


def test_trainable_loss_and_no_decompose(carried):
    """The loss trains, and ``functional_decompose`` (ported with ROADMAP
    A23b-6b) gives the JAX schema: the same params (bitwise), specs and
    num_layers, and its four functions chained equal the JAX chain and
    the port's own forward and loss."""
    jm, pm, _ = carried
    ids = torch.from_numpy(_ids(2, 8, seed=9))
    loss = pm.loss(pm(ids), ids)
    loss.backward()
    assert torch.isfinite(loss) and pm.lm_head.weight.grad is not None
    pm.zero_grad()
    got, want = pm.functional_decompose(), jm.functional_decompose()
    assert got["num_layers"] == want["num_layers"] == 2
    assert got["specs"] == want["specs"]
    for group in ("embed", "blocks", "head"):
        assert got["params"][group].keys() == want["params"][group].keys()
        for k, v in got["params"][group].items():
            assert np.array_equal(v.numpy(),
                                  np.asarray(want["params"][group][k])), k

    def chain(d, ids, layer):
        embed_fn, block_fn, head_fn, loss_fn = d["fns"]
        p = d["params"]
        h = embed_fn(p["embed"], ids)
        for i in range(d["num_layers"]):
            h = block_fn({k: v[i] for k, v in p["blocks"].items()},
                         layer(h))
        logits = head_fn(p["head"], layer(h), p["embed"])
        return logits, loss_fn(logits, ids)

    logits, closs = chain(got, ids, lambda h: h)
    jids = paddle.to_tensor(ids.numpy().astype(np.int32))
    jlogits, jloss = chain(want, jids._data,
                           lambda h: getattr(h, "_data", h))
    jlogits = getattr(jlogits, "_data", jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(closs), float(np.asarray(jloss)),
                               rtol=1e-5)
    assert torch.equal(logits, pm(ids).detach())
    assert torch.equal(closs, pm.loss(pm(ids), ids).detach())


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_tiny(num_layers=1)
