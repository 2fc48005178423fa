"""The port's GPT model against the JAX package's.

Weights cross over as numpy arrays: the JAX ``gpt_tiny(num_layers=2)``
is decomposed, its stacked params are loaded into the port with
``load_stacked``, and the port's ``functional_decompose`` must give the
same keys, shapes and values bitwise.  The port's dense ``forward``
must match the JAX forward (eval) to atol 1e-4 in f32 — the two run
the same composition with different matmul summation orders.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models.gpt import gpt_tiny


def _jax_params(model):
    d = model.functional_decompose()
    return {g: {k: np.asarray(v) for k, v in sub.items()}
            for g, sub in d["params"].items()}


def _randomized(params, seed):
    """Seeded weights with non-trivial biases and LayerNorm gains, so
    every parameter is exercised (the default init zeroes biases)."""
    rng = np.random.RandomState(seed)
    out = {}
    for g, sub in params.items():
        out[g] = {}
        for k, v in sub.items():
            noise = rng.randn(*v.shape).astype(np.float32)
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
def carried():
    paddle.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    jm.eval()
    params = _randomized(_jax_params(jm), seed=5)
    jm.load_stacked(params)
    pm = gpt_tiny(device="cpu", num_layers=2, seed=0)
    pm.load_stacked(params)
    return jm, pm, params


def test_decompose_schema_and_values_bitwise(carried):
    jm, pm, params = carried
    got = pm.functional_decompose()
    assert got["num_layers"] == 2
    assert set(got) == {"params", "num_layers"}
    ref = _jax_params(jm)
    for g in ("embed", "blocks", "head"):
        assert set(got["params"][g]) == set(ref[g]), g
        for k, v in ref[g].items():
            mine = got["params"][g][k].numpy()
            assert mine.shape == v.shape and mine.dtype == v.dtype, (g, k)
            np.testing.assert_array_equal(mine, v)
    assert got["params"]["blocks"]["attn.qkv.weight"].shape == (2, 64, 192)


def test_default_init_matches_the_jax_layout():
    """The port's seeded init fills the same schema: Normal(0, 0.02),
    output projections scaled by 1/sqrt(2L), zero biases, unit LN."""
    pm = gpt_tiny(device="cpu", num_layers=2, seed=3)
    p = pm.functional_decompose()["params"]
    paddle.seed(0)
    ref = _jax_params(jax_gpt_tiny(num_layers=2))
    for g in ref:
        for k, v in ref[g].items():
            assert tuple(p[g][k].shape) == v.shape, (g, k)
    b = p["blocks"]
    assert abs(b["attn.qkv.weight"].std().item() - 0.02) < 2e-3
    assert abs(b["attn.proj.weight"].std().item() - 0.01) < 1e-3
    assert torch.count_nonzero(b["mlp.fc_in.bias"]) == 0
    assert torch.equal(p["head"]["weight"], torch.ones(64))
    again = gpt_tiny(device="cpu", num_layers=2, seed=3)
    assert torch.equal(again.functional_decompose()["params"]["embed"][
        "word_embeddings.weight"], p["embed"]["word_embeddings.weight"])


@pytest.mark.parametrize("batch,seq", [(1, 7), (2, 33)])
def test_dense_forward_matches_jax(carried, batch, seq):
    jm, pm, _ = carried
    ids = np.random.RandomState(seq).randint(0, 128, size=(batch, seq))
    want = jm(paddle.to_tensor(ids.astype(np.int32))).numpy()
    got = pm(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == (batch, seq, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_greedy_decode_extends_by_argmax(carried):
    _, pm, _ = carried
    prompt = [3, 14, 15, 92]
    out = pm.greedy_decode(prompt, 5)
    assert out.dtype == np.int64 and list(out[:4]) == prompt
    with torch.no_grad():
        logits = pm(torch.from_numpy(out[None, :-1]))[0]
    np.testing.assert_array_equal(logits[3:].argmax(-1).numpy(), out[4:])
    assert pm.training


def test_jax_state_dict_carries_bitwise_by_name():
    """The JAX model's flat ``state_dict()`` loads into the port by name
    (``set_state_dict``), bitwise, and the port's own state dict has
    exactly the same names."""
    paddle.seed(1)
    jm = jax_gpt_tiny(num_layers=2)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    pm = gpt_tiny(device="cpu", num_layers=2, seed=7)
    pm.set_state_dict(sd)
    got = dict(pm.named_parameters())
    assert set(got) == set(sd)
    assert "gpt.h.1.ln_1.weight" in got
    for name, v in sd.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].detach().numpy(), v)
    with pytest.raises(KeyError, match="missing"):
        pm.set_state_dict({k: v for k, v in sd.items()
                           if k != "gpt.ln_f.bias"})


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt_tiny(num_layers=1)
