"""Context and sequence parallelism of the port against the JAX package.

JAX runs ``context_parallel_attention`` in ``shard_map`` over a 2-device
mesh of its 8 virtual CPU devices; the port over a pool of two gloo ranks
(``torch_dist_pool``), with the same seeded ``[B, T, N, H]`` inputs:

- ring and Ulysses, causal and not: the output within 1e-5 and the
  gradients of ``sum(sin(out))`` with respect to the global q, k and v
  within 1e-4 on both ranks (the gradient of the replicated
  inputs is the dense one on every rank), through
  ``context_parallel_attention`` and through ``ring_attention`` /
  ``ulysses_attention`` on the rank's chunks;
- ring attention with 3 heads over 2 ranks (no divisibility needed);
  Ulysses raises the JAX ``ValueError`` for it;
- ``gpt_tiny(cp_mode=...)`` under ``use_mesh(build_mesh(sep=2))``: the
  eval logits within 1e-5 of the JAX cp model's, and the eager loss and
  gradients within 1e-5 / 1e-4 of JAX's eager backward;
- ``mark_sequence_sharded`` / ``mark_replicated`` as the split/gather
  pair, with the gradient of the round trip the identity's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as J
from paddle_tpu.distributed.fleet.meta_parallel.sequence_parallel import (
    context_parallel_attention as jax_cp)
from paddle_tpu.distributed.fleet.spmd import use_mesh as jax_use_mesh
from paddle_tpu.distributed.fleet.topology import build_mesh as jax_mesh
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as P
import torch_dist_pool as TP
import torch_hybrid_tasks as H


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_cp(q, k, v, mode, causal):
    """The JAX output and gradients of sum(sin(out)) over a 2-device
    mesh."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))

    def loss(q, k, v):
        out = jax_cp(q, k, v, mesh, mode=mode, is_causal=causal)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_context_parallel_matches_jax(pool, mode, causal, direct):
    q, k, v = (_rand((2, 16, 4, 8), s) for s in (0, 1, 2))
    want, wgrads = _jax_cp(q, k, v, mode, causal)
    for r in pool.run(H.cp_attention_task, q, k, v, mode, causal, 2,
                      direct):
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-5)
        for name, g in zip("qkv", wgrads):
            np.testing.assert_allclose(r["d" + name], g, rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def test_ring_takes_uneven_heads_and_ulysses_refuses_them(pool):
    q, k, v = (_rand((1, 16, 3, 8), s) for s in (6, 7, 8))
    want, _ = _jax_cp(q, k, v, "ring", True)
    for r in pool.run(H.cp_attention_task, q, k, v, "ring", True):
        np.testing.assert_allclose(r["out"], want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        _jax_cp(q, k, v, "ulysses", False)
    for r in pool.run(H.cp_attention_task, q, k, v, "ulysses", False):
        assert "divisible" in r["error"]


@pytest.fixture(scope="module")
def gpt_sd():
    J.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    return {k: v.numpy() for k, v in jm.state_dict().items()}


def _jax_gpt_cp(sd, mode):
    J.seed(0)
    m = jax_gpt_tiny(num_layers=2, cp_mode=mode)
    m.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    return m


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gpt_cp_forward_matches_the_jax_cp_model(pool, gpt_sd, mode):
    ids = np.random.RandomState(0).randint(0, 128, (2, 32))
    jm = _jax_gpt_cp(gpt_sd, mode)
    jm.eval()
    with jax_use_mesh(jax_mesh(sep=2)):
        want = jm(J.to_tensor(ids.astype(np.int32))).numpy()
    for r in pool.run(H.gpt_cp_task, gpt_sd, ids, mode, False):
        np.testing.assert_allclose(r["logits"], want, rtol=1e-5, atol=1e-5)


def test_gpt_cp_eager_backward_matches_jax(pool, gpt_sd):
    ids = np.random.RandomState(2).randint(0, 128, (2, 32))
    jm = _jax_gpt_cp(gpt_sd, "ring")
    with jax_use_mesh(jax_mesh(sep=2)):
        loss = jm.loss(jm(J.to_tensor(ids.astype(np.int32))),
                       J.to_tensor(ids.astype(np.int32)))
        loss.backward()
    grads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    for r in pool.run(H.gpt_cp_task, gpt_sd, ids, "ring", True):
        assert abs(r["loss"] - float(loss.numpy())) <= 1e-5 * float(
            loss.numpy())
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, grads[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_sequence_marks_split_and_gather(pool):
    x = _rand((2, 8, 3), 4)
    got = pool.run(H.seq_marks_task, x)
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["chunk"],
                                      x[:, rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(r["back"], x)
        np.testing.assert_array_equal(r["grad"], np.full_like(x, 2.0))


def test_marks_are_the_identity_without_a_mesh():
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        mark_replicated, mark_sequence_sharded)

    x = torch.from_numpy(_rand((2, 8, 3), 5))
    assert mark_sequence_sharded(x) is x and mark_replicated(x) is x

