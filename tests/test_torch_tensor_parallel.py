"""Tensor and sequence parallelism of the port against the JAX package.

The JAX package runs one controller: its mp layers are dense math with
``mesh_axes`` and GSPMD inserts the collectives, so its numbers are the
dense ones.  The port runs one process a rank (a module-scoped pool of
two gloo ranks, ``torch_dist_pool``, and one of four for dp2 x mp2), and
each rank holds its block.  With the same seeded weights (the JAX
model's state dict, carried through numpy) and inputs:

- each Paddle-API mp layer over two ranks equals the JAX layer, forward
  and gradients (1e-5); ``ParallelCrossEntropy`` equals JAX
  ``F.cross_entropy`` (the logits stay split);
- ``gpt_tiny`` at mp = 2, with and without sequence parallelism, and
  ``llama_tiny`` at mp = 2 with it, take 3 AdamW steps with
  ``ClipGradByGlobalNorm(1.0)`` through ``fleet.init`` →
  ``distributed_model`` → ``distributed_optimizer``: the losses and the
  gathered weights within 1e-5 relative of the JAX ``TrainStep``'s;
  dp2 x mp2 on four ranks against the JAX step on the whole batch.
  AdamW runs with ``epsilon=1e-3`` on both sides: at 1e-8 an element
  whose gradient is rounding noise (the key bias) moves by about lr
  either way, in either package;
- one test a place where a rank could stop equalling the dense model:
  rank r's block of the fused qkv holds its heads' q, k and v (and the
  carried blocks are what TensorParallel sliced); every gradient, the
  replicated ones included, equals the JAX dense gradient, and without
  the sequence-parallel all-reduce they would not; the hybrid clip's
  norm equals JAX's global norm; with dropout 0.1 the replicated
  parameters are bitwise equal across the ranks after a step;
- ``TensorParallel.state_dict()`` saved by the port loads into the JAX
  model bitwise (the JAX layout) and gives its logits; its
  ``set_state_dict`` of that whole state gives each rank its blocks.
"""

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny

import paddle_tpu_torch as P
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
import torch_dist_pool as TP
import torch_hybrid_tasks as H

LR, EPS, STEPS = 1e-3, 1e-3, 3


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def pool4():
    p = TP.RankPool(4)
    yield p
    p.close()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------------------------------ the mp layers --
def _jax_layer(kind, weights):
    J.seed(0)
    if kind.startswith("column"):
        layer = jmp.ColumnParallelLinear(*weights["weight"].shape,
                                         gather_output=kind != "column")
    elif kind.startswith("row"):
        layer = jmp.RowParallelLinear(*weights["weight"].shape)
    else:
        layer = jmp.VocabParallelEmbedding(*weights["weight"].shape)
    layer.set_state_dict({k: J.to_tensor(v) for k, v in weights.items()})
    return layer


@pytest.mark.parametrize("kind", ["column", "column_gather", "row",
                                  "row_parallel", "embedding"])
def test_mp_layer_matches_the_jax_layer(pool, kind):
    if kind == "embedding":
        weights = {"weight": _rand((16, 6), 1)}
        x = np.random.RandomState(2).randint(0, 16, (3, 5))
        dy = _rand((3, 5, 6), 3)
    else:
        din, dout = (6, 8) if kind.startswith("column") else (8, 6)
        weights = {"weight": _rand((din, dout), 1),
                   "bias": _rand((dout,), 4)}
        x = _rand((3, 5, din), 2)
        dy = _rand((3, 5, dout), 3)
    got = pool.run(H.mp_layer_task, kind, weights, x, dy)
    layer = _jax_layer(kind, weights)
    jx = J.to_tensor(x.astype(np.int32) if kind == "embedding" else x,
                     stop_gradient=kind == "embedding")
    out = layer(jx)
    (out * J.to_tensor(dy)).sum().backward()
    for r in got:
        _close(r["out"], out.numpy(), what="out")
        if kind != "embedding":
            _close(r["dx"], jx.grad.numpy(), what="dx")
        for name, p in layer.named_parameters():
            _close(r["d" + name], p.grad.numpy(), what=name)


def test_parallel_cross_entropy_matches_jax_cross_entropy(pool):
    logits = _rand((10, 16), 5, 3.0)
    labels = np.random.RandomState(6).randint(0, 16, 10)
    labels[3] = -100
    got = pool.run(H.parallel_xent_task, logits, labels)
    jx = J.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, J.to_tensor(labels.astype(np.int32)),
                          reduction="none")
    jl.mean().backward()
    for r in got:
        _close(r["loss"].reshape(-1), jl.numpy().reshape(-1), what="loss")
        _close(r["dx"], jx.grad.numpy(), what="dx")


def test_layers_keep_the_jax_mesh_axes_and_equal_dense_at_mp1():
    """At mp = 1 a column/row layer is the dense layer, bitwise."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

    col, row = ColumnParallelLinear(8, 16), RowParallelLinear(16, 8)
    emb = VocabParallelEmbedding(100, 8)
    assert col.weight.mesh_axes == (None, "mp")
    assert col.bias.mesh_axes == ("mp",)
    assert row.weight.mesh_axes == ("mp", None)
    assert row.bias.mesh_axes == (None,)
    assert emb.weight.mesh_axes == ("mp", None)
    dense = nn.Linear(8, 16)
    dense.weight.set_value(col.weight)
    dense.bias.set_value(col.bias)
    x = P.to_tensor(_rand((4, 8), 7))
    assert np.array_equal(col(x).numpy(), dense(x).numpy())


# -------------------------------------------------- the carried weights --
@pytest.fixture(scope="module")
def gpt():
    J.seed(0)
    jm = jax_gpt_tiny(num_layers=2)
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def llama():
    J.seed(0)
    jm = jax_llama_tiny(num_layers=2)
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


def _batch(seed=1, b=4, t=32, vocab=128):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (b, t)), rng.randint(0, vocab, (b, t))


def test_block_of_and_whole_of_carry_the_qkv_heads(gpt):
    """The fused qkv: rank r's block of the fused [h, 3h] qkv is its heads'
    q, k and v columns, and whole_of inverts block_of."""
    _, sd = gpt
    w = sd["gpt.h.0.attn.qkv.weight"]           # [64, 192], 4 heads of 16
    h, tp = 64, 2
    blocks = [mp_layers.block_of(w, (None, "mp"), (h, h, h), r, tp)
              for r in range(tp)]
    for r, blk in enumerate(blocks):
        heads = slice(r * h // tp, (r + 1) * h // tp)
        want = np.concatenate([w[:, heads], w[:, h:][:, heads],
                               w[:, 2 * h:][:, heads]], axis=1)
        assert np.array_equal(blk, want)
    assert np.array_equal(mp_layers.whole_of(blocks, (None, "mp"),
                                             (h, h, h)), w)
    perm = mp_layers.parts_permutation((h, h, h), tp)
    assert np.array_equal(perm, mp_layers.qkv_head_permutation(4, 16, tp))


def test_tensor_parallel_slices_the_carried_blocks(pool, gpt):
    _, sd = gpt
    for r in pool.run(H.rank_block_task, sd):
        assert all(r.values()), [n for n, ok in r.items() if not ok]


def _jax_steps(jm_factory, sd, ids, labels, batches=None):
    """The JAX ``TrainStep``'s losses and weights: ``STEPS`` steps on
    (ids, labels), or one step a batch of ``batches``."""
    jm = jm_factory()
    jm.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    epsilon=EPS, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    step = JTrainStep(jm, lambda lg, lb: jm.loss(lg, lb), jo)
    losses = [float(step(J.to_tensor(x.astype(np.int32)),
                         J.to_tensor(y.astype(np.int32))).numpy())
              for x, y in batches or [(ids, labels)] * STEPS]
    return losses, {k: np.asarray(v) for k, v in step._params.items()}


def _rel_l2(got, want):
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return (num / den) ** 0.5


def _check_steps(results, want_losses, want_w, dp=1):
    losses = np.mean([r["losses"] for r in results], axis=0) if dp > 1 \
        else results[0]["losses"]
    for r in results:
        if dp == 1:
            _close(r["losses"], want_losses, rtol=1e-5, atol=0)
        assert _rel_l2(r["weights"], want_w) <= 1e-5
    _close(losses, want_losses, rtol=1e-5, atol=0)


@pytest.mark.parametrize("sp", [False, True])
def test_gpt_mp2_three_clipped_adamw_steps_match_jax(pool, gpt, sp):
    jm, sd = gpt
    ids, labels = _batch()
    got = pool.run(H.train_task, "gpt", sd, ids, labels, 2, 1, sp)
    want_l, want_w = _jax_steps(lambda: jax_gpt_tiny(num_layers=2), sd,
                                ids, labels)
    _check_steps(got, want_l, want_w)
    if sp:
        # the replicated parameters are the ones marked for the mp
        # all-reduce of their gradients
        repl = sorted(got[0]["replicated"])
        assert got[0]["sp_marked"] == repl and len(repl) == 15


def test_gpt_dp2_mp2_on_four_ranks_matches_jax_on_the_whole_batch(pool4,
                                                                   gpt):
    jm, sd = gpt
    ids, labels = _batch()
    got = pool4.run(H.train_task, "gpt", sd, ids, labels, 2, 2, True)
    want_l, want_w = _jax_steps(lambda: jax_gpt_tiny(num_layers=2), sd,
                                ids, labels)
    _check_steps(got, want_l, want_w, dp=2)


def test_gpt_mp2_sp_gradient_merge_matches_jax(pool, gpt):
    """The hybrid sync and clip act once an update under gradient merge:
    four calls merged two by two (``avg``) at mp = 2 with SP give the
    JAX steps on each pair's batches together, which is what the JAX
    gradient merge computes (``test_meta_optimizers.py::
    test_gradient_merge_avg_matches_big_batch``): each pair's mean loss
    and the weights within 1e-5 relative.  Clipping the running sum on
    every call, or summing an earlier call's SP gradients over mp again,
    would not give them."""
    _, sd = gpt
    batches = [_batch(seed=s) for s in (11, 12, 13, 14)]
    ids = np.stack([b[0] for b in batches])
    labels = np.stack([b[1] for b in batches])
    got = pool.run(H.train_task, "gpt", sd, ids, labels, 2, 1, True, 4,
                   LR, EPS, 1.0, 0.0, False, 2)
    merged = [(np.concatenate(ids[i:i + 2]), np.concatenate(labels[i:i + 2]))
              for i in (0, 2)]
    want_l, want_w = _jax_steps(lambda: jax_gpt_tiny(num_layers=2), sd,
                                None, None, batches=merged)
    for r in got:
        pairs = np.mean(np.reshape(r["losses"], (2, 2)), axis=1)
        _close(pairs, want_l, rtol=1e-5, atol=0)
        assert _rel_l2(r["weights"], want_w) <= 1e-5


def test_llama_mp2_sequence_parallel_matches_jax(pool, llama):
    jm, sd = llama
    ids, labels = _batch(seed=3)
    got = pool.run(H.train_task, "llama", sd, ids, labels, 2, 1, True)
    want_l, want_w = _jax_steps(lambda: jax_llama_tiny(num_layers=2), sd,
                                ids, labels)
    _check_steps(got, want_l, want_w)


@pytest.fixture(scope="module")
def dense_grads(gpt):
    """The JAX model's gradients on ``_batch(seed=5)``."""
    jm, sd = gpt
    ids, labels = _batch(seed=5)
    jm.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    loss = jm.loss(jm(J.to_tensor(ids.astype(np.int32))),
                   J.to_tensor(labels.astype(np.int32)))
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    return grads


@pytest.mark.parametrize("sp", [False, True])
def test_every_gradient_equals_the_dense_one(pool, gpt, dense_grads, sp):
    """The replicated parameters and the clip: the gradients the inner optimizer sees, the
    replicated ones included, equal the JAX dense gradients; the hybrid
    norm equals JAX's global norm (a norm over one rank's blocks, or
    one counting the replicated gradients twice, would not)."""
    jm, sd = gpt
    ids, labels = _batch(seed=5)
    got = pool.run(H.train_task, "gpt", sd, ids, labels, 2, 1, sp, 1,
                   LR, EPS, None, 0.0, True)
    want = dense_grads
    norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in want.values())))
    for r in got:
        for name, g in r["grads"].items():
            _close(g, want[name], rtol=1e-4, atol=1e-6, what=name)
        assert abs(r["norm"] - norm) <= 1e-5 * norm


def test_sequence_parallel_partial_gradients_need_the_all_reduce(
        pool, gpt, dense_grads):
    """The control of the sequence-parallel gradients: with the mp all-reduce of the marked
    gradients switched off, the LayerNorm gradients are each rank's
    partial sums and differ from the dense ones."""
    jm, sd = gpt
    ids, labels = _batch(seed=5)
    got = pool.run(H.partial_grads_task, sd, ids, labels)
    want = dense_grads
    name = "gpt.h.0.ln_1.weight"
    for r in got:
        assert not np.allclose(r[name], want[name], rtol=1e-3, atol=1e-5)
    _close(got[0][name] + got[1][name], want[name], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sp", [False, True])
def test_dropout_keeps_the_replicas_equal(pool, gpt, sp):
    """Dropout across the mp ranks: with dropout 0.1 every replicated parameter is bitwise
    equal across the mp ranks after a step."""
    _, sd = gpt
    ids, labels = _batch(seed=7)
    got = pool.run(H.train_task, "gpt", sd, ids, labels, 2, 1, sp, 1,
                   LR, EPS, 1.0, 0.1)
    a, b = (r["replicated"] for r in got)
    assert a.keys() == b.keys() and len(a) == 15
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    assert np.isfinite(got[0]["losses"]).all()


def test_tensor_parallel_state_dict_loads_in_the_jax_package(pool, gpt,
                                                             tmp_path):
    jm, sd = gpt
    path = str(tmp_path / "tp.pdparams")
    got = pool.run(H.save_tp_task, sd, path)
    assert all(names == sorted(sd) and back for names, back in got)
    loaded = J.load(path)
    assert sorted(loaded) == sorted(sd)
    for k, v in loaded.items():
        assert np.array_equal(v.numpy(), sd[k]), k
    J.seed(1)
    other = jax_gpt_tiny(num_layers=2)
    other.set_state_dict(loaded)
    ids, _ = _batch(seed=8)
    x = J.to_tensor(ids.astype(np.int32))
    jm.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    np.testing.assert_allclose(other(x).numpy(), jm(x).numpy(), rtol=1e-6,
                               atol=1e-6)
