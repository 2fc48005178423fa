"""The port's ``parallel/`` (pipeline and SpmdTrainStep) against the JAX
package's.

The JAX package runs one controller over eight virtual CPU devices:
``spmd_pipeline`` is a ``shard_map`` over 'pp' and ``SpmdTrainStep`` one
program over the whole mesh.  The port runs one process a rank (one
module-scoped pool of eight gloo ranks, ``torch_dist_pool``; the rank
tasks in ``torch_parallel_tasks``).  With the JAX ``gpt_tiny``'s
weights carried through numpy and seeded numpy inputs:

- ``functional_decompose()``'s ``fns`` equal the JAX ``fns`` (1e-5);
- ``spmd_pipeline`` at pp = 2 and pp = 2 × v = 2 (four pipelines side
  by side over dp = 4) equals the JAX ``spmd_pipeline``: the output and,
  for sum(out²), each stage's rows of the stacked gradients (1e-5);
- ``SpmdTrainStep`` at dp2 × pp2 × mp2 takes 3 AdamW steps with
  ``ClipGradByGlobalNorm(1.0)``: the losses and every gathered weight
  within 1e-5 relative of the JAX ``SpmdTrainStep``'s; so do ZeRO-1
  over a sharding axis (the moments of this rank's block only),
  ``zero_stage=0`` (whole moments), ZeRO folded into dp, the
  interleaved schedule with remat and sequence parallelism, and a
  dynamic loss scaler; a scale that overflows is found on every rank
  and the step skipped everywhere; the tied embedding stays equal on
  every stage;
- the tiny Llama at dp2 × pp2 × mp2 with ZeRO over dp takes 4 steps
  within 1e-5 of the JAX ``SpmdTrainStep`` in losses, weights and
  moments.

AdamW runs with ``epsilon=1e-3`` on both sides (``test_torch_tensor_
parallel.py`` says why).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as J
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.topology import build_mesh as jax_mesh
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.parallel import SpmdTrainStep as JaxSpmdTrainStep
from paddle_tpu.parallel import spmd_pipeline as jax_spmd_pipeline

import paddle_tpu_torch as P
import torch_dist_pool as TP
import torch_parallel_tasks as T

LR, EPS, STEPS, LAYERS = 1e-3, 1e-3, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool8():
    p = TP.RankPool(8, timeout=120)
    yield p
    p.close()


def _sd(num_layers, seed=0):
    J.seed(seed)
    jm = jax_gpt_tiny(num_layers=num_layers)
    return {k: v.numpy() for k, v in jm.state_dict().items()}


def _jax_model(sd, num_layers):
    J.seed(0)
    jm = jax_gpt_tiny(num_layers=num_layers)
    jm.set_state_dict({k: J.to_tensor(v) for k, v in sd.items()})
    return jm


def _batch(seed=1, b=8, t=16, vocab=128):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, t)).astype(np.int32),
            rng.randint(0, vocab, (b, t)).astype(np.int32))


def _rel_l2(got, want):
    num = den = 0.0
    for g in want:
        for k, w in want[g].items():
            w = np.asarray(w, np.float64)
            num += float(np.sum((got[g][k] - w) ** 2))
            den += float(np.sum(w ** 2))
    return (num / den) ** 0.5


def _leaf_rel(got, want):
    worst = 0.0
    for g in want:
        for k, w in want[g].items():
            w = np.asarray(w, np.float64)
            den = max(np.linalg.norm(w), 1e-12)
            worst = max(worst, np.linalg.norm(got[g][k] - w) / den)
    return worst


# ------------------------------------------------- the decomposition --
def test_decompose_fns_match_the_jax_fns():
    """embed_fn, block_fn over the layers, head_fn and loss_fn of the
    port on the carried weights equal the JAX ``fns`` (eval)."""
    import torch
    from paddle_tpu_torch.models.gpt import gpt_tiny

    sd = _sd(2)
    jm = _jax_model(sd, 2)
    jm.eval()
    pm = gpt_tiny(device="cpu", num_layers=2)
    pm.set_state_dict(sd)
    pm.eval()
    ids, labels = _batch(b=2)
    jd, pd = jm.functional_decompose(), pm.functional_decompose()
    assert set(pd) == {"params", "specs", "fns", "num_layers"}
    assert pd["specs"]["blocks"]["attn.qkv.weight"] == ("pp", None, "mp")
    assert pd["specs"]["embed"] == jd["specs"]["embed"]
    assert {k: tuple(v) for k, v in pd["specs"]["blocks"].items()} == \
        {k: tuple(v) for k, v in jd["specs"]["blocks"].items()}
    je, jb, jh, jl = jd["fns"]
    te, tb, th, tl = pd["fns"]
    jp, tp = jd["params"], pd["params"]
    h_j = je(jp["embed"], jnp.asarray(ids))
    h_t = te(tp["embed"], torch.from_numpy(ids).long())
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5,
                               atol=1e-6)
    for i in range(2):
        h_j = jb({k: v[i] for k, v in jp["blocks"].items()}, h_j)
        h_t = tb({k: v[i] for k, v in tp["blocks"].items()}, h_t)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                               rtol=1e-5, atol=1e-5)
    lg_j = jh(jp["head"], h_j, jp["embed"])
    lg_t = th(tp["head"], h_t, tp["embed"])
    np.testing.assert_allclose(lg_t.detach().numpy(), np.asarray(lg_j),
                               rtol=1e-5, atol=1e-5)
    loss_t = float(tl(lg_t, torch.from_numpy(labels).long()))
    loss_j = float(jl(lg_j, jnp.asarray(labels)))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    # block_fn runs the template in the model's mode and restores its own
    pm.gpt.h[0].train()
    tb({k: v[0] for k, v in tp["blocks"].items()}, h_t)
    assert pm.gpt.h[0].training


# ------------------------------------------------------ the pipeline --
@pytest.mark.parametrize("v,layers", [(1, 4), (2, 8)])
def test_spmd_pipeline_matches_jax(pool8, v, layers):
    """pp = 2 (four pipelines over dp = 4), m = 4: forward and the
    gradients of each stage's layers against the JAX pipeline."""
    sd = _sd(layers, seed=v)
    x = np.random.RandomState(0).randn(8, 16, 64).astype(np.float32)
    got = pool8.run(T.pipeline_task, sd, layers, x, dict(dp=4, pp=2), 4, v)
    jm = _jax_model(sd, layers)
    jm.eval()
    d = jm.functional_decompose()
    block_fn, blocks = d["fns"][1], d["params"]["blocks"]
    mesh = jax_mesh(dp=4, pp=2, sharding=1, mp=1)

    def loss(b, xx):
        out = jax_spmd_pipeline(block_fn, b, xx, mesh=mesh,
                                n_microbatches=4, virtual_pp=v)
        return jnp.sum(out * out), out

    with mesh:
        (_, out), (gb, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(blocks, jnp.asarray(x))
    from paddle_tpu.parallel.pipeline import interleave_permutation

    order = np.arange(layers) if v == 1 else \
        interleave_permutation(layers, 2, v)
    for r in got:
        np.testing.assert_allclose(r["out"], np.asarray(out), rtol=1e-5,
                                   atol=1e-5)
        mine = order[r["stage"] * layers // 2:(r["stage"] + 1) * layers // 2]
        for k, g in gb.items():
            g = np.asarray(g)
            np.testing.assert_allclose(r["grads"][k][mine], g[mine],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            rest = np.setdiff1d(np.arange(layers), mine)
            assert not np.any(r["grads"][k][rest])
        if r["stage"] == 0:
            np.testing.assert_allclose(r["dx"], np.asarray(gx), rtol=1e-5,
                                       atol=1e-5)


# -------------------------------------------------------- the trainer --
@pytest.fixture(scope="module")
def jax_steps():
    """The JAX SpmdTrainStep at dp2 x pp2 x mp2: losses and canonical
    params after 3 steps."""
    sd = _sd(LAYERS, seed=5)
    ids, labels = _batch()
    jm = _jax_model(sd, LAYERS)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    epsilon=EPS, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    tr = JaxSpmdTrainStep(jm, jo, jax_mesh(dp=2, pp=2, sharding=1, mp=2),
                          n_microbatches=2)
    losses = [float(tr.step(J.to_tensor(ids), J.to_tensor(labels)).numpy())
              for _ in range(STEPS)]
    st = tr.state_dict()
    params = {g: {k: np.asarray(v) for k, v in sub.items()}
              for g, sub in st["params"].items()}
    m1 = {g: {k: np.asarray(s["moment1"]) for k, s in sub.items()}
          for g, sub in st["opt_state"].items()}
    return sd, ids, labels, losses, params, m1


def _check(r, want_l, want_p, want_m1=None):
    np.testing.assert_allclose(r["losses"], want_l, rtol=1e-5, atol=0)
    assert _rel_l2(r["params"], want_p) <= 1e-5
    assert _leaf_rel(r["params"], want_p) <= 1e-5
    if want_m1 is not None:
        assert _rel_l2(r["moment1"], want_m1) <= 1e-5


def test_dp2_pp2_mp2_three_clipped_adamw_steps_match_jax(pool8, jax_steps):
    sd, ids, labels, want_l, want_p, want_m1 = jax_steps
    got = pool8.run(T.trainer_task, sd, LAYERS, ids, labels,
                    dict(dp=2, pp=2, mp=2), dict(n_microbatches=2))
    for r in got:
        _check(r, want_l, want_p, want_m1)
    # the tied embedding (and the rest of what pp replicates) is the same
    # on both stages: ranks 2i and 2i + 2 differ only in the stage
    for a, b in ((0, 2), (1, 3), (4, 6), (5, 7)):
        for k in got[a]["embed"]:
            assert np.array_equal(got[a]["embed"][k], got[b]["embed"][k])
    # sync_to_model wrote the trained head into the model
    np.testing.assert_allclose(got[0]["model_ln_f"],
                               want_p["head"]["weight"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mesh_kw,kw,m1_local", [
    (dict(dp=2, pp=1, sharding=2, mp=2), {}, (4, 32, 96)),
    (dict(dp=2, pp=1, sharding=2, mp=2), dict(zero_stage=0), (4, 64, 96)),
    (dict(dp=4, mp=2), dict(zero_axis="dp"), (4, 16, 96)),
])
def test_zero_one_places_the_state_and_trains_as_jax(pool8, jax_steps,
                                                     mesh_kw, kw, m1_local):
    """ZeRO-1 over the sharding axis keeps the moments of this rank's
    block (dim 1 of the qkv, the first its spec leaves unsharded), over
    dp when asked, whole at zero_stage=0; the steps are the JAX ones."""
    sd, ids, labels, want_l, want_p, want_m1 = jax_steps
    got = pool8.run(T.trainer_task, sd, LAYERS, ids, labels, mesh_kw, kw)
    for r in got:
        assert r["qkv_local"] == (4, 64, 96)
        assert r["m1_local"] == m1_local
        _check(r, want_l, want_p, want_m1)


def test_interleaved_remat_sequence_parallel_match_jax(pool8, jax_steps):
    sd, ids, labels, want_l, want_p, _ = jax_steps
    got = pool8.run(T.trainer_task, sd, LAYERS, ids, labels,
                    dict(dp=2, pp=2, mp=2),
                    dict(n_microbatches=2, virtual_pp=2, remat=True,
                         sequence_parallel=True))
    for r in got:
        _check(r, want_l, want_p)


def test_scaler_steps_and_skips_everywhere(pool8, jax_steps):
    """A dynamic scaler at 2**10 gives the unscaled steps; a scale that
    overflows the loss is found on every rank and every rank skips the
    step, the weights unchanged and the scale halved."""
    sd, ids, labels, want_l, want_p, _ = jax_steps
    got = pool8.run(T.trainer_task, sd, LAYERS, ids, labels,
                    dict(dp=2, pp=2, mp=2), dict(n_microbatches=2), STEPS,
                    dict(init_loss_scaling=2.0 ** 10))
    for r in got:
        _check(r, want_l, want_p)
        assert r["found_inf"] is False and r["scale"] == 2.0 ** 10
    got = pool8.run(T.trainer_task, sd, LAYERS, ids, labels,
                    dict(dp=2, pp=2, mp=2), dict(n_microbatches=2), 1,
                    dict(init_loss_scaling=3e38))
    sd0 = _jax_model(sd, LAYERS).functional_decompose()["params"]
    for r in got:
        assert r["found_inf"] is True
        assert r["scale"] == float(np.float32(3e38) * np.float32(0.5))
        assert _rel_l2(r["params"], {g: {k: np.asarray(v) for k, v in
                                         sub.items()}
                                     for g, sub in sd0.items()}) == 0.0


def test_llama_dp2_pp2_mp2_trains_with_zero_over_dp(pool8):
    """The JAX zoo body's contract on the port's Llama (dp2 x pp2 x mp2,
    ZeRO over dp, 4 steps), held against the JAX SpmdTrainStep on the
    carried weights: the losses and every gathered weight (the GQA kv
    heads split over mp, the vocab-parallel embedding, head and loss)
    and moment within 1e-5; the loss is finite and falls."""
    J.seed(2)
    jm = jax_llama_tiny()
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(5).randint(0, 128, (8, 16)).astype(np.int32)
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    epsilon=EPS, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    tr = JaxSpmdTrainStep(jm, jo, jax_mesh(dp=2, pp=2, sharding=1, mp=2),
                          n_microbatches=2, zero_axis="dp")
    want_l = [float(tr.step(J.to_tensor(ids), J.to_tensor(ids)).numpy())
              for _ in range(4)]
    st = tr.state_dict()
    want_p = {g: {k: np.asarray(v) for k, v in sub.items()}
              for g, sub in st["params"].items()}
    want_m1 = {g: {k: np.asarray(s["moment1"]) for k, s in sub.items()}
               for g, sub in st["opt_state"].items()}
    got = pool8.run(T.trainer_task, sd, 4, ids, ids, dict(dp=2, pp=2, mp=2),
                    dict(n_microbatches=2, zero_axis="dp"), 4, None, LR, EPS,
                    "llama")
    for r in got:
        _check(r, want_l, want_p, want_m1)
        assert all(np.isfinite(r["losses"]))
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        np.testing.assert_allclose(r["model_ln_f"],
                                   want_p["head"]["norm.weight"], rtol=1e-5,
                                   atol=1e-6)
