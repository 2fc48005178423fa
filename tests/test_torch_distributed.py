"""The port's groups, collectives and DataParallel against the JAX
package (ROADMAP A23b-6a).

- The port exports every name of the JAX package's ``communication``,
  ``group`` and ``parallel`` modules, ``TCPStore``, ``spawn`` and the
  submodules.
- **World size 1.**  Every collective on a seeded input equals the JAX
  op's output on the same input over a one-device group: the identity
  the JAX module defines on one copy (``send``/``recv`` raise in both).
- **World size 2** (one module-scoped pool of two gloo ranks,
  ``torch_dist_pool``): each rank holds its block of arange(8); the
  ranks agree with each other and with numpy — the facts of the
  reference's ``TestCollectives``: the psum value 28, the gather order,
  the reduce-scatter of ones (the group's size in every element), the
  ring permute (``np.roll`` by one rank's block).
- **DataParallel.**  ``gpt_tiny`` (2 layers, hidden 32) with the JAX
  model's weights takes 3 SGD ``TrainStep``s under ``DataParallel`` over
  a one-rank gloo group, within 1e-5 of the JAX ``TrainStep`` under
  ``build_mesh(dp=8)`` + ``shard_batch`` on the same batch (the fact of
  ``TestSpmdTraining::test_dp_sharded_train_step``).  At world size 2
  each rank takes half the batch: the mean of the two losses and every
  weight within 1e-5 of one process's steps over the whole batch.
  ``no_sync()`` skips the averaging; ``find_unused_parameters`` averages
  zeros for a gradient that never arrived, and without it the backward
  raises.
"""

import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as P
import paddle_tpu_torch.distributed as pdist
import torch_dist_pool as TP


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def test_exports_every_name_of_the_jax_modules():
    from paddle_tpu.distributed import communication, group, parallel

    for mod in (communication, group, parallel):
        names = [n for n in vars(mod) if not n.startswith("_")
                 and callable(getattr(mod, n))
                 and getattr(getattr(mod, n), "__module__", "")
                 == mod.__name__]
        missing = [n for n in names if not hasattr(pdist, n)
                   and not hasattr(getattr(pdist, mod.__name__.rsplit(
                       ".", 1)[1]), n)]
        assert not missing, (mod.__name__, missing)
    public = {n for n in dir(jdist) if not n.startswith("_")}
    assert public <= set(dir(pdist))
    for name in ("TCPStore", "spawn", "checkpoint", "sharding", "launch",
                 "rpc", "fleet", "auto_parallel", "ps"):
        assert hasattr(pdist, name)


def test_later_names_raise_naming_their_item():
    """No name waits for a later part of the port any more: the
    parameter server, fleet's dataset, fleet's topology and auto_parallel
    are all ported."""
    from paddle_tpu_torch.distributed import auto_parallel, fleet, ps

    for mod, name in ((fleet, "InMemoryDataset"), (fleet, "QueueDataset"),
                      (ps, "SparseTable"), (ps, "DistributedEmbedding"),
                      (ps, "HotRowCache"), (ps, "PsServer"),
                      (ps, "GraphTable")):
        assert callable(getattr(mod, name))
    assert fleet.DistributedStrategy is not None
    assert auto_parallel.Strategy is not None
    for mod, name in ((fleet, "build_mesh"),
                      (fleet, "HybridCommunicateGroup"),
                      (auto_parallel, "ProcessMesh")):
        assert callable(getattr(mod, name))
    with pytest.raises(AttributeError):
        ps.no_such_name


# ------------------------------------------------------ world size 1 --
def _x(seed=21, shape=(4, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(fn):
    """fn(mod, dist, group) on the JAX package (a one-device group) and
    on the port (its one-process default group), as numpy."""
    jg = jdist.new_group([0])
    got = []
    for mod, dist, g in ((J, jdist, jg), (P, pdist, None)):
        out = fn(mod, dist, g)
        got.append(out)
    return got


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return v.numpy() if hasattr(v, "numpy") else v


W1 = {
    **{f"all_reduce_{op}": (lambda op: lambda m, d, g: d.all_reduce(
        m.to_tensor(_x()), op=op, group=g))(op)
       for op in ("sum", "max", "min", "prod", "avg")},
    "all_gather": lambda m, d, g: (lambda parts: (
        d.all_gather(parts, m.to_tensor(_x()), group=g), parts))([]),
    "all_gather_object": lambda m, d, g: (lambda objs: (
        d.all_gather_object(objs, {"a": 1}, group=g), objs)[1])([]),
    "reduce_scatter": lambda m, d, g: d.reduce_scatter(
        None, m.to_tensor(_x()), group=g),
    "reduce_scatter_list": lambda m, d, g: d.reduce_scatter(
        m.to_tensor(np.zeros((8, 3), np.float32)),
        [m.to_tensor(_x()), m.to_tensor(_x(22))], group=g),
    "broadcast": lambda m, d, g: d.broadcast(m.to_tensor(_x()), src=0,
                                             group=g),
    "reduce": lambda m, d, g: d.reduce(m.to_tensor(_x()), dst=0, group=g),
    "scatter": lambda m, d, g: d.scatter(
        m.to_tensor(np.zeros((4, 3), np.float32)), [m.to_tensor(_x())],
        src=0, group=g),
    "alltoall_list": lambda m, d, g: d.alltoall([m.to_tensor(_x())],
                                                group=g),
    "alltoall_tensor": lambda m, d, g: d.all_to_all(m.to_tensor(_x()),
                                                    group=g),
    "barrier": lambda m, d, g: d.barrier(group=g),
    "wait": lambda m, d, g: d.wait(m.to_tensor(_x())),
}


@pytest.mark.parametrize("name", sorted(W1))
def test_world_size_1_collective_equals_the_jax_op(name):
    want, got = _both(W1[name])
    if name == "all_gather":
        assert len(got[1]) == len(want[1]) == 1
    np.testing.assert_equal(_np(got), _np(want))


def test_world_size_1_send_recv_raise_and_permute_is_identity():
    for fn in (pdist.send, pdist.recv):
        with pytest.raises(RuntimeError, match="peer"):
            fn(P.to_tensor(_x()))
    for fn in (jdist.send, jdist.recv):
        with pytest.raises(NotImplementedError):
            fn(J.to_tensor(_x()))
    out = pdist.p2p_permute(P.to_tensor(_x()), [(0, 0)])
    np.testing.assert_array_equal(out.numpy(), _x())
    np.testing.assert_array_equal(
        pdist.p2p_permute(P.to_tensor(_x()), []).numpy(),
        np.zeros_like(_x()))
    with pytest.raises(ValueError, match="outside"):
        pdist.p2p_permute(P.to_tensor(_x()), [(0, 1)])


def test_world_size_1_group_and_env():
    g = pdist.get_group()
    assert (g.nranks, g.rank, g.ranks) == (1, 0, [0])
    assert pdist.get_rank() == 0 and pdist.get_world_size() == 1
    assert not pdist.is_initialized()
    assert g.get_group_rank(3) == -1
    assert pdist.parallel.coordinator_address("10.0.0.1:6170") == \
        jdist.parallel.coordinator_address("10.0.0.1:6170")
    with pytest.raises(ValueError):
        pdist.parallel.coordinator_address("nohost")
    with pytest.raises(ValueError, match="outside"):
        pdist.new_group([0, 1])


def test_a_job_of_two_without_a_group_refuses(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setattr(pdist.group, "_default_group", None)
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        pdist.all_reduce(P.to_tensor(_x()))
    monkeypatch.setattr(pdist.group, "_default_group", None)


# ------------------------------------------------------ world size 2 --
def _agree(results):
    for r in results[1:]:
        np.testing.assert_equal(r, results[0])
    return results[0]


@pytest.mark.parametrize("op,fn", [("sum", np.add), ("max", np.maximum),
                                   ("min", np.minimum),
                                   ("prod", np.multiply),
                                   ("avg", lambda a, b: (a + b) / 2)])
def test_all_reduce_ops(pool, op, fn):
    out = _agree(pool.run(TP.collective_task, f"all_reduce_{op}"))
    want = fn(TP.shard8(0, 2) + 1, TP.shard8(1, 2) + 1)
    np.testing.assert_allclose(out["tensor"], want)
    np.testing.assert_allclose(out["raw"], want)
    assert out["same"]


def test_psum_of_the_blocks_is_28(pool):
    assert _agree(pool.run(TP.collective_task, "psum_scalar")) == 28.0


def test_all_gather_order_and_objects(pool):
    out = _agree(pool.run(TP.collective_task, "all_gather"))
    np.testing.assert_array_equal(out["concat"], np.arange(8.0))
    np.testing.assert_array_equal(out["parts"][1], np.arange(4.0, 8.0))
    objs = _agree(pool.run(TP.collective_task, "all_gather_object"))
    assert objs == [{"rank": 0}, {"rank": 1}]


def test_reduce_scatter_of_ones(pool):
    outs = pool.run(TP.collective_task, "reduce_scatter")
    got = np.concatenate([o["tensor"] for o in outs])
    np.testing.assert_array_equal(got, 2.0 * np.ones(8))
    for o in outs:
        np.testing.assert_array_equal(o["list"], 2.0 * np.ones(4))


def test_broadcast_reduce_scatter_send_recv(pool):
    np.testing.assert_array_equal(
        _agree(pool.run(TP.collective_task, "broadcast")), np.arange(4, 8))
    red = pool.run(TP.collective_task, "reduce")
    np.testing.assert_array_equal(red[0], TP.shard8(0, 2) + TP.shard8(1, 2))
    np.testing.assert_array_equal(red[1], TP.shard8(1, 2))
    sc = pool.run(TP.collective_task, "scatter")
    np.testing.assert_array_equal(sc[0], [0, 0])
    np.testing.assert_array_equal(sc[1], [10, 10])
    sr = pool.run(TP.collective_task, "send_recv")
    np.testing.assert_array_equal(sr[1], np.arange(4.0))


def test_alltoall(pool):
    outs = pool.run(TP.collective_task, "alltoall")
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(np.stack(o["list"]),
                                      [[r, r], [10 + r, 10 + r]])
    np.testing.assert_array_equal(
        np.concatenate([o["single"] for o in outs]),
        [0, 1, 4, 5, 2, 3, 6, 7])


def test_ring_permute_is_the_roll(pool):
    outs = pool.run(TP.collective_task, "p2p_permute")
    np.testing.assert_array_equal(np.concatenate(outs),
                                  np.roll(np.arange(8.0), 4))


def test_barrier_wait_and_a_subgroup(pool):
    assert pool.run(TP.collective_task, "barrier_wait") == [True, True]
    outs = pool.run(TP.collective_task, "new_group")
    assert [o["rank"] for o in outs] == [-1, 0]
    assert all(o["nranks"] == 1 and o["group_rank"] == 0 for o in outs)
    # rank 0 is outside: its tensor is left as it was
    np.testing.assert_array_equal(outs[0]["value"], TP.shard8(0, 2))
    np.testing.assert_array_equal(outs[1]["value"], TP.shard8(1, 2))


# ------------------------------------------------------ DataParallel --
def _gpt_batch(b=8, t=16, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (b, t)).astype(np.int64),
            rng.randint(0, 128, (b, t)).astype(np.int64))


@pytest.fixture(scope="module")
def jax_gpt():
    """The JAX gpt_tiny (2 layers, hidden 32) and its weights."""
    from paddle_tpu.models.gpt import gpt_tiny

    J.seed(5)
    jm = gpt_tiny(num_layers=2, hidden_size=32)
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


LR, STEPS = 0.5, 3


def test_data_parallel_matches_the_jax_dp8_step(jax_gpt):
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed.fleet import build_mesh
    from paddle_tpu.distributed.fleet.spmd import shard_batch, use_mesh
    from paddle_tpu.jit import TrainStep as JTrainStep

    jm, sd = jax_gpt
    ids, labels = _gpt_batch()
    jo = jopt.SGD(learning_rate=LR, parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda lg, lb: jm.loss(lg, lb), jo)
    mesh = build_mesh(dp=8)
    want = []
    with use_mesh(mesh):
        bx, by = shard_batch((J.to_tensor(ids.astype(np.int32)),
                              J.to_tensor(labels.astype(np.int32))), mesh)
        for _ in range(STEPS):
            want.append(float(jstep(bx, by).numpy()))
    jw = {k: np.asarray(v) for k, v in jstep._params.items()}

    pdist.init_parallel_env(device="cpu", timeout=30)
    try:
        assert pdist.is_initialized() and pdist.get_world_size() == 1
        losses, pw = TP.gpt_dp_steps(sd, ids, labels, STEPS, LR, False)
    finally:
        pdist.destroy_process_group()
    assert not pdist.is_initialized()
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    for name, w in pw.items():
        np.testing.assert_allclose(w, jw[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_data_parallel_two_ranks_match_one_process(pool, jax_gpt):
    _, sd = jax_gpt
    ids, labels = _gpt_batch()
    one_losses, one_w = TP.gpt_dp_steps(sd, ids, labels, STEPS, LR, False)
    outs = pool.run(TP.gpt_dp_steps, sd, ids, labels, STEPS, LR, True)
    mean = np.mean([o[0] for o in outs], axis=0)
    np.testing.assert_allclose(mean, one_losses, rtol=1e-5)
    for name, w in one_w.items():
        for _, ws in outs:
            np.testing.assert_allclose(ws[name], w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_no_sync_skips_the_averaging(pool):
    outs = pool.run(TP.no_sync_task)
    assert not np.allclose(outs[0]["local"], outs[1]["local"])
    np.testing.assert_array_equal(outs[0]["synced"], outs[1]["synced"])
    # synced = the average of what each rank accumulated over both
    # backwards; the first backward's share alone is the local gradient
    assert not np.allclose(outs[0]["synced"], outs[0]["local"])


def test_find_unused_parameters_averages_zeros(pool):
    outs = pool.run(TP.unused_task, True)
    local = TP.local_grads_task([True, False])
    for k in ("fc1", "fc2", "fc3"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    np.testing.assert_allclose(
        outs[0]["fc1"], (local[0]["fc1"] + local[1]["fc1"]) / 2, rtol=1e-6)
    np.testing.assert_allclose(outs[0]["fc2"], local[0]["fc2"] / 2,
                               rtol=1e-6)
    np.testing.assert_array_equal(outs[0]["fc3"], 0.0)
    errs = pool.run(TP.unused_task, False)
    assert all("find_unused_parameters=True" in e["error"] for e in errs)


def test_data_parallel_passes_through_without_a_group():
    m = TP._linear_model(0)
    dp = pdist.DataParallel(m)
    x = P.to_tensor(_x(3, (4, 6)))
    np.testing.assert_array_equal(dp(x).numpy(), m(x).numpy())
    assert dp.state_dict().keys() == m.state_dict().keys()
    assert dp.fc1 is m.fc1
    with dp.no_sync():
        pass


def test_launch_module_main_is_a_verbatim_copy():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("launch/__main__.py", "launch/__init__.py"):
        with open(os.path.join(root, "paddle_tpu/distributed", rel)) as f:
            want = f.read()
        with open(os.path.join(root, "paddle_tpu_torch/distributed",
                               rel)) as f:
            assert f.read() == want, rel
