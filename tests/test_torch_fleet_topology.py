"""fleet's topology, init, recompute and meta optimizers on the port
against the JAX package.

- ``CommunicateTopology`` (a verbatim copy) gives the JAX coordinates,
  ranks, axis lists and comm lists for several degree tuples.
- ``build_mesh`` is a mesh of ranks with the JAX axis order and
  dropping: the port's ``shape`` equals the JAX mesh's for the same
  degrees, and more ranks than the world has raise the JAX
  ``ValueError``.
- ``fleet.init`` over a pool of four gloo ranks (dp2 x mp2, and dp4 by
  default) gives each rank the JAX hcg's degrees, its coordinates as the
  JAX topology computes them, and groups that hold the JAX comm lists;
  a SUM over each group adds its members' values (the group order: every
  rank creates every comm list's group in one order; a rank creating
  its own list first would meet another list in ``new_group`` and the
  pool's 30 s gloo timeout would fail the test).
- ``recompute`` / ``recompute_sequential``: forward and gradients equal
  to the plain run, with dropout drawing the same masks in the
  recompute; the policies; the JAX ``ValueError`` for an unknown one.
- the meta optimizers over the data-parallel group of four ranks:
  ``LocalSGD`` averages the parameters every k steps, ``FP16AllReduce``
  averages the fp16 gradients, against numpy.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology as JTopology)
from paddle_tpu.distributed.fleet.topology import build_mesh as jax_mesh

import paddle_tpu_torch as P
from paddle_tpu_torch.distributed import fleet
import torch_dist_pool as TP
import torch_hybrid_tasks as H

NAMES = ["data", "pipe", "sharding", "model"]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool4():
    p = TP.RankPool(4)
    yield p
    p.close()


@pytest.mark.parametrize("dims", [(2, 2, 1, 2), (1, 1, 1, 4), (2, 1, 2, 1),
                                  (1, 2, 1, 2), (3, 1, 1, 2)])
def test_communicate_topology_equals_jax(dims):
    got, want = fleet.CommunicateTopology(NAMES, dims), \
        JTopology(NAMES, dims)
    assert got.world_size() == want.world_size()
    for r in range(want.world_size()):
        assert got.get_coord(r) == want.get_coord(r)
        assert got.get_rank(**dict(zip(NAMES, want.get_coord(r)))) == r
    for name in NAMES:
        assert got.get_comm_list(name) == want.get_comm_list(name)
        assert got.get_dim(name) == want.get_dim(name)
        for i in range(want.get_dim(name)):
            assert got.get_axis_list(name, i) == want.get_axis_list(name, i)


def test_build_mesh_in_one_process_and_its_error():
    import jax

    mesh = fleet.build_mesh()
    assert mesh.shape == dict(jax_mesh(devices=jax.devices()[:1]).shape)
    assert mesh.axis_names == ("dp", "pp", "sharding", "mp")
    with pytest.raises(ValueError, match="requires 2 devices, have 1"):
        fleet.build_mesh(dp=2)
    with pytest.raises(ValueError):
        jax_mesh(dp=2, devices=jax.devices()[:1])


@pytest.mark.parametrize("kw", [{"dp": 2, "mp": 2}, {"sep": 4},
                                {"dp": 2, "sep": 2}, {"pp": 2, "mp": 2},
                                {"dp": 8}])
def test_build_mesh_over_four_ranks_matches_the_jax_mesh(pool4, kw):
    import jax

    got = pool4.run(H.build_mesh_task, kw)
    try:
        want = jax_mesh(**kw, devices=jax.devices()[:4])
    except ValueError as e:
        assert all(r["error"] == str(e) for r in got)
        return
    devices = np.arange(4)[:want.devices.size].reshape(want.devices.shape)
    for rank, r in enumerate(got):
        assert r["shape"] == dict(want.shape)
        assert tuple(r["axes"]) == want.axis_names
        assert np.array_equal(r["devices"], devices)
        where = np.argwhere(devices == rank)[0]
        assert r["coords"] == {a: int(where[i])
                               for i, a in enumerate(want.axis_names)}


@pytest.mark.parametrize("degrees", [(2, 2), (1, 1)])
def test_fleet_init_over_four_ranks_gives_the_jax_hcg(pool4, degrees):
    """dp2 x mp2, and the JAX default of all degrees 1 (dp takes the
    world)."""
    import paddle_tpu.distributed.fleet as jfleet

    dp, mp = degrees
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": 1, "sharding_degree": 1}
    need = dp * mp
    jdims = (4, 1, 1, 1) if need == 1 else (dp, 1, 1, mp)
    topo = JTopology(NAMES, jdims)
    got = pool4.run(H.hcg_task, dp, mp)
    for rank, r in enumerate(got):
        coord = dict(zip(NAMES, topo.get_coord(rank)))
        assert r["degrees"] == (jdims[0], jdims[3], 1, 1)
        assert r["ranks"] == (coord["data"], coord["model"], coord["pipe"],
                              coord["sharding"])
        assert r["mesh"] == {"dp": jdims[0], "pp": 1, "sharding": 1,
                             "mp": jdims[3]}
        for name, ranks in r["groups"].items():
            lists = topo.get_comm_list(name)
            assert ranks in lists and rank in ranks
            assert r["sums"][name] == sum(x + 1 for x in ranks)
        assert r["src"] == (r["groups"]["data"][0], r["groups"]["model"][0])
        assert r["global_rank"] == rank
        assert r["fleet"] == (rank, 4, rank == 0, True, True)
        assert r["mode"] == (1 if jdims[3] > 1 else 0)


def test_the_dataset_waits_for_the_parameter_server():
    """The dataset came with the parameter server: fleet exports the
    dataset module's classes."""
    from paddle_tpu_torch.distributed.fleet import dataset

    assert fleet.InMemoryDataset is dataset.InMemoryDataset
    assert fleet.QueueDataset is dataset.QueueDataset
    assert issubclass(fleet.InMemoryDataset, dataset.DatasetBase)


# ----------------------------------------------------------- recompute --
def _net(seed=0):
    from paddle_tpu_torch import nn

    P.seed(seed)
    return nn.Sequential(nn.Linear(4, 8), nn.Dropout(0.5), nn.ReLU(),
                         nn.Linear(8, 2))


def _grads(net, x, run):
    out = run(net, x)
    out.sum().backward()
    return out.numpy(), [p.grad.numpy() for p in net.parameters()], \
        x.grad.numpy()


@pytest.mark.parametrize("policy", [None, "full", "dots",
                                    "dots_with_no_batch_dims",
                                    "nothing_saveable",
                                    "everything_saveable"])
def test_recompute_equals_the_plain_run(policy):
    """The same dropout masks in the recompute: output and gradients
    bitwise those of the plain run from the same seed."""
    from paddle_tpu_torch.distributed.fleet import recompute

    xs = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    P.seed(3)
    plain = _grads(_net(), P.to_tensor(xs, stop_gradient=False),
                   lambda n, x: n(x))
    P.seed(3)
    again = _grads(_net(), P.to_tensor(xs, stop_gradient=False),
                   lambda n, x: recompute(n, x, policy=policy))
    assert np.array_equal(plain[0], again[0])
    for a, b in zip(plain[1] + [plain[2]], again[1] + [again[2]]):
        assert np.array_equal(a, b)


def test_recompute_restores_the_generators_after_the_recompute():
    """The draws after a recomputed segment are not repeated: the global
    generator ends where the plain run leaves it."""
    from paddle_tpu_torch.distributed.fleet import recompute
    from paddle_tpu_torch.framework import random as prandom

    xs = P.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
    P.seed(5)
    net = _net()
    recompute(net, xs).sum().backward()
    after = prandom.generator(torch.device("cpu")).get_state()
    P.seed(5)
    net = _net()
    net(xs).sum()
    assert torch.equal(after,
                       prandom.generator(torch.device("cpu")).get_state())


def test_recompute_sequential_and_unknown_policy():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import (recompute,
                                                    recompute_sequential)

    P.seed(0)
    seq = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 8),
                        nn.ReLU(), nn.Linear(8, 2))
    x = P.to_tensor(np.random.RandomState(1).rand(2, 4).astype(np.float32))
    want = seq(x).numpy()
    got = recompute_sequential({"segments": 2}, seq, x)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(seq, x, policy="nope")


# ----------------------------------------------------- meta optimizers --
def test_fp16_allreduce_rounds_the_gradient_through_fp16():
    """The fact of the reference body
    ``test_fp16_allreduce_quantizes_grads_before_step``: the strategy
    wires ``FP16AllReduceOptimizer``, and the inner step sees the
    gradient rounded through float16 (0.1 becomes 0.0999755859375)."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        FP16AllReduceOptimizer, apply_strategy_to_optimizer)

    P.seed(0)
    m = nn.Linear(4, 1)
    s = fleet.DistributedStrategy()
    s.fp16_allreduce = True
    opt = apply_strategy_to_optimizer(
        optimizer.SGD(learning_rate=1.0, parameters=m.parameters()), s)
    assert isinstance(opt, FP16AllReduceOptimizer)
    seen = []
    inner = opt._inner.step
    opt._inner.step = lambda: (seen.append(m.weight.grad.numpy()), inner())
    m.weight.grad = P.to_tensor(np.full((4, 1), 0.1, np.float32))
    opt.step()
    assert np.array_equal(seen[0], np.full((4, 1), np.float16(0.1),
                                           np.float32))
    assert not np.allclose(seen[0], 0.1, rtol=1e-6, atol=0)


def test_localsgd_and_fp16_allreduce_over_the_dp_group(pool4):
    got = pool4.run(H.meta_optimizer_task)
    w0 = got[0]["w0"]
    # LocalSGD (k = 2): the ranks step on their own, then average
    local = [r["localsgd_step1"] for r in got]
    assert not all(np.array_equal(local[0], w) for w in local[1:])
    avg = np.mean([r["localsgd_step2_local"] for r in got], axis=0)
    for r in got:
        np.testing.assert_allclose(r["localsgd_step2"], avg, rtol=1e-6,
                                   atol=1e-7)
    # FP16AllReduce: every rank applies the fp16 mean of the gradients
    mean16 = np.mean([r["grad"].astype(np.float16).astype(np.float32)
                      for r in got], axis=0)
    for r in got:
        np.testing.assert_allclose(w0 - r["fp16_w"], 0.1 * mean16,
                                   rtol=2e-3, atol=1e-6)
        np.testing.assert_array_equal(r["fp16_w"], got[0]["fp16_w"])
