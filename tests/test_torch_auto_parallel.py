"""auto_parallel on the port against the JAX package.

- ``ProcessMesh``: shape, ndim, process ids, dim names, the id array,
  dim sizes, equality and hash as the JAX one's; ``placements_to_spec``
  and ``shard_spec_to_spec`` give the JAX spec entries (as tuples).
- Over a pool of two gloo ranks (``torch_dist_pool``) each rank holds
  its block of ``shard_tensor`` (the placements API and the 2.5
  ``shard_spec``), ``reshard`` to ``Replicate`` gathers it back (the
  JAX value: the whole array), ``Partial`` sums, ``Shard(1)`` of a
  replicated tensor splits the columns, ``dtensor_from_fn`` and
  ``shard_op`` keep the rank's block of the JAX result, ``shard_layer``
  gives every rank the first rank's parameters.
- ``Engine.fit/evaluate/predict/save/load`` in one process against the
  JAX ``Engine`` on the same data (losses within 1e-5 relative); over two
  ranks, each taking half of every batch, the weights of one process's
  run on the whole batches.
- The tuner: for the same ``ClusterSpec`` numbers the port's
  ``CostEstimator`` gives the JAX memory and step-time values and
  ``ParallelTuner`` the JAX candidates and picks; ``ClusterSpec()`` on a
  host without a card calibrates by a timed matmul; ``Mapper`` lays the
  ranks out (dp, pp, mp).
"""

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu.distributed import auto_parallel as JA

import paddle_tpu_torch as P
from paddle_tpu_torch.distributed import auto_parallel as A
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


def test_process_mesh_equals_the_jax_one():
    ids = [[0, 1, 2, 3], [4, 5, 6, 7]]
    got, want = A.ProcessMesh(ids, dim_names=["x", "y"]), \
        JA.ProcessMesh(ids, dim_names=["x", "y"])
    for attr in ("shape", "ndim", "process_ids", "processes", "dim_names"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert np.array_equal(got.mesh, want.mesh)
    assert got.get_dim_size("y") == want.get_dim_size("y") == 4
    assert got == A.ProcessMesh(ids, dim_names=["x", "y"])
    assert got != A.ProcessMesh(ids, dim_names=["a", "b"])
    assert hash(got) == hash(A.ProcessMesh(ids, dim_names=["x", "y"]))
    flat = A.ProcessMesh(None, process_ids=range(6), shape=[2, 3])
    assert flat.shape == [2, 3] and flat.dim_names == ["d0", "d1"]
    assert repr(got) == repr(want)


def test_placement_specs_equal_the_jax_specs():
    from paddle_tpu.distributed.auto_parallel import placement as jp
    from paddle_tpu_torch.distributed.auto_parallel import placement as pp

    cases = [([pp.Shard(0), pp.Replicate()], [jp.Shard(0), jp.Replicate()]),
             ([pp.Shard(1), pp.Shard(1)], [jp.Shard(1), jp.Shard(1)]),
             ([pp.Replicate(), pp.Shard(0)], [jp.Replicate(), jp.Shard(0)])]
    for got, want in cases:
        assert pp.placements_to_spec(got, ["x", "y"], 3) == \
            tuple(jp.placements_to_spec(want, ["x", "y"], 3))
    assert pp.shard_spec_to_spec(["x", None], 3) == \
        tuple(jp.shard_spec_to_spec(["x", None], 3))
    assert pp.Shard(0) == pp.Shard(0) and pp.Shard(0) != pp.Shard(1)
    assert pp.Partial().is_partial() and pp.Replicate().is_replicate()


def test_shard_reshard_op_and_layer_over_two_ranks(pool):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = pool.run(H.auto_parallel_task, x)
    for rank, r in enumerate(got):
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(r["a"], x[rows])
        placements, global_shape, same_mesh = r["a_meta"]
        assert placements == [A.Shard(0)] and global_shape == [4, 6]
        assert same_mesh
        np.testing.assert_array_equal(r["b"], x)
        assert r["b_is_a"]
        np.testing.assert_array_equal(r["c"], x[:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(r["summed"], 3 * x)
        np.testing.assert_array_equal(r["spec"], x[rows])
        np.testing.assert_array_equal(r["fn"], np.ones((2, 2)))
        np.testing.assert_allclose(r["prod"], (x @ x.T)[rows], rtol=1e-6)
        np.testing.assert_array_equal(r["layer"], got[0]["layer"])
        assert r["layer_meta"] == [A.Replicate()]


def _regression_data():
    rs = np.random.RandomState(0)
    X = rs.randn(128, 8).astype("float32")
    Y = (X @ rs.randn(8, 1)).astype("float32")
    return X, Y


def _engine(pkg, model_seed=0):
    pkg.seed(model_seed)
    nn, optimizer = pkg.nn, pkg.optimizer

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 32)
            self.fc2 = nn.Linear(32, 1)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    model = Net()
    opt = optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    mod = JA if pkg is J else A
    return model, mod.Engine(
        model=model, loss=lambda out, y: nn.functional.mse_loss(out, y),
        optimizer=opt, strategy=mod.Strategy())


def test_engine_fit_evaluate_predict_match_the_jax_engine(tmp_path):
    X, Y = _regression_data()
    jmodel, jeng = _engine(J)
    pmodel, peng = _engine(P)
    pmodel.set_state_dict({k: P.to_tensor(v.numpy())
                           for k, v in jmodel.state_dict().items()})
    got, want = {}, {}
    for pkg, eng, out in ((J, jeng, want), (P, peng, got)):
        ds = pkg.io.TensorDataset([pkg.to_tensor(X), pkg.to_tensor(Y)])
        out["loss"] = eng.fit(ds, epochs=2, batch_size=32).history["loss"]
        out["eval"] = eng.evaluate(ds, batch_size=32)["loss"]
        out["pred"] = eng.predict(
            pkg.io.TensorDataset([pkg.to_tensor(X)]), batch_size=32)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    assert len(got["pred"]) == len(want["pred"]) == 4
    for a, b in zip(got["pred"], want["pred"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    peng.save(str(tmp_path / "ckpt"))
    back = J.load(str(tmp_path / "ckpt") + ".pdparams")
    assert sorted(back) == sorted(pmodel.state_dict())
    pmodel.fc1.weight.set_value(np.zeros((8, 32), np.float32))
    peng.load(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(pmodel.fc1.weight.numpy(),
                                  np.asarray(back["fc1.weight"]))


def test_engine_over_two_ranks_equals_one_process(pool):
    rs = np.random.RandomState(3)
    X = rs.randn(16, 4).astype(np.float32)
    Y = rs.randn(16, 1).astype(np.float32)
    got = pool.run(H.engine_task, X, Y)
    # one process over the whole batches of 8
    from paddle_tpu_torch import nn, optimizer

    P.seed(0)
    model = nn.Linear(4, 1)
    opt = optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    for i in range(2):
        xb, yb = (P.to_tensor(a[8 * i:8 * i + 8]) for a in (X, Y))
        loss = nn.functional.mse_loss(model(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
    for r in got:
        np.testing.assert_allclose(r["w"], model.weight.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r["b"], model.bias.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert len(got[0]["losses"]) == 2


SCENARIOS = {
    "tight_memory": dict(n_dev=8, hbm=8e9, n_params=1.3e9, hidden=2048,
                         layers=24, tokens=8 * 2048),
    "small_model": dict(n_dev=8, hbm=1e12, n_params=1e6, hidden=256,
                        layers=4, tokens=8 * 2048),
    "dp_comm_heavy": dict(n_dev=8, hbm=1e12, n_params=1.3e9, hidden=2048,
                          layers=24, tokens=8 * 2048),
    "gpt124m_h100x4": dict(n_dev=4, hbm=80e9, n_params=124e6, hidden=768,
                           layers=12, tokens=8 * 1024),
}


def _estimator(mod, sc):
    cluster = mod.ClusterSpec(num_devices=sc["n_dev"], hbm_bytes=sc["hbm"],
                              flops_bf16=459e12, ici_bandwidth=9.8e10)
    return mod.CostEstimator(cluster, n_params=sc["n_params"],
                             flops_per_token=6 * sc["n_params"],
                             tokens_per_batch=sc["tokens"],
                             hidden_size=sc["hidden"],
                             num_layers=sc["layers"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tuner_decides_as_the_jax_tuner(name):
    sc = SCENARIOS[name]
    got, want = _estimator(A, sc), _estimator(JA, sc)
    for kw in ({}, {"recompute": True}, {"sp": True, "n_micro": 4}):
        for dims in ((8, 1, 1), (2, 2, 2), (1, 4, 2)):
            assert got.memory_bytes(*dims, **kw) == \
                want.memory_bytes(*dims, **kw)
            assert got.step_time(*dims, **kw) == want.step_time(*dims, **kw)
    tg, tw = A.ParallelTuner(got), JA.ParallelTuner(want)
    assert tg.candidates() == tw.candidates()
    assert tg.tune(top_k=5) == tw.tune(top_k=5)


def test_refine_times_the_candidates_the_world_holds(pool):
    """Over two ranks: every candidate with dp * pp * mp = 2 is built
    into an SpmdTrainStep and timed (a finite time; pp = 2 through the
    pipeline), the others are recorded with the reason, and the list is
    sorted by the measured time."""
    got = pool.run(H.refine_task)
    for r in got[0]:
        holds = r["dp"] * r["mp"] * r["pp"] == 2
        assert np.isfinite(r["measured_step_time"]) == holds, r
        assert ("error" in r) != holds
    times = [r["measured_step_time"] for r in got[0]]
    assert times == sorted(times)
    assert {(r["dp"], r["mp"], r["pp"]) for r in got[0]
            if np.isfinite(r["measured_step_time"])} == {
                (2, 1, 1), (1, 2, 1), (1, 1, 2)}


def test_calibrate_dcn_over_two_ranks(pool):
    for r in pool.run(H.dcn_task):
        assert r["before"] == (2.5e9, False)
        assert r["bw"] is not None and r["bw"] > 0
        assert r["after"] == (r["bw"], True)


def test_cluster_spec_on_a_host_without_a_card():
    c = A.ClusterSpec()
    assert c.device_kind == "cpu" and c.num_devices == 1
    assert 1e8 < c.flops_bf16 < 1e15
    assert c.hbm_bytes == 8e9
    assert c.calibrate_dcn() is None
    h100 = A.tuner._DEVICE_KINDS["nvidia h100 80gb hbm3"]
    assert h100["flops_bf16"] == 989e12
    assert set(JA.tuner._DEVICE_KINDS) < set(A.tuner._DEVICE_KINDS)


def test_mapper_lays_out_the_ranks():
    m = A.Mapper(devices=[0])
    mesh = m.build_mesh()
    assert mesh.axis_names == ("dp", "pp", "mp")
    assert mesh.devices.shape == (1, 1, 1)
    with pytest.raises(ValueError):
        A.Mapper().build_mesh(dp=2)
