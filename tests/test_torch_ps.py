"""The port's parameter server (``distributed/ps``), fleet's dataset, the
CTR models, ``enable_dist_inference`` and the sparse ``SyncBatchNorm``
against the JAX package's.

Both packages' ``SparseTable`` s sit on the one native library (each
its own table), so the same pulls and pushes give the same rows.  With
identically seeded tables and the dense weights carried by numpy:

- ``SparseTable`` pull/push sequences (SGD, Adagrad, duplicate keys)
  and ``DistributedEmbedding``'s forward and backward push equal the JAX
  ones bitwise;
- ``HotRowCache`` (the device-side hot-row cache, its rows on an
  explicit device) over a host table stays step-for-step equal to the
  uncached table, duplicates, eviction and write-back included;
- DeepFM and Wide&Deep: logits and 3 Adam steps (losses, the dense
  weights and the touched table rows) equal the JAX models' (1e-5);
- over two gloo ranks (one module-scoped pool, ``torch_dist_pool``):
  ``InMemoryDataset.global_shuffle`` with the rank and world size from
  the port's process group keeps the records the JAX shuffle gives
  each rank; ``enable_dist_inference`` returns the one-rank
  Predictor's outputs on both ranks; the sparse ``SyncBatchNorm`` over
  two ranks equals one BatchNorm over both ranks' sites together
  (outputs, running stats, and gradients of the summed losses).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.distributed import ps as jps
from paddle_tpu.models.deepfm import DeepFM as JDeepFM
from paddle_tpu.models.wide_deep import WideDeep as JWideDeep

import paddle_tpu_torch as P
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.models.deepfm import DeepFM
from paddle_tpu_torch.models.wide_deep import WideDeep
import torch_dist_pool as TP
import torch_parallel_tasks as T


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    P.set_device("cpu")


@pytest.fixture(scope="module")
def pool():
    p = TP.RankPool(2)
    yield p
    p.close()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------ tables --
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_sparse_table_pull_push_sequence_matches_jax(opt):
    tables = [mod.SparseTable(dim=4, optimizer=opt, learning_rate=0.3,
                              seed=11) for mod in (ps, jps)]
    rng = np.random.RandomState(0)
    for step in range(5):
        keys = rng.randint(0, 20, 12)
        rows = [t.pull(keys) for t in tables]
        np.testing.assert_array_equal(rows[0], rows[1])
        grads = rng.randn(12, 4).astype(np.float32)
        tables[0].push(keys, torch.from_numpy(grads))
        tables[1].push(keys, grads)
    assert len(tables[0]) == len(tables[1])
    allk = np.arange(20)
    np.testing.assert_array_equal(tables[0].pull(allk), tables[1].pull(allk))


def test_distributed_embedding_pull_and_push_match_jax():
    ids = np.array([[1, 2, 3], [3, 1, 7]], np.int64)
    dy = _rand((2, 3, 4), 1)
    out = {}
    for pkg, mod in ((P, ps), (J, jps)):
        pkg.seed(0)
        emb = mod.DistributedEmbedding(4, optimizer="adagrad",
                                       learning_rate=0.2)
        y = emb(pkg.to_tensor(ids))
        (y * pkg.to_tensor(dy)).sum().backward()
        out[pkg] = (y.numpy(), emb.table.pull(np.arange(10)))
    assert out[P][0].shape == (2, 3, 4)
    np.testing.assert_array_equal(out[P][0], out[J][0])
    np.testing.assert_array_equal(out[P][1], out[J][1])


@pytest.mark.parametrize("opt,capacity", [("sgd", 64), ("adagrad", 64),
                                          ("sgd", 6), ("adagrad", 10)])
def test_hot_row_cache_equals_the_uncached_table(opt, capacity):
    """Pulls and pushes (Zipf keys, so duplicates) through the cache
    equal the same sequence on a host table; after ``flush`` the remote
    table holds the same rows.  Capacity 6 evicts and overflows (SGD: an
    overflowed key pushed through to the host keeps its Adagrad history
    there, the JAX cache's one documented exception), capacity 10 evicts
    Adagrad rows with their accumulators."""
    remote = ps.SparseTable(dim=3, optimizer=opt, learning_rate=0.1,
                            seed=5, epsilon=1e-8)
    base = ps.SparseTable(dim=3, optimizer=opt, learning_rate=0.1,
                          seed=5, epsilon=1e-8)
    cache = ps.HotRowCache(remote, capacity=capacity, optimizer=opt,
                           learning_rate=0.1, epsilon=1e-8, device="cpu")
    rng = np.random.RandomState(3)
    for step in range(8):
        keys = np.minimum(rng.zipf(1.5, 8), 30).astype(np.int64)
        got = cache.pull(keys)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), base.pull(keys), rtol=1e-6,
                                   atol=1e-7)
        g = rng.randn(8, 3).astype(np.float32)
        cache.push(keys, torch.from_numpy(g))
        base.push(keys, g)
    cache.flush()
    allk = np.arange(1, 31)
    np.testing.assert_allclose(remote.pull(allk), base.pull(allk),
                               rtol=1e-5, atol=1e-6)
    st = cache.stats()
    assert st["hits"] > 0 and (capacity > 10 or st["evictions"] > 0)


# --------------------------------------------------------- CTR models --
def _carry(jm, pm):
    pm.set_state_dict({k: P.to_tensor(v.numpy())
                       for k, v in jm.state_dict().items()})


@pytest.mark.parametrize("name", ["deepfm", "wide_deep"])
def test_ctr_model_logits_and_three_steps_match_jax(name):
    kw = dict(sparse_feature_dim=4, num_slots=3, hidden_sizes=(8, 4))
    J.seed(0)
    jm = (JDeepFM if name == "deepfm" else JWideDeep)(**kw)
    P.seed(0)
    pm = (DeepFM if name == "deepfm" else WideDeep)(**kw)
    _carry(jm, pm)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 50, (16, 3)).astype(np.int64)
    y = (ids[:, :1] % 2 == 0).astype(np.float32)
    res = {}
    for pkg, m in ((J, jm), (P, pm)):
        opt = pkg.optimizer.Adam(learning_rate=1e-2,
                                 parameters=m.parameters())
        logits, losses = None, []
        for _ in range(3):
            out = m(pkg.to_tensor(ids))
            logits = out.numpy() if logits is None else logits
            loss = pkg.nn.functional.binary_cross_entropy_with_logits(
                out, pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        names = ("fo_table", "emb_table") if name == "deepfm" else \
            ("wide_table", "deep_table")
        tables = [getattr(m, n).table.pull(np.arange(50)) for n in names]
        res[pkg] = (logits, losses, tables,
                    {k: v.numpy() for k, v in m.state_dict().items()})
    np.testing.assert_allclose(res[P][0], res[J][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[P][1], res[J][1], rtol=1e-5)
    for a, b in zip(res[P][2], res[J][2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for k, v in res[J][3].items():
        np.testing.assert_allclose(res[P][3][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------- over two ranks --
def _write_multislot(path, n, rng):
    with open(path, "w") as f:
        for _ in range(n):
            ids1 = rng.randint(0, 100, rng.randint(1, 4))
            ids2 = rng.randint(0, 100, 2)
            parts = ([str(len(ids1))] + [str(v) for v in ids1] +
                     [str(len(ids2))] + [str(v) for v in ids2] +
                     ["1", str(float(ids1[0] % 2))])
            f.write(" ".join(parts) + "\n")


def test_dataset_global_shuffle_over_two_ranks_matches_jax(pool, tmp_path,
                                                           monkeypatch):
    from paddle_tpu.distributed.fleet import InMemoryDataset

    rng = np.random.RandomState(0)
    paths = []
    for k in range(2):
        p = str(tmp_path / f"part-{k}")
        _write_multislot(p, 9, rng)
        paths.append(p)
    got = pool.run(T.dataset_shuffle_task, paths, 7)
    seen = []
    for rank, mine in enumerate(got):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        ds = InMemoryDataset()
        ds.init(batch_size=2, use_var=[("slot_a", "sparse"),
                                       ("slot_b", "sparse"),
                                       ("label", "dense")])
        ds.set_filelist(paths)
        ds.load_into_memory()
        ds.global_shuffle(seed=7)
        want = [np.concatenate([np.asarray(v, np.float64).ravel()
                                for v in rec]) for rec in ds._records]
        assert len(mine) == len(want)
        for a, b in zip(mine, want):
            np.testing.assert_array_equal(a, b)
        seen += [tuple(a) for a in mine]
    assert len(seen) == 18


def test_enable_dist_inference_over_two_ranks_equals_one(pool):
    from paddle_tpu_torch import inference, nn

    sd = {"0.weight": _rand((6, 8), 1), "0.bias": _rand((8,), 2),
          "2.weight": _rand((8, 3), 3), "2.bias": _rand((3,), 4)}
    x = _rand((4, 6), 5)
    got = pool.run(T.dist_inference_task, sd, x)
    P.seed(0)
    net = nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))
    net.set_state_dict({k: P.to_tensor(v) for k, v in sd.items()})
    cfg = inference.Config()
    cfg.set_model_obj(net)
    want = inference.create_predictor(cfg).run([x])[0]
    for r in got:
        np.testing.assert_allclose(r, want, rtol=1e-6, atol=1e-6)


def test_sparse_sync_batch_norm_over_two_ranks_equals_one(pool):
    from paddle_tpu_torch import sparse

    rng = np.random.RandomState(0)
    idx, vals, shape, dy = [], [], [], []
    for n in (5, 7):
        idx.append(np.stack([np.zeros(n, np.int64), np.arange(n),
                             np.zeros(n, np.int64),
                             np.zeros(n, np.int64)], 1))
        vals.append(rng.randn(n, 3).astype(np.float32))
        shape.append([1, 8, 1, 1, 3])
        dy.append(rng.randn(n, 3).astype(np.float32))
    got = pool.run(T.sync_bn_task, idx, vals, shape, dy)
    P.seed(0)
    bn = sparse.nn.BatchNorm(3)
    bn.train()
    v = P.to_tensor(np.concatenate(vals), stop_gradient=False)
    allidx = np.stack([np.zeros(12, np.int64), np.arange(12),
                       np.zeros(12, np.int64), np.zeros(12, np.int64)], 1)
    x = sparse.sparse_coo_tensor(P.to_tensor(allidx.T), v, [1, 12, 1, 1, 3])
    out = bn(x)
    (out.values() * P.to_tensor(np.concatenate(dy))).sum().backward()
    want_out = out.values().numpy()
    np.testing.assert_allclose(np.concatenate([r["out"] for r in got]),
                               want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dv"] for r in got]),
                               v.grad.numpy(), rtol=1e-4, atol=1e-5)
    for k, want in (("dw", bn.weight.grad.numpy()),
                    ("db", bn.bias.grad.numpy())):
        np.testing.assert_allclose(got[0][k] + got[1][k], want, rtol=1e-5,
                                   atol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["mean"], bn._mean.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["var"], bn._variance.numpy(),
                                   rtol=1e-5, atol=1e-6)
