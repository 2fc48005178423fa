"""The port's ``io`` (and ``metric``) against the JAX package's.

``dataset.py`` and ``sampler.py`` are verbatim copies
(``test_torch_engine.py::test_host_modules_are_verbatim_copies``) and
``metric`` differs from the JAX module only in ``accuracy``, which
reads a Tensor through numpy;
the bodies of the reference's ``tests/test_io.py::TestDataLoader`` and
``TestMultiprocessDataLoader`` run against the port's ``DataLoader``;
a forked worker never asks for CUDA; ``prefetch_to_device`` stages on
the device it is given and raises on an array that cannot move.
"""

import ast
import inspect
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import paddle_tpu.metric as jax_metric

import paddle_tpu_torch as paddle
import paddle_tpu_torch.metric as port_metric
from paddle_tpu_torch import io
from paddle_tpu_torch.framework import device as port_device


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    paddle.set_device("cpu")


def _defs(mod):
    tree = ast.parse(inspect.getsource(mod))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_metric_differs_only_in_accuracy():
    jd, pd = _defs(jax_metric), _defs(port_metric)
    assert set(jd) == set(pd)
    assert [k for k in jd if jd[k] != pd[k]] == ["accuracy"]


def test_metrics_match_reference():
    rng = np.random.RandomState(0)
    pred = rng.rand(32, 5).astype(np.float32)
    label = rng.randint(0, 5, (32, 1))
    probs = rng.rand(32).astype(np.float32)
    bins = rng.randint(0, 2, 32)
    for name, args in [("Accuracy", (pred, label)), ("Precision",
                                                      (probs, bins)),
                       ("Recall", (probs, bins)), ("Auc", (probs, bins))]:
        got = []
        for mod in (jax_metric, port_metric):
            m = getattr(mod, name)(**({"topk": (1, 3)} if name == "Accuracy"
                                      else {}))
            out = m.compute(*args)
            m.update(*(out if isinstance(out, tuple) else (out,)))
            got.append(m.accumulate())
        np.testing.assert_allclose(got[0], got[1], err_msg=name)
    acc = port_metric.accuracy(paddle.to_tensor(pred).astype("bfloat16"),
                               paddle.to_tensor(label), k=2)
    want = jax_metric.accuracy(pred, label, k=2)
    assert float(acc) == pytest.approx(float(np.asarray(want.numpy())),
                                       abs=1e-6)


def test_distributed_batch_sampler_defaults_to_one_process():
    """No process group: rank 0 of 1 (the JAX sampler reads
    ``jax.device_count()``, ROADMAP C)."""
    s = io.DistributedBatchSampler(RangeDataset(10), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert [i for b in s for i in b] == list(range(10))


class RangeDataset(io.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i), np.int64(i % 3)

    def __len__(self):
        return self.n


# ---- the bodies of the reference's tests/test_io.py::TestDataLoader ----
class TestDataLoader:
    def test_batching(self):
        loader = io.DataLoader(RangeDataset(10), batch_size=4)
        batches = list(loader)
        assert len(batches) == 3
        x, y = batches[0]
        # the port keeps Paddle's int64
        assert x.shape == [4] and y.dtype == torch.int64

    def test_drop_last_shuffle(self):
        loader = io.DataLoader(RangeDataset(10), batch_size=4, shuffle=True,
                               drop_last=True)
        batches = list(loader)
        assert len(batches) == 2
        seen = np.concatenate([b[0].numpy() for b in batches])
        assert len(set(seen.tolist())) == 8

    def test_tensor_dataset(self):
        xs = paddle.to_tensor(np.arange(12.0).reshape(6, 2).astype(
            np.float32))
        ds = io.TensorDataset([xs])
        assert len(ds) == 6
        loader = io.DataLoader(ds, batch_size=3)
        (batch,) = next(iter(loader))
        assert batch.shape == [3, 2]
        np.testing.assert_array_equal(batch.numpy(), xs.numpy()[:3])

    def test_prefetch_worker(self):
        loader = io.DataLoader(RangeDataset(20), batch_size=5, num_workers=2)
        assert len(list(loader)) == 4

    def test_distributed_batch_sampler(self):
        ds = RangeDataset(16)
        s0 = io.DistributedBatchSampler(ds, batch_size=2, num_replicas=4,
                                        rank=0)
        s1 = io.DistributedBatchSampler(ds, batch_size=2, num_replicas=4,
                                        rank=1)
        i0 = [i for b in s0 for i in b]
        i1 = [i for b in s1 for i in b]
        assert len(i0) == 4 and not set(i0) & set(i1)


class _SquaresDataset(io.Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.float32(i) ** 2


# ---- the bodies of the reference's TestMultiprocessDataLoader ----
class TestMultiprocessDataLoader:
    def test_order_is_deterministic(self):
        ds = _SquaresDataset(37)
        loader = io.DataLoader(ds, batch_size=5, num_workers=2,
                               shuffle=False)
        got = np.concatenate([b.numpy().ravel() for b in loader])
        np.testing.assert_array_equal(got, np.arange(37) ** 2)

    def test_slow_dataset_overlaps_with_consumer(self):
        """Items 0 and 2 (different workers) meet at a 2-party barrier,
        which releases only if both fetches are in flight at once."""
        barrier = mp.get_context("fork").Barrier(2)

        class Slow(io.Dataset):
            def __len__(self):
                return 12

            def __getitem__(self, i):
                met = 0.0
                if i in (0, 2):
                    try:
                        barrier.wait(timeout=60)
                        met = 1.0
                    except Exception:
                        met = 0.0
                return np.array([i, met], np.float64)

        loader = io.DataLoader(Slow(), batch_size=2, num_workers=4)
        rows = np.concatenate([b.numpy().reshape(-1, 2) for b in loader])
        assert len(rows) == 12
        assert sorted(rows[:, 0].astype(int)) == list(range(12))
        met = {int(r[0]): r[1] for r in rows}
        assert met[0] == 1.0 and met[2] == 1.0

    def test_user_collate_type_consistent_across_num_workers(self):
        def my_collate(batch):
            import paddle_tpu_torch as pd
            return {"x": pd.to_tensor(np.stack(batch)),
                    "n": len(batch),
                    "raw": np.stack(batch)}

        class Small(io.Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                return np.float32(i)

        b0 = next(iter(io.DataLoader(Small(), batch_size=4,
                                     collate_fn=my_collate)))
        b2 = next(iter(io.DataLoader(Small(), batch_size=4,
                                     collate_fn=my_collate, num_workers=2)))
        assert type(b0["x"]) is type(b2["x"])
        assert isinstance(b2["raw"], np.ndarray) and b2["n"] == 4
        np.testing.assert_allclose(b0["x"].numpy(), b2["x"].numpy())

    def test_worker_error_propagates(self):
        class Bad(io.Dataset):
            def __len__(self):
                return 4

            def __getitem__(self, i):
                if i == 2:
                    raise ValueError("boom")
                return np.float32(i)

        loader = io.DataLoader(Bad(), batch_size=1, num_workers=2)
        with pytest.raises(RuntimeError, match="boom"):
            list(loader)

    def test_iterable_dataset_workers_shard_via_worker_info(self):
        class Streaming(io.IterableDataset):
            def __iter__(self):
                info = io.get_worker_info()
                wid = info.id if info else 0
                n = info.num_workers if info else 1
                for i in range(wid, 10, n):
                    yield np.float32(i)

        loader = io.DataLoader(Streaming(), batch_size=2, num_workers=2)
        vals = sorted(float(v) for b in loader for v in b.numpy().ravel())
        assert vals == [float(i) for i in range(10)]


def test_forked_worker_never_asks_for_cuda(monkeypatch):
    """The parent's current device is CUDA and CUDA's lazy init is a trap
    (the fork inherits both): a worker that builds Tensors in its
    dataset and its collate_fn never springs it, since each worker makes
    the CPU its current device first.  The control shows the trap fires
    in the parent."""
    def trap():
        raise AssertionError("CUDA was asked for")

    monkeypatch.setattr(torch.cuda, "_lazy_init", trap)
    monkeypatch.setattr(port_device, "_current_device",
                        torch.device("cuda"))
    with pytest.raises(AssertionError, match="CUDA was asked for"):
        paddle.to_tensor(np.ones(2, np.float32))

    class Built(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return paddle.to_tensor(np.full(2, i, np.float32))

    def collate(batch):
        x = paddle.stack(batch)
        return {"x": x.numpy(), "device": paddle.get_device(),
                "worker": io.get_worker_info().id}

    # each worker writes its current device at start into its own slot
    # (forked workers share the array); which worker takes which batch
    # is up to the shared task queue, so the test does not ask for it
    started = mp.Array("i", [-1, -1])

    def init(worker_id):
        started[worker_id] = int(paddle.get_device() == "cpu")

    loader = io.DataLoader(Built(), batch_size=2, num_workers=2,
                           collate_fn=collate, worker_init_fn=init)
    it = iter(loader)
    out = [next(it) for _ in range(4)]
    # the loader stops its workers at its end: let both have started
    deadline = time.monotonic() + 60
    while -1 in list(started) and time.monotonic() < deadline:
        time.sleep(0.01)
    out += list(it)
    assert [b["device"] for b in out] == ["cpu"] * 4
    assert list(started) == [1, 1]
    assert {b["worker"] for b in out} <= {0, 1}
    np.testing.assert_array_equal(
        np.concatenate([b["x"][:, 0] for b in out]), np.arange(8))


def test_default_collate_stacks_tensor_samples_on_their_device():
    xs = paddle.to_tensor(np.arange(8.0).reshape(4, 2).astype(np.float32))
    ds = io.TensorDataset([xs, paddle.to_tensor(np.arange(4))])
    (x, y), = list(io.DataLoader(ds, batch_size=4, use_buffer_reader=False))
    assert x._data.device == xs._data.device and y.dtype == torch.int64
    np.testing.assert_array_equal(x.numpy(), xs.numpy())


def test_prefetch_to_device():
    batches = list(io.prefetch_to_device(
        io.DataLoader(RangeDataset(7), batch_size=3), size=2, device="cpu"))
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[2][0].numpy(), [6.0])
    raw = list(io.prefetch_to_device([(np.ones(2, np.float32), "tag")],
                                     device="cpu"))
    assert isinstance(raw[0][0], torch.Tensor) and raw[0][1] == "tag"
    with pytest.raises(TypeError):
        list(io.prefetch_to_device([np.array([object()])], device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            list(io.prefetch_to_device([np.ones(2)]))
