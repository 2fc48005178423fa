"""DataLoader (port of ``paddle_tpu/io/dataloader.py``; reference
python/paddle/io/reader.py:218 and the multiprocess iterator at
python/paddle/io/dataloader/dataloader_iter.py).

Three feeding modes:
- ``num_workers=0``: synchronous single-process iteration.
- ``num_workers=0`` with ``use_buffer_reader``: thread prefetch (host
  CPUs collate while the card computes).
- ``num_workers>0``: forked worker PROCESSES pulling index batches from a
  task queue and returning numpy-collated batches over a result queue,
  reordered to preserve determinism — the reference's multiprocess design
  with the queue depth ``prefetch_factor * num_workers``.

A forked worker never touches the card: the parent may hold a live CUDA
context, which a forked child cannot use.  Each worker makes the CPU its
current device before it runs any user code, so a Tensor a dataset or a
user ``collate_fn`` builds there lies on the CPU; default collation in a
worker is numpy only, a user ``collate_fn``'s Tensors travel as numpy,
and the parent builds the device Tensors.  A dataset that holds CUDA
Tensors is for ``num_workers=0``: a worker reading one fails, and the
failure propagates.

Default collation of Tensor samples (a ``TensorDataset`` over device
Tensors) stacks them on their device in one call; the JAX package
collates them one sample at a time through the host.  The values are
the same.
"""

import multiprocessing as mp
import queue
import threading

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from .dataset import IterableDataset
from .sampler import BatchSampler

_worker_info = None


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    """Inside a worker process: (id, num_workers, dataset); else None.
    Reference: python/paddle/io/dataloader/worker.py get_worker_info."""
    return _worker_info


def _is_namedtuple(obj):
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _host_stack(batch):
    return np.stack([s.numpy() for s in batch])


def _device_stack(batch):
    return _wrap(torch.stack([s._data.detach() for s in batch]))


def _collate_numpy(batch, stack=_host_stack):
    """Worker-side collation: numpy only (a forked child never touches
    the card); ``stack`` collates Tensor samples."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if _is_namedtuple(sample):
        return type(sample)(*(_collate_numpy(list(s), stack)
                              for s in zip(*batch)))
    if isinstance(sample, (list, tuple)):
        transposed = zip(*batch)
        return type(sample)(_collate_numpy(list(s), stack)
                            for s in transposed)
    if isinstance(sample, dict):
        return {k: _collate_numpy([d[k] for d in batch], stack)
                for k in sample}
    raise TypeError(f"cannot collate type {type(sample)}")


def _to_tensors(obj):
    if isinstance(obj, np.ndarray):
        return Tensor(obj)
    if _is_namedtuple(obj):
        return type(obj)(*(_to_tensors(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    return _to_tensors(_collate_numpy(batch, _device_stack))


class _PackedTensor:
    """Transport marker: a Tensor produced by a user collate_fn inside a
    worker, detensorized to numpy for the queue and re-wrapped in the
    parent — so batch types do not depend on num_workers."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array


def _pack_for_transport(obj):
    if isinstance(obj, Tensor):
        return _PackedTensor(obj.numpy())
    if _is_namedtuple(obj):
        return type(obj)(*(_pack_for_transport(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack_for_transport(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _pack_for_transport(v) for k, v in obj.items()}
    return obj


def _unpack_from_transport(obj):
    if isinstance(obj, _PackedTensor):
        return Tensor(obj.array)
    if _is_namedtuple(obj):
        return type(obj)(*(_unpack_from_transport(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack_from_transport(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _unpack_from_transport(v) for k, v in obj.items()}
    return obj


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, multiprocessing_context=None):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = int(num_workers or 0)
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.use_buffer_reader = use_buffer_reader
        # "fork" keeps locally-defined datasets working (reference/Linux
        # default); a forked worker never touches the card (module
        # docstring).  "spawn"/"forkserver" need a picklable dataset.
        self.multiprocessing_context = multiprocessing_context
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
            if self.num_workers > 0:
                # reference behavior: every worker sees the whole
                # IterableDataset unless it shards via get_worker_info()
                pass
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _mp_context(self):
        ctx = self.multiprocessing_context
        if ctx is None or isinstance(ctx, str):
            return mp.get_context(ctx or "fork")
        return ctx

    # ---------------------------------------------------- single process --
    def _iter_batches(self):
        collate = self.collate_fn or default_collate_fn
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
        else:
            for indices in self.batch_sampler:
                batch = [self.dataset[i] for i in indices]
                yield collate(batch)

    def __iter__(self):
        if self.num_workers > 0 and not self._iterable_mode:
            return _MultiprocessIterator(self)
        if self.num_workers > 0 and self._iterable_mode:
            return _MultiprocessIterableIterator(self)
        if self.use_buffer_reader:
            return _PrefetchIterator(self._iter_batches(),
                                     max(2, self.prefetch_factor))
        return self._iter_batches()


class _PrefetchIterator:
    """Thread prefetch: overlaps host-side batch assembly with device work."""

    _SENTINEL = object()

    def __init__(self, source, depth):
        self._queue = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in source:
                    self._queue.put(item)
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def _liveness_get(result_q, workers, timeout, shutdown, expect_exit=False):
    """Pull one result, honoring the user timeout if set (timeout>0), else
    waiting indefinitely while the workers are alive (timeout=0 is the
    reference's documented "no timeout").  Raises on dead workers or
    user-timeout expiry.

    ``expect_exit=True`` (iterable path): workers exit normally after their
    final message, so death is fatal only when ALL are gone and the queue
    has drained.  ``expect_exit=False`` (map path): workers live until
    shutdown, so ANY death means an in-flight task may be lost and the
    ordered reorder buffer would stall forever — raise after a short grace
    (the dead worker's last result may still be in the feeder pipe)."""
    import time as _time

    deadline = (_time.monotonic() + timeout) if timeout else None
    death_grace = 2  # extra 5s polls after a partial death before raising
    while True:
        step = 5.0
        if deadline is not None:
            step = min(step, max(0.0, deadline - _time.monotonic()))
        try:
            return result_q.get(timeout=max(0.05, step))
        except queue.Empty:
            dead = [i for i, w in enumerate(workers) if not w.is_alive()]
            if deadline is not None and _time.monotonic() >= deadline:
                shutdown()
                raise RuntimeError(
                    f"DataLoader worker timeout after {timeout}s"
                    + (f"; dead workers: {dead}" if dead else ""))
            if not dead:
                continue
            if expect_exit and len(dead) < len(workers):
                continue
            if death_grace > 0:
                death_grace -= 1
                continue
            shutdown()
            raise RuntimeError(
                f"DataLoader workers died unexpectedly: {dead}")


def _enter_worker(wid, n_workers, dataset):
    """A worker's first act: the CPU becomes its current device, so no
    Tensor built in it asks for the card."""
    global _worker_info
    from ..framework.device import set_device
    set_device("cpu")
    _worker_info = WorkerInfo(wid, n_workers, dataset)


def _map_worker_loop(dataset, collate_fn, task_q, result_q, wid, n_workers,
                     init_fn):
    _enter_worker(wid, n_workers, dataset)
    if init_fn is not None:
        init_fn(wid)
    user_collate = collate_fn is not None
    collate = collate_fn or _collate_numpy
    while True:
        task = task_q.get()
        if task is None:
            return
        seq, indices = task
        try:
            batch = collate([dataset[i] for i in indices])
            if user_collate:
                batch = _pack_for_transport(batch)
            result_q.put((seq, batch, None))
        except BaseException as e:
            result_q.put((seq, None, repr(e)))


def _iterable_worker_loop(dataset, collate_fn, batch_size, drop_last,
                          result_q, wid, n_workers, init_fn):
    _enter_worker(wid, n_workers, dataset)
    if init_fn is not None:
        init_fn(wid)
    user_collate = collate_fn is not None
    collate = collate_fn or _collate_numpy

    def _ship(b):
        b = collate(b)
        if user_collate:
            b = _pack_for_transport(b)
        result_q.put(("data", b, None))

    try:
        batch = []
        for sample in dataset:
            batch.append(sample)
            if len(batch) == batch_size:
                _ship(batch)
                batch = []
        if batch and not drop_last:
            _ship(batch)
        result_q.put(("done", None, None))
    except BaseException as e:
        result_q.put(("error", None, repr(e)))


class _MultiprocessIterator:
    """Ordered multiprocess map-dataset iterator.

    Index batches go to a shared task queue; results come back tagged with
    their sequence number and are reordered so output order matches the
    sampler regardless of worker timing (reference _DataLoaderIterMultiProcess
    reordering via _rcvd_idx)."""

    def __init__(self, loader):
        self._loader = loader
        ctx = loader._mp_context()
        n = loader.num_workers
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._indices = list(loader.batch_sampler)
        self._n_batches = len(self._indices)
        self._next_submit = 0
        self._next_yield = 0
        self._buffer = {}
        self._timeout = loader.timeout or None  # 0 = no timeout (reference)
        self._workers = [
            ctx.Process(
                target=_map_worker_loop,
                args=(loader.dataset, loader.collate_fn, self._task_q,
                      self._result_q, i, n, loader.worker_init_fn),
                daemon=True)
            for i in range(n)
        ]
        for w in self._workers:
            w.start()
        # keep prefetch_factor batches in flight per worker
        for _ in range(min(self._n_batches,
                           loader.prefetch_factor * n)):
            self._submit()

    def _submit(self):
        if self._next_submit < self._n_batches:
            self._task_q.put((self._next_submit,
                              self._indices[self._next_submit]))
            self._next_submit += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_yield >= self._n_batches:
            self._shutdown()
            raise StopIteration
        while self._next_yield not in self._buffer:
            seq, batch, err = _liveness_get(
                self._result_q, self._workers, self._timeout, self._shutdown)
            if err is not None:
                self._shutdown()
                raise RuntimeError(f"DataLoader worker failed: {err}")
            self._buffer[seq] = batch
        batch = self._buffer.pop(self._next_yield)
        self._next_yield += 1
        self._submit()
        if self._loader.collate_fn is not None:
            return _unpack_from_transport(batch)
        return _to_tensors(batch)

    def _shutdown(self):
        for _ in self._workers:
            try:
                self._task_q.put_nowait(None)
            except Exception:
                pass
        for w in self._workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
        self._workers = []

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


class _MultiprocessIterableIterator:
    """IterableDataset over workers: each worker iterates the dataset
    (sharding is the dataset's job via get_worker_info, as in the
    reference); first-come delivery."""

    def __init__(self, loader):
        self._loader = loader
        ctx = loader._mp_context()
        n = loader.num_workers
        self._result_q = ctx.Queue(maxsize=max(2, loader.prefetch_factor * n))
        self._timeout = loader.timeout or None  # 0 = no timeout (reference)
        self._done = 0
        self._n = n
        self._workers = [
            ctx.Process(
                target=_iterable_worker_loop,
                args=(loader.dataset, loader.collate_fn, loader.batch_size,
                      loader.drop_last, self._result_q, i, n,
                      loader.worker_init_fn),
                daemon=True)
            for i in range(n)
        ]
        for w in self._workers:
            w.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._done >= self._n:
                self._shutdown()
                raise StopIteration
            kind, batch, err = _liveness_get(
                self._result_q, self._workers, self._timeout, self._shutdown,
                expect_exit=True)
            if kind == "error":
                self._shutdown()
                raise RuntimeError(f"DataLoader worker failed: {err}")
            if kind == "done":
                self._done += 1
                continue
            if self._loader.collate_fn is not None:
                return _unpack_from_transport(batch)
            return _to_tensors(batch)

    def _shutdown(self):
        for w in self._workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
        self._workers = []

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
