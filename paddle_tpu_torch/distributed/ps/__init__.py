"""Parameter-server stack — host-resident sparse embedding tables.

Port of ``paddle_tpu/distributed/ps/__init__.py`` (reference: the PS
stack at paddle/fluid/distributed/ps/, brpc client/server,
memory_sparse_table.cc with in-table optimizer accessors, and Python
the_one_ps.py; SURVEY §2.7).  Embeddings at 100B-feature scale never
fit in device memory: they live in host RAM in the native C++ sparse
table (native/sparse_table.cc, through ``core.native``, a verbatim copy
of the JAX package's loader), and the device only sees the dense pulled
rows of the current batch; the row gradients are pushed back and the
table applies its own optimizer (SGD/Adagrad) on the host.  Multi-host
sharding keys by ``key % num_shards`` (``service.py``, ``graph.py``:
verbatim copies, ctypes and numpy only).

``DistributedEmbedding``'s pull is a ``torch.autograd.Function``
(:class:`_EmbeddingPull`): the forward pulls the rows from the table to
the layer's device, the backward pushes the row gradients to the table
(as numpy to a host table, as the device tensor to a device-resident
``HotRowCache``) and gives the layer's anchor parameter a zero gradient,
so autograd reaches it.
"""


import ctypes

import numpy as np
import torch

from ...core import native as _native
from ...core.tensor import Tensor, _wrap
from ...nn.layer_base import Layer


def _lib():
    lib = _native.load()
    if lib is None:
        raise RuntimeError("native library unavailable; the PS sparse table "
                           "requires the C++ runtime (g++)")
    if not hasattr(lib.pd_table_create, "_bound"):
        lib.pd_table_create.restype = ctypes.c_void_p
        lib.pd_table_create.argtypes = [ctypes.c_int, ctypes.c_float,
                                        ctypes.c_uint64]
        lib.pd_table_destroy.argtypes = [ctypes.c_void_p]
        lib.pd_table_dim.restype = ctypes.c_int
        lib.pd_table_dim.argtypes = [ctypes.c_void_p]
        lib.pd_table_size.restype = ctypes.c_int64
        lib.pd_table_size.argtypes = [ctypes.c_void_p]
        lib.pd_table_pull.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.pd_table_push_sgd.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float]
        lib.pd_table_push_adagrad.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_float]
        lib.pd_table_save.restype = ctypes.c_int
        lib.pd_table_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_table_load.restype = ctypes.c_int
        lib.pd_table_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.pd_table_mem_rows.restype = ctypes.c_int64
        lib.pd_table_mem_rows.argtypes = [ctypes.c_void_p]
        lib.pd_table_disk_rows.restype = ctypes.c_int64
        lib.pd_table_disk_rows.argtypes = [ctypes.c_void_p]
        lib.pd_table_enable_disk.restype = ctypes.c_int
        lib.pd_table_enable_disk.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.pd_table_set_ctr.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int]
        lib.pd_table_push_delta.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pd_table_push_show_click.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]
        lib.pd_table_get_meta.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.pd_table_shrink.restype = ctypes.c_int64
        lib.pd_table_shrink.argtypes = [ctypes.c_void_p]
        lib.pd_table_geo_init.restype = ctypes.c_int
        lib.pd_table_geo_init.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pd_table_geo_push.restype = ctypes.c_int
        lib.pd_table_geo_push.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pd_table_geo_pull.restype = ctypes.c_int64
        lib.pd_table_geo_pull.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.pd_table_geo_pull_count.restype = ctypes.c_int64
        lib.pd_table_geo_pull_count.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
        lib.pd_table_create._bound = True
    return lib


def _i64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class SparseTable:
    """Host-side embedding table (memory_sparse_table.cc parity).

    >>> t = SparseTable(dim=8, optimizer="adagrad", learning_rate=0.05)
    >>> rows = t.pull(np.array([3, 17, 3]))       # [3, 8]; missing keys init
    >>> t.push(np.array([3, 17]), grads)          # in-table optimizer step
    """

    def __init__(self, dim, optimizer="adagrad", learning_rate=0.05,
                 init_range=0.01, epsilon=1e-8, seed=2023):
        self._lib = _lib()
        self._h = self._lib.pd_table_create(int(dim), float(init_range),
                                            int(seed))
        self.dim = int(dim)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pd_table_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def __len__(self):
        return int(self._lib.pd_table_size(self._h))

    def pull(self, keys):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        out = np.empty((len(keys), self.dim), dtype=np.float32)
        self._lib.pd_table_pull(self._h, _i64p(keys), len(keys), _f32p(out))
        return out

    def push(self, keys, grads, learning_rate=None):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        if isinstance(grads, torch.Tensor):
            grads = grads.detach().cpu().numpy()
        grads = np.ascontiguousarray(np.asarray(grads, dtype=np.float32)
                                     .reshape(len(keys), self.dim))
        lr = self.learning_rate if learning_rate is None else learning_rate
        if self.optimizer == "sgd":
            self._lib.pd_table_push_sgd(self._h, _i64p(keys), _f32p(grads),
                                        len(keys), lr)
        elif self.optimizer == "adagrad":
            self._lib.pd_table_push_adagrad(self._h, _i64p(keys),
                                            _f32p(grads), len(keys), lr,
                                            self.epsilon)
        else:
            raise ValueError(f"unknown table optimizer {self.optimizer!r}")

    def save(self, path):
        rc = self._lib.pd_table_save(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"table save failed rc={rc}")

    def load(self, path):
        rc = self._lib.pd_table_load(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"table load failed rc={rc}")

    # ---- SSD tier / CTR accessor / GeoSGD depth --------------------------
    # (reference ssd_sparse_table.h, ctr_accessor.cc,
    #  memory_sparse_geo_table.h)

    def enable_disk(self, path, max_mem_rows):
        """Bound resident rows; cold rows spill to an append-only log at
        ``path`` and promote back on access (SSD table role)."""
        rc = self._lib.pd_table_enable_disk(self._h, str(path).encode(),
                                            int(max_mem_rows))
        if rc != 0:
            raise IOError(f"enable_disk failed rc={rc}")

    def set_ctr_accessor(self, nonclk_coeff=0.1, click_coeff=1.0,
                         show_click_decay_rate=0.98, delete_threshold=0.8,
                         delete_after_unseen_days=30):
        """Enable CTR feature-value semantics: show/click stats with decay
        and score/age-based eviction on :meth:`shrink` (ctr_accessor.cc
        Shrink/ShowClickScore)."""
        self._lib.pd_table_set_ctr(
            self._h, float(nonclk_coeff), float(click_coeff),
            float(show_click_decay_rate), float(delete_threshold),
            int(delete_after_unseen_days))

    def push_show_click(self, keys, shows, clicks):
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        shows = np.ascontiguousarray(np.asarray(shows, np.float32)
                                     .reshape(len(keys)))
        clicks = np.ascontiguousarray(np.asarray(clicks, np.float32)
                                      .reshape(len(keys)))
        self._lib.pd_table_push_show_click(
            self._h, _i64p(keys), _f32p(shows), _f32p(clicks), len(keys))

    def push_delta(self, keys, deltas):
        """GeoSGD apply: w += delta (no learning rate — trainers already
        applied their local optimizer)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        deltas = np.ascontiguousarray(
            np.asarray(deltas, np.float32).reshape(len(keys), self.dim))
        self._lib.pd_table_push_delta(self._h, _i64p(keys), _f32p(deltas),
                                      len(keys))

    def geo_init(self, trainer_num):
        """Enable per-trainer delta queues (reference geo_recorder.h)."""
        rc = self._lib.pd_table_geo_init(self._h, int(trainer_num))
        if rc != 0:
            raise ValueError(f"geo_init failed rc={rc}")

    def geo_push(self, trainer_id, keys, deltas):
        """Apply deltas AND record the keys into every other trainer's
        dirty queue (memory_sparse_geo_table PushSparse)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        deltas = np.ascontiguousarray(
            np.asarray(deltas, np.float32).reshape(len(keys), self.dim))
        rc = self._lib.pd_table_geo_push(self._h, int(trainer_id),
                                         _i64p(keys), _f32p(deltas),
                                         len(keys))
        if rc != 0:
            raise ValueError(
                f"geo_push: trainer_id {trainer_id} out of range "
                "(geo_init first?)")

    def geo_pull(self, trainer_id, max_n=1 << 20):
        """Drain this trainer's dirty queue: (keys, current rows) for
        CHANGED keys only (memory_sparse_geo_table PullGeoParam)."""
        n = int(self._lib.pd_table_geo_pull_count(self._h,
                                                  int(trainer_id)))
        if n < 0:
            raise ValueError("geo mode not initialized for this trainer")
        n = min(n, int(max_n))
        keys = np.empty((max(n, 1),), np.int64)
        vals = np.empty((max(n, 1), self.dim), np.float32)
        got = int(self._lib.pd_table_geo_pull(
            self._h, int(trainer_id), _i64p(keys), _f32p(vals), n))
        if got < 0:
            raise ValueError("geo_pull failed")
        return keys[:got], vals[:got]

    def get_meta(self, keys):
        """(show, click, unseen_days) per key; -1 rows for absent keys."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                    dtype=np.int64)
        out = np.empty((len(keys), 3), np.float32)
        self._lib.pd_table_get_meta(self._h, _i64p(keys), len(keys),
                                    _f32p(out))
        return out

    def shrink(self):
        """One decay+evict cycle; returns evicted row count."""
        return int(self._lib.pd_table_shrink(self._h))

    def mem_rows(self):
        return int(self._lib.pd_table_mem_rows(self._h))

    def disk_rows(self):
        return int(self._lib.pd_table_disk_rows(self._h))


def _ids_host(ids):
    if isinstance(ids, Tensor):
        ids = ids._data
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids)


class _EmbeddingPull(torch.autograd.Function):
    """Rows of ``table`` at ``ids`` on ``anchor``'s device; the backward
    pushes their gradients into the table (module docstring)."""

    @staticmethod
    def forward(ctx, anchor, ids_np, table):
        rows = table.pull(ids_np)
        ctx.table = table
        ctx.ids = ids_np.reshape(-1)
        out = torch.as_tensor(rows).to(anchor.device, torch.float32)
        return out.reshape(ids_np.shape + (table.dim,))

    @staticmethod
    def backward(ctx, g):
        dev = g.device
        g = g.reshape(len(ctx.ids), ctx.table.dim)
        if not getattr(ctx.table, "on_device", False):
            g = g.detach().float().cpu().numpy()
        ctx.table.push(ctx.ids, g)
        return torch.zeros((1,), device=dev), None, None


class DistributedEmbedding(Layer):
    """Embedding lookup backed by the host PS table.

    Forward pulls rows for the batch's ids; backward pushes the row
    gradients, where the table's own optimizer updates them (the device
    optimizer never sees these parameters — reference PS semantics).
    """

    def __init__(self, dim, optimizer="adagrad", learning_rate=0.05,
                 init_range=0.01, table=None, name=None):
        super().__init__()
        self.table = table if table is not None else SparseTable(
            dim, optimizer=optimizer, learning_rate=learning_rate,
            init_range=init_range)
        self.dim = self.table.dim
        # trainable anchor: routes autograd through the pull
        from ...nn.initializer import Constant
        self._anchor = self.create_parameter(
            (1,), default_initializer=Constant(0.0))

    def forward(self, ids):
        return _wrap(_EmbeddingPull.apply(self._anchor._data,
                                          _ids_host(ids), self.table))


from .service import (  # noqa: E402,F401  (needs SparseTable above)
    DistributedSparseTable,
    GeoSGDWorker,
    PsClient,
    PsServer,
    register_ps_server,
    start_ps_server,
    wait_ps_endpoints,
)
from .graph import (  # noqa: E402,F401
    DistributedGraphTable,
    GraphPsClient,
    GraphPsServer,
    GraphTable,
    start_graph_server,
    wait_graph_endpoints,
)
from .heter import HotRowCache  # noqa: E402,F401
