"""PS training data pipeline — InMemoryDataset / QueueDataset.

Reference: python/paddle/distributed/fleet/dataset/dataset.py
(InMemoryDataset :350 — load_into_memory/local_shuffle/global_shuffle,
MultiSlot text format) over the C++ Dataset/DataFeed engine
(paddle/fluid/framework/data_set.h:50, data_feed.h MultiSlotDataFeed).

Port of ``paddle_tpu/distributed/fleet/dataset.py``: a copy whose
global shuffle reads the rank and world size from the port's
``get_rank()``/``get_world_size()`` where the JAX module asks JAX.

The async C++ feed threads become the multiprocess
DataLoader (io/) which already overlaps parsing with device compute, so
this layer owns what remains: the MultiSlot text format, in-memory
loading, local/global shuffle (global = exchange record ranges through
the TCPStore-backed PS plumbing's rank env), and batch assembly of
(slot_id arrays, dense values, labels) for Wide&Deep/DeepFM-class
models.

MultiSlot line format (reference data_feed semantics)::

    <n> id id ... <m> v v ... ...   per configured slot, space separated

Each slot contributes ``count value...``; sparse (uint64) slots yield
int64 id arrays, dense (float) slots yield float32 arrays.
"""

import os
import random

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


class DatasetBase:
    def __init__(self):
        self._use_vars = []
        self._slot_types = []
        self._batch_size = 1
        self._thread_num = 1
        self._filelist = []
        self._pipe_command = None

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command=None, input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        """Reference DatasetBase.init: batch size, threads, slot vars."""
        self._batch_size = int(batch_size)
        self._thread_num = max(1, int(thread_num))
        self._pipe_command = pipe_command
        if use_var is not None:
            self.set_use_var(use_var)
        return self

    def set_use_var(self, var_list):
        """Configure slots.  Entries may be (name, "sparse"|"dense")
        tuples, plain names (sparse by default), or objects with
        name/dtype attributes (static-graph Variables in the reference)."""
        self._use_vars = []
        self._slot_types = []
        for v in var_list:
            if isinstance(v, tuple):
                name, kind = v
            elif isinstance(v, str):
                name, kind = v, "sparse"
            else:
                name = getattr(v, "name", str(v))
                dtype = str(getattr(v, "dtype", "int64"))
                kind = "dense" if "float" in dtype else "sparse"
            self._use_vars.append(name)
            self._slot_types.append(kind)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    # ------------------------------------------------------------ parsing --
    def _parse_line(self, line):
        """One MultiSlot record -> list of per-slot arrays."""
        if self._pipe_command:
            raise NotImplementedError(
                "pipe_command preprocessing is not supported; preprocess "
                "files beforehand")
        toks = line.split()
        out = []
        i = 0
        for kind in self._slot_types:
            if i >= len(toks):
                raise ValueError(f"truncated MultiSlot line: {line[:80]!r}")
            n = int(toks[i])
            if n < 0:
                raise ValueError(
                    f"negative slot count in MultiSlot line: {line[:80]!r}")
            vals = toks[i + 1:i + 1 + n]
            if len(vals) < n:
                raise ValueError(
                    f"truncated MultiSlot line: {line[:80]!r}")
            i += 1 + n
            if kind == "sparse":
                out.append(np.asarray(vals, np.int64))
            else:
                out.append(np.asarray(vals, np.float32))
        return out

    def _iter_file(self, path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self._parse_line(line)

    def _assemble(self, recs):
        """dict slot_name -> array.  Sparse slots pad to the batch's max
        length with 0 (the reference's variable-length slots surface as
        LoD; TPU needs rectangles)."""
        out = {}
        for si, (name, kind) in enumerate(zip(self._use_vars,
                                              self._slot_types)):
            cols = [r[si] for r in recs]
            if kind == "dense":
                out[name] = np.stack(cols).astype(np.float32)
            else:
                width = max(1, max(len(c) for c in cols))
                arr = np.zeros((len(cols), width), np.int64)
                for j, c in enumerate(cols):
                    arr[j, :len(c)] = c
                out[name] = arr
                # padding uses id 0, which is a LEGAL feature id — ship
                # per-row lengths so models can mask pad positions (the
                # reference's LoD information, rectangularized)
                out[f"{name}_lens"] = np.asarray(
                    [len(c) for c in cols], np.int64)
        return out


class InMemoryDataset(DatasetBase):
    """Load-then-shuffle dataset for PS training (reference :350).

    >>> ds = InMemoryDataset()
    >>> ds.init(batch_size=32, use_var=[("slots", "sparse"),
    ...                                 ("label", "dense")])
    >>> ds.set_filelist(["part-000", "part-001"])
    >>> ds.load_into_memory()
    >>> ds.local_shuffle()
    >>> for batch in ds:  # dict name -> array (sparse slots padded)
    ...     ...
    """

    def __init__(self):
        super().__init__()
        self._records = []
        self._canonical = []
        self._loaded = False

    def load_into_memory(self, is_shuffle=False):
        self._records = []
        for path in self._filelist:
            self._records.extend(self._iter_file(path))
        # canonical load order: global_shuffle partitions from THIS list,
        # so prior local_shuffle calls can't break the cross-rank
        # partition (ranks agree on file order, not on shuffle history)
        self._canonical = list(self._records)
        self._loaded = True
        if is_shuffle:
            self.local_shuffle()

    def local_shuffle(self, seed=None):
        rng = random.Random(seed)
        rng.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=12, seed=0):
        """Deterministic cross-rank reshuffle (reference :1001 exchanges
        records between ranks through the PS service).

        Single-controller TPU redesign: every rank must load the SAME
        full filelist; all ranks shuffle with a shared seed and each
        keeps the records whose global index maps to it — the same
        record-to-rank permutation the reference's exchange produces,
        with no data plane.  (Per-rank file shards would need a real
        exchange; use local_shuffle + your own sharding instead.)
        """
        rank = world = None
        if "PADDLE_TRAINER_ID" in os.environ:
            rank = int(os.environ["PADDLE_TRAINER_ID"])
        if "PADDLE_TRAINERS_NUM" in os.environ:
            world = int(os.environ["PADDLE_TRAINERS_NUM"])
        if rank is None or world is None:
            # the world's rank and size for whichever is missing
            from ..parallel import get_rank, get_world_size

            rank = get_rank() if rank is None else rank
            world = get_world_size() if world is None else world
        # shuffle the CANONICAL load order so every rank computes the
        # same permutation regardless of earlier local_shuffle calls
        records = list(self._canonical)
        rng = random.Random(seed)
        rng.shuffle(records)
        self._records = records[rank::world] if world > 1 else records

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def release_memory(self):
        self._records = []
        self._canonical = []
        self._loaded = False

    # ------------------------------------------------------------ batches --
    def __iter__(self):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        bs = self._batch_size
        for lo in range(0, len(self._records) - bs + 1, bs):
            yield self._assemble(self._records[lo:lo + bs])

    def __len__(self):
        return max(0, len(self._records) // self._batch_size)


class QueueDataset(DatasetBase):
    """Streaming variant (reference QueueDataset :1295): no load phase,
    records stream straight from the filelist — for datasets larger than
    host RAM."""

    def __iter__(self):
        buf = []
        for path in self._filelist:
            for rec in self._iter_file(path):
                buf.append(rec)
                if len(buf) == self._batch_size:
                    yield self._assemble(buf)
                    buf = []
        # reference drops the trailing partial batch in train mode; keep
        # parity by dropping it here too
