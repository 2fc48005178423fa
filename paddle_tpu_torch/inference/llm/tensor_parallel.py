"""Tensor-parallel serving: the paged engine Megatron-sharded over ranks.

The counterpart of the JAX engine's mesh and ``shard_map`` code
(``paddle_tpu/inference/llm/engine.py``): ``LLMEngine(model,
tensor_parallel=N)`` or ``LLMEngine(model, mesh=[...])`` serves one model
over N ranks.  qkv and fc_in are column-parallel, proj and fc_out
row-parallel with an explicit all-reduce (two a layer), and the paged
K/V pools are sharded on the head axis: each rank runs its head slice of
the ragged attention kernel against its own pool shard.

Ranks are processes.  The caller's process is rank 0: it owns the
scheduler, the BlockManager, sampling and the whole public API, and it
alone computes the head's logits.  Ranks 1..N-1 are worker processes
(``spawn``: ``fork`` breaks CUDA) that hold their shard of the weights
and their head slice of the pools and run :func:`_worker_main`'s loop
over a command channel.  Every rank runs the same step body
(``engine._StepShard.body``), with :meth:`_Channel.all_reduce` as its
reduction.

Two process groups share one ``TCPStore`` bound to port 0 (so parallel
test processes never collide on a port):

- ``mp_cpu`` (gloo): the command channel, rank 0 -> workers.  A fixed
  int64 header (op, argument, payload length) is broadcast first, then
  the payload: a step's packed int32 operands with its copy-on-write
  pairs appended, an adapter slot's halves, or nothing.
- ``mp`` (the device collectives): NCCL when the mesh names distinct
  CUDA devices; gloo when ranks share a device or run on the CPU, with
  a CUDA tensor staged through the host (gloo's transport).  The
  backend follows from the mesh alone and is never switched after a
  failure.

Both groups have a finite timeout on rank 0, so a rank that is gone
fails rank 0's next collective instead of hanging it; the error
surfaces from ``step()`` as :class:`RankLostError`, a
:class:`~.faults.PoolLostError` (a dead rank's pool shard is gone), and
the group shuts down every worker it still has.  No step is captured in
a CUDA graph at tp > 1: gloo collectives cannot be captured, so every
rank runs its body eagerly.
"""

import datetime
import os
import pickle
import sys
import threading
import time

import numpy as np
import torch

from ...framework.device import resolve_device
from .faults import PoolLostError

# the seconds rank 0 waits on a collective or the command channel
# before it counts the group as lost (a worker waits for its next
# command without a limit, and leaves when rank 0's socket closes)
GROUP_TIMEOUT_S = 60.0
# rank 0's wait on a collective: a pure spin this long, then a poll of the
# work and of the workers' exit codes this often (``_Channel._wait``)
SPIN_S = 1e-3
POLL_S = 1e-4
_WORKER_WAIT = datetime.timedelta(days=7)

# Megatron split of the stacked block leaves ([L, ...]) and of the
# multi-LoRA pools ([L, A, ...]): the dimension each splits on, as the
# JAX engine's _TP_BLOCK_SPECS place its 'mp' axis.  qkv and fc_in
# split their output columns, proj and fc_out their input rows; their
# int8 scales follow the output axis (split for the column-parallel
# weights, whole for the row-parallel ones).  A column target's LoRA B
# splits its output columns, a row target's A its input rows, so the
# row target's delta is a partial that joins the base partial inside
# the all-reduce.  Every other leaf is whole on every rank.
TP_BLOCK_SPLITS = {
    "attn.qkv.weight": 2,
    "attn.qkv.bias": 1,
    "attn.proj.weight": 1,
    "mlp.fc_in.weight": 2,
    "mlp.fc_in.bias": 1,
    "mlp.fc_out.weight": 1,
    "attn.qkv.weight_scale": 2,
    "mlp.fc_in.weight_scale": 2,
    "lora.attn.qkv.weight.B": 3,
    "lora.attn.proj.weight.A": 2,
    "lora.mlp.fc_in.weight.B": 3,
    "lora.mlp.fc_out.weight.A": 2,
}
# the leaves whose columns the head-major permutation reorders: the
# fused qkv weight, its bias and its int8 scale ([L, ..., 3 * NH * D])
_QKV_PERMUTED = ("attn.qkv.weight", "attn.qkv.bias", "attn.qkv.weight_scale")

# command channel ops
OP_SHUTDOWN, OP_STEP, OP_DRAFT, OP_ADAPTER, OP_STATS = range(5)


class RankLostError(PoolLostError):
    """A collective or the command channel failed: a rank is gone (or
    out of step), and with it its pool shard."""


def qkv_head_permutation(num_heads, head_dim, tp):
    """Column permutation taking the fused qkv layout (3, NH, D) to
    (tp, 3, NH/tp, D): a contiguous 1/tp column slice then holds the q, k
    and v projections of one head group, so rank r's plain column shard
    is exactly its heads (the JAX engine's ``_qkv_head_permutation``)."""
    nhl = num_heads // tp
    return np.arange(3 * num_heads * head_dim).reshape(
        3, tp, nhl, head_dim).transpose(1, 0, 2, 3).reshape(-1)


def params_bytes_per_chip(params, tp):
    """Per-rank weight bytes of the global ``{group: {key: tensor}}``
    params under the Megatron layout: a block leaf in
    :data:`TP_BLOCK_SPLITS` holds 1/tp of its bytes on each rank, every
    other leaf (embeddings, head, LayerNorms, row-parallel biases) all of
    them (the JAX engine's ``_params_bytes_per_chip``)."""
    total = 0
    for group, sub in params.items():
        for key, w in sub.items():
            nbytes = w.numel() * w.element_size()
            split = group == "blocks" and key in TP_BLOCK_SPLITS
            total += nbytes // tp if split else nbytes
    return total


def permute_qkv(blocks, perm):
    """The block leaves with the qkv columns (weight, bias, int8 scale)
    in head-major order (a copy of the dict)."""
    out = dict(blocks)
    for key in _QKV_PERMUTED:
        if key in out:
            idx = torch.as_tensor(perm, device=out[key].device)
            out[key] = out[key].index_select(out[key].dim() - 1, idx)
    return out


def _slice(t, dim, rank, tp):
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def shard_params(params, rank, tp, device):
    """Rank ``rank``'s shard of the (qkv-permuted) global params on
    ``device``: each leaf of :data:`TP_BLOCK_SPLITS` sliced on its split
    dimension, every other leaf whole."""
    out = {}
    for group, sub in params.items():
        out[group] = {}
        for key, w in sub.items():
            dim = TP_BLOCK_SPLITS.get(key) if group == "blocks" else None
            w = w if dim is None else _slice(w, dim, rank, tp)
            # a worker's shard is a copy of its own, never a view of the
            # tensors of rank 0
            out[group][key] = w.to(device, copy=rank > 0)
    return out


def adapter_half_shard(key, side, val, rank, tp, perm):
    """Rank ``rank``'s part of one adapter half as registered (host
    numpy, ``A`` [L, in, r] / ``B`` [L, r, out]), as its pool leaf
    splits in :data:`TP_BLOCK_SPLITS` (one dimension lower: the half has
    no slot axis); a qkv B half first goes through the head-major
    permutation its base columns went through."""
    from .lora import lora_key

    if key == "attn.qkv.weight" and side == "B":
        val = val[..., perm]
    dim = TP_BLOCK_SPLITS.get(lora_key(key, side))
    if dim is None:
        return val
    n = val.shape[dim - 1] // tp
    return np.ascontiguousarray(
        np.take(val, np.arange(rank * n, (rank + 1) * n), axis=dim - 1))


def _cuda_index(dev):
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def resolve_mesh(tensor_parallel=None, mesh=None, device=None):
    """The ranks' devices, rank 0's first, from the engine's
    ``tensor_parallel=`` / ``mesh=`` / ``device=``.

    ``mesh=`` is a sequence of N device specs (``["cuda:0", "cuda:0"]``
    puts two ranks on one card, ``["cpu"] * 4`` four on the host), and a
    ``device=`` beside it must be its first entry.  ``tensor_parallel=N``
    without a mesh takes ``cuda:0..N-1`` (raising when N exceeds the
    visible devices) or, with ``device="cpu"``, N ranks on the host.
    Neither: the one device ``device=`` resolves to."""
    tp = None
    if tensor_parallel is not None:
        if isinstance(tensor_parallel, bool) or not isinstance(
                tensor_parallel, (int, np.integer)) or tensor_parallel < 1:
            raise ValueError(f"tensor_parallel must be a positive int, "
                             f"got {tensor_parallel!r}")
        tp = int(tensor_parallel)
    if mesh is not None:
        if isinstance(mesh, (str, torch.device)) or not hasattr(
                mesh, "__len__") or len(mesh) == 0:
            raise ValueError(
                f"mesh= is a non-empty sequence of device specs, one a "
                f"rank (e.g. ['cuda:0', 'cuda:0']), got {mesh!r}")
        devs = [torch.device(d) for d in mesh]
        devs = [_cuda_index(d) if d.type == "cuda" else d for d in devs]
        if tp is not None and tp != len(devs):
            raise ValueError(f"tensor_parallel={tp} disagrees with the "
                             f"mesh's {len(devs)} devices")
        if device is not None:
            want = torch.device(device)
            want = _cuda_index(want) if want.type == "cuda" else want
            if want != devs[0]:
                raise ValueError(
                    f"device={str(want)!r} is not the mesh's first entry "
                    f"{str(devs[0])!r} (rank 0's device)")
    elif tp is not None and tp > 1:
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index not in (None, 0):
                raise ValueError(
                    f"tensor_parallel={tp} takes cuda:0..{tp - 1}; give "
                    f"mesh= to place the ranks on other devices")
            k = torch.cuda.device_count()
            if tp > k:
                raise ValueError(f"tensor_parallel={tp} exceeds the {k} "
                                 f"visible devices")
            devs = [torch.device("cuda", i) for i in range(tp)]
        else:
            devs = [dev] * tp
    else:
        return [resolve_device(device)]
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh is all CUDA devices or all CPU, got "
                         f"{[str(d) for d in devs]}")
    for d in set(devs):
        resolve_device(d)
    return devs


def mp_backend(devices):
    """The ``mp`` group's backend: NCCL when every rank has a CUDA device
    of its own, gloo otherwise (ranks sharing a card, or on the CPU)."""
    if devices[0].type == "cuda" and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _group(backend, store, name, rank, size, timeout):
    from torch import distributed as dist

    prefixed = dist.PrefixStore(name, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(prefixed, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return dist.ProcessGroupGloo(prefixed, rank, size, opts)


class _Channel:
    """One rank's end of the two groups: the command broadcasts on
    ``mp_cpu`` and the step body's all-reduce on ``mp``.  Every failure of
    either raises :class:`RankLostError` (after ``on_lost``, which the
    rank 0 sets to shut its workers down).  The rank's time in each is
    kept: ``bcast_s`` (commands) and ``allreduce_s`` (the all-reduces),
    the latter split into ``exchange_s`` (the collective itself, the
    wait for the other ranks included) and, through the host, the
    copies out and back (the wait for the local partial included).

    Rank 0 also watches its workers while it waits (``watch``, set by
    :class:`TPGroup`): a worker that has exited fails the wait at once.
    A dead peer's socket does not always fail a gloo wait — the kernel
    may have buffered the send, or the peer's descriptors may outlive
    it — and the wait would then last the group's timeout."""

    def __init__(self, store, rank, tp, backend, device, timeout):
        self.rank, self.tp, self.backend = rank, tp, backend
        self.device = device
        self.ctrl = _group("gloo", store, "mp_cpu", rank, tp, timeout)
        self.mp = _group(backend, store, "mp", rank, tp, timeout)
        # gloo on a CUDA device: the partial goes through the host
        self.stage = backend == "gloo" and device.type == "cuda"
        self.on_lost = None
        self.watch = None
        self.bcast_s = self.allreduce_s = self.exchange_s = 0.0
        self.bcasts = self.allreduces = 0

    def _lost(self, what, exc):
        if self.on_lost is not None:
            self.on_lost()
        raise RankLostError(
            f"tensor-parallel {what} failed on rank {self.rank} of "
            f"{self.tp}: a rank is gone and its pool shard with it: "
            f"{exc}") from exc

    def _wait(self, work):
        """``work.wait()``; with a ``watch``, spin for the first
        ``SPIN_S``, then poll the work and the workers every
        ``POLL_S`` (a worker that exited raises)."""
        if self.watch is not None:
            spin_until = time.perf_counter() + SPIN_S
            while not work.is_completed():
                if time.perf_counter() < spin_until:
                    continue
                dead = self.watch()
                if dead is not None:
                    raise RuntimeError(f"{dead} exited while rank "
                                       f"{self.rank} waited on it")
                time.sleep(POLL_S)
        work.wait()

    def bcast(self, t, root=0):
        from torch import distributed as dist

        t0 = time.perf_counter()
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        try:
            self._wait(self.ctrl.broadcast([t], opts))
        except Exception as e:   # noqa: BLE001 — any channel failure
            self._lost("command channel", e)
        self.bcast_s += time.perf_counter() - t0
        self.bcasts += 1
        return t

    def all_reduce(self, y):
        """Sum ``y`` over the ranks (the step body's row-parallel
        reduction) -> the sum, on ``y``'s device."""
        t0 = time.perf_counter()
        try:
            if self.stage:
                host = y.cpu()  # noqa: H001 (gloo reduces host tensors: a CUDA partial is staged through the host by design)
                t1 = time.perf_counter()
                self._wait(self.mp.allreduce([host]))
                t2 = time.perf_counter()
                y = host.to(y.device)
            else:
                t1 = time.perf_counter()
                self._wait(self.mp.allreduce([y]))
                t2 = time.perf_counter()
        except Exception as e:   # noqa: BLE001 — any collective failure
            self._lost("all-reduce", e)
        self.exchange_s += t2 - t1
        self.allreduce_s += time.perf_counter() - t0
        self.allreduces += 1
        return y

    def header(self, op=0, arg=0, n=0, m=0):
        return self.bcast(torch.tensor([op, arg, n, m], dtype=torch.int64))

    def sum_ctrl(self, t):
        """Sum a small CPU tensor over the ranks on ``mp_cpu`` (the stats
        op's lengths), outside the step's timers."""
        try:
            self._wait(self.ctrl.allreduce([t]))
        except Exception as e:   # noqa: BLE001 — any channel failure
            self._lost("command channel", e)
        return t


def _forbidden_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "paddle_tpu")
                  or m.startswith(("jax.", "paddle_tpu.")))


def rank_stats(shard, channel, detail):
    """One rank's report for the stats op: its kernel launch counts,
    device bytes, pool shapes, weight bytes, channel timers, any JAX
    module it imported and, with ``detail``, the float64 sum of each
    block leaf (what its shard holds)."""
    from ...framework.cost import params_bytes
    from ...ops.cuda import registry

    dev = shard.device
    pools = shard.pools
    out = {"rank": channel.rank if channel is not None else 0,
           "device": str(dev),
           "launches": registry.counts(),
           "device_bytes": (torch.cuda.memory_allocated(dev)
                            if dev.type == "cuda" else 0),
           "pool_shape": list(pools.k_rows.shape),
           "scale_pool_shape": (None if pools.ks_flat is None
                                else list(pools.ks_flat.shape)),
           "draft_pool_shape": (None if shard.draft_pools is None
                                else list(shard.draft_pools.k_rows.shape)),
           "params_bytes": params_bytes(shard.params),
           "pool_bytes": sum(t.numel() * t.element_size()
                             for pools in (shard.pools, shard.draft_pools)
                             if pools is not None
                             for t in (pools.k_rows, pools.v_rows,
                                       pools.ks_flat, pools.vs_flat)
                             if t is not None),
           "foreign_modules": _forbidden_modules(),
           "pid": os.getpid()}
    if channel is not None:
        out.update(bcast_s=channel.bcast_s, allreduce_s=channel.allreduce_s,
                   exchange_s=channel.exchange_s, bcasts=channel.bcasts,
                   allreduces=channel.allreduces)
    if detail:
        out["leaf_sums"] = {
            f"{g}/{k}": float(v.double().sum())
            for g, sub in shard.params.items() for k, v in sub.items()}
    return out


class TPGroup:
    """Rank 0's side of a tensor-parallel engine: the
    store, the two groups, the worker processes and the command channel.

    ``spec`` holds what a worker needs to build its step shard (the
    engine's dims and options, see ``LLMEngine._shard_spec``); ``shards``
    ranks 1..N-1's params as CPU tensors, which ``torch.multiprocessing``
    hands to the workers through shared memory.  Construction returns
    once every rank has joined both groups."""

    def __init__(self, devices, spec, shards):
        from torch import distributed as dist
        from torch import multiprocessing as tmp

        self.devices = list(devices)
        self.tp = len(self.devices)
        self.backend = mp_backend(self.devices)
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        self._store = dist.TCPStore("127.0.0.1", 0, self.tp, True, timeout,
                                    wait_for_workers=False)
        ctx = tmp.get_context("spawn")
        self.processes = []
        self.closed = False
        try:
            for rank in range(1, self.tp):
                p = ctx.Process(
                    target=_worker_main, daemon=True,
                    name=f"tp-rank-{rank}",
                    args=(rank, [str(d) for d in self.devices],
                          self._store.port, spec, shards[rank - 1],
                          torch.get_num_threads(),
                          torch.get_float32_matmul_precision(),
                          torch.backends.cuda.matmul.allow_tf32))
                p.start()
                self.processes.append(p)
            self.channel = self._connect(timeout)
        except BaseException:
            self.close(kill=True)
            raise
        self.channel.on_lost = lambda: self.close(kill=True)
        self.channel.watch = self._dead_worker

    def _connect(self, timeout):
        """Join rank 0 to both groups while watching the workers: one that
        exits first (an error at its start) fails the construction at
        once instead of after the store's timeout."""
        out = {}

        def connect():
            try:
                out["channel"] = _Channel(self._store, 0, self.tp,
                                          self.backend, self.devices[0],
                                          timeout)
            except BaseException as e:   # noqa: BLE001 — re-raised below
                out["error"] = e

        t = threading.Thread(target=connect, daemon=True,
                             name="tp-connect")
        t.start()
        while t.is_alive():
            t.join(0.05)
            dead = [p for p in self.processes if p.exitcode is not None]
            if dead and t.is_alive():
                raise RuntimeError(
                    f"tensor-parallel worker {dead[0].name} exited with "
                    f"code {dead[0].exitcode} before joining its groups "
                    f"(its error is on stderr); a script that builds a "
                    f"tensor-parallel engine runs it under "
                    f"`if __name__ == '__main__':`, as every program "
                    f"that starts processes by spawn must")
        if "error" in out:
            raise out["error"]
        return out["channel"]

    def _dead_worker(self):
        """The first worker that has exited, described, or None."""
        for p in self.processes:
            if p.exitcode is not None:
                return f"worker {p.name} (exit code {p.exitcode})"
        return None

    def step(self, op, tb, ints, cows=()):
        """Send one step (``OP_STEP``) or draft step (``OP_DRAFT``): the
        packed int32 operands of bucket ``tb`` with the copy-on-write
        pairs appended."""
        payload = ints
        if len(cows):
            payload = np.concatenate(
                [ints, np.asarray(cows, np.int32).reshape(-1)])
        self.channel.header(op, tb, len(payload), len(cows))
        self.channel.bcast(torch.from_numpy(payload))

    def load_adapter(self, slot, weights, targets):
        """Send one adapter's halves (every target, A then B, float32 as
        registered) for pool slot ``slot``; each worker writes its
        part."""
        self.channel.header(OP_ADAPTER, slot)
        for key in targets:
            for half in weights[key]:
                self.channel.bcast(torch.from_numpy(
                    np.ascontiguousarray(half, np.float32)))

    def stats(self, local, detail=False):
        """Every rank's :func:`rank_stats`, rank 0's (``local``) first."""
        ch = self.channel
        ch.header(OP_STATS, int(detail))
        lengths = ch.sum_ctrl(torch.zeros(self.tp, dtype=torch.int64))
        out = [local]
        for rank in range(1, self.tp):
            buf = ch.bcast(torch.empty(int(lengths[rank]),
                                       dtype=torch.uint8), root=rank)
            out.append(pickle.loads(buf.numpy().tobytes()))
        return out

    def close(self, kill=False):
        """Shut the workers down: a shutdown command while every worker
        lives and the channel works, then join; otherwise (``kill``, the
        channel's failure path) every worker still alive is killed at
        once, since it may wait on a collective that never completes.
        Idempotent."""
        if self.closed:
            return
        self.closed = True
        channel = getattr(self, "channel", None)
        if not kill and channel is not None and all(
                p.is_alive() for p in self.processes):
            channel.on_lost = None
            try:
                channel.header(OP_SHUTDOWN)
            except RankLostError:
                kill = True
        for p in self.processes:
            if not kill:
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)


def _watch_parent(ppid):
    """A worker ends itself once rank 0's process is gone."""
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(1)


def _worker_main(rank, devices, port, spec, shard, threads, precision,
                 tf32):
    """Rank ``rank``'s process: join the groups, build the step shard
    (the params on the device, pools of ``nh / tp`` heads), then serve
    commands until shutdown.  It takes rank 0's intra-op threads and
    f32 matmul settings, so every rank computes as rank 0 does."""
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    spec = {**spec, "rank": rank}
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    from torch import distributed as dist

    from .engine import _StepShard, alloc_pools

    devs = [torch.device(d) for d in devices]
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore("127.0.0.1", port, len(devs), False,
                          datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    ch = _Channel(store, rank, len(devs), mp_backend(devs), dev,
                  _WORKER_WAIT)
    params = {g: {k: v.to(dev) for k, v in sub.items()}
              for g, sub in shard.items()}
    del shard

    def pools(num_layers):
        return alloc_pools(num_layers, spec["num_blocks"],
                           spec["block_size"], spec["num_heads"],
                           spec["head_dim"], spec["kv_dtype"],
                           spec["kv_quant"], dev)

    st = _StepShard(params, pools(spec["num_layers"]), spec, dev,
                    psum=ch.all_reduce, head=False)
    if spec["draft_layers"]:
        st.set_draft(spec["draft_layers"], pools(spec["draft_layers"]))
    with torch.no_grad():
        while True:
            op, arg, n, m = (int(v) for v in ch.header())
            if op == OP_SHUTDOWN:
                break
            if op in (OP_STEP, OP_DRAFT):
                payload = ch.bcast(torch.empty(n, dtype=torch.int32))
                ints = payload[:n - 2 * m].to(dev)
                if m:
                    st.copy_on_write(payload[n - 2 * m:].view(m, 2).numpy())  # noqa: H001 (the command payload is a host tensor)
                if op == OP_STEP:
                    st.body(ints)
                else:
                    st.draft_body(ints)
            elif op == OP_ADAPTER:
                weights = {}
                for key in spec["lora"].targets:
                    layers, d_in, d_out = spec["lora_shapes"][key]
                    r = spec["lora"].rank
                    weights[key] = tuple(
                        ch.bcast(torch.empty(shape)).numpy()  # noqa: H001 (the command payload is a host tensor)
                        for shape in ((layers, d_in, r), (layers, r, d_out)))
                st.write_adapter_slot(arg, weights)
            elif op == OP_STATS:
                blob = pickle.dumps(rank_stats(st, ch, bool(arg)))  # noqa: H001 (the op argument is a host int)
                lengths = torch.zeros(len(devs), dtype=torch.int64)
                lengths[rank] = len(blob)
                ch.sum_ctrl(lengths)
                for src in range(1, len(devs)):
                    if src == rank:
                        ch.bcast(torch.frombuffer(bytearray(blob),
                                                  dtype=torch.uint8),
                                 root=rank)
                    else:
                        ch.bcast(torch.empty(int(lengths[src]),
                                             dtype=torch.uint8), root=src)
