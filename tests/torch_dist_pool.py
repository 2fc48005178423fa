"""A pool of rank processes for the port's multi-rank CPU tests.

``RankPool(world)`` spawns ``world`` processes once (a test module holds
one for all its checks): each sets the launcher's variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``),
forms the default group with ``init_parallel_env(device="cpu",
timeout=30)`` (gloo) and then runs the tasks it is sent: ``pool.run(fn,
*args)`` runs ``fn(*args)`` on every rank and returns the results in
rank order, or raises with every failing rank's traceback.  ``fn`` is a
module-level function of an importable module that imports no JAX (the
tasks below), so a rank starts with torch and the port only.
"""

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np


def _free_port_pair():
    """A port p with p + 1 free too (the launcher's store owns the master
    port and the process group meets at port + 1)."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise RuntimeError("no free pair of ports")


def _worker(rank, world, port, tasks, results):
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_LOCAL_RANK=str(rank),
                      PADDLE_MASTER=f"127.0.0.1:{port}")
    import importlib

    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist

    paddle.set_device("cpu")
    try:
        dist.init_parallel_env(device="cpu", timeout=30)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "up"))
    while True:
        item = tasks.get()
        if item is None:
            break
        mod, name, args = item
        try:
            fn = getattr(importlib.import_module(mod), name)
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world=2, timeout=60):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        port = _free_port_pair()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world, port, self._tasks[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self):
        got, failed = {}, []
        deadline = time.monotonic() + self.timeout
        while len(got) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=0.5)
            except queue.Empty:
                waiting = sorted(set(range(self.world)) - set(got))
                dead = [r for r in waiting
                        if self._procs[r].exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks {waiting} did not answer (exited: {dead})")
                continue
            got[rank] = value
            if not ok:
                failed.append(f"rank {rank}:\n{value}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return [got[r] for r in range(self.world)]

    def run(self, fn, *args):
        for q in self._tasks:
            q.put((fn.__module__, fn.__name__, args))
        return self._collect()

    def close(self):
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)


# ------------------------------------------------------------- the tasks --
# Each runs on every rank of the pool and returns picklable results.

def _rank():
    from paddle_tpu_torch import distributed as dist
    return dist.get_rank(), dist.get_world_size()


def shard8(rank, world):
    """This rank's block of arange(8) (the reference's 8-element array)."""
    k = 8 // world
    return np.arange(8, dtype=np.float32)[rank * k:(rank + 1) * k]


def collective_task(name):
    """One collective of ``communication.py`` on this rank's block of
    arange(8) (a Tensor, and a raw torch tensor where the op takes one);
    returns the values as numpy."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist

    rank, world = _rank()
    x = shard8(rank, world)
    T = paddle.to_tensor
    if name.startswith("all_reduce_"):
        op = name[len("all_reduce_"):]
        t = T(x + 1.0)
        out = dist.all_reduce(t, op=op)
        raw = torch.from_numpy(x + 1.0)
        dist.all_reduce(raw, op=op)
        return {"tensor": out.numpy(), "raw": raw.numpy(), "same": out is t}
    if name == "psum_scalar":
        return dist.all_reduce(T(np.float32(x.sum()))).numpy()
    if name == "all_gather":
        parts = []
        out = dist.all_gather(parts, T(x))
        return {"concat": out.numpy(), "parts": [p.numpy() for p in parts]}
    if name == "all_gather_object":
        objs = []
        dist.all_gather_object(objs, {"rank": rank})
        return objs
    if name == "reduce_scatter":
        out = dist.reduce_scatter(None, T(np.ones(8, np.float32)))
        t = T(np.zeros(8 // world, np.float32))
        dist.reduce_scatter(t, [T(np.ones(4, np.float32)) for _ in
                                range(2)])
        return {"tensor": out.numpy(), "list": t.numpy()}
    if name == "broadcast":
        return dist.broadcast(T(x), src=1).numpy()
    if name == "reduce":
        return dist.reduce(T(x), dst=0).numpy()
    if name == "scatter":
        t = T(np.zeros(2, np.float32))
        parts = [T(np.full(2, 10.0 * i, np.float32)) for i in range(world)]
        return dist.scatter(t, parts if rank == 0 else None, src=0).numpy()
    if name == "alltoall":
        outs = []
        dist.alltoall([T(np.full(2, 10 * rank + i, np.float32))
                       for i in range(world)], outs)
        single = dist.alltoall(T(np.repeat(x, 1)))
        return {"list": [o.numpy() for o in outs],
                "single": single.numpy()}
    if name == "send_recv":
        if rank == 0:
            dist.send(T(x), dst=1)
            return None
        t = T(np.zeros_like(x))
        dist.recv(t, src=0)
        return t.numpy()
    if name == "p2p_permute":
        perm = [(i, (i + 1) % world) for i in range(world)]
        return dist.p2p_permute(T(x), perm).numpy()
    if name == "barrier_wait":
        dist.barrier()
        dist.wait(T(x))
        return True
    if name == "new_group":
        g = dist.new_group([1])
        out = dist.all_reduce(T(x), group=g)
        return {"rank": g.rank, "nranks": g.nranks, "value": out.numpy(),
                "group_rank": g.get_group_rank(1)}
    raise ValueError(name)


def _linear_model(seed):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    paddle.seed(seed)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(6, 8)
            self.fc2 = nn.Linear(8, 3)
            self.fc3 = nn.Linear(8, 3)

        def forward(self, x, use_fc2=True):
            h = nn.functional.relu(self.fc1(x))
            return self.fc2(h) if use_fc2 else h[:, :3]

    return Net()


def no_sync_task():
    """Two backwards, the first under ``no_sync``: the first leaves each
    rank's own gradient, the second averages the accumulated ones."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist

    rank, _ = _rank()
    dp = dist.DataParallel(_linear_model(0), find_unused_parameters=True)
    rs = np.random.RandomState(10 + rank)
    x1, x2 = (paddle.to_tensor(rs.randn(4, 6).astype(np.float32))
              for _ in range(2))
    with dp.no_sync():
        dp(x1).sum().backward()
    local = dp._layers.fc1.weight.grad.numpy().copy()
    dp(x2).sum().backward()
    return {"local": local, "synced": dp._layers.fc1.weight.grad.numpy()}


def unused_task(find):
    """Rank 1 skips fc2, fc3 is unused on both: with ``find`` the
    averaged gradients (zeros for fc3), else the error."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist

    rank, _ = _rank()
    dp = dist.DataParallel(_linear_model(0), find_unused_parameters=find)
    x = paddle.to_tensor(np.random.RandomState(3 + rank).randn(4, 6)
                         .astype(np.float32))
    try:
        dp(x, use_fc2=rank == 0).sum().backward()
    except RuntimeError as e:
        return {"error": str(e)}
    m = dp._layers
    return {k: getattr(m, k).weight.grad.numpy() for k in
            ("fc1", "fc2", "fc3")}


def local_grads_task(use_fc2):
    """The gradients of one process's backward, no group (the reference
    for ``unused_task``)."""
    import paddle_tpu_torch as paddle

    out = {}
    for rank, use in enumerate(use_fc2):
        m = _linear_model(0)
        x = paddle.to_tensor(np.random.RandomState(3 + rank).randn(4, 6)
                             .astype(np.float32))
        m(x, use_fc2=use).sum().backward()
        out[rank] = {k: None if getattr(m, k).weight.grad is None else
                     getattr(m, k).weight.grad.numpy()
                     for k in ("fc1", "fc2", "fc3")}
    return out


def gpt_dp_steps(sd, ids, labels, steps, lr, split):
    """``steps`` SGD TrainSteps of the port's gpt_tiny from ``sd`` under
    ``DataParallel``; with ``split`` each rank takes its half of the
    batch.  Returns (losses, the updated state dict as numpy)."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import gpt_tiny

    rank, world = _rank()
    model = gpt_tiny(device="cpu", num_layers=2, hidden_size=32)
    model.set_state_dict(sd)
    dp = dist.DataParallel(model)
    opt = optimizer.SGD(learning_rate=lr, parameters=dp.parameters())
    step = TrainStep(dp, lambda lg, lb: model.loss(lg, lb), opt)
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    if split:
        k = ids.shape[0] // world
        ids, labels = (t[rank * k:(rank + 1) * k] for t in (ids, labels))
    losses = [step(ids, labels).item() for _ in range(steps)]
    return losses, {k: v.detach().numpy() for k, v in
                    model.named_parameters()}


def sharded_model_and_data(seed=0):
    """The reference test's ``_model_and_data`` on the port."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    paddle.seed(seed)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(16, 64)
            self.fc2 = nn.Linear(64, 16)

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    rs = np.random.RandomState(seed)
    x = paddle.to_tensor(rs.randn(32, 16).astype("float32"))
    y = paddle.to_tensor(rs.randn(32, 16).astype("float32"))
    return Net(), x, y


def sharded_train(model, opt, x, y, steps=5):
    """The reference test's ``_train``."""
    from paddle_tpu_torch import nn

    losses = []
    for _ in range(steps):
        loss = nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def plain_sharded_reference(clip=None):
    """Losses, weights and optimizer state of the plain (unsharded)
    run."""
    from paddle_tpu_torch import optimizer

    model, x, y = sharded_model_and_data()
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters(),
                          grad_clip=_clip(clip))
    losses = sharded_train(model, opt, x, y)
    return (losses, {k: v.numpy() for k, v in model.state_dict().items()},
            {k: v.numpy() for k, v in opt.state_dict().items()
             if hasattr(v, "numpy")})


def _clip(kind):
    from paddle_tpu_torch import optimizer

    return {None: None,
            "global": optimizer.ClipGradByGlobalNorm(0.5),
            "norm": optimizer.ClipGradByNorm(0.5),
            "value": optimizer.ClipGradByValue(0.01)}[kind]


def group_sharded_task(level, clip=None, ckpt=None):
    """The reference run under ``group_sharded_parallel(level)``: losses,
    the whole weights, what a p_g_os parameter holds at rest, the
    optimizer's gathered state; with ``ckpt`` a ZeRO-3 checkpoint is
    written there by every rank."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.checkpoint import save_state_dict
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    model, x, y = sharded_model_and_data()
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters(),
                          grad_clip=_clip(clip))
    inner = model
    model, opt, _ = group_sharded_parallel(model, opt, level=level)
    losses = sharded_train(model, opt, x, y)
    w = inner.fc1.weight
    rest = {"storage": w._data.untyped_storage().nbytes(),
            "moment1": tuple(opt._inner_opt._accumulators[id(w)]["moment1"]
                             .shape)}
    if level == "p_g_os":
        rest["block"] = tuple(model.shard_of(w).shape)
    sd = model.state_dict()
    if ckpt is not None:
        save_state_dict(sd, ckpt)
    return {"losses": losses, "rest": rest,
            "weights": {k: v.numpy() for k, v in sd.items()},
            "opt": {k: v.numpy() for k, v in opt.state_dict().items()
                    if hasattr(v, "numpy")}}


def zero3_checkpoint_task(path, dtype):
    """A p_g_os model of the reference's, cast to ``dtype``, writes its
    checkpoint from every rank; returns its whole weights and what each
    rank wrote."""
    import json

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.checkpoint import save_state_dict
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    rank, _ = _rank()
    model, _, _ = sharded_model_and_data(seed=4)
    model.to(dtype=dtype)
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    sd = model.state_dict()
    save_state_dict(sd, path)
    with open(f"{path}/meta_rank{rank}.json") as f:
        meta = json.load(f)
    return {"weights": {k: v._data.float().numpy() for k, v in sd.items()},
            "offsets": {k: v["shards"][0]["offsets"] for k, v in
                        meta.items() if not k.startswith("__")}}


def save_sharded_task(path, level):
    """Two steps under ``level``, then ``save_group_sharded_model`` (rank
    0 writes the gathered state)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)

    model, x, y = sharded_model_and_data()
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, level=level)
    sharded_train(model, opt, x, y, steps=2)
    save_group_sharded_model(model, path, optimizer=opt)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def zero3_reads_task():
    """The reference run under ``p_g_os``, then every parameter read at
    rest on both ranks (each read all-gathers): ``numpy()``,
    ``detach().clone()``, the inner ``state_dict()``, the inner forward
    under no_grad; the leaves' bytes and the blocks' shapes before and
    after the reads, and the wrapper's gathered weights and forward;
    then the error of a read that rank 0 makes alone."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    model, x, y = sharded_model_and_data()
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters())
    inner = model
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    sharded_train(model, opt, x, y)

    def held():
        return {"leaf_bytes": sum(p._data.untyped_storage().nbytes()
                                  for p in inner.parameters()),
                "blocks": {k: tuple(model.shard_of(p).shape)
                           for k, p in inner.named_parameters()
                           if model.shard_of(p) is not None}}

    out = {"before": held()}
    out["numpy"] = {k: p.numpy() for k, p in inner.named_parameters()}
    out["detach_clone"] = {k: p._data.detach().clone().numpy()
                           for k, p in inner.named_parameters()}
    out["state_dict"] = {k: v.numpy() for k, v in inner.state_dict().items()}
    with torch.no_grad():
        out["forward"] = inner(x).numpy()
    out["after"] = held()
    out["gathered"] = {k: v.numpy() for k, v in model.state_dict().items()}
    with torch.no_grad():
        out["wrapped_forward"] = model(x).numpy()
    # last, as it leaves the wrapper's barrier group closed: a read that
    # rank 0 makes alone
    out["alone"] = None
    if torch.distributed.get_rank() == 0:
        model.read_timeout = 2.0
        try:
            inner.parameters()[0].numpy()
        except RuntimeError as e:
            out["alone"] = str(e)
    return out
