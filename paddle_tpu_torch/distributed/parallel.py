"""Parallel environment bootstrap + dygraph DataParallel.

Port of ``paddle_tpu/distributed/parallel.py`` (reference
python/paddle/distributed/parallel.py: ``init_parallel_env`` :915,
``DataParallel`` :186).  The JAX package runs one controller: its
``init_parallel_env`` starts ``jax.distributed`` on a multi-host job and
its ``DataParallel`` is a pass-through, since GSPMD averages the
gradients of a batch sharded over the data axis.  The port runs one
process a rank:

- **Rendezvous.**  ``init_parallel_env`` reads the rank and world size
  from ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` (the launcher and
  ``spawn`` set them) and starts torch's c10d store on
  :func:`coordinator_address` of ``PADDLE_MASTER``: the same host, the
  master port + 1, since the launcher's ``TCPStore`` owns the master port
  (the JAX launcher's convention).  A job of one process without a master
  forms a one-rank group over a local store.
- **Device and backend.**  The rank runs on ``device=`` or, by default,
  on card ``PADDLE_LOCAL_RANK``; without a card the caller must ask for
  the CPU.  The ranks swap their devices through the store and form the
  default group with ``group.mp_backend``: NCCL when each rank has a card
  of its own, gloo otherwise.  A failure to form the group raises.
- **DataParallel** averages the gradients itself, as torch's
  ``DistributedDataParallel`` does (the port's ``Layer`` is no
  ``nn.Module``, and the port's GPT is one, so the wrapper takes
  either): the trainable parameters, in reverse order, fill buckets of
  ``last_comm_buffer_size`` MB (the first) and ``comm_buffer_size`` MB
  (the rest), one dtype a bucket.  A hook on each parameter's leaf tensor
  (``register_post_accumulate_grad_hook``) counts its gradient in; a full
  bucket is flattened and summed over the group with one asynchronous
  ``all_reduce``, buckets launched in their order on every rank.  At the
  end of the backward (a callback queued on the autograd engine) the
  wrapper waits for every bucket, divides by the group's size and writes
  the averages back, so ``optimizer.step()`` sees them.  ``no_sync()``
  suspends the averaging (the gradients accumulate locally until the
  next synced backward); a parameter that got no gradient raises unless
  ``find_unused_parameters=True``, which sums zeros for it (every rank's
  parameter then has the group's average, zeros where no rank used it,
  the gradient the JAX step gives an unused parameter).
"""

import contextlib
import datetime
import os
import time

import torch

from ..core.tensor import Tensor
from ..nn.layer_base import Layer
from .group import (_ensure_default_group, _global_rank, _world_up,
                    mp_backend)
from . import group as _group_mod

_device = None


class ParallelEnv:
    """Reference: python/paddle/fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        """The rank's card: the one ``init_parallel_env`` chose, else
        ``PADDLE_LOCAL_RANK``'s."""
        if _device is not None and _device.type == "cuda":
            return _device.index
        return self.local_rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def dev_id(self):
        return self.device_id


def coordinator_address(master):
    """The jax coordination endpoint derived from a ``host:port`` master
    (TCPStore) endpoint — same host, port + 1 (the store owns its port).
    Fails fast on a port-less endpoint instead of an opaque IndexError."""
    host, sep, port = str(master).rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"master endpoint must be host:port, got {master!r}")
    return f"{host}:{int(port) + 1}"


def _rank_device(device):
    from ..framework.device import resolve_device

    if device is not None:
        return resolve_device(device)
    local = int(os.environ.get("PADDLE_LOCAL_RANK",
                               os.environ.get("PADDLE_TRAINER_ID", "0")))
    resolve_device(None)     # raises without a card: ask for the CPU
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card of its own "
            f"({torch.cuda.device_count()} visible): pass device=")
    return torch.device("cuda", local)


def init_parallel_env(device=None, timeout=1800):
    """Form the default group of this job (module docstring) and return
    the ``ParallelEnv``.  ``timeout`` is the group's, in seconds."""
    global _device
    if _world_up():
        return ParallelEnv()
    from torch import distributed as dist

    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    dev = _rank_device(device)
    span = datetime.timedelta(seconds=timeout)
    master = os.environ.get("PADDLE_MASTER")
    if master is None:
        if world != 1:
            raise RuntimeError(f"PADDLE_TRAINERS_NUM={world} but no "
                               "PADDLE_MASTER to meet at")
        store = dist.HashStore()
    else:
        host, _, port = coordinator_address(master).rpartition(":")
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=span)
    store.set(f"device/{rank}", str(dev))
    devices = [torch.device(store.get(f"device/{r}").decode())
               for r in range(world)]
    backend = mp_backend(devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world, timeout=span)
    _device = dev
    _group_mod._default_group = None
    _ensure_default_group()
    return ParallelEnv()


def get_rank(group=None):
    if group is not None:
        return group.rank
    return _global_rank()


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    from torch import distributed as dist
    return dist.get_world_size() if _world_up() else 1


def is_initialized():
    return _world_up()


def _leaf(p):
    return p._data if isinstance(p, Tensor) else p


class _Wrapper(Layer):
    """A Layer around ``layers`` (a Paddle Layer or a ``torch.nn.Module``)
    that passes through its parameters, state dict, mode and attributes:
    the base of ``DataParallel`` and the ZeRO stages."""

    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def train(self):
        self._layers.train()
        return super().train()

    def eval(self):
        self._layers.eval()
        return super().eval()

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_sub_layers", {}).get("_layers") \
                or self.__dict__.get("_layers")
            if inner is None:
                raise
            return getattr(inner, name)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)


class _Bucket:
    def __init__(self, params):
        self.params = params      # the owners (Parameters or torch leaves)
        self.arrived = 0
        self.work = None
        self.flat = None


class DataParallel(_Wrapper):
    """paddle.DataParallel: the gradients of ``layers`` (a Paddle Layer
    or a ``torch.nn.Module``) averaged over ``group`` (the default group
    when None) in buckets (module docstring)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        self.find_unused_parameters = find_unused_parameters
        self.group = group
        self._g = group if group is not None else _ensure_default_group()
        self._sync = True
        self._queued = False
        self._next = 0
        self.stats = {"allreduce_s": 0.0}   # host s in the end-of-backward waits
        if self._g.process_group is None or not self._g.is_member():
            self._buckets = []
            return
        params = [p for p in self._layers.parameters()
                  if _leaf(p).requires_grad]
        self._buckets = self._assign(params[::-1], [
            last_comm_buffer_size, comm_buffer_size])
        self._bucket_of = {id(p): b for b in self._buckets
                           for p in b.params}
        self._hooked = {}
        self._hook_leaves()

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients of the backwards inside accumulate locally."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def forward(self, *inputs, **kwargs):
        if self._buckets:
            self._hook_leaves()
        return self._layers(*inputs, **kwargs)

    # ---- buckets ----
    @staticmethod
    def _assign(params, limits_mb):
        """Consecutive parameters of one dtype and device, each bucket up
        to its limit (the first ``limits_mb[0]``, the rest
        ``limits_mb[1]``; a parameter larger than the limit is a bucket
        of its own)."""
        buckets, cur, size = [], [], 0
        for p in params:
            leaf = _leaf(p)
            nbytes = leaf.numel() * leaf.element_size()
            limit = limits_mb[min(len(buckets), 1)] * (1 << 20)
            if cur and (size + nbytes > limit
                        or (leaf.dtype, leaf.device) !=
                        (_leaf(cur[0]).dtype, _leaf(cur[0]).device)):
                buckets.append(_Bucket(cur))
                cur, size = [], 0
            cur.append(p)
            size += nbytes
        if cur:
            buckets.append(_Bucket(cur))
        return buckets

    def _hook_leaves(self):
        """Hook each parameter's current leaf (a Paddle Tensor's value is
        rebound by ``set_value``, so a new leaf gets the hook)."""
        for b in self._buckets:
            for p in b.params:
                leaf = _leaf(p)
                if self._hooked.get(id(p)) is leaf:
                    continue
                leaf.register_post_accumulate_grad_hook(
                    lambda _t, p=p, leaf=leaf: self._arrive(p, leaf))
                self._hooked[id(p)] = leaf

    def _arrive(self, p, leaf):
        if not self._sync or _leaf(p) is not leaf:
            return
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finalize)
        b = self._bucket_of[id(p)]
        b.arrived += 1
        if b.arrived == len(b.params):
            self._launch_ready()

    def _launch_ready(self, fill=False):
        """Launch the buckets in order, as far as they are full (every
        one, with zeros for the missing gradients, when ``fill``)."""
        from torch import distributed as dist

        while self._next < len(self._buckets):
            b = self._buckets[self._next]
            if b.arrived < len(b.params) and not fill:
                return
            grads = []
            for p in b.params:
                leaf = _leaf(p)
                g = leaf.grad
                grads.append(torch.zeros_like(leaf) if g is None else g)
            flat = torch.cat([g.reshape(-1) for g in grads])
            if self._g.backend == "gloo" and flat.is_cuda:
                flat = flat.cpu()
            b.flat = flat
            b.work = dist.all_reduce(flat, group=self._g.process_group,
                                     async_op=True)
            self._next += 1

    def _finalize(self):
        t0 = time.perf_counter()
        try:
            missing = [p for b in self._buckets for p in b.params
                       if _leaf(p).grad is None]
            if missing and not self.find_unused_parameters:
                names = [getattr(p, "name", None) or tuple(p.shape)
                         for p in missing]
                raise RuntimeError(
                    f"DataParallel: {len(missing)} parameters got no "
                    f"gradient in this backward ({names[:4]}...); pass "
                    "find_unused_parameters=True if the model leaves "
                    "parameters unused")
            self._launch_ready(fill=True)
            n = self._g.nranks
            with torch.no_grad():
                for b in self._buckets:
                    b.work.wait()
                    flat = b.flat.div_(n)
                    off = 0
                    for p in b.params:
                        leaf = _leaf(p)
                        k = leaf.numel()
                        avg = flat[off:off + k].view(leaf.shape).to(
                            leaf.device, non_blocking=True)
                        if leaf.grad is None:
                            leaf.grad = avg.clone()
                        else:
                            leaf.grad.copy_(avg)
                        off += k
        finally:
            for b in self._buckets:
                b.arrived, b.work, b.flat = 0, None, None
            self._next, self._queued = 0, False
            self.stats["allreduce_s"] += time.perf_counter() - t0
