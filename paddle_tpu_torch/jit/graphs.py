"""Step graphs — one captured CUDA graph per shape of a step body.

The port's counterpart of the JAX package's compiled executables: the
serving engine jits one ragged program per token bucket and
FusedMultiTransformer one decode program per batch shape; here the same
step body, a function of device tensors only, is captured once per key
(a token bucket, a batch size) and replayed, so a step costs one graph
launch instead of one Python dispatch per op.

The body reads its operands from a static device buffer per key.
:meth:`StepGraphs.stage` copies a step's host operands into it through a
pinned buffer of the key's own (one host-to-device copy, non-blocking);
:meth:`StepGraphs.run` then replays the key's graph.  A key's first run
has no graph yet: it runs the body eagerly on the staged operands — the
capture's warm-up, which builds the kernels' libraries, sets their
attributes and warms the allocator, and which is that step — and
captures the body right after, so every later step of the key replays,
as JAX compiles a shape at its first call.  Every graph of one
:class:`StepGraphs` shares one memory pool.  A capture that fails
raises; nothing here falls back to eager dispatch.

Kernel launch counts: a capture records the kernel wrappers' calls
without running any kernel, and a replay runs the kernels without
calling a wrapper.  So each capture takes the counts its wrappers added
back out and keeps them as the graph's launches, and each replay adds
them again through :func:`paddle_tpu_torch.ops.cuda.registry.add_counts`.

CUDA only: the callers run the body directly on the CPU.
"""

import gc
import time

import torch

from ..ops.cuda import registry


class StepGraphs:
    """One CUDA graph of ``body`` per key, in one shared memory pool.

    ``body(static)`` takes the key's static buffer on ``device`` and
    returns its outputs (tensors).  ``captures`` and ``replays`` count graphs
    captured and replayed; ``capture_ms`` holds each key's capture time
    on the host clock."""

    def __init__(self, body, device):
        self._body = body
        self._device = device
        # key -> (pinned host buffer, static device buffer, copy event)
        self._inputs = {}
        # key -> (graph, its static outputs, its kernel launches a replay)
        self._graphs = {}
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.capture_ms = {}

    def __contains__(self, key):
        return key in self._graphs

    def stage(self, key, array):
        """Copy the host array ``array`` into ``key``'s static device
        buffer (allocated, with its pinned host buffer, at the key's
        first stage) and return that buffer.  Raises ValueError if
        ``array`` does not fit the buffer."""
        dtype = torch.from_numpy(array).dtype
        entry = self._inputs.get(key)
        if entry is None:
            host = torch.empty(array.shape, dtype=dtype, pin_memory=True)
            entry = (host, torch.empty(host.shape, dtype=dtype,
                                       device=self._device),
                     torch.cuda.Event())
            self._inputs[key] = entry
        host, static, copied = entry
        if tuple(array.shape) != tuple(host.shape) or dtype != host.dtype:
            raise ValueError(
                f"step operands {array.dtype}{tuple(array.shape)} do not "
                f"fit the static buffer {host.dtype}{tuple(host.shape)} of "
                f"{key!r}")
        copied.synchronize()          # the last copy out of ``host`` is done
        host.numpy()[...] = array
        static.copy_(host, non_blocking=True)
        copied.record()
        return static

    def run(self, key):
        """Run one step on ``key``'s staged operands: replay its graph,
        or at the key's first run the body eagerly (the step itself and
        the capture's warm-up), then capture it.  A replay returns the
        graph's static outputs: the next replay of any graph of this pool
        may overwrite them, so read them before it."""
        if key in self._graphs:
            return self.replay(key)
        static = self._inputs[key][1]
        out = self._body(static)
        self.capture(key, static)
        return out

    def capture(self, key, *args):
        """Capture ``body(*args)`` as ``key``'s graph in the shared pool.

        The cyclic garbage collector is off during the capture: a
        collection there could free an unreachable object holding CUDA
        resources (another engine's graphs, say), and the CUDA calls of
        its release would invalidate the capture."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = registry.counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self._body(*args)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        after = registry.counts()
        launches = {name: n - before[name] for name, n in after.items()
                    if n != before[name]}
        # the capture ran no kernel: its wrapper calls come back out here
        # and go in again with every replay
        registry.add_counts({name: -n for name, n in launches.items()})
        self._graphs[key] = (graph, out, launches)
        self.captures += 1

    def replay(self, key):
        """Replay ``key``'s graph on the current stream -> its static
        outputs; adds the graph's kernel launches to the registry."""
        entry = self._graphs.get(key)
        if entry is None:
            raise KeyError(f"no graph captured for {key!r}")
        graph, out, launches = entry
        graph.replay()
        registry.add_counts(launches)
        self.replays += 1
        return out

    def pool_bytes(self):
        """Bytes of device memory the shared pool holds."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self.pool))
