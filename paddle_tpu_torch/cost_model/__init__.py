"""paddle.cost_model parity — measured per-op cost lookup (port of
``paddle_tpu/cost_model/__init__.py``).

Reference: python/paddle/cost_model/cost_model.py (profile a program,
report per-op times; static_op_benchmark.json lookup for the
pass/planner stack).  Costs come from the port's own profiler host
events (an eager run of a function) or from timing one registered op on
synthetic inputs — with CUDA events on the card, with the wall clock on
the CPU; results are cached and exportable as JSON, the role the
reference's benchmark json plays for auto-parallel/tuner decisions.

The *static* cost side (no execution at all) lives in
:mod:`paddle_tpu_torch.framework.cost` — the cost walker over a traced
graph, the census, the memory model; its public surface is re-exported
here so ``paddle_tpu_torch.cost_model`` is the one import for both the
measured and the predicted view.  The JAX module also re-exports
``estimate_jaxpr``, ``estimate_jitted`` and ``xla_cost_analysis``,
which read a jaxpr or XLA's cost analysis; they are not ported by
design (ROADMAP "Not ported by design"), and ``estimate_graph`` /
``estimate_fn`` take their place.
"""

import json
import time

import numpy as np
import torch

from ..framework.cost import (CostEstimate, derive_max_batch,
                              engine_memory_model, estimate_fn,
                              estimate_graph, parse_bytes, run_census)

__all__ = ["CostModel", "CostEstimate", "estimate_graph", "estimate_fn",
           "run_census", "engine_memory_model", "derive_max_batch",
           "parse_bytes"]


class CostModel:
    def __init__(self):
        self._static_table = {}

    # ------------------------------------------------------------ profile --
    def profile_measure(self, fn, *args, fetch_cost_list=("time",),
                        warmup=2, iters=5):
        """Measure per-op host costs of running ``fn(*args)`` eagerly.

        Returns {op_name: {"op_time_ms": total, "calls": n}} from the
        profiler's RecordEvent stream (the reference profiles a Program
        run and aggregates per-op; here ops are eager dispatches)."""
        from ..profiler import Profiler

        for _ in range(warmup):
            fn(*args)
        prof = Profiler(timer_only=True)
        prof.start()
        for _ in range(iters):
            fn(*args)
        agg_raw = prof.aggregated_events()
        prof.stop()
        return {name: {"op_time_ms": tot * 1e3 / iters, "calls": cnt}
                for name, (tot, cnt, _mx) in agg_raw.items()}

    # ------------------------------------------------------- static table --
    def measure_op(self, name, shapes=((1024, 1024),), dtype="float32",
                   iters=10):
        """Time one registered op on synthetic inputs (the best of
        ``iters`` calls, ms) on the port's current device: CUDA events
        on the card, the wall clock on the CPU."""
        from ..framework.device import current_device
        from ..ops.registry import OPS

        if name not in OPS or OPS[name].body is None:
            raise KeyError(f"op {name!r} has no body to measure")
        fn = OPS[name].body
        dev = current_device()
        rng = np.random.RandomState(0)
        args = [torch.from_numpy(rng.rand(*s).astype(dtype)).to(dev)
                for s in shapes]
        with torch.no_grad():
            fn(*args)
            best = float("inf")
            for _ in range(iters):
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn(*args)
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                else:
                    t0 = time.perf_counter()
                    fn(*args)
                    ms = (time.perf_counter() - t0) * 1e3
                best = min(best, ms)
        key = f"{name}|{tuple(tuple(s) for s in shapes)}|{dtype}"
        self._static_table[key] = best
        return best

    def get_static_op_time(self, op_name, forward=True, dtype="float32",
                           shapes=((1024, 1024),)):
        """Cost (ms) for an op, measuring on first request (the reference
        reads static_op_benchmark.json; this measures on the live
        device)."""
        key = f"{op_name}|{tuple(tuple(s) for s in shapes)}|{dtype}"
        if key not in self._static_table:
            self.measure_op(op_name, shapes=shapes, dtype=dtype)
        return {"op_time": self._static_table[key]}

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self._static_table, f, indent=1)

    def load(self, path):
        with open(path) as f:
            self._static_table.update(json.load(f))
