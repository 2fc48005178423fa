"""Auto-parallel cost model, rule-based tuner, and rank mapper.

Reference: auto_parallel/static/cost/ (op/comm cost model),
static/tuner/ (rule-based + profile-based optimization tuner),
static/mapper.py (logical rank -> physical device mapping),
static/cluster.py (machine/device/link capability model from json).

Port of ``paddle_tpu/distributed/auto_parallel/tuner.py``.  The search
space is mesh factorizations (dp, mp, pp) of the device count plus
recompute on/off, sequence-parallel mode, microbatch count and
interleaved virtual-pp depth; a candidate's cost is the analytic memory
model (params + activations vs device memory) and per-step time model
(compute FLOPs / device + collective bytes over the interconnect).
``CostEstimator`` and ``ParallelTuner``'s search are the JAX text, so the
same ``ClusterSpec`` gives the same decisions.  What the port changes:

- ``ClusterSpec()`` reads the attached card: its name
  (``torch.cuda.get_device_name``), its memory
  (``torch.cuda.get_device_properties(0).total_memory``), its bf16 rate
  and link bandwidth from :data:`_DEVICE_KINDS` (the H100's; the JAX
  TPU rows are kept so their names still resolve); a kind not in the
  table, or a host without a card, is calibrated by a timed matmul.
- ``calibrate_dcn`` times an all-gather over the default group
  (``torch.distributed``) instead of ``multihost_utils``.
- ``refine`` times the port's ``parallel.SpmdTrainStep`` of each
  candidate that the world can hold (dp * pp * mp the world size, over
  ``build_mesh(dp=dp, pp=pp, mp=mp)``); any other candidate is recorded
  with its reason, as the JAX loop records one that fails to build.
- ``Mapper`` lays ranks out as a ``fleet.RankMesh``.
"""

import math
import time

import numpy as np
import torch

__all__ = ["ClusterSpec", "CostEstimator", "ParallelTuner", "Mapper"]


# Per-device capability numbers by device kind (public sources):
# - NVIDIA H100 SXM5 80GB (HBM3): 989e12 dense bf16 FLOP/s (NVIDIA H100
#   datasheet), 80 GB HBM3, NVLink 4 at 900 GB/s bidirectional ->
#   4.5e11 B/s one way;
# - the TPU rows of the JAX package, kept for their names (Google Cloud
#   TPU system-architecture pages: v4 275 TF bf16, 32 GiB; v5e 197 TF,
#   16 GiB; v5p 459 TF, 95 GiB; v6e 918 TF, 32 GiB; one-way ICI figures
#   derived from the same pages).
# These are ANALYTIC RANKING constants, not promises: refine() re-times
# the top-K candidates with real steps; unknown kinds calibrate flops by
# a measured matmul instead of trusting a table.
_DEVICE_KINDS = {
    "nvidia h100 80gb hbm3": dict(flops_bf16=989e12, hbm_bytes=80e9,
                                  ici_bandwidth=4.5e11),
    "tpu v4":  dict(flops_bf16=275e12, hbm_bytes=32e9, ici_bandwidth=1.2e11),
    "tpu v5e": dict(flops_bf16=197e12, hbm_bytes=16e9, ici_bandwidth=4.5e10),
    "tpu v5p": dict(flops_bf16=459e12, hbm_bytes=95e9, ici_bandwidth=9.8e10),
    "tpu v5":  dict(flops_bf16=459e12, hbm_bytes=95e9, ici_bandwidth=9.8e10),
    "tpu v6e": dict(flops_bf16=918e12, hbm_bytes=32e9, ici_bandwidth=9.0e10),
    "tpu v6":  dict(flops_bf16=918e12, hbm_bytes=32e9, ici_bandwidth=9.0e10),
}


def _device_kind():
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _world():
    from ..parallel import get_world_size

    return get_world_size()


class ClusterSpec:
    """Per-device capability numbers used by the analytic model.

    ``ClusterSpec()`` reads the attached card (module docstring):
    ``num_devices`` defaults to the world's ranks; unknown kinds (CPU
    hosts, other parts) fall back to a measured matmul calibration so the
    tuner never ranks with fictional constants.  Explicit keyword
    overrides always win.
    """

    def __init__(self, num_devices=None, hbm_bytes=None, flops_bf16=None,
                 ici_bandwidth=None, dcn_bandwidth=2.5e9, calibrate=True):
        self.num_devices = num_devices or _world()
        self.device_kind = _device_kind()
        base = _DEVICE_KINDS.get(self.device_kind.lower())
        if base is None:
            base = dict(flops_bf16=None, hbm_bytes=None, ici_bandwidth=2e10)
        self.flops_bf16 = flops_bf16 or base["flops_bf16"]
        self.hbm_bytes = hbm_bytes or base["hbm_bytes"]
        self.ici_bandwidth = ici_bandwidth or base["ici_bandwidth"]
        # 2.5e9 B/s = 20 Gbps: a deliberately conservative default for a
        # single cloud inter-host NIC path.  In a real multi-process run
        # calibrate_dcn() replaces it with a MEASURED cross-host
        # collective bandwidth.
        self.dcn_bandwidth = dcn_bandwidth
        self.dcn_measured = False

        # the card's own memory when there is one
        if hbm_bytes is None and torch.cuda.is_available():
            self.hbm_bytes = float(
                torch.cuda.get_device_properties(0).total_memory)
        if self.flops_bf16 is None and calibrate:
            self.flops_bf16 = self._measure_flops()
        if self.flops_bf16 is None:
            self.flops_bf16 = 1e12  # last-resort nominal
        if self.hbm_bytes is None:
            self.hbm_bytes = 8e9

    @classmethod
    def from_devices(cls, **overrides):
        return cls(**overrides)

    def calibrate_dcn(self, nbytes=8 << 20, iters=3):
        """Measure the cross-process bandwidth by timing an all-gather of
        an ``nbytes`` buffer over the default group; replaces the
        conservative ``dcn_bandwidth`` default.  No-op (returns None) in
        a single-process run — there is nothing to measure.

        Per-process bytes moved by ring all-gather ≈ nbytes*(world-1),
        so bandwidth = nbytes*(world-1)/t_median (median of ``iters``
        timings — robust to one slow outlier).
        """
        from .. import communication as dist

        world = _world()
        if world <= 1:
            return None
        buf = torch.zeros(nbytes // 4, dtype=torch.float32)
        dist.all_gather([], buf)        # warm up
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dist.all_gather([], buf)
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        self.dcn_bandwidth = nbytes * (world - 1) / max(t, 1e-9)
        self.dcn_measured = True
        return self.dcn_bandwidth

    _measured_flops_cache = {}

    @classmethod
    def _measure_flops(cls, n=1024, iters=5):
        """Time a matmul on the attached device (bf16 on a card, f32 on
        the host) — honest capability for device kinds not in the table.
        Memoized per device kind: calibration is per-process, not per
        ClusterSpec instance."""
        kind = _device_kind()
        if kind in cls._measured_flops_cache:
            return cls._measured_flops_cache[kind]
        got = cls._measure_flops_uncached(n, iters)
        cls._measured_flops_cache[kind] = got
        return got

    @staticmethod
    def _measure_flops_uncached(n=1024, iters=5):
        try:
            cuda = torch.cuda.is_available()
            a = torch.ones((n, n), dtype=torch.bfloat16 if cuda
                           else torch.float32,
                           device="cuda" if cuda else "cpu")

            def run():
                out = a @ a
                if cuda:
                    torch.cuda.synchronize()
                return out

            run()
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            return 2.0 * n ** 3 / best
        except Exception:
            return None


class CostEstimator:
    """Analytic memory + step-time estimate for one parallel config.

    Model taxonomy follows the reference comp/comm CostEstimator
    (static/cost/estimate_cost.py): per-op compute from FLOPs, comm from
    collective bytes x bandwidth, memory from param/grad/optimizer-state
    + activation partitioning.  Extends the reference's (dp, mp, pp)
    space with sequence-parallel, microbatch count, and interleaved
    virtual-pp (Megatron grouped schedule — parallel/pipeline.py).
    """

    def __init__(self, cluster, n_params, flops_per_token, tokens_per_batch,
                 hidden_size, num_layers, bytes_per_param=18.0):
        # 18 bytes/param ~ bf16 param+grad + fp32 master+Adam moments
        self.cluster = cluster
        self.n_params = n_params
        self.flops_per_token = flops_per_token
        self.tokens_per_batch = tokens_per_batch
        self.hidden = hidden_size
        self.layers = num_layers
        self.bytes_per_param = bytes_per_param

    def memory_bytes(self, dp, mp, pp, sharding=1, recompute=False,
                     sp=False, n_micro=1, virtual_pp=1):
        shard = max(1, mp) * max(1, pp) * max(1, sharding)
        param_mem = self.n_params * self.bytes_per_param / shard
        # per-microbatch live activations; ~2/3 of layer activations split
        # over mp always (matmul partials), the LN/residual third only
        # under sequence parallel
        tok = self.tokens_per_batch / dp / max(1, n_micro)
        act_per_layer = 2.0 * tok * self.hidden * (
            (2.0 / 3.0) / max(1, mp)
            + (1.0 / 3.0) * (1.0 / max(1, mp) if sp else 1.0))
        n_live = self.layers if not recompute else math.sqrt(self.layers)
        # pipeline keeps ~pp in-flight microbatches of stage activations
        in_flight = min(max(1, n_micro * virtual_pp), max(1, pp))
        act_mem = 14.0 * act_per_layer * n_live / max(1, pp) * in_flight
        return param_mem + act_mem

    def step_time(self, dp, mp, pp, recompute=False, sp=False, n_micro=None,
                  virtual_pp=1):
        c = self.cluster
        if n_micro is None:
            n_micro = 4 * pp if pp > 1 else 1
        compute = self.flops_per_token * self.tokens_per_batch \
            / (dp * mp * pp) / c.flops_bf16
        if recompute:
            compute *= 4.0 / 3.0
        act_bytes = 2.0 * self.tokens_per_batch / dp * self.hidden
        # mp: per layer, 2 allreduce of activations fwd + 2 bwd; under SP
        # they become allgather+reduce-scatter pairs at half the volume
        comm_mp = (0.0 if mp == 1
                   else 4 * self.layers * act_bytes * (mp - 1) / mp
                   / c.ici_bandwidth * (0.5 if sp else 1.0))
        # dp: gradient allreduce (2x params bf16), overlapped ~50%
        comm_dp = (0.0 if dp == 1
                   else 2.0 * self.n_params * 2 * (dp - 1) / dp
                   / c.ici_bandwidth * 0.5)
        # pp: fwd+bwd activation p2p per stage boundary per microbatch;
        # interleaving multiplies boundary crossings by virtual_pp
        comm_pp = (0.0 if pp == 1
                   else 2.0 * (pp - 1) * act_bytes * max(1, virtual_pp)
                   / c.ici_bandwidth)
        # interleaved 1F1B bubble: (pp-1) / (pp-1 + m*v)
        bubble = 0.0 if pp == 1 else \
            (pp - 1) / (pp - 1 + float(n_micro) * max(1, virtual_pp))
        return (compute + comm_mp + comm_dp + comm_pp) / (1.0 - bubble)


class ParallelTuner:
    """Rule-based tuner (reference static/tuner/optimization_tuner.py):
    enumerate mesh factorizations x {recompute, sp, n_micro, virtual_pp},
    drop configs that exceed HBM, rank by the analytic step time; optional
    measured refinement (``refine``) re-ranks the analytic top-K by timing
    a real train step per candidate — the reference's
    profile-based OptimizationTuner loop."""

    def __init__(self, estimator, mp_limit=8, pp_limit=8,
                 micro_options=(1, 2, 4, 8, 16, 32), vpp_options=(1, 2)):
        self.est = estimator
        self.mp_limit = mp_limit
        self.pp_limit = pp_limit
        self.micro_options = micro_options
        self.vpp_options = vpp_options

    def candidates(self):
        n = self.est.cluster.num_devices
        out = []
        for mp in [d for d in range(1, self.mp_limit + 1) if n % d == 0]:
            rest = n // mp
            for pp in [d for d in range(1, self.pp_limit + 1)
                       if rest % d == 0]:
                dp = rest // pp
                micro = [m for m in self.micro_options
                         if self.est.tokens_per_batch % (dp * m) == 0] \
                    if pp > 1 else [1]
                vpps = [v for v in self.vpp_options
                        if self.est.layers % (pp * v) == 0] if pp > 1 \
                    else [1]
                sps = (False, True) if mp > 1 else (False,)
                for rc in (False, True):
                    for sp in sps:
                        for m in micro or [1]:
                            for v in vpps or [1]:
                                out.append({"dp": dp, "mp": mp, "pp": pp,
                                            "recompute": rc, "sp": sp,
                                            "n_micro": m, "virtual_pp": v})
        return out

    def tune(self, top_k=1):
        scored = []
        for cand in self.candidates():
            mem = self.est.memory_bytes(
                cand["dp"], cand["mp"], cand["pp"],
                recompute=cand["recompute"], sp=cand["sp"],
                n_micro=cand["n_micro"], virtual_pp=cand["virtual_pp"])
            if mem > self.est.cluster.hbm_bytes:
                continue
            t = self.est.step_time(
                cand["dp"], cand["mp"], cand["pp"],
                recompute=cand["recompute"], sp=cand["sp"],
                n_micro=cand["n_micro"], virtual_pp=cand["virtual_pp"])
            scored.append((t, mem, cand))
        if not scored:
            raise RuntimeError(
                "no parallel config fits in HBM — model too large for "
                "this cluster even fully sharded")
        scored.sort(key=lambda x: (x[0], x[2]["recompute"]))
        best = [dict(c, est_step_time=t, est_memory=m)
                for t, m, c in scored[:top_k]]
        return best[0] if top_k == 1 else best

    def refine(self, model_factory, optimizer_factory, batch_factory,
               top_k=3, steps=2):
        """Measured refinement: build + time the port's SpmdTrainStep of
        each of the analytic top-K that the world can hold (module
        docstring), return the candidates with ``measured_step_time``,
        re-ranked by it (reference profile-based tuner parity)."""
        from ...parallel import SpmdTrainStep
        from ..fleet.topology import build_mesh

        cands = self.tune(top_k=top_k)
        if isinstance(cands, dict):  # tune(top_k=1) returns the bare dict
            cands = [cands]
        world = _world()
        results = []
        for cand in cands:
            try:
                if cand["dp"] * cand["pp"] * cand["mp"] != world:
                    raise ValueError(
                        f"dp={cand['dp']} mp={cand['mp']} pp={cand['pp']} "
                        f"needs dp*pp*mp = the world's {world} ranks")
                mesh = build_mesh(dp=cand["dp"], pp=cand["pp"],
                                  mp=cand["mp"])
                model = model_factory()
                opt = optimizer_factory(model)
                tr = SpmdTrainStep(
                    model, opt, mesh, n_microbatches=cand["n_micro"],
                    sequence_parallel=cand["sp"], remat=cand["recompute"],
                    virtual_pp=cand["virtual_pp"])
                ids, labels = batch_factory(cand)
                tr.step(ids, labels)  # warm up
                best = float("inf")
                for _ in range(steps):
                    t0 = time.perf_counter()
                    float(tr.step(ids, labels))
                    best = min(best, time.perf_counter() - t0)
                results.append(dict(cand, measured_step_time=best))
            except Exception as e:  # candidate failed to build: record why
                results.append(dict(cand, measured_step_time=float("inf"),
                                    error=str(e)[:200]))
        results.sort(key=lambda c: c["measured_step_time"])
        return results


class Mapper:
    """Logical rank -> rank-mesh mapping (reference static/mapper.py).

    Axis order controls collective locality: the fastest-varying axis maps
    to adjacent ranks (on one host, neighbouring cards), so put the most
    communication-heavy axis (mp) innermost — the reference mapper's
    bandwidth-aware placement.  ``devices`` are ranks (the world's by
    default)."""

    def __init__(self, devices=None):
        self.devices = list(devices) if devices is not None \
            else list(range(_world()))

    def build_mesh(self, dp=1, mp=1, pp=1):
        from ..fleet.topology import RankMesh

        n = dp * mp * pp
        if n != len(self.devices):
            raise ValueError(f"{dp}x{pp}x{mp} != {len(self.devices)}")
        arr = np.array(self.devices).reshape(dp, pp, mp)
        return RankMesh(arr, ("dp", "pp", "mp"))
