"""The serving engine's memory model and the tier's cost estimate.

Port of ``paddle_tpu/framework/cost.py``'s ``parse_bytes``,
``engine_memory_model`` with its LoRA and host-tier keys,
``derive_max_batch`` and ``migration_estimate``, plus
``measured_host_overhead_s`` over the engine's lookahead gauge, and
``StepTimeModel``, the simulator's step clock, with its estimates built
from the engine's shapes.  The memory model is per chip, as the JAX
one: a tensor-parallel engine's params are its rank 0's shard (the
JAX engine's ``_params_bytes_per_chip`` is
``inference/llm/tensor_parallel.py``'s ``params_bytes_per_chip``) and a
page holds its ``nh / tp`` heads.  ``DEVICE_PROFILES`` holds the JAX module's ``"cpu"`` profile (so
``TierPolicy`` decides as the JAX engine does in the CPU tests) and an
``"h100"`` profile measured on the card; no TPU profile is carried over.
The jaxpr cost walker and the census stay in the tooling slice.
"""

# Roofline profiles converting byte and FLOP counts to seconds: the dense
# peak, the device-memory rate and the host<->device link rate (the key
# keeps the JAX module's name, ``ici_bytes_per_s``, which
# ``migration_estimate`` reads for its transfer term).
# "cpu" is the JAX module's profile, unchanged.  "h100": bf16 dense
# tensor-core peak and HBM3 rate of the H100 SXM (chip_smoke.py's
# constants); the link is the pinned host->device copy rate of 256 MiB
# copies that chip_smoke.py's kv_tier phase measures (``kv_tier_link``),
# read on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (device to
# host: 39.84443247504561 GB/s in the same run).
DEVICE_PROFILES = {
    "cpu": {"flops_per_s": 1.0e11, "hbm_bytes_per_s": 5.0e10,
            "ici_bytes_per_s": 2.0e10},
    "h100": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
             "ici_bytes_per_s": 41.97284178502522e9},
}

_BYTE_UNITS = {"b": 1, "kb": 1000, "mb": 1000**2, "gb": 1000**3,
               "tb": 1000**4, "kib": 1024, "mib": 1024**2,
               "gib": 1024**3, "tib": 1024**4}


def parse_bytes(value):
    """Byte counts from ints/floats or '16GiB' / '512MB' style strings
    (``LLMEngine(memory_budget=...)`` accepts either)."""
    if value is None:
        return None
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    s = str(value).strip().lower().replace(" ", "")
    try:
        for unit in sorted(_BYTE_UNITS, key=len, reverse=True):
            if s.endswith(unit):
                return int(float(s[: -len(unit)]) * _BYTE_UNITS[unit])
        return int(float(s))
    except ValueError:
        raise ValueError(
            f"can't parse memory size {value!r} — want an int byte "
            "count or a '<number><unit>' string like '16GiB' / "
            "'512MB'") from None


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def params_bytes(params):
    """Bytes of every leaf of the engine's ``{group: {key: tensor}}``
    params (int8 weights, their f32 scales and the rest)."""
    return sum(w.numel() * w.element_size()
               for sub in params.values() for w in sub.values())


def page_bytes(num_layers, block_size, num_heads, head_dim, itemsize,
               kv_quantized):
    """K + V bytes of one page: an int8 slot costs head_dim bytes plus
    one f32 scale per (slot, head); a full-precision one head_dim *
    itemsize."""
    slot = head_dim + 4 if kv_quantized else head_dim * itemsize
    return 2 * num_layers * block_size * num_heads * slot


def engine_memory_model(engine, memory_budget=None, host_budget=None):
    """Per-chip device-memory model of a live LLMEngine: weight bytes
    (the LoRA adapter pools among them, also broken out as
    ``lora_pool_bytes``; under tensor parallelism one rank's shard),
    paged K/V pool bytes, per-page and per-sequence bytes (a rank's
    ``nh / tp`` heads), and — when a budget is declared (here or at
    construction) — the admissible ``max_batch`` the budget supports.

    The host-RAM tier (``kv_tier=``) is priced beside device memory: the
    host pool and prefix store budgets, the global payload of one tier
    page (``page_bytes * tp``: a demoted chain carries every rank's
    slice), and — when ``host_budget`` is declared — how many tier pages
    that host-RAM budget admits."""
    tp = getattr(engine, "tp", 1)
    weights = params_bytes(engine.params)
    lora = sum(w.numel() * w.element_size()
               for key, w in engine.params.get("blocks", {}).items()
               if key.startswith("lora."))
    kv_quant = bool(engine._kv_quant)
    page = page_bytes(engine.num_layers, engine.block_size,
                      engine.num_heads // tp, engine.head_dim,
                      engine.dtype.itemsize, kv_quant)
    seq = engine.max_pages * page
    budget = parse_bytes(memory_budget if memory_budget is not None
                         else engine.memory_budget)
    model = {
        "tp": tp,
        "kv_quantized": kv_quant,
        "weights_bytes": int(weights),
        "lora_pool_bytes": int(lora),
        "page_bytes": int(page),
        "kv_pool_bytes": int(engine.num_blocks * page),
        "seq_bytes": int(seq),
        "max_pages": int(engine.max_pages),
        "num_blocks": int(engine.num_blocks),
        "memory_budget": budget,
    }
    tier = getattr(engine, "kv_tier", None)
    model["host_pool_bytes"] = int(tier.host_bytes) if tier else 0
    model["prefix_store_bytes"] = int(tier.store_bytes) if tier else 0
    host_page = int(page) * tp
    model["host_page_bytes"] = host_page
    model["host_tier_pages"] = (
        (model["host_pool_bytes"] + model["prefix_store_bytes"])
        // host_page)
    hb = parse_bytes(host_budget)
    model["host_budget"] = hb
    if hb is not None:
        model["host_budget_pages"] = int(hb // host_page)
    if budget is not None:
        try:
            model["derived_max_batch"] = derive_max_batch(budget, weights,
                                                          seq)
        except ValueError:
            # an overrun reads as 0 here; LLMEngine(memory_budget=)
            # calls derive_max_batch directly and raises
            model["derived_max_batch"] = 0
    return model


def derive_max_batch(memory_budget, weights_bytes, seq_bytes):
    """pages + weights -> admissible batch: how many full-length
    sequences' pages fit beside the weights on one card (per-chip
    numbers under tensor parallelism)."""
    budget = parse_bytes(memory_budget)
    free = budget - int(weights_bytes)
    if free < seq_bytes:
        raise ValueError(
            f"memory_budget {_fmt_bytes(budget)} cannot hold the "
            f"weights ({_fmt_bytes(int(weights_bytes))}) plus one "
            f"max_model_len sequence ({_fmt_bytes(int(seq_bytes))} of "
            "pages) — raise the budget or shrink max_model_len")
    return int(free // int(seq_bytes))


def migration_estimate(engine, num_tokens, num_pages, profile="h100",
                       link_bytes_per_s=None):
    """Static move-vs-recompute estimate for one sequence's K/V (the
    tier policy's decision inputs).

    Moving the sequence costs ``num_pages`` pages of ``page_bytes`` over
    the host<->device link; recomputing it costs a fresh prefill of
    ``num_tokens`` tokens through the weights (2 FLOPs per parameter per
    token, every leaf of the engine's params counted — int8 scales and
    LoRA pools too, as the JAX tree counts them; attention FLOPs and
    the GEMMs' real efficiency are left out).  ``profile`` (a
    DEVICE_PROFILES key) converts both to seconds, ``link_bytes_per_s``
    overriding the profile's link rate.

    Returns {bytes_moved, migrate_s, recompute_flops, recompute_s,
    prefer} with ``prefer`` in ("migrate", "recompute")."""
    prof = DEVICE_PROFILES[profile]
    model = engine_memory_model(engine)
    bytes_moved = int(num_pages) * model["page_bytes"]
    n_params = sum(w.numel() for sub in engine.params.values()
                   for w in sub.values())
    flops = 2.0 * n_params * int(num_tokens)
    link = (float(link_bytes_per_s) if link_bytes_per_s
            else prof["ici_bytes_per_s"])
    migrate_s = bytes_moved / link
    recompute_s = flops / prof["flops_per_s"]
    return {"bytes_moved": int(bytes_moved),
            "migrate_s": migrate_s,
            "recompute_flops": int(flops),
            "recompute_s": recompute_s,
            "prefer": ("migrate" if migrate_s <= recompute_s
                       else "recompute")}


def measured_host_overhead_s(engine):
    """The engine's critical-path planning time (schedule + pack +
    staged-claim validation, the ``host_plan_s`` lifecycle gauge) per
    launch, target and draft launches alike.  With ``lookahead=True`` a
    claimed staged step adds only its validation, so the value credits
    the pipeline."""
    stats = engine.lifecycle_stats()
    n = getattr(engine, "_launch_count", 0)
    if not n:
        return 0.0
    return float(stats.get("host_plan_s") or 0.0) / n


class StepTimeModel:
    """Roofline step-time estimates per ``(kind, bucket)`` launch — what
    the discrete-event simulator (``paddle_tpu_torch/sim/``) advances its
    virtual clock by in place of running the device.

    The JAX package builds the estimates by tracing the engine's
    executables through its jaxpr cost walker; the port has neither, so
    :meth:`from_engine` prices each token bucket from the engine's shapes
    (see there).  A launch's time is its estimate plus a flat
    ``host_overhead_s`` covering scheduling, packing and dispatch (0 by
    default; :func:`measured_host_overhead_s` reads one off a served
    engine)."""

    def __init__(self, times_s, profile="h100", host_overhead_s=0.0):
        self.times_s = dict(times_s)      # (kind, bucket) -> seconds
        self.profile = profile
        self.host_overhead_s = float(host_overhead_s)

    @classmethod
    def from_engine(cls, engine, profile="h100", host_overhead_s=0.0):
        """Per-bucket roofline of one engine: for each token bucket
        ``tb`` of the engine's grid, ``max(FLOPs / flops_per_s, bytes /
        hbm_bytes_per_s)`` under ``profile`` (a DEVICE_PROFILES key or a
        dict with the same keys).

        - FLOPs: ``2 * params * tb`` (every parameter leaf, as
          :func:`migration_estimate` counts them: the tied head's GEMM is
          the embedding's) plus attention, ``4 * L * Nh * D * tb * ctx``
          (scores and the weighted sum) at a context ``ctx`` of half
          ``max_model_len``, a sequence's mean over its life.
        - Bytes: the weights once, the K/V pages ``min(tb, max_batch)``
          rows of ``ctx`` tokens read, the step's ``tb`` K/V slots
          written, and the ``[tb, V]`` logits written.

        A model of the step, not a measurement of it: it leaves out the
        kernels' launch latency, the elementwise work and every
        efficiency below the peaks, so it is a lower bound.  On an NVIDIA
        H100 80GB HBM3 at 700 W the ``"h100"`` estimate of a GPT-124M
        bf16 step was 0.085 of the replayed step's measured time at
        bucket 8 and 0.065 at bucket 256 (``chip_smoke.py``'s
        ``sim_step_time_model`` line); a model built from measured
        ``times_s`` prices steps in the card's units."""
        if getattr(engine, "tp", 1) > 1:
            raise NotImplementedError(
                "StepTimeModel.from_engine() is not ported yet for "
                "tensor_parallel > 1: it comes with A20b (ROADMAP)")
        prof = DEVICE_PROFILES[profile] if isinstance(profile, str) \
            else profile
        ctx = engine.max_model_len // 2
        weights = params_bytes(engine.params)
        n_params = sum(w.numel() for sub in engine.params.values()
                       for w in sub.values())
        page = page_bytes(engine.num_layers, engine.block_size,
                          engine.num_heads, engine.head_dim,
                          engine.dtype.itemsize, engine._kv_quant)
        slot = page // engine.block_size
        logit_item = engine.dtype.itemsize
        times = {}
        for kind, tb in engine._bucket_grid():
            flops = (2.0 * n_params * tb
                     + 4.0 * engine.num_layers * engine.num_heads
                     * engine.head_dim * tb * ctx)
            rows = min(tb, engine.max_batch)
            nbytes = (weights + rows * ctx * slot + tb * slot
                      + tb * engine.vocab_size * logit_item)
            times[(kind, tb)] = max(flops / prof["flops_per_s"],
                                    nbytes / prof["hbm_bytes_per_s"])
        return cls(times, profile=profile, host_overhead_s=host_overhead_s)

    def step_seconds(self, kind, bucket):
        """Estimated seconds of one ``(kind, bucket)`` launch."""
        try:
            t = self.times_s[(kind, bucket)]
        except KeyError:
            raise KeyError(
                f"no step-time estimate for launch ({kind!r}, "
                f"{bucket!r}) — this model covers "
                f"{sorted(self.times_s)}; build it from an engine "
                f"configured like the one being simulated") from None
        return t + self.host_overhead_s

    def launches_seconds(self, launches):
        """Total estimated seconds of one step's launch list (the
        engine's ``last_launches``: [(kind, bucket), ...])."""
        return sum(self.step_seconds(k, b) for k, b in launches)

    def tier_seconds(self, nbytes, link_bytes_per_s=None):
        """Seconds to move ``nbytes`` of page payload over the
        host<->device link — the KV-tier traffic a step reports as
        ``last_tier_bytes``.  Priced at the profile's link rate by
        default, the rate TierPolicy's estimate uses, so the simulator's
        clock and the policy's break-even agree."""
        if not nbytes:
            return 0.0
        prof = (DEVICE_PROFILES[self.profile]
                if isinstance(self.profile, str) else self.profile)
        link = (float(link_bytes_per_s) if link_bytes_per_s
                else prof["ici_bytes_per_s"])
        return int(nbytes) / link

    def to_dict(self):
        return {
            "profile": (self.profile if isinstance(self.profile, str)
                        else "custom"),
            "host_overhead_s": self.host_overhead_s,
            "times_s": {f"{k}[{b}]": t
                        for (k, b), t in sorted(self.times_s.items())},
        }
