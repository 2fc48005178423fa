"""The serving engine's memory model: pages + weights -> admissible batch.

Port of the tp=1 part of ``paddle_tpu/framework/cost.py``
(``parse_bytes``, ``engine_memory_model``, ``derive_max_batch``) and of
the engine's ``_params_bytes_per_chip``, plus ``measured_host_overhead_s``
over the engine's lookahead gauge.  The port serves on one card,
so nothing is sharded: every parameter leaf counts whole, and the
tensor-parallel, LoRA and host-tier keys of the JAX model are left out.
The jaxpr cost walker, the census and the roofline profiles stay in the
tooling slice.
"""

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


def engine_memory_model(engine, memory_budget=None):
    """Device-memory model of a live LLMEngine: weight bytes, paged K/V
    pool bytes, per-page and per-sequence bytes, and — when a budget is
    declared (here or at construction) — the admissible ``max_batch``
    the budget supports."""
    weights = params_bytes(engine.params)
    kv_quant = bool(engine._kv_quant)
    page = page_bytes(engine.num_layers, engine.block_size,
                      engine.num_heads, engine.head_dim,
                      engine.dtype.itemsize, kv_quant)
    seq = engine.max_pages * page
    budget = parse_bytes(memory_budget if memory_budget is not None
                         else engine.memory_budget)
    model = {
        "tp": 1,
        "kv_quantized": kv_quant,
        "weights_bytes": int(weights),
        "page_bytes": int(page),
        "kv_pool_bytes": int(engine.num_blocks * page),
        "seq_bytes": int(seq),
        "max_pages": int(engine.max_pages),
        "num_blocks": int(engine.num_blocks),
        "memory_budget": budget,
    }
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
    sequences' pages fit beside the weights on one card."""
    budget = parse_bytes(memory_budget)
    free = budget - int(weights_bytes)
    if free < seq_bytes:
        raise ValueError(
            f"memory_budget {_fmt_bytes(budget)} cannot hold the "
            f"weights ({_fmt_bytes(int(weights_bytes))}) plus one "
            f"max_model_len sequence ({_fmt_bytes(int(seq_bytes))} of "
            "pages) — raise the budget or shrink max_model_len")
    return int(free // int(seq_bytes))


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
