"""Graph cost engine, the executable census and the serving engine's
memory model: the port of ``paddle_tpu/framework/cost.py``.

- **The walker** (:func:`estimate_graph` / :func:`estimate_fn`) prices a
  graph traced by ``framework/analysis.py::trace_graph`` (``make_fx``
  over fake tensors: nothing runs): ``mm`` / ``addmm`` / ``bmm`` at
  2MNK, elementwise ops at one FLOP an element (compares, selects and
  dtype converts included), transcendentals counted apart, reductions at
  one an input element, cumulative scans and sorts with the JAX module's
  conventions, and each kernel node (a ``torch.library`` op of
  ``ops/cuda/registry.py``) by its registry ``cost`` rule.  ``hbm_bytes``
  is the traffic at the graph's boundary: each input and weight read
  once, each output written once, a gather reading what it gathers, an
  in-place write writing what it writes, and each kernel what its rule
  counts (a pool the step reads only through a kernel and writes only in
  place is not read whole).  ``peak_bytes`` comes from liveness.  A
  kernel's rule counts data-dependent work from values only, so over
  fake tensors the attention kernels count the least any descriptors
  need: the roofline is a lower bound of a step.
  :func:`flop_counter_analysis` is the counterpart of
  ``xla_cost_analysis``: ``torch.utils.flop_counter.FlopCounterMode``
  over the same body, the cross-check of the matrix products.
- **The census** (:func:`run_census`) walks ``engine.executable_grid()``
  and reports each bucket's graph, the graph count and the memory model,
  with the rules **M001** (a bucket's estimated device peak over the
  declared budget, and the host tier over the host budget) and **B001**
  (the grid's graph count over ``max_executables``).  **C001** has
  nothing to check at tp = 1 (no collective inside a graph); at tp > 1
  the census raises NotImplementedError naming A20b.
- :class:`StepTimeModel`, the simulator's step clock, prices each bucket
  through the walker, as the JAX one does; :func:`speculative_draft_
  estimate` is the JAX draft-cost estimate.

``parse_bytes``, ``engine_memory_model`` (with its LoRA and host-tier
keys), ``derive_max_batch`` and ``migration_estimate`` are the JAX
module's, plus ``measured_host_overhead_s`` over the engine's lookahead
gauge.  The memory model is per chip, as the JAX one: a tensor-parallel
engine's params are its rank 0's shard (the JAX engine's
``_params_bytes_per_chip`` is ``inference/llm/tensor_parallel.py``'s
``params_bytes_per_chip``) and a page holds its ``nh / tp`` heads.
``DEVICE_PROFILES`` holds the JAX module's ``"cpu"`` profile (so
``TierPolicy`` decides as the JAX engine does in the CPU tests) and an
``"h100"`` profile; no TPU profile is carried over.
"""

import json
import math

import torch


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
# The "h100" profile also holds the card's per-block limits that the
# Hopper kernel lint (framework/kernel_lint.py, K002) checks a launch
# plan against (NVIDIA's Hopper tuning guide, the hopper-kernels notes):
# shared memory a block may use, registers an SM and a thread, threads a
# block.  The SM count is read from the card (``sms`` None here).
DEVICE_PROFILES = {
    "cpu": {"flops_per_s": 1.0e11, "hbm_bytes_per_s": 5.0e10,
            "ici_bytes_per_s": 2.0e10},
    "h100": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
             "ici_bytes_per_s": 41.97284178502522e9,
             "smem_per_block": 232448, "regs_per_sm": 65536,
             "regs_per_thread": 255, "threads_per_block": 1024,
             "sms": None},
}

__all__ = [
    "CostEstimate", "Census", "StepTimeModel", "estimate_graph",
    "estimate_fn", "flop_counter_analysis", "run_census",
    "engine_memory_model", "derive_max_batch", "migration_estimate",
    "speculative_draft_estimate", "parse_bytes", "DEVICE_PROFILES",
]

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


# --------------------------------------------------------------------------
# per-op flop / transcendental rules over ATen graphs
# --------------------------------------------------------------------------
def _aten(*names):
    """The ATen overload packets of ``names`` (missing ones skipped)."""
    ops = set()
    for name in names:
        packet = getattr(torch.ops.aten, name, None)
        if packet is not None:
            ops.add(packet)
    return ops


# one FLOP an output element (XLA's HloCostAnalysis convention, which
# the JAX walker follows: predicates, selects and dtype converts too;
# views, copies and data movement count zero)
_ELEMENTWISE = _aten(
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "remainder", "fmod", "maximum", "minimum", "neg", "abs", "floor",
    "ceil", "round", "sign", "clamp", "clamp_min", "clamp_max", "square",
    "lt", "le", "gt", "ge", "eq", "ne", "where", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "isfinite", "masked_fill",
    "_to_copy", "floor_divide", "reciprocal", "relu")
# counted apart in ``transcendentals``, as XLA reports them
_TRANSCENDENTAL = _aten(
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "sigmoid", "erf",
    "erfc", "erfinv", "rsqrt", "sqrt", "lgamma", "digamma")
# one op an input element folded away
_REDUCTIONS = _aten("sum", "mean", "amax", "amin", "max", "min", "prod",
                    "any", "all", "logsumexp")
_CUMULATIVE = _aten("cumsum", "cumprod", "cummax", "cummin",
                    "logcumsumexp")
_MATMUL = _aten("mm", "addmm", "bmm", "baddbmm")
# reads what it gathers, not the whole source
_GATHERS = _aten("index", "index_select", "embedding", "gather")


def _packet(node):
    target = node.target
    return getattr(target, "overloadpacket", None)


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _numel(t):
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _nbytes(t):
    return _numel(t) * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _out_elems(node):
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return sum(_numel(v) for v in val)
    return _numel(val)


def _matmul_flops(node):
    """2 * output elements * contraction size."""
    packet = _packet(node)
    a = _val(node.args[1] if packet in _aten("addmm", "baddbmm")
             else node.args[0])
    return 2 * _out_elems(node) * a.shape[-1]


def _conv_flops(node):
    """2 a multiply-add of a convolution, counting (as XLA's
    HloCostAnalysis does) only the kernel taps that land inside the
    input, not those on its zero padding; a transposed convolution
    counts every tap of its output."""
    x, w, out = _val(node.args[0]), _val(node.args[1]), node.meta["val"]
    stride, padding, dilation = node.args[3], node.args[4], node.args[5]
    transposed, groups = node.args[6], node.args[8]
    out_ch = w.shape[1] * groups if transposed else w.shape[0]
    taps = 1
    for i, k in enumerate(w.shape[2:]):
        n_in, n_out = x.shape[2 + i], out.shape[2 + i]
        if transposed:
            taps *= n_out * k
            continue
        s, p, d = stride[i], padding[i], dilation[i]
        taps *= sum(1 for o in range(n_out) for j in range(k)
                    if 0 <= o * s - p + j * d < n_in)
    per_tap = out.shape[0] * out_ch * (w.shape[1] if not transposed
                                        else w.shape[0] // groups)
    return 2 * per_tap * taps


def _node_flops(node):
    """(flops, matmul flops, transcendentals) of one ATen node."""
    packet = _packet(node)
    if packet in _MATMUL:
        mm = _matmul_flops(node)
        extra = _out_elems(node) if packet in _aten("addmm",
                                                    "baddbmm") else 0
        return mm + extra, mm, 0
    if packet == torch.ops.aten.convolution:
        mm = _conv_flops(node)
        extra = _out_elems(node) if node.args[2] is not None else 0
        return mm + extra, mm, 0
    if packet == torch.ops.aten.pow:
        # x ** n expands into O(log n) multiplies (XLA's integer_pow)
        n = node.args[1] if len(node.args) > 1 else 2
        if isinstance(n, (int, float)) and float(n).is_integer():
            return (_out_elems(node)
                    * max(1, int(math.log2(max(abs(int(n)), 2)))), 0, 0)
        return 0, 0, _out_elems(node)
    if packet == torch.ops.aten.gelu:
        # the tanh form's chain: cube, 4 multiplies, 2 adds and a tanh
        return 7 * _out_elems(node), 0, _out_elems(node)
    if packet in (torch.ops.aten._softmax, torch.ops.aten._log_softmax):
        # max, subtract, sum, divide (or log): 4 an element, plus exp
        return 4 * _out_elems(node), 0, _out_elems(node)
    if packet in _ELEMENTWISE:
        return _out_elems(node), 0, 0
    if packet in _TRANSCENDENTAL:
        return 0, 0, _out_elems(node)
    if packet in _REDUCTIONS:
        n = _numel(_val(node.args[0]))
        if packet == torch.ops.aten.mean:
            n += _out_elems(node)           # the divide after the sum
        return n, 0, 0
    if packet in _CUMULATIVE:
        out = node.meta["val"]
        out = out[0] if isinstance(out, (tuple, list)) else out
        dim = node.args[1] if len(node.args) > 1 else 0
        length = max(2, out.shape[dim] if out.dim() else 1)
        return int(out.numel() * (13 + math.log2(length) / 2)), 0, 0
    if packet == torch.ops.aten.sort:
        n = max(2, _numel(_val(node.args[0])))
        return int(n * math.ceil(math.log2(n))), 0, 0
    return 0, 0, 0


def _is_view(node):
    return bool(getattr(node.target, "is_view", False))


def _mutated(node):
    """Indices of the args an op's schema writes."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return ()
    return tuple(i for i, a in enumerate(schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


# --------------------------------------------------------------------------
# the estimate
# --------------------------------------------------------------------------
class CostEstimate:
    """Static cost of one step graph.

    flops            -- FLOPs of every node, kernels by their cost rules
    matmul_flops     -- of which the dense products (mm/addmm/bmm)
    transcendentals  -- exp/tanh/rsqrt/... element count
    hbm_bytes        -- device-memory traffic at the graph's boundary
                        (see the module docstring)
    access_bytes     -- per-node operand + result sum (the unfused bound)
    peak_bytes       -- peak live bytes: inputs and weights, plus the
                        intermediates alive at once
    resident_bytes   -- the inputs' and weights' bytes (alive throughout)
    kernels          -- {kernel name: launches in the graph}
    """

    __slots__ = ("flops", "matmul_flops", "transcendentals", "hbm_bytes",
                 "access_bytes", "peak_bytes", "resident_bytes", "kernels")

    def __init__(self):
        self.flops = 0
        self.matmul_flops = 0
        self.transcendentals = 0
        self.hbm_bytes = 0
        self.access_bytes = 0
        self.peak_bytes = 0
        self.resident_bytes = 0
        self.kernels = {}

    def arithmetic_intensity(self):
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def roofline(self, profile="h100"):
        """Classify the step as compute- or hbm-bound under a device
        profile (a DEVICE_PROFILES key or a dict): the larger of FLOPs
        over the peak rate and bytes over the memory rate is the least
        time the card could take."""
        p = DEVICE_PROFILES[profile] if isinstance(profile, str) \
            else profile
        times = {"compute": self.flops / p["flops_per_s"],
                 "hbm": self.hbm_bytes / p["hbm_bytes_per_s"]}
        bound = max(times, key=times.get)
        return {"bound": bound, "times_s": times}

    def to_dict(self):
        return {
            "flops": int(self.flops),
            "matmul_flops": int(self.matmul_flops),
            "transcendentals": int(self.transcendentals),
            "hbm_bytes": int(self.hbm_bytes),
            "access_bytes": int(self.access_bytes),
            "peak_bytes": int(self.peak_bytes),
            "resident_bytes": int(self.resident_bytes),
            "kernels": dict(sorted(self.kernels.items())),
            "arithmetic_intensity":
                round(self.arithmetic_intensity(), 3),
        }


def _source(node):
    """The placeholder or weight a chain of views starts from."""
    while isinstance(node, torch.fx.Node) and _is_view(node):
        node = node.args[0]
    return node


def _kernel_args(node):
    """The op's operands with each tensor replaced by its fake value."""
    def val(a):
        return _val(a) if isinstance(a, torch.fx.Node) else a
    return [val(a) for a in node.args]


def estimate_graph(gm):
    """CostEstimate of a traced graph (``analysis.trace_graph``)."""
    from ..ops.cuda import registry
    from .analysis import _values

    kernels = registry.by_op()
    est = CostEstimate()
    nodes = list(gm.graph.nodes)
    value = {}
    for node in nodes:
        if node.op == "get_attr":
            value[node] = getattr(gm, node.target)
        elif "val" in node.meta:
            value[node] = node.meta["val"]
    leaves = [n for n in nodes if n.op in ("placeholder", "get_attr")
              and isinstance(value.get(n), torch.Tensor)]
    est.resident_bytes = sum(_nbytes(value[n]) for n in leaves)
    # boundary reads: a leaf read densely by any node counts whole; one
    # read through gathers, in-place writes and kernels only counts what
    # those read and write
    dense = set()
    for node in nodes:
        if node.op == "output":
            out = node.args[0]
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.fx.Node):
                    est.hbm_bytes += sum(
                        _nbytes(v) for v in _values(value.get(x)))
            continue
        if node.op != "call_function" or _is_view(node):
            continue
        entry = kernels.get(node.target)
        packet = _packet(node)
        writes = _mutated(node)
        fl, mm, tr = (0, 0, 0) if entry is not None else _node_flops(node)
        if entry is not None:
            cost = entry.cost(*_kernel_args(node))
            fl = cost["flops"]
            est.hbm_bytes += cost["bytes"]
            est.kernels[entry.name] = est.kernels.get(entry.name, 0) + 1
        elif packet in _GATHERS:
            est.hbm_bytes += sum(_nbytes(v) for v in
                                 _values(node.meta.get("val")))
        elif writes:
            est.hbm_bytes += sum(
                _nbytes(_val(a)) for i, a in enumerate(node.args)
                if i not in writes and isinstance(a, torch.fx.Node)
                and _source(a).op not in ("placeholder", "get_attr"))
        else:
            for a in node.all_input_nodes:
                dense.add(_source(a))
        if entry is None and packet in _GATHERS:
            for a in node.all_input_nodes[1:]:
                dense.add(_source(a))
        est.flops += fl
        est.matmul_flops += mm
        est.transcendentals += tr
        est.access_bytes += sum(_nbytes(value.get(a))
                                for a in node.all_input_nodes) \
            + sum(_nbytes(v) for v in _values(node.meta.get("val")))
    est.hbm_bytes += sum(_nbytes(value[n]) for n in leaves if n in dense)
    est.peak_bytes = _peak_bytes(nodes, value, est.resident_bytes)
    return est


def _peak_bytes(nodes, value, resident):
    """Peak live bytes: the leaves throughout, each new buffer (not a
    view, not an in-place write) from its node to its last use."""
    from .analysis import _values

    index = {n: i for i, n in enumerate(nodes)}
    base = {}
    for node in nodes:
        if node.op == "call_function" and (_is_view(node)
                                           or _mutated(node)):
            src = node.args[0]
            base[node] = base.get(src, src)
        elif node.op == "call_function" and _packet(node) is None:
            # getitem of a multi-output op: the op's own buffer
            src = node.args[0]
            base[node] = base.get(src, src)
    last = {}
    for node in nodes:
        for a in node.all_input_nodes:
            b = base.get(a, a)
            last[b] = max(last.get(b, -1), index[node])
    alive = peak = resident
    frees = {}
    for node in nodes:
        if node.op == "call_function" and node not in base:
            nbytes = sum(_nbytes(v) for v in _values(value.get(node)))
            alive += nbytes
            frees.setdefault(last.get(node, index[node]), []).append(
                nbytes)
            peak = max(peak, alive)
        alive -= sum(frees.pop(index[node], ()))
    return peak


def estimate_fn(fn, *args):
    """Trace ``fn(*args)`` over fake tensors (``analysis.trace_graph``:
    nothing runs, no input is written) and estimate its cost."""
    from .analysis import trace_graph

    return estimate_graph(trace_graph(fn, *args))


def flop_counter_analysis(fn, *args):
    """PyTorch's own count for the same body: ``torch.utils.
    flop_counter.FlopCounterMode`` over ``fn(*args)`` run on fake copies
    of the arguments (the weights ``fn`` reads from its closure stay
    real and are only read).  It counts matrix products only, so it
    cross-checks :attr:`CostEstimate.matmul_flops`.  Returns ``{"flops",
    "by_op": {op name: flops}}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        counter = FlopCounterMode(display=False)
        with counter:
            fn(*fake)
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


# --------------------------------------------------------------------------
# the census
# --------------------------------------------------------------------------
class Census:
    """Cost census over an engine's bucket grid.

    entries        -- [{kind, bucket, label, cost, roofline}] per graph
    compile_count  -- graphs warmup() captures (the B001 baseline)
    families       -- {kind: count}
    totals         -- summed FLOPs and bytes over the grid
    memory         -- engine_memory_model() breakdown
    findings       -- M001 / B001 Finding records
    """

    def __init__(self, entries, families, memory, findings, profile):
        self.entries = entries
        self.families = families
        self.memory = memory
        self.findings = findings
        self.profile = profile
        self.compile_count = len(entries)

    @property
    def totals(self):
        keys = ("flops", "matmul_flops", "transcendentals", "hbm_bytes",
                "access_bytes")
        tot = {k: sum(e["cost"][k] for e in self.entries) for k in keys}
        tot["max_peak_bytes"] = max(
            (e["cost"]["peak_bytes"] for e in self.entries), default=0)
        return tot

    def to_dict(self):
        return {
            "compile_count": self.compile_count,
            "families": dict(self.families),
            "profile": self.profile,
            "entries": self.entries,
            "totals": self.totals,
            "memory": self.memory,
            "findings": [
                {"rule": f.rule, "severity": f.severity,
                 "where": f.where, "message": f.message}
                for f in self.findings],
        }

    def to_json(self, **kw):
        return json.dumps(self.to_dict(), **kw)


def run_census(engine, *, memory_budget=None, host_budget=None,
               profile="h100", max_executables=64):
    """Cost every graph of the engine's bucket grid
    (``engine.executable_grid()``, traced over fake tensors: nothing
    runs, no pool is written, no graph is captured) and run M001/B001.

    ``memory_budget`` (bytes or '16GiB') overrides the engine's own
    declared budget for M001; with neither, M001 is skipped and the
    memory model is still reported.  ``host_budget`` declares the
    host-RAM ceiling the KV tier (``kv_tier=``) must fit under — tier
    budgets past it are an M001 too, and every M001 message names both
    budgets when a host tier is configured.  At tp > 1 (where C001's
    collectives would live) the census is not ported yet (A20b)."""
    from .analysis import ERROR, Finding

    if getattr(engine, "tp", 1) > 1:
        raise NotImplementedError(
            "run_census() is not ported yet for tensor_parallel > 1: C001 "
            "and the sharded grid come with A20b (ROADMAP)")
    entries = []
    families = {}
    findings = []
    for kind, bucket, body, operands in engine.executable_grid():
        label = f"{kind}[{bucket}]"
        est = estimate_fn(body, *operands)
        families[kind] = families.get(kind, 0) + 1
        entries.append({"kind": kind, "bucket": bucket, "label": label,
                        "cost": est.to_dict(),
                        "roofline": est.roofline(profile)["bound"],
                        "roofline_s": max(
                            est.roofline(profile)["times_s"].values())})

    memory = engine_memory_model(engine, memory_budget=memory_budget,
                                 host_budget=host_budget)
    budget = memory.get("memory_budget")
    host_bytes = (memory["host_pool_bytes"]
                  + memory["prefix_store_bytes"])
    tier_note = ""
    if host_bytes:
        tier_note = (
            f"; host tier holds {_fmt_bytes(host_bytes)} beside it "
            f"(pool {_fmt_bytes(memory['host_pool_bytes'])} + store "
            f"{_fmt_bytes(memory['prefix_store_bytes'])}"
            + (f" under host budget "
               f"{_fmt_bytes(memory['host_budget'])}"
               if memory.get("host_budget") is not None else "")
            + ")")
    if budget is not None:
        weights = memory["weights_bytes"]
        pool = memory["kv_pool_bytes"]
        for e in entries:
            # per-card peak = resident weights + pool (exact) + the
            # step's transient intermediates over its resident buffers
            transient = max(0, e["cost"]["peak_bytes"]
                            - e["cost"]["resident_bytes"])
            est_peak = weights + pool + transient
            e["est_chip_peak_bytes"] = int(est_peak)
            if est_peak > budget:
                seq = memory["seq_bytes"]
                admissible = ((budget - weights) // seq
                              if budget - weights >= seq else 0)
                lora_bytes = memory.get("lora_pool_bytes", 0)
                lora_note = (
                    f" (of which LoRA adapter pools "
                    f"{_fmt_bytes(lora_bytes)})" if lora_bytes else "")
                findings.append(Finding(
                    "M001", ERROR, e["label"],
                    f"estimated per-chip peak {_fmt_bytes(est_peak)} "
                    f"exceeds the declared budget {_fmt_bytes(budget)} "
                    f"— weights {_fmt_bytes(weights)}{lora_note} + "
                    f"KV pages "
                    f"{_fmt_bytes(pool)} ({memory['num_blocks']} "
                    f"blocks x {_fmt_bytes(memory['page_bytes'])}) + "
                    f"transients {_fmt_bytes(transient)}; at "
                    f"{_fmt_bytes(seq)}/sequence the budget supports "
                    f"max_batch <= {admissible}{tier_note}"))

    hb = memory.get("host_budget")
    if hb is not None and host_bytes > hb:
        host_page = memory["host_page_bytes"]
        findings.append(Finding(
            "M001", ERROR, "kv_tier",
            f"hierarchical-KV tier budgets total "
            f"{_fmt_bytes(host_bytes)} (host pool "
            f"{_fmt_bytes(memory['host_pool_bytes'])} + prefix store "
            f"{_fmt_bytes(memory['prefix_store_bytes'])}) — over the "
            f"declared host budget {_fmt_bytes(hb)}; at "
            f"{_fmt_bytes(host_page)}/page (global payload) the host "
            f"budget admits {memory['host_budget_pages']} tier pages"
            + (f"; HBM budget {_fmt_bytes(budget)} beside it"
               if budget is not None else "")))

    if max_executables is not None and len(entries) > max_executables:
        fam = ", ".join(f"{k}: {v}" for k, v in sorted(families.items()))
        findings.append(Finding(
            "B001", ERROR, "census",
            f"warmup grid compiles {len(entries)} executables "
            f"(threshold {max_executables}) — {fam}. The shipped grid "
            "is ONE ragged family, O(log token_budget) buckets; growth "
            "past the threshold means a new executable kind (or an "
            "unbucketed shape) leaked past the ragged collapse this "
            "census count is the regression baseline for"))

    return Census(entries, families, memory, findings, profile)


def speculative_draft_estimate(engine, profile="h100"):
    """Static per-step cost of the model-based draft phase (the JAX
    estimate): one draft launch prices like one target launch of its
    bucket, and a K-deep greedy chain costs one catch-up launch plus
    K-1 single-token launches a step.  Against the dense
    2-FLOPs-per-parameter-per-token decode bound, worthwhile speculation
    needs the acceptance rate to beat ``flops_overhead_ratio / (1 +
    K)``.

    Returns {draft_launches_per_step, draft_flops_per_step,
    target_flops_per_token, flops_overhead_ratio, break_even_acceptance}
    or None when the engine has no model-based drafter."""
    spec = getattr(engine, "spec", None)
    if spec is None or not getattr(spec, "uses_draft_model", False):
        return None
    k = int(spec.num_tokens)
    n_params = sum(w.numel() for sub in engine.params.values()
                   for w in sub.values())
    per_tok = 2.0 * n_params
    launches = k                      # 1 catch-up + (K-1) chain steps
    draft_flops = per_tok * launches  # ~1 token per launch steady-state
    ratio = draft_flops / per_tok / (1 + k)
    return {"draft_launches_per_step": launches,
            "draft_flops_per_step": int(draft_flops),
            "target_flops_per_token": int(per_tok),
            "flops_overhead_ratio": draft_flops / per_tok,
            "break_even_acceptance": ratio}


class StepTimeModel:
    """Roofline step-time estimates per ``(kind, bucket)`` launch — what
    the discrete-event simulator (``paddle_tpu_torch/sim/``) advances its
    virtual clock by in place of running the device.

    :meth:`from_engine` builds the estimates by tracing the engine's
    step graphs through the cost walker, as the JAX model traces its
    executables.  A launch's time is its estimate plus a flat
    ``host_overhead_s`` covering scheduling, packing and dispatch (0 by
    default; :func:`measured_host_overhead_s` reads one off a served
    engine)."""

    def __init__(self, times_s, profile="h100", host_overhead_s=0.0):
        self.times_s = dict(times_s)      # (kind, bucket) -> seconds
        self.profile = profile
        self.host_overhead_s = float(host_overhead_s)

    @classmethod
    def from_engine(cls, engine, profile="h100", host_overhead_s=0.0):
        """Per-bucket roofline of one engine, as the JAX model builds it:
        each graph of ``engine.executable_grid()`` priced by the census
        walker (:func:`estimate_fn`, over fake tensors: nothing runs)
        and timed at ``max(FLOPs / flops_per_s, hbm_bytes /
        hbm_bytes_per_s)`` under ``profile`` (a DEVICE_PROFILES key or a
        dict with the same keys).

        A lower bound of a step, not a measurement of it: the kernels'
        launch latency and every efficiency below the peaks are left
        out, and the attention kernels count only the work any
        descriptors need (their pages depend on the data).  A model built
        from measured ``times_s`` prices steps in the card's units."""
        if getattr(engine, "tp", 1) > 1:
            raise NotImplementedError(
                "StepTimeModel.from_engine() is not ported yet for "
                "tensor_parallel > 1: it comes with A20b (ROADMAP)")
        times = {}
        for kind, bucket, body, operands in engine.executable_grid():
            rl = estimate_fn(body, *operands).roofline(profile)
            times[(kind, bucket)] = max(rl["times_s"].values())
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
