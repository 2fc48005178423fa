"""Graph lint over traced step graphs, host-sync lint over the sources,
and the capture guard: the port of ``paddle_tpu/framework/analysis.py``.

The JAX module reads jaxprs; this one reads the graphs
:func:`trace_graph` makes with ``make_fx`` over fake tensors, so nothing
runs, no kernel launches and no pool is written.  Each kernel of
``ops/cuda/registry.py`` is a ``torch.library`` op, so a launch is one
node of the graph (the counterpart of a ``pallas_call`` equation), which
the cost walker (``framework/cost.py``) and the Hopper kernel lint
(``framework/kernel_lint.py``) read.  ``docs/ANALYSIS.md`` stays the JAX
package's catalog; the port's rules are these:

- **T001 dtype** — no float64/complex128 value anywhere in a step graph
  (placeholders, constants, results), and no int8 value widened straight
  to float64 (the dequant accident).  The JAX rule's weak-type warning
  has no counterpart: a PyTorch tensor carries no weak type, and a
  Python scalar takes the tensor's dtype.
- **G001 dead code** — graph nodes whose results are never used,
  chains feeding only dead nodes included.  A node with effects (an
  op whose schema writes an operand: ``index_put_``, ``index_copy_``,
  ``copy_``; anything ``torch.fx.Node.is_impure`` reports) has no users
  and is live.  ``analyze_program`` applies the rule to an imported
  reference program (ops whose outputs never reach a fetch, feeds no
  live op reads); ``python -m paddle_tpu_torch.framework.analysis
  program <prefix>`` runs it on a ``.pdmodel``.
- **D001 captured state moved** — the counterpart of donation: a
  captured CUDA graph reads every tensor by the address it had at
  capture, so each tensor the step reads by address (the K/V pools with
  their sinks and scales, the draft pools, the weights, the per-layer
  views of them, the adapter pools, the step graphs' static buffers)
  must still have the ``data_ptr()`` the engine recorded when it built
  them and at ``warmup()``.  A replaced tensor means a replay reads
  stale memory.
- **S001 placements** — each rank's shard of the weights under the
  Megatron layout (``tensor_parallel.TP_BLOCK_SPLITS``, through
  ``shard_params`` on meta tensors: no rank is spawned) covers its leaf
  exactly and holds the head group its pool holds (at tp > 1 over the
  global shapes rank 0's shard implies), and every weight and pool of
  the engine's process lies on its device (:func:`check_devices`).
- **H001 host sync** — an AST lint over ``paddle_tpu_torch/ops/`` and
  ``paddle_tpu_torch/inference/llm/``: ``.item()``, ``.tolist()``,
  ``.cpu()`` and ``.numpy()`` on a tensor value, ``float()`` /
  ``int()`` / ``bool()`` and ``np.asarray`` / ``np.array`` on one, and,
  unconditionally, ``torch.cuda.synchronize`` and ``.synchronize()`` on
  an event or a stream.  Host-side sites carry ``# noqa: H001
  (<reason>)`` on their line, host-by-design modules ``# noqa-module:
  H001 (<reason>)`` in their first 40 lines.

:class:`CaptureWatcher` is the counterpart of ``CompileWatcher``: it
counts the captures of one or more :class:`~paddle_tpu_torch.jit.graphs.
StepGraphs` and raises :class:`RecaptureError` when a guarded window
captured a graph.  ``LLMEngine.warmup()`` and ``Fleet.warmup()`` return
one armed, with the warmup's ``compile_ms``.

:func:`main` is the ``graph-lint`` CLI, ``python -m
paddle_tpu_torch.framework.analysis {engine,cost,kernels,threads,ops,fn}``
(exit codes 0 clean or warnings only, 1 errors or warnings under
``--strict``, 2 usage).
"""

import argparse
import ast
import json
import os
import sys
import weakref

import torch

ERROR = "error"
WARNING = "warning"

__all__ = [
    "Finding", "CaptureWatcher", "RecaptureError", "trace_graph",
    "analyze_graph", "analyze_fn", "analyze_engine", "check_dtypes",
    "check_dead_code", "check_captured_state", "check_placements",
    "check_devices",
    "check_host_sync", "collect_host_sync_sites", "main",
]

class Finding:
    """One structured analysis result.

    rule      -- "D001" | "S001" | "T001" | "G001" | "H001" (and the
                 cost, kernel and concurrency rules)
    severity  -- "error" | "warning"
    where     -- human-readable location: "ragged[8]/node mm_3" or
                 "paddle_tpu_torch/ops/cuda/split_kv.py:52"
    message   -- what is wrong and why it matters
    category  -- optional sub-class (H001: item-call / to-host /
                 np-asarray / py-cast / explicit-sync; others leave it
                 empty)
    """

    __slots__ = ("rule", "severity", "where", "message", "category")

    def __init__(self, rule, severity, where, message, category=""):
        self.rule = rule
        self.severity = severity
        self.where = where
        self.message = message
        self.category = category

    def format(self):
        cat = f" [{self.category}]" if self.category else ""
        return f"{self.rule} {self.severity}{cat} {self.where}: " \
               f"{self.message}"

    def __repr__(self):
        return f"Finding({self.format()!r})"


_ALL_RULES = ("D001", "S001", "T001", "G001", "H001")


def _want(rules, rid):
    return rules is None or rid in rules


def _loc(label, tail=None):
    parts = [p for p in (label, tail) if p]
    return "/".join(parts) if parts else "<graph>"


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------
def trace_graph(fn, *args):
    """``fn(*args)`` as a ``torch.fx.GraphModule`` of ATen ops, traced by
    ``make_fx`` over fake tensors: the counterpart of ``make_jaxpr``.

    Nothing runs on a device and no input is written (an in-place write
    to an input pool writes its fake); tensors ``fn`` reads from its
    closure (the weights) become constants of the graph.  Each kernel of
    the port's registry is one node, its ``torch.library`` op.  Every
    node's ``meta["val"]`` holds the fake value it produced."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def _values(val):
    """The tensors of a node's ``meta["val"]`` (one, a tuple, or none)."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return []


# --------------------------------------------------------------------------
# T001 — dtype hygiene
# --------------------------------------------------------------------------
_BAD_DTYPES = (torch.float64, torch.complex128)


def check_dtypes(gm, label=""):
    """T001 over a traced graph: float64/complex128 anywhere, and an int8
    value widened straight to float64."""
    findings = []
    for node in gm.graph.nodes:
        what = {"placeholder": "input", "get_attr": "constant"}.get(
            node.op, "result")
        val = (getattr(gm, node.target) if node.op == "get_attr"
               else node.meta.get("val"))
        for val in _values(val):
            if val.dtype in _BAD_DTYPES:
                findings.append(Finding(
                    "T001", ERROR, _loc(label, f"node {node.name}"),
                    f"{what} '{node.name}' is {val.dtype} — double "
                    "precision leaked into the step graph (a numpy "
                    "float64 array or a .double() upstream; the card "
                    "runs f64 at a fraction of its f32 rate)"))
                break
        if node.op == "call_function" and node.args and \
                isinstance(node.args[0], torch.fx.Node):
            src = _values(node.args[0].meta.get("val"))
            out = _values(node.meta.get("val"))
            if src and out and src[0].dtype == torch.int8 and \
                    out[0].dtype in _BAD_DTYPES:
                findings.append(Finding(
                    "T001", ERROR, _loc(label, f"node {node.name}"),
                    f"int8 '{node.args[0].name}' widens directly to "
                    f"{out[0].dtype} — dequantize in the activation "
                    "dtype, not double precision"))
    return findings


# --------------------------------------------------------------------------
# G001 — dead code
# --------------------------------------------------------------------------
def check_dead_code(gm, label=""):
    """G001 over a traced graph: nodes whose results are never used,
    found by backward liveness from the output and every node with
    effects, so a chain feeding only dead nodes is dead too."""
    findings = []
    live = set()
    for node in reversed(list(gm.graph.nodes)):
        if node.op == "output" or (node.op == "call_function"
                                   and node.is_impure()):
            live.add(node)
        if node.op != "call_function":
            if node in live or node.op == "output":
                live.update(node.all_input_nodes)
            continue
        if node in live:
            live.update(node.all_input_nodes)
        else:
            findings.append(Finding(
                "G001", WARNING, _loc(label, f"node {node.name}"),
                f"result of '{node.target}' ({node.name}) is never used "
                "— dead computation in the step graph"))
    findings.reverse()
    return findings


# --------------------------------------------------------------------------
# D001 — captured state moved
# --------------------------------------------------------------------------
def check_captured_state(engine, label="captured"):
    """D001: every tensor the engine's step reads by address
    (``engine._captured_state()``) still has the ``data_ptr()`` recorded
    for it (``engine._state_ptrs``: at construction, and at ``warmup()``
    for what the warmup allocated)."""
    findings = []
    now = engine._captured_state()
    for name, ptr in sorted(engine._state_ptrs.items()):
        t = now.get(name)
        if t is None:
            findings.append(Finding(
                "D001", ERROR, _loc(label, name),
                f"'{name}' was read by address when the step graphs were "
                "built and is gone now — a replay reads freed memory"))
        elif t.data_ptr() != ptr:
            findings.append(Finding(
                "D001", ERROR, _loc(label, name),
                f"'{name}' moved from {ptr:#x} to {t.data_ptr():#x} — a "
                "captured step graph reads the old address; write it in "
                "place (copy_, index ops) instead of replacing it"))
    return findings


# --------------------------------------------------------------------------
# S001 — placements
# --------------------------------------------------------------------------
def check_placements(params, tp, *, num_heads, head_dim, device=None,
                     pools=None, label="params"):
    """S001 over the global ``{group: {key: tensor}}`` params at tensor
    parallelism ``tp``: each rank's shard (``tensor_parallel.
    shard_params`` over meta copies, so no rank is spawned and nothing is
    copied) must hold ``1/tp`` of each split leaf with no remainder, and
    its qkv columns the ``num_heads / tp`` heads its pool holds; a leaf
    outside ``TP_BLOCK_SPLITS`` stays whole.  With ``device``, every
    leaf (and every tensor of ``pools``) must lie there."""
    from ..inference.llm.tensor_parallel import TP_BLOCK_SPLITS, shard_params

    findings = []
    meta = {g: {k: v.to("meta") for k, v in sub.items()}
            for g, sub in params.items()}
    if num_heads % tp:
        findings.append(Finding(
            "S001", ERROR, _loc(label),
            f"{num_heads} heads do not split over tp={tp} ranks"))
    for rank in range(tp):
        shard = shard_params(meta, rank, tp, torch.device("meta"))
        for group, sub in meta.items():
            for key, full in sub.items():
                got = tuple(shard[group][key].shape)
                dim = TP_BLOCK_SPLITS.get(key) if group == "blocks" \
                    else None
                where = _loc(label, f"rank {rank}/{group}.{key}")
                if dim is None:
                    if got != tuple(full.shape):
                        findings.append(Finding(
                            "S001", ERROR, where,
                            f"replicated leaf has shard shape {got}, not "
                            f"its whole {tuple(full.shape)}"))
                    continue
                if got[dim] * tp != full.shape[dim]:
                    findings.append(Finding(
                        "S001", ERROR, where,
                        f"dim {dim} of {tuple(full.shape)} splits into "
                        f"{tp} shards of {got[dim]}: "
                        f"{full.shape[dim] - got[dim] * tp} columns land "
                        "on no rank"))
                if key == "attn.qkv.weight" and \
                        got[dim] != 3 * (num_heads // tp) * head_dim:
                    findings.append(Finding(
                        "S001", ERROR, where,
                        f"the qkv shard holds {got[dim]} columns, but the "
                        f"rank's pool holds {num_heads // tp} heads of "
                        f"{head_dim} ({3 * (num_heads // tp) * head_dim} "
                        "columns)"))
    if device is not None:
        findings += check_devices(params, device, pools=pools, label=label)
    return findings


def check_devices(params, device, *, pools=None, label="params"):
    """S001's placement half: every leaf of ``params`` and every tensor
    of ``pools`` must lie on ``device``."""
    findings = []
    leaves = [(f"{g}.{k}", v) for g, sub in params.items()
              for k, v in sub.items()]
    leaves += sorted((pools or {}).items())
    want = torch.device(device)
    for name, t in leaves:
        if t.device.type != want.type or (
                want.index is not None and t.device.index is not None
                and t.device.index != want.index):
            findings.append(Finding(
                "S001", ERROR, _loc(label, name),
                f"'{name}' lies on {t.device}, the engine's step runs "
                f"on {want} — every step would copy "
                "it or fail"))
    return findings


# --------------------------------------------------------------------------
# H001 — host-sync AST lint
# --------------------------------------------------------------------------
_METADATA_ATTRS = {"shape", "ndim", "size", "dtype", "name", "device",
                   "is_cuda", "numel", "dim", "element_size", "stride",
                   "data_ptr", "is_contiguous"}
_SYNC_METHODS = {"item": "item-call", "tolist": "item-call",
                 "cpu": "to-host", "numpy": "to-host"}
_CAST_FUNCS = {"float": "py-cast", "int": "py-cast", "bool": "py-cast"}
_NOQA = "noqa: H001"
_NOQA_MODULE = "noqa-module: H001"


def _data_names(node, acc=None):
    """Names contributing DATA (not metadata) to an expression: prunes
    ``.shape``/``.dtype``/``.numel()``-style attribute subtrees and
    ``len()`` calls, which read only what a tensor's header carries."""
    if acc is None:
        acc = set()
    if isinstance(node, ast.Attribute) and node.attr in _METADATA_ATTRS:
        return acc
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Name) and node.func.id == "len":
        return acc
    if isinstance(node, ast.Name):
        acc.add(node.id)
    for child in ast.iter_child_nodes(node):
        _data_names(child, acc)
    return acc


class _Site:
    __slots__ = ("path", "line", "func", "category", "detail", "allowed")

    def __init__(self, path, line, func, category, detail, allowed):
        self.path, self.line, self.func = path, line, func
        self.category, self.detail, self.allowed = \
            category, detail, allowed


class _HostSyncLinter(ast.NodeVisitor):
    def __init__(self, path, lines, sites):
        self.path = path
        self.lines = lines
        self.sites = sites
        self._taint = []        # stack of tainted-name sets

    def _tensor_params(self, node):
        """Op convention: tensors are the leading no-default positional
        params; attrs carry defaults."""
        args = node.args
        names = [a.arg for a in args.posonlyargs + args.args]
        n_def = len(args.defaults)
        tainted = names[:len(names) - n_def] if n_def else names
        return {n for n in tainted if n not in ("self", "cls", "name")}

    def visit_FunctionDef(self, node):
        inherited = self._taint[-1] if self._taint else set()
        self._taint.append(inherited | self._tensor_params(node))
        self.generic_visit(node)
        self._taint.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _is_tainted(self, expr):
        return bool(self._taint and
                    _data_names(expr) & self._taint[-1])

    def visit_Assign(self, node):
        self.generic_visit(node)
        if not self._taint:
            return
        tainted = self._is_tainted(node.value)
        for tgt in node.targets:
            for name in ([tgt] if isinstance(tgt, ast.Name) else
                         [e for e in ast.walk(tgt)
                          if isinstance(e, ast.Name)]):
                if isinstance(name.ctx, ast.Store):
                    (self._taint[-1].add if tainted else
                     self._taint[-1].discard)(name.id)

    def visit_For(self, node):
        if self._taint and self._is_tainted(node.iter):
            for name in ast.walk(node.target):
                if isinstance(name, ast.Name):
                    self._taint[-1].add(name.id)
        self.generic_visit(node)

    def visit_Call(self, node):
        self.generic_visit(node)
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "synchronize":
            # unconditional: torch.cuda.synchronize and an event's or a
            # stream's synchronize() block the host on device work by
            # definition, whatever the receiver is named
            self._record(node, "explicit-sync",
                         f"{ast.unparse(func)}() blocks the host on "
                         "device work")
            return
        if not self._taint:
            return
        if isinstance(func, ast.Attribute) and \
                func.attr in _SYNC_METHODS and \
                self._is_tainted(func.value):
            self._record(node, _SYNC_METHODS[func.attr],
                         f".{func.attr}() on a tensor value")
        elif isinstance(func, ast.Attribute) and \
                func.attr in ("asarray", "array") and \
                isinstance(func.value, ast.Name) and \
                func.value.id == "np" and node.args and \
                self._is_tainted(node.args[0]):
            self._record(node, "np-asarray",
                         f"np.{func.attr}() pulls a tensor to host")
        elif isinstance(func, ast.Name) and func.id in _CAST_FUNCS \
                and node.args and self._is_tainted(node.args[0]):
            self._record(node, _CAST_FUNCS[func.id],
                         f"{func.id}() on a tensor value")

    def _record(self, node, category, detail):
        line = self.lines[node.lineno - 1] \
            if node.lineno - 1 < len(self.lines) else ""
        allowed = _NOQA in line
        self.sites.append(_Site(self.path, node.lineno, "", category,
                                detail, allowed))


def collect_host_sync_sites(paths=None):
    """All host-sync sites the AST lint matches, allowlisted or not —
    the classification view behind :func:`check_host_sync`.  The default
    sweep is the port's ``ops/`` and ``inference/llm/``."""
    if paths is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = [os.path.join(pkg, "ops"),
                 os.path.join(pkg, "inference", "llm")]
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files += [os.path.join(root, n) for n in names
                          if n.endswith(".py")]
        else:
            files.append(p)
    sites = []
    for path in sorted(files):
        try:
            with open(path) as f:
                src = f.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError):
            continue
        lines = src.splitlines()
        module_allowed = any(_NOQA_MODULE in ln for ln in lines[:40])
        file_sites = []
        _HostSyncLinter(path, lines, file_sites).visit(tree)
        if module_allowed:
            for s in file_sites:
                s.allowed = True
        sites += file_sites
    return sites


def check_host_sync(paths=None, label=""):
    """H001 findings: untagged host-sync sites."""
    findings = []
    for s in collect_host_sync_sites(paths):
        if s.allowed:
            continue
        findings.append(Finding(
            "H001", ERROR, f"{os.path.relpath(s.path)}:{s.line}",
            f"{s.detail} — device->host sync in a step-reachable path "
            "(tag the line with '# noqa: H001 (<reason>)' only if it is "
            "host-side by contract)", category=s.category))
    return findings


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def analyze_graph(gm, *, rules=None, label=""):
    """The graph rules (T001, G001) over a traced graph."""
    findings = []
    if _want(rules, "T001"):
        findings += check_dtypes(gm, label=label)
    if _want(rules, "G001"):
        findings += check_dead_code(gm, label=label)
    return findings


def analyze_fn(fn, *args, rules=None, label=""):
    """Trace ``fn(*args)`` (:func:`trace_graph`) and run the graph
    rules."""
    return analyze_graph(trace_graph(fn, *args), rules=rules, label=label)


def analyze_program(program, rules=None, label=""):
    """G001 over an imported static program (``static.program_import.
    InferenceProgram``): top-level ops whose outputs never
    (transitively) reach a fetch target, and feed vars nothing reads —
    reported with the program's real variable names."""
    if not _want(rules, "G001"):
        return []
    findings = []
    blocks = getattr(program, "blocks", []) or []

    def op_reads(op, depth=0):
        reads = [a for args in op.inputs.values() for a in args]
        sub = op.attrs.get("sub_block")
        if sub is not None and depth < 16 and 0 <= sub < len(blocks):
            for sop in blocks[sub][0]:
                reads += op_reads(sop, depth + 1)
        return reads

    live = set(program.fetch_names)
    for idx in reversed(range(len(program.body))):
        op = program.body[idx]
        outs = [a for args in op.outputs.values() for a in args]
        # `while` mutates loop-carried vars in place; never prune it
        if op.type == "while" or any(o in live for o in outs):
            live.update(op_reads(op))
        else:
            findings.append(Finding(
                "G001", WARNING, _loc(label, f"op {idx} ({op.type})"),
                f"op '{op.type}' outputs {outs} never reach a fetch "
                "target — dead op in the imported program"))
    findings.reverse()
    for name in program.feed_names:
        if name not in live:
            findings.append(Finding(
                "G001", WARNING, _loc(label, f"feed '{name}'"),
                f"feed var '{name}' is never read by any live op"))
    return findings


def analyze_engine(engine, rules=None):
    """The graph rules over every step graph of an LLM engine's bucket
    grid (``engine.executable_grid()``), S001 over its weights and pools,
    and D001 over its captured state.

    Pure analysis: the bodies are traced over fake tensors, so the pools,
    the stats, the block manager and the step graphs stay as they were.
    At tp > 1 the graphs are rank 0's shard bodies (each all-reduce a
    stand-in node), S001 splits the global shapes rank 0's shard implies
    (``tensor_parallel.global_meta``) and places rank 0's shard and
    pools, and D001 reads the addresses of rank 0's state (no step is
    captured there, but a pool is still never rebound)."""
    from ..inference.llm.tensor_parallel import global_meta

    findings = []
    for kind, bucket, body, operands in engine.executable_grid():
        findings += analyze_fn(body, *operands, rules=rules,
                               label=f"{kind}[{bucket}]")
    if _want(rules, "S001"):
        pools = {f"pools.{k}": v
                 for k, v in engine._pools._asdict().items()
                 if v is not None}
        if engine.tp == 1:
            findings += check_placements(
                engine.params, 1, num_heads=engine.num_heads,
                head_dim=engine.head_dim, device=engine.device,
                pools=pools)
        else:
            findings += check_placements(
                global_meta(engine.params, engine.tp), engine.tp,
                num_heads=engine.num_heads, head_dim=engine.head_dim)
            findings += check_devices(engine.params, engine.device,
                                      pools=pools)
    if _want(rules, "D001"):
        findings += check_captured_state(engine)
    return findings


# --------------------------------------------------------------------------
# CaptureWatcher — the recapture guard
# --------------------------------------------------------------------------
class RecaptureError(AssertionError):
    """A watched StepGraphs captured a graph inside a no-capture
    window."""


class CaptureWatcher:
    """Guard a window of serving against new CUDA-graph captures.

    Snapshots the ``captures`` count of each watched
    :class:`~paddle_tpu_torch.jit.graphs.StepGraphs` (an engine's target
    and draft graphs, every replica's of a fleet; held weakly, so a
    replica's engine is freed when the fleet drops it) at construction
    and again at ``__enter__``; growth seen by :meth:`assert_no_new_captures`
    or ``__exit__`` raises :class:`RecaptureError` naming the graphs and
    the keys they captured.  ``compile_ms`` carries the warmup's timings
    (``LLMEngine.warmup()``: ``{"ragged[<bucket>]": ms}``).  Two idioms::

        with CaptureWatcher(eng._graphs):
            serve_traffic()             # raises if anything captured

        watcher = eng.warmup()          # armed at warmup exit
        serve_traffic()
        watcher.assert_no_new_captures()
    """

    def __init__(self, *graphs, labels=None, strict=True):
        # weakly: a watcher kept by its caller must not keep a dead
        # replica's engine (its graphs' body holds the engine and its
        # pools) alive; a collected StepGraphs captures nothing more
        self._graphs = [weakref.ref(g) for g in graphs]
        self._labels = list(labels) if labels else \
            [f"graphs{i}" for i in range(len(graphs))]
        self.strict = strict
        self.compile_ms = {}
        self._arm()

    def _live(self):
        """(label, StepGraphs, index) of every watched graphs still
        alive."""
        for i, (lbl, ref) in enumerate(zip(self._labels, self._graphs)):
            g = ref()
            if g is not None:
                yield lbl, g, i

    def _arm(self):
        self._base = [0] * len(self._graphs)
        self._keys = [set() for _ in self._graphs]
        for _lbl, g, i in self._live():
            self._base[i] = g.captures
            self._keys[i] = set(g.capture_ms)

    def new_captures(self):
        """[(label, captures since the window opened)] for every watched
        StepGraphs that captured."""
        return [(lbl, g.captures - self._base[i])
                for lbl, g, i in self._live()
                if g.captures > self._base[i]]

    def new_keys(self):
        """[(label, key)] of every graph captured inside the window."""
        return [(lbl, key) for lbl, g, i in self._live()
                for key in g.capture_ms if key not in self._keys[i]]

    def assert_no_new_captures(self):
        deltas = self.new_captures()
        if deltas:
            detail = ", ".join(f"{lbl}: +{n}" for lbl, n in deltas)
            keys = "; ".join(f"{lbl} {key!r}" for lbl, key in
                             self.new_keys()[-8:])
            raise RecaptureError(
                f"unexpected capture(s) inside guarded window — {detail}. "
                "A step key appeared that warmup() did not capture (a "
                "token bucket past the grid, or a new engine)"
                + (f" New keys: {keys}" if keys else ""))

    def __enter__(self):
        self._arm()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.strict:
            self.assert_no_new_captures()
        return False


# --------------------------------------------------------------------------
# CLI — python -m paddle_tpu_torch.framework.analysis
# --------------------------------------------------------------------------
def _report(findings, out=None, json_out=False, strict=False,
            extra=None):
    """Print findings and return the exit code: 0 = clean (or warnings
    only), 1 = any error-severity finding — or any warning under
    ``strict`` — 2 = usage error (argparse's own).  ``json_out`` emits
    one machine-readable JSON document instead of text; ``extra`` merges
    additional keys into it (the cost subcommand's census)."""
    out = out or sys.stdout
    errors = sum(1 for f in findings if f.severity == ERROR)
    warnings = len(findings) - errors
    if json_out:
        doc = {
            "findings": [
                {"rule": f.rule, "severity": f.severity,
                 "category": f.category, "where": f.where,
                 "message": f.message} for f in findings],
            "errors": errors,
            "warnings": warnings,
        }
        if extra:
            doc.update(extra)
        print(json.dumps(doc, indent=2), file=out)
    else:
        for f in findings:
            print(f.format(), file=out)
        print(f"graph-lint: {errors} error(s), {warnings} warning(s)",
              file=out)
    return 1 if errors or (strict and warnings) else 0


_SPEC_DTYPES = {"f32": torch.float32, "f16": torch.float16,
                "bf16": torch.bfloat16, "f64": torch.float64,
                "i32": torch.int32, "i64": torch.int64, "i8": torch.int8,
                "u8": torch.uint8, "b1": torch.bool}


def _parse_spec(spec, device="cpu"):
    """'f32[2,3]' / 'int32[8]' / 'i32' -> an empty tensor of that shape
    and dtype (traced as a fake: its values are never read)."""
    name, _, dims = spec.partition("[")
    dtype = _SPEC_DTYPES.get(name) or getattr(torch, name)
    shape = tuple(int(d) for d in dims.rstrip("]").split(",") if d) \
        if dims else ()
    return torch.empty(shape, dtype=dtype, device=device)


def _cli_build_engine(ns):
    from ..inference.llm import LLMEngine
    from ..models.gpt import gpt_tiny

    model = gpt_tiny(num_layers=ns.layers, device=ns.device, seed=0)
    model.eval()
    return LLMEngine(model, block_size=ns.block_size,
                     max_batch=ns.max_batch,
                     max_model_len=ns.max_model_len,
                     token_budget=ns.token_budget,
                     tensor_parallel=ns.tp if ns.tp > 1 else None,
                     speculative=ns.spec if ns.spec > 0 else None,
                     quantize=ns.quantize,
                     kv_tier=getattr(ns, "kv_tier", None),
                     # --lora N: N tenant adapters -> N+1 pool slots
                     # (slot 0 is the reserved base identity)
                     lora=(dict(rank=4, max_adapters=ns.lora + 1)
                           if ns.lora else None),
                     device=ns.device)


def _cli_close(eng):
    """Shut a tensor-parallel engine's workers down once its command is
    done (the finalizer would only at the engine's collection)."""
    if eng._tp is not None:
        eng._tp.close()


def _cli_engine(ns):
    eng = _cli_build_engine(ns)
    try:
        eng.warmup()
        findings = analyze_engine(eng, rules=ns.rules)
    finally:
        _cli_close(eng)
    if ns.rules is None or "H001" in ns.rules:
        findings += check_host_sync()
    return findings


def _cli_cost(ns):
    from .cost import run_census
    eng = _cli_build_engine(ns)
    try:
        census = run_census(eng, memory_budget=ns.memory_budget,
                            host_budget=ns.host_budget, profile=ns.profile,
                            max_executables=ns.max_executables)
    finally:
        _cli_close(eng)
    doc = census.to_dict()
    ns._extra = {"census": doc}
    if not ns.json:
        fams = ", ".join(f"{k}: {v}"
                         for k, v in sorted(census.families.items()))
        print(f"census: {census.compile_count} graph(s) — {fams}")
        for e in doc["entries"]:
            c = e["cost"]
            comms = "".join(f"{ax}={b:<10} " for ax, b in
                            c["collective_bytes"].items())
            print(f"  {e['label']:<16} flops={c['flops']:<12} "
                  f"hbm={c['hbm_bytes']:<10} peak={c['peak_bytes']:<10} "
                  f"{comms}{e['roofline']}-bound")
        mem = doc["memory"]
        line = (f"memory/card (tp={mem['tp']}): weights "
                f"{mem['weights_bytes']} + kv pool "
                f"{mem['kv_pool_bytes']} "
                f"({mem['num_blocks']} x {mem['page_bytes']}B pages)")
        if mem.get("lora_pool_bytes"):
            line += (f"; lora adapter pools "
                     f"{mem['lora_pool_bytes']} (counted in weights)")
        if mem.get("memory_budget") is not None:
            line += (f"; budget {mem['memory_budget']} admits "
                     f"max_batch <= {mem.get('derived_max_batch', 0)}")
        if mem.get("host_pool_bytes") or mem.get("prefix_store_bytes"):
            line += (f"; host tier {mem['host_pool_bytes']} pool + "
                     f"{mem['prefix_store_bytes']} store "
                     f"({mem['host_page_bytes']}B/page)")
            if mem.get("host_budget") is not None:
                line += (f" under host budget {mem['host_budget']} "
                         f"({mem.get('host_budget_pages', 0)} pages)")
        print(line)
    return census.findings


def _cli_kernels(ns):
    from .kernel_lint import lint_registry
    eng = _cli_build_engine(ns)
    try:
        return lint_registry(eng, rules=ns.rules, profile=ns.profile)
    finally:
        _cli_close(eng)


def _cli_program(ns):
    from ..static.program_import import (InferenceProgram,
                                         parse_program_blocks)
    # the lint reads the program's ops, feeds and fetches only: the
    # parameters are not read
    with open(f"{ns.path_prefix}.pdmodel", "rb") as f:
        blocks = parse_program_blocks(f.read())
    ops, var_descs = blocks[0]
    prog = InferenceProgram(ops, var_descs, {}, blocks=blocks)
    return analyze_program(prog, rules=ns.rules,
                           label=os.path.basename(ns.path_prefix))


def _cli_ops(ns):
    return check_host_sync(ns.paths or None)


def _cli_threads(ns):
    from .concurrency_lint import check_concurrency
    return check_concurrency(ns.paths or None, rules=ns.rules)


def _cli_fn(ns):
    import importlib
    mod_name, _, attr = ns.target.partition(":")
    fn = getattr(importlib.import_module(mod_name), attr)
    args = [_parse_spec(s) for s in ns.arg]
    return analyze_fn(fn, *args, rules=ns.rules, label=ns.target)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="graph-lint",
        description="Static analysis of the PyTorch port: traced step "
                    "graphs, the serving engine's bucket grid, the "
                    "host-sync sources, the CUDA kernel registry and the "
                    "serving tree's threads (rules D001/S001/T001/G001/"
                    "H001, M001/B001, K001-K005, R001-R005 — see the "
                    "module docstrings of paddle_tpu_torch/framework/)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    # common output flags, valid after every subcommand; exit codes:
    # 0 clean, 1 errors (or warnings under --strict), 2 usage
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--json", action="store_true",
                        help="emit one machine-readable JSON document "
                             "instead of text findings")
    common.add_argument("--strict", action="store_true",
                        help="exit 1 on warnings too, not just errors")
    sub = ap.add_subparsers(dest="cmd", required=True)

    engine_args = argparse.ArgumentParser(add_help=False)
    engine_args.add_argument("--device", default="cuda",
                             help="the engine's device (default cuda; "
                                  "'cpu' runs the plain versions)")
    engine_args.add_argument("--tp", type=int, default=1)
    engine_args.add_argument("--layers", type=int, default=2)
    engine_args.add_argument("--block-size", type=int, default=8)
    engine_args.add_argument("--max-batch", type=int, default=4)
    engine_args.add_argument("--max-model-len", type=int, default=64)
    engine_args.add_argument("--token-budget", type=int, default=16)
    engine_args.add_argument("--spec", type=int, default=0, metavar="K",
                             help="n-gram speculation with K draft "
                                  "tokens (0 = off)")
    engine_args.add_argument("--quantize", default=None,
                             choices=["int8"],
                             help="lint the int8 serving profile (int8 "
                                  "weights and int8 paged KV pool)")
    engine_args.add_argument("--lora", type=int, default=0, metavar="N",
                             help="lint the multi-LoRA serving profile "
                                  "with N adapter slots (rank 4)")

    eng = sub.add_parser("engine", parents=[common, engine_args],
                         help="lint the LLM engine's step graphs")
    eng.set_defaults(run=_cli_engine)

    cost = sub.add_parser(
        "cost", aliases=["census"], parents=[common, engine_args],
        help="static cost census over the engine's bucket grid: FLOPs, "
             "bytes and roofline per bucket, graph count, memory model, "
             "rules M001/B001")
    cost.add_argument("--memory-budget", default=None,
                      help="per-card device-memory budget for M001, "
                           "bytes or '16GiB'")
    cost.add_argument("--host-budget", default=None,
                      help="host-RAM ceiling for the KV tier (M001 names "
                           "both budgets), bytes or '64GiB'")
    cost.add_argument("--kv-tier", default=None,
                      help="configure the engine's host-RAM KV tier: "
                           "total byte budget ('128MiB'), split evenly "
                           "between host pool and prefix store")
    cost.add_argument("--profile", default="h100",
                      help="roofline device profile: h100 | cpu")
    cost.add_argument("--max-executables", type=int, default=64,
                      help="B001 threshold on the census graph count")
    cost.set_defaults(run=_cli_cost)

    kern = sub.add_parser(
        "kernels", parents=[common, engine_args],
        help="Hopper kernel lint: the registry contract and every "
             "kernel's launch plan at the engine's, FMT's, Llama's and "
             "training's shapes (rules K001-K005, "
             "framework/kernel_lint.py)")
    kern.add_argument("--profile", default="h100",
                      help="device profile for the K002 limits")
    kern.set_defaults(run=_cli_kernels)

    prog = sub.add_parser("program", parents=[common],
                          help="G001 over an exported inference program "
                               "(.pdmodel prefix)")
    prog.add_argument("path_prefix")
    prog.set_defaults(run=_cli_program)

    ops = sub.add_parser("ops", parents=[common],
                         help="H001 host-sync lint over the sources")
    ops.add_argument("paths", nargs="*")
    ops.set_defaults(run=_cli_ops)

    thr = sub.add_parser(
        "threads", parents=[common],
        help="concurrency lint over the serving tree: lock discipline, "
             "lock order, blocking-while-locked, lookahead epoch "
             "discipline, stale suppressions (rules R001-R005, "
             "framework/concurrency_lint.py)")
    thr.add_argument("paths", nargs="*",
                     help="files/dirs to sweep (default: inference/llm, "
                          "framework, sim, jit)")
    thr.set_defaults(run=_cli_threads)

    fn = sub.add_parser("fn", parents=[common],
                        help="lint an importable callable: "
                             "module.path:attr")
    fn.add_argument("target")
    fn.add_argument("--arg", action="append", default=[],
                    metavar="SPEC", help="argument, e.g. f32[2,8]")
    fn.set_defaults(run=_cli_fn)

    ns = ap.parse_args(argv)
    ns.rules = tuple(r.strip() for r in ns.rules.split(",")) \
        if ns.rules else None
    ns._extra = None
    return _report(ns.run(ns), json_out=ns.json, strict=ns.strict,
                   extra=ns._extra)


if __name__ == "__main__":
    sys.exit(main())
