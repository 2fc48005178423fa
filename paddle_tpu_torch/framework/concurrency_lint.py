"""Static concurrency lint for the async serving host (R001-R005).

The async lookahead engine made the host loop concurrent-by-construction:
staged plans, epoch bumps, claim/rollback windows, a stepping thread behind
``AsyncLLMEngine`` and transient per-replica threads in ``Fleet``.  The
correctness of all of that rests on a handful of host-side invariants that
the jaxpr/cost/kernel analyses cannot see.  This module closes the gap with
an AST-level corpus analysis over the serving tree, in the same structured
``Finding`` style as :mod:`paddle_tpu.framework.analysis`:

``R001`` lock-discipline
    An attribute that is written under a class's lock anywhere is considered
    *guarded by* that lock; any other read/write of the same attribute that
    holds none of its guarding locks is a finding.  Benign sites are
    annotated with ``# guarded-by: <lock>`` (a caller-holds contract) or
    ``# noqa: R001 (reason)``.

``R002`` lock-order
    A static lock-acquisition graph is built from lexically nested ``with``
    blocks plus calls made while holding a lock (resolved through a
    conservative name-based method->locks fixpoint).  Any cycle is a
    potential deadlock and is reported with the witness path; self-loops are
    reported only for non-reentrant lock kinds (``Lock``,
    ``Condition(Lock())``).

``R003`` blocking-while-locked
    H001-style taint inside a ``with lock:`` scope: ``jax.device_get`` /
    ``block_until_ready``, socket ``recv``/``accept``/``sendall``,
    ``time.sleep``, unbounded ``queue.get``, no-timeout thread ``join``, and
    ``Condition.wait`` on anything other than the (sole) held lock.

``R004`` epoch-discipline
    For classes that define ``_invalidate_plan`` (the lookahead engine):
    every mutation of scheduler / BlockManager / request state reachable
    from a public non-step entry point must also reach an
    ``_invalidate_plan`` call — the exact invariant ``_claim_staged``
    depends on.

``R005`` stale suppressions (WARNING)
    A ``noqa`` / ``noqa-module`` tag (H001 or R-rules) whose rule no longer
    fires at that site is itself reported, so the allowlist cannot rot.

Entry points: :func:`check_concurrency` (library), and the ``threads``
subcommand of ``tools/graph_lint.py`` (CLI; exit codes 0/1/2).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .analysis import Finding, ERROR, WARNING

ALL_RULES = ("R001", "R002", "R003", "R004", "R005")

_NOQA_RE = re.compile(r"#\s*noqa:\s*(R0\d\d|H001)(?:\s*\(([^)]*)\))?")
_NOQA_MODULE_RE = re.compile(r"#\s*noqa-module:\s*(R0\d\d|H001)")
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")

# Lock-constructor spellings we recognise on `self.X = threading.<kind>()`.
_LOCK_KINDS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_REENTRANT_KINDS = {"RLock"}

# Method names that mutate their receiver (for R001 write detection and the
# R004 mutator spec).
_MUTATING_METHODS = {
    "add", "append", "appendleft", "pop", "popleft", "remove", "discard",
    "update", "clear", "insert", "extend", "setdefault", "sort",
}

# R004: methods on scheduler/block-manager receivers that mutate serving
# state visible to a staged plan.
_SCHED_MUTATORS = {
    "add", "abort", "remove_running", "expire_deadlines", "_preempt",
    "preempt", "requeue",
}
_BM_MUTATORS = {
    "free", "allocate", "append_slot", "append_slots", "rollback_slots",
    "fork", "promote_fork", "import_seq", "register_imported",
}

_BLOCKING_SIMPLE = {
    ("jax", "device_get"): "device-sync",
    ("jax", "block_until_ready"): "device-sync",
    ("cuda", "synchronize"): "device-sync",
    ("event", "synchronize"): "device-sync",
    ("stream", "synchronize"): "device-sync",
    ("copied", "synchronize"): "device-sync",
    ("time", "sleep"): "sleep",
}
_SOCKET_METHODS = {"recv", "recvfrom", "accept", "sendall", "recv_into"}


def default_paths() -> List[str]:
    """The serving tree the default sweep covers."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for rel in ("inference/llm", "framework", "sim", "jit"):
        p = os.path.join(pkg, rel)
        if os.path.isdir(p):
            out.append(p)
    return out


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
    return sorted(set(files))


def _dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FileInfo:
    """Parsed file plus annotation tables."""

    def __init__(self, path: str, text: str, tree: ast.Module):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        # line -> set of rules suppressed on that line
        self.noqa: Dict[int, Set[str]] = {}
        # rules suppressed for the whole module (tag line recorded for R005)
        self.noqa_module: Dict[str, int] = {}
        # line -> lock names asserted held at that line (guarded-by)
        self.guarded_by: Dict[int, Set[str]] = {}
        # Only real COMMENT tokens count — a noqa tag spelled inside a
        # docstring or string literal (e.g. in this lint's own messages) is
        # documentation, not an annotation.
        try:
            toks = list(tokenize.generate_tokens(io.StringIO(text).readline))
        except (tokenize.TokenError, IndentationError):
            toks = []
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            comment = tok.string
            for m in _NOQA_RE.finditer(comment):
                self.noqa.setdefault(i, set()).add(m.group(1))
            for m in _GUARDED_BY_RE.finditer(comment):
                self.guarded_by.setdefault(i, set()).add(m.group(1))
            m = _NOQA_MODULE_RE.search(comment)
            if m and i <= 40:
                self.noqa_module.setdefault(m.group(1), i)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.noqa_module:
            return True
        return rule in self.noqa.get(line, set())


class _LockDef:
    def __init__(self, owner: str, attr: str, kind: str, reentrant: bool):
        self.owner = owner          # class name
        self.attr = attr            # attribute name, e.g. "_cond"
        self.kind = kind            # Lock / RLock / Condition / ...
        self.reentrant = reentrant

    @property
    def key(self) -> str:
        return f"{self.owner}.{self.attr}"


class _Access:
    __slots__ = ("fi", "cls", "func", "attr", "is_write", "is_self", "line",
                 "held")

    def __init__(self, fi, cls, func, attr, is_write, is_self, line, held):
        self.fi = fi
        self.cls = cls
        self.func = func
        self.attr = attr
        self.is_write = is_write
        self.is_self = is_self
        self.line = line
        self.held = held            # frozenset of lock attr names held


class _Corpus:
    def __init__(self, files: List[_FileInfo]):
        self.files = files
        # attr name -> list of _LockDef (merged across classes by attr name)
        self.locks_by_attr: Dict[str, List[_LockDef]] = {}
        self.lock_defs: List[_LockDef] = []

    def lock_attr_names(self) -> Set[str]:
        return set(self.locks_by_attr)

    def is_reentrant(self, attr: str) -> bool:
        defs = self.locks_by_attr.get(attr, [])
        return bool(defs) and all(d.reentrant for d in defs)


def _collect_locks(corpus: _Corpus) -> None:
    for fi in corpus.files:
        for node in ast.walk(fi.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                    continue
                tgt = sub.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                call = sub.value
                if not isinstance(call, ast.Call):
                    continue
                fn = _dotted(call.func)
                if fn is None:
                    continue
                base = fn.split(".")[-1]
                if base not in _LOCK_KINDS:
                    continue
                if not (fn.startswith("threading.") or fn == base):
                    continue
                kind = base
                reentrant = base in _REENTRANT_KINDS
                if base == "Condition":
                    # Condition() wraps an RLock (re-entrant); an explicit
                    # Condition(Lock()) is not.
                    reentrant = True
                    if call.args:
                        inner = call.args[0]
                        if isinstance(inner, ast.Call):
                            ifn = _dotted(inner.func) or ""
                            if ifn.split(".")[-1] == "Lock":
                                reentrant = False
                ld = _LockDef(node.name, tgt.attr, kind, reentrant)
                corpus.lock_defs.append(ld)
                corpus.locks_by_attr.setdefault(tgt.attr, []).append(ld)


class _MethodScan(ast.NodeVisitor):
    """Single-method walker tracking the lexically held lock set.

    Produces: attribute accesses (R001), lock-acquisition edges (R002),
    blocking calls under locks (R003), and the method's call/mutation
    summary (R004).
    """

    def __init__(self, fi: _FileInfo, cls: Optional[str], func: str,
                 corpus: _Corpus, base_held: Set[str]):
        self.fi = fi
        self.cls = cls
        self.func = func
        self.corpus = corpus
        self.lock_names = corpus.lock_attr_names()
        self.held: List[str] = list(base_held)   # stack of lock attr names
        self.aliases: Dict[str, str] = {}        # local name -> self-attr
        self.accesses: List[_Access] = []
        # (outer_lock, inner_lock, line) acquisition edges in this method
        self.edges: List[Tuple[str, str, int]] = []
        # locks acquired at top level (held=[base] only) -> for fixpoint
        self.acquired: Set[str] = set()
        # method names called (self.X(...)) with the held-set at call time
        self.calls: List[Tuple[str, Tuple[str, ...], int]] = []
        # R003 candidates: (category, detail, line, held-at-site)
        self.blocking: List[Tuple[str, str, int, Tuple[str, ...]]] = []
        # R004: mutation sites (category, line) and epoch-bump call lines
        self.mutations: List[Tuple[str, int]] = []
        self.bumps: List[int] = []

    # -- held-set helpers ---------------------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        """Map a with-context expression to a known lock attr name."""
        d = _dotted(expr)
        if d is None:
            return None
        if d in self.aliases:
            d = self.aliases[d]
        last = d.split(".")[-1]
        if last in self.lock_names:
            return last
        return None

    def _attr_of(self, expr: ast.AST) -> Optional[Tuple[str, bool]]:
        """(attr name, is_self_access) for a Name/Attribute chain."""
        d = _dotted(expr)
        if d is None:
            return None
        if d in self.aliases:
            d = self.aliases[d]
            return d.split(".")[-1], True
        parts = d.split(".")
        if len(parts) < 2:
            return None
        return parts[-1], parts[0] == "self" and len(parts) == 2

    def _line_guards(self, line: int) -> Set[str]:
        return self.fi.guarded_by.get(line, set())

    def _held_at(self, line: int) -> Set[str]:
        return set(self.held) | self._line_guards(line)

    # -- visitors -----------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested defs/lambdas inherit the current held stack lexically.
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        # Track local aliases:  bm = self.block_manager / lock = self._cond
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)):
            d = _dotted(node.value)
            if d and d.startswith("self.") and d.count(".") == 1:
                self.aliases[node.targets[0].id] = d
        for tgt in node.targets:
            self._record_store(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_store(node.target, aug=True)
        self.visit(node.value)

    def _record_store(self, tgt: ast.AST, aug: bool = False) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._record_store(e)
            return
        node = tgt
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            info = self._attr_of(node)
            if info:
                attr, is_self = info
                self.accesses.append(_Access(
                    self.fi, self.cls, self.func, attr, True, is_self,
                    tgt.lineno, frozenset(self._held_at(tgt.lineno))))
                if attr == "status" or (isinstance(tgt, ast.Subscript)
                                        and attr == "_requests"):
                    self.mutations.append(("request-state", tgt.lineno))
            # reads embedded in the chain (self.a.b = x reads self.a)
            self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            info = self._attr_of(node)
            if info:
                attr, is_self = info
                if attr not in self.lock_names:
                    self.accesses.append(_Access(
                        self.fi, self.cls, self.func, attr, False, is_self,
                        node.lineno, frozenset(self._held_at(node.lineno))))
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            lock = self._resolve_lock(item.context_expr)
            if lock is not None:
                held_now = self._held_at(node.lineno)
                for outer in held_now:
                    self.edges.append((outer, lock, node.lineno))
                if not self.held:
                    self.acquired.add(lock)
                self.held.append(lock)
                entered.append(lock)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        d = _dotted(fn) or ""
        if d.startswith("self."):
            d_res = d
        elif d.split(".")[0] in self.aliases:
            head, *rest = d.split(".")
            d_res = self.aliases[head] + ("." + ".".join(rest) if rest else "")
        else:
            d_res = d
        parts = d_res.split(".")
        held = tuple(sorted(self._held_at(node.lineno)))

        # self.method(...) calls -> call graph
        if len(parts) == 2 and parts[0] == "self":
            self.calls.append((parts[1], held, node.lineno))
            if parts[1] == "_invalidate_plan":
                self.bumps.append(node.lineno)
            # also: acquire via explicit .acquire()
            if parts[1] in self.lock_names:
                pass

        # R004 mutator detection on scheduler / block-manager receivers.
        if len(parts) >= 3 and parts[0] == "self":
            recv, meth = parts[1], parts[-1]
            if recv in ("scheduler", "_scheduler") and meth in _SCHED_MUTATORS:
                self.mutations.append((f"scheduler.{meth}", node.lineno))
            elif recv in ("block_manager", "_block_manager") \
                    and meth in _BM_MUTATORS:
                self.mutations.append((f"block_manager.{meth}", node.lineno))
            elif recv == "_requests" and meth in ("pop", "clear"):
                self.mutations.append(("request-state", node.lineno))
            elif recv == "running" and meth in _MUTATING_METHODS:
                self.mutations.append(("scheduler.running", node.lineno))

        # R001: mutating method on an attribute counts as a write.
        if len(parts) >= 2 and parts[-1] in _MUTATING_METHODS:
            target = ast.parse(".".join(parts[:-1]), mode="eval").body \
                if all(p.isidentifier() for p in parts[:-1]) else None
            if target is not None:
                info = None
                if len(parts) == 3 and parts[0] == "self":
                    info = (parts[1], True)
                elif len(parts) > 3 and parts[0] == "self":
                    info = (parts[1], True)
                elif parts[0] != "self" and len(parts) >= 2:
                    info = (parts[-2] if len(parts) > 2 else parts[0], False) \
                        if parts[0] not in self.aliases else None
                if info and info[0] not in self.lock_names:
                    self.accesses.append(_Access(
                        self.fi, self.cls, self.func, info[0], True, info[1],
                        node.lineno, frozenset(self._held_at(node.lineno))))

        # R003 blocking-call taint while holding any lock.
        if held:
            self._check_blocking(node, d_res, parts, held)

        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call, d: str,
                        parts: List[str], held: Tuple[str, ...]) -> None:
        def kw(name: str) -> Optional[ast.expr]:
            for k in node.keywords:
                if k.arg == name:
                    return k.value
            return None

        tail2 = tuple(parts[-2:]) if len(parts) >= 2 else ()
        if tail2 in _BLOCKING_SIMPLE:
            self.blocking.append(
                (_BLOCKING_SIMPLE[tail2], d, node.lineno, held))
            return
        last = parts[-1] if parts else ""
        recv = ".".join(parts[:-1])
        recv_last = parts[-2] if len(parts) >= 2 else ""
        if last == "block_until_ready" and parts[:1] != ["jax"]:
            self.blocking.append(("device-sync", d, node.lineno, held))
        elif last == "sleep" and recv_last not in ("_clock", "clock"):
            # time.sleep caught above; any bare/other .sleep under a lock is
            # still a stall unless it is the injected clock (virtualisable).
            if d in ("sleep",) or recv_last in ("time",):
                self.blocking.append(("sleep", d, node.lineno, held))
        elif last in _SOCKET_METHODS:
            self.blocking.append(("socket", d, node.lineno, held))
        elif last == "get" and ("queue" in recv_last.lower()
                                or recv_last in ("q", "_q", "inbox",
                                                 "_inbox")):
            if kw("timeout") is None and kw("block") is None:
                self.blocking.append(("queue-get", d, node.lineno, held))
        elif last == "join" and "thread" in recv_last.lower():
            if kw("timeout") is None and not node.args:
                self.blocking.append(("thread-join", d, node.lineno, held))
        elif last in ("wait", "wait_for"):
            # Waiting on the sole held condition releases it (correct CV
            # usage).  Waiting while other locks are held, or on something
            # that is not a held lock, stalls every other holder.
            resolved = recv
            head = parts[0]
            if head in self.aliases:
                resolved = self.aliases[head] + (
                    "." + ".".join(parts[1:-1]) if len(parts) > 2 else "")
            rl = resolved.split(".")[-1]
            if rl in held and len(held) == 1:
                return
            if rl in self.lock_names or rl in held:
                self.blocking.append(("cond-wait", d, node.lineno, held))


class _MethodInfo:
    def __init__(self, scan: _MethodScan):
        self.scan = scan
        self.cls = scan.cls
        self.func = scan.func
        self.fi = scan.fi


def _scan_corpus(corpus: _Corpus) -> List[_MethodInfo]:
    methods: List[_MethodInfo] = []
    for fi in corpus.files:
        for node in ast.walk(fi.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                base_held: Set[str] = set()
                # guarded-by on the def line = caller-holds contract for the
                # whole method body.
                for ln in range(item.lineno,
                               min(item.lineno + 2, item.body[0].lineno + 1)):
                    base_held |= fi.guarded_by.get(ln, set())
                scan = _MethodScan(fi, node.name, item.name, corpus,
                                   base_held)
                for stmt in item.body:
                    scan.visit(stmt)
                methods.append(_MethodInfo(scan))
    return methods


# ---------------------------------------------------------------------------
# R001 lock-discipline
# ---------------------------------------------------------------------------

def _check_r001(corpus: _Corpus, methods: List[_MethodInfo],
                findings: List[Finding],
                fired: Dict[str, List[Tuple[str, int]]]) -> None:
    # Pass 1: guard table.  attr -> {owner-class -> set(locks)} from write
    # sites under a lock (outside __init__).
    guards: Dict[str, Dict[str, Set[str]]] = {}
    for mi in methods:
        if mi.func == "__init__":
            continue
        for acc in mi.scan.accesses:
            if acc.is_write and acc.held and acc.is_self and acc.cls:
                g = guards.setdefault(acc.attr, {})
                g.setdefault(acc.cls, set()).update(acc.held)

    # Pass 2: every access outside __init__ must hold one guarding lock.
    for mi in methods:
        if mi.func == "__init__":
            continue
        for acc in mi.scan.accesses:
            g = guards.get(acc.attr)
            if not g:
                continue
            if acc.is_self:
                locks = g.get(acc.cls or "", set())
            else:
                locks = set()
                for s in g.values():
                    locks |= s
            if not locks:
                continue
            if acc.held & locks:
                continue
            kind = "unguarded-write" if acc.is_write else "unguarded-read"
            where = f"{os.path.basename(acc.fi.path)}:{acc.line} " \
                    f"{acc.cls}.{acc.func}"
            fired.setdefault(acc.fi.path, []).append(("R001", acc.line))
            if acc.fi.suppressed("R001", acc.line):
                continue
            findings.append(Finding(
                "R001", ERROR, where,
                f"attribute '{acc.attr}' is guarded by "
                f"{sorted(locks)} elsewhere but accessed here without any "
                f"of them (add the lock, a '# guarded-by: <lock>' contract, "
                f"or '# noqa: R001 (reason)')",
                category=kind))


# ---------------------------------------------------------------------------
# R002 lock-order
# ---------------------------------------------------------------------------

def _check_r002(corpus: _Corpus, methods: List[_MethodInfo],
                findings: List[Finding],
                fired: Dict[str, List[Tuple[str, int]]]) -> None:
    # Name-based method -> acquired-locks fixpoint (merged across classes —
    # conservative, matches how the engine calls through `self`).
    acq: Dict[str, Set[str]] = {}
    calls: Dict[str, Set[str]] = {}
    for mi in methods:
        acq.setdefault(mi.func, set()).update(mi.scan.acquired)
        calls.setdefault(mi.func, set()).update(
            c for c, _held, _ln in mi.scan.calls)
    changed = True
    while changed:
        changed = False
        for fn, callees in calls.items():
            for c in callees:
                extra = acq.get(c, set()) - acq.get(fn, set())
                if extra:
                    acq.setdefault(fn, set()).update(extra)
                    changed = True

    # Edge set: lexical with-nesting edges + (held-lock -> callee-acquired).
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for mi in methods:
        where = f"{os.path.basename(mi.fi.path)}"
        for outer, inner, ln in mi.scan.edges:
            if outer != inner:
                edges.setdefault((outer, inner),
                                 (mi.fi.path, ln,
                                  f"{mi.cls}.{mi.func}"))
            elif not corpus.is_reentrant(outer):
                key = (outer, outer)
                fired.setdefault(mi.fi.path, []).append(("R002", ln))
                if mi.fi.suppressed("R002", ln):
                    continue
                findings.append(Finding(
                    "R002", ERROR,
                    f"{os.path.basename(mi.fi.path)}:{ln} "
                    f"{mi.cls}.{mi.func}",
                    f"re-entrant acquisition of non-reentrant lock "
                    f"'{outer}' (self-deadlock)",
                    category="self-reentrancy"))
        for callee, held, ln in mi.scan.calls:
            for inner in acq.get(callee, set()):
                for outer in held:
                    if outer == inner:
                        if not corpus.is_reentrant(outer):
                            fired.setdefault(mi.fi.path, []).append(
                                ("R002", ln))
                            if mi.fi.suppressed("R002", ln):
                                continue
                            findings.append(Finding(
                                "R002", ERROR,
                                f"{os.path.basename(mi.fi.path)}:{ln} "
                                f"{mi.cls}.{mi.func}",
                                f"'{mi.func}' holds non-reentrant lock "
                                f"'{outer}' while calling '{callee}' which "
                                f"re-acquires it (self-deadlock)",
                                category="self-reentrancy"))
                    else:
                        edges.setdefault(
                            (outer, inner),
                            (mi.fi.path, ln,
                             f"{mi.cls}.{mi.func} -> {callee}"))

    # Cycle detection over the edge graph.
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = path + [start]
                canon = tuple(sorted(cyc[:-1]))
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                fpath, ln, ctx = edges[(path[-1], start)]
                rel = os.path.basename(fpath)
                for fi in corpus.files:
                    if fi.path == fpath:
                        fired.setdefault(fpath, []).append(("R002", ln))
                        if fi.suppressed("R002", ln):
                            return
                findings.append(Finding(
                    "R002", ERROR, f"{rel}:{ln} {ctx}",
                    "lock-order cycle (potential deadlock): "
                    + " -> ".join(cyc),
                    category="lock-cycle"))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])


# ---------------------------------------------------------------------------
# R003 blocking-while-locked
# ---------------------------------------------------------------------------

def _check_r003(corpus: _Corpus, methods: List[_MethodInfo],
                findings: List[Finding],
                fired: Dict[str, List[Tuple[str, int]]]) -> None:
    for mi in methods:
        for cat, detail, ln, held in mi.scan.blocking:
            fired.setdefault(mi.fi.path, []).append(("R003", ln))
            if mi.fi.suppressed("R003", ln):
                continue
            findings.append(Finding(
                "R003", ERROR,
                f"{os.path.basename(mi.fi.path)}:{ln} {mi.cls}.{mi.func}",
                f"blocking call '{detail}' ({cat}) while holding "
                f"{sorted(held)} — stalls every other thread contending "
                f"for the lock",
                category=cat))


# ---------------------------------------------------------------------------
# R004 epoch-discipline
# ---------------------------------------------------------------------------

_R004_EXEMPT_ENTRIES = {"step", "warmup", "generate", "close"}


def _check_r004(corpus: _Corpus, methods: List[_MethodInfo],
                findings: List[Finding],
                fired: Dict[str, List[Tuple[str, int]]]) -> None:
    # Group methods by class; only classes defining _invalidate_plan apply.
    by_class: Dict[Tuple[str, str], Dict[str, _MethodInfo]] = {}
    for mi in methods:
        if mi.cls:
            by_class.setdefault((mi.fi.path, mi.cls), {})[mi.func] = mi
    for (path, cls), meths in by_class.items():
        if "_invalidate_plan" not in meths:
            continue
        fi = meths["_invalidate_plan"].fi

        def reach(entry: str) -> Tuple[Set[str], bool, List[Tuple[str, int]]]:
            """Transitively reachable methods, whether a bump is reachable,
            and the mutation sites seen."""
            seen: Set[str] = set()
            stack = [entry]
            bumped = False
            muts: List[Tuple[str, int]] = []
            while stack:
                fn = stack.pop()
                if fn in seen or fn not in meths:
                    continue
                seen.add(fn)
                mi2 = meths[fn]
                if mi2.scan.bumps:
                    bumped = True
                muts.extend(mi2.scan.mutations)
                for callee, _held, _ln in mi2.scan.calls:
                    stack.append(callee)
            return seen, bumped, muts

        for name, mi in sorted(meths.items()):
            if name.startswith("_") or name in _R004_EXEMPT_ENTRIES:
                continue
            _seen, bumped, muts = reach(name)
            if muts and not bumped:
                ln = min(ln for _c, ln in muts)
                # anchor suppression at the entry's def line
                def_ln = None
                for node in ast.walk(fi.tree):
                    if isinstance(node, ast.FunctionDef) \
                            and node.name == name:
                        def_ln = node.lineno
                        break
                fired.setdefault(path, []).append(("R004", def_ln or ln))
                if def_ln and fi.suppressed("R004", def_ln):
                    continue
                cats = sorted({c for c, _ln in muts})
                findings.append(Finding(
                    "R004", ERROR,
                    f"{os.path.basename(path)}:{def_ln or ln} {cls}.{name}",
                    f"entry point '{name}' mutates serving state "
                    f"({', '.join(cats)}) without reaching "
                    f"_invalidate_plan() — a staged lookahead plan can be "
                    f"claimed against stale state",
                    category="missing-epoch-bump"))


# ---------------------------------------------------------------------------
# R005 stale suppressions
# ---------------------------------------------------------------------------

def _check_r005(corpus: _Corpus,
                fired: Dict[str, List[Tuple[str, int]]],
                findings: List[Finding]) -> None:
    from . import analysis as _an
    for fi in corpus.files:
        fired_here = fired.get(fi.path, [])
        h001_lines: Set[int] = set()
        has_h001_tags = any("H001" in rules for rules in fi.noqa.values()) \
            or "H001" in fi.noqa_module
        if has_h001_tags:
            try:
                for site in _an.collect_host_sync_sites([fi.path]):
                    h001_lines.add(site.line)
            except Exception:
                h001_lines = set()

        def rule_fired(rule: str, line: Optional[int]) -> bool:
            if rule == "H001":
                if line is None:
                    return bool(h001_lines)
                return line in h001_lines
            if line is None:
                return any(r == rule for r, _ln in fired_here)
            return any(r == rule and ln == line for r, ln in fired_here)

        for line, rules in sorted(fi.noqa.items()):
            for rule in sorted(rules):
                if not rule_fired(rule, line):
                    findings.append(Finding(
                        "R005", WARNING,
                        f"{os.path.basename(fi.path)}:{line}",
                        f"stale suppression: '# noqa: {rule}' but {rule} "
                        f"no longer fires at this line — remove the tag",
                        category="stale-noqa"))
        for rule, line in sorted(fi.noqa_module.items()):
            if not rule_fired(rule, None):
                findings.append(Finding(
                    "R005", WARNING,
                    f"{os.path.basename(fi.path)}:{line}",
                    f"stale suppression: '# noqa-module: {rule}' but "
                    f"{rule} fires nowhere in this module — remove the "
                    f"tag",
                    category="stale-noqa-module"))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def check_concurrency(paths: Optional[Sequence[str]] = None,
                      rules: Optional[Sequence[str]] = None
                      ) -> List[Finding]:
    """Run the concurrency rules over *paths* (default: the serving tree).

    Returns structured :class:`Finding` objects; empty list = clean sweep.
    """
    if paths is None:
        paths = default_paths()
    want = set(rules) if rules else set(ALL_RULES)
    files: List[_FileInfo] = []
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            tree = ast.parse(text, filename=path)
        except (OSError, SyntaxError) as e:
            findings.append(Finding(
                "R000", WARNING, os.path.basename(path),
                f"could not parse: {e}", category="parse-error"))
            continue
        files.append(_FileInfo(path, text, tree))

    corpus = _Corpus(files)
    _collect_locks(corpus)
    methods = _scan_corpus(corpus)

    # fired: path -> [(rule, line)] including suppressed hits (for R005).
    fired: Dict[str, List[Tuple[str, int]]] = {}
    if "R001" in want or "R005" in want:
        pre = [] if "R001" not in want else findings
        _check_r001(corpus, methods, pre, fired)
    if "R002" in want or "R005" in want:
        pre = [] if "R002" not in want else findings
        _check_r002(corpus, methods, pre, fired)
    if "R003" in want or "R005" in want:
        pre = [] if "R003" not in want else findings
        _check_r003(corpus, methods, pre, fired)
    if "R004" in want or "R005" in want:
        pre = [] if "R004" not in want else findings
        _check_r004(corpus, methods, pre, fired)
    if "R005" in want:
        _check_r005(corpus, fired, findings)
    findings.sort(key=lambda f: (f.rule, f.where))
    return findings
