"""dy2static — AST conversion of python control flow on tensor values.

Reference: python/paddle/jit/dy2static/ (20 AST transformers rewriting
``if``/``while``/``for`` into conditional_block/while ops via runtime
``convert_ifelse``/``convert_while_loop`` helpers).

Port of ``paddle_tpu/jit/dy2static.py``.  The AST pass is host Python
and is the JAX package's text; only the tracer test and the tensor
helpers change.  The pass rewrites ``if``/``while`` statements into
calls to the runtime converters below; the converters check the
condition at RUN time — a plain python value falls through to ordinary
python control flow (zero behavior change), a Tensor traced by
``jit.to_static`` (an FX trace, ``framework.mode.is_traced``)
dispatches to ``static.nn.cond`` / ``while_loop`` (``torch.cond`` /
``torch._higher_order_ops.while_loop``, the counterparts of
``lax.cond`` / ``lax.while_loop``) so the branch lands in the graph
instead of hitting the trace guard.

Rewrite shape (the reference's convert_ifelse pattern):

    if t.sum() > 0:          def __d2s_true_1(x, y):
        x = x + 1                x = x + 1
    else:                        return (x, y)
        y = x * 2     ==>    def __d2s_false_1(x, y):
                                 y = x * 2
                                 return (x, y)
                             (x, y) = __d2t_convert_ifelse(
                                 t.sum() > 0, __d2s_true_1, __d2s_false_1,
                                 (__d2t_get('x'), __d2t_get('y')))

Assigned names become branch-function parameters seeded from the call
site (``__d2t_get`` reads the caller's frame; missing names seed the
``_UNDEF`` sentinel so one-branch definitions still work on the python
path and raise a clear error if a compiled path leaves them unset).

Supported beyond plain if/while (reference loop_transformer.py,
return_transformer.py, break_continue_transformer.py semantics):

- ``return`` inside converted ``if`` blocks: early returns are
  canonicalized into if/else tail form (statements after a returning
  ``if`` move into its else-continuation), then both-return ifs lower
  to a value-returning ``lax.cond``.  A ``return`` whose branch only
  *sometimes* returns is left for the trace guard.
- ``return`` under a loop: rewritten into a carried (flag, value) pair
  + break, with a post-loop ``if flag: return value`` that the
  canonicalizer folds.  Exact on python-native loops; a
  tensor-converted loop raises an actionable error (the return value
  has no statically-shaped pre-loop form).  Returns under With/Try
  decline (unwind semantics).
- ``break``/``continue`` in ``while``/``for``: eliminated into flag
  variables + guard-ifs (the reference's break_continue_transformer
  rewrite); the loop test conjoins ``not brk``, so the flag rides the
  compiled ``lax.while_loop`` carry.
- ``for x in tensor``: lowered to an index-carried ``while_loop`` over
  the leading axis (python iterables keep the native loop); the loop
  variable's post-loop value is carried (python scoping parity).
- tuple for-targets (``for a, b in ...``, nesting included): the
  element names join the carried set and bind by unpacking each
  element; flat tuples also convert on the tensor path (seeded from the
  first row), nested patterns stay native-only.
- closures with free variables: the converted clone's code re-binds to
  the ORIGINAL cells, so nonlocal reads and writes stay live in both
  directions.

- ``while/for ... else``: converts — the else suite hoists after the
  loop, guarded on the carried break flag when a break exists (python
  semantics: else runs iff no break; exceeds the reference, whose
  loop_transformer has no orelse handling).
- ``yield``: a generator ENTRY POINT declines at decoration time with
  an actionable error (a compiled graph has one static output
  structure); generator helpers inside a compiled function run
  natively as iterables.

Conversion failure of any kind falls back to the original function.
"""

import ast
import functools
import inspect
import sys
import textwrap

__all__ = ["convert_ifelse", "convert_while", "convert_for",
           "convert_ifelse_ret", "ast_transform"]


class _Undefined:
    """Poison sentinel: ANY use raises, mirroring python's
    UnboundLocalError-on-read for a name assigned in an untaken branch."""

    __slots__ = ()

    def _explode(self, *a, **k):
        raise NameError(
            "variable assigned only inside an untaken to_static branch "
            "was used before assignment (dy2static)")

    __bool__ = __getattr__ = __call__ = __iter__ = __len__ = _explode
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _explode
    __truediv__ = __rtruediv__ = __eq__ = __lt__ = __gt__ = _explode
    __getitem__ = __neg__ = __abs__ = _explode
    __repr__ = __str__ = __format__ = _explode  # no silent leak via print


_UNDEF = _Undefined()


def _noret():
    """Pre-loop seed for a loop-carried return value: the poison makes a
    traced-loop conversion fail with the actionable _undef_loop_msg
    instead of a shape error, and is never read on the python path."""
    return _UNDEF


def _select_outputs(fn, values, keep):
    out = fn(*values)
    seq = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(o for i, o in enumerate(seq) if i in keep)


def _frame_get(name):
    """Call-site seed: the converted function's local, or _UNDEF."""
    frame = sys._getframe(1)
    return frame.f_locals.get(name, _UNDEF)


def _is_traced_bool(pred):
    from ..framework.mode import is_traced

    return is_traced(pred)


def convert_ifelse(pred, true_fn, false_fn, both, values):
    """Runtime dispatch for a rewritten ``if``.

    Python bool → run ONE branch natively (exact eager semantics, tape
    autograd included; a name assigned only in the untaken branch binds
    the poison sentinel, which raises on first use — UnboundLocalError
    parity).

    Traced Tensor → both branches trace into lax.cond.  ``both`` marks
    (by position) names assigned in BOTH branches: those, plus names
    with a defined seed, are cond outputs; a name with an _UNDEF seed
    assigned in only one branch cannot cross lax.cond (the other path
    has no value of matching type) — it binds the poison instead, so
    dead branch-local temporaries are fine and a genuine read raises.
    """
    if not _is_traced_bool(pred):
        return true_fn(*values) if bool(pred) else false_fn(*values)
    from ..static import nn as static_nn

    keep = [i for i, v in enumerate(values)
            if i in both or v is not _UNDEF]
    keep_set = set(keep)
    outs = static_nn.cond(
        pred,
        lambda: _select_outputs(true_fn, values, keep_set),
        lambda: _select_outputs(false_fn, values, keep_set))
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    full = []
    k = 0
    for i in range(len(values)):
        if i in keep_set:
            full.append(outs[k])
            k += 1
        else:
            full.append(_UNDEF)
    return tuple(full)


def convert_while(test_fn, body_fn, names, values):
    """Runtime dispatch for a rewritten ``while``.

    Python-bool tests loop natively; a traced test lowers to
    lax.while_loop (loop-invariant shapes required)."""
    first = test_fn(*values)
    if not _is_traced_bool(first):
        while bool(first):
            values = body_fn(*values)
            first = test_fn(*values)
        return tuple(values)
    from ..static import nn as static_nn

    values = _seed_inner_flags(names, values)
    for name, v in zip(names, values):
        if v is _UNDEF:
            raise NameError(_undef_loop_msg(name, "while"))
    return tuple(static_nn.while_loop(
        lambda *vs: test_fn(*vs), lambda *vs: tuple(body_fn(*vs)),
        list(values)))


def _seed_inner_flags(names, values):
    """A nested loop's break/continue flag is initialized INSIDE this
    loop's body (write-before-read by _rewrite_bc construction), so an
    _UNDEF pre-loop slot is dead — seed it False to keep the carry
    structure instead of raising the user-variable error."""
    return tuple(False if (v is _UNDEF
                           and (n.startswith("_d2s_brk")
                                or n.startswith("_d2s_cont")))
                 else v for n, v in zip(names, values))


def _undef_loop_msg(name, kind):
    if name.startswith("_d2s_retv"):
        return (
            f"`return` inside a tensor-converted {kind} loop cannot be "
            "compiled: the return value has no statically-shaped "
            "pre-loop form.  Assign a result variable in the loop and "
            "return it after the loop instead.")
    return (f"loop variable {name!r} is used in a compiled (tensor-"
            f"{'condition' if kind == 'while' else 'iterable'}) {kind} "
            "before assignment; initialize it before the loop")


def convert_ifelse_ret(pred, true_fn, false_fn, values):
    """Value-returning ``if``: both branches END in return (after
    canonicalization).  Python bool → one branch runs; traced → both
    trace into lax.cond, whose branches must return matching
    shapes/dtypes (lax raises a structure error otherwise — same
    restriction the reference places on static return_transformer
    outputs).  ``values`` seed the names assigned within the branches
    (reads of outer locals resolve by closure)."""
    if not _is_traced_bool(pred):
        return true_fn(*values) if bool(pred) else false_fn(*values)
    from ..static import nn as static_nn

    return static_nn.cond(pred, lambda: true_fn(*values),
                          lambda: false_fn(*values))


def _is_tensorish(v):
    import torch

    from ..core.tensor import Tensor

    return isinstance(v, (Tensor, torch.Tensor))


def _as_torch(v):
    from ..static import _tensorize

    return _tensorize(v)


def d2s_not(v):
    """``not`` that stays traceable: logical_not for tensors."""
    if not _is_tensorish(v):
        return not v
    import torch

    from ..core.tensor import Tensor, _wrap

    out = torch.logical_not(_as_torch(v))
    return _wrap(out) if isinstance(v, Tensor) else out


def d2s_or(a, b):
    """Eager-argument logical or (flag combination — both args cheap)."""
    if not _is_tensorish(a) and not _is_tensorish(b):
        return a or b
    import torch

    from ..core.tensor import _wrap

    return _wrap(torch.logical_or(_as_torch(a), _as_torch(b)))


def d2s_and_lazy(a, b_thunk):
    """``a and b`` with python short-circuit preserved on the python
    path; tensor path evaluates both and combines (pure, so safe)."""
    if not _is_tensorish(a):
        return b_thunk() if bool(a) else False
    import torch

    from ..core.tensor import _wrap

    b = b_thunk()
    return _wrap(torch.logical_and(_as_torch(a), _as_torch(b)))


def convert_for(it, body_fn, names, values, brk_name=None, elt_spec=()):
    """Runtime dispatch for a rewritten ``for TARGET in it``.

    ``body_fn(x, *values) -> (x, *values)`` (the loop variable is carried
    so its post-loop value matches python scoping; tuple targets carry
    their element NAMES inside ``values`` and bind them by unpacking x at
    body start).  Python iterables run the native loop (honoring a break
    flag with a REAL break); tensor/array iterables lower to an
    index-carried while_loop over the leading axis — ragged early exit
    rides the ``brk`` flag in the test.  ``elt_spec`` maps flat tuple-
    target names to element positions so the traced path can seed their
    carried slots from the first row.  Returns ``(*values, x_last)``;
    ``x_last`` is ``_UNDEF`` for an empty python iterable (python's
    unbound-after-empty-loop parity).
    """
    brk_idx = names.index(brk_name) if brk_name else None
    if not _is_tensorish(it):
        x_last = _UNDEF
        for x in it:
            out = body_fn(x, *values)
            x_last, values = out[0], tuple(out[1:])
            if brk_idx is not None and bool(values[brk_idx]):
                break
        return (*values, x_last)

    from ..core.tensor import Tensor, _wrap
    from ..static import nn as static_nn

    tens_seed = it if isinstance(it, Tensor) else _wrap(it)
    elt_names = {n for n, _ in elt_spec}
    values = list(values)
    if len(tens_seed.shape) and int(tens_seed.shape[0]) > 0:
        # seed element slots UNCONDITIONALLY: the unpack assign is the
        # first body statement, so any pre-loop value is dead — but a
        # differently-shaped one would poison the while carry structure
        for n, i in elt_spec:
            values[names.index(n)] = tens_seed[0][i]
    values = list(_seed_inner_flags(names, values))
    for name, v in zip(names, values):
        if v is _UNDEF and name not in elt_names:
            raise NameError(_undef_loop_msg(name, "for"))
    values = tuple(values)
    tens = tens_seed
    n = int(tens.shape[0])  # static leading axis (a graph's shapes)
    if n == 0:
        return (*values, _UNDEF)

    import torch

    dev = tens._data.device

    def test(i, x, *vals):
        ok = _wrap(torch.ones((), dtype=torch.bool, device=dev)) \
            if brk_idx is None else d2s_not(vals[brk_idx])
        return d2s_and_lazy(i < n, lambda: ok)

    def body(i, x, *vals):
        # row i by index_select: a traced index has no host value
        row = torch.index_select(tens._data, 0,
                                 _as_torch(i).reshape(1).long())[0]
        out = body_fn(_wrap(row), *vals)
        return (i + 1, out[0], *out[1:])

    i0 = _wrap(torch.zeros((), dtype=torch.int32, device=dev))
    out = static_nn.while_loop(test, body, [i0, tens[0], *values])
    return (*out[2:], out[1])


# ----------------------------------------------------- return canonical ----

class _Unsupported(Exception):
    """A return pattern the canonicalizer can't restructure — the caller
    skips return handling and leaves those ifs for the trace guard."""


class _ReturnFinder(ast.NodeVisitor):
    def __init__(self):
        self.found = False

    def visit_Return(self, node):
        self.found = True

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_Lambda = visit_ClassDef = \
        visit_FunctionDef


def _contains_return(stmts):
    v = _ReturnFinder()
    for s in stmts:
        v.visit(s)
    return v.found


def _always_returns(stmts):
    """True when every path through ``stmts`` ends in a return."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return _always_returns(last.body) and _always_returns(last.orelse)
    return False


def _canonicalize_returns(stmts):
    """Restructure so every return is a trailing statement or inside an If
    both of whose branches always return (statements after a returning If
    fold into its continuation branch — the reference return_transformer's
    early-return elimination).  Raises _Unsupported for partial-return
    branches and returns under loops/try/with."""
    out = []
    for idx, s in enumerate(stmts):
        rest = stmts[idx + 1:]
        if isinstance(s, (ast.While, ast.For, ast.Try, ast.With)) \
                and _contains_return([s]):
            raise _Unsupported
        if isinstance(s, ast.If) and _contains_return([s]):
            b_ret = _contains_return(s.body)
            o_ret = _contains_return(s.orelse)
            if b_ret and not _always_returns(s.body):
                raise _Unsupported
            if o_ret and not _always_returns(s.orelse):
                raise _Unsupported
            if b_ret and o_ret:
                s.body = _canonicalize_returns(s.body)
                s.orelse = _canonicalize_returns(s.orelse)
                out.append(s)
                return out  # rest is unreachable
            if b_ret:
                s.body = _canonicalize_returns(s.body)
                s.orelse = _canonicalize_returns(list(s.orelse) + rest)
            else:
                s.orelse = _canonicalize_returns(s.orelse)
                s.body = _canonicalize_returns(list(s.body) + rest)
            out.append(s)
            return out
        out.append(s)
    return out


# ---------------------------------------------------- return under loop ----

def _returns_convertible(stmts):
    """Pre-scan: False when any this-level return sits under With/Try
    (unwind semantics the flag rewrite can't model).  MUST run before
    any mutation — a partial rewrite that then declines would leave a
    return silently turned into a bare break."""
    for s in stmts:
        if isinstance(s, (ast.With, ast.Try)) and _contains_return([s]):
            return False
        if isinstance(s, ast.If):
            if not _returns_convertible(s.body) or \
                    not _returns_convertible(s.orelse):
                return False
    return True


def _replace_returns(stmts, flag, val):
    """Rewrite this-level ``return X`` into ``val = X; flag = True;
    break`` (the break rides the existing flag machinery).  Recurses into
    If branches only — nested loops were already cleansed by the
    post-order visit, and nested defs keep their own returns.  Callers
    gate on :func:`_returns_convertible` first."""
    out = []
    for s in stmts:
        if isinstance(s, ast.Return):
            v = s.value if s.value is not None else ast.Constant(value=None)
            out.append(ast.Assign(
                targets=[ast.Name(id=val, ctx=ast.Store())], value=v))
            out.append(_assign_flag(flag, True))
            out.append(ast.Break())
            break  # anything after a return is unreachable
        if isinstance(s, ast.If):
            s.body = _replace_returns(s.body, flag, val)
            s.orelse = _replace_returns(s.orelse, flag, val)
        out.append(s)
    return out


class _ReturnInLoopTransformer(ast.NodeTransformer):
    """``return`` under a loop -> carried (flag, value) + break + a
    post-loop ``if flag: return value`` that the canonicalizer then
    folds (the reference return_transformer's loop case).  Post-order,
    so inner loops hand their returns outward level by level."""

    def __init__(self):
        self.counter = 0
        self.changed = False

    def _handle(self, node):
        self.generic_visit(node)
        if node.orelse or not _contains_return(node.body):
            return node
        if not _returns_convertible(node.body):
            return node
        self.counter += 1
        flag = f"_d2s_retf{self.counter}"
        val = f"_d2s_retv{self.counter}"
        node.body = _replace_returns(node.body, flag, val)
        self.changed = True
        return [
            _assign_flag(flag, False),
            ast.Assign(targets=[ast.Name(id=val, ctx=ast.Store())],
                       value=ast.Call(
                           func=ast.Name(id="__d2t_noret", ctx=ast.Load()),
                           args=[], keywords=[])),
            node,
            ast.If(test=ast.Name(id=flag, ctx=ast.Load()),
                   body=[ast.Return(value=ast.Name(id=val,
                                                   ctx=ast.Load()))],
                   orelse=[]),
        ]

    visit_For = visit_While = _handle
    # nested defs are visited too: each def's loop-returns resolve to a
    # post-loop if-return INSIDE that def — independent and correct


# ------------------------------------------------- break/continue flags ----

class _BreakContinueFinder(ast.NodeVisitor):
    """break/continue belonging to THIS loop level (not nested loops)."""

    def __init__(self):
        self.has_break = False
        self.has_continue = False

    def visit_Break(self, node):
        self.has_break = True

    def visit_Continue(self, node):
        self.has_continue = True

    def visit_While(self, node):
        pass

    visit_For = visit_FunctionDef = visit_AsyncFunctionDef = visit_While
    visit_Lambda = visit_ClassDef = visit_While


def _find_bc(stmts):
    v = _BreakContinueFinder()
    for s in stmts:
        v.visit(s)
    return v.has_break, v.has_continue


def _assign_flag(name, value):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=ast.Constant(value=value))


def _flag_expr(brk, cont):
    names = [n for n in (brk, cont) if n]
    if len(names) == 1:
        return ast.Name(id=names[0], ctx=ast.Load())
    return ast.Call(func=ast.Name(id="__d2t_or", ctx=ast.Load()),
                    args=[ast.Name(id=names[0], ctx=ast.Load()),
                          ast.Name(id=names[1], ctx=ast.Load())],
                    keywords=[])


def _guard_rewrite(stmts, brk, cont):
    """Replace this-level break/continue with flag sets and wrap every
    statement suffix following a may-escape statement in
    ``if not (brk or cont):`` (the reference break_continue_transformer
    rewrite, targeting tensor-traceable guard ifs)."""
    out = []
    for i, s in enumerate(stmts):
        b, c = _find_bc([s])
        if isinstance(s, ast.Break):
            out.append(_assign_flag(brk, True))
        elif isinstance(s, ast.Continue):
            out.append(_assign_flag(cont, True))
        elif isinstance(s, ast.If) and (b or c):
            s.body = _guard_rewrite(s.body, brk, cont)
            s.orelse = _guard_rewrite(s.orelse, brk, cont)
            out.append(s)
        else:
            out.append(s)
            continue
        rest = _guard_rewrite(stmts[i + 1:], brk, cont)
        if rest:
            guard = ast.If(
                test=ast.Call(func=ast.Name(id="__d2t_not", ctx=ast.Load()),
                              args=[_flag_expr(brk if b else None,
                                               cont if c else None)
                                    if (b != c) else _flag_expr(brk, cont)],
                              keywords=[]),
                body=rest, orelse=[])
            out.append(guard)
        return out
    return out


class _LoopEscapeTransformer(ast.NodeTransformer):
    """Eliminate break/continue into carried flag variables (post-order:
    innermost loops first).  Flags are named ``_d2s_*`` (single
    underscore) so the control-flow transformer carries them through
    cond/while outputs like user variables."""

    def __init__(self):
        self.counter = 0
        self.changed = False

    def _fresh(self, hint):
        self.counter += 1
        return f"_d2s_{hint}{self.counter}"

    def _declines(self, node, is_for):
        """Decline cases shared by b/c elimination and else-hoisting:
        a loop the control-flow transformer will NOT convert must keep
        its native form."""
        if _has_escape_sans_bc(node.body):
            return True
        if is_for and not _for_target_names(node.target):
            return True
        if not is_for and any(isinstance(n, ast.NamedExpr)
                              for n in ast.walk(node.test)):
            return True
        return False

    def _handle_loop(self, node, is_for):
        self.generic_visit(node)
        has_b, has_c = _find_bc(node.body)
        if node.orelse:
            # python loop-else: the else suite runs iff the loop exits
            # WITHOUT break.  No break -> hoist it after the loop
            # unconditionally; with break -> guard it on the carried
            # flag.  (The reference's loop_transformer has no orelse
            # handling at all — this exceeds it.)
            if self._declines(node, is_for) or _has_escape(node.orelse):
                return node
            orelse = list(node.orelse)
            node.orelse = []
            self.changed = True
            out = self._rewrite_bc(node, is_for, has_b, has_c)
            if has_b:
                guard = ast.If(
                    test=ast.Call(
                        func=ast.Name(id="__d2t_not", ctx=ast.Load()),
                        args=[ast.Name(id=node._d2s_brk,
                                       ctx=ast.Load())],
                        keywords=[]),
                    body=orelse, orelse=[])
                return out + [guard]
            return out + orelse
        if not (has_b or has_c):
            return node
        # Only rewrite loops the control-flow transformer WILL convert;
        # a declined loop (tuple for-target, other escapes in body) must
        # keep its real break/continue for native semantics.
        if self._declines(node, is_for):
            return node
        return self._rewrite_bc(node, is_for, has_b, has_c)

    def _rewrite_bc(self, node, is_for, has_b, has_c):
        """Eliminate break/continue into carried flags; returns the
        statement list replacing the loop ([flag inits..., loop])."""
        if not (has_b or has_c):
            return [node]
        brk = self._fresh("brk") if has_b else None
        cont = self._fresh("cont") if has_c else None
        node._d2s_brk = brk  # this loop's OWN flag (nested loops get
        # their own; name scanning would confuse them)
        body = _guard_rewrite(node.body, brk, cont)
        if cont:
            body = [_assign_flag(cont, False)] + body
        node.body = body
        pre = []
        if brk:
            pre.append(_assign_flag(brk, False))
            if not is_for:
                # while test := (not brk) and (test); lazy on python path
                node.test = ast.Call(
                    func=ast.Name(id="__d2t_and", ctx=ast.Load()),
                    args=[ast.Call(func=ast.Name(id="__d2t_not",
                                                 ctx=ast.Load()),
                                   args=[ast.Name(id=brk, ctx=ast.Load())],
                                   keywords=[]),
                          ast.Lambda(args=_args([]), body=node.test)],
                    keywords=[])
        if cont:
            pre.append(_assign_flag(cont, False))
        self.changed = True
        return pre + [node]

    def visit_While(self, node):
        return self._handle_loop(node, is_for=False)

    def visit_For(self, node):
        return self._handle_loop(node, is_for=True)


# ------------------------------------------------------------- AST pass ----

class _AssignedNames(ast.NodeVisitor):
    """Names bound by assignments in a statement list (no nested defs)."""

    def __init__(self):
        self.names = []

    def _add(self, name):
        if name not in self.names:
            self.names.append(name)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            self._add(node.id)

    def visit_ListComp(self, node):
        pass  # comprehension targets live in their own scope

    visit_SetComp = visit_DictComp = visit_GeneratorExp = visit_ListComp

    def visit_Import(self, node):
        for a in node.names:
            self._add(a.asname or a.name.split(".")[0])

    def visit_ImportFrom(self, node):
        for a in node.names:
            self._add(a.asname or a.name)

    def visit_FunctionDef(self, node):
        self._add(node.name)

    def visit_AsyncFunctionDef(self, node):
        self._add(node.name)

    def visit_Lambda(self, node):
        pass

    def visit_ClassDef(self, node):
        self._add(node.name)


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


class _HasEscape(ast.NodeVisitor):
    """return/yield anywhere, break/continue not enclosed in a nested
    loop, nonlocal/global declarations (param-passing would break them)."""

    def __init__(self):
        self.found = False
        self._loop_depth = 0

    def visit_Return(self, node):
        self.found = True

    def visit_Raise(self, node):
        # both branches trace under lax.cond: a conditional raise would
        # fire unconditionally at trace time
        self.found = True

    def visit_Yield(self, node):
        self.found = True

    def visit_YieldFrom(self, node):
        self.found = True

    def visit_Nonlocal(self, node):
        self.found = True

    def visit_Global(self, node):
        self.found = True

    def visit_Delete(self, node):
        self.found = True  # del unbinds: param-passing can't model it

    def visit_ExceptHandler(self, node):
        if node.name:  # `except E as e`: e is unbound after the block
            self.found = True
        self.generic_visit(node)

    def visit_Break(self, node):
        if self._loop_depth == 0:
            self.found = True

    def visit_Continue(self, node):
        if self._loop_depth == 0:
            self.found = True

    def _loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = _loop
    visit_For = _loop

    def visit_FunctionDef(self, node):
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass


def _has_escape(stmts):
    v = _HasEscape()
    for s in stmts:
        v.visit(s)
    return v.found


def _has_escape_sans_return(stmts):
    """Escapes OTHER than return (yield/raise/nonlocal/del/...) — used for
    canonical both-return ifs, where returns are the expected exit."""
    v = _HasEscape()
    v.visit_Return = lambda node: None
    for s in stmts:
        v.visit(s)
    return v.found


def _has_escape_sans_bc(stmts):
    """Escapes other than this-level break/continue — the pre-check before
    the flag rewrite: a loop the control-flow transformer would decline
    anyway (return/yield/raise/... in body) must KEEP its real break, or
    the flag-only form silently changes native-loop semantics."""
    v = _HasEscape()
    v.visit_Break = lambda node: None
    v.visit_Continue = lambda node: None
    for s in stmts:
        v.visit(s)
    return v.found


def _for_target_names(target):
    """Names bound by a for target: a Name, or a (possibly nested) tuple
    of Names; None for anything else (starred/attribute/subscript)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for e in target.elts:
            sub = _for_target_names(e)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


def _args(names):
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=n)
                                               for n in names],
                         kwonlyargs=[], kw_defaults=[], defaults=[])


def _seed_tuple(names):
    return ast.Tuple(elts=[ast.Call(
        func=ast.Name(id="__d2t_get", ctx=ast.Load()),
        args=[ast.Constant(value=n)], keywords=[]) for n in names],
        ctx=ast.Load())


def _ret_tuple(names):
    return ast.Return(value=ast.Tuple(
        elts=[ast.Name(id=n, ctx=ast.Load()) for n in names],
        ctx=ast.Load()))


def _bind_target(names):
    # always a tuple target — the branch/body fns return tuples even for
    # one name, so `(y,) = call` unpacks consistently
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Store())
                           for n in names], ctx=ast.Store())


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self.counter = 0

    def _fresh(self, hint):
        self.counter += 1
        return f"__d2s_{hint}_{self.counter}"

    def visit_If(self, node):
        self.generic_visit(node)
        if (_contains_return(node.body) or _contains_return(node.orelse)):
            if _always_returns(node.body) and _always_returns(node.orelse) \
                    and not (_has_escape_sans_return(node.body)
                             or _has_escape_sans_return(node.orelse)):
                return self._ret_if(node)
            return node
        if _has_escape(node.body) or _has_escape(node.orelse):
            return node
        body_names = [n for n in _assigned(node.body)
                      if not n.startswith("__d2s")]
        orelse_names = [n for n in _assigned(node.orelse)
                        if not n.startswith("__d2s")]
        names = sorted(set(body_names) | set(orelse_names))
        both = [i for i, n in enumerate(names)
                if n in body_names and n in orelse_names]

        true_name = self._fresh("true")
        false_name = self._fresh("false")
        body = list(node.body) + ([_ret_tuple(names)] if names
                                  else [ast.Return(value=ast.Constant(
                                      value=None))])
        orelse = (list(node.orelse) or [ast.Pass()]) + \
            ([_ret_tuple(names)] if names
             else [ast.Return(value=ast.Constant(value=None))])
        true_def = ast.FunctionDef(name=true_name, args=_args(names),
                                   body=body, decorator_list=[])
        false_def = ast.FunctionDef(name=false_name, args=_args(names),
                                    body=orelse, decorator_list=[])
        call = ast.Call(
            func=ast.Name(id="__d2t_convert_ifelse", ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=true_name, ctx=ast.Load()),
                  ast.Name(id=false_name, ctx=ast.Load()),
                  ast.Call(func=ast.Name(id="frozenset", ctx=ast.Load()),
                           args=[ast.Tuple(
                               elts=[ast.Constant(value=i) for i in both],
                               ctx=ast.Load())], keywords=[]),
                  _seed_tuple(names)],
            keywords=[])
        stmt = (ast.Assign(targets=[_bind_target(names)], value=call)
                if names else ast.Expr(value=call))
        return [true_def, false_def, stmt]

    def _ret_if(self, node):
        """Both branches end in return (canonical form): lower to a
        value-returning convert_ifelse_ret and RETURN its result."""
        names = sorted(set(
            n for n in _assigned(node.body) + _assigned(node.orelse)
            if not n.startswith("__d2s")))
        true_name = self._fresh("rtrue")
        false_name = self._fresh("rfalse")
        true_def = ast.FunctionDef(name=true_name, args=_args(names),
                                   body=list(node.body), decorator_list=[])
        false_def = ast.FunctionDef(name=false_name, args=_args(names),
                                    body=list(node.orelse),
                                    decorator_list=[])
        call = ast.Call(
            func=ast.Name(id="__d2t_convert_ifelse_ret", ctx=ast.Load()),
            args=[node.test,
                  ast.Name(id=true_name, ctx=ast.Load()),
                  ast.Name(id=false_name, ctx=ast.Load()),
                  _seed_tuple(names)],
            keywords=[])
        self.counter += 1
        return [true_def, false_def, ast.Return(value=call)]

    def visit_For(self, node):
        self.generic_visit(node)
        if node.orelse or _has_escape(node.body):
            return node
        tnames = _for_target_names(node.target)
        if tnames is None:
            return node  # starred/attribute targets: can't be carried
        is_tuple = not isinstance(node.target, ast.Name)
        if is_tuple:
            # element names join the carried set: python scoping
            # (rebinding, post-loop values, unbound-after-empty) falls
            # out of the ordinary carry rules
            names = sorted(n for n in
                           set(_assigned(node.body)) | set(tnames)
                           if not n.startswith("__d2s"))
            target_carry = self._fresh("xlast")  # raw element, discarded
        else:
            names = sorted(n for n in set(_assigned(node.body))
                           if not n.startswith("__d2s")
                           and n != node.target.id)
            target_carry = node.target.id
        # flat (name, position) pairs let the traced path seed elements
        # from the first row; nested patterns stay native-only
        elt_spec = []
        if is_tuple and all(isinstance(e, ast.Name)
                            for e in node.target.elts):
            elt_spec = [(e.id, i) for i, e in enumerate(node.target.elts)]
        brk_name = getattr(node, "_d2s_brk", None)
        if brk_name is not None and brk_name not in names:
            brk_name = None  # defensive: flag must be carried to matter
        body_name = self._fresh("forbody")
        x_arg = "__d2s_x"
        # the element binds through the ORIGINAL target node (a tuple
        # target unpacks naturally)
        body = [ast.Assign(targets=[node.target],
                           value=ast.Name(id=x_arg, ctx=ast.Load()))] \
            + list(node.body) \
            + [_ret_tuple([x_arg if is_tuple else target_carry] + names)]
        body_def = ast.FunctionDef(name=body_name,
                                   args=_args([x_arg] + names),
                                   body=body, decorator_list=[])
        call = ast.Call(
            func=ast.Name(id="__d2t_convert_for", ctx=ast.Load()),
            args=[node.iter,
                  ast.Name(id=body_name, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                            ctx=ast.Load()),
                  _seed_tuple(names),
                  ast.Constant(value=brk_name),
                  ast.Tuple(elts=[
                      ast.Tuple(elts=[ast.Constant(value=n),
                                      ast.Constant(value=i)],
                                ctx=ast.Load())
                      for n, i in elt_spec], ctx=ast.Load())],
            keywords=[])
        assign = ast.Assign(targets=[_bind_target(names + [target_carry])],
                            value=call)
        self.counter += 1
        return [body_def, assign]

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_escape(node.body):
            return node
        if any(isinstance(n, ast.NamedExpr) for n in ast.walk(node.test)):
            return node  # walrus binds inside the nested test fn
        names = sorted(n for n in set(_assigned(node.body))
                       if not n.startswith("__d2s"))
        if not names:
            return node

        test_name = self._fresh("test")
        body_name = self._fresh("body")
        test_def = ast.FunctionDef(
            name=test_name, args=_args(names),
            body=[ast.Return(value=node.test)], decorator_list=[])
        body_def = ast.FunctionDef(
            name=body_name, args=_args(names),
            body=list(node.body) + [_ret_tuple(names)], decorator_list=[])
        call = ast.Call(
            func=ast.Name(id="__d2t_convert_while", ctx=ast.Load()),
            args=[ast.Name(id=test_name, ctx=ast.Load()),
                  ast.Name(id=body_name, ctx=ast.Load()),
                  ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                            ctx=ast.Load()),
                  _seed_tuple(names)],
            keywords=[])
        assign = ast.Assign(targets=[_bind_target(names)], value=call)
        return [test_def, body_def, assign]


def ast_transform(fn):
    """Control-flow-converted clone of ``fn``, or None when conversion
    isn't possible (no source, nothing to convert, exec failure).
    Identical behavior for python-bool conditions.  Closures convert via
    an outer wrapper whose compiled code is re-bound to the ORIGINAL
    cells, so nonlocal reads/writes stay live."""
    closure_cells = getattr(fn, "__closure__", None) or ()
    freevars = fn.__code__.co_freevars if closure_cells else ()
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return None
    fdef.decorator_list = []  # the caller re-wraps

    def _mangled(name):
        return name.startswith("__") and not name.endswith("__")

    for n in ast.walk(fdef):
        # private-name mangling (self.__x -> _Cls__x) happens at class
        # compile time; re-exec at module scope loses it — fall back
        if isinstance(n, ast.Attribute) and _mangled(n.attr):
            return None
        if isinstance(n, ast.Name) and _mangled(n.id):
            return None

    # 0) returns under loops -> carried (flag, value) + break + a
    #    post-loop if-return (feeds the canonicalizer below)
    ret_loop = _ReturnInLoopTransformer()
    tree = ret_loop.visit(tree)
    fdef = tree.body[0]

    # 1) early-return canonicalization (best-effort: unsupported patterns
    #    keep their returns, and the If transformer leaves those alone)
    if any(isinstance(s, ast.If) and _contains_return([s])
           for s in ast.walk(fdef)):
        try:
            body = list(fdef.body)
            if not _always_returns(body):
                body = body + [ast.Return(value=ast.Constant(value=None))]
            fdef.body = _canonicalize_returns(body)
        except _Unsupported:
            pass

    # 2) break/continue -> carried flags + guard ifs
    escape = _LoopEscapeTransformer()
    tree = escape.visit(tree)

    # 3) if/while/for -> runtime converter calls
    transformer = _ControlFlowTransformer()
    new_tree = transformer.visit(tree)
    if transformer.counter == 0 and not escape.changed \
            and not ret_loop.changed:
        return None
    if freevars:
        # compile the converted def inside a wrapper that declares the
        # free names, so the inner code object carries real freevars
        fdef = new_tree.body[0]
        outer = ast.FunctionDef(
            name="__d2s_outer", args=_args(list(freevars)),
            body=[fdef, ast.Return(value=ast.Name(id=fdef.name,
                                                  ctx=ast.Load()))],
            decorator_list=[])
        new_tree = ast.Module(body=[outer], type_ignores=[])
    ast.fix_missing_locations(new_tree)

    try:
        code = compile(new_tree, filename=f"<dy2static {fn.__name__}>",
                       mode="exec")
    except (SyntaxError, ValueError):
        return None
    # exec against the LIVE module globals so helpers defined after
    # decoration (or monkeypatched later) resolve exactly as they would
    # in the original function; only prefixed helper names are injected
    # (``__d2t_``: the JAX package's pass injects ``__d2s_`` helpers into
    # the same globals when one module converts functions for both)
    glb = fn.__globals__
    glb["__d2t_convert_ifelse"] = convert_ifelse
    glb["__d2t_convert_while"] = convert_while
    glb["__d2t_convert_for"] = convert_for
    glb["__d2t_convert_ifelse_ret"] = convert_ifelse_ret
    glb["__d2t_not"] = d2s_not
    glb["__d2t_or"] = d2s_or
    glb["__d2t_and"] = d2s_and_lazy
    glb["__d2t_get"] = _frame_get
    glb["__d2t_noret"] = _noret
    loc = {}
    try:
        exec(code, glb, loc)
    except Exception:
        return None
    if freevars:
        import types

        outer_fn = loc.get("__d2s_outer") or glb.get("__d2s_outer")
        if outer_fn is None:
            return None
        try:
            # call with the LIVE contents to materialize the inner code
            # object, then re-bind it to the ORIGINAL cells by name so
            # later nonlocal mutations stay visible both ways
            inner = outer_fn(*[c.cell_contents for c in closure_cells])
            cellmap = dict(zip(fn.__code__.co_freevars, closure_cells))
            cells = tuple(cellmap[n] for n in inner.__code__.co_freevars)
            converted = types.FunctionType(
                inner.__code__, glb, fdef.name, fn.__defaults__, cells)
        except (ValueError, KeyError):
            return None  # empty cell / freevar mismatch: decline
    else:
        converted = loc.get(fdef.name) or glb.get(fdef.name)
    if converted is None:
        return None
    converted.__defaults__ = fn.__defaults__
    if fn.__kwdefaults__:
        converted.__kwdefaults__ = dict(fn.__kwdefaults__)
    return functools.wraps(fn)(converted)
